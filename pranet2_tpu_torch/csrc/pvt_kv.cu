// The K/V path of the whole-half PVTv2 SRA kernel: LN1 of the patch tokens
// straight from x, the sr x sr patch product split over blocks, then the
// partials' sum, the kv LN and the kv product, written as (N, Tkv, 2D) in
// x's type for the attention step (csrc/pvt_attn.cu with exact_residual).
// The kernels (two launches where sr > 1, one at sr = 1) are in sra_kv.cuh.
//
// Replaces, with csrc/pvt_attn.cu, pranet2_tpu/ops/pvt_attn.py::_kernel_v2
// (launcher fused_sra_block).  What bounds it: at PVT-PraNet-V2 serving
// shapes (batch 16 at 352x352, bf16; Tkv = 121) a call reads x once (4-16
// MB) and does 1-2 GFLOP of products: 1-5 us at the card's peaks.  The
// design (sra_kv.cuh) splits the patch product over 248-310 blocks, one
// patch row each, and sums the parts in a second launch.

#include "sra_kv.cuh"

// x (n, h, w, d) contiguous, type `dtype`; wsr (d, sr, sr, d), bsr (d),
// wkv (2d, d), bkv (2d) of the same type, 32-byte aligned; lng, lnb, kng,
// knb (d) float32 (wsr, bsr, kng, knb unused at sr = 1).  kv out: (n, tkv,
// 2d), tkv = (h / sr) * (w / sr) > 0.  Scratch from the caller for sr > 1:
// part (sr, n * tkv, d) float32.  d a multiple of 32.  Returns the
// cudaError_t of the first launch that failed.
extern "C" int pvt_sra_kv(int dtype, const void* x, const void* lng, const void* lnb, float eps,
                          const void* wsr, const void* bsr, const void* kng, const void* knb,
                          float keps, const void* wkv, const void* bkv, void* part, void* kv,
                          int n, int h, int w, int d, int sr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kvpath::Args a{x,   static_cast<const float*>(lng), static_cast<const float*>(lnb),
                       eps, wsr, bsr, static_cast<const float*>(kng),
                       static_cast<const float*>(knb), keps, wkv, bkv, kv,
                       static_cast<float*>(part), n, h, w, d, sr};
  switch (dtype) {
    case kFloat32:
      return kvpath::launch<float>(a, s);
    case kBFloat16:
      return kvpath::launch<__nv_bfloat16>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
