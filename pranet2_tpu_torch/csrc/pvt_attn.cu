// PVTv2 SRA attention half over channels-last tokens x (N, H, W, D) with K
// and V given: the kernel of csrc/sra_attend.cuh, one launch.
//
// Replaces pranet2_tpu/ops/pvt_attn.py::_kernel (launcher
// fused_sra_attention), with its arithmetic (see sra_attend.cuh); the TPU
// kernel takes K pre-transposed per head, (nh, hd, Tkv), for its matrix
// unit; here K is read in the kv Linear's own layout.  With exact_residual
// it is also the attention step of the whole-half kernel (_kernel_v2, after
// csrc/pvt_kv.cu has made K and V), whose residual is rounded once.
//
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16; Tkv = 121 at every stage) the four products come to 2.5-5.9 GFLOP
// a call against 4-32 MB of x, K/V and weights in and out: 3-10 us at the
// card's peaks, bytes at stage 1 and operations at stages 2-4.  The design
// (sra_attend.cuh) keeps scores, P and each head's output in registers,
// splits the heads over a thread-block cluster that shares a query tile
// and exchanges their outputs through distributed shared memory.

#include "sra_attend.cuh"

namespace {

template <typename T>
int launch(int exact_residual, const void* x, const float* lng, const float* lnb, const void* wq,
           const void* bq, const void* kv, const void* wp, const void* bp, void* out, int n,
           int hw, int d, int nh, int tkv, float eps, float scale, cudaStream_t s) {
  return exact_residual
             ? sra::launch<T, sra::kExactResidual>(x, lng, lnb, wq, bq, kv, wp, bp, out, n, hw,
                                                   d, nh, tkv, eps, scale, s)
             : sra::launch<T, sra::kRoundedResidual>(x, lng, lnb, wq, bq, kv, wp, bp, out, n,
                                                     hw, d, nh, tkv, eps, scale, s);
}

}  // namespace

// x, out: (n, hw, d) contiguous, type `dtype`; wq, wp (d, d), bq, bp (d) and
// kv (n, tkv, 2d) of the same type, 16-byte aligned; lng, lnb (d) float32.
// d = nh * hd with hd a multiple of 32; scale = 1/sqrt(hd) as the caller
// rounds it.  exact_residual: out = round(x + o) instead of x + round(o).
// Returns the cudaError_t of the launch.
extern "C" int pvt_sra_attention(int dtype, int exact_residual, const void* x, const void* lng,
                                 const void* lnb, const void* wq, const void* bq, const void* kv,
                                 const void* wp, const void* bp, void* out, int n, int hw, int d,
                                 int nh, int tkv, float eps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_lng = static_cast<const float*>(lng);
  const float* f_lnb = static_cast<const float*>(lnb);
  switch (dtype) {
    case kFloat32:
      return launch<float>(exact_residual, x, f_lng, f_lnb, wq, bq, kv, wp, bp, out, n, hw, d,
                           nh, tkv, eps, scale, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(exact_residual, x, f_lng, f_lnb, wq, bq, kv, wp, bp, out, n,
                                   hw, d, nh, tkv, eps, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
