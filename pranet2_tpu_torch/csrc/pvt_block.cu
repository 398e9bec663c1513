// A whole PVTv2 transformer block over channels-last tokens x (N, H, W, D):
//   h   = x + proj(attention(LN1(x), kv(LN_kv(sr(LN1(x))))))
//   out = h + fc2(GELU_poly(dwconv3x3(fc1(LN2(h)))))
// in four launches on one stream, the attention launch crossing into the
// MLP half:
//   1. kvpath::kv_kernel (sra_kv.cuh): LN1 of the patch tokens, the sr
//      patch product, the kv LN and the kv product -> kv (N, Tkv, 2D);
//   2. sra::sra_kernel<kFc1> (sra_attend.cuh): per 32 query rows, the
//      attention half with its residual rounded once (h, written: it is
//      the MLP's residual), then, on the h rows it holds in shared memory,
//      LN2 and fc1 into the float32 hidden z;
//   3. mlp::dw_gelu_kernel (mlp_tail.cuh): depthwise 3x3, bias, GELU -> g;
//   4. mlp::fc2_kernel<kPlain>: out = h + fc2(g), rounded in x's type.
//
// Replaces pranet2_tpu/ops/pvt_block.py::_kernel_v3 (launcher
// fused_pvt_block), with its arithmetic: _kernel_v2's attention half (see
// sra_kv.cuh, sra_attend.cuh), h rounded to x's type, then the MLP half of
// pvt_mlp.py::_kernel in its plain mode (f32 taps, fc1 per tap equal to fc1
// once).
//
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16) a call does 10-22 GFLOP of products and, per hidden element, about
// 37 float32 operations outside them: 13-60 us at the card's peaks, the
// operations bounding it.  The TPU kernel keeps h and the 4x-8x wider
// hidden in VMEM for a whole image; one Hopper block's 227 KB holds neither
// an image nor the hidden over a halo'd tile, so h and the hidden go
// through device memory (z f32 and g in x's type, as in csrc/pvt_mlp.cu)
// and the block saves, against sra_block then mlp_block, the reading of h
// for LN2 and fc1.

#include "mlp_tail.cuh"
#include "sra_attend.cuh"
#include "sra_kv.cuh"

namespace {

template <typename T>
int launch(const kvpath::Args& kva, const void* wq, const void* bq, const void* wp,
           const void* bp, float scale, const sra::Fc1Args& f, const void* dwk, const void* dwb,
           const void* w2, const void* b2, void* hbuf, void* g, void* out, int n, int nh,
           cudaStream_t s) {
  const int h = kva.h, w = kva.w, d = kva.d, c = f.c, hw = h * w;
  const long long m = (long long)n * hw;
  const int tkv = (h / kva.sr) * (w / kva.sr);
  int err = kvpath::launch<T>(kva, n, s);
  if (err) return err;
  err = sra::launch<T, sra::kFc1>(kva.x, kva.lng, kva.lnb, wq, bq, kva.kv, wp, bp, hbuf, n, hw,
                                  d, nh, tkv, kva.eps, scale, f, s);
  if (err) return err;
  err = mlp::launch_dw_gelu<T>(f.z, dwk, dwb, g, m, h, w, c, s);
  if (err) return err;
  return mlp::launch_fc2<T, mlp::kPlain>(g, w2, b2, hbuf, nullptr, nullptr, out, nullptr,
                                         nullptr, m, c, d, 0.f, s);
}

}  // namespace

// x, out: (n, h, w, d) contiguous, type `dtype`; the attention half's
// parameters as for pvt_sra_kv and pvt_sra_attention (wq, bq, wp, bp;
// lng, lnb with eps; scale = 1/sqrt(d / nh)); the MLP's: ln2g, ln2b (d)
// float32 with eps2, w1 (c, d), b1 (c), dwk (c, 3, 3), dwb (c), w2 (d, c),
// b2 (d) of x's type, 32-byte aligned.  Scratch from the caller: kv
// (n, tkv, 2d) and hbuf (n, h, w, d) of x's type, z (n*h*w, c) float32, g
// (n*h*w rounded up to 32, c) of x's type.  d = nh * hd with hd and c
// multiples of 32.  Returns the cudaError_t of the first launch that failed.
extern "C" int pvt_block(int dtype, const void* x, const void* lng, const void* lnb, float eps,
                         const void* wq, const void* bq, const void* wsr, const void* bsr,
                         const void* kng, const void* knb, float keps, const void* wkv,
                         const void* bkv, const void* wp, const void* bp, float scale,
                         const void* ln2g, const void* ln2b, float eps2, const void* w1,
                         const void* b1, const void* dwk, const void* dwb, const void* w2,
                         const void* b2, void* kv, void* hbuf, void* z, void* g, void* out,
                         int n, int h, int w, int d, int nh, int c, int sr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kvpath::Args kva{x, static_cast<const float*>(lng), static_cast<const float*>(lnb), eps,
                         wsr, bsr, static_cast<const float*>(kng),
                         static_cast<const float*>(knb), keps, wkv, bkv, kv, h, w, d, sr};
  const sra::Fc1Args f{static_cast<const float*>(ln2g), static_cast<const float*>(ln2b), eps2,
                       w1, b1, static_cast<float*>(z), c};
  switch (dtype) {
    case kFloat32:
      return launch<float>(kva, wq, bq, wp, bp, scale, f, dwk, dwb, w2, b2, hbuf, g, out, n, nh,
                           s);
    case kBFloat16:
      return launch<__nv_bfloat16>(kva, wq, bq, wp, bp, scale, f, dwk, dwb, w2, b2, hbuf, g,
                                   out, n, nh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
