// A whole PVTv2 transformer block over channels-last tokens x (N, H, W, D):
//   h   = x + proj(attention(LN1(x), kv(LN_kv(sr(LN1(x))))))
//   out = h + fc2(GELU_poly(dwconv3x3(fc1(LN2(h)))))
// in three steps on one stream:
//   1. the K/V path (sra_kv.cuh): the split patch product into f32 partials
//      (sr > 1), then their sum, bsr, the kv LN and the kv product -> kv
//      (N, Tkv, 2D); two launches where sr > 1, one at sr = 1;
//   2. sra::attend_kernel<kExactResidual> (sra_attend.cuh), as the
//      whole-half kernel runs it: the attention half with its residual
//      rounded once, the heads split over a thread-block cluster
//      -> h (N, H, W, D);
//   3. mlpf::mlp_kernel (mlp_fused.cuh): the MLP half on h, its hidden
//      walked in chunks that stay on chip -> out.
//
// Replaces pranet2_tpu/ops/pvt_block.py::_kernel_v3 (launcher
// fused_pvt_block), with its arithmetic: _kernel_v2's attention half (see
// sra_kv.cuh, sra_attend.cuh), h rounded to x's type, then _mlp_half (f32
// taps, fc1 per tap equal to fc1 once).
//
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16) a call does 10-22 GFLOP of products and, per hidden element, about
// 37 float32 operations outside them: 13-60 us at the card's peaks, the
// operations bounding it.  The TPU kernel keeps h and the 4x-8x wider
// hidden in VMEM for a whole image.  Here h (x's type, 0.5-4 MB a call)
// goes through device memory once between the attention and the MLP
// launches; the hidden never does (mlp_fused.cuh).  The first design ran
// fc1 in the attention's grid (32 query rows a block, 64 blocks at stage
// 4), spilled the f32 hidden and ran the K/V path in 64 blocks; each of
// the three launches now has a grid of its own, of at least a block per SM
// at PVTv2-b2's serving shapes.

#include "mlp_fused.cuh"
#include "sra_attend.cuh"
#include "sra_kv.cuh"

namespace {

template <typename T>
int launch(const kvpath::Args& kva, const void* wq, const void* bq, const void* wp,
           const void* bp, float scale, mlpf::Args& ma, int nh, cudaStream_t s) {
  const int hw = kva.h * kva.w;
  const int tkv = (kva.h / kva.sr) * (kva.w / kva.sr);
  int err = kvpath::launch<T>(kva, s);
  if (err) return err;
  err = sra::launch<T, sra::kExactResidual>(kva.x, kva.lng, kva.lnb, wq, bq, kva.kv, wp, bp,
                                            const_cast<void*>(ma.h), kva.n, hw, kva.d, nh, tkv,
                                            kva.eps, scale, s);
  if (err) return err;
  return mlpf::launch<T>(ma, s);
}

}  // namespace

// x, out: (n, h, w, d) contiguous, type `dtype`; the attention half's
// parameters as for pvt_sra_kv and pvt_sra_attention (wq, bq, wp, bp;
// lng, lnb with eps; scale = 1/sqrt(d / nh)); the MLP's: ln2g, ln2b (d)
// float32 with eps2, w1 (c, d), b1 (c), dwk (c, 3, 3), dwb (c), w2 (d, c),
// b2 (d) of x's type, 32-byte aligned.  Scratch from the caller: part
// (sr, n * tkv, d) float32 for sr > 1, kv (n, tkv, 2d) and hbuf (n, h, w,
// d) of x's type.  Where pvt_mlp_tile (pvt_mlp.cu: the same pick) gives
// the MLP launch S > 1 splits of R rows: scratch mlp_part (S, n * h * w,
// d) float32 and mlp_count (n * ceil(h / R)) int32, which the launch
// zeroes; else both may be null.  d = nh * hd with hd and c multiples of
// 32.  Returns the cudaError_t of the first
// launch that failed.
extern "C" int pvt_block(int dtype, const void* x, const void* lng, const void* lnb, float eps,
                         const void* wq, const void* bq, const void* wsr, const void* bsr,
                         const void* kng, const void* knb, float keps, const void* wkv,
                         const void* bkv, const void* wp, const void* bp, float scale,
                         const void* ln2g, const void* ln2b, float eps2, const void* w1,
                         const void* b1, const void* dwk, const void* dwb, const void* w2,
                         const void* b2, void* part, void* kv, void* hbuf, void* out, int n,
                         int h, int w, int d, int nh, int c, int sr, void* mlp_part,
                         void* mlp_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kvpath::Args kva{x,   static_cast<const float*>(lng), static_cast<const float*>(lnb),
                         eps, wsr, bsr, static_cast<const float*>(kng),
                         static_cast<const float*>(knb), keps, wkv, bkv, kv,
                         static_cast<float*>(part), n, h, w, d, sr};
  mlpf::Args ma{hbuf, static_cast<const float*>(ln2g), static_cast<const float*>(ln2b), eps2,
                w1,   b1, dwk, dwb, w2, b2, out, n, h, w, d, c,
                static_cast<float*>(mlp_part), static_cast<int*>(mlp_count)};
  switch (dtype) {
    case kFloat32:
      return launch<float>(kva, wq, bq, wp, bp, scale, ma, nh, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(kva, wq, bq, wp, bp, scale, ma, nh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
