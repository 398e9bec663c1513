// Bottle2neck tail over NCHW maps:
//   out = relu((W3 . cc) * s3 + t3 + short)
// with W3 the 1x1 projection (Cout x Cin), s3/t3 the folded BatchNorm (f32)
// and short the residual shortcut (Cout channels).
//
// Replaces pranet2_tpu/ops/res2_tail.py::_kernel (launcher fused_tail), with
// its arithmetic: the product accumulated in float32 from operands in the
// input's type and not rounded before the BatchNorm; then * s3 + t3, then
// + short in float32, ReLU, one cast.  The TPU kernel gives way to an XLA
// composition at map widths that are not multiples of 8 (a Mosaic layout
// limit); this kernel takes every map width (in bfloat16 channel counts
// that keep its rows 16-byte aligned: cin a multiple of 8, cout even).
//
// What bounds it: at PraNet-V2 serving shapes (batch 16 at 352x352, bf16) a
// call does 2 Cin Cout HW N operations, 6.6 GFLOP at every stage, 7 us on the
// tensor cores, against 22-153 MB of cc, short and out, 7-46 us at the HBM
// rate: the bytes bound it.  The design reads cc and short once each and
// writes out once; the weights come through L2.  bfloat16 runs on
// res2_gemm.cuh's pipelined tensor-core engine (cc staged k-major by
// cp.async and read by ldmatrix.trans; BatchNorm, residual and ReLU in the
// epilogue, each channel's pixels written contiguously); the first
// design's WMMA tiles with no pipeline ran at 11% of the byte bound on the
// H100.
// float32 (not served) keeps conv_gemm.cuh's FMA products.

#include "conv_gemm.cuh"
#include "res2_gemm.cuh"

namespace {

int launch_f32(const float* cc, const float* shortcut, const float* w3, const float* s3,
               const float* t3, float* out, float* ws, int n, int cin, int cout, int h, int w,
               cudaStream_t stream) {
  const long long hw = (long long)h * w;
  res2::ConvArgs<float> a{};
  a.ws = ws;
  a.weight = w3;
  a.x = cc;
  a.s = s3;
  a.t = t3;
  a.res = shortcut;
  a.out = out;
  a.x_img = cin * hw;
  a.res_img = a.out_img = cout * hw;
  a.m = a.split = cout;
  a.cin = cin;
  a.height = h;
  a.width = w;
  return res2::launch_conv<float, 1, true>(a, n, stream);
}

}  // namespace

// float32 elements of scratch res2_tail needs at these sizes (split-K
// partial sums; 0 when the launch does not split), or -1 for a bad dtype.
extern "C" long long res2_tail_workspace(int dtype, int n, int cin, int cout, int h, int w) {
  switch (dtype) {
    case kFloat32:
      return res2::workspace_elems<float>(cout, cin, h * w, n);
    case kBFloat16:
      return r2g::part_elems(r2g::plan1x1(n, h * w, cout, cin), (long long)n * h * w, cout);
    default:
      return -1;
  }
}

// cc (n, cin, h, w), shortcut and out (n, cout, h, w), w3 (cout, cin): all
// contiguous, of type `dtype` (float32 or bfloat16; in bfloat16 cc and w3
// 16-byte aligned, cin a multiple of 8 and cout even); s3, t3 (cout)
// float32; ws float32 scratch of res2_tail_workspace elements.  Returns the
// cudaError_t of the launches.
extern "C" int res2_tail(int dtype, const void* cc, const void* shortcut, const void* w3,
                         const void* s3, const void* t3, void* out, void* ws, int n, int cin,
                         int cout, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fs = static_cast<const float*>(s3);
  const float* ft = static_cast<const float*>(t3);
  float* fws = static_cast<float*>(ws);
  switch (dtype) {
    case kFloat32:
      return launch_f32(static_cast<const float*>(cc), static_cast<const float*>(shortcut),
                        static_cast<const float*>(w3), fs, ft, static_cast<float*>(out), fws, n,
                        cin, cout, h, w, s);
    case kBFloat16: {
      using r2g::bf16;
      r2g::Out o{};
      o.kind = r2g::kResidual;
      o.s = fs;
      o.t = ft;
      o.ncols = cout;
      o.res = static_cast<const bf16*>(shortcut);
      o.out = static_cast<bf16*>(out);
      o.part = fws;
      return r2g::launch1x1(r2g::A1{static_cast<const bf16*>(cc), (long long)cin * h * w, 0, cin},
                            r2g::B1{static_cast<const bf16*>(w3), cin, cout, 0, 0}, o, 0, n,
                            h * w, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
