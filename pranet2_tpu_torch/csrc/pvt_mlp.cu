// PVTv2 MLP half over channels-last tokens x (N, H, W, D):
//   out = x + fc2(GELU_poly(dwconv3x3(fc1(LN(x)))))
// with two epilogue modes: `stats` also writes the float32 (mu, rstd) of the
// rounded output per token, `final_ln` applies the stage-end LayerNorm to
// f32(x) + fc2(...) and writes only that.
//
// Replaces pranet2_tpu/ops/pvt_mlp.py::_kernel (launchers fused_mlp_block,
// fused_mlp_block_stats, fused_mlp_block_final_ln).  One launch of
// mlp_fused.cuh's kernel in every mode, its hidden kept on chip; that
// header holds the arithmetic, what bounds the launch and the design.  The
// first design of this file ran three launches (fc1, dw+GELU, fc2) and
// wrote the f32 hidden and the GELU output to device memory and back,
// 4.7 GB a forward at PVT-PraNet-V2 serving shapes.

#include "mlp_fused.cuh"

// x, out: (n, h, w, d) contiguous, type `dtype` (float32 or bfloat16); w1
// (c, d), b1 (c), dwk (c, 3, 3), dwb (c), w2 (d, c), b2 (d) of the same
// type, w1 and w2 32-byte aligned; lng, lnb (d) and, in final_ln mode, fg,
// fb (d) float32.  mu, rstd (n, h, w) float32 in stats mode.  eps2 is the
// stats' or the stage LN's epsilon.  Where pvt_mlp_tile gives S > 1 splits
// of R rows: scratch part (S, n * h * w, d) float32 and count (n * ceil(h /
// R)) int32, which the launch zeroes; else both may be null.  d and c
// multiples of 32.
// Returns the cudaError_t of the launch.
extern "C" int pvt_mlp_block(int dtype, int mode, const void* x, const void* lng,
                             const void* lnb, const void* w1, const void* b1, const void* dwk,
                             const void* dwb, const void* w2, const void* b2, const void* fg,
                             const void* fb, void* out, void* mu, void* rstd, void* part,
                             void* count, int n, int h, int w, int d, int c, float eps,
                             float eps2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlpf::Args a{};
  a.h = x;
  a.lng = static_cast<const float*>(lng);
  a.lnb = static_cast<const float*>(lnb);
  a.eps = eps;
  a.w1 = w1;
  a.b1 = b1;
  a.dwk = dwk;
  a.dwb = dwb;
  a.w2 = w2;
  a.b2 = b2;
  a.out = out;
  a.n = n;
  a.hh = h;
  a.w = w;
  a.d = d;
  a.c = c;
  a.part = static_cast<float*>(part);
  a.count = static_cast<int*>(count);
  a.mode = mode;
  a.fg = static_cast<const float*>(fg);
  a.fb = static_cast<const float*>(fb);
  a.eps2 = eps2;
  a.mu = static_cast<float*>(mu);
  a.rstd = static_cast<float*>(rstd);
  switch (dtype) {
    case kFloat32:
      return mlpf::launch<float>(a, s);
    case kBFloat16:
      return mlpf::launch<__nv_bfloat16>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The launch's tile on the current device (mlpf::pick): image rows R,
// hidden channels a chunk CC and splits S into tile[0..2], for the
// caller's scratch.  Returns cudaErrorInvalidValue where no tile fits.
extern "C" int pvt_mlp_tile(int dtype, int n, int h, int w, int d, int c, int* tile) {
  mlpf::Tile t{0, 0, 0};
  if (dtype == kFloat32) t = mlpf::pick<float>(n, h, w, d, c);
  if (dtype == kBFloat16) t = mlpf::pick<__nv_bfloat16>(n, h, w, d, c);
  tile[0] = t.rows;
  tile[1] = t.chunk;
  tile[2] = t.splits;
  return t.rows ? 0 : (int)cudaErrorInvalidValue;
}
