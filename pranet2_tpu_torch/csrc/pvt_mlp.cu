// PVTv2 MLP half over channels-last tokens x (N, H, W, D):
//   out = x + fc2(GELU_poly(dwconv3x3(fc1(LN(x)))))
// with two epilogue modes: `stats` also writes the float32 (mu, rstd) of the
// rounded output per token, `final_ln` applies the stage-end LayerNorm to
// f32(x) + fc2(...) and writes only that.
//
// Replaces pranet2_tpu/ops/pvt_mlp.py::_kernel (launchers fused_mlp_block,
// fused_mlp_block_stats, fused_mlp_block_final_ln), with its arithmetic:
// LN in f32 (var = E[x^2] - mu^2) cast to x's type; fc1 in f32 plus the bias,
// the hidden kept f32; the depthwise 3x3 zero-pads the fc1 output (bias
// included) and sums its taps in f32, column of taps outer, row inner, then
// adds its bias; GELU through the clipped degree-5 polynomial erf; the GELU
// output cast to x's type for fc2 (f32 accumulation plus bias); the output
// x + out rounded in x's type.
//
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16) a call does 8-16 GFLOP of products (fc1, fc2) on the tensor cores
// and, per hidden element, about 37 float32 operations (nine taps, the
// GELU polynomial) outside them; at 989 and 67 TFLOP/s that is 11-53 us a
// call, against 4-32 MB of x and weights in and out (1-10 us), so the
// operations bound it.  The TPU kernel keeps the 4x-8x wider hidden map in
// VMEM; this first Hopper design does not.  It is a chain of three launches
// on one stream:
//   1. fc1_kernel: LN of 32 rows into shared memory, then 32x32 WMMA
//      blocks of LN(x) W1^T (W1 fragments read through L2) for 512 hidden
//      channels, plus the bias, written to a float32 hidden z (M x C) in
//      device memory;
//   2. dw_gelu_kernel (in mlp_tail.cuh, with fc2_kernel): a thread walks
//      an image row for four channels with the 3x3 window in registers:
//      taps, border zeros, bias, GELU, cast; written as g (M x C) in x's
//      type;
//   3. fc2_kernel: 32 rows of g times W2^T on WMMA into shared memory,
//      then one warp per row for the residual and the mode's epilogue,
//      which needs the whole row of D channels.
// So the hidden goes through device memory twice (f32 z written and read,
// g in x's type written and read): at stage 1 that is 254 + 127 MB each
// way.  Keeping it on chip, as the TPU kernel does, is left for later.

#include "mlp_tail.cuh"

using tile::kSpan;
using tile::kThreads;
using tile::kWarps;
using tile::WarpBlock;

namespace {

constexpr int kFc1Rows = 32;   // tokens per fc1 block
constexpr int kFc1Cols = 512;  // hidden channels per fc1 block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fc1_kernel(const T* __restrict__ x, const float* __restrict__ lng,
               const float* __restrict__ lnb, const T* __restrict__ w1,
               const T* __restrict__ b1, float* __restrict__ z, long long m, int d, int c,
               float eps) {
  constexpr int S = kSpan<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);  // kFc1Rows x d
  float* stage = reinterpret_cast<float*>(smem + (size_t)kFc1Rows * d * sizeof(T));
  const long long row0 = (long long)blockIdx.x * kFc1Rows;
  tile::layer_norm_rows<T>(x, row0, m, kFc1Rows, d, lng, lnb, eps, ys);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kFc1Cols;
  const int col_blocks = min(kFc1Cols, c - col0) / S;
  float* st = stage + warp * S * S;
  for (int t = warp; t < (kFc1Rows / S) * col_blocks; t += kWarps) {
    const int tr = t % (kFc1Rows / S), tc = t / (kFc1Rows / S);
    WarpBlock<T> acc;
    acc.zero();
    acc.mma_abt(ys + tr * S * d, d, w1 + (long long)(col0 + tc * S) * d, d, d);
    acc.store(st, S);
    __syncwarp();
    for (int e = lane; e < S * S; e += 32) {
      const long long row = row0 + tr * S + e / S;
      const int col = col0 + tc * S + e % S;
      if (row < m) z[row * c + col] = st[e] + to_f32<T>(b1[col]);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(int mode, const void* x, const float* lng, const float* lnb, const void* w1,
           const void* b1, const void* dwk, const void* dwb, const void* w2, const void* b2,
           const float* fg, const float* fb, void* out, float* mu, float* rstd, float* z,
           void* g, long long m, int h, int w, int d, int c, float eps, float eps2,
           cudaStream_t s) {
  const size_t smem1 =
      (size_t)kFc1Rows * d * sizeof(T) + kWarps * kSpan<T> * kSpan<T> * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(fc1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((unsigned)((m + kFc1Rows - 1) / kFc1Rows), (c + kFc1Cols - 1) / kFc1Cols);
  fc1_kernel<T><<<grid1, kThreads, smem1, s>>>(
      static_cast<const T*>(x), lng, lnb, static_cast<const T*>(w1), static_cast<const T*>(b1),
      z, m, d, c, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = (cudaError_t)mlp::launch_dw_gelu<T>(z, dwk, dwb, g, m, h, w, c, s)) != cudaSuccess)
    return (int)err;

  switch (mode) {
    case mlp::kPlain:
      return mlp::launch_fc2<T, mlp::kPlain>(g, w2, b2, x, fg, fb, out, mu, rstd, m, c, d,
                                             eps2, s);
    case mlp::kStats:
      return mlp::launch_fc2<T, mlp::kStats>(g, w2, b2, x, fg, fb, out, mu, rstd, m, c, d,
                                             eps2, s);
    case mlp::kFinalLn:
      return mlp::launch_fc2<T, mlp::kFinalLn>(g, w2, b2, x, fg, fb, out, mu, rstd, m, c, d,
                                               eps2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (m, d) contiguous, type `dtype`: the tokens of m / (h*w) images
// of h x w; w1 (c, d), b1 (c), dwk (c, 3, 3), dwb (c), w2 (d, c), b2 (d) of
// the same type; lng, lnb (d) and, in final_ln mode, fg, fb (d) float32.
// mu, rstd (m) float32 in stats mode.  Scratch from the caller: z (m, c)
// float32 and g (m rounded up to 32, c) of type `dtype`.  eps2 is the stats
// or final-LN epsilon.  d and c are multiples of 32, m below 2^31.  Returns
// the cudaError_t of the launches.
extern "C" int pvt_mlp_block(int dtype, int mode, const void* x, const void* lng,
                             const void* lnb, const void* w1, const void* b1, const void* dwk,
                             const void* dwb, const void* w2, const void* b2, const void* fg,
                             const void* fb, void* out, void* mu, void* rstd, void* z, void* g,
                             long long m, int h, int w, int d, int c, float eps, float eps2,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_lng = static_cast<const float*>(lng);
  const float* f_lnb = static_cast<const float*>(lnb);
  const float* f_fg = static_cast<const float*>(fg);
  const float* f_fb = static_cast<const float*>(fb);
  float* f_mu = static_cast<float*>(mu);
  float* f_rstd = static_cast<float*>(rstd);
  float* f_z = static_cast<float*>(z);
  switch (dtype) {
    case kFloat32:
      return launch<float>(mode, x, f_lng, f_lnb, w1, b1, dwk, dwb, w2, b2, f_fg, f_fb, out, f_mu,
                           f_rstd, f_z, g, m, h, w, d, c, eps, eps2, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(mode, x, f_lng, f_lnb, w1, b1, dwk, dwb, w2, b2, f_fg, f_fb,
                                   out, f_mu, f_rstd, f_z, g, m, h, w, d, c, eps, eps2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
