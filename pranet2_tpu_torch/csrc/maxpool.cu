// The Res2Net-v1b stem's tail: inference BatchNorm (bn1) + ReLU + maxpool
// 3x3, stride 2, padding 1 with -inf, over an NCHW map, in one pass; or
// the bare maxpool.
//
// Replaces pranet2_tpu/ops/stem.py::_maxpool_kernel (launcher
// _maxpool_s2d_pallas), which the JAX package feeds the stem's conv3 output
// after folding bn1 (fold_bn) and applying it with ReLU (s2d_stem's bnrelu).
// The TPU kernel reads a 2x2 space-to-depth packing so that its minor
// dimension fills the 128 lanes; Hopper has no lane layout to satisfy, so
// this kernel reads the plain NCHW map of conv1's last convolution.
//
// Arithmetic (stem_pool, BN on): per channel s = w * rsqrt(var + eps) and
// t = b - mean * s in float32 (ops/res2_tail.py::fold_bn's, with rsqrtf as
// torch.rsqrt on the card), then relu(z * s + t) in float32, product and
// sum rounded apart (no fused multiply-add, as the plain version's two
// ops), NaN kept, rounded once to z's type; then the max of the nine taps,
// exact in every type, NaN propagating as through torch.maximum.  BN off
// (max_pool3x3s2): the max alone.
//
// What bounds it: device memory.  At the PraNet-V2 serving shape
// (16, 64, 176, 176) bf16 it has to read 63.4 MB and write 15.9 MB, about
// 24 us at 3.35 TB/s, against 8 compares and 3 flops per output.  Before
// it ATen ran bn1 and the ReLU as two passes over the 63.4 MB map.  The
// first kernel (one thread an output, nine 2-byte loads) reached 31% of
// the bytes' bound.  Design: a block takes a band of R output rows of one
// (n, c) plane; it stages the band's 2R + 1 input rows, contiguous in
// memory, by cp.async in 16-byte granules, applies BN + ReLU once to each
// staged element in shared memory, 16 bytes a thread, then each thread
// takes VEC adjacent outputs of a row (8 in bf16): two 16-byte shared
// loads and one 2-byte load of each of its three input rows, one 16-byte
// store.  (Nine 2-byte shared loads an output, at 32 bytes a lane apart,
// were 8-way bank conflicts: 0.100 ms at the serving shape.)  Rows that
// are not 16-byte aligned take one output a thread.  R fills the block's
// 128 threads with output vectors (11 rows of 11 vectors at the serving
// shape, 23 staged rows): each input byte leaves device memory
// (2R + 1) / 2R times.

#include "mma.cuh"

#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T v[VEC];
};

struct Pool {
  int h, w, oh, ow, c;
  int rows, bands;  // output rows a band, bands a plane
  float eps;
};

// The BatchNorm and ReLU of one staged element, rounded to T.
template <typename T>
__device__ __forceinline__ T bn_relu(T x, float sc, float sh) {
  const float v = __fadd_rn(__fmul_rn(to_f32<T>(x), sc), sh);
  return from_f32<T>(v < 0.f ? 0.f : v);
}

__device__ __forceinline__ float max_tap(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// FAST: x, its rows and the output rows are 16-byte aligned (so the staged
// span starts at s[0]); then the BN pass and the pool's loads move 16
// bytes a thread, and each thread writes VEC = 16 / sizeof(T) outputs of a
// row from two 16-byte loads of each of its three input rows (the taps at
// columns 2c0 .. 2c0 + 2 VEC - 1) and one element on their left.  Else a
// thread takes one output and its nine taps.
template <typename T, bool FAST, bool BN>
__global__ void __launch_bounds__(kThreads)
    stem_pool_kernel(const T* __restrict__ x, const float* __restrict__ bw,
                     const float* __restrict__ bb, const float* __restrict__ bm,
                     const float* __restrict__ bv, T* __restrict__ y, Pool p) {
  constexpr int VEC = FAST ? 16 / sizeof(T) : 1;
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long plane = blockIdx.x / p.bands;
  const int b = blockIdx.x % p.bands;
  const int r0 = b * p.rows, r1 = min(r0 + p.rows, p.oh);
  const int lo = max(2 * r0 - 1, 0), hi = min(2 * r1 - 1, p.h - 1);
  const long long n = (long long)(hi - lo + 1) * p.w;
  const T* src = x + plane * p.h * p.w + (long long)lo * p.w;
  T* s = reinterpret_cast<T*>(smem) + mma::cp_span(reinterpret_cast<T*>(smem), src, n);
  mma::commit();
  mma::wait<0>();
  __syncthreads();
  if (BN) {
    const int ch = (int)(plane % p.c);
    const float sc = __fmul_rn(bw[ch], rsqrtf(__fadd_rn(bv[ch], p.eps)));
    const float sh = __fsub_rn(bb[ch], __fmul_rn(bm[ch], sc));
    for (long long i = threadIdx.x; i < n / VEC; i += blockDim.x) {
      P v = reinterpret_cast<P*>(s)[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) v.v[j] = bn_relu<T>(v.v[j], sc, sh);
      reinterpret_cast<P*>(s)[i] = v;
    }
    __syncthreads();
  }
  const int groups = p.ow / VEC;
  for (int i = threadIdx.x; i < (r1 - r0) * groups; i += blockDim.x) {
    const int r = r0 + i / groups, c0 = (i % groups) * VEC;
    float m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = -INFINITY;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = 2 * r + dr;
      if (rr < 0 || rr >= p.h) continue;
      const T* row = s + (rr - lo) * p.w;
      if (FAST) {
        // e[t] is column 2 c0 - 1 + t
        float e[2 * VEC + 1];
        e[0] = c0 > 0 ? to_f32<T>(row[2 * c0 - 1]) : -INFINITY;
        const P a = reinterpret_cast<const P*>(row + 2 * c0)[0];
        const P b = reinterpret_cast<const P*>(row + 2 * c0)[1];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          e[1 + j] = to_f32<T>(a.v[j]);
          e[1 + VEC + j] = to_f32<T>(b.v[j]);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
#pragma unroll
          for (int t = 0; t < 3; ++t) m[j] = max_tap(m[j], e[2 * j + t]);
      } else {
#pragma unroll
        for (int dc = -1; dc <= 1; ++dc) {
          const int cc = 2 * c0 + dc;
          if (cc >= 0 && cc < p.w) m[0] = max_tap(m[0], to_f32<T>(row[cc]));
        }
      }
    }
    P out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = from_f32<T>(m[j]);
    *reinterpret_cast<P*>(y + (plane * p.oh + r) * p.ow + c0) = out;
  }
}

template <typename T, bool BN>
static int launch(const void* x, const float* bw, const float* bb, const float* bm,
                  const float* bv, float eps, void* y, long long planes, int c, int h, int w,
                  int oh, int ow, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool fast = (w * sizeof(T)) % 16 == 0 && (ow * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int groups = fast ? ow / V : ow;
  // output rows a band: as many as give every thread one output vector,
  // split evenly; fewer where the staged rows do not fit a block
  int rows = std::max(1, std::min(oh, kThreads / groups));
  const int bands0 = (oh + rows - 1) / rows;
  rows = (oh + bands0 - 1) / bands0;
  while (rows > 1 && mma::span_bytes<T>((long long)(2 * rows + 1) * w) > mma::kSmemBlock) --rows;
  const long long smem = mma::span_bytes<T>((long long)(2 * rows + 1) * w);
  const long long bands = (oh + rows - 1) / rows;
  if (smem > mma::kSmemBlock || planes * bands >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Pool p{h, w, oh, ow, c, rows, (int)bands, eps};
  auto kernel = fast ? stem_pool_kernel<T, true, BN> : stem_pool_kernel<T, false, BN>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned int)(planes * bands), kThreads, smem, stream>>>(
      static_cast<const T*>(x), bw, bb, bm, bv, static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <bool BN>
static int dispatch(int dtype, const void* x, const float* bw, const float* bb, const float* bm,
                    const float* bv, float eps, void* y, long long planes, int c, int h, int w,
                    int oh, int ow, cudaStream_t s) {
  switch (dtype) {
    case kFloat32: return launch<float, BN>(x, bw, bb, bm, bv, eps, y, planes, c, h, w, oh, ow, s);
    case kBFloat16:
      return launch<__nv_bfloat16, BN>(x, bw, bb, bm, bv, eps, y, planes, c, h, w, oh, ow, s);
    case kFloat16: return launch<__half, BN>(x, bw, bb, bm, bv, eps, y, planes, c, h, w, oh, ow, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (planes, h, w) contiguous; y: (planes, oh, ow) contiguous.
// Returns the cudaError_t of the launch.
extern "C" int maxpool3x3s2(int dtype, const void* x, void* y, long long planes, int h, int w,
                            int oh, int ow, void* stream) {
  return dispatch<false>(dtype, x, nullptr, nullptr, nullptr, nullptr, 0.f, y, planes, 1, h, w,
                         oh, ow, static_cast<cudaStream_t>(stream));
}

// z: (n, c, h, w) contiguous; bn_weight, bn_bias, bn_mean, bn_var: (c,)
// float32; y: (n, c, oh, ow) contiguous.  Returns the cudaError_t of the
// launch.
extern "C" int stem_pool(int dtype, const void* z, const void* bn_weight, const void* bn_bias,
                         const void* bn_mean, const void* bn_var, float eps, void* y, long long n,
                         int c, int h, int w, int oh, int ow, void* stream) {
  return dispatch<true>(dtype, z, static_cast<const float*>(bn_weight),
                        static_cast<const float*>(bn_bias), static_cast<const float*>(bn_mean),
                        static_cast<const float*>(bn_var), eps, y, n * c, c, h, w, oh, ow,
                        static_cast<cudaStream_t>(stream));
}
