// Building blocks of the PVT kernels: square blocks of a matrix product's
// output held by one warp with float32 accumulation, and the LayerNorm of a
// block's rows in the TPU kernels' arithmetic.
//
// bfloat16 blocks go through the tensor cores with WMMA (16x16x16 bf16 in,
// f32 accumulate).  float32 blocks are plain FMA loops.  No library GEMM is
// called.
#pragma once

#include "common.cuh"

#include <math.h>
#include <mma.h>

namespace tile {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp's 16x16 float32 accumulator for float32 operands: plain FMA
// loops, each lane owning one row and eight columns of the tile.  All lanes
// of the warp call every method; k is a multiple of 16.
//   mma_abt: acc += A B^T with A (16 x k) and B (16 x k), both row-major
//            (B in torch Linear weight layout: its rows are the output
//            columns);
//   mma_ab:  acc += A B with A (16 x k) and B (k x 16), both row-major;
//   store:   the tile to c, row-major with leading dimension ldc.
struct FmaTile {
  float acc[8];

  __device__ static int row() { return (threadIdx.x & 31) >> 1; }
  __device__ static int col() { return (threadIdx.x & 1) * 8; }

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  }

  __device__ void mma_abt(const float* a, int lda, const float* b, int ldb, int k) {
    const float* ar = a + (long long)row() * lda;
    const float* bc = b + (long long)col() * ldb;
    for (int kk = 0; kk < k; ++kk) {
      const float av = ar[kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(av, bc[(long long)j * ldb + kk], acc[j]);
    }
  }

  __device__ void mma_ab(const float* a, int lda, const float* b, int ldb, int k) {
    const float* ar = a + (long long)row() * lda;
    for (int kk = 0; kk < k; ++kk) {
      const float av = ar[kk];
      const float* br = b + (long long)kk * ldb + col();
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(av, br[j], acc[j]);
    }
  }

  __device__ void store(float* c, int ldc) {
    float* cr = c + (long long)row() * ldc + col();
#pragma unroll
    for (int j = 0; j < 8; ++j) cr[j] = acc[j];
  }
};

// Side of the square output block one warp holds: 32 (2 x 2 WMMA tiles) for
// bfloat16, 16 for float32.  Every M, N and K a kernel hands to WarpBlock
// is a multiple of it.
template <typename T>
constexpr int kSpan = sizeof(T) == 2 ? 32 : 16;

// One warp's kSpan x kSpan float32 accumulator, the same methods as
// FmaTile on (kSpan x k) A and B blocks.  For bfloat16 each 16-deep step
// loads two A and two B fragments and issues four WMMA products (16x16x16
// bf16 in, f32 accumulate); the pointers are 32-byte aligned and the
// leading dimensions multiples of 8 elements, in global or shared memory.
template <typename T>
struct WarpBlock;

template <>
struct WarpBlock<float> : FmaTile {};

template <>
struct WarpBlock<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) nvcuda::wmma::fill_fragment(acc[r][c], 0.f);
  }

  __device__ void mma_abt(const bf16* a, int lda, const bf16* b, int ldb, int k) {
    using namespace nvcuda::wmma;
    fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
    fragment<matrix_b, 16, 16, 16, bf16, col_major> fb[2];
    for (int kk = 0; kk < k; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load_matrix_sync(fa[i], a + (long long)i * 16 * lda + kk, lda);
        load_matrix_sync(fb[i], b + (long long)i * 16 * ldb + kk, ldb);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) mma_sync(acc[r][c], fa[r], fb[c], acc[r][c]);
    }
  }

  __device__ void mma_ab(const bf16* a, int lda, const bf16* b, int ldb, int k) {
    using namespace nvcuda::wmma;
    fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
    fragment<matrix_b, 16, 16, 16, bf16, row_major> fb[2];
    for (int kk = 0; kk < k; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load_matrix_sync(fa[i], a + (long long)i * 16 * lda + kk, lda);
        load_matrix_sync(fb[i], b + (long long)kk * ldb + i * 16, ldb);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) mma_sync(acc[r][c], fa[r], fb[c], acc[r][c]);
    }
  }

  __device__ void store(float* c, int ldc) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        nvcuda::wmma::store_matrix_sync(c + (long long)r * 16 * ldc + cc * 16, acc[r][cc], ldc,
                                        nvcuda::wmma::mem_row_major);
  }
};

// LayerNorm of one row of d channels, src to dst (type T), by one warp.
// The TPU kernels' arithmetic: float32 statistics with var = E[x^2] - mu^2,
// ((x - mu) * rsqrt(var + eps)) * gamma + beta, then a cast to T.
template <typename T>
__device__ void layer_norm_row(const T* __restrict__ src, int d, const float* __restrict__ gamma,
                               const float* __restrict__ beta, float eps, T* dst) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32<T>(src[c]);
    s += v;
    ss += v * v;
  }
  const float mu = warp_sum(s) / d;
  const float var = warp_sum(ss) / d - mu * mu;
  const float rstd = rsqrtf(var + eps);
  for (int c = lane; c < d; c += 32)
    dst[c] = from_f32<T>((to_f32<T>(src[c]) - mu) * rstd * gamma[c] + beta[c]);
}

// LayerNorm of rows [row0, row0 + rows) of x (d channels each; rows at or
// past `valid` do not exist and become zeros) into ys (rows x d, type T).
// One warp per row; every thread of the block calls it.
template <typename T>
__device__ void layer_norm_rows(const T* __restrict__ x, long long row0, long long valid,
                                int rows, int d, const float* __restrict__ gamma,
                                const float* __restrict__ beta, float eps, T* ys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    T* dst = ys + (long long)r * d;
    if (row0 + r >= valid) {
      for (int c = lane; c < d; c += 32) dst[c] = from_f32<T>(0.f);
      continue;
    }
    layer_norm_row<T>(x + (row0 + r) * d, d, gamma, beta, eps, dst);
  }
}

// Float32 rows of a block-sized matrix in shared memory through a product:
// each warp's staged kSpan x kSpan result `st` goes to fn(r, col, value) for
// the block's rows r < rows_valid (r and col relative to the tile (tr, tc)).
// Every lane of the warp calls it; it syncs the warp before and after.
template <typename T, typename Fn>
__device__ __forceinline__ void for_staged(const float* st, int tr, int tc, int rows_valid,
                                           Fn fn) {
  constexpr int S = kSpan<T>;
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int e = lane; e < S * S; e += 32) {
    const int r = tr * S + e / S;
    if (r < rows_valid) fn(r, tc * S + e % S, st[e]);
  }
  __syncwarp();
}

}  // namespace tile
