// Warp-level matrix products from shared memory and asynchronous copies
// into it, for the redesigned PVT kernels (sra_kv.cuh, mlp_fused.cuh), the
// Res2Net products (res2_gemm.cuh) and the depthwise 3x3 (dwconv.cu).
//
// A warp holds an (MT*16) x (NT*8) float32 accumulator in the register
// layout of mma.sync.m16n8k16: for tile (mt, nt), lane l holds rows
// l/4 and l/4 + 8, columns 2*(l%4) and 2*(l%4) + 1.
// mma_abt adds A B^T, A (rows x k) and B (cols x k) both row-major in
// shared memory (B in torch Linear weight layout: its rows are the output
// columns).  bfloat16: ldmatrix + mma.sync (bf16 in, f32 accumulate); the
// leading dimensions are multiples of 8 elements (16-byte rows; padding
// them by 8 keeps ldmatrix free of bank conflicts), k a multiple of 16 and
// NT even.  float32: FMA loops over the same register layout, for the
// float32 kernels, which no model serves.  No library GEMM is called.
#pragma once

#include "common.cuh"

#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src must
// still be a valid address).  Both 16-byte aligned.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 8 or 4 bytes global -> shared, asynchronously (zeros when !valid); both
// aligned to the copy's size.
__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols of T from global g (row stride gld) to shared s (row stride
// sld), rows at or past `valid` zero-filled; cols * sizeof(T) and both
// strides' bytes multiples of 16.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void cp_tile(T* s, int sld, const T* g, long long gld, int rows,
                                        int cols, int valid) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = cols / V;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * V;
    const bool ok = r < valid;
    cp16(s + r * sld + c, g + (ok ? r * gld + c : 0), ok);
  }
}

// n > 0 contiguous elements of T at global g, of any alignment, to shared
// memory: the 16-byte granules of global memory that hold them are copied
// to s (16-byte aligned) by cp.async, so g[i] lands at s[off + i], off (the
// return value) g's offset in its granule in elements.  The granules lie
// inside g's allocation (cudaMalloc gives whole 16-byte granules), and
// span_bytes(n) bytes at s take them.  Every thread of the block calls it;
// commit, wait and __syncthreads before reading.
template <typename T>
__device__ __forceinline__ int cp_span(T* s, const T* g, long long n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const uintptr_t lo = a & ~uintptr_t(15);
  const long long chunks = (long long)((a + n * sizeof(T) + 15 - lo) / 16);
  for (long long i = threadIdx.x; i < chunks; i += blockDim.x)
    cp16(reinterpret_cast<char*>(s) + 16 * i, reinterpret_cast<const char*>(lo + 16 * i), true);
  return (int)((a - lo) / sizeof(T));
}

template <typename T>
__host__ __device__ constexpr long long span_bytes(long long n) {
  return (n * (long long)sizeof(T) + 15) / 16 * 16 + 16;
}

template <typename T, int MT, int NT>
struct Acc {
  float v[MT][NT][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[m][n][i] = 0.f;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The four 8x8 matrices transposed: from a k x m tile stored row-major
// (m contiguous) the A fragment of its m x k transpose.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, int NT>
__device__ __forceinline__ void mma_abt(Acc<bf16, MT, NT>& acc, const bf16* a, int lda,
                                        const bf16* b, int ldb, int k) {
  static_assert(NT % 2 == 0, "NT must be even");
  const int lane = threadIdx.x & 31;
  // A: matrices (rows 0-7, k0), (8-15, k0), (0-7, k0+8), (8-15, k0+8)
  const bf16* pa = a + (lane & 15) * lda + (lane >> 4) * 8;
  // B: (cols 0-7, k0), (0-7, k0+8), (8-15, k0), (8-15, k0+8)
  const bf16* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int kk = 0; kk < k; kk += 16) {
    uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(af[m], pa + m * 16 * lda + kk);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) ldsm_x4(bfr[n], pb + n * 16 * ldb + kk);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_bf16(acc.v[m][n], af[m], bfr[n / 2][(n & 1) * 2], bfr[n / 2][(n & 1) * 2 + 1]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void mma_abt(Acc<float, MT, NT>& acc, const float* a, int lda,
                                        const float* b, int ldb, int k) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int kk = 0; kk < k; ++kk) {
    float av[MT][2], bv[NT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      av[m][0] = a[(m * 16 + g) * lda + kk];
      av[m][1] = a[(m * 16 + g + 8) * lda + kk];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      bv[n][0] = b[(n * 8 + 2 * q) * ldb + kk];
      bv[n][1] = b[(n * 8 + 2 * q + 1) * ldb + kk];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc.v[m][n][i] = fmaf(av[m][i >> 1], bv[n][i & 1], acc.v[m][n][i]);
  }
}

// Shared memory a block may use (227 KB).
constexpr int kSmemBlock = 232448;

// Streaming multiprocessors of the current device (132 on the H100 SXM):
// the launches pick tiles that give every one of them a block.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  return sms;
}

// Two consecutive elements of T, loaded or stored at once.
template <typename T>
struct alignas(2 * sizeof(T)) Two {
  T v[2];
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  Two<T> t;
  t.v[0] = from_f32<T>(a);
  t.v[1] = from_f32<T>(b);
  *reinterpret_cast<Two<T>*>(p) = t;
}

// Shared-memory row stride (elements) for k columns of T: 16 bytes of
// padding, so that ldmatrix's eight row addresses fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int padded(int k) {
  return k + 16 / (int)sizeof(T);
}

}  // namespace mma
