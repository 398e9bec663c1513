// Helpers shared by the port's kernels: float conversion for the three
// element types the wrappers accept, and the dtype codes they pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// Must match pranet2_tpu_torch/ops/_build.py::DTYPE_CODES; kFloat64 only
// the standalone DSRA gate takes (ops/dsra.py::GATE_CODES).
enum DType { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2, kFloat64 = 3 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half(v); }

// Round a float to T and back: reproduces one elementwise op done in T.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Blocks for a grid-stride loop over `total` elements.
inline unsigned int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 1LL << 30;
  return (unsigned int)(blocks < cap ? blocks : cap);
}
