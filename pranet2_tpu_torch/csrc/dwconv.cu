// Depthwise 3x3 convolution, stride 1, zero "same" padding, no bias, over
// channels-last x (N, H, W, C) with taps w (3, 3, C):
//   out[n, i, j, c] = sum_{di, dj} x[n, i + di - 1, j + dj - 1, c] w[di, dj, c]
// summed in float32 from zero, di outer and dj inner, each product and sum
// rounded as float32 (no fused multiply-add), out in x's type.
//
// Replaces pranet2_tpu/ops/dwconv.py::_dw_kernel (launcher
// depthwise_conv3x3), with its arithmetic: the TPU kernel adds the nine
// products to a float32 accumulator in that order, and is exact against
// a plain float32 reference.
//
// What bounds it: 17 operations per output element against 2-8 bytes in
// and out, so the bytes: at (16, 88, 88, 512) bf16 a call moves 127 MB, 38
// us at 3.35 TB/s.  Design: one block per image row (blockIdx.x over N*H)
// and a span of channels (blockIdx.y); a thread takes VEC channels (16
// bytes: 8 bf16 or 4 float32, or 1 where C does not allow it) and walks the
// row's pixels with the 3x3 window in registers, so each value of x is
// loaded once for each of the three output rows it feeds (neighbouring
// rows' blocks share it through L1/L2) and each output written once, in
// 16-byte stores.  Out-of-image taps read zeros and are summed like the
// others.

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 128;

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32<T>(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32<T>(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f32<T>(v[j]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int h,
                 int wd, int c) {
  const int ch0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (ch0 >= c) return;
  const int q = blockIdx.x;
  const int row = q % h, plane = q - row;  // first row of this image, in rows of N*H
  float k[3][3][VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t) load_vec<T, VEC>(w + (long long)t * c + ch0, k[t / 3][t % 3]);
  auto load = [&](int rr, int cc, float* v) {
    if (rr < 0 || rr >= h || cc < 0 || cc >= wd) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = 0.f;
    } else {
      load_vec<T, VEC>(x + ((long long)(plane + rr) * wd + cc) * c + ch0, v);
    }
  };
  float win[3][3][VEC];  // win[dj][di]: column col + dj - 1, row row + di - 1
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    load(row + di - 1, -1, win[0][di]);
    load(row + di - 1, 0, win[1][di]);
  }
  T* o = out + (long long)q * wd * c + ch0;
  for (int col = 0; col < wd; ++col, o += c) {
#pragma unroll
    for (int di = 0; di < 3; ++di) load(row + di - 1, col + 1, win[2][di]);
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(win[dj][di][j], k[di][dj][j]));
    store_vec<T, VEC>(o, acc);
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        win[0][di][j] = win[1][di][j];
        win[1][di][j] = win[2][di][j];
      }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int n, int h, int wd, int c,
           cudaStream_t s) {
  const int lanes = (c + VEC - 1) / VEC;  // threads a row needs
  const int threads = lanes < kMaxThreads ? (lanes + 31) / 32 * 32 : kMaxThreads;
  const dim3 grid((unsigned)n * h, (lanes + threads - 1) / threads);
  dw3x3_kernel<T, VEC><<<grid, threads, 0, s>>>(static_cast<const T*>(x),
                                                static_cast<const T*>(w), static_cast<T*>(out),
                                                h, wd, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* w, void* out, int n, int h, int wd, int c,
               cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  if (c % kVec == 0 && (addr(x) | addr(w) | addr(out)) % 16 == 0)
    return launch<T, kVec>(x, w, out, n, h, wd, c, s);
  return launch<T, 1>(x, w, out, n, h, wd, c, s);
}

}  // namespace

// x, out: (n, h, w, c) contiguous, type `dtype`; w (3, 3, c) of the same
// type.  16-byte loads and stores where c and the pointers allow them.
// n * h below 2^31.  Returns the cudaError_t of the launch.
extern "C" int depthwise_conv3x3(int dtype, const void* x, const void* w, void* out, int n, int h,
                                 int wd, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_any<float>(x, w, out, n, h, wd, c, s);
    case kBFloat16:
      return launch_any<__nv_bfloat16>(x, w, out, n, h, wd, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
