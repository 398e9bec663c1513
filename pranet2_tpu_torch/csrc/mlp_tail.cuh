// The tail of the PVTv2 MLP half in csrc/pvt_mlp.cu (gelu_poly is also
// mlp_fused.cuh's): from the float32 hidden z = fc1(LN(x)) to the output,
//   dw_gelu_kernel: g = GELU_poly(dwconv3x3(z) + bias), cast to x's type;
//   fc2_kernel:     out = x + fc2(g), with the `stats` or `final_ln`
//                   epilogue where asked.
// The arithmetic of pranet2_tpu/ops/pvt_mlp.py::_kernel: the depthwise 3x3
// zero-pads the fc1 output (bias included) and sums its taps in f32, column
// of taps outer, row inner, then adds its bias; GELU through the clipped
// degree-5 polynomial erf; fc2 accumulates in f32 and adds its bias; the
// output x + out is rounded in x's type.
#pragma once

#include "tile.cuh"

namespace mlp {

using tile::kSpan;
using tile::kThreads;
using tile::kWarps;
using tile::WarpBlock;

constexpr int kFc2Rows = 32;   // tokens per fc2 block (the caller pads g to it)
constexpr int kDwThreads = 128;
constexpr int kDwVec = 4;      // hidden channels per dw_gelu thread

enum Mode { kPlain = 0, kStats = 1, kFinalLn = 2 };

// GELU with erf(x / sqrt 2) ~ xc * P(xc^2), xc = clip(x, -3.5, 3.5): the
// TPU kernel's _gelu_erf and its _ERF_COEF, Horner from the top.
__device__ __forceinline__ float gelu_poly(float x) {
  const float xc = fminf(fmaxf(x, -3.5f), 3.5f);
  const float u = xc * xc;
  float p = -1.7651197891844647e-06f;
  p = p * u + 8.08939954863686e-05f;
  p = p * u + -0.0015805384199393212f;
  p = p * u + 0.017675043414989475f;
  p = p * u + -0.13004687058013398f;
  p = p * u + 0.79677470225491f;
  return 0.5f * x * (1.f + xc * p);
}

// One block per image row (blockIdx.x over N*H) and 512 hidden channels
// (blockIdx.y); each thread walks the row's pixels for kDwVec channels with
// the 3x3 window of hidden values in registers, so a value is loaded once
// for each of the three output rows it feeds, and the taps once a row.
// Out-of-image taps read zeros and are summed like the others, as the TPU
// kernel sums its zeroed border rows.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    dw_gelu_kernel(const float* __restrict__ z, const T* __restrict__ dwk,
                   const T* __restrict__ dwb, T* __restrict__ g, int h, int w, int c) {
  const int ch0 = (blockIdx.y * kDwThreads + threadIdx.x) * kDwVec;
  if (ch0 >= c) return;
  const int q = blockIdx.x;
  const int row = q % h, plane = q - row;  // first row of this image, in rows of N*H
  float k[3][3][kDwVec], bias[kDwVec];
#pragma unroll
  for (int j = 0; j < kDwVec; ++j) {
#pragma unroll
    for (int t = 0; t < 9; ++t) k[t / 3][t % 3][j] = to_f32<T>(dwk[(ch0 + j) * 9 + t]);
    bias[j] = to_f32<T>(dwb[ch0 + j]);
  }
  auto load = [&](int rr, int cc) {
    if (rr < 0 || rr >= h || cc < 0 || cc >= w) return make_float4(0.f, 0.f, 0.f, 0.f);
    return *reinterpret_cast<const float4*>(z + ((long long)(plane + rr) * w + cc) * c + ch0);
  };
  float4 win[3][3];  // win[dj][di]: column col + dj - 1, row row + di - 1
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    win[0][di] = make_float4(0.f, 0.f, 0.f, 0.f);
    win[1][di] = load(row + di - 1, 0);
  }
  T* out = g + ((long long)q * w) * c + ch0;
  for (int col = 0; col < w; ++col, out += c) {
#pragma unroll
    for (int di = 0; di < 3; ++di) win[2][di] = load(row + di - 1, col + 1);
    float acc[kDwVec] = {};
#pragma unroll
    for (int dj = 0; dj < 3; ++dj)
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const float zs[kDwVec] = {win[dj][di].x, win[dj][di].y, win[dj][di].z, win[dj][di].w};
#pragma unroll
        for (int j = 0; j < kDwVec; ++j) acc[j] += zs[j] * k[di][dj][j];
      }
#pragma unroll
    for (int j = 0; j < kDwVec; ++j) out[j] = from_f32<T>(gelu_poly(acc[j] + bias[j]));
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      win[0][di] = win[1][di];
      win[1][di] = win[2][di];
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    fc2_kernel(const T* __restrict__ g, const T* __restrict__ w2, const T* __restrict__ b2,
               const T* __restrict__ x, const float* __restrict__ fg,
               const float* __restrict__ fb, T* __restrict__ out, float* __restrict__ mu_out,
               float* __restrict__ rstd_out, long long m, int c, int d, float eps2) {
  constexpr int S = kSpan<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);  // kFc2Rows x d
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kFc2Rows;
  for (int t = warp; t < (kFc2Rows / S) * (d / S); t += kWarps) {
    const int tr = t % (kFc2Rows / S), tc = t / (kFc2Rows / S);
    WarpBlock<T> acc;
    acc.zero();
    acc.mma_abt(g + (row0 + tr * S) * c, c, w2 + (long long)tc * S * c, c, c);
    acc.store(acc_s + tr * S * d + tc * S, d);
  }
  __syncthreads();

  for (int r = warp; r < kFc2Rows; r += kWarps) {
    const long long row = row0 + r;
    if (row >= m) continue;
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float* a = acc_s + r * d;
    float s = 0.f, ss = 0.f;
    for (int cc = lane; cc < d; cc += 32) {
      const float o = a[cc] + to_f32<T>(b2[cc]);
      float v;
      if (MODE == kFinalLn) {
        v = to_f32<T>(xr[cc]) + o;  // no rounding before the stage LN
        a[cc] = v;
      } else {
        v = round_to<T>(to_f32<T>(xr[cc]) + round_to<T>(o));
        orow[cc] = from_f32<T>(v);
      }
      s += v;
      ss += v * v;
    }
    if (MODE == kPlain) continue;
    const float mu = tile::warp_sum(s) / d;
    const float var = tile::warp_sum(ss) / d - mu * mu;
    const float rstd = rsqrtf(var + eps2);
    if (MODE == kStats && lane == 0) {
      mu_out[row] = mu;
      rstd_out[row] = rstd;
    }
    if (MODE == kFinalLn) {
      for (int cc = lane; cc < d; cc += 32)
        orow[cc] = from_f32<T>((a[cc] - mu) * rstd * fg[cc] + fb[cc]);
    }
  }
}

// dw_gelu_kernel over m = N*H*W tokens of h x w images, c hidden channels.
template <typename T>
int launch_dw_gelu(const float* z, const void* dwk, const void* dwb, void* g, long long m, int h,
                   int w, int c, cudaStream_t s) {
  const dim3 grid((unsigned)(m / w), (c + kDwThreads * kDwVec - 1) / (kDwThreads * kDwVec));
  dw_gelu_kernel<T><<<grid, kDwThreads, 0, s>>>(z, static_cast<const T*>(dwk),
                                                static_cast<const T*>(dwb), static_cast<T*>(g),
                                                h, w, c);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_fc2(const void* g, const void* w2, const void* b2, const void* x, const float* fg,
               const float* fb, void* out, float* mu, float* rstd, long long m, int c, int d,
               float eps2, cudaStream_t s) {
  const size_t smem = (size_t)kFc2Rows * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fc2_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fc2_kernel<T, MODE><<<(unsigned)((m + kFc2Rows - 1) / kFc2Rows), kThreads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(x), fg, fb, static_cast<T*>(out), mu, rstd, m, c, d, eps2);
  return (int)cudaGetLastError();
}

}  // namespace mlp
