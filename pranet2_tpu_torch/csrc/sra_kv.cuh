// The K/V path of a PVTv2 SRA half, shared by csrc/pvt_kv.cu and
// csrc/pvt_block.cu: from channels-last tokens x (N, H, W, D) to the kv
// Linear's output (N, Tkv, 2D) in x's type, Tkv = (H / sr) * (W / sr)
// (the VALID sr x sr, stride-sr convolution's floor):
//   sr > 1:  kv = (LN_kv(P Wsr^T + bsr) in x's type) Wkv^T + bkv,
//            P the sr x sr patch of LN1(x) under each K/V token;
//   sr = 1:  kv = LN1(x) Wkv^T + bkv.
// The arithmetic of pranet2_tpu/ops/pvt_attn.py::_kernel_v2 up to _attend:
// LN1 in f32 (var = E[x^2] - mu^2) cast to x's type; the patch product in
// f32 plus bsr in f32; the kv LN in f32 with its own eps, cast to x's type;
// the kv product in f32 plus bkv in f32, cast to x's type.  (The module
// chain and reference_sra_block round the sr convolution's output to x's
// type and add both biases in it; the kernel does not.)
//
// Design: one block of 4 warps per 32 K/V tokens of one image (16 for
// float32).  A token's patch is sr rows of sr pixels; the block walks the
// patch rows si: LN1 of the sr pixels of row si of each of its tokens,
// straight from x into shared memory (sr * D contiguous channels a token,
// so the patches tensor is never written), then the partial product of
// that K-chunk with the weight's columns for row si, added to a float32
// sum in shared memory.  The weight comes as (D, sr, sr, D), the torch
// convolution's (D, D, sr, sr) with its input channels last, so that a
// chunk is a contiguous K range.  Then bsr and the kv LN on the float32
// rows, the kv product (2D output columns in 32x32 WMMA blocks, Wkv
// fragments through L2) and bkv.  Each pixel of x under a patch is read
// once; pixels past the floor are not read.
//
// Why a launch of its own: every query block of an image needs all of the
// image's K/V tokens.  Made inside each of the 242 query blocks of a stage-1
// image, the patch product alone would cost 63 MFLOP a block.
#pragma once

#include "tile.cuh"

namespace kvpath {

using tile::kSpan;
using tile::kThreads;
using tile::kWarps;
using tile::WarpBlock;

// K/V tokens per block: one warp block's rows.
template <typename T>
constexpr int kRows = kSpan<T>;

struct Args {
  const void* x;     // (n, h, w, d), type T
  const float* lng;  // LN1 (d) and its eps
  const float* lnb;
  float eps;
  const void* wsr;   // (d, sr, sr, d) type T, sr > 1 only
  const void* bsr;   // (d) type T
  const float* kng;  // kv LN (d) and its eps, sr > 1 only
  const float* knb;
  float keps;
  const void* wkv;   // (2d, d) type T
  const void* bkv;   // (2d) type T
  void* kv;          // (n, tkv, 2d) type T
  int h, w, d, sr;
};

template <typename T>
size_t smem_bytes(int d, int sr) {
  constexpr int R = kRows<T>, S = kSpan<T>;
  size_t b = (size_t)kWarps * S * S * sizeof(float) + (size_t)R * d * sizeof(T);
  if (sr > 1) b += (size_t)R * d * sizeof(float) + (size_t)R * sr * d * sizeof(T);
  return b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) kv_kernel(Args a) {
  constexpr int R = kRows<T>, S = kSpan<T>;
  const int d = a.d, sr = a.sr, ws = a.w / sr, tkv = (a.h / sr) * ws;
  const int img = blockIdx.y, t0 = blockIdx.x * R, valid = min(R, tkv - t0);
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);          // kWarps x S x S
  float* sum = stage + kWarps * S * S;                     // R x d, sr > 1
  T* kvi = reinterpret_cast<T*>(sum + (sr > 1 ? R * d : 0));  // R x d
  T* patch = kvi + R * d;                                  // R x sr*d, sr > 1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * S * S;
  const T* xi = static_cast<const T*>(a.x) + (long long)img * a.h * a.w * d;

  if (sr > 1) {
    const int kc = sr * d;  // one patch row: sr pixels of d channels
    const int k = sr * kc;
    const T* wsr = static_cast<const T*>(a.wsr);
    for (int i = threadIdx.x; i < R * d; i += kThreads) sum[i] = 0.f;
    for (int si = 0; si < sr; ++si) {
      for (int p = warp; p < R * sr; p += kWarps) {
        const int t = p / sr, sj = p % sr;
        T* dst = patch + t * kc + sj * d;
        if (t >= valid) {
          for (int c = lane; c < d; c += 32) dst[c] = from_f32<T>(0.f);
          continue;
        }
        const int pi = (t0 + t) / ws, pj = (t0 + t) % ws;
        const T* src = xi + ((long long)(pi * sr + si) * a.w + pj * sr + sj) * d;
        tile::layer_norm_row<T>(src, d, a.lng, a.lnb, a.eps, dst);
      }
      __syncthreads();
      for (int t = warp; t < (R / S) * (d / S); t += kWarps) {
        const int tr = t % (R / S), tc = t / (R / S);
        WarpBlock<T> acc;
        acc.zero();
        acc.mma_abt(patch + tr * S * kc, kc, wsr + (long long)tc * S * k + si * kc, k, kc);
        acc.store(st, S);
        tile::for_staged<T>(st, tr, tc, R, [&](int r, int col, float v) { sum[r * d + col] += v; });
      }
      __syncthreads();
    }
    const T* bsr = static_cast<const T*>(a.bsr);
    for (int r = warp; r < R; r += kWarps) {
      float* row = sum + r * d;
      T* dst = kvi + r * d;
      if (r >= valid) {
        for (int c = lane; c < d; c += 32) dst[c] = from_f32<T>(0.f);
        continue;
      }
      float s = 0.f, ss = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float v = row[c] + to_f32<T>(bsr[c]);
        row[c] = v;
        s += v;
        ss += v * v;
      }
      const float mu = tile::warp_sum(s) / d;
      const float var = tile::warp_sum(ss) / d - mu * mu;
      const float rstd = rsqrtf(var + a.keps);
      for (int c = lane; c < d; c += 32)
        dst[c] = from_f32<T>((row[c] - mu) * rstd * a.kng[c] + a.knb[c]);
    }
  } else {
    tile::layer_norm_rows<T>(xi, t0, tkv, R, d, a.lng, a.lnb, a.eps, kvi);
  }
  __syncthreads();

  const T* wkv = static_cast<const T*>(a.wkv);
  const T* bkv = static_cast<const T*>(a.bkv);
  T* kvo = static_cast<T*>(a.kv) + ((long long)img * tkv + t0) * 2 * d;
  for (int t = warp; t < (R / S) * (2 * d / S); t += kWarps) {
    const int tr = t % (R / S), tc = t / (R / S);
    WarpBlock<T> acc;
    acc.zero();
    acc.mma_abt(kvi + tr * S * d, d, wkv + (long long)tc * S * d, d, d);
    acc.store(st, S);
    tile::for_staged<T>(st, tr, tc, valid, [&](int r, int col, float v) {
      kvo[(long long)r * 2 * d + col] = from_f32<T>(v + to_f32<T>(bkv[col]));
    });
  }
}

// One launch over n images.  Returns the cudaError_t of the launch.
template <typename T>
int launch(const Args& a, int n, cudaStream_t s) {
  const size_t smem = smem_bytes<T>(a.d, a.sr);
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a request over the block's limit: clear it
    return (int)err;
  }
  const int tkv = (a.h / a.sr) * (a.w / a.sr);
  const dim3 grid((tkv + kRows<T> - 1) / kRows<T>, n);
  kv_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace kvpath
