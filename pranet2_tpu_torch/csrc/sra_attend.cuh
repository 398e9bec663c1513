// The attention of a PVTv2 SRA half over channels-last tokens x (N, H, W, D)
// with K and V given, shared by csrc/pvt_attn.cu and csrc/pvt_block.cu:
//   out = x + proj(concat_h softmax(q_h K_h^T) V_h),  q = LN1(x) Wq^T + bq
// K and V come as the kv Linear's output (N, Tkv, 2D): K is channels
// [0, D), V channels [D, 2D), head h at [h*hd, (h+1)*hd).
//
// The arithmetic of pranet2_tpu/ops/pvt_attn.py::_kernel and ::_attend: LN1
// in f32 (var = E[x^2] - mu^2) cast to x's type; q in f32 plus its bias,
// then times 1/sqrt(hd), cast to x's type; scores in f32; the row max
// subtracted, exp in f32, p cast to x's type, PV in f32, divided by the f32
// row sum after PV; the heads concatenated and cast; proj in f32 plus its
// bias.  The epilogue (template argument) sets the residual's roundings:
//   kRoundedResidual  x + round(out), rounded in x's type (_kernel, v1);
//   kExactResidual    round(x + out) (_attend, the whole-half and
//                     whole-block kernels).
//
// Design: one block of 4 warps per 32 query rows of one image (16 rows for
// float32), everything between x and out in shared memory:
//   LN1 rows -> ys; Q = ys Wq^T for all heads, 32x32 WMMA blocks (Wq
//   fragments through L2) -> qs; per head: K_h, V_h -> shared memory in
//   16-byte loads, zero-padded to a multiple of 32 rows; S = q_h K_h^T
//   (f32, whole Tkv row, so the max is exact before the exp, as the TPU
//   kernel has it); P = exp(S - max) in x's type and the row sums;
//   O_h = P V_h / sum -> into ys, which LN1 no longer needs; then
//   out = x + (ys Wp^T + bp).  The scores' region doubles as the warps'
//   staging for the epilogues, which run when it holds no scores.
// K and V are staged again by each block of an image (L2 hits: at most
// 248 KB an image at stage 4).
#pragma once

#include "tile.cuh"

namespace sra {

using tile::kSpan;
using tile::kThreads;
using tile::kWarps;
using tile::WarpBlock;

enum Epilogue { kRoundedResidual = 0, kExactResidual = 1 };

// Query rows per block; K/V rows are padded to a multiple of 32.
template <typename T>
constexpr int kBlockRows = sizeof(T) == 4 ? 16 : 32;

__host__ __device__ inline int padded_tkv(int tkv) { return (tkv + 31) / 32 * 32; }

// Floats of the region that holds the scores and, in the phases without
// scores, the warps' staging blocks.
template <typename T>
__host__ __device__ inline int score_floats(int tkvp) {
  const int scores = kBlockRows<T> * tkvp, stage = kWarps * kSpan<T> * kSpan<T>;
  return scores > stage ? scores : stage;
}

template <typename T>
size_t smem_bytes(int d, int hd, int tkvp) {
  constexpr int bm = kBlockRows<T>;
  return 2 * (size_t)bm * d * sizeof(T) + 2 * (size_t)tkvp * hd * sizeof(T) +
         score_floats<T>(tkvp) * sizeof(float) + (size_t)bm * tkvp * sizeof(T) +
         bm * sizeof(float);
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads)
    sra_kernel(const T* __restrict__ x, const float* __restrict__ lng,
               const float* __restrict__ lnb, const T* __restrict__ wq,
               const T* __restrict__ bq, const T* __restrict__ kv, const T* __restrict__ wp,
               const T* __restrict__ bp, T* __restrict__ out, int hw, int d, int nh, int tkv,
               float eps, float scale) {
  constexpr int BM = kBlockRows<T>, S = kSpan<T>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte K/V load
  const int hd = d / nh, tkvp = padded_tkv(tkv);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);  // BM x d: LN1(x), later the heads' outputs
  T* qs = ys + BM * d;                  // BM x d
  T* ks = qs + BM * d;                  // tkvp x hd
  T* vs = ks + tkvp * hd;               // tkvp x hd
  float* sc = reinterpret_cast<float*>(vs + tkvp * hd);  // BM x tkvp scores
  float* stage = sc;  // kWarps x S x S, in the phases that hold no scores
  T* ps = reinterpret_cast<T*>(sc + score_floats<T>(tkvp));  // BM x tkvp
  float* den = reinterpret_cast<float*>(ps + BM * tkvp);     // BM

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * S * S;
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const T* xi = x + (long long)img * hw * d;
  tile::layer_norm_rows<T>(xi, row0, hw, BM, d, lng, lnb, eps, ys);
  __syncthreads();

  for (int t = warp; t < (BM / S) * (d / S); t += kWarps) {
    const int tr = t % (BM / S), tc = t / (BM / S);
    WarpBlock<T> acc;
    acc.zero();
    acc.mma_abt(ys + tr * S * d, d, wq + (long long)tc * S * d, d, d);
    acc.store(st, S);
    tile::for_staged<T>(st, tr, tc, BM, [&](int r, int col, float v) {
      qs[r * d + col] = from_f32<T>((v + to_f32<T>(bq[col])) * scale);
    });
  }
  __syncthreads();

  const T* kvi = kv + (long long)img * tkv * 2 * d;
  for (int h = 0; h < nh; ++h) {
    for (int i = threadIdx.x * VEC; i < tkvp * hd; i += kThreads * VEC) {
      const int t = i / hd, k = i % hd;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = kval;  // zeros in any T
      if (t < tkv) {
        const T* src = kvi + (long long)t * 2 * d + h * hd + k;
        kval = *reinterpret_cast<const uint4*>(src);
        vval = *reinterpret_cast<const uint4*>(src + d);
      }
      *reinterpret_cast<uint4*>(ks + i) = kval;
      *reinterpret_cast<uint4*>(vs + i) = vval;
    }
    __syncthreads();

    for (int t = warp; t < (BM / S) * (tkvp / S); t += kWarps) {
      const int tr = t % (BM / S), tc = t / (BM / S);
      WarpBlock<T> acc;
      acc.zero();
      acc.mma_abt(qs + tr * S * d + h * hd, d, ks + tc * S * hd, hd, hd);
      acc.store(sc + tr * S * tkvp + tc * S, tkvp);
    }
    __syncthreads();

    for (int r = warp; r < BM; r += kWarps) {
      const float* sr = sc + r * tkvp;
      T* pr = ps + r * tkvp;
      float mx = -INFINITY;
      for (int j = lane; j < tkv; j += 32) mx = fmaxf(mx, sr[j]);
      mx = tile::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < tkvp; j += 32) {
        float p = 0.f;
        if (j < tkv) {
          p = expf(sr[j] - mx);
          sum += p;
        }
        pr[j] = from_f32<T>(p);
      }
      sum = tile::warp_sum(sum);
      if (lane == 0) den[r] = sum;
    }
    __syncthreads();

    for (int t = warp; t < (BM / S) * (hd / S); t += kWarps) {
      const int tr = t % (BM / S), tc = t / (BM / S);
      WarpBlock<T> acc;
      acc.zero();
      acc.mma_ab(ps + tr * S * tkvp, tkvp, vs + tc * S, hd, tkvp);
      acc.store(st, S);
      tile::for_staged<T>(st, tr, tc, BM, [&](int r, int col, float v) {
        ys[r * d + h * hd + col] = from_f32<T>(v / den[r]);
      });
    }
    __syncthreads();
  }

  // the block's rows of out
  T* oi = out + (long long)img * hw * d;
  for (int t = warp; t < (BM / S) * (d / S); t += kWarps) {
    const int tr = t % (BM / S), tc = t / (BM / S);
    WarpBlock<T> acc;
    acc.zero();
    acc.mma_abt(ys + tr * S * d, d, wp + (long long)tc * S * d, d, d);
    acc.store(st, S);
    tile::for_staged<T>(st, tr, tc, BM, [&](int r, int col, float v) {
      const int row = row0 + r;
      if (row < hw) {
        const long long idx = (long long)row * d + col;
        const float p = v + to_f32<T>(bp[col]);
        oi[idx] = from_f32<T>(to_f32<T>(xi[idx]) + (EPI == kRoundedResidual ? round_to<T>(p) : p));
      }
    });
  }
}

// One launch over n images of hw tokens; see pvt_sra_attention for the
// arguments.  Returns the cudaError_t of the launch.
template <typename T, int EPI>
int launch(const void* x, const float* lng, const float* lnb, const void* wq, const void* bq,
           const void* kv, const void* wp, const void* bp, void* out, int n, int hw, int d,
           int nh, int tkv, float eps, float scale, cudaStream_t s) {
  constexpr int BM = kBlockRows<T>;
  const size_t smem = smem_bytes<T>(d, d / nh, padded_tkv(tkv));
  cudaError_t err = cudaFuncSetAttribute(sra_kernel<T, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a request over the block's limit: clear it, so
    return (int)err;     // that the next launch does not report it again
  }
  const dim3 grid((hw + BM - 1) / BM, n);
  sra_kernel<T, EPI><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), lng, lnb, static_cast<const T*>(wq), static_cast<const T*>(bq),
      static_cast<const T*>(kv), static_cast<const T*>(wp), static_cast<const T*>(bp),
      static_cast<T*>(out), hw, d, nh, tkv, eps, scale);
  return (int)cudaGetLastError();
}

}  // namespace sra
