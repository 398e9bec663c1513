// The attention of a PVTv2 SRA half over channels-last tokens x (N, H, W, D)
// with K and V given, shared by csrc/pvt_attn.cu and csrc/pvt_block.cu:
//   out = x + proj(concat_h softmax(q_h K_h^T) V_h),  q = LN1(x) Wq^T + bq
// K and V come as the kv Linear's output (N, Tkv, 2D): K is channels
// [0, D), V channels [D, 2D), head h at [h*hd, (h+1)*hd).
//
// Replaces pranet2_tpu/ops/pvt_attn.py:43 _kernel, and the attention steps
// of pranet2_tpu/ops/pvt_attn.py:221 _kernel_v2 and
// pranet2_tpu/ops/pvt_block.py:105 _kernel_v3, with their arithmetic: LN1
// in f32 (var = E[x^2] - mu^2) cast to x's type; q in f32 plus its bias,
// then times 1/sqrt(hd), cast to x's type; scores in f32 with the exact
// max over the whole Tkv row; p = exp(s - max) in f32, the row sum from
// the unrounded p, p cast to x's type; PV in f32, divided by the sum after
// PV, cast; the heads concatenated; proj in f32 plus its bias.  Padded
// keys (j >= Tkv) enter neither the max nor the sum.  The epilogue
// (template argument) sets the residual's roundings:
//   kRoundedResidual  x + round(out), rounded in x's type (_kernel, v1);
//   kExactResidual    round(x + out) (_attend, the whole-half and
//                     whole-block kernels).
// Only the f32 summation orders (of the LN statistics, 8 lanes a row; of
// the products; of the row sums) differ from the plain version's.
//
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16; Tkv = 121 at every stage) a call does 2.5-5.9 GFLOP of products
// against 4-32 MB of x, K/V and weights in and out: 3-10 us at the card's
// peaks, bytes at stage 1 and operations at stages 2-4.  The first design
// ran one block per 32 query rows doing every head (64 blocks at stage 4),
// read the weights' WMMA fragments from L2 and passed scores, P and each
// head's output through shared memory with four barriers a head.  Here:
//   * a cluster of c blocks (c the largest divisor of nh up to 8: 1, 2,
//     5, 8 at PVTv2-b2) shares a tile of BM query rows of one image (64 in
//     bf16, 32 in float32); each block takes nh / c heads, so stage 4 runs
//     256 blocks;
//   * a block copies its x rows (with LN1's gamma and beta) and each
//     head's K_h, V_h (rows padded to a multiple of 128 with zeros,
//     ldmatrix-padded) to shared memory by cp.async, and LN1s the rows in
//     place, 8 lanes a row;
//   * two warps share each 16 rows, each taking 32 of every 64 product
//     columns; the q and proj products stream their weight rows through a
//     ring of two 64 x 32 chunks in shared memory (cp.async, one barrier a
//     chunk), the first chunk put in flight before the block's preceding
//     step (LN1, or the attention for proj).  (Deeper chunks, up to the
//     whole 64-row slice where shared memory allows, measured no faster.)
//   * a warp computes S = q_h K_h^T for 128 keys at a time in registers
//     (ldmatrix + mma.sync), the row max and sum reduced over a row's 4
//     lanes by shuffles, p packed to bf16 straight into the A fragments of
//     PV, V read by ldmatrix.trans, its 32 columns of O in registers until
//     they are divided and rounded.  Where Tkv > 128 a first pass over the
//     key tiles takes the exact max and a second one the exp, sum and PV
//     (no online rescaling, which would round p at other points);
//   * each block writes its heads' rounded O to its shared memory, then
//     pushes it, 16 bytes a store, into every peer's LN1 rows through
//     DSMEM: the first half of a cluster barrier (arrive) follows the
//     block's last read of LN1, the second (wait) precedes the push, and a
//     whole cluster barrier after it makes the rows visible, after which
//     no block touches a peer's memory.  Each block then computes its
//     d / c output columns of proj over K = d, plus bias and residual.  No
//     cross-block sum, no atomics: the result does not depend on the
//     schedule.
// Measured on the H100 (PERF.md): below the eager chain with SDPA at
// stages 1-2 by device time, not at stages 3-4, where a block's steps are
// latency-bound (two warps an SM sub-partition; at stage 4 one 132 KB
// block an SM, so its 256 blocks take at least two waves).
// float32 (checked on the card, served by no model) runs the same
// structure over mma.cuh's FMA path.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "mma.cuh"

namespace sra {

enum Epilogue { kRoundedResidual = 0, kExactResidual = 1 };

using bf16 = __nv_bfloat16;

// Query rows a block (BM); each 16 rows belong to kSplit warps, each of
// which takes kWarpCols of a product pass's kCols columns.
template <typename T>
constexpr int kRows = sizeof(T) == 2 ? 64 : 32;
constexpr int kSplit = 2;
template <typename T>
constexpr int kThreads = 32 * kSplit * kRows<T> / 16;  // 256 in bf16, 128 in float32
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;     // bf16: at most 128 registers
constexpr int kKeys = 128;                      // keys a register tile (16 n-tiles)
constexpr int kCols = 64;                       // product columns a pass
constexpr int kWarpCols = kCols / kSplit;       // a warp's: 4 n-tiles
constexpr int kStages = 2;                      // weight chunks a ring
constexpr int kDepth = 32;                      // columns a weight chunk

struct Args {
  const void* x;     // (n, hw, d) type T
  const float* lng;  // LN1 (d)
  const float* lnb;
  const void* wq;    // (d, d)
  const void* bq;    // (d)
  const void* kv;    // (n, tkv, 2d)
  const void* wp;    // (d, d)
  const void* bp;    // (d)
  void* out;         // (n, hw, d)
  int hw, d, nh, tkv;
  int heads;         // nh / c: heads a block
  float eps, scale;
};

__host__ __device__ inline int key_rows(int tkv) { return (tkv + kKeys - 1) / kKeys * kKeys; }

// The largest divisor of nh up to 8: blocks a cluster.
inline int cluster_size(int nh) {
  int c = nh < 8 ? nh : 8;
  while (nh % c) --c;
  return c;
}

// Shared memory of a block, offsets in elements of T: LN1 rows (later the
// concat rows), K_h and V_h, the weight ring, q rows, the block's heads'
// outputs (until the first head's output: LN1's gamma and beta in f32;
// hb * hd >= d / 8 leaves room for them).
template <typename T>
struct Smem {
  int ldd, ldh, ldw, ldo, kvr;
  size_t ys, ks, vs, wb, qs, os, bytes;
  __host__ __device__ Smem(int d, int hd, int hb, int tkv) {
    constexpr int bm = kRows<T>;
    ldd = mma::padded<T>(d);
    ldh = mma::padded<T>(hd);
    ldw = mma::padded<T>(kDepth);
    ldo = mma::padded<T>(hb * hd);
    kvr = key_rows(tkv);
    ys = 0;
    ks = ys + (size_t)bm * ldd;
    vs = ks + (size_t)kvr * ldh;
    wb = vs + (size_t)kvr * ldh;
    qs = wb + (size_t)kStages * kCols * ldw;
    os = qs + (size_t)bm * ldh;
    bytes = (os + (size_t)bm * ldo) * sizeof(T);
  }
};

// A weight's rows streamed through a ring of kStages chunks of 64 rows x
// kDepth columns in shared memory (cp.async, one barrier a chunk), for
// the q and proj products: start() puts the first chunk in flight, so
// that it can arrive while the block does other work; run() multiplies.
// Every thread of the block calls both.
template <typename T>
struct Ring {
  T* wb;
  int ldw;
  const T* w;
  int rows, d;

  __device__ __forceinline__ void fetch(int c) {
    if (c < d / kDepth)
      mma::cp_tile<T>(wb + (c % kStages) * kCols * ldw, ldw, w + c * kDepth, d, kCols, kDepth,
                      rows);
    mma::commit();  // empty past the last chunk: one group a step
  }

  // W: `rows_` (<= 64; the ring's other rows zeros) rows of a (., d_)
  // weight in device memory; d_ a multiple of kDepth.  The ring must be
  // free (run() returns with it free).
  __device__ __forceinline__ void start(const T* w_, int rows_, int d_) {
    w = w_;
    rows = rows_;
    d = d_;
    fetch(0);
  }

  // acc (the warp's 16 rows x kWarpCols columns from column `col` of the
  // weight rows) += A W^T over K = d, A the warp's rows in shared memory.
  // Groups committed after start() only make the waits wait for more.
  __device__ __forceinline__ void run(mma::Acc<T, 1, kWarpCols / 8>& acc, const T* a, int lda,
                                      int col) {
    const int chunks = d / kDepth;
    for (int c = 0; c < chunks; ++c) {
      mma::wait<0>();   // chunk c (and every older group) is in
      __syncthreads();  // ... for every thread; chunk c - 1 is done
      fetch(c + 1);     // into chunk c - 1's buffer
      mma::mma_abt(acc, a + c * kDepth, lda, wb + ((c % kStages) * kCols + col) * ldw, ldw,
                   kDepth);
    }
    __syncthreads();  // the ring is free for the next product
  }
};

// The two halves of cluster.sync(): arrive releases this thread's memory
// operations to the cluster, wait returns once every thread of the
// cluster has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
struct alignas(16) Eight {
  T v[8];
};

// LN1 of `rows` rows of d values in place (row stride ldd), 8 lanes a row,
// 8 values a piece: f32 statistics with var = E[x^2] - mu^2,
// ((v - mu) * rstd) * g + b cast to T; rows at or past `valid` zeros.  gs,
// bs: gamma and beta in shared memory.  Every thread of the block calls
// it; d a multiple of 32.
template <typename T>
__device__ __forceinline__ void ln_rows(T* ys, int ldd, int rows, int valid, int d,
                                        const float* gs, const float* bs, float eps) {
  const int l = threadIdx.x & 7;
  for (int r = threadIdx.x / 8; r < rows; r += blockDim.x / 8) {
    T* row = ys + r * ldd;
    float s = 0.f, ss = 0.f;
#pragma unroll 2
    for (int c = 8 * l; c < d; c += 64) {
      const Eight<T> v = *reinterpret_cast<const Eight<T>*>(row + c);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float f = to_f32<T>(v.v[k]);
        s += f;
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = s / d;
    const float rstd = rsqrtf(ss / d - mu * mu + eps);
    const bool ok = r < valid;
#pragma unroll 2
    for (int c = 8 * l; c < d; c += 64) {
      Eight<T> v = *reinterpret_cast<const Eight<T>*>(row + c);
      const Eight<float> g = *reinterpret_cast<const Eight<float>*>(gs + c);
      const Eight<float> b = *reinterpret_cast<const Eight<float>*>(bs + c);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v.v[k] = from_f32<T>(ok ? (to_f32<T>(v.v[k]) - mu) * rstd * g.v[k] + b.v[k] : 0.f);
      *reinterpret_cast<Eight<T>*>(row + c) = v;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// o (16 rows x kWarpCols) += P V over one register tile of keys: p in the
// accumulator layout of S (zero past the keys), V's `keys` rows from v
// (row stride ldv, from the warp's first column).  bfloat16: p packed into
// the A fragments of m16n8k16 (the accumulators of n-tiles 2k and 2k + 1
// are the A fragment of k-step k), V's B fragments by ldmatrix.trans.
__device__ __forceinline__ void pv(mma::Acc<bf16, 1, kWarpCols / 8>& o,
                                   const mma::Acc<bf16, 1, kKeys / 8>& p, const bf16* v, int ldv,
                                   int keys) {
  const int lane = threadIdx.x & 31;
  const bf16* vl = v + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldv + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    if (kk * 16 >= keys) break;
    const uint32_t a[4] = {pack_bf16(p.v[0][2 * kk][0], p.v[0][2 * kk][1]),
                           pack_bf16(p.v[0][2 * kk][2], p.v[0][2 * kk][3]),
                           pack_bf16(p.v[0][2 * kk + 1][0], p.v[0][2 * kk + 1][1]),
                           pack_bf16(p.v[0][2 * kk + 1][2], p.v[0][2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < kWarpCols / 16; ++np) {
      uint32_t b[4];
      mma::ldsm_x4_trans(b, vl + kk * 16 * ldv + np * 16);
      mma::mma_bf16(o.v[0][2 * np], a, b[0], b[1]);
      mma::mma_bf16(o.v[0][2 * np + 1], a, b[2], b[3]);
    }
  }
}

// float32: each p broadcast from the lane that holds it, FMA with V's rows.
__device__ __forceinline__ void pv(mma::Acc<float, 1, kWarpCols / 8>& o,
                                   const mma::Acc<float, 1, kKeys / 8>& p, const float* v,
                                   int ldv, int keys) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    if (n * 8 >= keys) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int src = g * 4 + (e >> 1);
      const float lo = __shfl_sync(0xffffffffu, p.v[0][n][e & 1], src);
      const float hi = __shfl_sync(0xffffffffu, p.v[0][n][2 + (e & 1)], src);
      const float* vr = v + (n * 8 + e) * ldv + 2 * q;
#pragma unroll
      for (int t = 0; t < kWarpCols / 8; ++t) {
        const float v0 = vr[t * 8], v1 = vr[t * 8 + 1];
        o.v[0][t][0] = fmaf(lo, v0, o.v[0][t][0]);
        o.v[0][t][1] = fmaf(lo, v1, o.v[0][t][1]);
        o.v[0][t][2] = fmaf(hi, v0, o.v[0][t][2]);
        o.v[0][t][3] = fmaf(hi, v1, o.v[0][t][3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warp's part of 16 query rows of one head: q in qw (16 x hd), K and V
// in ks, vs (kvr rows, zero past tkv); columns [c0, c0 + 32) of each 64 of
// the rounded softmax(q K^T) V into ow (16 x hd, row stride ldo).  Both
// warps of a row pair compute the same S, max and sum.
template <typename T>
__device__ __forceinline__ void attend_rows(const T* qw, const T* ks, const T* vs, int ldh,
                                            int kvr, int hd, int tkv, int c0, T* ow, int ldo) {
  if (c0 >= hd) return;  // hd 32: the pair's second warp has no columns
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int tiles = kvr / kKeys;
  mma::Acc<T, 1, kKeys / 8> s;
  auto scores = [&](int t) {
    s.zero();
    mma::mma_abt(s, qw, ldh, ks + t * kKeys * ldh, ldh, hd);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t * kKeys + n * 8 + 2 * q + (i & 1) >= tkv) s.v[0][n][i] = -INFINITY;
  };
  // the exact row max over every key tile (rows g and g + 8)
  float mx[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < tiles; ++t) {
    scores(t);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s.v[0][n][i]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  bool held = tiles == 1;  // S of a single tile is still in registers
  for (int oc = c0; oc < hd; oc += kCols) {
    mma::Acc<T, 1, kWarpCols / 8> o;
    o.zero();
    float sum[2] = {0.f, 0.f};
    for (int t = 0; t < tiles; ++t) {
      if (!held) scores(t);
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = expf(s.v[0][n][i] - mx[i >> 1]);  // 0 past tkv
          s.v[0][n][i] = p;
          sum[i >> 1] += p;
        }
      pv(o, s, vs + t * kKeys * ldh + oc, ldh, tkv - t * kKeys);
    }
    held = false;
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
#pragma unroll
    for (int n = 0; n < kWarpCols / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        mma::store2<T>(ow + (g + half * 8) * ldo + oc + n * 8 + 2 * q,
                       o.v[0][n][2 * half] / sum[half], o.v[0][n][2 * half + 1] / sum[half]);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads<T>, kMinBlocks<T>) attend_kernel(Args a) {
  namespace cg = cooperative_groups;
  constexpr int BM = kRows<T>, V = 16 / sizeof(T), NW = kWarpCols / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), c = (int)cluster.num_blocks();
  const int d = a.d, hd = d / a.nh, hb = a.heads, tkv = a.tkv, hbd = hb * hd;
  const Smem<T> L(d, hd, hb, tkv);
  extern __shared__ __align__(128) unsigned char smem[];
  T* base = reinterpret_cast<T*>(smem);
  T *ys = base + L.ys, *ks = base + L.ks, *vs = base + L.vs;
  T *qs = base + L.qs, *os = base + L.os;
  float* gs = reinterpret_cast<float*>(os);  // LN1's gamma and beta, until
  float* bs = gs + d;                        // the first head's output
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int wm = warp % (BM / 16), wc = warp / (BM / 16) * kWarpCols;  // rows, columns
  const long long row0 = (long long)blockIdx.x * BM;
  const int valid = (int)(a.hw - row0 < BM ? a.hw - row0 : BM);
  const long long tok0 = (long long)blockIdx.z * a.hw + row0;
  const T* x = static_cast<const T*>(a.x) + tok0 * d;
  const T* kv = static_cast<const T*>(a.kv) + (long long)blockIdx.z * tkv * 2 * d;
  const T* wq = static_cast<const T*>(a.wq);
  const T* bq = static_cast<const T*>(a.bq);
  const T* wp = static_cast<const T*>(a.wp);
  const int col0 = rank * hbd;  // the block's proj columns
  Ring<T> ring{base + L.wb, L.ldw};
  auto stage_kv = [&](int h) {
    mma::cp_tile<T>(ks, L.ldh, kv + h * hd, 2LL * d, L.kvr, hd, tkv);
    mma::cp_tile<T>(vs, L.ldh, kv + d + h * hd, 2LL * d, L.kvr, hd, tkv);
    mma::commit();
  };
  const auto cols_from = [](int total, int oc) { return total - oc < kCols ? total - oc : kCols; };

  // x's rows (zeros past hw) with gamma and beta, the first head's K/V
  // and Wq chunks in flight; then LN1 in place
  mma::cp_tile<T>(ys, L.ldd, x, d, BM, d, valid);
  mma::cp_tile<float>(gs, d, a.lng, 0, 1, d, 1);
  mma::cp_tile<float>(bs, d, a.lnb, 0, 1, d, 1);
  mma::commit();
  stage_kv(rank * hb);
  ring.start(wq + (long long)rank * hb * hd * d, cols_from(hd, 0), d);
  mma::wait<2>();  // x, gamma and beta are in
  __syncthreads();
  ln_rows<T>(ys, L.ldd, BM, valid, d, gs, bs, a.eps);
  __syncthreads();

  const T* yw = ys + wm * 16 * L.ldd;  // the warp's rows
  T* qw = qs + wm * 16 * L.ldh;
  for (int j = 0; j < hb; ++j) {
    const int h = rank * hb + j;
    const bool last = j == hb - 1;
    if (j > 0) stage_kv(h);  // the previous head is done with K/V
    // q_h = (LN1 Wq_h^T + bq_h) * scale in x's type
    for (int oc = 0; oc < hd; oc += kCols) {
      const int cols = cols_from(hd, oc);
      if (j > 0 || oc > 0) ring.start(wq + (long long)(h * hd + oc) * d, cols, d);
      mma::Acc<T, 1, NW> acc;
      acc.zero();
      ring.run(acc, yw, L.ldd, wc);
      if (wc >= cols) continue;
      mma::Two<T> bias[NW];  // every load in flight before a store
#pragma unroll
      for (int n = 0; n < NW; ++n)
        bias[n] = *reinterpret_cast<const mma::Two<T>*>(bq + h * hd + oc + wc + n * 8 + 2 * q);
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          mma::store2<T>(qw + (g + half * 8) * L.ldh + oc + wc + n * 8 + 2 * q,
                         (acc.v[0][n][2 * half] + to_f32<T>(bias[n].v[0])) * a.scale,
                         (acc.v[0][n][2 * half + 1] + to_f32<T>(bias[n].v[1])) * a.scale);
    }
    if (last) {
      cluster_arrive();  // this block is done with LN1: peers may write it
      ring.start(wp + (long long)col0 * d, cols_from(hbd, 0), d);  // in flight over the heads
      mma::wait<1>();
    } else {
      mma::wait<0>();
    }
    __syncthreads();  // K_h, V_h and the q rows are in; gamma and beta read
    attend_rows<T>(qw, ks, vs, L.ldh, L.kvr, hd, tkv, wc, os + wm * 16 * L.ldo + j * hd, L.ldo);
    __syncthreads();  // K/V free for the next head; os complete
  }

  // the block's heads into every block's concat rows (their LN1 rows,
  // which no block reads any more), through DSMEM
  cluster_wait();
  {
    const int per_row = hbd / V, per = BM * per_row;
    for (int i = threadIdx.x; i < c * per; i += blockDim.x) {
      const int r = i / per, e = i % per, row = e / per_row, col = (e % per_row) * V;
      T* peer = cluster.map_shared_rank(ys, r);
      *reinterpret_cast<uint4*>(peer + row * L.ldd + col0 + col) =
          *reinterpret_cast<const uint4*>(os + row * L.ldo + col);
    }
  }
  cluster_arrive();  // the writes are released to the cluster, and no
  cluster_wait();    // block reads or writes a peer's memory after this

  // the block's hbd output columns of proj, its bias and the residual
  const T* bp = static_cast<const T*>(a.bp);
  T* out = static_cast<T*>(a.out) + tok0 * d;
  for (int oc = 0; oc < hbd; oc += kCols) {
    const int cols = cols_from(hbd, oc);
    if (oc > 0) ring.start(wp + (long long)(col0 + oc) * d, cols, d);
    mma::Acc<T, 1, NW> acc;
    acc.zero();
    ring.run(acc, yw, L.ldd, wc);
    if (wc >= cols) continue;
    // the bias and residual loads all in flight before the first store
    mma::Two<T> bias[NW], res[NW][2];
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int col = col0 + oc + wc + n * 8 + 2 * q;
      bias[n] = *reinterpret_cast<const mma::Two<T>*>(bp + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 + g + half * 8;
        if (r < valid) res[n][half] = *reinterpret_cast<const mma::Two<T>*>(x + r * d + col);
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const int col = col0 + oc + wc + n * 8 + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 + g + half * 8;
        if (r >= valid) continue;
        const float p0 = acc.v[0][n][2 * half] + to_f32<T>(bias[n].v[0]);
        const float p1 = acc.v[0][n][2 * half + 1] + to_f32<T>(bias[n].v[1]);
        const mma::Two<T>& xv = res[n][half];
        mma::store2<T>(out + (long long)r * d + col,
                       to_f32<T>(xv.v[0]) + (EPI == kRoundedResidual ? round_to<T>(p0) : p0),
                       to_f32<T>(xv.v[1]) + (EPI == kRoundedResidual ? round_to<T>(p1) : p1));
      }
    }
  }
}

// One launch over n images of hw tokens; see pvt_sra_attention for the
// arguments.  Grid (query tiles, c, n) in clusters of (1, c, 1).  Returns
// the cudaError_t of the launch, or of the request for its shared memory
// or cluster where the card refuses it.
template <typename T, int EPI>
int launch(const void* x, const float* lng, const float* lnb, const void* wq, const void* bq,
           const void* kv, const void* wp, const void* bp, void* out, int n, int hw, int d,
           int nh, int tkv, float eps, float scale, cudaStream_t s) {
  const int c = cluster_size(nh);
  const Args a{x, lng, lnb, wq, bq, kv, wp, bp, out, hw, d, nh, tkv, nh / c, eps, scale};
  const size_t smem = Smem<T>(d, d / nh, nh / c, tkv).bytes;
  auto kernel = attend_kernel<T, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a request over the block's limit: clear it, so
    return (int)err;     // that the next launch does not report it again
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((hw + kRows<T> - 1) / kRows<T>, c, n);
  cfg.blockDim = dim3(kThreads<T>);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = c;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess || clusters < 1) {
    cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sra
