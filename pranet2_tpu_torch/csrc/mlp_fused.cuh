// The MLP half of a PVTv2 block in one launch, its hidden kept on chip:
//   out = h + fc2(GELU_poly(dwconv3x3(fc1(LN2(h))) + dwb))
// over channels-last tokens h (N, H, W, D), for csrc/pvt_mlp.cu (row 5,
// pranet2_tpu/ops/pvt_mlp.py::_kernel, all three of its modes) and
// csrc/pvt_block.cu (row 8, plain mode).
//
// The arithmetic of pranet2_tpu/ops/pvt_mlp.py::_kernel: LN2 in f32 (var
// = E[x^2] - mu^2) cast to h's type; fc1 in f32 plus b1, the hidden f32
// and zero outside the image (the depthwise conv pads fc1's output, bias
// included); the nine f32 taps summed from zero, column of taps outer and
// row inner, then dwb; GELU through the clipped degree-5 polynomial erf,
// cast to h's type; fc2 accumulated in f32 plus b2.  Then the mode's
// epilogue:
//   plain:    out = round(h + round(fc2));
//   stats:    the same out, and the f32 (mu, rstd) of the rounded out
//             over D (var = E[x^2] - mu^2), for the next block's LN1;
//   final_ln: out = round(LN_f32(f32(h) + fc2)) with the stage-end LN's
//             parameters, no rounding before it.
// Only fc2's f32 summation order (chunk by chunk from a chunk that depends
// on the block, then the S splits' partial sums in order) and that of the
// per-token sums differ from the plain version's.
//
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16) a call does 8-16 GFLOP of products and about 25 f32 instructions
// per hidden element outside them (taps, bias, GELU, conversions): 30-90
// us at the card's peaks.  The first design (fc1, dw+GELU and fc2
// launches) wrote the f32 hidden z and g to device memory and read them
// back: 4.7 GB a forward over the 16 blocks, 1.40 ms at 3.35 TB/s before
// any arithmetic.  A block cannot hold all C hidden channels over a
// halo'd tile, but the depthwise conv is per channel, so here the hidden
// is walked in chunks of CC channels that never leave the SM:
//   a block (16 warps, one an SM) owns R image rows of one image over the
//   full width, and holds LN2 of the R + 2 halo'd rows in shared memory
//   (h's type).  Per chunk, a tensor phase and an f32 phase, two barriers:
//   1. fc2 of chunk k, acc += g W2[:, chunk]^T, the (R * W) x D f32
//      accumulator in registers (each warp at most 4 of its 16 x 32
//      tiles), beside fc1 of chunk k + 1: the (R + 2) * W rows times the
//      chunk's W1 rows (ldmatrix + mma.sync), f32 plus b1, zero outside
//      the image, into an f32 chunk in shared memory;
//   2. the depthwise 3x3 of chunk k + 1, dwb and GELU into g (R * W x CC,
//      h's type, shared), a thread taking two channels of a column and
//      walking its R rows with the window in registers.
// Each step's weights (W2 of chunk k, W1, b1, dwb and taps of chunk k + 1)
// arrive by cp.async one or two steps ahead, as shared memory allows.
// Measured on the H100: the launch is bound by how often each block reads
// the weights from L2, not by the SM count: a block's chunk walk took about
// the same time whatever its rows, so fewer blocks of more rows ran faster
// at stages 3-4.  So the tiles are tall (R = 3-4 rows: the halo
// re-runs fc1 on (R + 2) / R of the rows) and the chunks wide, and where
// that leaves fewer row tiles than half the SMs, S blocks share a tile's
// hidden channels: each writes its f32 partial sum, and the last of the S
// to finish (a counter per tile, zeroed by a memset before the launch)
// adds them in split order and runs the epilogue.  A token's D columns lie
// in several warps' accumulator tiles, so the stats and final_ln modes sum
// each token's values through shared memory (the chunk buffers are free by
// then).  launch picks R, CC and S (pick): PVTv2-b2 at batch 16, bf16,
// stages 1-4: R = 4, 3, 3, 4; CC = 32, 64, 64, 32; S = 1, 1, 1, 2; 352,
// 240, 128 and 96 blocks of 512 threads and 128 registers.  No (N*H*W x C) tensor is written.
#pragma once

#include "mma.cuh"
#include "tile.cuh"

namespace mlpf {

constexpr int kThreads = 512;  // 16 warps, one block an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 4;    // R
constexpr int kMaxTiles = 4;   // fc2 accumulator tiles (16 x 32) a warp
constexpr int kVecs = 11;      // b1, dwb and 9 taps: a chunk's vectors

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

struct Args {
  const void* h;     // (n, hh, w, d) type T: the attention half's output
  const float* lng;  // LN2 (d) and its eps
  const float* lnb;
  float eps;
  const void* w1;    // (c, d) type T
  const void* b1;    // (c)
  const void* dwk;   // (c, 3, 3)
  const void* dwb;   // (c)
  const void* w2;    // (d, c)
  const void* b2;    // (d)
  void* out;         // (n, hh, w, d)
  int n, hh, w, d, c;
  float* part;       // (S, n * hh * w, d) float32 partial sums, S > 1 only
  int* count;        // (n * tiles): blocks of a tile done, S > 1 only (launch
                     // zeroes it)
  int mode;          // Mode; kPlain where left zero
  const float* fg;   // final_ln: the stage LN's (d) parameters
  const float* fb;
  float eps2;        // the stats' or the stage LN's eps
  float* mu;         // stats: (n, hh, w) float32 outputs
  float* rstd;
  // set by launch (pick):
  int rows;          // R: image rows a block
  int chunk;         // CC: hidden channels a chunk (16, 32 or 64)
  int splits;        // S: blocks sharing a row tile's hidden channels
  int nbuf;          // buffers for the weight chunks: 1 or 2
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// fc2 accumulator tiles (16 x 32) of a block.
__host__ __device__ inline int acc_tiles(int rows, int w, int d) {
  return round16(rows * w) / 16 * (d / 32);
}

// LN2 of the halo'd rows, nbuf chunks of W1 and W2, nbuf + 1 of the
// chunk vectors, g and the f32 hidden chunk.
template <typename T>
size_t smem_bytes(int rows, int w, int d, int cc, int nbuf) {
  const size_t p = round16((rows + 2) * w), m = round16(rows * w);
  const size_t ldy = mma::padded<T>(d), ldc = mma::padded<T>(cc);
  return (p * ldy + nbuf * (cc * ldy + d * ldc) + (nbuf + 1) * kVecs * cc + m * ldc) * sizeof(T) +
         p * (cc + 8) * sizeof(float);
}

// fc1 of rows [0, pp) of ys against the chunk's W1 rows w1c (CC x d), in
// items of 16 rows x NT * 8 columns, plus b1, into zs (f32, row stride
// ldz), zero on rows outside the image (valid(q) false).
template <typename T, int CC, int NT, typename Valid>
__device__ __forceinline__ void fc1_chunk(const T* ys, int ldy, const T* w1c, int d,
                                          const T* b1c, float* zs, int ldz, int pp, Valid valid) {
  constexpr int G = CC / (NT * 8);  // column groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = pp / 16;
  for (int t = warp; t < mt * G; t += kWarps) {
    const int m = t % mt, c0 = (t / mt) * NT * 8;
    mma::Acc<T, 1, NT> z;
    z.zero();
    mma::mma_abt(z, ys + m * 16 * ldy, ldy, w1c + c0 * ldy, ldy, d);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = m * 16 + (lane >> 2) + half * 8;
      const bool ok = valid(q);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = c0 + n * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(zs + q * ldz + col) =
            ok ? make_float2(z.v[0][n][2 * half] + to_f32<T>(b1c[col]),
                             z.v[0][n][2 * half + 1] + to_f32<T>(b1c[col + 1]))
               : make_float2(0.f, 0.f);
      }
    }
  }
}

template <typename T, int CC, int J>
__global__ void __launch_bounds__(kThreads, 1) mlp_kernel(Args a) {
  constexpr int CV = 16 / sizeof(T), ldz = CC + 8, VS = kVecs * CC;
  const int w = a.w, d = a.d, c = a.c, hh = a.hh, R = a.rows, nbuf = a.nbuf;
  const int p = (R + 2) * w, pp = round16(p), mo = R * w, mt = round16(mo) / 16;
  const int tiles = mt * (d / 32), chunks = c / CC / a.splits, split = blockIdx.y;
  const int ldy = mma::padded<T>(d), ldc = mma::padded<T>(CC);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);  // pp x d: LN2 of the halo'd rows
  T* w1s = ys + pp * ldy;              // nbuf x CC x d: W1's chunks
  T* w2s = w1s + nbuf * CC * ldy;      // nbuf x d x CC: W2's chunks
  T* vs = w2s + nbuf * d * ldc;        // (nbuf + 1) x [b1, dwb, taps] of a chunk
  T* gs = vs + (nbuf + 1) * VS;        // mt * 16 x CC
  float* zs = reinterpret_cast<float*>(gs + mt * 16 * ldc);  // pp x CC
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_h = (hh + R - 1) / R;
  const int img = blockIdx.x / tiles_h, r0 = (blockIdx.x % tiles_h) * R;
  const T* hi = static_cast<const T*>(a.h) + (long long)img * hh * w * d;
  // The block walks `chunks` chunks of its split of the hidden channels;
  // its k-th is the split's (k + first) % chunks-th: blocks on the card at
  // the same time start at different chunks, so that they do not all ask
  // L2 for the same weights at once.
  const int first = blockIdx.x % chunks;
  auto hidden = [&](int k) { return split * chunks + (k + first) % chunks; };
  // the k-th chunk's W1 rows (slot k % nbuf) and b1, dwb and taps (slot
  // k % (nbuf + 1)), and its W2 columns (slot k % nbuf), by cp.async
  auto fetch_w1 = [&](int k) {
    if (k >= chunks) return;
    const int kc = hidden(k);
    mma::cp_tile<T>(w1s + (k % nbuf) * CC * ldy, ldy,
                    static_cast<const T*>(a.w1) + (long long)kc * CC * d, d, CC, d, CC);
    T* v = vs + (k % (nbuf + 1)) * VS;
    mma::cp_tile<T>(v, CC, static_cast<const T*>(a.b1) + kc * CC, CC, 1, CC, 1);
    mma::cp_tile<T>(v + CC, CC, static_cast<const T*>(a.dwb) + kc * CC, CC, 1, CC, 1);
    mma::cp_tile<T>(v + 2 * CC, 9 * CC, static_cast<const T*>(a.dwk) + kc * CC * 9, 9 * CC, 1,
                    9 * CC, 1);
  };
  auto fetch_w2 = [&](int k) {
    if (k >= chunks) return;
    mma::cp_tile<T>(w2s + (k % nbuf) * d * ldc, ldc,
                    static_cast<const T*>(a.w2) + hidden(k) * CC, c, d, CC, d);
  };
  // Step k's group: what the tensor phase of step k reads (W2 of chunk k,
  // W1 and b1 of chunk k + 1) and the depthwise phase after it (taps and
  // dwb of chunk k + 1).  Empty past the last chunk, so that nbuf groups
  // are always in flight at a wait.
  auto fetch_step = [&](int k) {
    fetch_w1(k + 1);
    fetch_w2(k);
    mma::commit();
  };
  auto wait_step = [&]() {
    if (nbuf == 2) mma::wait<1>(); else mma::wait<0>();
  };
  // local row q of the halo'd tile lies in the image
  auto valid = [&](int q) {
    const int r = r0 - 1 + q / w;
    return q < p && r >= 0 && r < hh;
  };
  // fc1 of the k-th chunk into zs: 16-column items where the row tiles are
  // too few to give every warp one
  auto fc1 = [&](int k) {
    const T* w1c = w1s + (k % nbuf) * CC * ldy;
    const T* b1c = vs + (k % (nbuf + 1)) * VS;
    if (pp / 16 >= kWarps || CC == 16)
      fc1_chunk<T, CC, CC / 8>(ys, ldy, w1c, d, b1c, zs, ldz, pp, valid);
    else
      fc1_chunk<T, CC, 2>(ys, ldy, w1c, d, b1c, zs, ldz, pp, valid);
  };
  // depthwise 3x3, dwb and GELU of the k-th chunk into g: a thread takes
  // channels 2 cp, 2 cp + 1 of a column and walks its R rows with the
  // window in registers
  const int cp = threadIdx.x % (CC / 2);
  auto dw = [&](int k) {
    const T* v = vs + (k % (nbuf + 1)) * VS;
    float2 tap[3][3];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      tap[t / 3][t % 3] =
          make_float2(to_f32<T>(v[2 * CC + 18 * cp + t]), to_f32<T>(v[2 * CC + 18 * cp + 9 + t]));
    const float2 bias = make_float2(to_f32<T>(v[CC + 2 * cp]), to_f32<T>(v[CC + 2 * cp + 1]));
    for (int j = threadIdx.x / (CC / 2); j < w; j += kThreads / (CC / 2)) {
      float2 win[3][3];  // [row % 3][dj]: local row `row`, column j + dj - 1
      auto load = [&](int row, float2 (&dst)[3]) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int cc = j + dj - 1;
          dst[dj] = cc >= 0 && cc < w
                        ? *reinterpret_cast<const float2*>(zs + (row * w + cc) * ldz + 2 * cp)
                        : make_float2(0.f, 0.f);
        }
      };
      load(0, win[0]);
      load(1, win[1]);
#pragma unroll
      for (int rr = 0; rr < kMaxRows; ++rr) {
        if (rr >= R) break;
        load(rr + 2, win[(rr + 2) % 3]);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int di = 0; di < 3; ++di) {
            s0 += win[(rr + di) % 3][dj].x * tap[di][dj].x;
            s1 += win[(rr + di) % 3][dj].y * tap[di][dj].y;
          }
        mma::store2<T>(gs + (rr * w + j) * ldc + 2 * cp, gelu_poly(s0 + bias.x),
                       gelu_poly(s1 + bias.y));
      }
    }
  };

  // h's halo'd rows (contiguous in h, zeros outside the image) with chunk
  // 0's W1, then steps 0 .. nbuf - 2
  for (int i = threadIdx.x; i < pp * (d / CV); i += kThreads) {
    const int q = i / (d / CV), e = (i % (d / CV)) * CV;
    const bool ok = valid(q);
    mma::cp16(ys + q * ldy + e, hi + (ok ? ((long long)(r0 - 1) * w + q) * d + e : 0), ok);
  }
  fetch_w1(0);
  mma::commit();
  for (int k = 0; k + 1 < nbuf; ++k) fetch_step(k);
  for (int i = mo * ldc + threadIdx.x; i < mt * 16 * ldc; i += kThreads) gs[i] = from_f32<T>(0.f);
  wait_step();
  __syncthreads();
  for (int q = warp; q < pp; q += kWarps) {
    T* row = ys + q * ldy;
    if (valid(q)) tile::layer_norm_row<T>(row, d, a.lng, a.lnb, a.eps, row);
  }
  __syncthreads();
  fc1(0);
  __syncthreads();
  fetch_step(nbuf - 1);
  dw(0);

  // Step k: one tensor phase (fc2 of chunk k, fc1 of chunk k + 1), then
  // the depthwise phase of chunk k + 1; two barriers a chunk.
  mma::Acc<T, 1, 4> acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j].zero();
  for (int k = 0; k < chunks; ++k) {
    wait_step();
    __syncthreads();  // step k's group has landed; dw(k) is done with zs
    const T* w2c = w2s + (k % nbuf) * d * ldc;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = warp + j * kWarps;
      if (t < tiles)
        mma::mma_abt(acc[j], gs + (t % mt) * 16 * ldc, ldc, w2c + (t / mt) * 32 * ldc, ldc, CC);
    }
    if (k + 1 < chunks) fc1(k + 1);
    __syncthreads();  // fc2(k) is done with g and step k's weights
    fetch_step(k + nbuf);
    if (k + 1 < chunks) dw(k + 1);
  }

  // fn(j, n, half, token, col): the accumulator's elements inside the image
  // (token: the image row-major index of the output row)
  auto each = [&](auto fn) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = warp + j * kWarps;
      if (t >= tiles) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (t % mt) * 16 + (lane >> 2) + half * 8;
          if (o >= mo || r0 + o / w >= hh) continue;
          fn(j, n, half, (long long)r0 * w + o, (t / mt) * 32 + n * 8 + 2 * (lane & 3));
        }
    }
  };
  if (a.splits > 1) {
    // Hidden channels split over the tile's S blocks: each writes its f32
    // partial sum; the last to finish adds them in split order (fixed, so
    // the result does not depend on the schedule) and writes out.
    const long long m = (long long)a.n * hh * w, base = (long long)img * hh * w;
    each([&](int j, int n, int half, long long tok, int col) {
      *reinterpret_cast<float2*>(a.part + ((split * m + base + tok) * d + col)) =
          make_float2(acc[j].v[0][n][2 * half], acc[j].v[0][n][2 * half + 1]);
    });
    // Each thread fences its own writes; the barrier then holds thread 0's
    // count back until every thread of the block has, and the second
    // barrier tells the block whether it was the last of the S.
    __threadfence();
    __syncthreads();
    const bool last =
        __syncthreads_or(threadIdx.x == 0 && atomicAdd(a.count + blockIdx.x, 1) == a.splits - 1);
    if (!last) return;
    __threadfence();
    each([&](int j, int n, int half, long long tok, int col) {
      float2 v = make_float2(0.f, 0.f);
      for (int sp = 0; sp < a.splits; ++sp) {
        const float2 u = __ldcg(reinterpret_cast<const float2*>(a.part + ((sp * m + base + tok) * d + col)));
        v.x += u.x;
        v.y += u.y;
      }
      acc[j].v[0][n][2 * half] = v.x;
      acc[j].v[0][n][2 * half + 1] = v.y;
    });
  }
  // v = acc + b2, then the mode's value in acc, in place: the rounded
  // out (plain, stats; stored now) or the unrounded f32(h) + v (final_ln)
  const T* b2 = static_cast<const T*>(a.b2);
  T* oi = static_cast<T*>(a.out) + (long long)img * hh * w * d;
  const bool final_ln = a.mode == kFinalLn;
  each([&](int j, int n, int half, long long tok, int col) {
    const long long idx = tok * d + col;
    const mma::Two<T> x2 = *reinterpret_cast<const mma::Two<T>*>(hi + idx);
    float* v = acc[j].v[0][n] + 2 * half;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float o = v[e] + to_f32<T>(b2[col + e]);
      v[e] = final_ln ? to_f32<T>(x2.v[e]) + o : round_to<T>(to_f32<T>(x2.v[e]) + round_to<T>(o));
    }
    if (!final_ln) mma::store2<T>(oi + idx, v[0], v[1]);
  });
  if (a.mode == kPlain) return;

  // Per-token sums of v and v^2: each row's four lanes, then each column
  // tile's partial in shared memory (red: [row][column tile][2]), summed
  // in column-tile order by one thread a token.
  const int cts = d / 32;
  float* red = reinterpret_cast<float*>(smem);
  float* stat = red + mt * 16 * cts * 2;  // [row][2]: mu, rstd (final_ln)
  mma::wait<0>();
  __syncthreads();  // every warp is done with the chunk buffers
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int t = warp + j * kWarps;
    if (t >= tiles) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = (t % mt) * 16 + (lane >> 2) + half * 8;
      const bool ok = o < mo && r0 + o / w < hh;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = ok ? acc[j].v[0][n][2 * half + e] : 0.f;
          s1 += v;
          s2 += v * v;
        }
#pragma unroll
      for (int m = 1; m <= 2; m *= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      }
      if ((lane & 3) == 0) {
        red[(o * cts + t / mt) * 2] = s1;
        red[(o * cts + t / mt) * 2 + 1] = s2;
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < mo; o += kThreads) {
    if (r0 + o / w >= hh) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int ct = 0; ct < cts; ++ct) {
      s1 += red[(o * cts + ct) * 2];
      s2 += red[(o * cts + ct) * 2 + 1];
    }
    const float mu = s1 / d, rstd = rsqrtf(s2 / d - mu * mu + a.eps2);
    if (final_ln) {
      stat[2 * o] = mu;
      stat[2 * o + 1] = rstd;
    } else {
      const long long tok = (long long)img * hh * w + (long long)r0 * w + o;
      a.mu[tok] = mu;
      a.rstd[tok] = rstd;
    }
  }
  if (!final_ln) return;
  __syncthreads();
  each([&](int j, int n, int half, long long tok, int col) {
    const int o = (int)(tok - (long long)r0 * w);
    const float mu = stat[2 * o], rstd = stat[2 * o + 1];
    const float* v = acc[j].v[0][n] + 2 * half;
    mma::store2<T>(oi + tok * d + col, (v[0] - mu) * rstd * a.fg[col] + a.fb[col],
                   (v[1] - mu) * rstd * a.fg[col + 1] + a.fb[col + 1]);
  });
}

template <typename T, int CC, int J>
int launch_j(const Args& a, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T, CC, J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid((unsigned)a.n * ((a.hh + a.rows - 1) / a.rows), a.splits);
  mlp_kernel<T, CC, J><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int CC>
int launch_cc(const Args& a, size_t smem, cudaStream_t s) {
  switch ((acc_tiles(a.rows, a.w, a.d) + kWarps - 1) / kWarps) {
    case 1:
      return launch_j<T, CC, 1>(a, smem, s);
    case 2:
      return launch_j<T, CC, 2>(a, smem, s);
    case 3:
      return launch_j<T, CC, 3>(a, smem, s);
    case kMaxTiles:
      return launch_j<T, CC, kMaxTiles>(a, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

struct Tile {
  int rows, chunk, splits;  // R, CC, S; rows 0 where no tile fits
};

// The tile of an MLP launch over (n, h, w, d) tokens and c hidden channels
// on the current device.  Few, tall tiles and wide chunks read the weights
// from L2 fewest times, which bounds the launch at PVTv2-b2's later stages:
// 64-channel chunks with 3 or 4 rows, else 32 or 16 with the most rows (up
// to 4), whose fc2 accumulator and shared memory (the weights once) fit a
// block; then the fewest splits (1, 2, 4) of the hidden channels that give
// half the SMs a block, else the most: the split's partial sums cost more
// than the SMs a grid leaves idle.  The order, and that of the splits, is
// the fastest of sweeps at PVTv2-b2's four stages at batch 16 on the H100
// (device ms a stats call, chip_smoke.py: stage 2 R = 3 against 4, 0.29
// against 0.32; stage 3 S = 1 against 2, 0.19 against 0.24; stage 4 S = 2
// against 4, 0.22 against 0.25).
template <typename T>
Tile pick(int n, int h, int w, int d, int c) {
  const int rmax = h < 1 ? 1 : (h < kMaxRows ? h : kMaxRows);
  Tile order[2 + 2 * kMaxRows];
  int k = 0;
  for (int r = rmax - 1 > 3 ? rmax - 1 : 3; r <= rmax; ++r) order[k++] = {r, 64, 0};
  for (int cc = 32; cc >= 16; cc /= 2)
    for (int r = rmax; r >= 1; --r) order[k++] = {r, cc, 0};
  const long long sms = mma::sm_count();
  for (int i = 0; i < k; ++i) {
    Tile t = order[i];
    if (c % t.chunk || acc_tiles(t.rows, w, d) > kWarps * kMaxTiles ||
        smem_bytes<T>(t.rows, w, d, t.chunk, 1) > (size_t)mma::kSmemBlock)
      continue;
    const long long tiles = (long long)n * ((h + t.rows - 1) / t.rows);
    for (int sp = 1; sp <= 4; sp *= 2) {
      if (c % (t.chunk * sp)) continue;
      t.splits = sp;
      if (2 * tiles * sp >= sms) break;
    }
    return t;
  }
  return {0, 0, 0};
}

// One launch over a.n images, its tile from pick; sets a.nbuf: two
// buffers where they fit a block's shared memory.  Refuses
// (cudaErrorInvalidValue) a D not a multiple of 32, a shape no tile fits,
// S > 1 without the caller's scratch (sized by the same pick), or a mode
// without its outputs or parameters.
template <typename T>
int launch(Args a, cudaStream_t s) {
  const Tile t = pick<T>(a.n, a.hh, a.w, a.d, a.c);
  a.rows = t.rows;
  a.chunk = t.chunk;
  a.splits = t.splits;
  if (a.d % 32 || !a.rows || (a.splits > 1 && !(a.part && a.count)) ||
      (a.mode == kStats && !(a.mu && a.rstd)) || (a.mode == kFinalLn && !(a.fg && a.fb)) ||
      a.mode < kPlain || a.mode > kFinalLn)
    return (int)cudaErrorInvalidValue;
  a.nbuf = smem_bytes<T>(a.rows, a.w, a.d, a.chunk, 2) <= (size_t)mma::kSmemBlock ? 2 : 1;
  const size_t smem = smem_bytes<T>(a.rows, a.w, a.d, a.chunk, a.nbuf);
  if (smem > (size_t)mma::kSmemBlock) return (int)cudaErrorInvalidValue;
  if (a.splits > 1) {
    // the tiles' counters start at zero (a memset on the stream, no kernel)
    const size_t bytes = sizeof(int) * a.n * ((a.hh + a.rows - 1) / a.rows);
    const cudaError_t err = cudaMemsetAsync(a.count, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (a.chunk) {
    case 16:
      return launch_cc<T, 16>(a, smem, s);
    case 32:
      return launch_cc<T, 32>(a, smem, s);
    case 64:
      return launch_cc<T, 64>(a, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace mlpf
