// The bfloat16 products of the Res2Net kernels (res2_block.cu, res2_tail.cu)
// as pipelined tensor-core implicit GEMMs: cp.async into a 3-stage ring of
// shared-memory tiles, ldmatrix, mma.sync m16n8k16 (bf16 in, f32
// accumulate).  No library GEMM is called.
//
// A product's rows are output pixels and its columns output channels:
//   conv1x1_kernel: out (pixels x N) = A (pixels x K) . B^T, B the weight
//     (N x K, torch layout).  A is an NCHW map (x, or the tail's concat),
//     staged k-major by 16-, 8- or 4-byte copies as the map's HW allows (a
//     scalar copy where HW is odd) and read by ldmatrix.trans; or an NHWC
//     scratch map (the concat of the block's splits), read by ldmatrix.  A
//     block takes 128 pixels of one image x 128 channels, K in steps of 64;
//     8 warps of 64 x 32.
//   conv3x3_kernel (stride 1, zero padding 1): out (pixels x WP) = the nine
//     taps of an NHWC scratch map u_i (+ sp_{i-1}, rounded to bf16: the
//     Bottle2neck's hierarchical add).  A block owns a TH x TW pixel tile
//     (TH * TW <= 128) and BN channels; per step of 16 input channels it
//     stages the halo'd (TH + 2) x (TW + 2) patch of u_i (and of sp_{i-1},
//     added in shared memory) by 16-byte cp.async, zeros outside the
//     image, and the 9 x 16 weights of its channels; the nine taps are
//     ldmatrix reads of shifted rows of that one patch, so every staged
//     value serves nine products and none is gathered from device memory
//     alone.  8 warps of 32 pixels x BN / 2 channels.
// Each stage holds one K step; the copies of step i + 2 fly while step i
// is multiplied.  Where a grid has fewer blocks than 1.5 an SM, K is split
// (at most 4 ways, at least 2 steps each) into float32 partial sums that
// split_reduce_kernel adds in split order (deterministic) before the
// epilogue.
//
// Epilogues, in the TPU kernels' arithmetic (separately rounded multiply
// and add): kGroups, relu(z * s + t) of the padded channel groups into an
// NHWC scratch map in bf16 (zeros in the padding); kResidual, relu(z * s +
// t + res) into an NCHW map, staged through shared memory so that each
// channel's pixels are written contiguously.
//
// The scratch maps keep each group of `width` channels in WP = width
// rounded up to 16 (26 -> 32 at Res2Net-50's layer 1): the MMA's K and N
// shapes, zero-padded, and every row 32-byte aligned for the copies.
#pragma once

#include "mma.cuh"

namespace r2g {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBM = 128;            // output pixels a block
constexpr int kBN = 128;            // 1x1: output channels a block
constexpr int kBK = 64;             // 1x1: K a step
constexpr int kCK = 16;             // 3x3: input channels a step (x 9 taps)
constexpr int kMaxPatch = 256;      // 3x3: halo'd tile positions at most
constexpr int kLdA = kBK + 8;       // NHWC A tile [pixel][k]
constexpr int kLdAT = kBM + 8;      // NCHW A tile [k][pixel]
constexpr int kLdB = kBK + 8;       // 1x1 weight tile [co][k]
constexpr int kLdP = kCK + 8;       // patch [position][channel]
constexpr int kLdW3 = 9 * kCK + 8;  // 3x3 weight tile [co][tap][channel]
// the paddings keep ldmatrix's eight 16-byte rows in distinct banks

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

enum Kind { kGroups = 0, kResidual = 1 };

// Where a product's columns go, with its folded BatchNorm.
struct Out {
  int kind;
  const float* s;  // scale and shift
  const float* t;
  int ncols;       // columns of the product (even)
  // kGroups: column g * wp + j -> relu(z * s[g*w + j] + t[g*w + j]) for
  // j < w, 0 for j >= w; row n * hw + p of an NHWC map: groups g < gsplit
  // at dst0 + row * ld0 + g * wp + j, the others at dst1 + row * ld1 +
  // (g - gsplit) * wp + j
  int w, wp, gsplit;
  bf16* dst0;
  int ld0;
  bf16* dst1;
  int ld1;
  // kResidual: out[n][c][p] = relu(z * s[c] + t[c] + res[n][c][p]), NCHW
  const bf16* res;
  bf16* out;
  // split-K partial sums [split][n * hw + p][col], splits > 1 only
  float* part;
  int splits;
};

__device__ __forceinline__ float bn_relu(float z, float s, float t) {
  return fmaxf(__fadd_rn(__fmul_rn(z, s), t), 0.f);
}

// kGroups: columns c, c + 1 (c even, one group) of row rr.
__device__ __forceinline__ void store_groups(const Out& o, long long rr, int c, float z0,
                                             float z1) {
  const int g = c / o.wp, j = c - g * o.wp, b = g * o.w + j;
  const float v0 = j < o.w ? bn_relu(z0, o.s[b], o.t[b]) : 0.f;
  const float v1 = j + 1 < o.w ? bn_relu(z1, o.s[b + 1], o.t[b + 1]) : 0.f;
  bf16* dst = g < o.gsplit ? o.dst0 + rr * o.ld0 + g * o.wp + j
                           : o.dst1 + rr * o.ld1 + (g - o.gsplit) * o.wp + j;
  mma::store2<bf16>(dst, v0, v1);
}

// kResidual: channel c of pixel p of image n.
__device__ __forceinline__ void store_residual(const Out& o, long long n, int c, int p, int hw,
                                               float z) {
  const long long idx = (n * o.ncols + c) * hw + p;
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(z, o.s[c]), o.t[c]), __bfloat162float(o.res[idx]));
  o.out[idx] = __float2bfloat16(fmaxf(v, 0.f));
}

// The A operand of a 1x1 product over image n's pixels.
struct A1 {
  const bf16* a;
  long long img;  // NCHW: elements an image (a + n * img + k * hw + p)
  int ld;         // NHWC: elements a row (a + (n * hw + p) * ld + k)
  int k;          // K, a multiple of 8
};

// The weight of a 1x1 product: rows (output channels) of ld elements.
struct B1 {
  const bf16* b;
  int ld;
  int rows;       // rows of the product
  int w, wp;      // wp > 0: row g * wp + j is the weight's row g * w + j
                  // for j < w, zero for j >= w (the expand's groups)
};

// VEC bf16 values loaded or stored at once (aligned to their size).
template <int VEC>
struct alignas(2 * VEC) Vec {
  bf16 v[VEC];
  __device__ __forceinline__ void load(const bf16* p) { *this = *reinterpret_cast<const Vec*>(p); }
  __device__ __forceinline__ void store(bf16* p) const { *reinterpret_cast<Vec*>(p) = *this; }
};

template <int SRC>
__host__ __device__ constexpr int a_elems() {
  return SRC == 0 ? kBK * kLdAT : kBM * kLdA;
}
template <int SRC>
__host__ __device__ constexpr size_t smem1() {
  return (size_t)kStages * (a_elems<SRC>() + kBN * kLdB) * sizeof(bf16);
}

// SRC 0: A NCHW, copied VEC (8, 4, 2 or 1) elements at a time; 1: A NHWC.
// The kResidual epilogue takes VEC pixels at a time (hw % VEC == 0).
template <int SRC, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    conv1x1_kernel(const A1 a, const B1 b, const Out o, int n_img, int hw, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SE = a_elems<SRC>() + kBN * kLdB;  // a stage
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int tpi = (hw + kBM - 1) / kBM;
  const int n = blockIdx.x / tpi, p0 = (blockIdx.x % tpi) * kBM, n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int kc0 = split * per, kc1 = min((a.k + kBK - 1) / kBK, kc0 + per), steps = kc1 - kc0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32

  auto load = [&](int kc, int st) {
    bf16* as = sm + st * SE;
    bf16* bs = as + a_elems<SRC>();
    const int k0 = kc * kBK;
    if constexpr (SRC == 0) {
      const bf16* src = a.a + n * a.img;
      constexpr int PR = kBM / VEC;
      for (int i = tid; i < kBK * PR; i += kThreads) {
        const int r = i / PR, c = (i % PR) * VEC, k = k0 + r, p = p0 + c;
        const bool ok = k < a.k && p < hw;
        const bf16* g = src + (ok ? (long long)k * hw + p : 0);
        bf16* d = as + r * kLdAT + c;
        if constexpr (VEC == 8) mma::cp16(d, g, ok);
        else if constexpr (VEC == 4) mma::cp8(d, g, ok);
        else if constexpr (VEC == 2) mma::cp4(d, g, ok);
        else *d = ok ? *g : __float2bfloat16(0.f);
      }
    } else {
      for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8, p = p0 + r, k = k0 + c;
        const bool ok = p < hw && k < a.k;
        mma::cp16(as + r * kLdA + c, a.a + (ok ? ((long long)n * hw + p) * a.ld + k : 0), ok);
      }
    }
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      int row = n0 + r;
      bool ok = row < b.rows && k0 + c < a.k;
      if (b.wp) {
        const int g = row / b.wp, j = row - g * b.wp;
        ok = ok && j < b.w;
        row = g * b.w + j;
      }
      mma::cp16(bs + r * kLdB + c, b.b + (ok ? (long long)row * b.ld + k0 + c : 0), ok);
    }
  };

  mma::Acc<bf16, 4, 4> acc;
  acc.zero();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(kc0 + st, st);
    mma::commit();
  }
  for (int i = 0; i < steps; ++i) {
    mma::wait<kStages - 2>();
    __syncthreads();  // step i has landed; step i - 1's buffer is free
    if (i + kStages - 1 < steps) load(kc0 + i + kStages - 1, (i + kStages - 1) % kStages);
    mma::commit();
    const bf16* as = sm + (i % kStages) * SE;
    const bf16* bs = as + a_elems<SRC>();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m0 = wm * 64 + mi * 16;
        if constexpr (SRC == 0)
          mma::ldsm_x4_trans(af[mi], as + (kk + (lane & 7) + ((lane >> 4) << 3)) * kLdAT + m0 +
                                         ((lane >> 3) & 1) * 8);
        else
          mma::ldsm_x4(af[mi], as + (m0 + (lane & 15)) * kLdA + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np)
        mma::ldsm_x4(bfr[np], bs + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdB +
                                  kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma::mma_bf16(acc.v[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2],
                        bfr[ni / 2][(ni & 1) * 2 + 1]);
    }
  }

  if (o.splits > 1 || o.kind == kGroups) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
          const int c = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
          if (p >= hw || c >= o.ncols) continue;
          const long long rr = (long long)n * hw + p;
          const float z0 = acc.v[mi][ni][2 * half], z1 = acc.v[mi][ni][2 * half + 1];
          if (o.splits > 1)
            *reinterpret_cast<float2*>(
                o.part + ((long long)split * n_img * hw + rr) * o.ncols + c) = make_float2(z0, z1);
          else
            store_groups(o, rr, c, z0, z1);
        }
    return;
  }
  // kResidual: the tile through shared memory, [channel][pixel], then each
  // channel's pixels read and written contiguously
  constexpr int LDC = kBM + 4;
  float* cs = reinterpret_cast<float*>(smem);
  mma::wait<0>();
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 64 + mi * 16 + (lane >> 2) + half * 8;
        const int c = wn * 32 + ni * 8 + 2 * (lane & 3);
        cs[c * LDC + r] = acc.v[mi][ni][2 * half];
        cs[(c + 1) * LDC + r] = acc.v[mi][ni][2 * half + 1];
      }
  __syncthreads();
  // VEC pixels a thread at once (hw % VEC == 0), several loads of the
  // residual in flight a thread
  constexpr int PER = kBN * kBM / VEC / kThreads;
#pragma unroll 4
  for (int it = 0; it < PER; ++it) {
    const int i = tid + it * kThreads;
    const int cl = i / (kBM / VEC), r = (i % (kBM / VEC)) * VEC, c = n0 + cl, p = p0 + r;
    if (c >= o.ncols || p >= hw) continue;
    const long long idx = ((long long)n * o.ncols + c) * hw + p;
    Vec<VEC> rv, ov;
    rv.load(o.res + idx);
    const float sc = o.s[c], sh = o.t[c];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(cs[cl * LDC + r + e], sc), sh),
                                __bfloat162float(rv.v[e]));
      ov.v[e] = __float2bfloat16(fmaxf(v, 0.f));
    }
    ov.store(o.out + idx);
  }
}

// A 3x3 product: the input u_i (+ sp_{i-1}) and its permuted weight.
struct A3 {
  const bf16* a;    // u_i: NHWC rows of ld elements, channels [0, wp)
  int ld;
  const bf16* add;  // sp_{i-1} (rows of add_ld), summed into u_i, or null
  int add_ld;
  const bf16* wt;   // (w, 9, wp): [co][tap][ci], tap = di * 3 + dj
  int w;            // output channels
  int wp;           // input and output channels, padded to 16
};

// a patch's elements, rounded to 128 bytes
__host__ __device__ inline int patch_elems(int th, int tw) {
  return ((th + 2) * (tw + 2) * kLdP + 63) / 64 * 64;
}
__host__ __device__ inline int stage3_elems(int th, int tw, int bn, bool add) {
  return patch_elems(th, tw) * (add ? 2 : 1) + bn * kLdW3;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(const A3 a, const Out o, int n_img, int hh, int ww, int th, int tw, int per) {
  constexpr int MT = 2, NT = BN / 16;  // 4 x 2 warps of 32 pixels x BN / 2 channels
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const bool add = a.add != nullptr;
  const int pw = tw + 2, npos = (th + 2) * pw, pe = patch_elems(th, tw);
  const int se = stage3_elems(th, tw, BN, add);
  const int tys = (hh + th - 1) / th, txs = (ww + tw - 1) / tw;
  const int n = blockIdx.x / (tys * txs), tt = blockIdx.x % (tys * txs);
  const int y0 = (tt / txs) * th, x0 = (tt % txs) * tw, n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int c0s = split * per, steps = min(a.wp / kCK, c0s + per) - c0s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;

  auto load = [&](int cc, int st) {
    bf16* ps = sm + st * se;
    bf16* qs = ps + pe;
    bf16* ws = ps + (add ? 2 : 1) * pe;
    const int c0 = cc * kCK;
    for (int i = tid; i < npos * 2; i += kThreads) {
      const int pos = i >> 1, h8 = (i & 1) * 8, py = pos / pw, px = pos - py * pw;
      const int y = y0 - 1 + py, x = x0 - 1 + px;
      const bool ok = y >= 0 && y < hh && x >= 0 && x < ww;
      const long long row = ok ? ((long long)n * hh + y) * ww + x : 0;
      mma::cp16(ps + pos * kLdP + h8, a.a + (ok ? row * a.ld + c0 + h8 : 0), ok);
      if (add) mma::cp16(qs + pos * kLdP + h8, a.add + (ok ? row * a.add_ld + c0 + h8 : 0), ok);
    }
    for (int i = tid; i < BN * 18; i += kThreads) {
      const int r = i / 18, e = i % 18, tap = e >> 1, h8 = (e & 1) * 8, co = n0 + r;
      const bool ok = co < a.w;
      mma::cp16(ws + r * kLdW3 + tap * kCK + h8,
                a.wt + (ok ? ((long long)co * 9 + tap) * a.wp + c0 + h8 : 0), ok);
    }
  };

  // each lane's A row: its pixel's patch position (tap 0, 0); rows past
  // the tile read position 0 and are not stored
  int pos[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int r = wm * 32 + mi * 16 + (lane & 15);
    const int ty = r < th * tw ? r / tw : 0, tx = r < th * tw ? r - (r / tw) * tw : 0;
    pos[mi] = ty * pw + tx;
  }
  const int koff = (lane >> 4) * 8;

  mma::Acc<bf16, MT, NT> acc;
  acc.zero();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(c0s + st, st);
    mma::commit();
  }
  for (int i = 0; i < steps; ++i) {
    mma::wait<kStages - 2>();
    __syncthreads();  // step i has landed; step i - 1's buffer is free
    if (i + kStages - 1 < steps) load(c0s + i + kStages - 1, (i + kStages - 1) % kStages);
    mma::commit();
    bf16* ps = sm + (i % kStages) * se;
    const bf16* ws = ps + (add ? 2 : 1) * pe;
    if (add) {
      // the hierarchical add, round(u_i + sp_{i-1}), in place
      const bf16* qs = ps + pe;
      for (int j = tid; j < npos * (kCK / 2); j += kThreads) {
        const int e = (j / (kCK / 2)) * kLdP + (j % (kCK / 2)) * 2;
        const mma::Two<bf16> u = *reinterpret_cast<const mma::Two<bf16>*>(ps + e);
        const mma::Two<bf16> v = *reinterpret_cast<const mma::Two<bf16>*>(qs + e);
        mma::store2<bf16>(ps + e, __bfloat162float(u.v[0]) + __bfloat162float(v.v[0]),
                          __bfloat162float(u.v[1]) + __bfloat162float(v.v[1]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * pw + tap % 3;
      uint32_t af[MT][4], bfr[NT / 2][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) mma::ldsm_x4(af[mi], ps + (pos[mi] + off) * kLdP + koff);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        mma::ldsm_x4(bfr[np], ws + (wn * (BN / 2) + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                       kLdW3 +
                                   tap * kCK + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
          mma::mma_bf16(acc.v[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2],
                        bfr[ni / 2][(ni & 1) * 2 + 1]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
        const int ty = r / tw, y = y0 + ty, x = x0 + r - ty * tw;
        const int c = n0 + wn * (BN / 2) + ni * 8 + 2 * (lane & 3);
        if (r >= th * tw || y >= hh || x >= ww || c >= o.ncols) continue;
        const long long rr = ((long long)n * hh + y) * ww + x;
        const float z0 = acc.v[mi][ni][2 * half], z1 = acc.v[mi][ni][2 * half + 1];
        if (o.splits > 1)
          *reinterpret_cast<float2*>(o.part + ((long long)split * n_img * hh * ww + rr) * o.ncols +
                                     c) = make_float2(z0, z1);
        else
          store_groups(o, rr, c, z0, z1);
      }
}

// The splits' partial sums of `rows` rows added in split order, then the
// epilogue.
__global__ void split_reduce_kernel(const Out o, long long rows, int hw) {
  const long long total = rows * o.ncols;
  for (long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 2; i < total;
       i += (long long)gridDim.x * blockDim.x * 2) {
    float z0 = 0.f, z1 = 0.f;
    for (int s = 0; s < o.splits; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(o.part + s * total + i);
      z0 += v.x;
      z1 += v.y;
    }
    const long long rr = i / o.ncols;
    const int c = (int)(i - rr * o.ncols);
    if (o.kind == kGroups) {
      store_groups(o, rr, c, z0, z1);
    } else {
      store_residual(o, rr / hw, c, (int)(rr % hw), hw, z0);
      store_residual(o, rr / hw, c + 1, (int)(rr % hw), hw, z1);
    }
  }
}

// How a launch cuts its work.
struct Plan {
  int splits, per;  // K splits, K steps a split
  int th, tw, bn;   // 3x3: the pixel tile and channels a block
  long long blocks;
};

// K split in 2 or 4 where the grid has fewer blocks than 1.5 an SM, each
// split at least 2 steps.
inline void split_k(Plan& pl, int steps) {
  const long long want = (long long)mma::sm_count() * 3 / 2;
  int s = 1;
  while (s < 4 && pl.blocks * s < want && steps >= 4 * s) s *= 2;
  pl.per = (steps + s - 1) / s;
  pl.splits = (steps + pl.per - 1) / pl.per;
}

inline Plan plan1x1(int n, int hw, int ncols, int k) {
  Plan pl{};
  pl.blocks = (long long)n * ((hw + kBM - 1) / kBM) * ((ncols + kBN - 1) / kBN);
  split_k(pl, (k + kBK - 1) / kBK);
  return pl;
}

// The pixel tile: the fewest staged positions, output rows (128 a tile)
// and halos counted alike, over TH * TW <= 128; Res2Net-50's maps (88,
// 44, 22 and 11 wide) all take 11 x 11.
inline Plan plan3x3(int n, int h, int w, int wp) {
  Plan pl{};
  long long best = -1;
  for (int tw = 1; tw <= (w < kBM ? w : kBM); ++tw) {
    const int th = h < kBM / tw ? h : kBM / tw;
    if ((th + 2) * (tw + 2) > kMaxPatch) continue;
    const long long cost =
        (long long)((h + th - 1) / th) * ((w + tw - 1) / tw) * (kBM + (th + 2) * (tw + 2));
    if (best < 0 || cost <= best) {
      best = cost;
      pl.th = th;
      pl.tw = tw;
    }
  }
  pl.bn = wp <= 32 ? 32 : 64;
  pl.blocks = (long long)n * ((h + pl.th - 1) / pl.th) * ((w + pl.tw - 1) / pl.tw) *
              ((wp + pl.bn - 1) / pl.bn);
  split_k(pl, wp / kCK);
  return pl;
}

// float32 elements of split-K partial sums a launch needs
inline long long part_elems(const Plan& pl, long long rows, int ncols) {
  return pl.splits > 1 ? pl.splits * rows * ncols : 0;
}

inline int reduce(const Out& o, long long rows, int hw, cudaStream_t s) {
  split_reduce_kernel<<<grid_for(rows * o.ncols / 2, 256), 256, 0, s>>>(o, rows, hw);
  return (int)cudaGetLastError();
}

template <int SRC, int VEC>
int launch1_v(const A1& a, const B1& b, const Out& o, int n, int hw, const Plan& pl,
              cudaStream_t s) {
  constexpr size_t smem = smem1<SRC>();
  cudaError_t err = cudaFuncSetAttribute(conv1x1_kernel<SRC, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid((unsigned)(n * ((hw + kBM - 1) / kBM)), (o.ncols + kBN - 1) / kBN, pl.splits);
  conv1x1_kernel<SRC, VEC><<<grid, kThreads, smem, s>>>(a, b, o, n, hw, pl.per);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.splits == 1) return (int)err;
  return reduce(o, (long long)n * hw, hw, s);
}

// A 1x1 product over n images of hw pixels; src 0: A NCHW, 1: A NHWC.
// o.part must hold part_elems(plan1x1(...)) floats where it splits.
inline int launch1x1(const A1& a, const B1& b, Out o, int src, int n, int hw, cudaStream_t s) {
  const Plan pl = plan1x1(n, hw, o.ncols, a.k);
  o.splits = pl.splits;
  if (a.k % 8 || o.ncols % 2 || (pl.splits > 1 && !o.part)) return (int)cudaErrorInvalidValue;
  const int vec = hw % 8 == 0 ? 8 : hw % 4 == 0 ? 4 : hw % 2 == 0 ? 2 : 1;
  switch (src * 16 + vec) {
    case 8: return launch1_v<0, 8>(a, b, o, n, hw, pl, s);
    case 4: return launch1_v<0, 4>(a, b, o, n, hw, pl, s);
    case 2: return launch1_v<0, 2>(a, b, o, n, hw, pl, s);
    case 1: return launch1_v<0, 1>(a, b, o, n, hw, pl, s);
    case 24: return launch1_v<1, 8>(a, b, o, n, hw, pl, s);
    case 20: return launch1_v<1, 4>(a, b, o, n, hw, pl, s);
    case 18: return launch1_v<1, 2>(a, b, o, n, hw, pl, s);
    default: return launch1_v<1, 1>(a, b, o, n, hw, pl, s);
  }
}

template <int BN>
int launch3_bn(const A3& a, const Out& o, int n, int h, int w, const Plan& pl, cudaStream_t s) {
  const size_t smem = (size_t)kStages * stage3_elems(pl.th, pl.tw, BN, a.add != nullptr) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  const dim3 grid((unsigned)(n * ((h + pl.th - 1) / pl.th) * ((w + pl.tw - 1) / pl.tw)),
                  (a.wp + BN - 1) / BN, pl.splits);
  conv3x3_kernel<BN><<<grid, kThreads, smem, s>>>(a, o, n, h, w, pl.th, pl.tw, pl.per);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.splits == 1) return (int)err;
  return reduce(o, (long long)n * h * w, h * w, s);
}

// A 3x3 product over n images of h x w pixels into o (ncols = a.wp).
inline int launch3x3(const A3& a, Out o, int n, int h, int w, cudaStream_t s) {
  const Plan pl = plan3x3(n, h, w, a.wp);
  o.splits = pl.splits;
  if (a.wp % kCK || !pl.th || (pl.splits > 1 && !o.part)) return (int)cudaErrorInvalidValue;
  return pl.bn == 32 ? launch3_bn<32>(a, o, n, h, w, pl, s) : launch3_bn<64>(a, o, n, h, w, pl, s);
}

}  // namespace r2g
