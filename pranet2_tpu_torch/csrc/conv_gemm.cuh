// The float32 convolutions of a Res2Net Bottle2neck as matrix products over
// NCHW maps, with the block's epilogue: shared by res2_tail.cu and
// res2_block.cu, which no model serves in float32 (their bfloat16 products
// run on res2_gemm.cuh's tensor-core engine).
//
// Per image a 1x1 convolution is out (M x HW) = W (M x K) . X (K x HW) with
// K = Cin, and a 3x3 one (stride 1, zero padding 1) the same product over
// K = 9 Cin with X the im2col of the input, built as the tile is loaded:
// k = ci * 9 + di * 3 + dj, the flattening of an OIHW weight.  The input of a
// 3x3 convolution can be the sum of two maps (the Bottle2neck's
// hierarchical add, u_i + sp_{i-1}).  Taps outside the image read zero.
// The epilogue is the TPU kernels': z * s + t (a folded BatchNorm, float32),
// plus a residual in float32 where one is given, ReLU.
//
// One block of 128 threads holds a BM x BN output tile of four warps of
// 16 x 16 FMA tiles, 2 x 2 warps or, for outputs of at most 16 channels,
// 1 x 4.  K runs in steps of 32 through shared memory, zero-filled past
// the ragged edges of M, K and HW.  No library GEMM is called.
#pragma once

#include "tile.cuh"

namespace res2 {

constexpr int kBK = 32;
// Row padding of the shared tiles: rows on distinct banks.
constexpr int kPad = 1;

template <typename T>
struct ConvArgs {
  const T* weight;   // (m, k) row-major
  const T* x;        // input channel 0 of image 0
  const T* add;      // 3x3 only: summed into x and rounded to T, or null
  const float* s;    // folded BatchNorm scale (m)
  const float* t;    // folded BatchNorm shift (m)
  const T* res;      // residual, m channels, or null
  T* out;            // output channels [0, split)
  T* out2;           // output channels [split, m), at channel co - split
  float* ws;         // split-K partial sums (workspace_elems), or null
  long long x_img, add_img, res_img, out_img, out2_img;  // elements per image
  int m, cin, height, width, split;
};

// How a launch cuts its work: warps along M (1 for outputs of at most kSpan
// channels, the 26-wide 3x3 convolutions of layer 1, else 2), and the K
// splits.  A grid of fewer than 1024 output tiles (the small maps of layers
// 3-4, where K runs to 1872) leaves too few warps on each SM to hide the
// loads' latency, so K is split in two until it has 1024 blocks or a split
// would get fewer than 4 steps; each split writes float32 partial sums, and
// a second kernel adds them in split order and applies the epilogue.
struct Plan {
  int wm, splits;
};

template <typename T>
Plan plan(int m, int ktot, int hw, int n) {
  constexpr int S = tile::kSpan<T>;
  const int wm = m <= S ? 1 : 2, bm = wm * S, bn = tile::kWarps / wm * S;
  const long long tiles = (long long)((hw + bn - 1) / bn) * ((m + bm - 1) / bm) * n;
  const int steps = (ktot + kBK - 1) / kBK;
  int splits = 1;
  while (tiles * splits < 1024 && steps >= 8 * splits) splits *= 2;
  return {wm, splits};
}

// float32 elements of split-K workspace a launch needs (0 without splits).
template <typename T>
long long workspace_elems(int m, int ktot, int hw, int n) {
  const Plan pl = plan<T>(m, ktot, hw, n);
  return pl.splits > 1 ? (long long)pl.splits * n * m * hw : 0;
}

// The epilogue of one output: BatchNorm, residual, ReLU, cast, routed to
// out or out2.  Separate rounded multiply and add, as the plain version
// computes them.
template <typename T, bool RES>
__device__ __forceinline__ void store_out(const ConvArgs<T>& a, float z, long long n, int co,
                                          int p, int hw) {
  float v = __fadd_rn(__fmul_rn(z, a.s[co]), a.t[co]);
  if (RES) v = __fadd_rn(v, to_f32<T>(a.res[n * a.res_img + (long long)co * hw + p]));
  T* dst = co < a.split ? a.out + n * a.out_img + (long long)co * hw
                        : a.out2 + n * a.out2_img + (long long)(co - a.split) * hw;
  dst[p] = from_f32<T>(fmaxf(v, 0.f));
}

// The A and B tiles of one K step, loaded into shared memory one value at a
// time.
template <typename T, int KS, int BM, int BN, int LDA, int LDB>
__device__ __forceinline__ void load_tiles(const ConvArgs<T>& a, const T* x, const T* add,
                                           int m0, int p0, int k0, int ktot, int hw, T* as,
                                           T* bs) {
  constexpr int BK = kBK;
  const int tid = threadIdx.x;
  const T zero = from_f32<T>(0.f);
  for (int e = tid; e < BM * BK; e += tile::kThreads) {
    const int mm = e / BK, kk = e % BK;
    const int co = m0 + mm, k = k0 + kk;
    as[mm * LDA + kk] = (co < a.m && k < ktot) ? a.weight[(long long)co * ktot + k] : zero;
  }
  // each thread keeps one pixel column of the B tile
  const int j = tid % BN, p = p0 + j;
  const bool live = p < hw;
  const int py = live ? p / a.width : 0, px = live ? p - py * a.width : 0;
  for (int kk = tid / BN; kk < BK; kk += tile::kThreads / BN) {
    const int k = k0 + kk;
    T v = zero;
    if (live && k < ktot) {
      if (KS == 1) {
        v = x[(long long)k * hw + p];
      } else {
        const int ci = k / 9, tap = k - 9 * ci, di = tap / 3, dj = tap - 3 * di;
        const int yy = py + di - 1, xx = px + dj - 1;
        if (yy >= 0 && yy < a.height && xx >= 0 && xx < a.width) {
          const long long off = (long long)ci * hw + yy * a.width + xx;
          v = add == nullptr ? x[off] : from_f32<T>(to_f32<T>(x[off]) + to_f32<T>(add[off]));
        }
      }
    }
    bs[kk * LDB + j] = v;
  }
}

template <typename T, int KS, bool RES, int WM>
__global__ void __launch_bounds__(tile::kThreads)
    res2_conv_kernel(const ConvArgs<T> a, int n_images, int splits) {
  constexpr int S = tile::kSpan<T>;
  constexpr int WN = tile::kWarps / WM;
  constexpr int BM = WM * S, BN = WN * S, BK = kBK;
  constexpr int LDA = BK + kPad, LDB = BN + kPad, LDC = BN + 4;
  __shared__ __align__(128) T as[BM * LDA];
  __shared__ __align__(128) T bs[BK * LDB];
  __shared__ __align__(128) float cs[BM * LDC];

  const int hw = a.height * a.width;
  const int ktot = KS * KS * a.cin;
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * BM, p0 = blockIdx.x * BN;
  const long long n = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int kper = ((ktot + BK - 1) / BK + splits - 1) / splits * BK;
  const int kend = min(ktot, (split + 1) * kper);
  const T* x = a.x + n * a.x_img;
  const T* add = a.add == nullptr ? nullptr : a.add + n * a.add_img;

  tile::WarpBlock<T> acc;
  acc.zero();
  for (int k0 = split * kper; k0 < kend; k0 += BK) {
    load_tiles<T, KS, BM, BN, LDA, LDB>(a, x, add, m0, p0, k0, ktot, hw, as, bs);
    __syncthreads();
    acc.mma_ab(as + (warp / WN) * S * LDA, LDA, bs + (warp % WN) * S, LDB, BK);
    __syncthreads();
  }
  acc.store(cs + (warp / WN) * S * LDC + (warp % WN) * S, LDC);
  __syncthreads();

  // each thread writes one pixel column: the output, or this split's
  // partial sums, laid out [split][image][channel][pixel]
  const int j = threadIdx.x % BN, p = p0 + j;
  if (p >= hw) return;
  float* part =
      splits > 1 ? a.ws + ((long long)split * n_images + n) * a.m * hw + p : nullptr;
  for (int mm = threadIdx.x / BN; mm < BM; mm += tile::kThreads / BN) {
    const int co = m0 + mm;
    if (co >= a.m) break;
    if (splits > 1)
      part[(long long)co * hw] = cs[mm * LDC + j];
    else
      store_out<T, RES>(a, cs[mm * LDC + j], n, co, p, hw);
  }
}

// Adds the splits' partial sums in split order and applies the epilogue.
template <typename T, bool RES>
__global__ void res2_split_epilogue(const ConvArgs<T> a, int n_images, int splits) {
  const int hw = a.height * a.width;
  const long long total = (long long)n_images * a.m * hw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float z = a.ws[i];
    for (int s = 1; s < splits; ++s) z += a.ws[s * total + i];
    const long long r = i / hw;
    store_out<T, RES>(a, z, r / a.m, (int)(r % a.m), (int)(i - r * hw), hw);
  }
}

template <typename T, int KS, bool RES, int WM>
int launch_tiles(const ConvArgs<T>& a, int n, int splits, cudaStream_t stream) {
  constexpr int BM = WM * tile::kSpan<T>, BN = tile::kWarps / WM * tile::kSpan<T>;
  const dim3 grid((a.height * a.width + BN - 1) / BN, (a.m + BM - 1) / BM, n * splits);
  res2_conv_kernel<T, KS, RES, WM><<<grid, tile::kThreads, 0, stream>>>(a, n, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)n * a.m * a.height * a.width;
  res2_split_epilogue<T, RES><<<grid_for(total, 256), 256, 0, stream>>>(a, n, splits);
  return (int)cudaGetLastError();
}

// Outputs of at most kSpan channels (the 26-wide 3x3 convolutions of layer
// 1) take kSpan x 4 kSpan tiles, the rest 2 kSpan x 2 kSpan.
template <typename T, int KS, bool RES>
int launch_conv(const ConvArgs<T>& a, int n, cudaStream_t stream) {
  const Plan pl = plan<T>(a.m, KS * KS * a.cin, a.height * a.width, n);
  if (pl.splits > 1 && a.ws == nullptr) return (int)cudaErrorInvalidValue;
  if (pl.wm == 1) return launch_tiles<T, KS, RES, 1>(a, n, pl.splits, stream);
  return launch_tiles<T, KS, RES, 2>(a, n, pl.splits, stream);
}

}  // namespace res2
