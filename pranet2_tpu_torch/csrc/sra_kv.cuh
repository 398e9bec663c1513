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
// What bounds it: at PVT-PraNet-V2 serving shapes (batch 16 at 352x352,
// bf16; 1936 K/V tokens a call) a call reads x once (4-16 MB) and does 1-2
// GFLOP of products: 5-10 us at the card's peaks, the bytes bounding it.
// The first design ran one block per 32 K/V tokens of an image, 64 blocks
// a call, each walking a K of up to 4096 in sequence with WMMA fragments
// loaded from L2.  Here the patch product is split over many blocks, in
// two launches:
//   1. patch_kernel (sr > 1): a block owns BM (64) K/V tokens over all
//      images x BN (64) output channels x one patch row si, and walks the
//      row's sr pixels: pixel sj's D channels of each token (contiguous in
//      x; the patches tensor is never written) and the matching D columns
//      of Wsr (permuted to (D, sr, sr, D)) arrive by cp.async, are LN1'd in
//      place (8 lanes a row) and multiplied (ldmatrix + mma.sync).  The
//      tiles take 18-84 KB, so two or more blocks share an SM and one's
//      copies overlap another's work (a double buffer, which kept one block
//      an SM at stage 3, measured no faster at stages 1-2 and slower at 3).
//      The f32 partial sum of patch row si goes to a scratch buffer (sr,
//      N * Tkv, D): 248, 248 and 310 blocks of 256 threads a call at
//      PVTv2-b2's stages 1-3.
//   2. finish_kernel: a block owns BM (16-64) K/V tokens x BN (64 or 128)
//      of the 2D kv columns.  It copies its tokens' sr partial rows
//      (at sr = 1: x's rows) and its Wkv rows to shared memory by cp.async,
//      all in flight at once; sums the partials in patch-row order (no
//      atomics: the result does not depend on the schedule) plus bsr, then
//      the kv LN (at sr = 1: LN1); then the kv product plus bkv.  The host
//      picks the largest tile that leaves the grid a block per SM: 242,
//      244, 305 and 248 blocks at PVTv2-b2's stages.
// Only the f32 summation orders of the patch product and of the LayerNorm
// statistics (8 lanes a row, not 32) differ from the first design.
//
// Why a launch of its own: every query block of an image needs all of the
// image's K/V tokens; made inside each query block, the patch product
// would be repeated by each of them.
#pragma once

#include "mma.cuh"

namespace kvpath {

constexpr int kPatchThreads = 256;  // 8 warps
constexpr int kThreads = 128;       // finish_kernel: 4 warps

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
  float* part;       // (sr, n * tkv, d) float32 scratch, sr > 1 only
  int n, h, w, d, sr;
};

template <typename T>
struct alignas(4 * sizeof(T)) Four {
  T v[4];
};

// LayerNorm of one row of d values by a group of 8 lanes (every lane of
// the warp calls it, rows of a warp's four groups side by side): values
// come four at a time from load4(c), c a multiple of 4; f32 statistics
// with var = E[x^2] - mu^2, ((v - mu) * rsqrt(var + eps)) * g + b cast to
// T into dst (zeros where !ok).  d a multiple of 32.
template <typename T, typename Load4>
__device__ __forceinline__ void ln_row8(Load4 load4, bool ok, int d, const float* __restrict__ g,
                                        const float* __restrict__ b, float eps, T* dst) {
  const int l = threadIdx.x & 7;
  float s = 0.f, ss = 0.f;
  for (int c = 4 * l; c < d; c += 32) {
    const float4 v = load4(c);
    s += v.x + v.y + v.z + v.w;
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / d;
  const float rstd = rsqrtf(ss / d - mu * mu + eps);
  for (int c = 4 * l; c < d; c += 32) {
    const float4 v = load4(c);
    const float e[4] = {v.x, v.y, v.z, v.w};
    Four<T> o;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o.v[j] = from_f32<T>(ok ? (e[j] - mu) * rstd * g[c + j] + b[c + j] : 0.f);
    *reinterpret_cast<Four<T>*>(dst + c) = o;
  }
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const Four<T> f = *reinterpret_cast<const Four<T>*>(p);
  return make_float4(to_f32<T>(f.v[0]), to_f32<T>(f.v[1]), to_f32<T>(f.v[2]), to_f32<T>(f.v[3]));
}

// A pixel's A (BM x d) and B (BN x d) tiles.
template <typename T>
size_t patch_smem(int d, int bm, int bn) {
  return (size_t)(bm + bn) * mma::padded<T>(d) * sizeof(T);
}

// A and B tiles, and the f32 partial rows where sr > 1.
template <typename T>
size_t finish_smem(int d, int sr, int bm, int bn) {
  return (size_t)(bm + bn) * mma::padded<T>(d) * sizeof(T) +
         (sr > 1 ? (size_t)sr * bm * d * sizeof(float) : 0);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kPatchThreads) patch_kernel(Args a) {
  constexpr int kWarps = kPatchThreads / 32, WM = BM / 16;
  constexpr int WN = kWarps / WM < BN / 16 ? kWarps / WM : BN / 16;  // warps over BM x BN
  constexpr int NT = BN / WN / 8, CV = 16 / sizeof(T);
  const int d = a.d, sr = a.sr, ws = a.w / sr, tkv = (a.h / sr) * ws;
  const long long ntok = (long long)a.n * tkv;
  const int ld = mma::padded<T>(d);
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);  // BM x d LN1 rows, then BN x d Wsr rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // blocks on the card at the same time take different Wsr tiles
  const int cols = d / BN;
  const long long t0 = (long long)blockIdx.y * BM;
  const int col0 = (blockIdx.x % cols) * BN, si = blockIdx.x / cols;
  const T* x = static_cast<const T*>(a.x);
  const T* wsr = static_cast<const T*>(a.wsr) + (long long)col0 * sr * sr * d;
  // pixel (si, sj) of each token, and Wsr's columns for it
  auto fetch = [&](int sj) {
    for (int i = threadIdx.x; i < BM * (d / CV); i += kPatchThreads) {
      const int t = i / (d / CV), e = (i % (d / CV)) * CV;
      const long long tok = t0 + t;
      const bool ok = tok < ntok;
      const int img = ok ? (int)(tok / tkv) : 0, tt = ok ? (int)(tok % tkv) : 0;
      const T* src =
          x + (((long long)img * a.h + (tt / ws) * sr + si) * a.w + (tt % ws) * sr + sj) * d + e;
      mma::cp16(as + t * ld + e, src, ok);
    }
    mma::cp_tile<T>(as + BM * ld, ld, wsr + (si * sr + sj) * d, (long long)sr * sr * d, BN, d, BN);
    mma::commit();
  };
  fetch(0);
  const int wm = warp % WM, wn = warp / WM;
  mma::Acc<T, 1, NT> acc;
  acc.zero();
  for (int sj = 0; sj < sr; ++sj) {
    if (sj > 0) {
      __syncthreads();  // pixel sj - 1's product is done with the tiles
      fetch(sj);
    }
    mma::wait<0>();
    __syncthreads();
    for (int r = threadIdx.x / 8; r < BM; r += kPatchThreads / 8)
      ln_row8<T>([&](int c) { return load4<T>(as + r * ld + c); }, t0 + r < ntok, d, a.lng,
                 a.lnb, a.eps, as + r * ld);
    __syncthreads();
    if (warp < WM * WN)
      mma::mma_abt(acc, as + wm * 16 * ld, ld, as + (BM + wn * (BN / WN)) * ld, ld, d);
  }
  if (warp >= WM * WN) return;
  float* part = a.part + ((long long)si * ntok + t0 + wm * 16) * d + col0 + wn * (BN / WN);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (lane >> 2) + half * 8;
      if (t0 + wm * 16 + r < ntok)
        *reinterpret_cast<float2*>(part + (long long)r * d + n * 8 + 2 * (lane & 3)) =
            make_float2(acc.v[0][n][2 * half], acc.v[0][n][2 * half + 1]);
    }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads) finish_kernel(Args a) {
  constexpr int WM = BM / 16 < 4 ? BM / 16 : 4, WN = 4 / WM;  // warps over BM x BN
  constexpr int NT = BN / WN / 8;
  const int d = a.d, sr = a.sr, tkv = (a.h / sr) * (a.w / sr);
  const long long ntok = (long long)a.n * tkv;
  const int ld = mma::padded<T>(d);
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);              // BM x d: kv LN (or LN1) rows
  T* bs = as + BM * ld;                            // BN x d: rows of Wkv
  float* ps = reinterpret_cast<float*>(bs + BN * ld);  // sr x BM x d partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int valid = (int)(ntok - t0 < BM ? ntok - t0 : BM);
  mma::cp_tile<T>(bs, ld, static_cast<const T*>(a.wkv) + (long long)col0 * d, d, BN, d, BN);
  if (sr == 1)
    mma::cp_tile<T>(as, ld, static_cast<const T*>(a.x) + t0 * d, d, BM, d, valid);
  else
    for (int p = 0; p < sr; ++p)
      mma::cp_tile<float>(ps + p * BM * d, d, a.part + (p * ntok + t0) * d, d, BM, d, valid);
  mma::commit();
  mma::wait<0>();
  __syncthreads();
  const T* bsr = static_cast<const T*>(a.bsr);
  for (int r = threadIdx.x / 8; r < BM; r += kThreads / 8) {
    if (sr == 1) {
      ln_row8<T>([&](int c) { return load4<T>(as + r * ld + c); }, r < valid, d, a.lng, a.lnb,
                 a.eps, as + r * ld);
    } else {
      // the patch rows' partials summed in order, then bsr
      ln_row8<T>(
          [&](int c) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int p = 0; p < sr; ++p) {
              const float4 u = *reinterpret_cast<const float4*>(ps + (p * BM + r) * d + c);
              v.x += u.x;
              v.y += u.y;
              v.z += u.z;
              v.w += u.w;
            }
            const float4 b = load4<T>(bsr + c);
            return make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
          },
          r < valid, d, a.kng, a.knb, a.keps, as + r * ld);
    }
  }
  __syncthreads();
  const int wm = warp % WM, wn = warp / WM;
  mma::Acc<T, 1, NT> acc;
  acc.zero();
  mma::mma_abt(acc, as + wm * 16 * ld, ld, bs + wn * (BN / WN) * ld, ld, d);
  const T* bkv = static_cast<const T*>(a.bkv);
  T* kv = static_cast<T*>(a.kv) + (t0 + wm * 16) * 2 * d + col0 + wn * (BN / WN);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (lane >> 2) + half * 8, c = n * 8 + 2 * (lane & 3);
      if (wm * 16 + r >= valid) continue;
      const T* b = bkv + col0 + wn * (BN / WN) + c;
      mma::store2<T>(kv + (long long)r * 2 * d + c, acc.v[0][n][2 * half] + to_f32<T>(b[0]),
                     acc.v[0][n][2 * half + 1] + to_f32<T>(b[1]));
    }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // a request over the limit: clear it
  return (int)err;
}

template <typename T, int BM, int BN>
int launch_patch(const Args& a, long long ntok, cudaStream_t s) {
  const size_t smem = patch_smem<T>(a.d, BM, BN);
  if (int err = set_smem(patch_kernel<T, BM, BN>, smem)) return err;
  const dim3 grid(a.d / BN * a.sr, (unsigned)((ntok + BM - 1) / BM));
  patch_kernel<T, BM, BN><<<grid, kPatchThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN>
int launch_finish(const Args& a, long long ntok, cudaStream_t s) {
  const size_t smem = finish_smem<T>(a.d, a.sr, BM, BN);
  if (int err = set_smem(finish_kernel<T, BM, BN>, smem)) return err;
  const dim3 grid(2 * a.d / BN, (unsigned)((ntok + BM - 1) / BM));
  finish_kernel<T, BM, BN><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The launches over a.n images: patch_kernel (sr > 1), then finish_kernel.
// Returns the cudaError_t of the first that failed.
template <typename T>
int launch(const Args& a, cudaStream_t s) {
  const int tkv = (a.h / a.sr) * (a.w / a.sr);
  const long long ntok = (long long)a.n * tkv;
  const size_t most = mma::kSmemBlock;
  if (a.sr > 1) {
    // 64 tokens x 64 channels where D and shared memory allow, else 32 x 32
    const int err = a.d % 64 == 0 && patch_smem<T>(a.d, 64, 64) <= most
                        ? launch_patch<T, 64, 64>(a, ntok, s)
                        : launch_patch<T, 32, 32>(a, ntok, s);
    if (err) return err;
  }
  // the largest tile that leaves a block per SM (Wkv is read once per BM
  // tokens, the partials once per BN columns) and fits
  const int sms = mma::sm_count();
  const auto fits = [&](int bm, int bn) {
    return (2 * a.d) % bn == 0 && finish_smem<T>(a.d, a.sr, bm, bn) <= most &&
           (ntok + bm - 1) / bm * (2 * a.d / bn) >= sms;
  };
  if (fits(64, 128)) return launch_finish<T, 64, 128>(a, ntok, s);
  if (fits(32, 128)) return launch_finish<T, 32, 128>(a, ntok, s);
  if (fits(32, 64)) return launch_finish<T, 32, 64>(a, ntok, s);
  return launch_finish<T, 16, 64>(a, ntok, s);
}

}  // namespace kvpath
