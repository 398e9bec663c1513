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
// us at 3.35 TB/s; but the products and sums may not fuse, so the 18
// float32 operations an element come close behind (34 us at 67 TFLOP/s),
// and every conversion, address or register move on top of them shows.
// The first design (a thread walking a whole image row, three dependent
// loads a pixel) was latency-bound at 47% of the bytes' bound.
// Design: a block owns a tile of R output rows x Wt columns x 16 * VEC
// channels (VEC = 4, or 1 where C or the pointers do not allow 16-byte
// copies).  It stages the (R + 2) x (Wt + 2) halo'd input tile in shared
// memory with cp.async (16-byte copies, all in flight at once, zeros
// outside the image; the staging loop walks rows and columns without a
// division).  Thread (column j, channel group q) then walks the R rows,
// fully unrolled, with the 3 x 3 window in float registers that rotate by
// name: three shared loads and 3 * VEC conversions per output row, the
// taps in registers for the whole tile.  Each input byte leaves device
// memory about (R + 2) / R * (Wt + 2) / Wt times.  launch picks R and Wt:
// even splits into at most 11 rows and 8 columns, the best of a sweep at
// PVTv2-b2's hidden shapes on the H100; even the 11 x 11 maps give the
// card several blocks an SM, and a tile's shared memory stays under 48 KB
// (at most 13 x 10 x 64 float32).
#include "mma.cuh"

namespace {

constexpr int kLanes = 16;    // threads per pixel: 16 * VEC channels a tile
// R and Wt at most: the best of a sweep over 1-16 of each at PVTv2-b2's
// four hidden shapes on the H100
constexpr int kMaxRows = 11;  // R
constexpr int kMaxCols = 8;   // Wt

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T v[VEC];
};

struct Tile {
  int rows, cols, tiles_h, tiles_w;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kLanes * kMaxCols)
    dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int h,
                 int wd, int c, Tile t) {
  using P = Pack<T, VEC>;
  constexpr int CS = kLanes * VEC;                  // channels a tile
  constexpr int CV = VEC == 1 ? 1 : 16 / sizeof(T);  // channels a copy
  constexpr int QP = CS / CV;                        // copies a pixel
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);  // (rows + 2) x (cols + 2) x CS
  const int sw = t.cols + 2;
  int b = blockIdx.x;
  const int tw = b % t.tiles_w;
  b /= t.tiles_w;
  const int th = b % t.tiles_h;
  const int img = b / t.tiles_h;
  const int r0 = th * t.rows, c0 = tw * t.cols, ch0 = blockIdx.y * CS;
  const T* xi = x + (long long)img * h * wd * c;

  // the halo'd tile: thread (pixel lane, copy q) walks pixels `step` apart
  {
    const int q = threadIdx.x % QP, step = blockDim.x / QP, ch = ch0 + q * CV;
    int row = 0, col = threadIdx.x / QP;
    for (; row < t.rows + 2; col += step) {
      while (col >= sw) col -= sw, ++row;
      if (row >= t.rows + 2) break;
      const int rr = r0 - 1 + row, cc = c0 - 1 + col;
      const bool ok = rr >= 0 && rr < h && cc >= 0 && cc < wd && ch < c;
      T* dst = s + (row * sw + col) * CS + q * CV;
      const T* src = xi + ((long long)rr * wd + cc) * c + ch;
      if constexpr (CV * sizeof(T) == 16) {
        mma::cp16(dst, ok ? src : x, ok);
      } else {
        *dst = ok ? *src : from_f32<T>(0.f);
      }
    }
  }
  mma::commit();

  const int q = threadIdx.x % kLanes, j = threadIdx.x / kLanes, ch = ch0 + q * VEC;
  const bool live = j < t.cols && c0 + j < wd && ch < c;
  float k[3][3][VEC];
#pragma unroll
  for (int tp = 0; tp < 9; ++tp) {
    P v;
    if (live) v = *reinterpret_cast<const P*>(w + (long long)tp * c + ch);
#pragma unroll
    for (int e = 0; e < VEC; ++e) k[tp / 3][tp % 3][e] = live ? to_f32<T>(v.v[e]) : 0.f;
  }
  mma::wait<0>();
  __syncthreads();
  if (!live) return;

  // win[row % 3][dj]: tile row `row` - 1 (smem row `row`), column j + dj - 1
  float win[3][3][VEC];
  const T* col = s + j * CS + q * VEC;  // smem row 0, tile column j - 1
  auto load_row = [&](int row, float (&dst)[3][VEC]) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const P v = *reinterpret_cast<const P*>(col + (row * sw + dj) * CS);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[dj][e] = to_f32<T>(v.v[e]);
    }
  };
  load_row(0, win[0]);
  load_row(1, win[1]);
  const int rows = min(t.rows, h - r0);
  T* o = out + (((long long)img * h + r0) * wd + c0 + j) * c + ch;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r >= rows) break;
    load_row(r + 2, win[(r + 2) % 3]);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fadd_rn(acc[e], __fmul_rn(win[(r + di) % 3][dj][e], k[di][dj][e]));
    P res;
#pragma unroll
    for (int e = 0; e < VEC; ++e) res.v[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<P*>(o + (long long)r * wd * c) = res;
  }
}

// Even parts of at most `most`: ceil(extent / ceil(extent / most)).
int split(int extent, int most) {
  const int parts = (extent + most - 1) / most;
  return (extent + parts - 1) / parts;
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int n, int h, int wd, int c, cudaStream_t s) {
  constexpr int CS = kLanes * VEC;
  Tile t;
  t.rows = split(h, kMaxRows);
  t.cols = split(wd, kMaxCols);
  t.tiles_h = (h + t.rows - 1) / t.rows;
  t.tiles_w = (wd + t.cols - 1) / t.cols;
  const size_t smem = (size_t)(t.rows + 2) * (t.cols + 2) * CS * sizeof(T);
  const long long blocks = (long long)n * t.tiles_h * t.tiles_w;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (c + CS - 1) / CS);
  dw3x3_kernel<T, VEC><<<grid, kLanes * t.cols, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), h, wd, c, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* w, void* out, int n, int h, int wd, int c,
               cudaStream_t s) {
  constexpr int kCopy = 16 / sizeof(T);  // channels a 16-byte copy
  const auto addr = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  if (c % kCopy == 0 && (addr(x) | addr(w) | addr(out)) % 16 == 0)
    return launch<T, 4>(x, w, out, n, h, wd, c, s);
  return launch<T, 1>(x, w, out, n, h, wd, c, s);
}

}  // namespace

// x, out: (n, h, w, c) contiguous, type `dtype`; w (3, 3, c) of the same
// type.  16-byte copies where c and the pointers allow them.
// Returns the cudaError_t of the launch.
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
