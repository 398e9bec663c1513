// The volumetric predictor's two zooms (train/multiclass.py::
// make_slice_predictor): every slice of a (D, x, y) volume zoomed to the
// patch (ph, pw) at order 3, and the (D, ph, pw) labels zoomed back to
// (x, y) at order 0, scipy.ndimage.zoom's numbers both ways.
//
// Replaces no TPU kernel: the JAX package zooms on the host, one slice at a
// time with scipy (pranet2_tpu/train/multiclass.py), and so did the port,
// while the card idled.
//
// The arithmetic.  scipy's order-3 zoom is linear and separable: along each
// axis a B-spline prefilter (mirror boundary) and a 4-tap cubic at
// o (n - 1) / (m - 1), in float64, cast to float32 at the end; so a slice's
// zoom is A S B^T with A (ph x x) and B (pw x y) the 1-D operators.
// ops/volume_zoom.py builds each operator from scipy itself (the zoom of an
// identity) and keeps the band of each row that holds every entry above
// 2^-60 of the row's largest (64 taps from 512 or 154 to 224: the
// prefilter's inverse decays by 0.268 a pixel, whatever the sizes).  The dropped
// tail moves a float64 sum by less than its own rounding.  Pass 1 applies A
// over the slice's rows into a float64 buffer T (D, y, ph), transposed;
// pass 2 applies B over T's rows, which are the slice's columns, and casts
// to float32 into (D, ph, pw).  Both with fma in float64, each sum over the
// taps in order: the same terms as (A S) B^T, summed in another order than
// a BLAS product, so a float32 result may differ from scipy's by one
// rounding of a float64 sum (none did in the CPU tests).  The order-0 zoom
// back is a gather by two index tables (scipy's nearest index of each
// output row and column, -1 where scipy's constant mode gives cval, label
// 0).
//
// What bounds it: float64 operations, then bytes.  A 512^2 slice to 224^2
// is 224 * 512 * 64 + 224 * 224 * 64 = 10.5 M fma in its 64-tap sums,
// 0.63 us at the card's 34 TFLOP/s of float64 outside the tensor cores; it
// reads 1 MB and writes 0.2 MB, 0.37 us at 3.35 TB/s, and passes T (0.92 MB
// a slice) through L2 and HBM once each way.  The labels' gather writes
// 1 MB a slice of int32 and reads 0.2 MB.
//
// Design.  Both passes are one kernel that zooms the rows axis of a
// (D, n, c) array into a (D, c, m) one.  A thread takes kCols columns and a
// block of kRows output rows, and walks the input rows that any of them
// needs once, top to bottom, adding each row's values into all its sums
// through a table of the block's weights padded with zeros to the rows the
// block spans (ops/volume_zoom.py::row_blocks; 102 rows for 16 outputs at
// 512 -> 224, so 1.6 times the useful fma, but no test in the loop, two
// weights a 16-byte broadcast load, each weight used by kCols fma, and
// each input element read once a block, coalesced).  It writes each
// column's kRows outputs contiguously: the transpose that lets pass 2 read
// T's rows coalesced.  A volume is two launches; its labels one launch of
// the gather.

#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads of a zoom block
constexpr int kCols = 2;       // columns a thread, kThreads apart
constexpr int kRows = 16;      // output rows a block (ROW_BLOCK in ops/volume_zoom.py)
constexpr int kLabelThreads = 256;
constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z

// out[d, j, b kRows + t] = sum_s table[b, s, t] * in[d, lo[b] + s, j] for
// the kRows output rows of row block b and the thread's columns j.  The
// table holds each row's weights at its own offset in the block's `span`
// input rows and zeros around them, so every input row feeds all kRows sums
// with no test; each sum adds its taps in order (the zeros add nothing).
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
    zoom_axis_kernel(const In* __restrict__ in, int n, int c, const int* __restrict__ lo,
                     const double* __restrict__ table, int span, int m, Out* __restrict__ out) {
  const int j0 = blockIdx.x * kThreads * kCols + threadIdx.x;
  const int b = blockIdx.y;
  const long long d = blockIdx.z;
  if (j0 >= c) return;
  bool live[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) live[u] = j0 + u * kThreads < c;
  const double2* w = reinterpret_cast<const double2*>(table + (long long)b * span * kRows);
  const In* src = in + (d * n + __ldg(lo + b)) * c + j0;
  double acc[kCols][kRows];
#pragma unroll
  for (int u = 0; u < kCols; ++u)
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[u][t] = 0.0;
  for (int s = 0; s < span; ++s) {
    double v[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u)
      v[u] = live[u] ? (double)src[(long long)s * c + u * kThreads] : 0.0;
#pragma unroll
    for (int t = 0; t < kRows / 2; ++t) {
      const double2 w2 = __ldg(w + s * (kRows / 2) + t);
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        acc[u][2 * t] = fma(w2.x, v[u], acc[u][2 * t]);
        acc[u][2 * t + 1] = fma(w2.y, v[u], acc[u][2 * t + 1]);
      }
    }
  }
  const int rows = min(kRows, m - b * kRows);
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    if (!live[u]) continue;
    Out* o = out + (d * c + j0 + u * kThreads) * m + b * kRows;
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      if (t < rows) o[t] = (Out)acc[u][t];
  }
}

// out[d, i, j] = src[d, rows[i], cols[j]], 0 where either index is -1.
__global__ void __launch_bounds__(kLabelThreads)
    zoom_labels_kernel(const int* __restrict__ src, int h, int w, const int* __restrict__ rows,
                       const int* __restrict__ cols, int x, int y, int* __restrict__ out) {
  const int j = blockIdx.x * kLabelThreads + threadIdx.x;
  const int i = blockIdx.y;
  const long long d = blockIdx.z;
  if (j >= y) return;
  const int r = __ldg(rows + i), c = __ldg(cols + j);
  out[(d * x + i) * y + j] = (r < 0 || c < 0) ? 0 : __ldg(src + (d * h + r) * w + c);
}

inline unsigned int blocks(int n, int per) { return (unsigned int)((n + per - 1) / per); }

}  // namespace

// src: (d, x, y) float32 (dtype 0) or float64 (dtype 3), contiguous;
// row_lo (ceil(ph / rows) int32) and row_table (ceil(ph / rows) x row_span
// x rows float64): the operator over x by blocks of `rows` output rows,
// which must be kRows; col_lo and col_table, col_span: the operator over y
// alike; tmp: (d, y, ph) float64 scratch; out: (d, ph, pw) float32.  Two
// launches on `stream`; returns the cudaError_t of the launches.
extern "C" int volume_zoom_slices(const void* src, int dtype, int d, int x, int y,
                                  const void* row_lo, const void* row_table, int row_span,
                                  const void* col_lo, const void* col_table, int col_span,
                                  int rows, int ph, int pw, void* tmp, void* out, void* stream) {
  if (d <= 0 || x <= 0 || y <= 0 || ph <= 0 || pw <= 0 || row_span <= 0 || row_span > x ||
      col_span <= 0 || col_span > y || rows != kRows || d > kMaxGrid ||
      (int)blocks(ph, kRows) > kMaxGrid || (int)blocks(pw, kRows) > kMaxGrid ||
      reinterpret_cast<uintptr_t>(row_table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(col_table) % 16 != 0 ||
      (dtype != kFloat32 && dtype != kFloat64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* t = static_cast<double*>(tmp);
  const int* rlo = static_cast<const int*>(row_lo);
  const double* rtab = static_cast<const double*>(row_table);
  const dim3 g1(blocks(y, kThreads * kCols), blocks(ph, kRows), d);
  if (dtype == kFloat32)
    zoom_axis_kernel<float, double><<<g1, kThreads, 0, s>>>(static_cast<const float*>(src), x, y,
                                                            rlo, rtab, row_span, ph, t);
  else
    zoom_axis_kernel<double, double><<<g1, kThreads, 0, s>>>(static_cast<const double*>(src), x,
                                                             y, rlo, rtab, row_span, ph, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(blocks(ph, kThreads * kCols), blocks(pw, kRows), d);
  zoom_axis_kernel<double, float><<<g2, kThreads, 0, s>>>(
      t, y, ph, static_cast<const int*>(col_lo), static_cast<const double*>(col_table), col_span,
      pw, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// src: (d, h, w) int32 labels, contiguous; rows (x int32) and cols (y
// int32): the nearest source row and column of each output one, -1 for
// cval; out: (d, x, y) int32.  One launch on `stream`; returns its
// cudaError_t.
extern "C" int volume_zoom_labels(const void* src, int d, int h, int w, const void* rows,
                                  const void* cols, int x, int y, void* out, void* stream) {
  if (d <= 0 || h <= 0 || w <= 0 || x <= 0 || y <= 0 || d > kMaxGrid || x > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  const dim3 g(blocks(y, kLabelThreads), x, d);
  zoom_labels_kernel<<<g, kLabelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), h, w, static_cast<const int*>(rows),
      static_cast<const int*>(cols), x, y, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
