// The served masks at each image's native size: bilinear resize of the
// (S, S) logit map (align_corners=False), sigmoid, min-max over the image,
// x 255 and a truncating cast to uint8, for a batch of images of any sizes,
// into one packed uint8 buffer.
//
// Replaces no TPU kernel: the JAX package (pranet2_tpu/serve.py) resizes on
// the host with dense interpolation matrices, and so did the port, one image
// at a time on the serving thread (ops/resize.py::resize_bilinear_np), while
// the card idled.  The arithmetic is the reference export's
// (binary_seg/MyTest_med.py), as PyTorch runs it on the card, in float32:
// ATen's upsample_bilinear2d taps (scale = (float)S / h, src = max(scale *
// (dst + 0.5) - 0.5, 0), i = (int)src, the second tap only if i < S - 1,
// lambda = src - i, the value formed in ATen's order), the sigmoid as
// 1 / (1 + expf(-v)), then (v - min) / (max - min + 1e-8f), times 255,
// truncated.
//
// What bounds it: a launch's latency, then bytes.  An HD frame writes 2 MB
// of mask and reads its 0.5 MB map, which stays in L2; a served batch of 16
// at the polyp test sets' sizes writes about 9 MB.  At 3.35 TB/s that is
// under 3 us, against a few microseconds a launch.  Design: two launches
// over one grid of blocks, each block 4096 consecutive pixels of one image
// (16 a thread, one 16-byte store).  Pass 1 computes the sigmoid of each
// pixel, reduces the block's min and max and folds them into the image's
// pair with one atomicMax each (sigmoids are >= 0, so their bits order as
// ints; the min is kept as 0x7fffffff - bits, so that both start at zero
// and the order of the atomics cannot change the result).  Pass 2
// recomputes each pixel (the map is in L2: cheaper than storing 4 bytes a
// pixel), normalises and stores.  The table of images (offsets, sizes,
// first blocks, and the zeroed min/max pair) comes in with one small copy,
// so no memset is needed.

#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 16;                     // pixels a thread: one 16-byte store
constexpr int kBlockPix = kThreads * kPix;  // pixels a block

// One row of the table, as ops/native_mask.py writes it (8 int32).
struct Image {
  long long offset;  // the mask's first byte in the packed output, a multiple of 16
  int h, w;          // the native size
  int first_block;   // the first block of the grid that covers this image
  int lo, hi;        // 0x7fffffff - bits(min) and bits(max) of the sigmoid; zero on entry
  int pad;
};
static_assert(sizeof(Image) == 32, "the table's rows are 8 int32");

// The image that block `b` covers: the last with first_block <= b.
__device__ __forceinline__ int find_image(const Image* ims, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ims[mid].first_block <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

struct Tap {
  int i0, i1;
  float l0, l1;
};

// ATen's area_pixel_compute_source_index (align_corners=False) and the
// taps of upsample_bilinear2d_out_frame.
__device__ __forceinline__ Tap tap(float scale, int dst, int size) {
  float src = scale * (dst + 0.5f) - 0.5f;
  src = src < 0.f ? 0.f : src;
  Tap t;
  t.i0 = (int)src;
  t.i1 = t.i0 + (t.i0 < size - 1 ? 1 : 0);
  t.l1 = src - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// The sigmoid of the resized logit at (y, x) of an image whose map is m.
__device__ __forceinline__ float pixel(const float* __restrict__ m, int sh, int sw,
                                       float rh, float rw, int y, int x) {
  const Tap ty = tap(rh, y, sh), tx = tap(rw, x, sw);
  const float* r0 = m + (long long)ty.i0 * sw;
  const float* r1 = m + (long long)ty.i1 * sw;
  const float v = ty.l0 * (tx.l0 * __ldg(r0 + tx.i0) + tx.l1 * __ldg(r0 + tx.i1)) +
                  ty.l1 * (tx.l0 * __ldg(r1 + tx.i0) + tx.l1 * __ldg(r1 + tx.i1));
  return 1.f / (1.f + expf(-v));
}

// The pixels of this thread: up to kPix from flat index p0 of image `im`,
// handed to f(j, value).
template <typename F>
__device__ __forceinline__ void for_pixels(const float* __restrict__ logits, int sh, int sw,
                                           const Image& im, int b, long long p0, F f) {
  const long long hw = (long long)im.h * im.w;
  const float rh = (float)sh / (float)im.h, rw = (float)sw / (float)im.w;
  const float* m = logits + (long long)b * sh * sw;
  int y = (int)(p0 / im.w), x = (int)(p0 - (long long)y * im.w);
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (p0 + j < hw) f(j, pixel(m, sh, sw, rh, rw, y, x));
    if (++x == im.w) {
      x = 0;
      ++y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    minmax_kernel(const float* __restrict__ logits, int sh, int sw, Image* ims, int n) {
  const int b = find_image(ims, n, blockIdx.x);
  const Image im = ims[b];
  const long long p0 = (long long)(blockIdx.x - im.first_block) * kBlockPix + threadIdx.x * kPix;
  float lo = INFINITY, hi = 0.f;
  for_pixels(logits, sh, sw, im, b, p0, [&](int, float v) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ float slo[kThreads / 32], shi[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      lo = fminf(lo, slo[i]);
      hi = fmaxf(hi, shi[i]);
    }
    // a block holds at least one pixel, so lo is a sigmoid, not the +inf start
    atomicMax(&ims[b].lo, 0x7fffffff - __float_as_int(lo));
    atomicMax(&ims[b].hi, __float_as_int(hi));
  }
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const float* __restrict__ logits, int sh, int sw, const Image* __restrict__ ims,
                 int n, uint8_t* __restrict__ out) {
  const int b = find_image(ims, n, blockIdx.x);
  const Image im = ims[b];
  const long long p0 = (long long)(blockIdx.x - im.first_block) * kBlockPix + threadIdx.x * kPix;
  const long long hw = (long long)im.h * im.w;
  if (p0 >= hw) return;
  const float lo = __int_as_float(0x7fffffff - im.lo), hi = __int_as_float(im.hi);
  const float den = __fadd_rn(__fsub_rn(hi, lo), 1e-8f);
  // the 16 bytes in four words, indexed only by unrolled constants (registers)
  unsigned int q[kPix / 4] = {0u, 0u, 0u, 0u};
  for_pixels(logits, sh, sw, im, b, p0, [&](int j, float v) {
    const unsigned int u = __float2uint_rz(__fmul_rn(__fdiv_rn(__fsub_rn(v, lo), den), 255.f));
    q[j / 4] |= u << (8 * (j % 4));
  });
  uint8_t* dst = out + im.offset + p0;
  if (p0 + kPix <= hw) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (p0 + j < hw) dst[j] = (uint8_t)(q[j / 4] >> (8 * (j % 4)));
  }
}

}  // namespace

// Pixels a block covers: ops/native_mask.py sizes the grid and each image's
// first block by it.
extern "C" int native_mask_block_pixels() { return kBlockPix; }

// logits: (>= n, 1, sh, sw) float32 contiguous; table: n rows of Image in
// device memory, lo and hi zero; blocks: the grid, the last image's
// first_block plus its blocks; out: the packed uint8 masks, 16-byte
// aligned.  Two launches on `stream`; returns the cudaError_t of the
// launches.
extern "C" int native_masks(const void* logits, int sh, int sw, void* table, int n, int blocks,
                            void* out, void* stream) {
  if (n <= 0 || blocks <= 0 || sh <= 0 || sw <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  Image* ims = static_cast<Image*>(table);
  minmax_kernel<<<blocks, kThreads, 0, s>>>(x, sh, sw, ims, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_kernel<<<blocks, kThreads, 0, s>>>(x, sh, sw, ims, n, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
