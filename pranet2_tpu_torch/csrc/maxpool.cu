// Stem maxpool: 3x3 window, stride 2, padding 1 with -inf, over an NCHW map.
//
// Replaces pranet2_tpu/ops/stem.py::_maxpool_kernel (launcher
// _maxpool_s2d_pallas).  The TPU kernel reads a 2x2 space-to-depth packing
// of the stem's conv3 output so that its minor dimension fills the 128
// lanes.  Hopper has no lane layout to satisfy, so this kernel reads the
// plain NCHW map that the port's stem emits.
//
// What bounds it: device memory.  At the PraNet-V2 serving shape
// (16, 64, 176, 176) bf16 it has to read 63.4 MB and write 15.9 MB, about
// 24 us at 3.35 TB/s, against 8 compares per output.  Design: one thread per
// output element, neighbouring threads on neighbouring output columns, so a
// warp's nine taps cover three contiguous input row segments; the taps that
// overlap between threads and between output rows are served by L1/L2, and
// each input byte comes from device memory about once.  The max is taken in
// f32 and cast back, which is exact for every input type.  NaN propagates
// as it does through torch.maximum.

#include "common.cuh"

#include <math.h>

template <typename T>
__global__ void maxpool3x3s2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                    long long planes, int h, int w, int oh, int ow) {
  const long long total = planes * oh * ow;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % ow);
    const long long t = i / ow;
    const int r = (int)(t % oh);
    const long long p = t / oh;
    const T* src = x + p * h * w;
    float m = -INFINITY;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = 2 * r + dr;
      if (rr < 0 || rr >= h) continue;
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc = 2 * c + dc;
        if (cc < 0 || cc >= w) continue;
        const float v = to_f32<T>(src[(long long)rr * w + cc]);
        m = (v > m || isnan(v)) ? v : m;
      }
    }
    y[i] = from_f32<T>(m);
  }
}

template <typename T>
static void launch(const void* x, void* y, long long planes, int h, int w, int oh, int ow,
                   cudaStream_t stream) {
  const int threads = 256;
  maxpool3x3s2_kernel<T><<<grid_for(planes * oh * ow, threads), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, h, w, oh, ow);
}

// x: (planes, h, w) contiguous; y: (planes, oh, ow) contiguous.
// Returns the cudaError_t of the launch.
extern "C" int maxpool3x3s2(int dtype, const void* x, void* y, long long planes, int h, int w,
                            int oh, int ow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: launch<float>(x, y, planes, h, w, oh, ow, s); break;
    case kBFloat16: launch<__nv_bfloat16>(x, y, planes, h, w, oh, ow, s); break;
    case kFloat16: launch<__half>(x, y, planes, h, w, oh, ow, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
