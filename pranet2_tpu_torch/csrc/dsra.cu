// DSRA gate: out = fg + fg * softmax_c(crop_fg - crop_bg), or the linear
// form out = fg + fg * (crop_fg - crop_bg), over NCHW maps.
//
// Replaces pranet2_tpu/ops/dsra.py::_dsra_kernel (launcher
// dsra_gate_pallas), which runs the same arithmetic over (rows, C) blocks
// of 4096 rows.  The rounding follows that kernel: the difference is taken
// in the input type, the softmax in f32, the gate is cast to fg's type and
// fg + fg * gate is evaluated in fg's type, one rounding per operation, as
// the plain PyTorch version (dsra_gate_plain) does it.
//
// What bounds it: at PraNet-V2 serving shapes (16, 1, {44, 22, 11}^2) bf16
// it moves at most 248 KB, well under a microsecond of device memory time,
// so each call costs about one kernel launch.  At C > 1 (the multiclass
// decoders, C <= 9) it is memory-bound.  Design: one thread per pixel,
// looping over the C channels, which lie H*W apart; neighbouring threads
// take neighbouring pixels, so every channel's loads coalesce.  The channel
// loop reads the inputs again for the max, the sum and the output; C is
// small and the repeats hit L1.

#include "common.cuh"

#include <math.h>

template <typename T>
__device__ __forceinline__ float diff_at(const T* cf, const T* cb, long long idx) {
  return round_to<T>(to_f32<T>(cf[idx]) - to_f32<T>(cb[idx]));
}

template <typename T>
__global__ void dsra_gate_kernel(const T* __restrict__ fg, const T* __restrict__ cf,
                                 const T* __restrict__ cb, T* __restrict__ out, long long n,
                                 int c, long long hw, int use_softmax) {
  const long long total = n * hw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long base = (i / hw) * c * hw + i % hw;
    float mx = -INFINITY, sum = 0.f;
    if (use_softmax) {
      for (int k = 0; k < c; ++k) mx = fmaxf(mx, diff_at<T>(cf, cb, base + k * hw));
      for (int k = 0; k < c; ++k) sum += expf(diff_at<T>(cf, cb, base + k * hw) - mx);
    }
    for (int k = 0; k < c; ++k) {
      const long long idx = base + k * hw;
      const float d = diff_at<T>(cf, cb, idx);
      const float gate = round_to<T>(use_softmax ? expf(d - mx) / sum : d);
      const float f = to_f32<T>(fg[idx]);
      out[idx] = from_f32<T>(f + round_to<T>(f * gate));
    }
  }
}

template <typename T>
static void launch(const void* fg, const void* cf, const void* cb, void* out, long long n, int c,
                   long long hw, int use_softmax, cudaStream_t stream) {
  const int threads = 256;
  dsra_gate_kernel<T><<<grid_for(n * hw, threads), threads, 0, stream>>>(
      static_cast<const T*>(fg), static_cast<const T*>(cf), static_cast<const T*>(cb),
      static_cast<T*>(out), n, c, hw, use_softmax);
}

// fg, cf, cb, out: (n, c, hw) contiguous, one type.
// Returns the cudaError_t of the launch.
extern "C" int dsra_gate(int dtype, const void* fg, const void* cf, const void* cb, void* out,
                         long long n, int c, long long hw, int use_softmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: launch<float>(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    case kBFloat16: launch<__nv_bfloat16>(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    case kFloat16: launch<__half>(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
