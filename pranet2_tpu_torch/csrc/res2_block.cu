// The whole stride-1 'normal' Bottle2neck of Res2Net-v1b over NCHW maps,
// eval mode with folded BatchNorms (f32 scale/shift):
//   u    = relu((W1 . x) * s1 + t1)                      4 groups of width
//   sp_0 = relu(conv3x3(u_0) * sd_0 + td_0)
//   sp_i = relu(conv3x3(u_i + sp_{i-1}) * sd_i + td_i)   i = 1, 2
//   out  = relu((W3 . cat(sp_0, sp_1, sp_2, u_3)) * s3 + t3 + x)
//
// Replaces pranet2_tpu/ops/res2_block.py::_kernel_full / _kernel_halo
// (launcher fused_bottle2neck, body _body), with its rounding points: u,
// u_i + sp_{i-1} and every sp_i rounded to the input's type; each product
// accumulated in float32 from operands in that type; BatchNorm, residual and
// ReLU in float32; one cast of the output.  The TPU kernel's 128-lane group
// padding and its 3-row-halo tiles are devices of the TPU's layout and VMEM
// and are not carried over; the zero padding of each 3x3 convolution at the
// image border is (taps outside the image read zero).
//
// What bounds it: at PraNet-V2 serving shapes (batch 16 at 352x352, bf16) a
// call does 17.7 GFLOP at every stage, 18 us on the tensor cores, against
// x and out of 127 MB at stage 1 (38 us at the HBM rate) down to 16 MB at
// stage 4: stage 1 is bound by bytes, stages 3-4 by the products.  The TPU
// kernel keeps u and the sp_i in VMEM; a Hopper block's 227 KB of shared
// memory cannot hold stage 1's three sequential 3x3 convolutions over a row
// tile with the 3-row halo they need.  So this first design is a chain of
// five products on one stream, each a conv_gemm.cuh launch with its
// epilogue (two launches where it splits K, at the small maps of layers
// 2-4), and u and the sp_i go through device memory in the input's type,
// which keeps the TPU kernel's rounding points exactly:
//   1. the 1x1 expand with BN1 and ReLU: groups 0-2 into the scratch u,
//      group 3 straight into its place in the concat buffer cat;
//   2-4. conv i: the im2col of u_i (+ sp_{i-1}, read from cat) loaded tile
//      by tile, BN, ReLU, sp_i written into cat's group i;
//   5. the projection with BN3, the residual x and ReLU: the tail kernel's
//      code (res2_tail.cu).
// The spill (u and cat written and read) is the first thing to remove.

#include <algorithm>

#include "conv_gemm.cuh"

namespace {

template <typename T>
int launch(const void* xv, const void* w1, const float* s1, const float* t1, const void* wd,
           const float* sd, const float* td, const void* w3, const float* s3, const float* t3,
           void* uv, void* catv, void* out, float* ws, int n, int cin, int width, int cout,
           int h, int w, cudaStream_t stream) {
  const long long hw = (long long)h * w;
  const T* x = static_cast<const T*>(xv);
  T* u = static_cast<T*>(uv);
  T* cat = static_cast<T*>(catv);
  const T* kd = static_cast<const T*>(wd);
  res2::ConvArgs<T> a{};
  a.height = h;
  a.width = w;
  a.ws = ws;
  a.weight = static_cast<const T*>(w1);
  a.x = x;
  a.s = s1;
  a.t = t1;
  a.out = u;
  a.out2 = cat + 3 * width * hw;
  a.x_img = cin * hw;
  a.out_img = 3 * width * hw;
  a.out2_img = 4 * width * hw;
  a.m = 4 * width;
  a.cin = cin;
  a.split = 3 * width;
  int err = res2::launch_conv<T, 1, false>(a, n, stream);
  if (err) return err;

  for (int i = 0; i < 3; ++i) {
    res2::ConvArgs<T> c{};
    c.height = h;
    c.width = w;
    c.ws = ws;
    c.weight = kd + (long long)i * width * width * 9;
    c.x = u + i * width * hw;
    c.add = i == 0 ? nullptr : cat + (i - 1) * width * hw;
    c.s = sd + i * width;
    c.t = td + i * width;
    c.out = cat + i * width * hw;
    c.x_img = 3 * width * hw;
    c.add_img = c.out_img = 4 * width * hw;
    c.m = c.cin = c.split = width;
    if ((err = res2::launch_conv<T, 3, false>(c, n, stream))) return err;
  }

  res2::ConvArgs<T> p{};
  p.height = h;
  p.width = w;
  p.ws = ws;
  p.weight = static_cast<const T*>(w3);
  p.x = cat;
  p.s = s3;
  p.t = t3;
  p.res = x;
  p.out = static_cast<T*>(out);
  p.x_img = 4 * width * hw;
  p.res_img = p.out_img = cout * hw;
  p.m = p.split = cout;
  p.cin = 4 * width;
  return res2::launch_conv<T, 1, true>(p, n, stream);
}

template <typename T>
long long workspace(int n, int cin, int width, int cout, int hw) {
  long long e = res2::workspace_elems<T>(4 * width, cin, hw, n);
  e = std::max(e, res2::workspace_elems<T>(width, 9 * width, hw, n));
  return std::max(e, res2::workspace_elems<T>(cout, 4 * width, hw, n));
}

}  // namespace

// float32 elements of workspace res2_block needs at these sizes (the
// largest of its launches' split-K partial sums, which run one after
// another), or -1 for a bad dtype.
extern "C" long long res2_block_workspace(int dtype, int n, int cin, int width, int cout, int h,
                                          int w) {
  switch (dtype) {
    case kFloat32:
      return workspace<float>(n, cin, width, cout, h * w);
    case kBFloat16:
      return workspace<__nv_bfloat16>(n, cin, width, cout, h * w);
    default:
      return -1;
  }
}

// x and out (n, cin, h, w) with cout == cin, w1 (4 width, cin), wd (3, width,
// width, 3, 3), w3 (cout, 4 width): contiguous, of type `dtype` (float32 or
// bfloat16); s1, t1 (4 width), sd, td (3, width), s3, t3 (cout) float32.
// Scratch from the caller: u (n, 3 width, h, w) and cat (n, 4 width, h, w)
// of type `dtype`, ws float32 of res2_block_workspace elements.  Returns
// the cudaError_t of the first launch that failed, or 0.
extern "C" int res2_block(int dtype, const void* x, const void* w1, const void* s1,
                          const void* t1, const void* wd, const void* sd, const void* td,
                          const void* w3, const void* s3, const void* t3, void* u, void* cat,
                          void* out, void* ws, int n, int cin, int width, int cout, int h, int w,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* fws = static_cast<float*>(ws);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, w1, f(s1), f(t1), wd, f(sd), f(td), w3, f(s3), f(t3), u, cat, out,
                           fws, n, cin, width, cout, h, w, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w1, f(s1), f(t1), wd, f(sd), f(td), w3, f(s3), f(t3), u,
                                   cat, out, fws, n, cin, width, cout, h, w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
