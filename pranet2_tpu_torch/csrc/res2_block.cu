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
// tile with the 3-row halo they need.  So the block is a chain of five
// products on one stream, and u and the sp_i go through device memory in
// the input's type, which keeps the TPU kernel's rounding points exactly;
// that spill is 0.52 GB a forward, 0.15 ms at 3.35 TB/s.  The first
// design's product engine (WMMA tiles of 128-thread blocks, a K step of 32
// with no pipeline, the 3x3 im2col gathered one value at a time from
// device memory) ran at under 3% of the tensor cores' rate, so the
// bfloat16 chain now runs on res2_gemm.cuh:
//   0. prep_kernel: the 3x3 weights to [co][tap][ci] and W3's columns to
//      the padded groups, zeros in the padding;
//   1. the 1x1 expand (x NCHW) with BN1 and ReLU: groups 0-2 into the
//      scratch u, group 3 into its place in the concat buffer cat, both
//      NHWC with each group padded to WP = width rounded up to 16;
//   2-4. conv i on the halo'd patches of u_i (+ sp_{i-1}, read from cat
//      and added as the patch is staged), BN, ReLU, sp_i into cat's group i;
//   5. the projection of cat with BN3, the residual x and ReLU, NCHW out.
// Where a product's grid is small (layers 3-4), its K is split and a
// reduce launch follows.  float32 (not served) keeps the NCHW chain of
// conv_gemm.cuh's FMA products.

#include <algorithm>

#include "conv_gemm.cuh"
#include "res2_gemm.cuh"

namespace {

using r2g::bf16;

// Byte offsets of the scratch a call carves: the maps u and cat, the
// prepared weights and the split-K partial sums, each 256-byte aligned.
struct Layout {
  size_t u, cat, wd, w3, part, total;
};

size_t up256(size_t b) { return (b + 255) / 256 * 256; }

Layout layout(int dtype, int n, int c, int width, int h, int w) {
  Layout l{};
  const long long hw = (long long)h * w, rows = n * hw;
  if (dtype == kFloat32) {
    // NCHW u (groups 0-2) and cat; split-K partials of the largest launch
    long long e = res2::workspace_elems<float>(4 * width, c, (int)hw, n);
    e = std::max(e, res2::workspace_elems<float>(width, 9 * width, (int)hw, n));
    e = std::max(e, res2::workspace_elems<float>(c, 4 * width, (int)hw, n));
    l.cat = up256(rows * 3 * width * sizeof(float));
    l.wd = l.w3 = l.part = l.cat + up256(rows * 4 * width * sizeof(float));
    l.total = l.part + up256(e * sizeof(float));
    return l;
  }
  const int wp = r2g::round16(width);
  long long e = r2g::part_elems(r2g::plan1x1(n, (int)hw, 4 * wp, c), rows, 4 * wp);
  e = std::max(e, r2g::part_elems(r2g::plan3x3(n, h, w, wp), rows, wp));
  e = std::max(e, r2g::part_elems(r2g::plan1x1(n, (int)hw, c, 4 * wp), rows, c));
  l.cat = up256(rows * 3 * wp * sizeof(bf16));
  l.wd = l.cat + up256(rows * 4 * wp * sizeof(bf16));
  l.w3 = l.wd + up256(3LL * width * 9 * wp * sizeof(bf16));
  l.part = l.w3 + up256((long long)c * 4 * wp * sizeof(bf16));
  l.total = l.part + up256(e * sizeof(float));
  return l;
}

// The 3x3 weights (3, width, width, 3, 3) OIHW to wdp (3, width, 9, wp),
// [co][tap][ci], and W3 (c, 4 width) to w3p (c, 4 wp); zeros at ci, j >=
// width.
__global__ void prep_kernel(const bf16* __restrict__ wd, const bf16* __restrict__ w3,
                            bf16* __restrict__ wdp, bf16* __restrict__ w3p, int width, int wp,
                            int c) {
  const long long n1 = 3LL * width * 9 * wp, n2 = (long long)c * 4 * wp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n1 + n2;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < n1) {
      const int ci = (int)(i % wp);
      const long long r = i / wp;
      const int tap = (int)(r % 9);
      const long long bco = r / 9;  // b * width + co
      wdp[i] = ci < width ? wd[(bco * width + ci) * 9 + tap] : __float2bfloat16(0.f);
    } else {
      const long long k = i - n1;
      const int j = (int)(k % wp), g = (int)(k / wp % 4);
      const long long co = k / wp / 4;
      w3p[k] = j < width ? w3[co * 4 * width + g * width + j] : __float2bfloat16(0.f);
    }
  }
}

int launch_bf16(const bf16* x, const bf16* w1, const float* s1, const float* t1, const bf16* wd,
                const float* sd, const float* td, const bf16* w3, const float* s3,
                const float* t3, bf16* out, unsigned char* scratch, int n, int c, int width,
                int h, int w, cudaStream_t s) {
  const Layout l = layout(kBFloat16, n, c, width, h, w);
  const int wp = r2g::round16(width), hw = h * w;
  bf16* u = reinterpret_cast<bf16*>(scratch + l.u);
  bf16* cat = reinterpret_cast<bf16*>(scratch + l.cat);
  bf16* wdp = reinterpret_cast<bf16*>(scratch + l.wd);
  bf16* w3p = reinterpret_cast<bf16*>(scratch + l.w3);
  float* part = reinterpret_cast<float*>(scratch + l.part);
  const long long nprep = 3LL * width * 9 * wp + (long long)c * 4 * wp;
  prep_kernel<<<grid_for(nprep, 256), 256, 0, s>>>(wd, w3, wdp, w3p, width, wp, c);
  int err = (int)cudaGetLastError();
  if (err) return err;

  r2g::Out o{};
  o.kind = r2g::kGroups;
  o.s = s1;
  o.t = t1;
  o.ncols = 4 * wp;
  o.w = width;
  o.wp = wp;
  o.gsplit = 3;
  o.dst0 = u;
  o.ld0 = 3 * wp;
  o.dst1 = cat + 3 * wp;
  o.ld1 = 4 * wp;
  o.part = part;
  err = r2g::launch1x1(r2g::A1{x, (long long)c * hw, 0, c}, r2g::B1{w1, c, 4 * wp, width, wp},
                       o, 0, n, hw, s);
  if (err) return err;

  for (int i = 0; i < 3; ++i) {
    r2g::Out oi{};
    oi.kind = r2g::kGroups;
    oi.s = sd + i * width;
    oi.t = td + i * width;
    oi.ncols = wp;
    oi.w = width;
    oi.wp = wp;
    oi.gsplit = 1;
    oi.dst0 = cat + i * wp;
    oi.ld0 = 4 * wp;
    oi.part = part;
    const r2g::A3 a{u + i * wp, 3 * wp, i ? cat + (i - 1) * wp : nullptr, 4 * wp,
                    wdp + (long long)i * width * 9 * wp, width, wp};
    if ((err = r2g::launch3x3(a, oi, n, h, w, s))) return err;
  }

  r2g::Out op{};
  op.kind = r2g::kResidual;
  op.s = s3;
  op.t = t3;
  op.ncols = c;
  op.res = x;
  op.out = out;
  op.part = part;
  return r2g::launch1x1(r2g::A1{cat, 0, 4 * wp, 4 * wp}, r2g::B1{w3p, 4 * wp, c, 0, 0}, op, 1, n,
                        hw, s);
}

int launch_f32(const float* x, const float* w1, const float* s1, const float* t1,
               const float* kd, const float* sd, const float* td, const float* w3,
               const float* s3, const float* t3, float* out, unsigned char* scratch, int n,
               int cin, int width, int cout, int h, int w, cudaStream_t stream) {
  const Layout l = layout(kFloat32, n, cin, width, h, w);
  const long long hw = (long long)h * w;
  float* u = reinterpret_cast<float*>(scratch + l.u);
  float* cat = reinterpret_cast<float*>(scratch + l.cat);
  float* ws = reinterpret_cast<float*>(scratch + l.part);
  res2::ConvArgs<float> a{};
  a.height = h;
  a.width = w;
  a.ws = ws;
  a.weight = w1;
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
  int err = res2::launch_conv<float, 1, false>(a, n, stream);
  if (err) return err;

  for (int i = 0; i < 3; ++i) {
    res2::ConvArgs<float> c{};
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
    if ((err = res2::launch_conv<float, 3, false>(c, n, stream))) return err;
  }

  res2::ConvArgs<float> p{};
  p.height = h;
  p.width = w;
  p.ws = ws;
  p.weight = w3;
  p.x = cat;
  p.s = s3;
  p.t = t3;
  p.res = x;
  p.out = out;
  p.x_img = 4 * width * hw;
  p.res_img = p.out_img = cout * hw;
  p.m = p.split = cout;
  p.cin = 4 * width;
  return res2::launch_conv<float, 1, true>(p, n, stream);
}

}  // namespace

// Bytes of scratch res2_block needs at these sizes (cout == cin), or -1
// for a bad dtype.
extern "C" long long res2_block_scratch(int dtype, int n, int c, int width, int h, int w) {
  if (dtype != kFloat32 && dtype != kBFloat16) return -1;
  return (long long)layout(dtype, n, c, width, h, w).total;
}

// The 3x3 products' pixel tile (rows, columns) and K splits at these sizes
// on the current device (bfloat16), into tile[0..2].
extern "C" void res2_block_tile(int n, int c, int width, int h, int w, int* tile) {
  const r2g::Plan pl = r2g::plan3x3(n, h, w, r2g::round16(width));
  tile[0] = pl.th;
  tile[1] = pl.tw;
  tile[2] = pl.splits;
}

// x and out (n, c, h, w), w1 (4 width, c), wd (3, width, width, 3, 3), w3
// (c, 4 width): contiguous, of type `dtype` (float32 or bfloat16; in
// bfloat16 x, w1 16-byte aligned and c a multiple of 8); s1, t1 (4 width),
// sd, td (3, width), s3, t3 (c) float32.  Scratch from the caller:
// res2_block_scratch bytes, 256-byte aligned.  Returns the cudaError_t of
// the first launch that failed, or 0.
extern "C" int res2_block(int dtype, const void* x, const void* w1, const void* s1,
                          const void* t1, const void* wd, const void* sd, const void* td,
                          const void* w3, const void* s3, const void* t3, void* out,
                          void* scratch, int n, int c, int width, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  switch (dtype) {
    case kFloat32:
      return launch_f32(f(x), f(w1), f(s1), f(t1), f(wd), f(sd), f(td), f(w3), f(s3), f(t3),
                        static_cast<float*>(out), sc, n, c, width, c, h, w, s);
    case kBFloat16: {
      auto b = [](const void* p) { return static_cast<const bf16*>(p); };
      if (c % 8) return (int)cudaErrorInvalidValue;
      return launch_bf16(b(x), b(w1), f(s1), f(t1), b(wd), f(sd), f(td), b(w3), f(s3), f(t3),
                         static_cast<bf16*>(out), sc, n, c, width, h, w, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
