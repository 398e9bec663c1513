// DSRA gate, and the whole decoder level of PraNet-V2 around it.
//
// dsra_gate: out = fg + fg * softmax_c(crop_fg - crop_bg), or the linear
// form out = fg + fg * (crop_fg - crop_bg), over NCHW maps.
// dsra_level: one decoder level in one launch: the crops (bilinear resizes
// of the previous level's fg/bg maps prev_* to the branch's size), the gate
// of the branch's ra_fg with them, and the full-size maps (bilinear resizes
// of the gated fg and of ra_bg, and with emit_prev of prev_* too, to the
// input's size).
//
// Replaces pranet2_tpu/ops/dsra.py::_dsra_kernel (launcher
// dsra_gate_pallas), which runs the gate over (rows, C) blocks of 4096
// rows.  The rounding follows that kernel: the difference is taken in the
// input type, the softmax in f32, the gate is cast to fg's type and
// fg + fg * gate is evaluated in fg's type, one rounding per operation, as
// the plain PyTorch version (dsra_gate_plain) does it; gate_pixel holds
// that arithmetic for both entry points.  The resizes follow ATen's
// upsample_bilinear2d (align_corners=False), which the plain version
// (ops/resize.py::resize_bilinear) calls on float32 copies: source index
// max(scale * (dst + 0.5) - 0.5, 0) with the float32 scale in / out, the
// second tap clamped at the edge, h0 * (w0 * a + w1 * b) + h1 * (...) in
// that order, one rounding to the map's type.
//
// What bounds it: device memory, and before the redesign the host.  At
// PraNet-V2 serving shapes (16, 1, {44, 22, 11}^2) bf16 a gate call moves
// at most 248 KB, so a standalone call costs one launch; around it the
// chain ran two crop resizes and two output resizes, each three ATen
// launches through a float32 copy, 45 launches a forward for 8 maps.  The
// level writes the 352^2 maps, 31.7 MB of bf16 a forward, about 9.5 us at
// 3.35 TB/s, and reads under 0.3 MB.  Design of dsra_level: one block per
// (band of up to 16 output rows, image).  The block stages, by cp.async in
// 16-byte granules, only the rows of the small maps its band needs (prev_*
// for the crops, ra_fg and ra_bg, and prev_* for emit_prev), computes the
// crops' difference and the gate of those rows once into shared memory,
// and writes the rows of the gated map it owns (the image's rows split
// evenly over the bands).  Then, a channel at a time, it takes ATen's
// resize apart as ATen's formula groups it: the horizontal pass
// w0 * a + w1 * b of each source row the band reads, once, into float32
// rows in shared memory (the column taps from a table made at the start),
// then each output pixel h0 * H(i0) + h1 * H(i1), each thread VEC adjacent
// pixels from two 16-byte shared loads a row and one 16-byte store (scalar
// where a row is not 16-byte aligned).  No float32 copy of a full-size map
// exists in device memory.  Computing both taps and four loads for every
// output pixel instead made the pixels' arithmetic the limit: 0.05-0.06 ms
// of device time for the three levels against 0.03 (H100 SXM, 700 W).

#include "mma.cuh"

#include <math.h>

#include <algorithm>

namespace {

// The TPU kernel's gate at one pixel over its c channels, the differences
// crop_fg - crop_bg given (rounded to T): out_k = f_k + f_k * gate_k.
template <typename T, typename Diff, typename Fg, typename Out>
__device__ __forceinline__ void gate_pixel(int c, int use_softmax, Diff diff, Fg fg, Out out) {
  float mx = -INFINITY, sum = 0.f;
  if (use_softmax) {
    for (int k = 0; k < c; ++k) mx = fmaxf(mx, diff(k));
    for (int k = 0; k < c; ++k) sum += expf(diff(k) - mx);
  }
  for (int k = 0; k < c; ++k) {
    const float d = diff(k);
    const float gate = round_to<T>(use_softmax ? expf(d - mx) / sum : d);
    const float f = fg(k);
    out(k, from_f32<T>(f + round_to<T>(f * gate)));
  }
}

template <typename T>
__global__ void dsra_gate_kernel(const T* __restrict__ fg, const T* __restrict__ cf,
                                 const T* __restrict__ cb, T* __restrict__ out, long long n,
                                 int c, long long hw, int use_softmax) {
  const long long total = n * hw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long base = (i / hw) * c * hw + i % hw;
    gate_pixel<T>(
        c, use_softmax,
        [&](int k) {
          const long long j = base + k * hw;
          return round_to<T>(to_f32<T>(cf[j]) - to_f32<T>(cb[j]));
        },
        [&](int k) { return to_f32<T>(fg[base + k * hw]); },
        [&](int k, T v) { out[base + k * hw] = v; });
  }
}

// The gate in float64, the plain version's arithmetic under
// promote_types(float64, float32): the difference, the softmax (max, exp,
// sum, divide) and fg + fg * gate all in double.  It serves a float64 train
// step (held against the CPU to 1e-9), not the models' float32 or bf16
// paths.
__global__ void dsra_gate_f64_kernel(const double* __restrict__ fg, const double* __restrict__ cf,
                                     const double* __restrict__ cb, double* __restrict__ out,
                                     long long n, int c, long long hw, int use_softmax) {
  const long long total = n * hw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long base = (i / hw) * c * hw + i % hw;
    double mx = -INFINITY, sum = 0.0;
    if (use_softmax) {
      for (int k = 0; k < c; ++k) mx = fmax(mx, cf[base + k * hw] - cb[base + k * hw]);
      for (int k = 0; k < c; ++k) sum += exp(cf[base + k * hw] - cb[base + k * hw] - mx);
    }
    for (int k = 0; k < c; ++k) {
      const long long j = base + k * hw;
      const double d = cf[j] - cb[j];
      const double gate = use_softmax ? exp(d - mx) / sum : d;
      out[j] = fg[j] + fg[j] * gate;
    }
  }
}

// ATen's upsample_bilinear2d along one axis: output index d reads source
// indices i0 and i1 with weights l0 and l1.
struct Taps {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Taps taps(float scale, int d, int in) {
  float src = scale * (d + 0.5f) - 0.5f;
  src = src < 0.f ? 0.f : src;
  Taps t;
  t.i0 = (int)src;
  t.i1 = t.i0 + (t.i0 < in - 1 ? 1 : 0);
  t.l1 = src - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// The value at (r, c) of a resize whose source element (i, j) is at(i, j);
// a same-size resize copies, as ATen does.
template <typename At>
__device__ __forceinline__ float resized(bool copy, float sh, float sw, int ih, int iw, int r,
                                         int c, At at) {
  if (copy) return at(r, c);
  const Taps y = taps(sh, r, ih), x = taps(sw, c, iw);
  return y.l0 * (x.l0 * at(y.i0, x.i0) + x.l1 * at(y.i0, x.i1)) +
         y.l1 * (x.l0 * at(y.i1, x.i0) + x.l1 * at(y.i1, x.i1));
}

// Source rows [lo, hi] that output rows [a, b] of a resize read.
__device__ __forceinline__ int2 rows_read(bool copy, float scale, int in, int a, int b) {
  if (copy) return make_int2(a, b);
  return make_int2(taps(scale, a, in).i0, taps(scale, b, in).i1);
}

__device__ __forceinline__ int granule_off(const void* g, int size) {
  return (int)((reinterpret_cast<uintptr_t>(g) & 15) / size);
}

struct Level {
  int n, c, hp, wp, h, w, oh, ow;  // prev (hp, wp), branch (h, w), output (oh, ow)
  float crop_h, crop_w;            // scales prev -> branch (the crops)
  float up_h, up_w;                // branch -> output (gated, ra_bg)
  float prev_h, prev_w;            // prev -> output (emit_prev)
  int rows, bands;                 // output rows a band, bands an image
  // rows staged at most: the gate's, prev's for the crops, the branch
  // maps' and prev's that the band's full-size rows read
  int gcap, pcap, ucap, ecap;
  int use_softmax, emit_prev;
};

// Shared memory of a level block, byte offsets: the full-size maps' column
// taps (from the branch's width, and from prev's), the horizontal pass of
// one channel's source rows (float32, ow wide: ucap rows of gated and of
// ra_bg, and ecap of prev_fg and of prev_bg), the crops' difference and
// the gate (gcap rows a channel), then one granule span a channel of
// ra_fg and of ra_bg (gcap rows), of prev_fg and prev_bg for the crops
// (pcap rows) and, with emit_prev, for the maps (ecap rows).
template <typename T>
struct LevelSmem {
  long long cols, hrow, diff, gate, fg, bg, prev, emit, total;
  long long fg_step, prev_step, emit_step;
  __host__ __device__ explicit LevelSmem(const Level& p) {
    const long long plane = ((long long)p.c * p.gcap * p.w * sizeof(T) + 15) / 16 * 16;
    fg_step = mma::span_bytes<T>((long long)p.gcap * p.w);
    prev_step = mma::span_bytes<T>((long long)p.pcap * p.wp);
    emit_step = p.emit_prev ? mma::span_bytes<T>((long long)p.ecap * p.wp) : 0;
    cols = 0;
    hrow = cols + 2LL * p.ow * sizeof(uint2);
    diff = hrow + 2LL * (p.ucap + (p.emit_prev ? p.ecap : 0)) * p.ow * sizeof(float);
    gate = diff + plane;
    fg = gate + plane;
    bg = fg + p.c * fg_step;
    prev = bg + p.c * fg_step;
    emit = prev + 2 * p.c * prev_step;
    total = emit + 2 * p.c * emit_step;
  }
};

template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T v[VEC];
};

constexpr int kLevelThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kLevelThreads)
    dsra_level_kernel(const T* __restrict__ pfg, const T* __restrict__ pbg,
                      const T* __restrict__ rfg, const T* __restrict__ rbg,
                      T* __restrict__ gated, T* __restrict__ maps, Level p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LevelSmem<T> L(p);
  T* sdiff = reinterpret_cast<T*>(smem + L.diff);
  T* sgate = reinterpret_cast<T*>(smem + L.gate);
  float* hrow = reinterpret_cast<float*>(smem + L.hrow);
  const int b = blockIdx.x, img = blockIdx.y;
  const int r0 = b * p.rows, r1 = min(r0 + p.rows, p.oh) - 1;
  const bool up_copy = p.h == p.oh && p.w == p.ow;
  const bool crop_copy = p.hp == p.h && p.wp == p.w;
  const bool prev_copy = p.hp == p.oh && p.wp == p.ow;
  // the branch maps' rows that the band's full-size rows read; the gate's
  // rows: those, and those the band writes out
  const int2 u = rows_read(up_copy, p.up_h, p.h, r0, r1);
  int2 g = u;
  const int own0 = (int)((long long)b * p.h / p.bands);
  const int own1 = (int)((long long)(b + 1) * p.h / p.bands);
  if (own0 < own1) g = make_int2(min(g.x, own0), max(g.y, own1 - 1));
  const int2 cr = rows_read(crop_copy, p.crop_h, p.hp, g.x, g.y);
  const int2 er = p.emit_prev ? rows_read(prev_copy, p.prev_h, p.hp, r0, r1) : make_int2(0, -1);
  // the launch sizes the caps past what these can reach
  if (g.y - g.x >= p.gcap || cr.y - cr.x >= p.pcap || u.y - u.x >= p.ucap ||
      er.y - er.x >= p.ecap)
    __trap();

  const long long sp = (long long)p.hp * p.wp, sb = (long long)p.h * p.w;
  const long long img_p = (long long)img * p.c * sp, img_b = (long long)img * p.c * sb;
  auto prev_src = [&](const T* base, int k, int lo) {
    return base + img_p + k * sp + (long long)lo * p.wp;
  };
  auto ra_src = [&](const T* base, int k) { return base + img_b + k * sb + (long long)g.x * p.w; };
  // channel k of a staged map, from its row `lo`
  auto staged = [&](long long at, const T* src) {
    return reinterpret_cast<const T*>(smem + at) + granule_off(src, sizeof(T));
  };
  const int rows_g = g.y - g.x + 1;
  for (int k = 0; k < p.c; ++k) {
    unsigned char* pk = smem + L.prev + 2 * k * L.prev_step;
    const long long cnt = (long long)(cr.y - cr.x + 1) * p.wp;
    mma::cp_span(reinterpret_cast<T*>(pk), prev_src(pfg, k, cr.x), cnt);
    mma::cp_span(reinterpret_cast<T*>(pk + L.prev_step), prev_src(pbg, k, cr.x), cnt);
    mma::cp_span(reinterpret_cast<T*>(smem + L.fg + k * L.fg_step), ra_src(rfg, k),
                 (long long)rows_g * p.w);
    mma::cp_span(reinterpret_cast<T*>(smem + L.bg + k * L.fg_step), ra_src(rbg, k),
                 (long long)rows_g * p.w);
    if (p.emit_prev) {
      unsigned char* ek = smem + L.emit + 2 * k * L.emit_step;
      const long long ecnt = (long long)(er.y - er.x + 1) * p.wp;
      mma::cp_span(reinterpret_cast<T*>(ek), prev_src(pfg, k, er.x), ecnt);
      mma::cp_span(reinterpret_cast<T*>(ek + L.emit_step), prev_src(pbg, k, er.x), ecnt);
    }
  }
  mma::commit();
  // the maps' column taps, (i0, l1) a column, from the branch's width and
  // from prev's
  uint2* cols = reinterpret_cast<uint2*>(smem + L.cols);
  for (int c = threadIdx.x; c < p.ow; c += blockDim.x) {
    const Taps a = taps(p.up_w, c, p.w);
    cols[c] = make_uint2(a.i0, __float_as_uint(a.l1));
    if (p.emit_prev) {
      const Taps e = taps(p.prev_w, c, p.wp);
      cols[p.ow + c] = make_uint2(e.i0, __float_as_uint(e.l1));
    }
  }
  mma::wait<0>();
  __syncthreads();

  // each gate row's pixels: the crops' difference, rounded as the gate's
  // inputs are, for every channel, then the gate; the band writes out the
  // gated rows it owns
  for (int i = threadIdx.x; i < rows_g * p.w; i += blockDim.x) {
    const int gr = i / p.w, x = i % p.w, row = g.x + gr;
    for (int k = 0; k < p.c; ++k) {
      const long long pk = L.prev + 2 * k * L.prev_step;
      const T* cf = staged(pk, prev_src(pfg, k, cr.x));
      const T* cb = staged(pk + L.prev_step, prev_src(pbg, k, cr.x));
      auto at_f = [=](int r, int c) { return to_f32<T>(cf[(r - cr.x) * p.wp + c]); };
      auto at_b = [=](int r, int c) { return to_f32<T>(cb[(r - cr.x) * p.wp + c]); };
      const float vf = resized(crop_copy, p.crop_h, p.crop_w, p.hp, p.wp, row, x, at_f);
      const float vb = resized(crop_copy, p.crop_h, p.crop_w, p.hp, p.wp, row, x, at_b);
      sdiff[(k * p.gcap + gr) * p.w + x] = from_f32<T>(round_to<T>(vf) - round_to<T>(vb));
    }
    const bool own = row >= own0 && row < own1;
    const long long at = img_b + (long long)row * p.w + x;
    gate_pixel<T>(
        p.c, p.use_softmax, [&](int k) { return to_f32<T>(sdiff[(k * p.gcap + gr) * p.w + x]); },
        [&](int k) {
          return to_f32<T>(staged(L.fg + k * L.fg_step, ra_src(rfg, k))[gr * p.w + x]);
        },
        [&](int k, T v) {
          sgate[(k * p.gcap + gr) * p.w + x] = v;
          if (own) gated[at + k * sb] = v;
        });
  }
  __syncthreads();

  // The band's full-size rows, a channel at a time: first the horizontal
  // pass of every source row they read, w0 * a + w1 * b in float32 as
  // ATen's inner sum; then each output row's h0 * H(i0) + h1 * H(i1),
  // each thread VEC adjacent pixels and one 16-byte store.  Maps: gated,
  // ra_bg, then prev_fg and prev_bg with emit_prev.
  const int nu = u.y - u.x + 1, ne = er.y - er.x + 1;
  const int nmaps = p.emit_prev ? 4 : 2, nrows = r1 - r0 + 1, groups = p.ow / VEC;
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const long long plane = (long long)p.oh * p.ow;
  auto hrows = [&](int m) {  // the first H row of map m
    return hrow + (long long)(m < 2 ? m * p.ucap : 2 * p.ucap + (m - 2) * p.ecap) * p.ow;
  };
  const int per_m = nrows * groups;
  const int dm = blockDim.x / per_m, drem = blockDim.x % per_m;
  const int drr = drem / groups, dq = drem % groups;
  for (int k = 0; k < p.c; ++k) {
    for (int it = threadIdx.x / 32; it < 2 * nu + 2 * ne; it += nwarps) {
      const int m = it < 2 * nu ? it / nu : 2 + (it - 2 * nu) / ne;
      const int sr = it < 2 * nu ? it % nu : (it - 2 * nu) % ne;  // row from u.x or er.x
      const T* src;
      const uint2* tab;
      int iw;
      bool copy;
      if (m < 2) {
        src = m == 0 ? sgate + (k * p.gcap + u.x - g.x + sr) * p.w
                     : staged(L.bg + k * L.fg_step, ra_src(rbg, k)) + (u.x - g.x + sr) * p.w;
        tab = cols, iw = p.w, copy = up_copy;
      } else {
        src = staged(L.emit + (2 * k + m - 2) * L.emit_step,
                     prev_src(m == 2 ? pfg : pbg, k, er.x)) +
              sr * p.wp;
        tab = cols + p.ow, iw = p.wp, copy = prev_copy;
      }
      float* h = hrows(m) + (long long)sr * p.ow;
      for (int c = lane; c < p.ow; c += 32) {
        if (copy) {
          h[c] = to_f32<T>(src[c]);
        } else {
          // taps(sw, c, iw), read back: i1 and l0 as taps() derives them
          const uint2 t = tab[c];
          const int i0 = (int)t.x, i1 = i0 + (i0 < iw - 1 ? 1 : 0);
          const float l1 = __uint_as_float(t.y), l0 = 1.f - l1;
          h[c] = l0 * to_f32<T>(src[i0]) + l1 * to_f32<T>(src[i1]);
        }
      }
    }
    __syncthreads();
    // item (map m, row rr, group q), stepped by blockDim.x without a
    // division
    int m = threadIdx.x / per_m, rr = threadIdx.x % per_m / groups,
        q = threadIdx.x % per_m % groups;
    for (; m < nmaps; m += dm) {
      const int r = r0 + rr;
      const bool copy = m < 2 ? up_copy : prev_copy;
      const Taps y = copy ? Taps{r, r, 1.f, 0.f}
                          : m < 2 ? taps(p.up_h, r, p.h) : taps(p.prev_h, r, p.hp);
      const int lo = m < 2 ? u.x : er.x;
      const float* h0 = hrows(m) + (long long)(y.i0 - lo) * p.ow + q * VEC;
      const float* h1 = hrows(m) + (long long)(y.i1 - lo) * p.ow + q * VEC;
      float a[VEC], c[VEC];
      if (VEC % 4 == 0) {
#pragma unroll
        for (int j = 0; j < VEC; j += 4) {
          *reinterpret_cast<float4*>(a + j) = *reinterpret_cast<const float4*>(h0 + j);
          *reinterpret_cast<float4*>(c + j) = *reinterpret_cast<const float4*>(h1 + j);
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) a[j] = h0[j], c[j] = h1[j];
      }
      Pack<T, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.v[j] = from_f32<T>(copy ? a[j] : y.l0 * a[j] + y.l1 * c[j]);
      T* dst = maps + (((long long)m * p.n + img) * p.c + k) * plane + (long long)r * p.ow;
      *reinterpret_cast<Pack<T, VEC>*>(dst + q * VEC) = out;
      q += dq;
      rr += drr;
      if (q >= groups) q -= groups, ++rr;
      if (rr >= nrows) rr -= nrows, ++m;
    }
    __syncthreads();
  }
}

template <typename T>
static void launch_gate(const void* fg, const void* cf, const void* cb, void* out, long long n,
                        int c, long long hw, int use_softmax, cudaStream_t stream) {
  const int threads = 256;
  dsra_gate_kernel<T><<<grid_for(n * hw, threads), threads, 0, stream>>>(
      static_cast<const T*>(fg), static_cast<const T*>(cf), static_cast<const T*>(cb),
      static_cast<T*>(out), n, c, hw, use_softmax);
}

static void launch_gate_f64(const void* fg, const void* cf, const void* cb, void* out,
                            long long n, int c, long long hw, int use_softmax,
                            cudaStream_t stream) {
  const int threads = 256;
  dsra_gate_f64_kernel<<<grid_for(n * hw, threads), threads, 0, stream>>>(
      static_cast<const double*>(fg), static_cast<const double*>(cf),
      static_cast<const double*>(cb), static_cast<double*>(out), n, c, hw, use_softmax);
}

// Rows of a resize in -> out that `rows` consecutive output rows read, at
// most (one more for the float source index's rounding).
static int rows_cap(int in, int out, int rows) {
  return (int)std::min<long long>(in, (long long)in * (rows - 1) / out + 4);
}

template <typename T>
static int launch_level(const void* pfg, const void* pbg, const void* rfg, const void* rbg,
                        void* gated, void* maps, int n, int c, int hp, int wp, int h, int w,
                        int oh, int ow, int use_softmax, int emit_prev, cudaStream_t stream) {
  Level p{n, c, hp, wp, h, w, oh, ow,
          (float)hp / h, (float)wp / w, (float)h / oh, (float)w / ow, (float)hp / oh,
          (float)wp / ow, 0, 0, 0, 0, 0, 0, use_softmax, emit_prev};
  // bands of up to 16 output rows, fewer where that leaves the card under
  // two blocks an SM or the staged rows do not fit a block
  const int sms = mma::sm_count();
  int rows = 16;
  while (rows > 1 && (long long)n * ((oh + rows - 1) / rows) < sms) rows /= 2;
  for (;; rows /= 2) {
    p.rows = rows;
    p.bands = (oh + rows - 1) / rows;
    // the gated rows: those read, and the owned share, which may lag or
    // lead them by about as much again
    p.gcap = (int)std::min<long long>(h, 3LL * (((long long)rows * h + oh - 1) / oh) + 8);
    p.pcap = (hp == h && wp == w) ? p.gcap : rows_cap(hp, h, p.gcap);
    p.ucap = (h == oh && w == ow) ? rows : rows_cap(h, oh, rows);
    p.ecap = !emit_prev ? 0 : (hp == oh && wp == ow) ? rows : rows_cap(hp, oh, rows);
    if (LevelSmem<T>(p).total <= mma::kSmemBlock || rows == 1) break;
  }
  const long long smem = LevelSmem<T>(p).total;
  if (smem > mma::kSmemBlock || n > 65535) return (int)cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  const bool vec = ((long long)ow * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(maps) % 16 == 0;
  auto kernel = vec ? dsra_level_kernel<T, V> : dsra_level_kernel<T, 1>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(p.bands, n), kLevelThreads, smem, stream>>>(
      static_cast<const T*>(pfg), static_cast<const T*>(pbg), static_cast<const T*>(rfg),
      static_cast<const T*>(rbg), static_cast<T*>(gated), static_cast<T*>(maps), p);
  return (int)cudaGetLastError();
}

}  // namespace

// fg, cf, cb, out: (n, c, hw) contiguous, one type (float64 too).
// Returns the cudaError_t of the launch.
extern "C" int dsra_gate(int dtype, const void* fg, const void* cf, const void* cb, void* out,
                         long long n, int c, long long hw, int use_softmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: launch_gate<float>(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    case kBFloat16: launch_gate<__nv_bfloat16>(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    case kFloat16: launch_gate<__half>(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    case kFloat64: launch_gate_f64(fg, cf, cb, out, n, c, hw, use_softmax, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// prev_fg, prev_bg: (n, c, hp, wp); ra_fg, ra_bg: (n, c, h, w); gated: (n,
// c, h, w) out; maps: (2 or 4 with emit_prev, n, c, oh, ow) out, in the
// order resized gated, ra_bg, prev_fg, prev_bg.  All contiguous, one type.
// Returns the cudaError_t of the launch.
extern "C" int dsra_level(int dtype, const void* prev_fg, const void* prev_bg, const void* ra_fg,
                          const void* ra_bg, void* gated, void* maps, int n, int c, int hp,
                          int wp, int h, int w, int oh, int ow, int use_softmax, int emit_prev,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DSRA_LEVEL(T)                                                                        \
  launch_level<T>(prev_fg, prev_bg, ra_fg, ra_bg, gated, maps, n, c, hp, wp, h, w, oh, ow, \
                  use_softmax, emit_prev, s)
  switch (dtype) {
    case kFloat32: return DSRA_LEVEL(float);
    case kBFloat16: return DSRA_LEVEL(__nv_bfloat16);
    case kFloat16: return DSRA_LEVEL(__half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DSRA_LEVEL
}
