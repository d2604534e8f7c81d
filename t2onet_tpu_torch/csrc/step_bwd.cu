// Backward kernel of one chain step for Hopper (sm_90a).
//
// step_bwd<false> replaces t2onet_tpu/ops/pallas_fused.py:_step_bwd_kernel
// (launched there by _step_bwd through _bwd_branches): the VJP of
// out = clip(op(img, p), 0, 1) for the op each image selected, giving d_img
// (B,3,H,W) and d_params (B,24), the latter summed over all pixels of the
// image. Slots 0 and 5 pass the cotangent through, slot 8 (white) passes
// nothing; both give zero d_params. The plain version is
// ops/step.py:fused_step_bwd_reference.
//
// step_bwd<true> replaces _masked_step_bwd_kernel, the VJP through the GIER
// mask blend y = op(x)*m + x*(1-m), out = clip(y, 0, 1): with
// gy = g * clip'(y), the op's cotangent is gy*m and x also gets gy*(1-m)
// directly; d_params sums gy*m * d op/d p. The mask gets no gradient. So
// masked white (slot 8) passes gy*(1-m) where the unmasked one passes
// nothing, and a pixel at exactly 0 or 1 outside the mask (y = x) passes
// g/2. Sharpness needs gy*m at the four neighbours, so it reads the mask on
// the same one-pixel ring as p*gc. Slots 0 and 5 are not blended.
//
// Tie rules are jnp's, as JAX differentiates the forward: clip'(y) is 1/2
// at y == 0 or 1, a pairwise max or min splits a tie in half (.25/.25/.5
// over three equal channels). The curves follow the min form of the
// forward (fused_step), not the bank's clip segments: at x == 0 the slope
// is S*p0/csum, twice the bank's value there (pallas_fused.py:500-503).
//
// What bounds it. Per pixel an op reads img and g (and the mask) and writes
// d_img: 36 bytes (40 masked); the identities move 24, unmasked white 12.
// At B=64, 128x128 with every slot that is 32-38 MB, about 10-11 us at
// 3.35 TB/s; at B=128, 512x512 1.03-1.22 GB, 0.31-0.36 ms. Against that each
// pixel costs 0-160 f32 operations, one or two divisions and, for the
// curves, 8 f64 additions per channel: bytes bound it. The kernel it
// replaces ran at 4-7x that bound (PERF.md): 123 registers a thread
// (q[24] doubles and three curves, sized for color whatever the slot), so 2
// blocks of 256 threads per SM; 24 block reductions of 2 barriers each per
// 1,024 pixels whatever the slot needed; and a second launch that summed
// the tiles with 24 more reductions per image (12 us at B=64).
//
// What the design does about it. One launch, grid (blocks per image, B),
// 256 threads a block; each block reads its image's slot (broadcast through
// shared memory) and takes either `tiles_per_block` 32x32 tiles of a
// sharpness image or the same number of 1,024-pixel runs of a pointwise
// image's flat planes (ops/step.py:plan). Pointwise slots need no
// neighbours and no shared tile: each thread takes 4 pixels at a time with
// 16-byte loads and stores of each plane (scalar ones when H*W % 4 != 0 or
// a tensor is not 16-byte aligned). The identities read only g, unmasked
// white reads nothing. Each slot keeps only the f64 sums it needs (0, 1, 2
// or 8 live; color runs its three channels one after another with 8 each),
// so the kernel needs far fewer registers. Sharpness keeps a halo design:
// img with a two-pixel halo and p*gc with a one-pixel ring in shared memory
// (cells outside the image hold 0, the zero padding of _shift_zero),
// filled by flat walks so that no warp idles on the 36- and 34-wide rows;
// the clamp's cotangent on the tile is recomputed from them rather than
// kept, 12-16 KB less shared memory per block (keeping it measured no
// faster: registers, not shared memory, cap a SM at 4 blocks). A block's sums
// take one pass: warp shuffles, the warps' partials in shared memory, one
// barrier, then a fixed-order sum over the warps. d_params needs no second
// launch and no atomic sum: each block writes its f64 partials, fences, and
// counts itself on its image's counter (zeroed by a memset before the
// launch, each call its own); the block that arrives last sums the image's
// partials in block order and writes the 24 gradients with the same scalar
// arithmetic as the plain version. Only the counter is atomic, so every
// run sums in the same order and gives
// the same bits. The per-pixel quantities are f32, as in the plain version;
// their sums are taken in f64 in both and rounded to f32 once, because the
// cotangents' signs make them cancel: f32 sums in two orders would differ by
// far more than the rounding of the result.
//
// Numerics. Built without --use_fast_math and with -fmad=false; every
// per-pixel expression follows the plain version's order, which follows the
// order of JAX's reverse pass, so d_img is bit-exact against it. The masked
// instantiation cuts the work and sums in the same order as the unmasked
// one, so under an all-ones mask it gives B3's bits.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks per SM: ops/step.py:MIN_BLOCKS_PER_SM
constexpr int kMaxParam = 24;
constexpr int kNQ = 24;        // f64 sums per block, at most (color)
constexpr int kCurveSteps = 8;
constexpr float kS = 1048576.0f;  // 2^20
constexpr float kSE = static_cast<float>(1e-12 * 1048576.0);

__device__ __forceinline__ bool isnan_(float x) { return x != x; }
__device__ __forceinline__ float max_(float a, float b) {
  return (a > b || isnan_(a)) ? a : b;
}
__device__ __forceinline__ float min_(float a, float b) {
  return (a < b || isnan_(a)) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_(max_(x, lo), hi);
}
// d clip(y, 0, 1)/dy, d max(a, b)/da, d min(a, b)/da with jnp's ties
__device__ __forceinline__ float clip_d(float y) {
  return (y > 0.0f && y < 1.0f) ? 1.0f
                                : ((y == 0.0f || y == 1.0f) ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float dmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// The clamp's input and its cotangent. Unmasked: y = o, and the op's
// cotangent is gc = g * clip'(o). Masked: y = o*m + x*(1-m), the op gets
// gc = g * clip'(y) * m and x directly g * clip'(y) * (1-m), which JAX's
// reverse pass adds to x's cotangent first (the blend is the forward's
// last step).
template <bool kMasked>
__device__ __forceinline__ float blend_ct(float o, float x, float g, float m,
                                          float* direct) {
  if constexpr (kMasked) {
    const float gy = g * clip_d(o * m + x * (1.0f - m));
    *direct = gy * (1.0f - m);
    return gy * m;
  } else {
    return g * clip_d(o);
  }
}

// ---- pointwise VJPs: x, g the pixel's channels; m its mask (kMasked);
// ---- d the result; q sums

template <bool kMasked>
__device__ __forceinline__ void bwd_brightness(const float* x, const float* g,
                                               float m, float p0, float* d,
                                               double* q) {
  const float m1 = max_(x[0], x[1]);
  const float v = max_(m1, x[2]);
  const float onep = 1.0f + p0;
  const float t = v * onep;
  const float c = clip(t, 0.0f, 1.0f);
  const float den = v + 1e-12f;
  const float k = c / den;
  float gc[3], dx[3], direct[3];
  for (int i = 0; i < 3; ++i) {
    gc[i] = blend_ct<kMasked>(x[i] * k, x[i], g[i], m, &direct[i]);
    dx[i] = gc[i] * k;
    if constexpr (kMasked) dx[i] = direct[i] + dx[i];
  }
  const float ct_k = (gc[0] * x[0] + gc[1] * x[1]) + gc[2] * x[2];
  const float ct_c = ct_k / den;
  const float ct_den = -((ct_k * (1.0f / (den * den))) * c);
  const float ct_t = ct_c * clip_d(t);
  const float ct_v = ct_den + ct_t * onep;
  const float ct_m1 = ct_v * dmax(m1, x[2]);
  d[0] = dx[0] + ct_m1 * dmax(x[0], x[1]);
  d[1] = dx[1] + ct_m1 * dmax(x[1], x[0]);
  d[2] = dx[2] + ct_v * dmax(x[2], m1);
  q[0] = q[0] + static_cast<double>(ct_t * v);
}

template <bool kMasked>
__device__ __forceinline__ void bwd_contrast(const float* x, const float* g,
                                             float m, float p0, float* d,
                                             double* q) {
  const float C0 = 3.1415926536f, C1 = -5.1677127683f, C2 = 2.5501634534f,
              C3 = -5.9925387121e-1f, C4 = 8.2058791186e-2f,
              C5 = -7.0429524662e-3f;
  const float lum_raw = (0.27f * x[0] + 0.67f * x[1]) + 0.06f * x[2];
  const float lum = clip(lum_raw, 0.0f, 1.0f);
  const float u = lum - 0.5f;
  const float v = u * u;
  const float w = v * v;
  const float wc = C4 + C5 * v;
  const float y_ = (C2 + C3 * v) + w * wc;
  const float acc = (C0 + C1 * v) + w * y_;
  const float au = acc * u;
  const float clum = au * 0.5f + 0.5f;
  const float den = lum + 1e-6f;
  const float ratio = clum / den;
  const float k = (1.0f - p0) + p0 * ratio;
  float gc[3], dx[3], direct[3];
  for (int i = 0; i < 3; ++i) {
    gc[i] = blend_ct<kMasked>(x[i] * k, x[i], g[i], m, &direct[i]);
    dx[i] = gc[i] * k;
    if constexpr (kMasked) dx[i] = direct[i] + dx[i];
  }
  const float ct_k = (gc[0] * x[0] + gc[1] * x[1]) + gc[2] * x[2];
  const float ct_ratio = ct_k * p0;
  const float ct_clum = ct_ratio / den;
  const float ct_den = -((ct_ratio * (1.0f / (den * den))) * clum);
  const float ct_au = ct_clum * 0.5f;
  const float ct_acc = ct_au * u;
  float ct_u = ct_au * acc;
  const float ct_y = ct_acc * w;
  float ct_w = ct_acc * y_;
  const float ct_wc = ct_y * w;
  ct_w = ct_w + ct_y * wc;
  float ct_v = ct_wc * C5;
  ct_v = ct_v + ct_y * C3;
  ct_v = ct_v + ct_acc * C1;
  ct_v = ct_v + ct_w * v;
  ct_v = ct_v + ct_w * v;
  ct_u = ct_u + ct_v * u;
  ct_u = ct_u + ct_v * u;
  const float ct_lr = (ct_den + ct_u) * clip_d(lum_raw);
  d[0] = dx[0] + ct_lr * 0.27f;
  d[1] = dx[1] + ct_lr * 0.67f;
  d[2] = dx[2] + ct_lr * 0.06f;
  q[0] = q[0] + static_cast<double>(ct_k * ratio);
  q[1] = q[1] + static_cast<double>(ct_k);
}

template <bool kMasked>
__device__ __forceinline__ void bwd_saturation(const float* x, const float* g,
                                               float m, float p0, float* d,
                                               double* q) {
  const float m1 = max_(x[0], x[1]);
  const float v = max_(m1, x[2]);
  const float n1 = min_(x[0], x[1]);
  const float mn = min_(n1, x[2]);
  const float dd = v - mn;
  const float ve = v + 1e-8f;
  const float onep = 1.0f + p0;
  const float t = dd * onep;
  const float mt = max_(t, 0.0f);
  const float nc = min_(mt, ve);
  const float num = nc * kS;
  const float den = dd * kS + kSE * ve;
  const float ratio = num / den;
  float gc[3], e[3], dx[3], direct[3];
  for (int i = 0; i < 3; ++i) {
    e[i] = v - x[i];
    gc[i] = blend_ct<kMasked>(v - ratio * e[i], x[i], g[i], m, &direct[i]);
    dx[i] = gc[i] * ratio;
    if constexpr (kMasked) dx[i] = direct[i] + dx[i];
  }
  float ct_e[3];
  for (int i = 0; i < 3; ++i) ct_e[i] = (-gc[i]) * ratio;
  const float ct_ratio =
      ((-gc[0]) * e[0] + (-gc[1]) * e[1]) + (-gc[2]) * e[2];
  const float ct_num = ct_ratio / den;
  const float ct_den = -((ct_ratio * (1.0f / (den * den))) * num);
  float ct_d = ct_den * kS;
  float ct_ve = ct_den * kSE;
  const float ct_nc = ct_num * kS;
  const float ct_m = ct_nc * dmin(mt, ve);
  ct_ve = ct_ve + ct_nc * dmin(ve, mt);
  const float ct_t = ct_m * dmax(t, 0.0f);
  ct_d = ct_d + ct_t * onep;
  const float ct_v = (((gc[0] + gc[1]) + gc[2]) +
                      ((ct_e[0] + ct_e[1]) + ct_e[2]) + ct_ve) + ct_d;
  const float ct_mn = -ct_d;
  const float ct_n1 = ct_mn * dmin(n1, x[2]);
  const float ct_m1 = ct_v * dmax(m1, x[2]);
  d[0] = (dx[0] + ct_n1 * dmin(x[0], x[1])) + ct_m1 * dmax(x[0], x[1]);
  d[1] = (dx[1] + ct_n1 * dmin(x[1], x[0])) + ct_m1 * dmax(x[1], x[0]);
  d[2] = (dx[2] + ct_mn * dmin(x[2], n1)) + ct_v * dmax(x[2], m1);
  q[0] = q[0] + static_cast<double>(ct_t * dd);
}

// Min-form curve coefficients: out = a*x - sum_j b[j-1] * min(x, j/8).
struct Curve {
  float a;
  float b[kCurveSteps - 1];
};

__device__ __forceinline__ Curve make_curve(const float* p) {
  float csum = 1e-10f;
  for (int i = 0; i < kCurveSteps; ++i) csum = csum + p[i];
  const float s = static_cast<float>(kCurveSteps) / csum;
  Curve c;
  c.a = s * p[kCurveSteps - 1];
  for (int j = 1; j < kCurveSteps; ++j) c.b[j - 1] = s * (p[j] - p[j - 1]);
  return c;
}

// One channel value through a curve's VJP; q gets [gc*x, -gc*min(x, j/8)].
template <bool kMasked>
__device__ __forceinline__ float bwd_curve(const Curve& c, float x, float g,
                                           float m, double* q) {
  float mins[kCurveSteps - 1];
  float out = c.a * x;
  for (int j = 1; j < kCurveSteps; ++j) {
    mins[j - 1] = min_(x, j * (1.0f / kCurveSteps));
    out = out - c.b[j - 1] * mins[j - 1];
  }
  float direct;
  const float gc = blend_ct<kMasked>(out, x, g, m, &direct);
  const float ngc = -gc;
  float dx = (ngc * c.b[kCurveSteps - 2]) *
             dmin(x, (kCurveSteps - 1) * (1.0f / kCurveSteps));
  if constexpr (kMasked) dx = direct + dx;
  for (int j = kCurveSteps - 2; j >= 1; --j) {
    dx = dx + (ngc * c.b[j - 1]) * dmin(x, j * (1.0f / kCurveSteps));
  }
  dx = dx + gc * c.a;
  q[0] = q[0] + static_cast<double>(gc * x);
  for (int j = 1; j < kCurveSteps; ++j) {
    q[j] = q[j] + static_cast<double>(ngc * mins[j - 1]);
  }
  return dx;
}

// The scalar end of a curve's VJP (ops/step.py:_curve_params).
__device__ void curve_params(const float* p, const float* q, float* dp) {
  float csum = 1e-10f;
  for (int i = 0; i < kCurveSteps; ++i) csum = csum + p[i];
  const float s = static_cast<float>(kCurveSteps) / csum;
  float cdiff[kCurveSteps];  // cdiff[j] for j = 1..7
  for (int j = 1; j < kCurveSteps; ++j) cdiff[j] = q[j] * s;
  float ct_s = q[7] * (p[7] - p[6]);
  for (int j = kCurveSteps - 2; j >= 1; --j) {
    ct_s = ct_s + q[j] * (p[j] - p[j - 1]);
  }
  ct_s = ct_s + q[0] * p[7];
  const float ct_csum =
      -((ct_s * (1.0f / (csum * csum))) * static_cast<float>(kCurveSteps));
  for (int i = 0; i < kCurveSteps; ++i) {
    float dv;
    if (i == kCurveSteps - 1) {
      dv = cdiff[i] + q[0] * s;
    } else if (i == 0) {
      dv = -cdiff[1];
    } else {
      dv = -cdiff[i + 1] + cdiff[i];
    }
    dp[i] = dv + ct_csum;
  }
}

// The f64 sums a slot reduces per image: 1 for brightness, saturation and
// sharpness, 2 for contrast, 8 per curve (3 curves for color), none for the
// identities and white.
__device__ __forceinline__ int slot_sums(int slot) {
  switch (slot) {
    case 1: case 3: case 7: return 1;
    case 2: return 2;
    case 4: return 3 * kCurveSteps;
    case 6: return kCurveSteps;
    default: return 0;
  }
}

// Each warp's sums of q[0..N) (shuffles in a fixed tree) into
// red[first + i][warp], written by its lane 0. The block's barrier follows.
template <int N>
__device__ __forceinline__ void warp_sums(const double* q,
                                          double (*red)[kWarps], int first) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double v = q[i];
    for (int off = 16; off > 0; off >>= 1) {
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    }
    if (threadIdx.x == 0) red[first + i][threadIdx.y] = v;
  }
}

// The image's slot, clamped into 0..8 as lax.switch clamps its index, read
// by every thread from shared memory. (Computed in registers, the clamp
// was fused by ptxas into a min/max whose predicate output was then taken
// for "slot == 8", which sent slots 5 and 6 down the white branch.)
__device__ __forceinline__ int block_slot(const int* slots, int bi, int* ss) {
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int s = slots[bi];
    *ss = s < 0 ? 0 : (s > 8 ? 8 : s);
  }
  __syncthreads();
  return *ss;
}

// One image's planes: img, g, d_img (3 planes of hw each) and the mask.
struct Planes {
  const float* x;
  const float* g;
  const float* m;
  float* d;
  size_t hw;
};

// 16-byte loads and stores with the streaming hint (evict first): every
// value is touched once, and the hint measured 8-14% faster than plain
// accesses on an H100 (PERF.md).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// f(x[3], g[3], m, d[3]) on every pixel of [start, end): four at a time
// with 16-byte accesses when vec (start a multiple of 4, hw % 4 == 0),
// else one at a time. A thread's pixels come in a fixed order.
template <bool kMasked, class F>
__device__ __forceinline__ void pixels3(const Planes& im, size_t start,
                                        size_t end, bool vec, F&& f) {
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const size_t hw = im.hw;
  if (vec) {
    for (size_t p = start + 4 * tid; p < end; p += 4 * kThreads) {
      float xs[3][4], gs[3][4], ms[4], ds[3][4];
      for (int c = 0; c < 3; ++c) {
        load4(im.x + c * hw + p, xs[c]);
        load4(im.g + c * hw + p, gs[c]);
      }
      if constexpr (kMasked) load4(im.m + p, ms);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x[3] = {xs[0][k], xs[1][k], xs[2][k]};
        const float gv[3] = {gs[0][k], gs[1][k], gs[2][k]};
        float d[3];
        f(x, gv, kMasked ? ms[k] : 0.0f, d);
        for (int c = 0; c < 3; ++c) ds[c][k] = d[c];
      }
      for (int c = 0; c < 3; ++c) store4(im.d + c * hw + p, ds[c]);
    }
  } else {
    for (size_t p = start + tid; p < end; p += kThreads) {
      float x[3], gv[3], d[3];
      for (int c = 0; c < 3; ++c) {
        x[c] = im.x[c * hw + p];
        gv[c] = im.g[c * hw + p];
      }
      f(x, gv, kMasked ? im.m[p] : 0.0f, d);
      for (int c = 0; c < 3; ++c) im.d[c * hw + p] = d[c];
    }
  }
}

// d = f(x, g, m) on channel c of every pixel of [start, end), as pixels3.
template <bool kMasked, class F>
__device__ __forceinline__ void pixels1(const Planes& im, int c, size_t start,
                                        size_t end, bool vec, F&& f) {
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const float* x = im.x + c * im.hw;
  const float* g = im.g + c * im.hw;
  float* d = im.d + c * im.hw;
  if (vec) {
    for (size_t p = start + 4 * tid; p < end; p += 4 * kThreads) {
      float xs[4], gs[4], ms[4], ds[4];
      load4(x + p, xs);
      load4(g + p, gs);
      if constexpr (kMasked) load4(im.m + p, ms);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ds[k] = f(xs[k], gs[k], kMasked ? ms[k] : 0.0f);
      }
      store4(d + p, ds);
    }
  } else {
    for (size_t p = start + tid; p < end; p += kThreads) {
      d[p] = f(x[p], g[p], kMasked ? im.m[p] : 0.0f);
    }
  }
}

// d_img = g (the identities: never blended) or 0 (unmasked white) on
// [start, end): reads g only, or nothing.
__device__ __forceinline__ void pass_or_zero(const Planes& im, size_t start,
                                             size_t end, bool vec, bool pass) {
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int c = 0; c < 3; ++c) {
    const float* g = im.g + c * im.hw;
    float* d = im.d + c * im.hw;
    if (vec) {
      for (size_t p = start + 4 * tid; p < end; p += 4 * kThreads) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (pass) load4(g + p, v);
        store4(d + p, v);
      }
    } else {
      for (size_t p = start + tid; p < end; p += kThreads) {
        d[p] = pass ? g[p] : 0.0f;
      }
    }
  }
}

// Sharpness scratch: img with a two-pixel halo and p*gc with a one-pixel
// ring, three planes each (29.4 KB of static shared memory).
constexpr int kSideX = kTile + 4;
constexpr int kSideC = kTile + 2;

// One 32x32 tile of a sharpness image at (ty0, tx0): d_img on the tile, q
// += gc * lap(img) over it. Every thread must call it; it ends with a
// barrier, so the next tile may reuse sx and scd.
template <bool kMasked>
__device__ __forceinline__ void sharpness_tile(
    const Planes& im, int H, int W, int ty0, int tx0, float p0,
    float (*sx)[kSideX][kSideX], float (*scd)[kSideC][kSideC], double* q) {
  const size_t hw = im.hw;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  // the halo and the ring are 36 and 34 wide: walked as flat arrays, so
  // that every warp's lanes are busy
  for (int i = tid; i < kSideX * kSideX; i += kThreads) {
    const int ry = i / kSideX, rx = i % kSideX;
    const int gy = ty0 - 2 + ry, gx = tx0 - 2 + rx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t gi = static_cast<size_t>(gy) * W + gx;
    for (int c = 0; c < 3; ++c) sx[c][ry][rx] = in ? im.x[c * hw + gi] : 0.0f;
  }
  __syncthreads();
  // p*gc on the tile and a one-pixel ring (gc the op's cotangent, which
  // needs the mask on the ring too); 0 outside the image
  for (int i = tid; i < kSideC * kSideC; i += kThreads) {
    const int ry = i / kSideC, rx = i % kSideC;
    const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t gi = static_cast<size_t>(gy) * W + gx;
    const float m = (kMasked && in) ? im.m[gi] : 0.0f;
    for (int c = 0; c < 3; ++c) {
      float cd = 0.0f;
      if (in) {
        const int y = ry + 1, x = rx + 1;  // position in sx
        const float v = sx[c][y][x];
        float delta = 4.0f * v;
        delta = delta - sx[c][y - 1][x];
        delta = delta - sx[c][y + 1][x];
        delta = delta - sx[c][y][x - 1];
        delta = delta - sx[c][y][x + 1];
        const float o = v + p0 * delta;
        float gc;
        if constexpr (kMasked) {
          gc = (im.g[c * hw + gi] * clip_d(o * m + v * (1.0f - m))) * m;
        } else {
          gc = im.g[c * hw + gi] * clip_d(o);
        }
        cd = gc * p0;
      }
      scd[c][ry][rx] = cd;
    }
  }
  __syncthreads();
  for (int ty = threadIdx.y; ty < kTile; ty += kBlockY) {
    const int gy = ty0 + ty;
    const int gx = tx0 + threadIdx.x;
    if (gy >= H || gx >= W) continue;
    const int y = ty + 1, x = threadIdx.x + 1;  // position in scd
    const size_t gi = static_cast<size_t>(gy) * W + gx;
    const float m = kMasked ? im.m[gi] : 0.0f;
    for (int c = 0; c < 3; ++c) {
      // the Laplacian and the clamp's cotangent again, as the ring had them
      const float v = sx[c][y + 1][x + 1];
      float delta = 4.0f * v;
      delta = delta - sx[c][y][x + 1];
      delta = delta - sx[c][y + 2][x + 1];
      delta = delta - sx[c][y + 1][x];
      delta = delta - sx[c][y + 1][x + 2];
      const float o = v + p0 * delta;
      float gc, dv;
      if constexpr (kMasked) {  // x's direct term first, then the op's
        const float gy_ = im.g[c * hw + gi] * clip_d(o * m + v * (1.0f - m));
        gc = gy_ * m;
        dv = gy_ * (1.0f - m) + gc;
      } else {
        gc = im.g[c * hw + gi] * clip_d(o);
        dv = gc;
      }
      dv = dv - scd[c][y][x - 1];
      dv = dv - scd[c][y][x + 1];
      dv = dv - scd[c][y - 1][x];
      dv = dv - scd[c][y + 1][x];
      dv = dv + scd[c][y][x] * 4.0f;
      im.d[c * hw + gi] = dv;
      q[0] = q[0] + static_cast<double>(gc * delta);
    }
  }
  __syncthreads();
}

// The image's 24 gradients from its rounded sums (the scalar end of the
// VJP, as the plain version has it).
__device__ void finish_params(int slot, const float* p, const float* tot,
                              float* out) {
  float dp[kMaxParam];
  for (int i = 0; i < kMaxParam; ++i) dp[i] = 0.0f;
  switch (slot) {
    case 1: case 3: case 7: dp[0] = tot[0]; break;
    case 2: dp[0] = tot[0] - tot[1]; break;
    case 4:
      for (int c = 0; c < 3; ++c) {
        curve_params(p + c * kCurveSteps, tot + c * kCurveSteps,
                     dp + c * kCurveSteps);
      }
      break;
    case 6: curve_params(p, tot, dp); break;
    default: break;
  }
  for (int i = 0; i < kMaxParam; ++i) out[i] = dp[i];
}

// Grid (blocks per image, B), block (32, 8). Block k of image b takes
// tiles [k*tpb, (k+1)*tpb) of a sharpness image, or pixels [k*tpb*1024,
// (k+1)*tpb*1024) of any other, and leaves its sums in
// partials[b][k][0..n); the last of the image's blocks to finish turns
// them into d_params[b]. counters (B,) are 0 before the launch.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
step_bwd(const float* __restrict__ imgs, const float* __restrict__ mask,
         const int* __restrict__ slots, const float* __restrict__ params,
         const float* __restrict__ g, float* __restrict__ d_img,
         double* __restrict__ partials, unsigned* __restrict__ counters,
         float* __restrict__ d_params, int H, int W, int tiles_per_block,
         int vec) {
  __shared__ float sp[kMaxParam];
  __shared__ double red[kNQ][kWarps];
  __shared__ float tot[kNQ];
  __shared__ int ss, last;
  __shared__ float sx[3][kSideX][kSideX];
  __shared__ float scd[3][kSideC][kSideC];

  const int bi = blockIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid < kMaxParam) {
    sp[tid] = params[static_cast<size_t>(bi) * kMaxParam + tid];
  }
  const int slot = block_slot(slots, bi, &ss);

  const size_t hw = static_cast<size_t>(H) * W;
  const Planes im{imgs + static_cast<size_t>(bi) * 3 * hw,
                  g + static_cast<size_t>(bi) * 3 * hw,
                  kMasked ? mask + static_cast<size_t>(bi) * hw : nullptr,
                  d_img + static_cast<size_t>(bi) * 3 * hw, hw};
  const size_t run = static_cast<size_t>(tiles_per_block) * kTile * kTile;
  const size_t start = blockIdx.x * run;
  const size_t end = start + run < hw ? start + run : hw;
  const bool v4 = vec != 0;

  switch (slot) {
    case 1: {
      double q[1] = {0.0};
      pixels3<kMasked>(im, start, end, v4, [&](const float* x, const float* gv,
                                               float m, float* d) {
        bwd_brightness<kMasked>(x, gv, m, sp[0], d, q);
      });
      warp_sums<1>(q, red, 0);
      break;
    }
    case 2: {
      double q[2] = {0.0, 0.0};
      pixels3<kMasked>(im, start, end, v4, [&](const float* x, const float* gv,
                                               float m, float* d) {
        bwd_contrast<kMasked>(x, gv, m, sp[0], d, q);
      });
      warp_sums<2>(q, red, 0);
      break;
    }
    case 3: {
      double q[1] = {0.0};
      pixels3<kMasked>(im, start, end, v4, [&](const float* x, const float* gv,
                                               float m, float* d) {
        bwd_saturation<kMasked>(x, gv, m, sp[0], d, q);
      });
      warp_sums<1>(q, red, 0);
      break;
    }
    case 4:  // color: one curve and 8 sums per channel, a channel at a time
      for (int c = 0; c < 3; ++c) {
        const Curve cv = make_curve(sp + c * kCurveSteps);
        double q[kCurveSteps];
#pragma unroll
        for (int i = 0; i < kCurveSteps; ++i) q[i] = 0.0;
        pixels1<kMasked>(im, c, start, end, v4, [&](float x, float gv,
                                                    float m) {
          return bwd_curve<kMasked>(cv, x, gv, m, q);
        });
        warp_sums<kCurveSteps>(q, red, c * kCurveSteps);
      }
      break;
    case 6: {  // tone: one curve, 8 sums over all channels
      const Curve cv = make_curve(sp);
      double q[kCurveSteps];
#pragma unroll
      for (int i = 0; i < kCurveSteps; ++i) q[i] = 0.0;
      for (int c = 0; c < 3; ++c) {
        pixels1<kMasked>(im, c, start, end, v4, [&](float x, float gv,
                                                    float m) {
          return bwd_curve<kMasked>(cv, x, gv, m, q);
        });
      }
      warp_sums<kCurveSteps>(q, red, 0);
      break;
    }
    case 7: {
      double q[1] = {0.0};
      const int tiles_x = (W + kTile - 1) / kTile;
      const int tiles = tiles_x * ((H + kTile - 1) / kTile);
      const int t0 = blockIdx.x * tiles_per_block;
      const int t1 =
          t0 + tiles_per_block < tiles ? t0 + tiles_per_block : tiles;
      for (int t = t0; t < t1; ++t) {
        sharpness_tile<kMasked>(im, H, W, (t / tiles_x) * kTile,
                                (t % tiles_x) * kTile, sp[0], sx, scd, q);
      }
      warp_sums<1>(q, red, 0);
      break;
    }
    case 8:  // white: a constant, blended into x by m
      if constexpr (kMasked) {
        pixels3<true>(im, start, end, v4, [&](const float* x, const float* gv,
                                              float m, float* d) {
          for (int c = 0; c < 3; ++c) {
            blend_ct<true>(1.0f, x[c], gv[c], m, &d[c]);
          }
        });
      } else {
        pass_or_zero(im, start, end, v4, false);
      }
      break;
    default:  // 0 and 5: identity, never blended
      pass_or_zero(im, start, end, v4, true);
      break;
  }

  const int n = slot_sums(slot);
  float* out = d_params + static_cast<size_t>(bi) * kMaxParam;
  if (n == 0) {
    if (blockIdx.x == 0 && tid < kMaxParam) out[tid] = 0.0f;
    return;
  }
  __syncthreads();  // the warps' sums are in red
  const int nblk = gridDim.x;
  double* part = partials + static_cast<size_t>(bi) * nblk * kNQ;
  if (tid < n) {
    double s = red[tid][0];
    for (int w = 1; w < kWarps; ++w) s = s + red[tid][w];
    part[static_cast<size_t>(blockIdx.x) * kNQ + tid] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&counters[bi], 1u) == static_cast<unsigned>(nblk - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < n) {  // the image's partials in block order, rounded once
    double s = __ldcg(part + tid);
    for (int k = 1; k < nblk; ++k) {
      s = s + __ldcg(part + static_cast<size_t>(k) * kNQ + tid);
    }
    tot[tid] = static_cast<float>(s);
  }
  __syncthreads();
  if (tid == 0) finish_params(slot, sp, tot, out);
}

template <bool kMasked>
int launch(const float* imgs, const float* mask, const int* slots,
           const float* params, const float* g, float* d_img,
           double* partials, unsigned* counters, float* d_params, int B,
           int H, int W, int tiles_per_block, int blocks_per_image, int vec,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(counters, 0, B * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_per_image, B);
  const dim3 block(kBlockX, kBlockY);
  step_bwd<kMasked><<<grid, block, 0, s>>>(
      imgs, mask, slots, params, g, d_img, partials, counters, d_params, H, W,
      tiles_per_block, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Zero the counters and launch the step's backward on `stream`: imgs, g,
// d_img (B,3,H,W) f32; slots (B,) i32; params, d_params (B,24) f32;
// partials scratch of B * blocks_per_image * 24 f64; counters (B,) u32
// scratch, the call's own. The cut
// (tiles_per_block, blocks_per_image, vec) is ops/step.py:plan's. All
// contiguous on the current device, and 16-byte aligned when vec. Returns
// the launch error (0 on success); does not synchronise.
int t2o_step_bwd_launch(const float* imgs, const int* slots,
                        const float* params, const float* g, float* d_img,
                        double* partials, unsigned* counters, float* d_params,
                        int B, int H, int W, int tiles_per_block,
                        int blocks_per_image, int vec, void* stream) {
  return launch<false>(imgs, nullptr, slots, params, g, d_img, partials,
                       counters, d_params, B, H, W, tiles_per_block,
                       blocks_per_image, vec, stream);
}

// The masked step's backward: as t2o_step_bwd_launch, plus mask (B,1,H,W)
// f32, which gets no gradient.
int t2o_step_bwd_masked_launch(const float* imgs, const float* mask,
                               const int* slots, const float* params,
                               const float* g, float* d_img, double* partials,
                               unsigned* counters, float* d_params, int B,
                               int H, int W, int tiles_per_block,
                               int blocks_per_image, int vec, void* stream) {
  return launch<true>(imgs, mask, slots, params, g, d_img, partials, counters,
                      d_params, B, H, W, tiles_per_block, blocks_per_image,
                      vec, stream);
}

const char* t2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
