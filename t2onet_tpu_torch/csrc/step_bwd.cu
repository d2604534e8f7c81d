// Backward kernels of one chain step for Hopper (sm_90a).
//
// step_bwd_tiles<false> (with step_bwd_params) replaces
// t2onet_tpu/ops/pallas_fused.py:_step_bwd_kernel (launched there by
// _step_bwd through _bwd_branches): the VJP of out = clip(op(img, p), 0, 1)
// for the op each image selected, giving d_img (B,3,H,W) and d_params
// (B,24), the latter summed over all pixels of the image. Slots 0 and 5 pass
// the cotangent through, slot 8 (white) passes nothing; both give zero
// d_params. The plain version is ops/step.py:fused_step_bwd_reference.
//
// step_bwd_tiles<true> replaces _masked_step_bwd_kernel, the VJP through
// the GIER mask blend y = op(x)*m + x*(1-m), out = clip(y, 0, 1): with
// gy = g * clip'(y), the op's cotangent is gy*m and x also gets gy*(1-m)
// directly; d_params sums gy*m * d op/d p. The mask gets no gradient. So
// masked white (slot 8) passes gy*(1-m) where the unmasked one passes
// nothing, and a pixel at exactly 0 or 1 outside the mask (y = x) passes
// g/2. Sharpness needs gy*m at the four neighbours: the mask is read on
// the same one-pixel ring as p*gc. Slots 0 and 5 are not blended. It moves
// 10 planes per pixel against 9: 42 MB at B=64, 128x128 (12.5 us at
// 3.35 TB/s), 1.34 GB at B=128, 512x512 (0.40 ms).
//
// Tie rules are jnp's, as JAX differentiates the forward: clip'(y) is 1/2
// at y == 0 or 1, a pairwise max or min splits a tie in half (.25/.25/.5
// over three equal channels). The curves follow the min form of the
// forward (fused_step), not the bank's clip segments: at x == 0 the slope
// is S*p0/csum, twice the bank's value there (pallas_fused.py:500-503).
//
// What bounds it. Per pixel it reads img and g and writes d_img: 36 bytes,
// so at B=64, 128x128 that is 38 MB (11 us at 3.35 TB/s) and at B=128,
// 512x512 1.2 GB (0.36 ms). Against that each pixel costs a few dozen
// flops and one or two divisions: like the forward, it is bound by
// instruction issue more than by bytes.
//
// What the design does about it. One block per 32x32 tile of an image
// (the TPU kernel held a whole image in VMEM). Pointwise ops need nothing
// but their pixel. Sharpness needs gc = g * clip'(img + p * lap(img)) at the
// four neighbours, so its block keeps img with a two-pixel halo and p*gc
// with a one-pixel halo in shared memory; cells outside the image hold 0,
// the zero padding of _shift_zero. d_params is reduced in two passes with
// no atomics, so it is the same on every run: each block reduces its
// tile's per-pixel quantities (warp shuffles, then the 8 warps in order)
// into a (B, tiles, 24) buffer, and a second kernel, one block per image,
// sums the tiles in order and turns the sums into the 24 gradients with
// the same scalar arithmetic as the plain version. The per-pixel
// quantities are f32, as in the plain version; their sums are taken in
// f64 in both and rounded to f32 once, because the cotangents' signs make
// them cancel: f32 sums in two orders would differ by far more than the
// rounding of the result.
//
// Numerics. Built without --use_fast_math and with -fmad=false; every
// expression follows the plain version's order, which follows the order
// of JAX's reverse pass.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxParam = 24;
constexpr int kNQ = 24;
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

// Sum v over the block's threads, in a fixed order: shuffles within each
// warp, then the warps' sums in warp order. red holds kWarps doubles.
// Every thread must call it; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0) {
    total = red[0];
    for (int w = 1; w < kWarps; ++w) total = total + red[w];
  }
  __syncthreads();
  return total;
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

// Sharpness scratch: img with a two-pixel halo, p*gc with a one-pixel halo
// and the clamp's cotangent on the tile, three planes each (41.8 KB of
// static shared memory); with kMasked also the mask on the tile (4 KB).
constexpr int kSideX = kTile + 4;
constexpr int kSideC = kTile + 2;

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
step_bwd_tiles(const float* __restrict__ imgs, const float* __restrict__ mask,
               const int* __restrict__ slots, const float* __restrict__ params,
               const float* __restrict__ g, float* __restrict__ d_img,
               double* __restrict__ partials, int H, int W) {
  __shared__ float sp[kMaxParam];
  __shared__ double red[kWarps];
  __shared__ int ss;
  __shared__ float sx[3][kSideX][kSideX];
  __shared__ float scd[3][kSideC][kSideC];
  __shared__ float sgc[3][kTile][kTile];
  constexpr int kMaskSide = kMasked ? kTile : 1;
  __shared__ float smk[kMaskSide][kMaskSide];

  const int bi = blockIdx.z;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid < kMaxParam) sp[tid] = params[static_cast<size_t>(bi) * kMaxParam + tid];
  const int slot = block_slot(slots, bi, &ss);

  const size_t hw = static_cast<size_t>(H) * W;
  const float* src = imgs + static_cast<size_t>(bi) * 3 * hw;
  const float* gsrc = g + static_cast<size_t>(bi) * 3 * hw;
  const float* msrc = kMasked ? mask + static_cast<size_t>(bi) * hw : nullptr;
  float* dst = d_img + static_cast<size_t>(bi) * 3 * hw;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;

  double q[kNQ];
#pragma unroll
  for (int i = 0; i < kNQ; ++i) q[i] = 0.0;

  if (slot == 7) {
    const float p0 = sp[0];
    for (int ry = threadIdx.y; ry < kSideX; ry += kBlockY) {
      const int gy = ty0 - 2 + ry;
      for (int rx = threadIdx.x; rx < kSideX; rx += kBlockX) {
        const int gx = tx0 - 2 + rx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const size_t gi = static_cast<size_t>(gy) * W + gx;
        for (int c = 0; c < 3; ++c) sx[c][ry][rx] = in ? src[c * hw + gi] : 0.0f;
      }
    }
    __syncthreads();
    // p*gc on the tile and a one-pixel ring (gc the op's cotangent, which
    // needs the mask on the ring too); 0 outside the image. sgc keeps the
    // clamp's cotangent on the tile, smk the mask.
    for (int ry = threadIdx.y; ry < kSideC; ry += kBlockY) {
      const int gy = ty0 - 1 + ry;
      for (int rx = threadIdx.x; rx < kSideC; rx += kBlockX) {
        const int gx = tx0 - 1 + rx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const size_t gi = static_cast<size_t>(gy) * W + gx;
        const bool center = ry >= 1 && ry <= kTile && rx >= 1 && rx <= kTile;
        float m = 0.0f;
        if constexpr (kMasked) {
          if (in) m = msrc[gi];
          if (center) smk[ry - 1][rx - 1] = m;
        }
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
              const float gy_ = gsrc[c * hw + gi] *
                                clip_d(o * m + v * (1.0f - m));
              gc = gy_ * m;
              if (center) sgc[c][ry - 1][rx - 1] = gy_;
            } else {
              gc = gsrc[c * hw + gi] * clip_d(o);
              if (center) sgc[c][ry - 1][rx - 1] = gc;
            }
            cd = gc * p0;
          }
          scd[c][ry][rx] = cd;
        }
      }
    }
    __syncthreads();
    for (int ty = threadIdx.y; ty < kTile; ty += kBlockY) {
      const int gy = ty0 + ty;
      const int gx = tx0 + threadIdx.x;
      if (gy >= H || gx >= W) continue;
      const int y = ty + 1, x = threadIdx.x + 1;  // position in scd
      const size_t gi = static_cast<size_t>(gy) * W + gx;
      for (int c = 0; c < 3; ++c) {
        float gc = sgc[c][ty][threadIdx.x];
        float dv = gc;
        if constexpr (kMasked) {  // x's direct term first, then the op's
          const float m = smk[ty][threadIdx.x];
          const float gy_ = gc;
          gc = gy_ * m;
          dv = gy_ * (1.0f - m) + gc;
        }
        dv = dv - scd[c][y][x - 1];
        dv = dv - scd[c][y][x + 1];
        dv = dv - scd[c][y - 1][x];
        dv = dv - scd[c][y + 1][x];
        dv = dv + scd[c][y][x] * 4.0f;
        dst[c * hw + gi] = dv;
        const float v = sx[c][y + 1][x + 1];  // the Laplacian again
        float delta = 4.0f * v;
        delta = delta - sx[c][y][x + 1];
        delta = delta - sx[c][y + 2][x + 1];
        delta = delta - sx[c][y + 1][x];
        delta = delta - sx[c][y + 1][x + 2];
        q[0] = q[0] + static_cast<double>(gc * delta);
      }
    }
  } else {
    Curve curves[3];
    if (slot == 4) {
      for (int c = 0; c < 3; ++c) curves[c] = make_curve(sp + c * kCurveSteps);
    } else if (slot == 6) {
      curves[0] = make_curve(sp);
    }
    for (int ty = threadIdx.y; ty < kTile; ty += kBlockY) {
      const int gy = ty0 + ty;
      const int gx = tx0 + threadIdx.x;
      if (gy >= H || gx >= W) continue;
      const size_t gi = static_cast<size_t>(gy) * W + gx;
      float x[3], gv[3], d[3];
      for (int c = 0; c < 3; ++c) {
        x[c] = src[c * hw + gi];
        gv[c] = gsrc[c * hw + gi];
      }
      const float m = kMasked ? msrc[gi] : 0.0f;
      if (slot == 1) {
        bwd_brightness<kMasked>(x, gv, m, sp[0], d, q);
      } else if (slot == 2) {
        bwd_contrast<kMasked>(x, gv, m, sp[0], d, q);
      } else if (slot == 3) {
        bwd_saturation<kMasked>(x, gv, m, sp[0], d, q);
      } else if (slot == 4) {  // color: one curve and 8 sums per channel
        d[0] = bwd_curve<kMasked>(curves[0], x[0], gv[0], m, q);
        d[1] = bwd_curve<kMasked>(curves[1], x[1], gv[1], m, q + kCurveSteps);
        d[2] = bwd_curve<kMasked>(curves[2], x[2], gv[2], m,
                                  q + 2 * kCurveSteps);
      } else if (slot == 6) {  // tone: one curve, 8 sums over all channels
        d[0] = bwd_curve<kMasked>(curves[0], x[0], gv[0], m, q);
        d[1] = bwd_curve<kMasked>(curves[0], x[1], gv[1], m, q);
        d[2] = bwd_curve<kMasked>(curves[0], x[2], gv[2], m, q);
      } else if (slot == 8) {  // white: a constant, blended into x by m
        if constexpr (kMasked) {
          for (int c = 0; c < 3; ++c) blend_ct<true>(1.0f, x[c], gv[c], m, &d[c]);
        } else {
          d[0] = d[1] = d[2] = 0.0f;
        }
      } else {  // 0 and 5: identity, never blended
        d[0] = gv[0];
        d[1] = gv[1];
        d[2] = gv[2];
      }
      for (int c = 0; c < 3; ++c) dst[c * hw + gi] = d[c];
    }
  }

  double* out = partials + (static_cast<size_t>(bi) * tiles + tile) * kNQ;
#pragma unroll
  for (int i = 0; i < kNQ; ++i) {
    const double s = block_sum(q[i], red);
    if (tid == 0) out[i] = s;
  }
}

// One block per image: sum the tiles' partials in order, then the scalar
// end of the VJP for the image's slot.
__global__ void __launch_bounds__(kThreads)
step_bwd_params(const int* __restrict__ slots, const float* __restrict__ params,
                const double* __restrict__ partials, float* __restrict__ d_params,
                int tiles) {
  __shared__ double red[kWarps];
  __shared__ float tot[kNQ];
  __shared__ int ss;
  const int bi = blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int slot = block_slot(slots, bi, &ss);
  const double* part = partials + static_cast<size_t>(bi) * tiles * kNQ;
  for (int i = 0; i < kNQ; ++i) {
    double s = 0.0;
    for (int t = tid; t < tiles; t += kThreads) s = s + part[t * kNQ + i];
    s = block_sum(s, red);
    if (tid == 0) tot[i] = static_cast<float>(s);  // rounded once, to f32
  }
  if (tid != 0) return;
  const float* p = params + static_cast<size_t>(bi) * kMaxParam;
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
  float* o = d_params + static_cast<size_t>(bi) * kMaxParam;
  for (int i = 0; i < kMaxParam; ++i) o[i] = dp[i];
}

template <bool kMasked>
int launch(const float* imgs, const float* mask, const int* slots,
           const float* params, const float* g, float* d_img,
           double* partials, float* d_params, int B, int H, int W,
           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kBlockX, kBlockY);
  step_bwd_tiles<kMasked><<<grid, block, 0, st>>>(imgs, mask, slots, params,
                                                  g, d_img, partials, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  step_bwd_params<<<B, block, 0, st>>>(slots, params, partials, d_params,
                                       grid.x * grid.y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the step's backward on `stream`: imgs, g, d_img (B,3,H,W) f32;
// slots (B,) i32; params, d_params (B,24) f32; partials scratch of
// B * tiles * 24 f64 (tiles = ceil(H/32) * ceil(W/32)). All contiguous on
// the current device. Returns the first launch error (0 on success); does
// not synchronise.
int t2o_step_bwd_launch(const float* imgs, const int* slots,
                        const float* params, const float* g, float* d_img,
                        double* partials, float* d_params, int B, int H, int W,
                        void* stream) {
  return launch<false>(imgs, nullptr, slots, params, g, d_img, partials,
                       d_params, B, H, W, stream);
}

// The masked step's backward: as t2o_step_bwd_launch, plus mask (B,1,H,W)
// f32, which gets no gradient.
int t2o_step_bwd_masked_launch(const float* imgs, const float* mask,
                               const int* slots, const float* params,
                               const float* g, float* d_img, double* partials,
                               float* d_params, int B, int H, int W,
                               void* stream) {
  return launch<true>(imgs, mask, slots, params, g, d_img, partials, d_params,
                      B, H, W, stream);
}

const char* t2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
