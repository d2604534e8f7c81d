// Operator-chain kernels for Hopper (sm_90a).
//
// chain_kernel<false, NP> replaces t2onet_tpu/ops/pallas_fused.py:_chain_kernel
// (launched there by fused_chain through _run_step). Per image it applies K
// steps of the selected op: slots 0 and 5 write nothing, every other slot
// does out = clip(op(out, p[b, k]), 0, 1). Ops: 1 brightness, 2 contrast,
// 3 saturation, 4 color, 6 tone, 7 sharpness, 8 white.
//
// chain_kernel<true, NP> replaces _masked_chain_kernel, the GIER local-edit
// chain: each executed step blends before the clamp,
// out = clip(op(x)*m + x*(1-m), 0, 1) with x the step's input and m the
// image's (B,1,H,W) mask, in that order of operations (pallas_fused.py
// :249-252); slots 0 and 5 still write nothing. The mask is read only at
// the pixel being written, never at a neighbour.
//
// What bounds it. Per pixel the chain reads three planes and writes three
// (24 bytes; 28 with the mask), once for all K steps; an unmasked chain
// with a white step only writes (12 bytes), since white sets every pixel
// to 1 whatever came before it. Against that each
// executed step costs 0-82 f32 instructions a pixel (built with
// -fmad=false, so a multiply and an add are two): about 10 instructions a
// byte at bench.py's K5 draw, which is the H100's own ratio (33.5e12
// instructions a second over 3.35 TB/s). So bytes bound the trainers' K=1
// steps, and chains of curves at K5 are bound by their arithmetic. The
// kernel it replaces ran at 2.3-6.4x the bytes bound: every step, even a
// pointwise one, read and wrote three shared-memory planes over the whole
// tile and halo and then waited at a barrier; images without a sharpness
// step paid for the tile machinery with 4-byte accesses; shared memory
// held two copies of the planes and a mask plane, sized for a K-pixel halo.
//
// What the design does about it. One launch, grid (blocks per image, B),
// 256 threads a block, at least two waves of blocks on the card
// (ops/chain.py:plan). A block loads its image's slots
// and params (the TPU's scalar prefetch), turns each curve step's knots
// into the curve's coefficients once, and counts the image's sharpness
// steps R.
// - R = 0, the flat path: no halo and no tile. The block takes a run of
//   tiles_per_block * 1,024 pixels of the image's flat planes; a thread
//   loads 4 pixels of each plane (and of the mask) with 16-byte streaming
//   loads, runs all K steps in registers and stores once (scalar accesses
//   when H*W % 4 != 0 or a tensor is not 16-byte aligned). Unmasked, a
//   chain with no sharpness step after its last white step takes it too:
//   it runs the steps after the white one on planes of ones and reads no
//   input. That is a compile-time variant of the flat path alone: a
//   branch at each load cost the whole kernel registers (32 B of spills
//   at NP 5), so a chain with sharpness after white runs whole on the
//   tile path and reads its input.
// - R > 0, the tile path: a 32x32 output tile with an R-pixel halo, side
//   S = 32 + 2R, cut flat over the threads: thread t holds the pixels
//   t + 256j, j < NP, and their mask values in registers (NP, fixed at
//   compile time so that the arrays stay in registers, is the smallest of
//   5, 7, 9, 16 with 256 NP >= (32 + 2K)^2: K=1 5, K=5 7, the GIER
//   decoder's K=8 9, up to K=16). Pointwise steps run there with no
//   barrier. A sharpness step writes the thread's pixels to one copy of
//   three shared planes of S*S, waits, reads the four neighbours, and
//   waits again before the planes may be written anew. Each sharpness
//   step shrinks the region of exact values by one pixel, so R pixels of
//   halo suffice; pixels outside the image hold exactly 0 through every
//   step, the zero padding that the reference's _shift_zero adds.
// Shared memory is 3 * (32 + 2K)^2 f32 (21,168 B at K5) for B1 and B2 alike,
// so registers, not shared memory, set the blocks a SM holds. Each NP has
// its own __launch_bounds__ (kMinBlocks, ops/chain.py:INSTANCES): 4 blocks
// of 64 registers at NP 5 (the trainers' K=1 steps, bound by bytes, want
// warps in flight), 3 of 80 at NP 7 and 9 (the tile path's pixels, curves
// and index walk fit with little spill; measured faster at K5 than 4
// blocks of 64 with their spills), 2 at NP 16.
//
// Numerics. The maths follows pallas_fused.py, not the bank: brightness
// with eps 1e-12; saturation in its single-division form with the 2^20
// scaling; contrast with the same sin(pi u)/u polynomial in Estrin form
// (not cospif); min-form curves with csum summed from 1e-10 in knot order.
// Built without --use_fast_math (IEEE division) and with -fmad=false, so
// each multiply and add rounds alone, as in the plain PyTorch version: the
// kernel agrees with it bit for bit. min, max and clamp keep NaN, as
// jnp.minimum/maximum/clip do.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kTilePixels = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kMaxSteps = 16;   // ops/chain.py:MAX_STEPS
constexpr int kMaxParam = 24;
constexpr int kCurveSteps = 8;
constexpr int kSharpSlot = 7;
constexpr int kWhiteSlot = 8;

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

__device__ __forceinline__ float max_(float a, float b) {
  return (a > b || isnan_(a)) ? a : b;
}

__device__ __forceinline__ float min_(float a, float b) {
  return (a < b || isnan_(a)) ? a : b;
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Min-form curve coefficients: out = a*x - sum_j b[j-1] * min(x, j/8).
// In shared memory a curve step's 8 knots are replaced by (a, b[0..6]).
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

// q in shared memory, 16-byte aligned: two 16-byte loads
__device__ __forceinline__ Curve load_curve(const float* q) {
  const float4 lo = *reinterpret_cast<const float4*>(q);
  const float4 hi = *reinterpret_cast<const float4*>(q + 4);
  return Curve{lo.x, {lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// min(x, j/8) needs no NaN rule here (fminf would return j/8): a NaN x
// makes a*x, and so the result, NaN whatever the min gives.
__device__ __forceinline__ float apply_curve(const Curve& c, float x) {
  float out = c.a * x;
#pragma unroll
  for (int j = 1; j < kCurveSteps; ++j) {
    out = out - c.b[j - 1] * fminf(x, j * (1.0f / kCurveSteps));
  }
  return out;
}

// sin(pi*u)/u polynomial, the coefficients of pallas_fused._SINPI_C
__device__ __forceinline__ float contrast_scale(float r, float g, float b,
                                                float p) {
  const float lum = clip(0.27f * r + 0.67f * g + 0.06f * b, 0.0f, 1.0f);
  const float u = lum - 0.5f;
  const float v = u * u;
  const float w = v * v;
  const float acc = (3.1415926536f + -5.1677127683f * v) +
                    w * ((2.5501634534f + -5.9925387121e-1f * v) +
                         w * (8.2058791186e-2f + -7.0429524662e-3f * v));
  const float clum = (acc * u) * 0.5f + 0.5f;
  const float ratio = clum / (lum + 1e-6f);
  return (1.0f - p) + p * ratio;
}

// A step's result y for a pixel whose input was x: blended by the mask m
// when kMasked, then clamped.
template <bool kMasked>
__device__ __forceinline__ float finish(float y, float x, float m) {
  if constexpr (kMasked) y = y * m + x * (1.0f - m);
  return clip(y, 0.0f, 1.0f);
}

// N pixels of one thread: three channels and the mask (kMasked only).
template <int N>
struct Pixels {
  float c[3][N];
  float m[N];
};

// One pointwise step (slot 1-4, 6 or 8; p its params, or for a curve its
// coefficients) on the pixels whose bit is set in `act`.
template <bool kMasked, int N>
__device__ __forceinline__ void pointwise_step(int slot, const float* p,
                                               Pixels<N>& px, unsigned act) {
  switch (slot) {
    case 1: {  // brightness
      const float onep = 1.0f + p[0];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (!((act >> j) & 1u)) continue;
        const float r = px.c[0][j], g = px.c[1][j], b = px.c[2][j];
        const float v = max_(max_(r, g), b);
        const float k = clip(v * onep, 0.0f, 1.0f) / (v + 1e-12f);
        px.c[0][j] = finish<kMasked>(r * k, r, px.m[j]);
        px.c[1][j] = finish<kMasked>(g * k, g, px.m[j]);
        px.c[2][j] = finish<kMasked>(b * k, b, px.m[j]);
      }
      break;
    }
    case 2: {  // contrast
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (!((act >> j) & 1u)) continue;
        const float r = px.c[0][j], g = px.c[1][j], b = px.c[2][j];
        const float k = contrast_scale(r, g, b, p[0]);
        px.c[0][j] = finish<kMasked>(r * k, r, px.m[j]);
        px.c[1][j] = finish<kMasked>(g * k, g, px.m[j]);
        px.c[2][j] = finish<kMasked>(b * k, b, px.m[j]);
      }
      break;
    }
    case 3: {  // saturation, single division scaled by 2^20
      const float S = 1048576.0f;
      const float onep = 1.0f + p[0];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (!((act >> j) & 1u)) continue;
        const float r = px.c[0][j], g = px.c[1][j], b = px.c[2][j];
        const float v = max_(max_(r, g), b);
        const float mn = min_(min_(r, g), b);
        const float d = v - mn;
        const float ve = v + 1e-8f;
        const float num = clip(d * onep, 0.0f, ve) * S;
        const float ratio =
            num / (d * S + static_cast<float>(1e-12 * 1048576.0) * ve);
        px.c[0][j] = finish<kMasked>(v - ratio * (v - r), r, px.m[j]);
        px.c[1][j] = finish<kMasked>(v - ratio * (v - g), g, px.m[j]);
        px.c[2][j] = finish<kMasked>(v - ratio * (v - b), b, px.m[j]);
      }
      break;
    }
    case 4:  // color: one curve per channel, a channel at a time
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const Curve cv = load_curve(p + c * kCurveSteps);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (!((act >> j) & 1u)) continue;
          const float x = px.c[c][j];
          px.c[c][j] = finish<kMasked>(apply_curve(cv, x), x, px.m[j]);
        }
      }
      break;
    case 6: {  // tone: one curve for all channels
      const Curve cv = load_curve(p);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (!((act >> j) & 1u)) continue;
          const float x = px.c[c][j];
          px.c[c][j] = finish<kMasked>(apply_curve(cv, x), x, px.m[j]);
        }
      }
      break;
    }
    case 8:  // white
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (!((act >> j) & 1u)) continue;
          px.c[c][j] = finish<kMasked>(1.0f, px.c[c][j], px.m[j]);
        }
      }
      break;
    default:
      break;
  }
}

// 16-byte loads and stores with the streaming hint (evict first): the flat
// path touches every value once.
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

// All K steps (none of them sharpness) on N pixels held in registers.
template <bool kMasked, int N>
__device__ __forceinline__ void pointwise_chain(const int* ss, const float* sp,
                                                int K, Pixels<N>& px) {
  for (int k = 0; k < K; ++k) {
    const int slot = ss[k];  // uniform across the block
    if (slot == 0 || slot == 5) continue;
    pointwise_step<kMasked, N>(slot, sp + k * kMaxParam, px, (1u << N) - 1u);
  }
}

// One image's planes: src and dst (3 planes of hw each) and its mask.
struct Planes {
  const float* src;
  const float* m;
  float* dst;
  size_t hw;
};

// The flat path: every pixel of [start, end), 4 at a time with 16-byte
// accesses when vec (start a multiple of 4, hw % 4 == 0), else one at a
// time. kOnes: the chain starts from planes of ones, and src is not read.
template <bool kMasked, bool kOnes>
__device__ __forceinline__ void flat_chain(const Planes& im, size_t start,
                                           size_t end, bool vec, const int* ss,
                                           const float* sp, int K) {
  const int tid = threadIdx.x;
  const size_t hw = im.hw;
  if (vec) {
    for (size_t p = start + 4 * tid; p < end; p += 4 * kThreads) {
      Pixels<4> px;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (kOnes) {
#pragma unroll
          for (int j = 0; j < 4; ++j) px.c[c][j] = 1.0f;
        } else {
          load4(im.src + c * hw + p, px.c[c]);
        }
      }
      if constexpr (kMasked) {
        load4(im.m + p, px.m);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) px.m[j] = 0.0f;
      }
      pointwise_chain<kMasked, 4>(ss, sp, K, px);
#pragma unroll
      for (int c = 0; c < 3; ++c) store4(im.dst + c * hw + p, px.c[c]);
    }
  } else {
    for (size_t p = start + tid; p < end; p += kThreads) {
      Pixels<1> px;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        px.c[c][0] = kOnes ? 1.0f : im.src[c * hw + p];
      }
      px.m[0] = kMasked ? im.m[p] : 0.0f;
      pointwise_chain<kMasked, 1>(ss, sp, K, px);
#pragma unroll
      for (int c = 0; c < 3; ++c) im.dst[c * hw + p] = px.c[c][0];
    }
  }
}

// (ry, rx) of pixel i + 256 from (ry, rx) of pixel i in a region of side
// `side` (256 = dq * side + dr, dr < side)
__device__ __forceinline__ void next_pixel(int& ry, int& rx, int dq, int dr,
                                           int side) {
  ry += dq;
  rx += dr;
  if (rx >= side) {
    rx -= side;
    ++ry;
  }
}

// The tile path: the 32x32 tile at (ty0, tx0) of an image with R
// sharpness steps, its region (side 32 + 2R) NP pixels a thread in
// registers, `planes` the block's shared memory (3 * side^2 f32 at least).
// Every thread must call it; it ends after a barrier, so the next tile may
// reuse the planes.
template <bool kMasked, int NP>
__device__ __forceinline__ void tile_chain(const Planes& im, int H, int W,
                                           int ty0, int tx0, int R,
                                           const int* ss, const float* sp,
                                           int K, float* planes) {
  const int tid = threadIdx.x;
  const int side = kTile + 2 * R;
  const int n = side * side;
  const size_t hw = im.hw;
  // pixel i = tid + 256j sits at (ry, rx) = (i / side, i % side), walked
  // without a division per pixel: 256 = dq * side + dr
  const int dq = kThreads / side, dr = kThreads - dq * side;
  const int ry0 = tid / side, rx0 = tid - ry0 * side;
  Pixels<NP> px;
  // the pixel's distance from the region's border; -1 outside the image
  // or past the region's last pixel
  int lim[NP];
  int ry = ry0, rx = rx0;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = tid + j * kThreads;
    const int gy = ty0 - R + ry, gx = tx0 - R + rx;
    const bool in = i < n && gy >= 0 && gy < H && gx >= 0 && gx < W;
    lim[j] = in ? min(min(ry, rx), min(side - 1 - ry, side - 1 - rx)) : -1;
    px.m[j] = 0.0f;
    if (in) {
      const size_t gi = static_cast<size_t>(gy) * W + gx;
#pragma unroll
      for (int c = 0; c < 3; ++c) px.c[c][j] = __ldg(im.src + c * hw + gi);
      if constexpr (kMasked) px.m[j] = __ldg(im.m + gi);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) px.c[c][j] = 0.0f;
    }
    next_pixel(ry, rx, dq, dr, side);
  }
  // pixels that still hold exact values: in the image and at distance >=
  // the sharpness steps done so far from the region's border
  int sharp_done = 0;
  unsigned act = 0;
#pragma unroll
  for (int j = 0; j < NP; ++j) act |= (lim[j] >= 0 ? 1u : 0u) << j;

  for (int k = 0; k < K; ++k) {
    const int slot = ss[k];  // uniform across the block
    const float* p = sp + k * kMaxParam;
    if (slot == 0 || slot == 5) continue;
    if (slot != kSharpSlot) {
      pointwise_step<kMasked, NP>(slot, p, px, act);
      continue;
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int i = tid + j * kThreads;
      if (i < n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) planes[c * n + i] = px.c[c][j];
      }
    }
    __syncthreads();
    ++sharp_done;
    const float amount = p[0];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (lim[j] < sharp_done) continue;  // the ring outside is carried over
      const int i = tid + j * kThreads;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* q = planes + c * n;
        const float v = px.c[c][j];
        float delta = 4.0f * v;
        delta = delta - q[i - side];  // img[y-1, x]
        delta = delta - q[i + side];  // img[y+1, x]
        delta = delta - q[i - 1];     // img[y, x-1]
        delta = delta - q[i + 1];     // img[y, x+1]
        px.c[c][j] = finish<kMasked>(v + amount * delta, v, px.m[j]);
      }
    }
    __syncthreads();
    act = 0;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      act |= (lim[j] >= sharp_done ? 1u : 0u) << j;
    }
  }

  ry = ry0;
  rx = rx0;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (lim[j] >= R) {  // not the halo, and inside the image
      const size_t gi =
          static_cast<size_t>(ty0 - R + ry) * W + (tx0 - R + rx);
#pragma unroll
      for (int c = 0; c < 3; ++c) __stcs(im.dst + c * hw + gi, px.c[c][j]);
    }
    next_pixel(ry, rx, dq, dr, side);
  }
}

// Grid (blocks per image, B), 256 threads. Block k of image b takes tiles
// [k*tpb, (k+1)*tpb) of an image with a sharpness step, or pixels
// [k*tpb*1024, (k+1)*tpb*1024) of any other; a block past the image's end
// returns. Dynamic shared memory: the tile path's planes. kMinBlocks, the
// blocks per SM that registers are held to, grows with NP's registers.
template <bool kMasked, int NP, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chain_kernel(const float* __restrict__ imgs, const float* __restrict__ mask,
             const int* __restrict__ slots, const float* __restrict__ params,
             float* __restrict__ out, int H, int W, int K,
             int tiles_per_block, int vec) {
  extern __shared__ float planes[];
  __shared__ __align__(16) float sp[kMaxSteps * kMaxParam];
  __shared__ int ss[kMaxSteps];

  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < K * kMaxParam; i += kThreads) {
    sp[i] = params[static_cast<size_t>(bi) * K * kMaxParam + i];
  }
  if (tid < K) {
    const int s = slots[static_cast<size_t>(bi) * K + tid];
    ss[tid] = s < 0 ? 0 : (s > 8 ? 8 : s);  // lax.switch clamps its index
  }
  __syncthreads();
  // a curve step's knots become its curves' coefficients, once per block
  if (tid < K && (ss[tid] == 4 || ss[tid] == 6)) {
    float* p = sp + tid * kMaxParam;
    for (int c = 0; c < (ss[tid] == 4 ? 3 : 1); ++c) {
      const Curve cv = make_curve(p + c * kCurveSteps);
      p[c * kCurveSteps] = cv.a;
      for (int j = 1; j < kCurveSteps; ++j) p[c * kCurveSteps + j] = cv.b[j - 1];
    }
  }
  __syncthreads();

  // Unmasked, a white step sets every pixel to 1 whatever its input: k0
  // is the step after the last one (0 if none), r0 the sharpness steps
  // before it.
  int k0 = 0;
  if constexpr (!kMasked) {
    for (int k = 0; k < K; ++k) k0 = ss[k] == kWhiteSlot ? k + 1 : k0;
  }
  int R = 0, r0 = 0;
  for (int k = 0; k < K; ++k) {
    R += (ss[k] == kSharpSlot);
    r0 += (ss[k] == kSharpSlot && k < k0);
  }
  const size_t hw = static_cast<size_t>(H) * W;
  const Planes im{imgs + static_cast<size_t>(bi) * 3 * hw,
                  kMasked ? mask + static_cast<size_t>(bi) * hw : nullptr,
                  out + static_cast<size_t>(bi) * 3 * hw, hw};
  if (R == r0) {  // no sharpness step after the last white one
    const size_t run = static_cast<size_t>(tiles_per_block) * kTilePixels;
    const size_t start = blockIdx.x * run;
    if (start >= hw) return;
    const size_t end = start + run < hw ? start + run : hw;
    if constexpr (!kMasked) {
      if (k0 > 0) {  // the steps after the white one, from ones
        flat_chain<false, true>(im, start, end, vec != 0, ss + k0,
                                sp + k0 * kMaxParam, K - k0);
        return;
      }
    }
    flat_chain<kMasked, false>(im, start, end, vec != 0, ss, sp, K);
    return;
  }
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles = tiles_x * ((H + kTile - 1) / kTile);
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = t0 + tiles_per_block < tiles ? t0 + tiles_per_block : tiles;
  for (int t = t0; t < t1; ++t) {
    tile_chain<kMasked, NP>(im, H, W, (t / tiles_x) * kTile,
                            (t % tiles_x) * kTile, R, ss, sp, K, planes);
  }
}

template <bool kMasked, int NP, int kMinBlocks>
int launch_np(const float* imgs, const float* mask, const int* slots,
              const float* params, float* out, int B, int H, int W, int K,
              int tiles_per_block, int blocks_per_image, int vec, int smem,
              cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<kMasked, NP, kMinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_kernel<kMasked, NP, kMinBlocks>
      <<<dim3(blocks_per_image, B), kThreads, smem, stream>>>(
          imgs, mask, slots, params, out, H, W, K, tiles_per_block, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMasked>
int launch(const float* imgs, const float* mask, const int* slots,
           const float* params, float* out, int B, int H, int W, int K,
           int tiles_per_block, int blocks_per_image, int vec,
           int pixels_per_thread, int smem, void* stream) {
  const int side = kTile + 2 * K;
  if (K < 0 || K > kMaxSteps || pixels_per_thread * kThreads < side * side ||
      smem < 3 * side * side * static_cast<int>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (pixels per thread, blocks per SM): ops/chain.py:INSTANCES
  switch (pixels_per_thread) {
    case 5:
      return launch_np<kMasked, 5, 4>(imgs, mask, slots, params, out, B, H, W, K,
                                   tiles_per_block, blocks_per_image, vec,
                                   smem, s);
    case 7:
      return launch_np<kMasked, 7, 3>(imgs, mask, slots, params, out, B, H, W, K,
                                   tiles_per_block, blocks_per_image, vec,
                                   smem, s);
    case 9:
      return launch_np<kMasked, 9, 3>(imgs, mask, slots, params, out, B, H, W, K,
                                   tiles_per_block, blocks_per_image, vec,
                                   smem, s);
    case 16:
      return launch_np<kMasked, 16, 2>(imgs, mask, slots, params, out, B, H, W,
                                    K, tiles_per_block, blocks_per_image, vec,
                                    smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch the chain on `stream`. imgs/out (B,3,H,W) f32, slots (B,K) i32,
// params (B,K,24) f32, all contiguous on the current device, and 16-byte
// aligned when vec. The cut (tiles_per_block, blocks_per_image, vec,
// pixels_per_thread, smem) is ops/chain.py:plan's. Returns the cudaError_t
// of the launch (0 on success); does not synchronise.
int t2o_chain_launch(const float* imgs, const int* slots, const float* params,
                     float* out, int B, int H, int W, int K,
                     int tiles_per_block, int blocks_per_image, int vec,
                     int pixels_per_thread, int smem, void* stream) {
  return launch<false>(imgs, nullptr, slots, params, out, B, H, W, K,
                       tiles_per_block, blocks_per_image, vec,
                       pixels_per_thread, smem, stream);
}

// The masked chain: as t2o_chain_launch, plus mask (B,1,H,W) f32.
int t2o_chain_masked_launch(const float* imgs, const float* mask,
                            const int* slots, const float* params, float* out,
                            int B, int H, int W, int K, int tiles_per_block,
                            int blocks_per_image, int vec,
                            int pixels_per_thread, int smem, void* stream) {
  return launch<true>(imgs, mask, slots, params, out, B, H, W, K,
                      tiles_per_block, blocks_per_image, vec,
                      pixels_per_thread, smem, stream);
}

const char* t2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
