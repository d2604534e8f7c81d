// Operator-chain kernels for Hopper (sm_90a).
//
// chain_kernel<false> replaces t2onet_tpu/ops/pallas_fused.py:_chain_kernel
// (launched there by fused_chain through _run_step). Per image it applies K
// steps of the selected op: slots 0 and 5 write nothing, every other slot
// does out = clip(op(out, p[b, k]), 0, 1). Ops: 1 brightness, 2 contrast,
// 3 saturation, 4 color, 6 tone, 7 sharpness, 8 white.
//
// chain_kernel<true> replaces _masked_chain_kernel, the GIER local-edit
// chain: each executed step blends before the clamp,
// out = clip(op(x)*m + x*(1-m), 0, 1) with x the step's input and m the
// image's (B,1,H,W) mask, in that order of operations (pallas_fused.py
// :249-252); slots 0 and 5 still write nothing. The mask plane sits in
// shared memory beside the image with the same halo: a halo pixel is
// blended at every step, and a later sharpness step reads it. It adds one
// plane read per pixel: 7 planes of traffic against 6, 939 MB at B=128,
// 512x512 (0.28 ms at 3.35 TB/s).
//
// What bounds it. Device memory traffic is 2 * B*3*H*W*4 bytes for the
// whole chain, one read and one write per pixel; against that, each pixel
// takes K steps of ALU work (a division or two, a handful of curve knots).
// At B=128, 512x512, K=5 that is 805 MB, about 0.24 ms at 3.35 TB/s.
//
// What the design does about it. The TPU kernel keeps a whole image in
// VMEM; a Hopper block has at most 227 KB of shared memory, so the image
// is cut into 32x32 output tiles. A block holds its tile plus a halo of
// R pixels on each side in shared memory as three f32 planes, runs all K
// steps there and writes the tile once, so the chain still reads and
// writes each pixel of device memory once (the halo is re-read by
// neighbouring blocks, mostly from L2). Only sharpness reads neighbours,
// and each sharpness step shrinks the region that holds exact values by
// one pixel, so R = the number of sharpness steps in the image's chain
// suffices (at most K, which sizes the shared memory). Halo cells outside
// the image are held at exactly 0 through every step: they are the zero
// padding of the current state that the reference's _shift_zero adds.
// The block loads its image's slots and params itself (the TPU's scalar
// prefetch).
//
// Numerics. The maths follows pallas_fused.py, not the bank: brightness
// with eps 1e-12; saturation in its single-division form with the 2^20
// scaling; contrast with the same sin(pi u)/u polynomial in Estrin form
// (not cospif); min-form curves with csum summed from 1e-10 in knot order.
// Built without --use_fast_math (IEEE division) and with -fmad=false, so
// each multiply and add rounds alone, as in the plain PyTorch version.
// min, max and clamp keep NaN, as jnp.minimum/maximum/clip do.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxParam = 24;
constexpr int kCurveSteps = 8;
constexpr int kSharpSlot = 7;

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

__device__ __forceinline__ float apply_curve(const Curve& c, float x) {
  float out = c.a * x;
  for (int j = 1; j < kCurveSteps; ++j) {
    out = out - c.b[j - 1] * min_(x, j * (1.0f / kCurveSteps));
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

// One pointwise step on the three channels of a pixel, blended into the
// step's input by the mask m when kMasked, then clamped.
template <bool kMasked>
__device__ __forceinline__ void pointwise(int slot, const float* p,
                                          const Curve* curves, float m,
                                          float& r, float& g, float& b) {
  const float x0 = r, x1 = g, x2 = b;
  switch (slot) {
    case 1: {  // brightness
      const float v = max_(max_(r, g), b);
      const float k = clip(v * (1.0f + p[0]), 0.0f, 1.0f) / (v + 1e-12f);
      r = r * k; g = g * k; b = b * k;
      break;
    }
    case 2: {  // contrast
      const float k = contrast_scale(r, g, b, p[0]);
      r = r * k; g = g * k; b = b * k;
      break;
    }
    case 3: {  // saturation, single division scaled by 2^20
      const float S = 1048576.0f;
      const float v = max_(max_(r, g), b);
      const float mn = min_(min_(r, g), b);
      const float d = v - mn;
      const float ve = v + 1e-8f;
      const float num = clip(d * (1.0f + p[0]), 0.0f, ve) * S;
      const float ratio =
          num / (d * S + static_cast<float>(1e-12 * 1048576.0) * ve);
      r = v - ratio * (v - r);
      g = v - ratio * (v - g);
      b = v - ratio * (v - b);
      break;
    }
    case 4:  // color: one curve per channel
      r = apply_curve(curves[0], r);
      g = apply_curve(curves[1], g);
      b = apply_curve(curves[2], b);
      break;
    case 6:  // tone: one curve for all channels
      r = apply_curve(curves[0], r);
      g = apply_curve(curves[0], g);
      b = apply_curve(curves[0], b);
      break;
    case 8:  // white
      r = 1.0f; g = 1.0f; b = 1.0f;
      break;
  }
  if constexpr (kMasked) {
    r = r * m + x0 * (1.0f - m);
    g = g * m + x1 * (1.0f - m);
    b = b * m + x2 * (1.0f - m);
  }
  r = clip(r, 0.0f, 1.0f);
  g = clip(g, 0.0f, 1.0f);
  b = clip(b, 0.0f, 1.0f);
}

// Shared memory: two ping-pong buffers of 3 planes of side x side f32
// (side = kTile + 2K), with kMasked one mask plane, then K*24 params, then
// K slots.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ imgs, const float* __restrict__ mask,
             const int* __restrict__ slots, const float* __restrict__ params,
             float* __restrict__ out, int H, int W, int K) {
  extern __shared__ float smem[];
  const int side_max = kTile + 2 * K;
  const int plane = side_max * side_max;
  float* buf0 = smem;
  float* buf1 = smem + 3 * plane;
  float* sm = smem + 6 * plane;        // the mask plane (kMasked only)
  float* sp = smem + (kMasked ? 7 : 6) * plane;
  int* ss = reinterpret_cast<int*>(sp + K * kMaxParam);

  const int bi = blockIdx.z;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < K * kMaxParam; i += kThreads) {
    sp[i] = params[static_cast<size_t>(bi) * K * kMaxParam + i];
  }
  for (int i = tid; i < K; i += kThreads) {
    int s = slots[static_cast<size_t>(bi) * K + i];
    ss[i] = s < 0 ? 0 : (s > 8 ? 8 : s);  // lax.switch clamps its index
  }
  __syncthreads();

  int R = 0;
  for (int k = 0; k < K; ++k) R += (ss[k] == kSharpSlot);
  const int side = kTile + 2 * R;      // this block's active region
  const int off = K - R;               // its origin inside the planes
  const int gy0 = blockIdx.y * kTile - R;
  const int gx0 = blockIdx.x * kTile - R;
  const size_t hw = static_cast<size_t>(H) * W;
  const float* src = imgs + static_cast<size_t>(bi) * 3 * hw;

  for (int ry = threadIdx.y; ry < side; ry += kBlockY) {
    const int gy = gy0 + ry;
    for (int rx = threadIdx.x; rx < side; rx += kBlockX) {
      const int gx = gx0 + rx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int si = (off + ry) * side_max + off + rx;
      const size_t gi = static_cast<size_t>(gy) * W + gx;
      for (int c = 0; c < 3; ++c) {
        buf0[c * plane + si] = in ? src[c * hw + gi] : 0.0f;
      }
      if constexpr (kMasked) {
        sm[si] = in ? mask[static_cast<size_t>(bi) * hw + gi] : 0.0f;
      }
    }
  }
  __syncthreads();

  float* cur = buf0;
  float* nxt = buf1;
  int sharp_done = 0;
  for (int k = 0; k < K; ++k) {
    const int slot = ss[k];            // uniform across the block
    const float* p = sp + k * kMaxParam;
    if (slot == 0 || slot == 5) continue;
    if (slot == kSharpSlot) {
      // exact values survive at distance >= sharp_done from the region's
      // border; the ring outside is carried over unchanged
      ++sharp_done;
      const float amount = p[0];
      for (int ry = threadIdx.y; ry < side; ry += kBlockY) {
        const int gy = gy0 + ry;
        for (int rx = threadIdx.x; rx < side; rx += kBlockX) {
          const int gx = gx0 + rx;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int dist = min(min(ry, rx), min(side - 1 - ry, side - 1 - rx));
          const int si = (off + ry) * side_max + off + rx;
          for (int c = 0; c < 3; ++c) {
            const float* q = cur + c * plane;
            float v = q[si];
            if (!in) {
              v = 0.0f;
            } else if (dist >= sharp_done) {
              float delta = 4.0f * v;
              delta = delta - q[si - side_max];   // img[y-1, x]
              delta = delta - q[si + side_max];   // img[y+1, x]
              delta = delta - q[si - 1];          // img[y, x-1]
              delta = delta - q[si + 1];          // img[y, x+1]
              float o = v + amount * delta;
              if constexpr (kMasked) {
                const float m = sm[si];
                o = o * m + v * (1.0f - m);
              }
              v = clip(o, 0.0f, 1.0f);
            }
            nxt[c * plane + si] = v;
          }
        }
      }
      float* t = cur;
      cur = nxt;
      nxt = t;
    } else {
      Curve curves[3];
      if (slot == 4) {
        for (int c = 0; c < 3; ++c) curves[c] = make_curve(p + c * kCurveSteps);
      } else if (slot == 6) {
        curves[0] = make_curve(p);
      }
      for (int ry = threadIdx.y; ry < side; ry += kBlockY) {
        const int gy = gy0 + ry;
        for (int rx = threadIdx.x; rx < side; rx += kBlockX) {
          const int gx = gx0 + rx;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
          const int si = (off + ry) * side_max + off + rx;
          float r = cur[si];
          float g = cur[plane + si];
          float b = cur[2 * plane + si];
          pointwise<kMasked>(slot, p, curves, kMasked ? sm[si] : 0.0f, r, g,
                             b);
          cur[si] = r;
          cur[plane + si] = g;
          cur[2 * plane + si] = b;
        }
      }
    }
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(bi) * 3 * hw;
  for (int ty = threadIdx.y; ty < kTile; ty += kBlockY) {
    const int gy = blockIdx.y * kTile + ty;
    if (gy >= H) break;
    const int gx = blockIdx.x * kTile + threadIdx.x;
    if (gx >= W) continue;
    const int si = (off + R + ty) * side_max + off + R + threadIdx.x;
    const size_t gi = static_cast<size_t>(gy) * W + gx;
    for (int c = 0; c < 3; ++c) dst[c * hw + gi] = cur[c * plane + si];
  }
}

size_t smem_bytes(int K, bool masked) {
  const size_t side = kTile + 2 * static_cast<size_t>(K);
  return (masked ? 7 : 6) * side * side * sizeof(float) +
         K * kMaxParam * sizeof(float) + K * sizeof(int);
}

template <bool kMasked>
int launch(const float* imgs, const float* mask, const int* slots,
           const float* params, float* out, int B, int H, int W, int K,
           void* stream) {
  const size_t smem = smem_bytes(K, kMasked);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kBlockX, kBlockY);
  chain_kernel<kMasked>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
          imgs, mask, slots, params, out, H, W, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the chain on `stream`. imgs/out (B,3,H,W) f32, slots (B,K) i32,
// params (B,K,24) f32, all contiguous on the current device. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
int t2o_chain_launch(const float* imgs, const int* slots, const float* params,
                     float* out, int B, int H, int W, int K, void* stream) {
  return launch<false>(imgs, nullptr, slots, params, out, B, H, W, K, stream);
}

// The masked chain: as t2o_chain_launch, plus mask (B,1,H,W) f32.
int t2o_chain_masked_launch(const float* imgs, const float* mask,
                            const int* slots, const float* params, float* out,
                            int B, int H, int W, int K, void* stream) {
  return launch<true>(imgs, mask, slots, params, out, B, H, W, K, stream);
}

const char* t2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
