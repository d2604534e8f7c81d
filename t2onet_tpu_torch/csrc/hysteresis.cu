// Canny's hysteresis for Hopper (sm_90a): the weak pixels 4-connected to a
// strong one, per image of a (B, H, W) batch.
//
// It replaces no TPU kernel: the JAX package runs canny on the host
// (scipy.ndimage.label over the weak pixels, then the components that
// hold a strong pixel). EdgeConnect's trainer needs the edge map of every
// image of every batch, and on the host that paces the step; on the card
// the rest of canny is tensor arithmetic (models/edgeconnect.py:
// edge_maps), and only the connected components need a kernel, since a
// flood fill's number of rounds depends on the image and reading it back
// would stall the step.
//
// The components come from union-find over a label per pixel
// (Allegretti, Bolelli and Grana's "UF", after Playne and Hawick), in four
// launches that need no round trip to the host:
// - init: a weak pixel's label is its own flat index, any other's -1;
// - merge: each weak pixel unites its set with its left and upper weak
//   neighbours', linking the larger root under the smaller with atomicMin
//   and retrying while another thread moved the root. Labels only fall
//   and always point at a pixel of the same set, so a find that reads a
//   stale label still reaches the root; when the launch ends every set is
//   one tree whose root is its smallest index, whatever the order;
// - mark: each strong pixel writes 1 at its root in `out`;
// - spread: each weak pixel takes its root's mark. A root only ever
//   writes its own mark back, so the reads of marks and the writes to
//   other pixels do not race.
// `out` is zeroed first (cudaMemsetAsync), so a pixel that is not weak
// ends at 0. No set spans two images: a pixel unites only with neighbours
// of its own image.
//
// What bounds it: bytes. Per pixel the kernel needs one byte of classes
// (0 none, 1 weak, 2 strong) read and one byte of edges written; the
// labels are scratch (4 bytes a pixel, written, then read by the finds).
// The finds' pointer chasing on thin edge curves is short, and most
// pixels are neither weak nor strong and return at once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Reads go to L2 (__ldcg): during the merge other blocks, on other
// multiprocessors, lower the labels with atomics that L1 does not see.
__device__ __forceinline__ int find_root(const int* labels, int i) {
  int p = __ldcg(labels + i);
  while (p != i) {
    i = p;
    p = __ldcg(labels + i);
  }
  return i;
}

__device__ __forceinline__ void unite(int* labels, int a, int b) {
  bool done = false;
  while (!done) {
    a = find_root(labels, a);
    b = find_root(labels, b);
    if (a < b) {
      int old = atomicMin(labels + b, a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      int old = atomicMin(labels + a, b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hysteresis_init(const unsigned char* cls, int* labels, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) labels[i] = cls[i] ? i : -1;
}

__global__ void __launch_bounds__(kThreads)
hysteresis_merge(const unsigned char* cls, int* labels, int n, int H, int W) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !cls[i]) return;
  int x = i % W;
  int y = (i / W) % H;
  if (x > 0 && cls[i - 1]) unite(labels, i, i - 1);
  if (y > 0 && cls[i - W]) unite(labels, i, i - W);
}

__global__ void __launch_bounds__(kThreads)
hysteresis_mark(const unsigned char* cls, const int* labels,
                unsigned char* out, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n && cls[i] == 2) out[find_root(labels, i)] = 1;
}

__global__ void __launch_bounds__(kThreads)
hysteresis_spread(const unsigned char* cls, const int* labels,
                  unsigned char* out, int n) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n && cls[i]) out[i] = out[find_root(labels, i)];
}

}  // namespace

extern "C" {

// Launch the four kernels on `stream`. cls (B,H,W) u8 (0 none, 1 weak,
// 2 strong), labels (B,H,W) i32 scratch, out (B,H,W) u8, contiguous on the
// current device, B*H*W < 2^31. Returns the first cudaError_t (0 on
// success); does not synchronise.
int t2o_hysteresis_launch(const unsigned char* cls, int* labels,
                          unsigned char* out, int B, int H, int W,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n = B * H * W;
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  hysteresis_init<<<blocks, kThreads, 0, s>>>(cls, labels, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hysteresis_merge<<<blocks, kThreads, 0, s>>>(cls, labels, n, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hysteresis_mark<<<blocks, kThreads, 0, s>>>(cls, labels, out, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hysteresis_spread<<<blocks, kThreads, 0, s>>>(cls, labels, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* t2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
