// Exact 4-connected component labelling for Hopper (sm_90a).
//
// Replaces lightly_ocr_tpu/ops/pallas_cc.py::_cc_kernel (the TPU kernel
// behind label_components_pallas / label_components_checked).  Input: a
// [B, H, W] bool mask (1 byte per pixel).  Output: int32 labels of the same
// shape; each foreground pixel gets the MINIMUM linear index (r * W + c,
// within its image) of its component, background gets H * W.
//
// The TPU kernel keeps the whole map on chip and runs a bounded number of
// directional min-scan rounds, escalating to XLA when they do not converge.
// A 480x320 int32 map (600 KB) does not fit in an SM's 227 KB of shared
// memory, so this is a GPU algorithm instead: union-find in global memory
// (Playne & Hawick 2018), which is exact for every mask, spirals included.
//   1. init:  p[i] = i for foreground, H * W for background;
//   2. merge: every foreground pixel unions itself with its left and upper
//      foreground neighbours; a union links the larger root under the
//      smaller with atomicMin, so a component's minimum index stays a root
//      and ends as the root of the whole component;
//   3. flatten: pointer jumping p[i] = p[p[i]], ceil(log2(H * W)) + 1
//      passes, which reaches the root from any depth of the forest.
// Bound on an H100: the compulsory traffic is the mask read and the labels
// written, 5 bytes a pixel (12 MB at b16 480x320, ~4 us at 3.35 TB/s); the
// kernels move several times that (the union walks and the flatten passes
// re-read the labels), which is what a faster version would cut.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* p, int x) {
  // L2-coherent reads: parents written by atomics on other SMs.
  int q = __ldcg(p + x);
  while (q != x) {
    x = q;
    q = __ldcg(p + x);
  }
  return x;
}

__device__ void unite(int* p, int a, int b) {
  bool done = false;
  while (!done) {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a < b) {
      const int old = atomicMin(p + b, a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      const int old = atomicMin(p + a, b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  }
}

__global__ void cc_init(const uint8_t* __restrict__ fg, int* __restrict__ p,
                        long long n, int HW) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    p[i] = fg[i] ? (int)(i % HW) : HW;
  }
}

__global__ void cc_merge(const uint8_t* __restrict__ fg, int* p, long long n,
                         int H, int W) {
  const int HW = H * W;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!fg[i]) continue;
    const int li = (int)(i % HW);
    int* pb = p + (i - li);
    const int c = li % W;
    if (c > 0 && fg[i - 1]) unite(pb, li, li - 1);
    if (li >= W && fg[i - W]) unite(pb, li, li - W);
  }
}

__global__ void cc_jump(const uint8_t* __restrict__ fg, int* p, long long n,
                        int HW) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (!fg[i]) continue;
    int* pb = p + (i - i % HW);
    const int q = __ldcg(p + i);
    p[i] = __ldcg(pb + q);
  }
}

int grid_for(long long items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (items + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 16;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

// fg: [B, H, W] uint8 (0/1); labels: [B, H, W] int32 output.  Runs on
// `stream`; returns the first launch error (0 = cudaSuccess).
extern "C" int cc_launch(const void* fg, void* labels, int B, int H, int W,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)B * H * W;
  const int HW = H * W;
  const uint8_t* m = static_cast<const uint8_t*>(fg);
  int* p = static_cast<int*>(labels);
  const int grid = grid_for(n);
  cc_init<<<grid, kThreads, 0, s>>>(m, p, n, HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc_merge<<<grid, kThreads, 0, s>>>(m, p, n, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int passes = 1;
  while ((1LL << (passes - 1)) < HW) ++passes;  // ceil(log2(HW)) + 1
  for (int k = 0; k < passes; ++k) {
    cc_jump<<<grid, kThreads, 0, s>>>(m, p, n, HW);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
