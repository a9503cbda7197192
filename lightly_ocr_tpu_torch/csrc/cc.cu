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
// memory, so this is block-based union-find (Playne & Hawick 2018;
// Allegretti, Bolelli & Grana 2019), exact for every mask, spirals
// included, in three launches on the caller's stream:
//   1. cc_strip: one block per (image, strip of R full-width rows).  The
//      strip's R * W mask bytes are one contiguous range, copied to shared
//      memory in 16-byte vectors, and union-find runs in shared memory: a
//      warp per row walks its 32-column segments, a ballot gives each
//      segment's foreground word, and each foreground pixel points at the
//      first pixel of its run in the row; runs unite with the runs of the
//      row above once per overlap (shifts and masks of the words give each
//      overlap's first column); each run's first pixel finds its root; and
//      each label is written once, in 16-byte vectors: row0 * W + root, or
//      H * W for the background.
//   2. cc_seams: a warp per (image, seam between two strips, 32 columns):
//      the first column of each overlap across the seam unites the two
//      labels (strip roots) in the label map, through L2; of the lanes that
//      would unite the same two labels, one does.
//   3. cc_flatten: each foreground pixel follows its label to the global
//      root and rewrites it where they differ; the strip root's own entry
//      is shortened on the way.
// Unions hook the larger root under the smaller by compare-and-swap, with
// path halving (ECL-CC, Jaiganesh & Burtscher 2018), so a component's root
// is its minimum index, the label asked for.  R is about kStripPixels / W
// rows (12 at W = 320): each block's phases are bound by the instruction rate
// and latency, so more, shorter strips fill the SMs better than 32-row
// ones, up to where the seams' unions cost more than they save.  The rule
// is reported by cc_geometry and mirrored in ops/cc.py.  Nothing is
// allocated; the label map is the parent array.
// Bound on an H100: the compulsory traffic is the mask read and the labels
// written, 5 bytes a pixel (12.3 MB at b16 480x320, 3.7 us at 3.35 TB/s).
// cc_strip moves exactly that; the seams and the flatten re-read the
// labels, which the 50 MB L2 still holds, and their union and root walks
// are chains of dependent L2 reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripThreads = 512;  // threads of a cc_strip block
constexpr int kStripPixels = 4096;  // pixels of a strip, about: rows = this / W
// shared bytes of a strip block, at most (one row of a very wide map): two
// blocks an SM, (233,472 B of the SM less 1 KB reserved a block) / 2
constexpr int kSmemBudget = 115712;
constexpr int kThreads = 256;  // threads of the seam and flatten blocks

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Shared bytes of a strip: one foreground word per 32-column row segment,
// the mask bytes (placed at the global address's offset mod 16, so that
// 16-byte vectors land aligned), then two int32 arrays: the parents and
// the roots of the runs.
__host__ __device__ constexpr int strip_smem(int rows, int W) {
  return align16(4 * rows * ((W + 31) >> 5)) + align16(rows * W + 15) + 8 * rows * W;
}

// Rows of a strip: about kStripPixels pixels, at least one row; 0 when one
// row does not fit kSmemBudget.
int strip_rows(int W) {
  if (W <= 0) return 0;
  const int R = W < kStripPixels / 2 ? kStripPixels / W : 1;
  return strip_smem(R, W) <= kSmemBudget ? R : 0;
}

// ---- union-find (ECL-CC's hooking and path halving) ----------------------
// A hook links a root under a smaller root by compare-and-swap, so it
// succeeds only while its target is still a root, and every tree's root is
// its minimum.  Path halving stores to nodes that are no longer roots; a
// non-root never becomes a root again and each store moves a pointer to
// one of its ancestors, so the hooks and the halving never undo each other.

__device__ __forceinline__ int find_s(volatile int* L, int x) {
  while (true) {
    const int q = L[x];
    if (q == x) return x;
    const int g = L[q];
    if (g == q) return q;
    L[x] = g;
    x = g;
  }
}

__device__ void unite_s(int* L, int a, int b) {
  while (true) {
    a = find_s(L, a);
    b = find_s(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(L + b, b, a);
    if (old == b) return;
    b = old;
  }
}

// The label map in device memory: loads through L2 (parents written on
// other SMs), stores to L2.
__device__ __forceinline__ int find_g(int* p, int x) {
  while (true) {
    const int q = __ldcg(p + x);
    if (q == x) return x;
    const int g = __ldcg(p + q);
    if (g == q) return q;
    __stcg(p + x, g);
    x = g;
  }
}

__device__ void unite_g(int* p, int a, int b) {
  while (true) {
    a = find_g(p, a);
    b = find_g(p, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(p + b, b, a);
    if (old == b) return;
    b = old;
  }
}

// ---- cc_strip -------------------------------------------------------------

__global__ void __launch_bounds__(kStripThreads)
cc_strip(const uint8_t* __restrict__ fg, int* __restrict__ labels, int H, int W, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = (H + R - 1) / R;
  const int b = blockIdx.x / S;
  const int r0 = (blockIdx.x - b * S) * R;
  const int rows = min(R, H - r0);
  const int n = rows * W;
  const int segs = (W + 31) >> 5;
  const long long off = ((long long)b * H + r0) * W;  // the strip's first pixel
  const uint8_t* g = fg + off;
  const int mo = (int)((uintptr_t)g & 15);
  unsigned* F = reinterpret_cast<unsigned*>(smem);  // F[r * segs + s]: a segment's foreground bits
  unsigned char* mb = smem + align16(4 * rows * segs);
  uint8_t* m = mb + mo;  // m[k]: pixel k's mask byte
  int* L = reinterpret_cast<int*>(mb + align16(n + 15));  // parents
  int* T = L + n;  // T[f]: the root of the run whose first pixel is f

  // the mask: bytes up to the first 16-byte boundary, vectors, the rest
  const int head = min(n, (16 - mo) & 15);
  const int nvec = (n - head) >> 4;
  for (int k = threadIdx.x; k < head; k += blockDim.x) m[k] = g[k];
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    reinterpret_cast<uint4*>(m + head)[v] = __ldg(reinterpret_cast<const uint4*>(g + head) + v);
  for (int k = head + (nvec << 4) + threadIdx.x; k < n; k += blockDim.x) m[k] = g[k];
  __syncthreads();

  // Row runs: a warp per row walks its 32-column segments left to right;
  // a warp ballot gives a segment's foreground word, and each foreground
  // pixel points at the first pixel of its run in the row (the run that
  // reaches a segment's last column is carried into the next segment).
  const int lane = threadIdx.x & 31;
  const int warp0 = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned left_lanes = (1u << lane) - 1;
  for (int r = warp0; r < rows; r += nwarps) {
    int carry = -1;  // first pixel of the run through the previous segment's last column
    for (int s = 0; s < segs; ++s) {
      const int c = s * 32 + lane;
      const int k = r * W + c;
      const bool f = c < W && m[k];
      const unsigned bits = __ballot_sync(0xffffffffu, f);
      if (lane == 0) F[r * segs + s] = bits;
      const unsigned below = ~bits & left_lanes;  // background lanes left of this one
      const int first = below ? k - lane + 32 - __clz(below) : (carry >= 0 ? carry : k - lane);
      if (f) L[k] = first;
      carry = (bits >> 31) ? __shfl_sync(0xffffffffu, first, 31) : -1;
    }
  }
  __syncthreads();

  // Each warp walks the strip's row segments t = r * segs + s, stepping
  // (r, s) without a division.  The foreground words give, with shifts and
  // masks, the pixels that begin a run and those that begin an overlap with
  // a run of the row above (where the left and upper-left pixels are not
  // both foreground).
  const int step_r = nwarps / segs, step_s = nwarps - step_r * segs;
  const int r_first = warp0 / segs, s_first = warp0 - r_first * segs;
  {
    int r = r_first, s = s_first;
    for (int t = warp0; t < rows * segs; t += nwarps) {
      const unsigned cur = F[t];
      if (cur && r > 0) {
        const unsigned up = F[t - segs];
        const unsigned pc = s > 0 ? F[t - 1] >> 31 : 0u;
        const unsigned pu = s > 0 ? F[t - segs - 1] >> 31 : 0u;
        const unsigned overlap = cur & up & ~(((cur << 1) | pc) & ((up << 1) | pu));
        const int k = r * W + s * 32 + lane;
        if ((overlap >> lane) & 1u) unite_s(L, k - W, k);
      }
      r += step_r;
      s += step_s;
      if (s >= segs) {
        s -= segs;
        ++r;
      }
    }
  }
  __syncthreads();

  // Each run's first pixel finds its root, into T: every pointer in L is a
  // run's first pixel (runs hook under runs; path halving stores
  // grandparents), so after this a pixel's root is T[L[k]].
  {
    int r = r_first, s = s_first;
    for (int t = warp0; t < rows * segs; t += nwarps) {
      const unsigned cur = F[t];
      const unsigned pc = s > 0 ? F[t - 1] >> 31 : 0u;
      const unsigned firsts = cur & ~((cur << 1) | pc);
      if ((firsts >> lane) & 1u) {
        const int k = r * W + s * 32 + lane;
        T[k] = find_s(L, k);
      }
      r += step_r;
      s += step_s;
      if (s >= segs) {
        s -= segs;
        ++r;
      }
    }
  }
  __syncthreads();

  // labels out: scalars up to the first 16-byte boundary, int4, the rest
  const int HW = H * W, base = r0 * W;
  int* out = labels + off;
  const int lhead = min(n, (int)(((16 - ((uintptr_t)out & 15)) & 15) >> 2));
  const int nv4 = (n - lhead) >> 2;
  for (int k = threadIdx.x; k < lhead; k += blockDim.x) out[k] = m[k] ? base + T[L[k]] : HW;
  for (int v = threadIdx.x; v < nv4; v += blockDim.x) {
    const int k = lhead + 4 * v;
    int4 o;
    o.x = m[k] ? base + T[L[k]] : HW;
    o.y = m[k + 1] ? base + T[L[k + 1]] : HW;
    o.z = m[k + 2] ? base + T[L[k + 2]] : HW;
    o.w = m[k + 3] ? base + T[L[k + 3]] : HW;
    reinterpret_cast<int4*>(out + lhead)[v] = o;
  }
  for (int k = lhead + (nv4 << 2) + threadIdx.x; k < n; k += blockDim.x)
    out[k] = m[k] ? base + T[L[k]] : HW;
}

// ---- cc_seams -------------------------------------------------------------

__global__ void cc_seams(const uint8_t* __restrict__ fg, int* p, int B, int H, int W, int R) {
  const int seams = (H + R - 1) / R - 1;
  const int segs = (W + 31) >> 5;
  const long long items = (long long)B * seams * segs;
  const int lane = threadIdx.x & 31;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < items;
       w += ((long long)gridDim.x * blockDim.x) >> 5) {
    const long long bs = w / segs;
    const int s = (int)(w - bs * segs);
    const int b = (int)(bs / seams);
    const int r = ((int)(bs - (long long)b * seams) + 1) * R;  // first row below the seam
    const long long img = (long long)b * H * W;
    const uint8_t* m = fg + img;
    const int c = s * 32 + lane;
    const int k = r * W + c;
    const bool pair = c < W && m[k] && m[k - W];
    const unsigned pairs = __ballot_sync(0xffffffffu, pair);
    const int kl = r * W + s * 32 - 1;  // the column left of the segment
    const unsigned left = s > 0 && m[kl] && m[kl - W] ? 1u : 0u;
    const unsigned firsts = pairs & ~((pairs << 1) | left);
    if ((firsts >> lane) & 1u) {
      // the labels across the seam are strip roots (or their ancestors):
      // of the lanes that would unite the same two, the lowest does
      int* pb = p + img;
      const int a = __ldcg(pb + k - W), bl = __ldcg(pb + k);
      const unsigned same = __match_any_sync(firsts, ((unsigned long long)(unsigned)a << 32) | (unsigned)bl);
      if (lane == __ffs(same) - 1) unite_g(pb, a, bl);
    }
  }
}

// ---- the flatten (cc_flatten) -------------------------------------------

// Every value a label takes here is an ancestor of its pixel in the final
// forest, so plain (possibly stale) loads still arrive at the root.  A
// thread's pixels mostly share their label (a strip root): its root is
// found once, and stored into the strip root's own entry too, which
// shortens the walk for the other pixels of that strip component.
__device__ __forceinline__ void settle(int* p, long long i, int g, int HW, long long img,
                                       int& last_g, int& last_root) {
  if (g == HW) return;
  if (g != last_g) {
    int* pb = p + img;
    int x = g, q = pb[x];
    while (q != x) {
      x = q;
      q = pb[x];
    }
    if (x != g && pb[g] != x) pb[g] = x;
    last_g = g;
    last_root = x;
  }
  if (last_root != g) p[i] = last_root;
}

__global__ void cc_flatten(int* p, long long n, int HW) {
  const long long n4 = n >> 2;
  const long long items = n4 + (n & 3);
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < items;
       v += (long long)gridDim.x * blockDim.x) {
    int last_g = -1, last_root = -1;
    if (v < n4) {
      const int4 q = reinterpret_cast<const int4*>(p)[v];
      const long long i = v << 2;
      long long img = i - i % HW;
      const int g[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j - img >= HW) {  // a new image: its labels are another index space
          while (i + j - img >= HW) img += HW;
          last_g = -1;
        }
        settle(p, i + j, g[j], HW, img, last_g, last_root);
      }
    } else {
      const long long i = (n4 << 2) + (v - n4);
      settle(p, i, p[i], HW, i - i % HW, last_g, last_root);
    }
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

// out[0..4] = rows of a strip for width W (0: W does not fit), its shared
// bytes, threads of a strip block, kStripPixels, kSmemBudget.
extern "C" int cc_geometry(int W, int* out) {
  const int R = strip_rows(W);
  out[0] = R;
  out[1] = R > 0 ? strip_smem(R, W) : 0;
  out[2] = kStripThreads;
  out[3] = kStripPixels;
  out[4] = kSmemBudget;
  return cudaSuccess;
}

// The first `phases` launches of the labelling (3 = all of it; fewer only to
// time the launches one by one).  fg: [B, H, W] uint8 (0/1); labels:
// [B, H, W] int32, 16-byte aligned.  Runs on `stream`; returns the first
// launch error (0 = cudaSuccess).
extern "C" int cc_phases(const void* fg, void* labels, int B, int H, int W, int phases,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = strip_rows(W);
  if (R == 0 || B <= 0 || H <= 0 || ((uintptr_t)labels & 15)) return cudaErrorInvalidValue;
  const uint8_t* m = static_cast<const uint8_t*>(fg);
  int* p = static_cast<int*>(labels);
  const int S = (H + R - 1) / R;
  const int smem = strip_smem(R < H ? R : H, W);
  cudaError_t err = cudaFuncSetAttribute(cc_strip, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cc_strip<<<B * S, kStripThreads, smem, s>>>(m, p, H, W, R);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  if (phases >= 2) {
    const long long lanes = (long long)B * (S - 1) * ((W + 31) / 32) * 32;
    cc_seams<<<grid_for(lanes), kThreads, 0, s>>>(m, p, B, H, W, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases >= 3) {
    const long long n = (long long)B * H * W;
    cc_flatten<<<grid_for((n >> 2) + (n & 3)), kThreads, 0, s>>>(p, n, H * W);
    err = cudaGetLastError();
  }
  return err;
}

extern "C" int cc_launch(const void* fg, void* labels, int B, int H, int W, void* stream) {
  return cc_phases(fg, labels, B, H, W, 3, stream);
}
