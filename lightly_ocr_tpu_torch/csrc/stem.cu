// conv1_2 (+ 2x2 pool) (+ conv2_1) detector front for Hopper (sm_90a).
//
// Replaces four TPU kernels of lightly_ocr_tpu/ops/pallas_stem.py:
//   _stem_kernel              (#4, pallas_stem.py:46)  conv1_2 + BN + ReLU at full resolution
//   _conv_pool_kernel         (#5, pallas_stem.py:255) conv1_2 + BN + ReLU + 2x2 max pool
//   _conv_pool_conv_kernel    (#6, pallas_stem.py:430) #5, then conv2_1 + BN + ReLU
//   _conv_pool_conv_q_kernel  (#7, pallas_stem.py:597) the w8a8 form of #6
// All four start with the same 3x3 64->64 convolution (VGG conv1_2) on the
// conv1_1 activation x0 [B, H, W, 64] NHWC.  #5-#7 never write its full-
// resolution output to device memory (1.26 GB of bf16 at b16 960x640): the
// 2x2 pool runs in the epilogue and only the pooled map [B, H/2, W/2, 64] is
// stored.  #4 is the same conv without the pool and writes that full-
// resolution map, which the trunk pools.  BN is folded into the weights by
// ops/stem.py.  bf16 rounding follows the TPU kernels: bf16 operands, f32
// sums, + f32 bias, ReLU, pool in f32, one cast; only the order of the f32
// sums differs from the plain versions.
//
// One kernel, conv3x3_hopper, does every convolution, in two element types:
// bf16 x bf16 -> f32 (#4, #5, #6) and s8 x s8 -> s32 (#7).
// - Bound on an H100 at b16 960x640 (conv1_2 0.72 TFLOP, conv2_1 0.36
//   TFLOP): #4 moves 2.5 GB (x0 in, the full-resolution map out), 0.75 ms
//   at 3.35 TB/s against 0.73 ms of bf16 operations, so it is bound by
//   bytes and needs its copies, products and stores overlapped; #5 is
//   bound by operations (0.73 ms), #6 too (1.10 ms at 989 TFLOP/s); #7's
//   int8 operations take 0.55 ms at 1,979 TOP/s, under its bytes (below).
// - Geometry: a block owns one sample, a strip of kStrip output columns and
//   a segment of output rows (conv1_2: 128 x 120, int8 128 x 60; bf16
//   conv2_1: 64 x 60; int8 conv2_1: 64 x one requant block, below), and
//   walks the segment two rows a step.  Its input rows live in a ring of
//   kRing = 8 rows of kStrip + 2 pixels (the 1-column halo each side), so
//   every input row is read once per strip; a segment re-reads one row
//   above and one below.  Rows and columns outside the image are
//   zero-filled by the copies (SAME padding).  The grid is persistent, one block an SM (two for the int8
//   conv1_2, whose 109 KB allow it: one block's epilogue then runs under
//   the other's products), walking B x ceil(W / kStrip) x segments items
//   (640 for the bf16 conv1_2 and conv2_1 at b16 960x640, 1,280 for the
//   int8 conv1_2, 2,400 for the int8 conv2_1), so the weights are loaded
//   once per block.
// - Copies: cp.async with the zero-fill source size, two steps (4 rows)
//   ahead of the products, one block barrier a step.  TMA would give the zero
//   fill too, but its swizzles key a 16-byte chunk by the pixel's address,
//   and the pool's A rows are every second pixel (below), which they map
//   onto 4 bank groups; cp.async writes the ring with its own key (ring_off),
//   which keeps every ldmatrix conflict-free, and needs no tensor map
//   (cuTensorMapEncodeTiled lives in libcuda, which the library does not
//   link).
// - Products: wgmma with A from registers and B from shared memory;
//   m64nNk16 bf16 -> f32, or m64nNk32 s8 -> s32.  The weights [576][COUT]
//   are written once per block as K-major tiles [COUT][128 B] in the
//   128-byte swizzle (bf16: one tap a tile, 9 tiles; s8: two taps a tile, 5
//   tiles, the last half used) and read through a matrix descriptor
//   advanced 32 B a K step (a tap is 4 k16 steps in bf16, 2 k32 steps in
//   s8).  A is loaded with ldmatrix.x4 of b16 from the ring: one 16-byte row
//   address per lane, so tap (dy, dx) is only another base address
//   (wgmma's shared-memory A layout breaks under a one-pixel shift); on
//   byte rows the same instruction gives the s8 m16 x k32 fragment, which
//   has the bf16 m16 x k16 fragment's byte layout.  Each of the two
//   warpgroups of a block holds 64 accumulators a thread: conv1_2, 2 rows x
//   64 columns x 64 channels (two m64n64 tiles, rows R and R + 1 of the
//   same columns); conv2_1, 1 row x 64 columns x 128 channels (one m64n128
//   tile, warpgroup w takes row R + w).  A is loaded once per input row and
//   column shift dx, and feeds every tile that row reaches (conv1_2: input
//   rows R and R + 1 feed both output rows, so a step loads 12 A units, not
//   18); each tile still sums its taps in ascending order.  A unit's
//   products are one commit group, its A fragments are double-buffered in
//   registers, and the next unit's ldmatrix overlaps them.
// - Ring layout: a pixel is 128 bytes (64 bf16) or 64 (64 s8).  Its 16-byte
//   chunks sit in 128-byte units (one bf16 pixel, or an s8 pixel pair, the
//   odd pixel in chunks 4-7) permuted by the key (pixel / 2) % 8, so the 8
//   rows of one ldmatrix phase, pixels at a stride of 2 (or 1), hit 8
//   distinct 16-byte bank groups in either type.
// - Pixel order: A row i of a warp's m16 slice is pixel 2i (i < 8) or
//   2(i - 8) + 1 of its 16 columns, so accumulator rows g and g + 8 of a
//   thread are horizontal neighbours, and with the two rows of the step in
//   the same thread the 2x2 max needs no shuffle.
// - Epilogue in registers: bias (int8: the dequant FMA first), ReLU (and
//   the pool) in f32 on the accumulators, then a bf16 cast, a 4x4 transpose
//   of 32-bit words across each quad of lanes and 16-byte stores (8
//   channels of one pixel a lane), or the int8 conv1_2's f32 pooled map in
//   8-byte stores (a quad writes 32 whole bytes).
// - Shared memory (1,024 B of alignment slack + weights + bias [+ int8
//   weight scales] + ring [+ staging]):
//     bf16 conv1_2  1,024 +  73,728 + 256       + 133,120 (8 x 130 x 128)            = 208,128
//     bf16 conv2_1  1,024 + 147,456 + 512       +  67,584 (8 x 66 x 128)             = 216,576
//     s8 conv1_2    1,024 +  40,960 + 256 + 256 +  66,560 (8 x 130 x 64)             = 109,056
//     s8 conv2_1    1,024 +  81,920 + 512 + 512 +  33,792 (8 x 66 x 64) + 67,584 (4 x 66 x 256 f32)
//                                                                                    = 185,344
//   of the 232,448 a block may have.  Registers: 64 accumulators, 32 (bf16)
//   or 16 (s8) A registers.
// - #6 is two launches: conv12_pool_bf16 (#5 itself) writes the bf16
//   pooled map (rounded as the plain version rounds it, 0.63 GB of round
//   trip, ~0.19 ms, under #6's 1.10 ms operations bound), and conv21_bf16
//   reads it with a zero SAME ring.  Both weight sets together (221 KB)
//   would leave no room for a ring, so the pooled map is not kept on chip.
//
// #7, the w8a8 chain, is four launches:
//   sample_amax_bf16  amax[b] = max |x0| over sample b (reads x0);
//   quantize_bf16     sx = max(amax, 1e-12) * (1/127), xq = clip(rint(x0 /
//                     sx), -127, 127) (reads x0 again, writes xq: the amax
//                     must be whole before the first code is known), each
//                     code from x0 * (1 / sx), rounded by adding 1.5 * 2^23,
//                     with the true division only where that product lies
//                     near a half-integer (code_div: the same codes as
//                     __fdiv_rn everywhere, in 0.63 ms against 1.06 at b16
//                     960x640 on an H100).  Quantizing x0 in conv1_2's ring
//                     instead, which saves the xq round trip, measured 1.9
//                     ms for that one launch against 0.63 + 0.84 for these
//                     two: the per-value work stalls the products;
//   conv12_pool_s8    conv3x3_hopper on xq: relu(fma(acc, sx * sw1, b1)),
//                     the 2x2 max in f32, the f32 pooled map out, and each
//                     pooled row's max (a ReLU output, so >= 0, and non-
//                     negative floats order as their bits) into rowmax
//                     [B, H/2] by an integer atomicMax: no pass reads the
//                     f32 map only to take the requant scales;
//   conv21_s8         conv3x3_hopper on the f32 pooled map, one work item a
//                     requant block of r2 = rows / 2 pooled rows (the TPU
//                     kernel's row block, pallas_stem.py:641-651): s2 =
//                     max(rowmax over the block's rows and one halo row each
//                     side, 1e-12) / 127, a true division; the block's r2 + 2
//                     f32 rows are copied by cp.async into a staging ring and
//                     quantized once, each by the thread that copied it, with
//                     that block's s2 (a multiply by its correctly rounded
//                     reciprocal, then the clip and rint) into the int8
//                     ring, one step ahead of the products; then
//                     relu(fma(acc, s2 * sw2, b2)) -> bf16.  A halo row is
//                     quantized with the reading block's s2, as the TPU
//                     kernel quantizes its slab.
// Bytes of #7 at b16 960x640: x0 twice (2.52 GB), xq out and in (1.26 GB),
// the f32 pooled map out and in (1.26 GB, + 2/16 for the halo rows), the
// output (0.63 GB).  The int8 epilogues round as XLA runs the JAX kernel:
// y * (s * sw) + b is one FMA (__fmaf_rn after __fmul_rn(s, sw)), the
// requant multiplies by the correctly rounded reciprocal of s2 and rounds
// half to even, and sx = max(amax, 1e-12) / 127 is a multiply by the float
// constant 1/127 (XLA's rewrite of a division by a constant in the jitted
// wrapper; s2, taken in the TPU kernel, is a true division); so #7 matches
// its plain PyTorch version (ops/stem.py) bit for bit: every int8 product
// and int32 sum is exact, in any order.
//
// The geometry is exported by stem_geometry() and checked by ops/stem.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kRcp127 = 1.0f / 127.0f;  // correctly rounded float, as XLA folds it
constexpr float kMagic = 12582912.f;      // 1.5 * 2^23

// clip(rint(v), -127, 127) as the low byte: adding 1.5 * 2^23 rounds the
// clipped value to an integer, half to even, in the low mantissa bits
__device__ __forceinline__ uint32_t code(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, -127.f), 127.f), kMagic)) & 0xFFu;
}

// code(x / s) for x / s a correctly rounded division, from c = x * rs (rs =
// 1 / s correctly rounded): |c - x / s| < 1.5 * 2^-23 |x / s| <= 2.3e-5 where
// it is not clipped, so rint of c and of the rounded quotient differ only
// when c lies within that of a half-integer; there the division decides.
__device__ __forceinline__ uint32_t code_div(float x, float s, float rs) {
  const float c = fminf(fmaxf(__fmul_rn(x, rs), -127.f), 127.f);
  const float t = __fadd_rn(c, kMagic);
  if (fabsf(__fsub_rn(c, __fsub_rn(t, kMagic))) < 0.49993896484375f)  // 0.5 - 2^-14
    return __float_as_uint(t) & 0xFFu;
  return code(__fdiv_rn(x, s));
}

// amax[b] = max |x| over sample b of x bf16 [B, n] (n % 8 == 0); amax is
// zeroed by the launcher.  Non-negative floats order as their bit patterns,
// so an integer atomicMax combines the blocks.
__global__ void __launch_bounds__(256)
sample_amax_kernel(const bf16* __restrict__ x, float* __restrict__ amax, long long n) {
  const int b = blockIdx.y;
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)b * n);
  float m = 0.f;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n / 8;
       k += (long long)gridDim.x * blockDim.x) {
    const uint4 raw = p[k];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float red[8];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
    atomicMax(reinterpret_cast<int*>(amax + b), __float_as_int(m));
  }
}

// sx[b] = max(amax[b], 1e-12) * (1/127); xq = clip(round(x / sx), -127, 127),
// a true division rounded half to even (QuantConv's convention; code_div).
__global__ void __launch_bounds__(256)
quantize_kernel(const bf16* __restrict__ x, const float* __restrict__ amax,
                signed char* __restrict__ xq, float* __restrict__ sx, long long n) {
  const int b = blockIdx.y;
  const float s = __fmul_rn(fmaxf(amax[b], 1e-12f), kRcp127), rs = __frcp_rn(s);
  if (blockIdx.x == 0 && threadIdx.x == 0) sx[b] = s;
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)b * n);
  uint2* q = reinterpret_cast<uint2*>(xq + (size_t)b * n);
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n / 8;
       k += (long long)gridDim.x * blockDim.x) {
    const uint4 raw = p[k];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint32_t c[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 f0 = __bfloat1622float2(h[2 * e]), f1 = __bfloat1622float2(h[2 * e + 1]);
      c[e] = code_div(f0.x, s, rs) | (code_div(f0.y, s, rs) << 8) | (code_div(f1.x, s, rs) << 16) |
             (code_div(f1.y, s, rs) << 24);
    }
    q[k] = make_uint2(c[0], c[1]);
  }
}

dim3 sample_grid(int B, long long n) {
  const long long chunks = (n / 8 + 255) / 256;
  return dim3((unsigned)(chunks < 512 ? chunks : 512), B);
}

}  // namespace

// ---- conv3x3_hopper ---------------------------------------------------------

namespace hop {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRing = 8;       // ring rows: 4 in use, 2 steps of 2 in flight
constexpr int kHalo = 1;       // halo columns each side, rows above and below
constexpr int kStage = 4;      // f32 staging rows of the int8 conv2_1: 2 steps of 2

// S8: int8 operands.  The int8 conv2_1 (kQuant) quantizes its f32 input
// rows in shared memory; every other instantiation copies its ring rows as
// they are in device memory.
template <int COUT, bool S8>
struct HGeo {
  static constexpr bool kC12 = COUT == 64;
  static constexpr bool kQuant = S8 && !kC12;
  static constexpr int kStrip = kC12 ? 128 : 64;  // output columns of a block
  // output rows of a segment (even; int8 conv2_1: r2).  The int8 conv1_2
  // runs kBlocks = 2 blocks an SM (one's epilogue under the other's
  // products), so its segments are half as long to spread the items evenly.
  static constexpr int kBlocks = S8 && kC12 ? 2 : 1;
  static constexpr int kSeg = kC12 ? 120 / kBlocks : 60;
  static constexpr int kMT = kC12 ? 2 : 1;        // m64 tiles of a warpgroup a step
  static constexpr int kRingPix = kStrip + 2 * kHalo;
  static constexpr int kPixBytes = S8 ? 64 : 128;     // 64 channels
  static constexpr int kChunkLog = S8 ? 2 : 3;        // 16-byte chunks a pixel: 1 << kChunkLog
  static constexpr int kRowBytes = kRingPix * kPixBytes;
  static constexpr int kKSteps = S8 ? 2 : 4;          // 32-byte K steps a tap
  static constexpr int kTapK = S8 ? 64 : 128;         // K bytes a tap
  static constexpr int kTileBytes = COUT * 128;       // [COUT][128 B], K-major
  static constexpr int kTiles = (9 * kTapK + 127) / 128;
  static constexpr int kBias = kTiles * kTileBytes;
  static constexpr int kSw = kBias + COUT * 4;        // int8 weight scales
  static constexpr int kRingOff = kSw + (S8 ? COUT * 4 : 0);
  static constexpr int kStageOff = kRingOff + kRing * kRowBytes;
  static constexpr int kStageRow = kRingPix * 64 * 4;  // f32 pixels
  static constexpr int kSmem = 1024 + kStageOff + (kQuant ? kStage * kStageRow : 0);  // + alignment slack
  // step rows R, R + 1: conv1_2 warpgroup w takes both rows of columns
  // [64 w, 64 w + 64); conv2_1 warpgroup w takes row R + w, all 64 columns
  __device__ static int tile_row(int wg, int t) { return kC12 ? t : wg; }
  __device__ static int tile_col(int wg) { return kC12 ? 64 * wg : 0; }
};
static_assert(HGeo<64, false>::kSmem == 208128 && HGeo<128, false>::kSmem == 216576 &&
                  HGeo<64, true>::kSmem == 109056 && HGeo<128, true>::kSmem == 185344,
              "budget in the note");
static_assert(HGeo<128, false>::kSmem <= 232448 && HGeo<128, true>::kSmem <= 232448 &&
                  2 * (HGeo<64, true>::kSmem + 1024) <= 233472,
              "shared memory: a block, and two int8 conv1_2 blocks (with 1 KB reserved each) an SM");
static_assert(HGeo<64, false>::kRingOff % 16 == 0 && HGeo<128, false>::kRingOff % 16 == 0 &&
                  HGeo<64, true>::kRingOff % 16 == 0 && HGeo<128, true>::kStageOff % 16 == 0,
              "ring alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !in (the source is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NA>
__device__ __forceinline__ void fence_acc(int (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define HOP_D32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOP_D64 HOP_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
                "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOP_A8(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
                     C(d[i + 6]), C(d[i + 7])
#define HOP_A32(C) HOP_A8(C, 0), HOP_A8(C, 8), HOP_A8(C, 16), HOP_A8(C, 24)
#define HOP_A64(C) HOP_A32(C), HOP_A8(C, 32), HOP_A8(C, 40), HOP_A8(C, 48), HOP_A8(C, 56)

// d += A (registers, m64 x k16 bf16 or k32 s8) x B (descriptor); f32 or s32
// sums.  The overload is picked by the accumulator array.
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOP_D32
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
               : HOP_A32("+f")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOP_D64
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : HOP_A64("+f")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// the integer forms take no scale or transpose immediates
__device__ __forceinline__ void wgmma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" HOP_D32
               "}, {%32, %33, %34, %35}, %36, p;\n}\n"
               : HOP_A32("+r")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" HOP_D64
               "}, {%64, %65, %66, %67}, %68, p;\n}\n"
               : HOP_A64("+r")
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Lane q of a quad holds a[j] = the word j of its row; afterwards a[k] =
// lane k's word q (a 4x4 transpose across the quad, two shuffle rounds).
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  uint32_t x0 = __shfl_xor_sync(0xffffffffu, hi ? a[0] : a[2], 2);
  uint32_t x1 = __shfl_xor_sync(0xffffffffu, hi ? a[1] : a[3], 2);
  if (hi) { a[0] = x0; a[1] = x1; } else { a[2] = x0; a[3] = x1; }
  x0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[1], 1);
  x1 = __shfl_xor_sync(0xffffffffu, odd ? a[2] : a[3], 1);
  if (odd) { a[0] = x0; a[2] = x1; } else { a[1] = x0; a[3] = x1; }
}

// Byte offset of pixel p's 16-byte chunk c in a ring row.  A 128-byte unit
// holds one bf16 pixel (chunks 0-7) or an s8 pixel pair (the odd pixel in
// chunks 4-7); chunks are permuted by (p / 2) % 8, so 8 pixels at a stride
// of 1 or 2 hit 8 distinct bank groups.
template <bool S8>
__device__ __forceinline__ uint32_t ring_off(int p, int c) {
  const int unit = S8 ? p >> 1 : p, slot = S8 ? ((p & 1) << 2) | c : c;
  return (uint32_t)(unit * 128 + (((slot ^ (p >> 1)) & 7) << 4));
}

// relu(conv3x3(x) + bias) (POOL: then the 2x2 max), SAME padding:
// x [B, H, W, 64], w [576, COUT] (k = tap * 64 + cin), bias [COUT] f32, rows
// cut into segments of `seg`.
//   bf16: x, w bf16 -> out bf16 [B, H, W, COUT] or, POOL (COUT 64, H even,
//     W % 16 == 0), [B, H/2, W/2, 64].
//   s8 POOL (conv1_2): x = xq int8, w int8, sw [64], scale = sx [B] ->
//     relu(fma(acc, sx * sw, bias)) pooled, out f32 [B, H/2, W/2, 64], and
//     atomicMax of each pooled row's max into rowmax [B, H/2] (zeroed).
//   s8 !POOL (conv2_1): x = the f32 pooled map [B, H, W, 64], w int8, sw
//     [128], rowmax [B, H] from conv1_2; seg = r2 (H % r2 == 0): segment i
//     is requant block i, quantized with its s2 -> relu(fma(acc, s2 * sw,
//     bias)), out bf16 [B, H, W, 128].
template <int COUT, bool POOL, bool S8>
__global__ void __launch_bounds__(kThreads, HGeo<COUT, S8>::kBlocks)
conv3x3_hopper(const void* __restrict__ x, const void* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ sw,
               const float* __restrict__ scale, float* __restrict__ rowmax,
               void* __restrict__ out, int B, int H, int W, int seg, int nstrip, int nseg) {
  typedef HGeo<COUT, S8> G;
  typedef typename std::conditional<S8, int, float>::type Acc;
  constexpr int MT = G::kMT, NA = COUT / 2, KS = G::kKSteps;
  constexpr bool QUANT = G::kQuant;
  static_assert(!POOL || COUT == 64, "the pool pairs the two rows of a warpgroup");
  static_assert(!S8 || POOL != QUANT, "int8: conv1_2 pools, conv2_1 requantizes");
  extern __shared__ __align__(1024) unsigned char hsmem[];
  unsigned char* smem = hsmem + ((1024 - (smem_u32(hsmem) & 1023)) & 1023);
  const uint32_t s_w = smem_u32(smem);
  const uint32_t s_ring = s_w + G::kRingOff;
  const float* s_bias = reinterpret_cast<const float*>(smem + G::kBias);
  const float* s_sw = reinterpret_cast<const float*>(smem + G::kSw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, q = lane & 3;

  // weights -> K-major tiles [COUT][128 B], 8-row atoms of 1,024 B, chunk c
  // of row n at c ^ (n % 8): wgmma's 128-byte swizzle.  K chunk kc of 16
  // bytes (8 bf16 or 16 s8 values of K) goes to tile kc / 8, chunk kc % 8.
  {
    constexpr int EPC = S8 ? 16 : 8;  // K values a chunk
    for (int i = tid; i < (576 / EPC) * COUT; i += kThreads) {
      const int n = i % COUT, kc = i / COUT, c = kc & 7;
      uint32_t v[4];
      if constexpr (S8) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(w) + (size_t)kc * 16 * COUT + n;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (uint32_t)src[4 * e * COUT] | ((uint32_t)src[(4 * e + 1) * COUT] << 8) |
                 ((uint32_t)src[(4 * e + 2) * COUT] << 16) | ((uint32_t)src[(4 * e + 3) * COUT] << 24);
      } else {
        const unsigned short* src = reinterpret_cast<const unsigned short*>(w) + (size_t)kc * 8 * COUT + n;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (uint32_t)src[2 * e * COUT] | ((uint32_t)src[(2 * e + 1) * COUT] << 16);
      }
      *reinterpret_cast<uint4*>(smem + (kc >> 3) * G::kTileBytes + (n >> 3) * 1024 + (n & 7) * 128 +
                                ((c ^ (n & 7)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  for (int i = tid; i < COUT; i += kThreads) {
    reinterpret_cast<float*>(smem + G::kBias)[i] = bias[i];
    if constexpr (S8) reinterpret_cast<float*>(smem + G::kSw)[i] = sw[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma

  // B descriptor: start >> 4, leading offset 16 B (unused when swizzled),
  // stride 1,024 B between 8-row atoms, 128-byte swizzle
  const uint64_t desc0 = (uint64_t)((s_w & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
                         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
  // ldmatrix lane: A row (lane & 15) is pixel 2i or 2i + 1 of the warp's 16
  // columns; lanes 16-31 address the upper 16 bytes of a 32-byte K step
  const int px = 2 * (lane & 7) + ((lane >> 3) & 1), khalf = lane >> 4;
  const int rp0 = G::tile_col(wg) + 16 * wi + px;  // ring pixel of this lane's A row at dx = 0

  const long long items = (long long)B * nstrip * nseg;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int iseg = (int)(it % nseg);
    const long long rest = it / nseg;
    const int strip = (int)(rest % nstrip), b = (int)(rest / nstrip);
    const int c0 = strip * G::kStrip, s0 = iseg * seg, s1 = min(s0 + seg, H);
    const int nsteps = (s1 - s0 + 1) / 2;
    // ring slot of input row r: (r - base) % 8; the int8 conv2_1 numbers
    // its rows from the block's first halo row
    const int base = QUANT ? s0 - 1 : -1;
    float sq = 0.f, rcp = 0.f;  // the item's dequant scale (sx or s2), and 1 / s2
    if constexpr (S8 && POOL) sq = scale[b];
    if constexpr (QUANT) {  // the block's scale from the pooled rows' maxima
      float m = 0.f;
      for (int r = max(s0 - 1, 0); r < min(s1 + 1, H); ++r) m = fmaxf(m, rowmax[(size_t)b * H + r]);
      sq = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
      rcp = __frcp_rn(sq);
    }
    // input rows [r, r + n) -> their ring slots, zeros outside the image
    auto load_rows = [&](int r, int n) {
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
      for (int i = tid; i < (n * G::kRingPix) << G::kChunkLog; i += kThreads) {
        const int c = i & ((1 << G::kChunkLog) - 1), p = (i >> G::kChunkLog) % G::kRingPix;
        const int row = r + (i >> G::kChunkLog) / G::kRingPix, col = c0 - kHalo + p;
        const bool in = row >= 0 && row < H && col >= 0 && col < W;
        const unsigned char* src = in ? xb + (((size_t)b * H + row) * W + col) * G::kPixBytes + 16 * c : xb;
        cp_async16(s_ring + ((row - base) & (kRing - 1)) * G::kRowBytes + ring_off<S8>(p, c), src, in);
      }
    };
    // int8 conv2_1: block rows j0, j0 + 1 (row s0 - 1 + j) -> staging slots
    // j % 4 (f32; zeros outside the image and past the block's last halo
    // row), and after they land -> int8 ring slots j % 8 quantized with s2.
    // Both walk the same thread-to-chunk map, so each thread quantizes only
    // what it copied itself and refills only slots it has read.
    auto stage_rows = [&](int j0) {
      const float* xf = reinterpret_cast<const float*>(x);
      for (int i = tid; i < 2 * G::kRingPix * 16; i += kThreads) {
        const int c = i & 15, p = (i >> 4) % G::kRingPix, j = j0 + (i >> 4) / G::kRingPix;
        const int row = s0 - 1 + j, col = c0 - kHalo + p;
        const bool in = j < s1 - s0 + 2 && row >= 0 && row < H && col >= 0 && col < W;
        const float* src = in ? xf + (((size_t)b * H + row) * W + col) * 64 + 4 * c : xf;
        cp_async16(s_w + G::kStageOff + (j & (kStage - 1)) * G::kStageRow + p * 256 + 16 * c, src, in);
      }
    };
    auto quant_rows = [&](int j0) {
      for (int i = tid; i < 2 * G::kRingPix * 16; i += kThreads) {
        const int c = i & 15, p = (i >> 4) % G::kRingPix, j = j0 + (i >> 4) / G::kRingPix;
        const float4 v = *reinterpret_cast<const float4*>(
            smem + G::kStageOff + (j & (kStage - 1)) * G::kStageRow + p * 256 + 16 * c);
        *reinterpret_cast<uint32_t*>(smem + G::kRingOff + (j & (kRing - 1)) * G::kRowBytes +
                                     ring_off<true>(p, c >> 2) + 4 * (c & 3)) =
            code(__fmul_rn(v.x, rcp)) | (code(__fmul_rn(v.y, rcp)) << 8) |
            (code(__fmul_rn(v.z, rcp)) << 16) | (code(__fmul_rn(v.w, rcp)) << 24);
      }
    };
    __syncthreads();  // weights in; the last item's readers are done with the ring
    if constexpr (QUANT) {
      stage_rows(0);
      stage_rows(2);
      cp_async_commit();
      cp_async_wait<0>();
      quant_rows(0);
      quant_rows(2);
      if (nsteps > 1) stage_rows(4);
      cp_async_commit();
    } else {
      load_rows(s0 - 1, 4);
      cp_async_commit();
      if (nsteps > 1) load_rows(s0 + 3, 2);
      cp_async_commit();
    }
    for (int t = 0; t < nsteps; ++t) {
      const int R = s0 + 2 * t;  // conv rows R, R + 1 from input rows R - 1 .. R + 2
      if constexpr (QUANT) {
        cp_async_wait<0>();
        __syncthreads();  // ring rows of this step in; step t - 1 is done with the slots refilled below
        if (t + 1 < nsteps) quant_rows(2 * t + 4);
        if (t + 2 < nsteps) stage_rows(2 * t + 6);
      } else {
        cp_async_wait<1>();
        __syncthreads();  // rows in; step t - 1 is done with the slots reloaded below
        if (t + 2 < nsteps) load_rows(R + 5, 2);
      }
      cp_async_commit();

      Acc acc[MT][NA];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < NA; ++e) acc[m][e] = 0;
        fence_acc(acc[m]);
      }
      // one unit = one input row (rin + u / 3) at one column shift dx = u % 3:
      // its A fragments are loaded once and feed every tile whose row it
      // reaches (tile m at tap dy = u / 3 - m), so each tile sums its taps in
      // ascending order; two units in flight, A double-buffered
      const int rin = R + G::tile_row(wg, 0) - 1;
      uint32_t a[2][KS][4];  // [unit parity][K step][fragment]
#pragma unroll
      for (int u = 0; u < 3 * (MT + 2); ++u) {
        const int ir = u / 3, dx = u % 3, buf = u & 1;
        const uint32_t rbase = s_ring + ((rin + ir - base) & (kRing - 1)) * G::kRowBytes;
#pragma unroll
        for (int kc = 0; kc < KS; ++kc) ldsm_x4(a[buf][kc], rbase + ring_off<S8>(rp0 + dx, 2 * kc + khalf));
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KS; ++kc)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int dy = ir - m;
            if (dy >= 0 && dy <= 2) {
              const int kb = (3 * dy + dx) * G::kTapK + 32 * kc;  // K byte of this step
              wgmma(acc[m], a[buf][kc], desc0 + (uint64_t)(((kb >> 7) * G::kTileBytes + (kb & 127)) >> 4));
            }
          }
        wgmma_commit();
        wgmma_wait<1>();  // unit u - 1 done: its A buffer is free for unit u + 1
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(acc[m]);

      // ---- epilogue: accumulator (row g | g + 8, channels 8 j + 2 q, + 1) of
      // m16 slice wi = pixels 2 g | 2 g + 1 of columns [16 wi, 16 wi + 16)
      if constexpr (POOL) {
        const int pc = (c0 + G::tile_col(wg) + 16 * wi) / 2 + g;
        const size_t o = (((size_t)b * (H / 2) + R / 2) * (W / 2) + pc) * 64;
        uint32_t wd[2][4];
        float mx = 0.f;  // this thread's largest pooled value (int8)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ch = 8 * j + 2 * q;
          float m0 = 0.f, m1 = 0.f;  // every candidate is a ReLU output
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float y0, y1;
              if constexpr (S8) {
                y0 = __fmaf_rn(__int2float_rn(acc[m][4 * j + 2 * h]), __fmul_rn(sq, s_sw[ch]), s_bias[ch]);
                y1 = __fmaf_rn(__int2float_rn(acc[m][4 * j + 2 * h + 1]), __fmul_rn(sq, s_sw[ch + 1]),
                               s_bias[ch + 1]);
              } else {
                y0 = __fadd_rn(acc[m][4 * j + 2 * h], s_bias[ch]);
                y1 = __fadd_rn(acc[m][4 * j + 2 * h + 1], s_bias[ch + 1]);
              }
              m0 = fmaxf(m0, fmaxf(y0, 0.f));
              m1 = fmaxf(m1, fmaxf(y1, 0.f));
            }
          if constexpr (S8) {
            if (pc < W / 2) {
              *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o + ch) = make_float2(m0, m1);
              mx = fmaxf(mx, fmaxf(m0, m1));
            }
          } else {
            wd[j / 4][j % 4] = pack_bf16(m0, m1);
          }
        }
        if constexpr (S8) {
          for (int d = 16; d; d >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
          if (lane == 0)
            atomicMax(reinterpret_cast<int*>(rowmax) + (size_t)b * (H / 2) + R / 2, __float_as_int(mx));
        } else {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            quad_transpose(wd[k], q);
            if (pc < W / 2)
              *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(out) + o + 8 * q + 32 * k) =
                  make_uint4(wd[k][0], wd[k][1], wd[k][2], wd[k][3]);
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int row = R + G::tile_row(wg, m);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = c0 + G::tile_col(wg) + 16 * wi + 2 * g + h;
            uint32_t wd[COUT / 32][4];
#pragma unroll
            for (int j = 0; j < COUT / 8; ++j) {
              const int ch = 8 * j + 2 * q;
              float y0, y1;
              if constexpr (S8) {
                y0 = __fmaf_rn(__int2float_rn(acc[m][4 * j + 2 * h]), __fmul_rn(sq, s_sw[ch]), s_bias[ch]);
                y1 = __fmaf_rn(__int2float_rn(acc[m][4 * j + 2 * h + 1]), __fmul_rn(sq, s_sw[ch + 1]),
                               s_bias[ch + 1]);
              } else {
                y0 = __fadd_rn(acc[m][4 * j + 2 * h], s_bias[ch]);
                y1 = __fadd_rn(acc[m][4 * j + 2 * h + 1], s_bias[ch + 1]);
              }
              wd[j / 4][j % 4] = pack_bf16(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
            }
            const size_t o = (((size_t)b * H + row) * W + col) * COUT + 8 * q;
#pragma unroll
            for (int k = 0; k < COUT / 32; ++k) {
              quad_transpose(wd[k], q);
              if (row < s1 && col < W)
                *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(out) + o + 32 * k) =
                    make_uint4(wd[k][0], wd[k][1], wd[k][2], wd[k][3]);
            }
          }
        }
      }
    }
  }
}

template <int COUT, bool POOL, bool S8>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* sw, const void* scale,
                   void* rowmax, void* out, int B, int H, int W, int seg, cudaStream_t s) {
  typedef HGeo<COUT, S8> G;
  if (B < 0 || H < 0 || W < 0 || seg < 1 || (POOL && (H % 2 || W % 16)) || (G::kQuant && H % seg))
    return cudaErrorInvalidValue;
  const int nstrip = (W + G::kStrip - 1) / G::kStrip, nseg = (H + seg - 1) / seg;
  const long long items = (long long)B * nstrip * nseg;
  if (items == 0) return cudaSuccess;
  auto kern = conv3x3_hopper<COUT, POOL, S8>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int per_sm = 0;  // kBlocks an SM where they fit
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, G::kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * (per_sm < G::kBlocks ? per_sm : G::kBlocks);
  const int grid = (int)(items < cap ? items : cap);
  kern<<<grid, kThreads, G::kSmem, s>>>(x, w, (const float*)bias, (const float*)sw, (const float*)scale,
                                        (float*)rowmax, out, B, H, W, seg, nstrip, nseg);
  return cudaGetLastError();
}

}  // namespace hop

// #4: x0 bf16 [B,H,W,64], w [576,64] bf16 (tap-major K), b [64] f32 ->
// bf16 [B,H,W,64] of relu(conv3x3(x0) + b), zero padding.  Any H and W (the
// wrapper asks H % 4 == 0 and W % 8 == 0, as the TPU kernel does).
extern "C" int conv12_bf16(const void* x, const void* w, const void* b, void* out,
                           int B, int H, int W, void* stream) {
  return hop::launch<64, false, false>(x, w, b, nullptr, nullptr, nullptr, out, B, H, W,
                                       hop::HGeo<64, false>::kSeg, (cudaStream_t)stream);
}

// #5, and #6's first launch: x0 bf16 [B,H,W,64], w [576,64] bf16, b [64]
// f32 -> pooled bf16 [B,H/2,W/2,64].  H even, W % 16 == 0.
extern "C" int conv12_pool_bf16(const void* x, const void* w, const void* b, void* out,
                                int B, int H, int W, void* stream) {
  return hop::launch<64, true, false>(x, w, b, nullptr, nullptr, nullptr, out, B, H, W,
                                      hop::HGeo<64, false>::kSeg, (cudaStream_t)stream);
}

// #6, second launch: pooled bf16 [B,H2,W2,64], w [576,128] bf16, b [128]
// f32 -> bf16 [B,H2,W2,128] (zero padding = the pooled map's zeroed SAME
// ring).  Any H2 and W2.
extern "C" int conv21_bf16(const void* p, const void* w, const void* b, void* out,
                           int B, int H2, int W2, void* stream) {
  return hop::launch<128, false, false>(p, w, b, nullptr, nullptr, nullptr, out, B, H2, W2,
                                        hop::HGeo<128, false>::kSeg, (cudaStream_t)stream);
}

// #7, launch 1: amax [B] f32 = max |x0| of each sample of x0 bf16 [B, n]
// (n = H * W * 64).
extern "C" int sample_amax_bf16(const void* x, void* amax, int B, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)B * sizeof(float), s);
  if (err != cudaSuccess || B == 0 || n == 0) return err;
  sample_amax_kernel<<<sample_grid(B, n), 256, 0, s>>>((const bf16*)x, (float*)amax, n);
  return cudaGetLastError();
}

// #7, launch 2: x0 bf16 [B, n], amax [B] -> xq int8 [B, n], sx [B] f32.
extern "C" int quantize_bf16(const void* x, const void* amax, void* xq, void* sx, int B, long long n,
                             void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  quantize_kernel<<<sample_grid(B, n), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)amax, (signed char*)xq, (float*)sx, n);
  return cudaGetLastError();
}

// #7, launch 3: xq int8 [B,H,W,64], sx [B], w int8 [576,64], sw [64], b [64]
// -> f32 pooled map [B,H/2,W/2,64] of relu(acc * (sx * sw) + b), and rowmax
// [B, H/2] f32, each pooled row's max.  H even, W % 16 == 0.
extern "C" int conv12_pool_s8(const void* xq, const void* sx, const void* w, const void* sw,
                              const void* b, void* out, void* rowmax, int B, int H, int W,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(rowmax, 0, (size_t)B * (H / 2) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  return hop::launch<64, true, true>(xq, w, b, sw, sx, rowmax, out, B, H, W,
                                     hop::HGeo<64, true>::kSeg, s);
}

// #7, launch 4: f32 pooled map [B,H2,W2,64], its rowmax [B,H2], w int8
// [576,128], sw [128], b [128] -> bf16 [B,H2,W2,128] of relu(acc * (s2 *
// sw) + b), quantized per requant block of r2 rows (H2 % r2 == 0).
extern "C" int conv21_s8(const void* p, const void* rowmax, const void* w, const void* sw,
                         const void* b, void* out, int B, int H2, int W2, int r2, void* stream) {
  return hop::launch<128, false, true>(p, w, b, sw, nullptr, (void*)rowmax, out, B, H2, W2, r2,
                                       (cudaStream_t)stream);
}
// conv3x3_hopper's geometry, for the wrapper to check against its own copy:
// conv1_2 strip columns and segment rows, conv2_1 strip columns and segment
// rows (bf16), the int8 conv1_2's segment rows and blocks an SM, halo, ring
// rows, the int8 conv2_1's staging rows, and the shared-memory bytes of the
// bf16 conv1_2, bf16 conv2_1, s8 conv1_2 and s8 conv2_1.
extern "C" int stem_geometry(int* out) {
  out[0] = hop::HGeo<64, false>::kStrip;
  out[1] = hop::HGeo<64, false>::kSeg;
  out[2] = hop::HGeo<128, false>::kStrip;
  out[3] = hop::HGeo<128, false>::kSeg;
  out[4] = hop::HGeo<64, true>::kSeg;
  out[5] = hop::HGeo<64, true>::kBlocks;
  out[6] = hop::kHalo;
  out[7] = hop::kRing;
  out[8] = hop::kStage;
  out[9] = hop::HGeo<64, false>::kSmem;
  out[10] = hop::HGeo<128, false>::kSmem;
  out[11] = hop::HGeo<64, true>::kSmem;
  out[12] = hop::HGeo<128, true>::kSmem;
  return 0;
}
