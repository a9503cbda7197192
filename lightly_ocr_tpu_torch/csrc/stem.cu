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
// ops/stem.py.  Rounding follows the TPU kernels: bf16 operands, f32 sums,
// + f32 bias, ReLU, pool in f32, one cast; only the order of the f32 sums
// differs from the plain versions.
//
// Two kernels do the convolutions:
//
// conv3x3_hopper (#4 and both launches of #6): a line buffer down a column
// strip, fed by cp.async and multiplied with wgmma.
// - Bound on an H100 at b16 960x640 (conv1_2 0.72 TFLOP, conv2_1 0.36
//   TFLOP): #4 moves 2.5 GB (x0 in, the full-resolution map out), 0.75 ms
//   at 3.35 TB/s against 0.73 ms of bf16 operations, so it is bound by
//   bytes and needs its copies, products and stores overlapped; #6 is bound
//   by operations, 1.10 ms at 989 TFLOP/s.
// - Geometry: a block owns one sample, a strip of kStrip output columns and
//   a segment of kSeg output rows (conv1_2: 128 x 120; conv2_1: 64 x 60),
//   and walks the segment two rows a step.  Its input rows live in a ring of
//   kRing = 8 rows of kStrip + 2 pixels (the 1-column halo each side), so
//   every input row is read once per strip; a segment re-reads one row above
//   and one below.  Rows and columns outside the image are zero-filled by the
//   copies (SAME padding).  The grid is persistent, one block an SM, walking
//   B x ceil(W / kStrip) x ceil(H / kSeg) items (640 for either conv at b16
//   960x640, 4.85 an SM), so the weights are loaded once per SM.
// - Copies: cp.async with the zero-fill source size, two steps (4 rows)
//   ahead of the products, one block barrier a step.  TMA would give the zero
//   fill too, but its 128-byte swizzle keys a pixel's 16-byte chunks by pixel
//   % 8, and the pool's A rows are every second pixel (below), which that
//   swizzle maps onto 4 bank groups; cp.async writes the ring with the key
//   (pixel / 2) % 8, which keeps every ldmatrix conflict-free, and needs no
//   tensor map (cuTensorMapEncodeTiled lives in libcuda, which the library
//   does not link).
// - Products: wgmma.m64nNk16, bf16 x bf16 -> f32, A from registers, B from
//   shared memory.  The weights [576][COUT] are written once per block as 9
//   tap tiles [COUT][64] K-major in the 128-byte swizzle and read through a
//   matrix descriptor.  A is loaded with ldmatrix from the ring: one 16-byte
//   row address per lane, so tap (dy, dx) is only another base address
//   (wgmma's shared-memory A layout breaks under a one-pixel shift).  Each
//   of the two warpgroups of a block holds 64 f32 accumulators a thread:
//   conv1_2, 2 rows x 64 columns x 64 channels (two m64n64 tiles, rows R and
//   R + 1 of the same columns); conv2_1, 1 row x 64 columns x 128 channels
//   (one m64n128 tile, warpgroup w takes row R + w).  A is loaded once per
//   input row and column shift dx, and feeds every tile that row reaches
//   (conv1_2: input rows R and R + 1 feed both output rows, so a step loads
//   12 A units, not 18); each tile still sums its taps in ascending order.
//   A unit's products are one commit group, its A fragments are double-
//   buffered in registers, and the next unit's ldmatrix overlaps them.
// - Pixel order: A row i of a warp's m16 slice is pixel 2i (i < 8) or
//   2(i - 8) + 1 of its 16 columns, so accumulator rows g and g + 8 of a
//   thread are horizontal neighbours, and with the two rows of the step in
//   the same thread the 2x2 max needs no shuffle.
// - Epilogue in registers: bias, ReLU (and the pool) in f32 on the
//   accumulators, one bf16 cast, a 4x4 transpose of 32-bit words across each
//   quad of lanes, and 16-byte stores (8 channels of one pixel a lane).
// - Shared memory: conv1_2 1,024 (alignment) + 73,728 (weights) + 256
//   (bias) + 133,120 (ring: 8 x 130 x 128) = 208,128 B; conv2_1 1,024 +
//   147,456 + 512 + 67,584 (8 x 66 x 128) = 216,576 B, of the 232,448 a
//   block may have.  Registers: 64 accumulators, 32 A registers.
// - #6 is two launches of this kernel: conv12_pool_bf16_h writes the bf16
//   pooled map (rounded as the plain version rounds it, 0.63 GB of round
//   trip, ~0.19 ms, under #6's 1.10 ms operations bound), and conv21_bf16
//   reads it with a zero SAME ring.  Both weight sets together (221 KB)
//   would leave no room for a ring, so the pooled map is not kept on chip.
// The geometry is exported by stem_geometry() and checked by ops/stem.py.
//
// conv3x3_mma (#5 and #7, the first version; to move onto
// conv3x3_hopper next): one templated implicit-GEMM kernel, M = output
// pixels, N = output channels, K = 9 taps x 64 input channels.  A block
// stages its input tile (2 output rows x TC columns plus the 3x3 halo, zero
// outside the image) and all 576 x COUT weights in shared memory, and walks
// tiles with a grid-stride loop.  Each warp owns 16 columns x 2 rows x
// (COUT / WN) channels and runs nvcuda::wmma 16x16x16 products: bf16 x bf16
// -> f32, or s8 x s8 -> s32.  The epilogue goes through a per-warp staging
// tile.  There is no copy/compute overlap (one block per SM).
//
// Launches (extern "C", below):
//   #4  conv12_bf16                 x0 bf16 -> full-resolution bf16 (hopper)
//   #5  conv12_pool_bf16            x0 bf16 -> pooled bf16 (mma)
//   #6  conv12_pool_bf16_h, conv21_bf16  (hopper; conv2_1 on the bf16 pooled map)
//   #7  quantize_per_sample_bf16 (x0 -> xq int8 and sx, per sample),
//       conv12_pool_s8 (xq int8 -> dequantized pooled map in f32),
//       requant_scales (s2 per sample and row block: amax over the block's
//       pooled rows with a one-row halo, all columns),
//       conv21_s8 (quantizes the f32 pooled map on load with the OUTPUT
//       row's block scale, as the TPU kernel quantizes its slab, halo rows
//       included, with the reading block's s2).
// The int8 epilogues round as XLA runs the JAX kernel: y * (s * sw) + b is
// one FMA (__fmaf_rn after __fmul_rn(s, sw)), the requant multiplies by the
// correctly rounded reciprocal of s2, then rounds half to even, and the
// per-sample scale sx = max(amax, 1e-12) / 127 is a multiply by the float
// constant 1/127 (XLA's rewrite of a division by a constant in the jitted
// wrapper; s2, taken in the TPU kernel, is a true division); so #7 matches
// its plain PyTorch version (ops/stem.py) bit for bit: every int8 product
// and int32 sum is exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCin = 64;
constexpr int kK = 9 * kCin;

enum In { kInBf16 = 0, kInS8 = 1, kInF32Quant = 2 };

constexpr float kRcp127 = 1.0f / 127.0f;  // correctly rounded float, as XLA folds it

// Shared-memory layouts.  wmma wants every fragment's first element 32-byte
// aligned.  bf16: A is [pixel][80] (160 B a pixel), B is [576][COUT + 8].
// int8 (16-byte fragment rows): A is [k-chunk of 16][pixel][32 B] and B is
// [column chunk of 16][576][16 B], so every fragment starts on 32 bytes.
template <int IN>
struct Types {
  typedef bf16 E;
  typedef float Acc;
  static constexpr bool kS8 = false;
};
template <>
struct Types<kInS8> {
  typedef signed char E;
  typedef int Acc;
  static constexpr bool kS8 = true;
};
template <>
struct Types<kInF32Quant> : Types<kInS8> {};

__host__ __device__ constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <int COUT, int WN, int IN>
struct Geo {
  typedef typename Types<IN>::E E;
  static constexpr bool kS8 = Types<IN>::kS8;
  static constexpr int kTC = 16 * (kWarps / WN);          // tile columns
  static constexpr int kSets = IN == kInF32Quant ? 2 : 1;  // one halo per output row
  static constexpr int kHRows = IN == kInF32Quant ? 3 : 4;
  static constexpr int kPix = kSets * kHRows * (kTC + 2);  // staged pixels
  static constexpr int kLda = kS8 ? 32 : 80;               // A fragment ldm (elements)
  static constexpr int kLdb = kS8 ? 16 : COUT + 8;         // B fragment ldm (elements)
  static constexpr int kBytesA = align128(kS8 ? 4 * kPix * 32 : kPix * 80 * 2);
  static constexpr int kBytesB = align128(kK * COUT * (kS8 ? 1 : 2) + (kS8 ? 0 : kK * 8 * 2));
  static constexpr int kBytesStage = kWarps * 2 * 256 * 4;
  static constexpr int kSmem = kBytesA + kBytesB + kBytesStage;

  // first element of the A fragment: staged pixel `px`, channels [16 kc, 16 kc + 16)
  __device__ static size_t a_off(int px, int kc) {
    return kS8 ? ((size_t)kc * kPix + px) * 32 : (size_t)px * 80 + kc * 16;
  }
  // first element of the B fragment: weight row k, columns [n, n + 16)
  __device__ static size_t b_off(int k, int n) {
    return kS8 ? ((size_t)(n / 16) * kK + k) * 16 : (size_t)k * (COUT + 8) + n;
  }
};

// clip(round(v * rcp), -127, 127), rcp = 1 / s2 rounded once
__device__ __forceinline__ signed char quant1(float v, float rcp) {
  float q = rintf(__fmul_rn(v, rcp));
  return (signed char)fminf(fmaxf(q, -127.f), 127.f);
}

// Output of the conv: H x W (SAME).  POOL: writes [B, H/2, W/2, COUT]
// (H, W even), else [B, H, W, COUT].  scale: IN=kInS8 -> sx [B];
// IN=kInF32Quant -> s2 [B, ceil(H / r2)]; sw [COUT] with any int8 input.
template <int COUT, int WN, bool POOL, int IN, bool OUT_F32>
__global__ void __launch_bounds__(kThreads)
conv3x3_mma(const void* __restrict__ xin, const void* __restrict__ wgt,
            const float* __restrict__ bias, const float* __restrict__ scale,
            const float* __restrict__ sw, void* __restrict__ out,
            int B, int H, int W, int r2) {
  typedef Geo<COUT, WN, IN> G;
  typedef typename G::E E;
  typedef typename Types<IN>::Acc Acc;
  constexpr int TC = G::kTC, LDA = G::kLda, LDB = G::kLdb;
  static_assert(kCin == 64, "conv1_2 and conv2_1 take 64 channels");
  constexpr int NW = COUT / WN;  // channels per warp
  constexpr int NF = NW / 16;    // fragments per output row

  extern __shared__ __align__(128) unsigned char smem[];
  E* sA = reinterpret_cast<E*>(smem);
  E* sB = reinterpret_cast<E*>(smem + G::kBytesA);
  Acc* sStage = reinterpret_cast<Acc*>(smem + G::kBytesA + G::kBytesB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp % WN, wc = warp / WN;
  const int n0 = wn * NW;
  Acc* st = sStage + warp * 512;

  // weights [576][COUT] -> shared, 16-byte chunks (16 columns of int8, 8 of bf16)
  {
    constexpr int EPC = 16 / (int)sizeof(E);  // elements a chunk
    constexpr int CPR = COUT / EPC;
    const uint4* src = reinterpret_cast<const uint4*>(wgt);
    for (int i = tid; i < kK * CPR; i += kThreads) {
      const int k = i / CPR, c = i % CPR;
      *reinterpret_cast<uint4*>(sB + G::b_off(k, c * EPC)) = src[i];
    }
  }

  const int nblk = IN == kInF32Quant ? (H + r2 - 1) / r2 : 1;
  const int ctiles = (W + TC - 1) / TC, rtiles = (H + 1) / 2;
  const long long ntiles = (long long)B * rtiles * ctiles;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int ct = (int)(tile % ctiles);
    const long long rest = tile / ctiles;
    const int r0 = 2 * (int)(rest % rtiles);
    const int b = (int)(rest / rtiles);
    const int c0 = ct * TC;

    __syncthreads();  // the previous tile's products are done with sA
    // ---- input tile with halo -> shared ----
    if (IN == kInF32Quant) {
      const float* x = reinterpret_cast<const float*>(xin);
      constexpr int CH = kCin / 4;  // float4 per pixel
      for (int i = tid; i < 2 * 3 * (TC + 2) * CH; i += kThreads) {
        const int ch = i % CH;
        const int px = i / CH;
        const int cc = px % (TC + 2);
        const int rr = (px / (TC + 2)) % 3;
        const int set = px / (3 * (TC + 2));
        const int orow = min(r0 + set, H - 1);
        const float s = __frcp_rn(scale[b * nblk + orow / r2]);
        const int gr = r0 + set - 1 + rr, gc = c0 - 1 + cc;
        char4 q = make_char4(0, 0, 0, 0);
        if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
          const float4 v = *reinterpret_cast<const float4*>(
              x + (((size_t)b * H + gr) * W + gc) * kCin + ch * 4);
          q = make_char4(quant1(v.x, s), quant1(v.y, s), quant1(v.z, s), quant1(v.w, s));
        }
        const int spx = (set * 3 + rr) * (TC + 2) + cc;
        *reinterpret_cast<char4*>(sA + G::a_off(spx, ch / 4) + (ch % 4) * 4) = q;
      }
    } else {
      constexpr int CH = kCin * (int)sizeof(E) / 16;  // 16-byte chunks per pixel
      const unsigned char* x = reinterpret_cast<const unsigned char*>(xin);
      for (int i = tid; i < 4 * (TC + 2) * CH; i += kThreads) {
        const int ch = i % CH;
        const int px = i / CH;
        const int cc = px % (TC + 2), rr = px / (TC + 2);
        const int gr = r0 - 1 + rr, gc = c0 - 1 + cc;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gr >= 0 && gr < H && gc >= 0 && gc < W)
          v = *reinterpret_cast<const uint4*>(
              x + ((((size_t)b * H + gr) * W + gc) * kCin) * sizeof(E) + ch * 16);
        // chunk ch holds channels [ch * EPC, ch * EPC + EPC)
        constexpr int EPC = 16 / (int)sizeof(E);
        const int spx = rr * (TC + 2) + cc;
        *reinterpret_cast<uint4*>(sA + G::a_off(spx, ch * EPC / 16) + (ch * EPC) % 16) = v;
      }
    }
    __syncthreads();

    // ---- products: 9 taps x 4 k-steps ----
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][NF];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[r][f], (Acc)0);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, E, wmma::row_major> a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int hrow = G::kSets == 2 ? r * 3 + dy : r + dy;
          wmma::load_matrix_sync(a[r], sA + G::a_off(hrow * (TC + 2) + wc * 16 + dx, kc), LDA);
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, sB + G::b_off(tap * kCin + kc * 16, n0 + f * 16), LDB);
          wmma::mma_sync(acc[0][f], a[0], bf, acc[0][f]);
          wmma::mma_sync(acc[1][f], a[1], bf, acc[1][f]);
        }
      }
    }

    // ---- epilogue ----
    const int cw = c0 + wc * 16;  // first conv column of this warp
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::store_matrix_sync(st, acc[0][f], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, acc[1][f], 16, wmma::mem_row_major);
      __syncwarp();
      const int nb = n0 + f * 16;
      if (POOL) {
        const int j = lane >> 2, cq = (lane & 3) * 4;
        const int pc = cw / 2 + j;
        float m[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = nb + cq + k;
          float sc = 0.f;
          if (IN == kInS8) sc = __fmul_rn(scale[b], sw[ch]);
          float v = 0.f;  // every candidate is a ReLU output
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const Acc a = st[(q >> 1) * 256 + (2 * j + (q & 1)) * 16 + cq + k];
            float y = IN == kInBf16 ? __fadd_rn((float)a, bias[ch])
                                    : __fmaf_rn(__int2float_rn((int)a), sc, bias[ch]);
            v = fmaxf(v, fmaxf(y, 0.f));
          }
          m[k] = v;
        }
        if (pc < W / 2) {
          const size_t o = (((size_t)b * (H / 2) + r0 / 2) * (W / 2) + pc) * COUT + nb + cq;
          if (OUT_F32) {
            *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o) =
                make_float4(m[0], m[1], m[2], m[3]);
          } else {
            __nv_bfloat162 h[2] = {__floats2bfloat162_rn(m[0], m[1]),
                                   __floats2bfloat162_rn(m[2], m[3])};
            *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(out) + o) =
                *reinterpret_cast<uint2*>(h);
          }
        }
      } else {
        const int p = lane >> 1, half = (lane & 1) * 8;
        const int col = cw + p;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + r;
          if (row >= H || col >= W) continue;
          float sr = 0.f;
          if (IN == kInF32Quant) sr = scale[b * nblk + row / r2];
          if (IN == kInS8) sr = scale[b];
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int ch = nb + half + k;
            const Acc a = st[r * 256 + p * 16 + half + k];
            float y = IN == kInBf16
                          ? __fadd_rn((float)a, bias[ch])
                          : __fmaf_rn(__int2float_rn((int)a), __fmul_rn(sr, sw[ch]), bias[ch]);
            v[k] = fmaxf(y, 0.f);
          }
          const size_t o = (((size_t)b * H + row) * W + col) * COUT + nb + half;
          if (OUT_F32) {
            float4* d = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o);
            d[0] = make_float4(v[0], v[1], v[2], v[3]);
            d[1] = make_float4(v[4], v[5], v[6], v[7]);
          } else {
            __nv_bfloat162 h[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
            *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(out) + o) =
                *reinterpret_cast<uint4*>(h);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int COUT, int WN, bool POOL, int IN, bool OUT_F32>
cudaError_t launch(const void* x, const void* w, const float* bias, const float* scale,
                   const float* sw, void* out, int B, int H, int W, int r2, cudaStream_t s) {
  auto kern = conv3x3_mma<COUT, WN, POOL, IN, OUT_F32>;
  constexpr int smem = Geo<COUT, WN, IN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  constexpr int TC = Geo<COUT, WN, IN>::kTC;
  const long long tiles = (long long)B * ((H + 1) / 2) * ((W + TC - 1) / TC);
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(tiles < cap ? tiles : cap);
  if (grid == 0) return cudaSuccess;
  kern<<<grid, kThreads, smem, s>>>(x, w, bias, scale, sw, out, B, H, W, r2);
  return cudaGetLastError();
}

// s2[b, i] = max(amax |p| over pooled rows [i*r2 - 1, i*r2 + r2 + 1) of
// sample b (clipped to the map), all columns and channels, 1e-12) / 127.
__global__ void __launch_bounds__(256)
requant_scales_kernel(const float* __restrict__ p, float* __restrict__ s2,
                      int H2, int W2, int r2, int nblk) {
  const int b = blockIdx.x / nblk, i = blockIdx.x % nblk;
  const int lo = max(i * r2 - 1, 0), hi = min(i * r2 + r2 + 1, H2);
  const float4* base = reinterpret_cast<const float4*>(p + ((size_t)b * H2 + lo) * W2 * kCin);
  const long long n = (long long)(hi - lo) * W2 * kCin / 4;
  float m = 0.f;
  for (long long k = threadIdx.x; k < n; k += blockDim.x) {
    const float4 v = base[k];
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float red[8];
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
    s2[blockIdx.x] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
  }
}

// amax[b] = max |x| over sample b of x bf16 [B, n] (n % 8 == 0); amax is
// zeroed by the caller.  Non-negative floats order as their bit patterns,
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
// a true division rounded half to even (QuantConv's convention).
__global__ void __launch_bounds__(256)
quantize_kernel(const bf16* __restrict__ x, const float* __restrict__ amax,
                signed char* __restrict__ xq, float* __restrict__ sx, long long n) {
  const int b = blockIdx.y;
  const float s = __fmul_rn(fmaxf(amax[b], 1e-12f), kRcp127);
  if (blockIdx.x == 0 && threadIdx.x == 0) sx[b] = s;
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)b * n);
  uint2* q = reinterpret_cast<uint2*>(xq + (size_t)b * n);
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n / 8;
       k += (long long)gridDim.x * blockDim.x) {
    const uint4 raw = p[k];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    signed char c[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      c[2 * j] = (signed char)fminf(fmaxf(rintf(__fdiv_rn(f.x, s)), -127.f), 127.f);
      c[2 * j + 1] = (signed char)fminf(fmaxf(rintf(__fdiv_rn(f.y, s)), -127.f), 127.f);
    }
    q[k] = *reinterpret_cast<uint2*>(c);
  }
}

}  // namespace

// ---- conv3x3_hopper: #4 and #6 ----------------------------------------------

namespace hop {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRing = 8;       // ring rows: 4 in use, 2 steps of 2 in flight
constexpr int kHalo = 1;       // halo columns each side, rows above and below

template <int COUT>
struct HGeo {
  static constexpr bool kC12 = COUT == 64;
  static constexpr int kStrip = kC12 ? 128 : 64;  // output columns of a block
  static constexpr int kSeg = kC12 ? 120 : 60;    // output rows of a segment (even)
  static constexpr int kMT = kC12 ? 2 : 1;        // m64 tiles of a warpgroup a step
  static constexpr int kRingPix = kStrip + 2 * kHalo;
  static constexpr int kRowBytes = kRingPix * 128;  // 64 bf16 channels a pixel
  static constexpr int kTapBytes = COUT * 128;      // [COUT][64] bf16, K-major
  static constexpr int kBias = 9 * kTapBytes;
  static constexpr int kRingOff = kBias + COUT * 4;
  static constexpr int kSmem = 1024 + kRingOff + kRing * kRowBytes;  // + alignment slack
  // step rows R, R + 1: conv1_2 warpgroup w takes both rows of columns
  // [64 w, 64 w + 64); conv2_1 warpgroup w takes row R + w, all 64 columns
  __device__ static int tile_row(int wg, int t) { return kC12 ? t : wg; }
  __device__ static int tile_col(int wg) { return kC12 ? 64 * wg : 0; }
};
static_assert(HGeo<64>::kSmem == 208128 && HGeo<128>::kSmem == 216576, "budget in the note");
static_assert(HGeo<128>::kSmem <= 232448, "shared memory");
static_assert(HGeo<64>::kRingOff % 16 == 0 && HGeo<128>::kRingOff % 16 == 0, "ring alignment");

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

// d += A (registers, m64 x k16) x B (descriptor, k16 x nN); bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 64) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
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

// Byte offset of pixel p's 16-byte chunk c in a ring row: the chunks of a
// pixel are permuted by (p / 2) % 8, so 8 pixels at a stride of 1 or 2 hit
// 8 distinct bank groups.
__device__ __forceinline__ uint32_t ring_off(int p, int c) {
  return (uint32_t)(p * 128 + (((c ^ (p >> 1)) & 7) << 4));
}

// relu(conv3x3(x) + bias) (POOL: then the 2x2 max), SAME padding, bf16 out:
// x [B, H, W, 64] bf16, w [576, COUT] bf16 (k = tap * 64 + cin), bias [COUT]
// f32 -> out [B, H, W, COUT] or, POOL (COUT 64, H even, W % 16 == 0),
// [B, H/2, W/2, 64].
template <int COUT, bool POOL>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_hopper(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out, int B, int H, int W,
               int nstrip, int nseg) {
  typedef HGeo<COUT> G;
  constexpr int MT = G::kMT, NA = COUT / 2;
  static_assert(!POOL || COUT == 64, "the pool pairs the two rows of a warpgroup");
  extern __shared__ __align__(1024) unsigned char hsmem[];
  unsigned char* smem = hsmem + ((1024 - (smem_u32(hsmem) & 1023)) & 1023);
  const uint32_t s_w = smem_u32(smem);
  const uint32_t s_ring = s_w + G::kRingOff;
  const float* s_bias = reinterpret_cast<const float*>(smem + G::kBias);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, q = lane & 3;

  // weights -> 9 tap tiles [COUT][64], 8-row atoms of 1,024 B, chunk c of
  // row n at c ^ (n % 8): wgmma's 128-byte swizzle, K-major
  for (int i = tid; i < 9 * 8 * COUT; i += kThreads) {
    const int n = i % COUT, c = (i / COUT) % 8, tap = i / (8 * COUT);
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(w) + (size_t)(tap * 64 + 8 * c) * COUT + n;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (uint32_t)src[2 * e * COUT] | ((uint32_t)src[(2 * e + 1) * COUT] << 16);
    *reinterpret_cast<uint4*>(smem + tap * G::kTapBytes + (n >> 3) * 1024 + (n & 7) * 128 +
                              ((c ^ (n & 7)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < COUT; i += kThreads) reinterpret_cast<float*>(smem + G::kBias)[i] = bias[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma

  // B descriptor: start >> 4, leading offset 16 B (unused when swizzled),
  // stride 1,024 B between 8-row atoms, 128-byte swizzle
  const uint64_t desc0 = (uint64_t)((s_w & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
                         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
  // ldmatrix lane: A row (lane & 15) is pixel 2i or 2i + 1 of the warp's 16
  // columns; lanes 16-31 address the upper 8 channels of a k16 step
  const int px = 2 * (lane & 7) + ((lane >> 3) & 1), khalf = lane >> 4;
  const int rp0 = G::tile_col(wg) + 16 * wi + px;  // ring pixel of this lane's A row at dx = 0

  const long long items = (long long)B * nstrip * nseg;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int seg = (int)(it % nseg);
    const long long rest = it / nseg;
    const int strip = (int)(rest % nstrip), b = (int)(rest / nstrip);
    const int c0 = strip * G::kStrip, s0 = seg * G::kSeg, s1 = min(s0 + G::kSeg, H);
    const int nsteps = (s1 - s0 + 1) / 2;
    // input rows [r, r + n) -> their ring slots ((row + 1) % 8), zeros
    // outside the image
    auto load_rows = [&](int r, int n) {
      for (int i = tid; i < n * G::kRingPix * 8; i += kThreads) {
        const int c = i & 7, p = (i >> 3) % G::kRingPix, row = r + (i >> 3) / G::kRingPix;
        const int col = c0 - kHalo + p;
        const bool in = row >= 0 && row < H && col >= 0 && col < W;
        const bf16* src = in ? x + (((size_t)b * H + row) * W + col) * 64 + 8 * c : x;
        cp_async16(s_ring + ((row + 1) & (kRing - 1)) * G::kRowBytes + ring_off(p, c), src, in);
      }
    };
    __syncthreads();  // weights in; the last item's readers are done with the ring
    load_rows(s0 - 1, 4);
    cp_async_commit();
    if (nsteps > 1) load_rows(s0 + 3, 2);
    cp_async_commit();
    for (int t = 0; t < nsteps; ++t) {
      const int R = s0 + 2 * t;  // conv rows R, R + 1 from input rows R - 1 .. R + 2
      cp_async_wait<1>();
      __syncthreads();  // rows in; step t - 1 is done with the slots reloaded below
      if (t + 2 < nsteps) load_rows(R + 5, 2);
      cp_async_commit();

      float acc[MT][NA];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int e = 0; e < NA; ++e) acc[m][e] = 0.f;
        fence_acc(acc[m]);
      }
      // one unit = one input row (rin + u / 3) at one column shift dx = u % 3:
      // its A fragments are loaded once and feed every tile whose row it
      // reaches (tile m at tap dy = u / 3 - m), so each tile sums its taps in
      // ascending order; two units in flight, A double-buffered
      const int rin = R + G::tile_row(wg, 0) - 1;
      uint32_t a[2][4][4];  // [unit parity][k16 step][fragment]
#pragma unroll
      for (int u = 0; u < 3 * (MT + 2); ++u) {
        const int ir = u / 3, dx = u % 3, buf = u & 1;
        const uint32_t base = s_ring + ((rin + ir + 1) & (kRing - 1)) * G::kRowBytes;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) ldsm_x4(a[buf][kc], base + ring_off(rp0 + dx, 2 * kc + khalf));
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int dy = ir - m;
            if (dy >= 0 && dy <= 2)
              wgmma<COUT>(acc[m], a[buf][kc],
                          desc0 + (uint64_t)(((3 * dy + dx) * G::kTapBytes + kc * 32) >> 4));
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
        uint32_t wd[2][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ch = 8 * j + 2 * q;
          float m0 = 0.f, m1 = 0.f;  // every candidate is a ReLU output
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              m0 = fmaxf(m0, fmaxf(__fadd_rn(acc[m][4 * j + 2 * h], s_bias[ch]), 0.f));
              m1 = fmaxf(m1, fmaxf(__fadd_rn(acc[m][4 * j + 2 * h + 1], s_bias[ch + 1]), 0.f));
            }
          wd[j / 4][j % 4] = pack_bf16(m0, m1);
        }
        const int pc = (c0 + G::tile_col(wg) + 16 * wi) / 2 + g;
        const size_t o = (((size_t)b * (H / 2) + R / 2) * (W / 2) + pc) * 64 + 8 * q;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          quad_transpose(wd[k], q);
          if (pc < W / 2)
            *reinterpret_cast<uint4*>(out + o + 32 * k) = make_uint4(wd[k][0], wd[k][1], wd[k][2], wd[k][3]);
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
              wd[j / 4][j % 4] =
                  pack_bf16(fmaxf(__fadd_rn(acc[m][4 * j + 2 * h], s_bias[ch]), 0.f),
                            fmaxf(__fadd_rn(acc[m][4 * j + 2 * h + 1], s_bias[ch + 1]), 0.f));
            }
            const size_t o = (((size_t)b * H + row) * W + col) * COUT + 8 * q;
#pragma unroll
            for (int k = 0; k < COUT / 32; ++k) {
              quad_transpose(wd[k], q);
              if (row < H && col < W)
                *reinterpret_cast<uint4*>(out + o + 32 * k) =
                    make_uint4(wd[k][0], wd[k][1], wd[k][2], wd[k][3]);
            }
          }
        }
      }
    }
  }
}

template <int COUT, bool POOL>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                   cudaStream_t s) {
  typedef HGeo<COUT> G;
  if (B < 0 || H < 0 || W < 0 || (POOL && (H % 2 || W % 16))) return cudaErrorInvalidValue;
  const int nstrip = (W + G::kStrip - 1) / G::kStrip, nseg = (H + G::kSeg - 1) / G::kSeg;
  const long long items = (long long)B * nstrip * nseg;
  if (items == 0) return cudaSuccess;
  auto kern = conv3x3_hopper<COUT, POOL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)(items < sms ? items : sms);  // one block an SM (shared memory)
  kern<<<grid, kThreads, G::kSmem, s>>>((const bf16*)x, (const bf16*)w, (const float*)bias,
                                        (bf16*)out, B, H, W, nstrip, nseg);
  return cudaGetLastError();
}

}  // namespace hop

// #7, step 0: per-sample int8 of x0 bf16 [B, n] (n = H * W * 64): amax
// [B] f32 zeroed by the caller, xq int8 [B, n], sx [B] f32.
extern "C" int quantize_per_sample_bf16(const void* x, void* amax, void* xq, void* sx, int B,
                                        long long n, void* stream) {
  if (B == 0 || n == 0) return cudaSuccess;
  const long long chunks = (n / 8 + 255) / 256;
  const dim3 grid((unsigned)(chunks < 512 ? chunks : 512), B);
  cudaStream_t s = (cudaStream_t)stream;
  sample_amax_kernel<<<grid, 256, 0, s>>>((const bf16*)x, (float*)amax, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_kernel<<<grid, 256, 0, s>>>((const bf16*)x, (const float*)amax, (signed char*)xq,
                                       (float*)sx, n);
  return cudaGetLastError();
}

// #4: x0 bf16 [B,H,W,64], w [576,64] bf16 (tap-major K), b [64] f32 ->
// bf16 [B,H,W,64] of relu(conv3x3(x0) + b), zero padding (conv3x3_hopper).
// Any H and W (the wrapper asks H % 4 == 0 and W % 8 == 0, as the TPU
// kernel does).
extern "C" int conv12_bf16(const void* x, const void* w, const void* b, void* out,
                           int B, int H, int W, void* stream) {
  return hop::launch<64, false>(x, w, b, out, B, H, W, (cudaStream_t)stream);
}

// #5: x0 bf16 [B,H,W,64], w [576,64] bf16 (tap-major K), b [64] f32 ->
// pooled bf16 [B,H/2,W/2,64] (conv3x3_mma).  H even, W % 16 == 0.
extern "C" int conv12_pool_bf16(const void* x, const void* w, const void* b, void* out,
                                int B, int H, int W, void* stream) {
  return launch<64, 1, true, kInBf16, false>(x, w, (const float*)b, nullptr, nullptr, out,
                                              B, H, W, 1, (cudaStream_t)stream);
}

// #6, first half: the same function as #5 on conv3x3_hopper.
extern "C" int conv12_pool_bf16_h(const void* x, const void* w, const void* b, void* out,
                                  int B, int H, int W, void* stream) {
  return hop::launch<64, true>(x, w, b, out, B, H, W, (cudaStream_t)stream);
}

// #6, second half: pooled bf16 [B,H2,W2,64], w [576,128] bf16, b [128] f32
// -> bf16 [B,H2,W2,128] (zero padding = the pooled map's zeroed SAME ring;
// conv3x3_hopper).  Any H2 and W2.
extern "C" int conv21_bf16(const void* p, const void* w, const void* b, void* out,
                           int B, int H2, int W2, void* stream) {
  return hop::launch<128, false>(p, w, b, out, B, H2, W2, (cudaStream_t)stream);
}

// conv3x3_hopper's geometry, for the wrapper to check against its own copy:
// conv1_2 strip columns and segment rows, conv2_1 strip columns and segment
// rows, halo, ring rows, shared-memory bytes of conv1_2 and of conv2_1.
extern "C" int stem_geometry(int* out) {
  out[0] = hop::HGeo<64>::kStrip;
  out[1] = hop::HGeo<64>::kSeg;
  out[2] = hop::HGeo<128>::kStrip;
  out[3] = hop::HGeo<128>::kSeg;
  out[4] = hop::kHalo;
  out[5] = hop::kRing;
  out[6] = hop::HGeo<64>::kSmem;
  out[7] = hop::HGeo<128>::kSmem;
  return 0;
}

// #7, step 1: xq int8 [B,H,W,64], sx [B], w int8 [576,64], sw [64], b [64]
// -> f32 pooled map [B,H/2,W/2,64] of relu(acc * (sx * sw) + b).
extern "C" int conv12_pool_s8(const void* xq, const void* sx, const void* w, const void* sw,
                              const void* b, void* out, int B, int H, int W, void* stream) {
  return launch<64, 1, true, kInS8, true>(xq, w, (const float*)b, (const float*)sx,
                                           (const float*)sw, out, B, H, W, 1,
                                           (cudaStream_t)stream);
}

// #7, step 2: f32 pooled map [B,H2,W2,64] -> s2 [B, ceil(H2/r2)].
extern "C" int requant_scales(const void* p, void* s2, int B, int H2, int W2, int r2,
                              void* stream) {
  const int nblk = (H2 + r2 - 1) / r2;
  if (B * nblk == 0) return cudaSuccess;
  requant_scales_kernel<<<B * nblk, 256, 0, (cudaStream_t)stream>>>(
      (const float*)p, (float*)s2, H2, W2, r2, nblk);
  return cudaGetLastError();
}

// #7, step 3: f32 pooled map, s2, w int8 [576,128], sw [128], b [128] ->
// bf16 [B,H2,W2,128] of relu(acc * (s2 * sw) + b), the input quantized on
// load with the output row's s2.
extern "C" int conv21_s8(const void* p, const void* s2, const void* w, const void* sw,
                         const void* b, void* out, int B, int H2, int W2, int r2,
                         void* stream) {
  return launch<128, 2, false, kInF32Quant, false>(p, w, (const float*)b, (const float*)s2,
                                                    (const float*)sw, out, B, H2, W2, r2,
                                                    (cudaStream_t)stream);
}
