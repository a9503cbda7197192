// Fused conv1_2 + 2x2 pool detector front for Hopper (sm_90a).
//
// Replaces four TPU kernels of lightly_ocr_tpu/ops/pallas_stem.py:
//   _stem_kernel              (#4) conv1_2 + BN + ReLU at full resolution
//   _conv_pool_kernel         (#5) conv1_2 + BN + ReLU + 2x2 max pool
//   _conv_pool_conv_kernel    (#6) #5, then conv2_1 + BN + ReLU
//   _conv_pool_conv_q_kernel  (#7) the w8a8 form of #6
// All four start with the same 3x3 64->64 convolution (VGG conv1_2) on the
// conv1_1 activation x0 [B, H, W, 64] NHWC.  #5-#7 never write its full-
// resolution output to device memory (1.26 GB of bf16 at b16 960x640): the
// 2x2 pool runs in the epilogue and only the pooled map [B, H/2, W/2, 64] is
// stored.  #4 is the same conv without the pool and writes that full-
// resolution map, which the trunk pools.  BN is folded into the weights by
// ops/stem.py.
//
// One templated implicit-GEMM kernel, conv3x3_mma, does every convolution:
// M = output pixels, N = output channels, K = 9 taps x 64 input channels.
// A block stages its input tile (2 output rows x TC columns plus the 3x3
// halo, zero outside the image = SAME padding) and all 576 x COUT weights in
// shared memory, and walks tiles with a grid-stride loop so the weights are
// loaded once per block.  Each warp owns 16 columns x 2 rows x (COUT / WN)
// channels and runs nvcuda::wmma 16x16x16 products: bf16 x bf16 -> f32, or
// s8 x s8 -> s32.  The epilogue goes through a per-warp staging tile.
//
// Launches (extern "C", below):
//   #4  conv12_bf16                 x0 bf16 -> full-resolution bf16
//   #5  conv12_pool_bf16            x0 bf16 -> pooled bf16
//   #6  conv12_pool_bf16, conv21_bf16  (conv2_1 on the bf16 pooled map)
//   #7  quantize_per_sample_bf16 (x0 -> xq int8 and sx, per sample),
//       conv12_pool_s8 (xq int8 -> dequantized pooled map in f32),
//       requant_scales (s2 per sample and row block: amax over the block's
//       pooled rows with a one-row halo, all columns),
//       conv21_s8 (quantizes the f32 pooled map on load with the OUTPUT
//       row's block scale, as the TPU kernel quantizes its slab, halo rows
//       included, with the reading block's s2).
// Rounding follows the TPU kernels: bf16 operands, f32 sums, + f32 bias,
// ReLU, pool in f32, one cast.  The int8 epilogues round as XLA runs the JAX
// kernel: y * (s * sw) + b is one FMA (__fmaf_rn after __fmul_rn(s, sw)),
// the requant multiplies by the correctly rounded reciprocal of s2, then
// rounds half to even, and the per-sample scale sx = max(amax, 1e-12) / 127
// is a multiply by the float constant 1/127 (XLA's rewrite of a division by
// a constant in the jitted wrapper; s2, taken in the TPU kernel, is a true
// division); so #7 matches its plain PyTorch version (ops/stem.py) bit for
// bit: every int8 product and int32 sum is exact.
//
// Bound on an H100 at b16 960x640: conv1_2 is 0.72 TFLOP and conv2_1 0.36
// TFLOP, so #5-#7 are bound by tensor-core operations (about 0.73 ms for
// #5 and 1.1 ms for #6 in bf16, 0.55 ms for #7 at the int8 rate).  #4 moves
// 2.5 GB (x0 in, the full-resolution map out), 0.75 ms at 3.35 TB/s, just
// above its 0.73 ms of operations: it is bound by bytes.  This first
// version uses mma.sync through wmma with no copy/compute overlap (one or
// two blocks per SM), so it sits well above that bound; wgmma with a TMA
// ring is the next step.
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
// bf16 [B,H,W,64] of relu(conv3x3(x0) + b), zero padding.  Any H; the
// column tiles of 128 are masked, so any W (the wrapper asks W % 8 == 0, as
// the TPU kernel does).
extern "C" int conv12_bf16(const void* x, const void* w, const void* b, void* out,
                           int B, int H, int W, void* stream) {
  return launch<64, 1, false, kInBf16, false>(x, w, (const float*)b, nullptr, nullptr, out,
                                               B, H, W, 1, (cudaStream_t)stream);
}

// #5 and the first half of #6: x0 bf16 [B,H,W,64], w [576,64] bf16 (tap-
// major K), b [64] f32 -> pooled bf16 [B,H/2,W/2,64].  H even, W % 16 == 0.
extern "C" int conv12_pool_bf16(const void* x, const void* w, const void* b, void* out,
                                int B, int H, int W, void* stream) {
  return launch<64, 1, true, kInBf16, false>(x, w, (const float*)b, nullptr, nullptr, out,
                                              B, H, W, 1, (cudaStream_t)stream);
}

// #6, second half: pooled bf16 [B,H2,W2,64], w [576,128] bf16, b [128] f32
// -> bf16 [B,H2,W2,128] (zero padding = the pooled map's zeroed SAME ring).
extern "C" int conv21_bf16(const void* p, const void* w, const void* b, void* out,
                           int B, int H2, int W2, void* stream) {
  return launch<128, 2, false, kInBf16, false>(p, w, (const float*)b, nullptr, nullptr, out,
                                                B, H2, W2, 1, (cudaStream_t)stream);
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
