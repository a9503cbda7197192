// Seam tail of the CRAFT detector for Hopper (sm_90a): upconv4 + conv_cls.
//
// Replaces two TPU kernels of lightly_ocr_tpu/ops/pallas_tail.py:
//   _seam_kernel (#1), behind fused_tail_scores_cs_seam: seam_tail_launch;
//   _tail_kernel (#3), behind fused_tail_scores_cs and the legacy branch of
//     fused_tail_scores_cs_seam: tail_launch, the same chain from a formed
//     64-channel activation x [B, H2, W2, 64] bf16 (launches 2-5 below).
// seam_tail_launch's inputs, all NHWC and contiguous:
//   t   [B, H2, W2, 128] bf16  slice1 skip
//   ya  [B, H2/2, W2/2, 64] f32 quarter-res product y_lo @ k1[:64]
//   folded weights (bf16) and biases (f32) from ops/seam_tail.py tail_params
// Output: scores [B, H2, 2, W2] f32, channels-second.
//
// Arithmetic is the TPU kernel's: bf16 operands, f32 accumulation, bias and
// ReLU in f32, a cast to bf16 after every stage but the last
// (pallas_tail.py:101-105,381-383).  Every product runs in this file on the
// CUDA cores in f32 FMAs; no library call.
//
// Design (first, simple version): a short sequence of launches
//   1. seam_front: 2x bilinear upsample of ya + t @ k1b + b1, ReLU -> xs bf16
//      (one thread per pixel, the 128x64 weight in shared memory);
//   2. conv3x3<64,32>, conv3x3<32,32> twice, conv3x3<32,16> with the two head
//      1x1s fused into its epilogue (one thread per two adjacent pixels, the
//      tap-major [9][cin][cout] weights in shared memory as f32, zero padding
//      at the image edge = the SAME convs of the reference).
// Each kernel walks its pixels with a grid-stride loop over a grid of a few
// blocks per SM, so the weights are staged into shared memory once per block.
// Bound on an H100 at b16 480x320: ~245 GFLOP of bf16 products (0.25 ms at
// 989 TFLOP/s) against ~0.8 GB of compulsory traffic (0.24 ms at 3.35 TB/s),
// so it is compute-bound for a tensor-core kernel (tail_launch: 205 GFLOP,
// 0.21 ms, against 0.34 GB, 0.10 ms); this version runs the
// products as f32 FMAs on the CUDA cores and keeps the intermediates in
// device memory, so it sits well above that bound.  Tensor cores (wgmma) and
// one fused kernel with a halo are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 consecutive bf16 (16 bytes) -> 8 floats.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// 8 floats -> 8 bf16 (16 bytes).
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__global__ void __launch_bounds__(kThreads)
seam_front(const bf16* __restrict__ t, const float* __restrict__ ya,
           const bf16* __restrict__ k1b, const float* __restrict__ b1,
           bf16* __restrict__ xs, int B, int H2, int W2) {
  __shared__ float sw[128 * 64];
  __shared__ float sb[64];
  for (int i = threadIdx.x; i < 128 * 64; i += blockDim.x) sw[i] = __bfloat162float(k1b[i]);
  if (threadIdx.x < 64) sb[threadIdx.x] = b1[threadIdx.x];
  __syncthreads();

  const int H4 = H2 / 2, W4 = W2 / 2;
  const long long npix = (long long)B * H2 * W2;
  for (long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x; pix < npix;
       pix += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(pix % W2);
    const long long rest = pix / W2;
    const int r = (int)(rest % H2);
    const int b = (int)(rest / H2);

    float acc[64];
#pragma unroll
    for (int o = 0; o < 64; ++o) acc[o] = 0.f;
    const bf16* tp = t + pix * 128;
    for (int k = 0; k < 128; k += 8) {
      float xv[8];
      load8(tp + k, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4* w4 = reinterpret_cast<const float4*>(sw + (k + j) * 64);
#pragma unroll
        for (int o = 0; o < 16; ++o) {
          const float4 w = w4[o];
          acc[4 * o + 0] += xv[j] * w.x;
          acc[4 * o + 1] += xv[j] * w.y;
          acc[4 * o + 2] += xv[j] * w.z;
          acc[4 * o + 3] += xv[j] * w.w;
        }
      }
    }

    // 2x bilinear upsample, half-pixel centres, in the reference's order:
    // W taps first (edge columns copy the edge input), then H taps (edge
    // rows blend the duplicated edge row).
    const int kr = r >> 1, kc = c >> 1;
    int ra, rb, ca, cb;
    float wra, wrb, wca, wcb;
    if ((r & 1) == 0) { ra = max(kr - 1, 0); rb = kr; wra = 0.25f; wrb = 0.75f; }
    else { ra = kr; rb = min(kr + 1, H4 - 1); wra = 0.75f; wrb = 0.25f; }
    if ((c & 1) == 0) {
      if (kc == 0) { ca = 0; cb = 0; wca = 0.f; wcb = 1.f; }
      else { ca = kc - 1; cb = kc; wca = 0.25f; wcb = 0.75f; }
    } else {
      if (kc == W4 - 1) { ca = kc; cb = kc; wca = 0.f; wcb = 1.f; }
      else { ca = kc; cb = kc + 1; wca = 0.75f; wcb = 0.25f; }
    }
    const float* y0 = ya + ((long long)b * H4 + ra) * W4 * 64;
    const float* y1 = ya + ((long long)b * H4 + rb) * W4 * 64;
    bf16* xp = xs + pix * 64;
    for (int o8 = 0; o8 < 64; o8 += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o8 + j;
        const float h0 = __fadd_rn(__fmul_rn(wca, y0[ca * 64 + o]), __fmul_rn(wcb, y0[cb * 64 + o]));
        const float h1 = __fadd_rn(__fmul_rn(wca, y1[ca * 64 + o]), __fmul_rn(wcb, y1[cb * 64 + o]));
        const float up = __fadd_rn(__fmul_rn(wra, h0), __fmul_rn(wrb, h1));
        v[j] = fmaxf((up + acc[o]) + sb[o], 0.f);
      }
      store8(xp + o8, v);
    }
  }
}

// Head: 1x1 16->16 + ReLU (bf16), 1x1 16->2, channels-second f32 store.
__device__ __forceinline__ void head(const float* v, const float* s6, const float* sb6,
                                     const float* s8, const float* sb8, float* out,
                                     long long row_base, int W, int c) {
  float e[16];
#pragma unroll
  for (int o = 0; o < 16; ++o) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) a += v[i] * s6[i * 16 + o];
    e[o] = round_bf16(fmaxf(a + sb6[o], 0.f));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) a += e[i] * s8[i * 2 + k];
    out[(row_base * 2 + k) * W + c] = a + sb8[k];
  }
}

template <int CIN, int COUT, bool HEAD>
constexpr int conv_smem_floats() {
  return 9 * CIN * COUT + COUT + (HEAD ? 16 * 16 + 16 + 16 * 2 + 2 : 0);
}

template <int CIN, int COUT, bool HEAD>
__global__ void __launch_bounds__(kThreads)
conv3x3(const bf16* __restrict__ x, const bf16* __restrict__ w,
        const float* __restrict__ bias, bf16* __restrict__ y,
        const bf16* __restrict__ w6, const float* __restrict__ b6,
        const bf16* __restrict__ w8, const float* __restrict__ b8,
        float* __restrict__ out, int B, int H, int W) {
  extern __shared__ float smem[];
  float* sw = smem;
  float* sb = sw + 9 * CIN * COUT;
  float* s6 = sb + COUT;
  float* sb6 = s6 + 256;
  float* s8 = sb6 + 16;
  float* sb8 = s8 + 32;
  for (int i = threadIdx.x; i < 9 * CIN * COUT; i += blockDim.x) sw[i] = __bfloat162float(w[i]);
  if (threadIdx.x < COUT) sb[threadIdx.x] = bias[threadIdx.x];
  if (HEAD) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s6[i] = __bfloat162float(w6[i]);
    if (threadIdx.x < 16) sb6[threadIdx.x] = b6[threadIdx.x];
    if (threadIdx.x < 32) s8[threadIdx.x] = __bfloat162float(w8[threadIdx.x]);
    if (threadIdx.x < 2) sb8[threadIdx.x] = b8[threadIdx.x];
  }
  __syncthreads();

  const int Wp = W / 2;
  const long long total = (long long)B * H * Wp;
  for (long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x; id < total;
       id += (long long)gridDim.x * blockDim.x) {
    const int c0 = 2 * (int)(id % Wp);
    const long long rest = id / Wp;  // b * H + r
    const int r = (int)(rest % H);
    const long long img = rest - r;  // b * H

    float acc0[COUT], acc1[COUT];
#pragma unroll
    for (int o = 0; o < COUT; ++o) { acc0[o] = 0.f; acc1[o] = 0.f; }

    for (int dy = 0; dy < 3; ++dy) {
      const int rr = r + dy - 1;
      if (rr < 0 || rr >= H) continue;
      const bf16* row = x + (img + rr) * W * CIN;
      for (int dx = 0; dx < 3; ++dx) {
        const int ca = c0 + dx - 1;  // column read by pixel c0
        const int cb = ca + 1;       // column read by pixel c0 + 1
        const bool va = ca >= 0, vb = cb < W;
        const float* wt = sw + (dy * 3 + dx) * CIN * COUT;
        for (int k = 0; k < CIN; k += 8) {
          float xa[8], xb[8];
          if (va) load8(row + (long long)ca * CIN + k, xa);
          else {
#pragma unroll
            for (int j = 0; j < 8; ++j) xa[j] = 0.f;
          }
          if (vb) load8(row + (long long)cb * CIN + k, xb);
          else {
#pragma unroll
            for (int j = 0; j < 8; ++j) xb[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4* w4 = reinterpret_cast<const float4*>(wt + (k + j) * COUT);
#pragma unroll
            for (int o = 0; o < COUT / 4; ++o) {
              const float4 wv = w4[o];
              acc0[4 * o + 0] += xa[j] * wv.x;
              acc0[4 * o + 1] += xa[j] * wv.y;
              acc0[4 * o + 2] += xa[j] * wv.z;
              acc0[4 * o + 3] += xa[j] * wv.w;
              acc1[4 * o + 0] += xb[j] * wv.x;
              acc1[4 * o + 1] += xb[j] * wv.y;
              acc1[4 * o + 2] += xb[j] * wv.z;
              acc1[4 * o + 3] += xb[j] * wv.w;
            }
          }
        }
      }
    }

#pragma unroll
    for (int o = 0; o < COUT; ++o) {
      acc0[o] = round_bf16(fmaxf(acc0[o] + sb[o], 0.f));
      acc1[o] = round_bf16(fmaxf(acc1[o] + sb[o], 0.f));
    }
    if (HEAD) {
      head(acc0, s6, sb6, s8, sb8, out, rest, W, c0);
      head(acc1, s6, sb6, s8, sb8, out, rest, W, c0 + 1);
    } else {
      bf16* yp = y + ((rest * W) + c0) * COUT;
#pragma unroll
      for (int o = 0; o < COUT; o += 8) {
        store8(yp + o, acc0 + o);
        store8(yp + COUT + o, acc1 + o);
      }
    }
  }
}

int grid_for(long long items) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (items + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 8;
  return (int)(blocks < cap ? blocks : cap);
}

template <int CIN, int COUT, bool HEAD>
cudaError_t launch_conv(const bf16* x, const bf16* w, const float* bias, bf16* y,
                        const bf16* w6, const float* b6, const bf16* w8, const float* b8,
                        float* out, int B, int H, int W, cudaStream_t s) {
  const int smem = conv_smem_floats<CIN, COUT, HEAD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(conv3x3<CIN, COUT, HEAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv3x3<CIN, COUT, HEAD><<<grid_for((long long)B * H * (W / 2)), kThreads, smem, s>>>(
      x, w, bias, y, w6, b6, w8, b8, out, B, H, W);
  return cudaGetLastError();
}

// upconv4 3x3 64->32 and conv_cls from x [B,H2,W2,64]: four launches.
cudaError_t tail_chain(const bf16* x, const bf16* wa, const float* ba, const bf16* w0,
                       const float* b0, const bf16* w2, const float* b2, const bf16* w4,
                       const float* b4, const bf16* w6, const float* b6, const bf16* w8,
                       const float* b8, bf16* bufa, bf16* bufb, float* out, int B, int H2,
                       int W2, cudaStream_t s) {
  const bf16* none = nullptr;
  const float* nonef = nullptr;
  cudaError_t err = launch_conv<64, 32, false>(x, wa, ba, bufa, none, nonef, none, nonef,
                                               nullptr, B, H2, W2, s);
  if (err != cudaSuccess) return err;
  err = launch_conv<32, 32, false>(bufa, w0, b0, bufb, none, nonef, none, nonef, nullptr,
                                   B, H2, W2, s);
  if (err != cudaSuccess) return err;
  err = launch_conv<32, 32, false>(bufb, w2, b2, bufa, none, nonef, none, nonef, nullptr,
                                   B, H2, W2, s);
  if (err != cudaSuccess) return err;
  return launch_conv<32, 16, true>(bufa, w4, b4, nullptr, w6, b6, w8, b8, out, B, H2, W2, s);
}

}  // namespace

// Runs the whole tail on `stream`; xs [B,H2,W2,64], bufa/bufb [B,H2,W2,32]
// bf16 are scratch from the caller.  H2 and W2 must be even.  Returns the
// first launch error (0 = cudaSuccess).
extern "C" int seam_tail_launch(
    const void* t, const void* ya, const void* k1b, const void* b1,
    const void* wa, const void* ba, const void* w0, const void* b0,
    const void* w2, const void* b2, const void* w4, const void* b4,
    const void* w6, const void* b6, const void* w8, const void* b8,
    void* xs, void* bufa, void* bufb, void* out, int B, int H2, int W2,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  seam_front<<<grid_for((long long)B * H2 * W2), kThreads, 0, s>>>(
      (const bf16*)t, (const float*)ya, (const bf16*)k1b, (const float*)b1,
      (bf16*)xs, B, H2, W2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tail_chain((const bf16*)xs, (const bf16*)wa, (const float*)ba, (const bf16*)w0,
                    (const float*)b0, (const bf16*)w2, (const float*)b2, (const bf16*)w4,
                    (const float*)b4, (const bf16*)w6, (const float*)b6, (const bf16*)w8,
                    (const float*)b8, (bf16*)bufa, (bf16*)bufb, (float*)out, B, H2, W2, s);
}

// #3: the chain alone from a formed x [B,H2,W2,64] bf16 (the TPU kernel's
// input after its XLA 1x1); bufa/bufb [B,H2,W2,32] bf16 scratch, out
// [B,H2,2,W2] f32.  H2 and W2 must be even.
extern "C" int tail_launch(
    const void* x, const void* wa, const void* ba, const void* w0, const void* b0,
    const void* w2, const void* b2, const void* w4, const void* b4,
    const void* w6, const void* b6, const void* w8, const void* b8,
    void* bufa, void* bufb, void* out, int B, int H2, int W2, void* stream) {
  return tail_chain((const bf16*)x, (const bf16*)wa, (const float*)ba, (const bf16*)w0,
                    (const float*)b0, (const bf16*)w2, (const float*)b2, (const bf16*)w4,
                    (const float*)b4, (const bf16*)w6, (const float*)b6, (const bf16*)w8,
                    (const float*)b8, (bf16*)bufa, (bf16*)bufb, (float*)out, B, H2, W2,
                    static_cast<cudaStream_t>(stream));
}
