// Seam tail of the CRAFT detector for Hopper (sm_90a): upconv4 + conv_cls.
//
// Replaces two TPU kernels of lightly_ocr_tpu/ops/pallas_tail.py:
//   _seam_kernel (#1, pallas_tail.py:258), behind fused_tail_scores_cs_seam:
//     seam_tail_launch;
//   _tail_kernel (#3, pallas_tail.py:166), behind fused_tail_scores_cs and
//     the legacy branch of fused_tail_scores_cs_seam: tail_launch, the same
//     chain from a formed 64-channel activation x [B, H2, W2, 64] bf16.
// seam_tail_launch's inputs, all NHWC and contiguous:
//   t   [B, H2, W2, 128] bf16  slice1 skip
//   ya  [B, H2/2, W2/2, 64] f32 quarter-res product y_lo @ k1[:64]
//   folded weights (bf16) and biases (f32) from ops/seam_tail.py tail_params
// Output: scores [B, H2, 2, W2] f32, channels-second.
//
// Arithmetic is the TPU kernel's: bf16 operands, f32 accumulation, bias and
// ReLU in f32, a cast to bf16 after every stage but the last
// (pallas_tail.py:101-105,381-383).  No library call.
//
// Bound on an H100 at b16 480x320: #1 is ~245 GFLOP of bf16 products
// (0.25 ms at 989 TFLOP/s) against ~0.8 GB of compulsory traffic (t, ya,
// scores: 0.24 ms at 3.35 TB/s); #3 is 205 GFLOP (0.21 ms) against 0.34 GB
// (x, scores: 0.10 ms).  Both are bound by tensor-core operations, so every
// product runs on the tensor cores and no intermediate goes to device memory.
//
// Design: one fused kernel per entry point, a line buffer walking down a
// strip.
// - MMA route: mma.sync.m16n8k16 (bf16 x bf16 -> f32) with ldmatrix.  Each
//   3x3 conv is an implicit GEMM, M = the 64 pixels of one row of the strip,
//   N = Cout, K = 9 taps x Cin.  Tap (dy, dx) reads the ring row of dy
//   shifted by dx pixels; ldmatrix takes one 16-byte row address per lane,
//   so a one-pixel shift costs nothing, where wgmma's canonical shared-
//   memory layout for A would break under it.  Pixels are stored with a
//   stride of Cin + 8 bf16 (144 or 80 bytes), so the 8 rows of every 8x8
//   ldmatrix tile fall in distinct banks.  The weights are staged once per
//   block transposed, [Cout][9 * Cin + 8], and read with ldmatrix as the
//   "col" B operand.  The seam front t @ k1b is the same GEMM with K = 128,
//   N = 64.  The head (1x1 16->16, 1x1 16->2 padded to N = 16) runs in the
//   registers of conv c4's warps: the f32 accumulator of an m16n8 pair is,
//   after bias, ReLU and the bf16 cast, the A fragment of the next k16
//   product.
// - Geometry: a block owns one sample, a strip of kTW = 56 output columns
//   and a segment of kSeg = 120 output rows.  Every layer works on the same
//   kSW = kTW + 2 * kHalo = 64 columns (4 m16 tiles); the layer L output is
//   right on columns [L, 64 - L) of the strip, so the 4-pixel halo (kHalo)
//   covers the four 3x3 convs, and the head keeps columns [4, 60).  Rows
//   run as a skewed pipeline: step i forms x row i, then conv a row i - 1,
//   conv c0 row i - 2, conv c2 row i - 3, and conv c4 + head row i - 4.
//   Each layer keeps its last 3 rows in a ring in shared memory, bf16 (4 for
//   x on the #3 entry, which prefetches into it).  A segment starts 4 rows
//   early and walks 8 rows more than it writes, so no row is recomputed
//   inside a segment; across segments 8 of 128 front rows are.  The grid
//   is B x ceil(W2 / 56) x ceil(H2 / 120) blocks, one per SM at a time
//   (384 at b16 480x320, about 2.9 waves on 132 SMs).
// - Shared memory (#1): transposed weights 103,680 B + biases 832 B; rings
//   x 3 x 66 x 72 x 2 = 28,512 B, a, c0, c2 3 x 66 x 40 x 2 = 15,840 B each;
//   the staged t row 64 x 136 x 2 = 17,408 B and the two ya rows 2 x 34 x 64
//   x 4 = 17,408 B: 215,360 B of the 232,448 a block may have.  (#3: no
//   k1b, t or ya; a 4-row x ring: 172,640 B.)  A ring row has 66 pixels:
//   the 64 of the strip and one zero pad each side.
// - Copies: the next step's input (t row and ya rows for #1, the x row for
//   #3) is fetched with cp.async while the current step's convs run; the
//   weights are loaded once per block.
// - Rezero: SAME padding means zeros outside the image at every layer, so
//   every epilogue writes 0, not relu(bias), at columns outside [0, W2), and
//   rows outside [0, H2) are written as zero rows.  Strip and segment edges
//   inside the image use real neighbours: the halo is computed, not padded.
// - The bilinear 2x upsample of ya (#1) reads ya columns
//   [cstart/2 - 1, cstart/2 + 33) of the block's two source rows, staged in
//   shared memory, and clamps only at the image edge, in the reference's
//   order (W taps first, then H taps, __fmul_rn/__fadd_rn).
// This first tensor-core version synchronises the block 5 times a row step
// and leaves conv c4's phase to 4 of its 8 warps; the layers run one after
// another, not overlapped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTW = 56;        // output columns of a strip
constexpr int kHalo = 4;       // columns (and rows) of halo: four 3x3 convs
constexpr int kSeg = 120;      // output rows of a segment
constexpr int kSW = kTW + 2 * kHalo;  // 64 computed columns = 4 m16 tiles
constexpr int kRW = kSW + 2;          // ring row: one zero pad each side
constexpr int kYaCols = kSW / 2 + 2;  // staged ya columns of a row

// Pixel strides (bf16) of the rings and the t stage, weight row strides.
constexpr int kPX = 64 + 8, kPA = 32 + 8, kPT = 128 + 8;
constexpr int kW1 = 128 + 8, kWA = 9 * 64 + 8, kW3 = 9 * 32 + 8, kWH = 16 + 8;

template <bool SEAM>
struct Smem {
  static constexpr int xslots = SEAM ? 3 : 4;
  // byte offsets
  static constexpr int w1 = 0;
  static constexpr int wa = w1 + (SEAM ? 64 * kW1 * 2 : 0);
  static constexpr int w0 = wa + 32 * kWA * 2;
  static constexpr int w2 = w0 + 32 * kW3 * 2;
  static constexpr int w4 = w2 + 32 * kW3 * 2;
  static constexpr int w6 = w4 + 16 * kW3 * 2;
  static constexpr int w8 = w6 + 16 * kWH * 2;
  static constexpr int bias = w8 + 16 * kWH * 2;  // f32: b1 64 ba 32 b0 32 b2 32 b4 16 b6 16 b8 16
  static constexpr int xr = bias + 208 * 4;
  static constexpr int ar = xr + xslots * kRW * kPX * 2;
  static constexpr int c0r = ar + 3 * kRW * kPA * 2;
  static constexpr int c2r = c0r + 3 * kRW * kPA * 2;
  static constexpr int ts = c2r + 3 * kRW * kPA * 2;
  static constexpr int ys = ts + (SEAM ? kSW * kPT * 2 : 0);
  static constexpr int total = ys + (SEAM ? 2 * kYaCols * 64 * 4 : 0);
};
static_assert(Smem<true>::total <= 232448, "seam tail: shared memory");
static_assert(Smem<true>::total == 215360 && Smem<false>::total == 172640, "budget in the note");

struct Args {
  const bf16* in;   // t [B,H2,W2,128] (#1) or x [B,H2,W2,64] (#3)
  const float* ya;  // [B,H2/2,W2/2,64] (#1)
  const bf16 *k1b, *wa, *w0, *w2, *w4, *w6, *w8;
  const float *b1, *ba, *b0, *b2, *b4, *b6, *b8;
  float* out;
  int H2, W2, nstrip, nseg;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// acc[NT][4] = A (16 pixels from m0) x W^T rows [n0, n0 + 8 NT).  KS = 3:
// a 3x3 conv over ring rows rows[0..2] (pixel p of the strip at ring index
// p + 1, stride PS); KS = 1: a 1x1 over rows[0] with no pad.  wT is
// [N][KS * KS * CIN + 8], k = tap * CIN + cin, tap = 3 dy + dx.
template <int CIN, int KS, int PS, int NT>
__device__ __forceinline__ void mma_rows(const bf16* const* rows, const bf16* wT, int m0, int n0,
                                         float (&acc)[NT][4]) {
  constexpr int WS = KS * KS * CIN + 8;
  const int lane = threadIdx.x & 31;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int akof = (lane >> 4) * 8;
  const int bn = (lane >> 4) * 8 + (lane & 7);
  const int bkof = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const bf16* abase = rows[dy] + (m0 + arow + dx) * PS + akof;
      const bf16* bbase = wT + (n0 + bn) * WS + (dy * KS + dx) * CIN + bkof;
#pragma unroll
      for (int kc = 0; kc < CIN / 16; ++kc) {
        uint32_t a[4];
        ldsm_x4(a, abase + kc * 16);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4(b, bbase + jp * 16 * WS + kc * 16);
          mma16816(acc[2 * jp], a, b[0], b[1]);
          mma16816(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// bf16(relu(acc + bias)) into a ring row, zero at columns outside the image.
template <int NT, int PS>
__device__ __forceinline__ void store_row(const float (&acc)[NT][4], const float* bias, bf16* row,
                                          int m0, int n0, int cstart, int W2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int ch = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + g + 8 * h;
      const int c = cstart + p;
      const bool in = c >= 0 && c < W2;
      const float v0 = in ? fmaxf(acc[j][2 * h] + bias[ch], 0.f) : 0.f;
      const float v1 = in ? fmaxf(acc[j][2 * h + 1] + bias[ch + 1], 0.f) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(row + (p + 1) * PS + ch) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// A ring row of zeros (a row outside the image).
template <int PS>
__device__ __forceinline__ void zero_row(bf16* row) {
  uint4* p = reinterpret_cast<uint4*>(row);
  for (int i = threadIdx.x; i < kRW * PS / 8; i += kThreads) p[i] = make_uint4(0, 0, 0, 0);
}

// w [K][N] (global, in, out) -> sT [n][k] with row stride WS, rows >= N untouched.
template <int K, int N, int WS>
__device__ __forceinline__ void load_wT(bf16* sT, const bf16* w) {
  for (int i = threadIdx.x; i < K * N; i += kThreads) sT[(i % N) * WS + i / N] = w[i];
}

// Ring slot of image row r (r >= -12) in a ring of n rows.
__device__ __forceinline__ int slot(int r, int n) { return (r + 12) % n; }
__device__ __forceinline__ int ring3(int r) { return slot(r, 3); }

// One 3x3 conv layer of the chain: output row r from the previous layer's
// ring (rows r - 1, r, r + 1), 32 output channels.
template <int CIN, int PIN>
__device__ __forceinline__ void conv_layer(const bf16* in_ring, int in_slots, const bf16* wT,
                                           const float* bias, bf16* out_ring, int r, int H2,
                                           int cstart, int W2) {
  bf16* orow = out_ring + ring3(r) * kRW * kPA;
  if (r < 0 || r >= H2) {
    zero_row<kPA>(orow);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 16;
  const bf16* rows[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    rows[d] = in_ring + slot(r - 1 + d, in_slots) * kRW * PIN;
  float acc[2][4];
  mma_rows<CIN, 3, PIN, 2>(rows, wT, m0, n0, acc);
  store_row<2, kPA>(acc, bias, orow, m0, n0, cstart, W2);
}

// conv c4 (32 -> 16) + bias + ReLU + bf16, then the head 1x1 16->16 + ReLU +
// bf16 and 1x1 16->2 + bias in f32, all in the registers of warps 0-3; the
// scores of row r go to out [B, H2, 2, W2] for the strip's 56 columns.
__device__ __forceinline__ void c4_head(const bf16* c2_ring, const bf16* w4T, const bf16* w6T,
                                        const bf16* w8T, const float* b4, const float* b6,
                                        const float* b8, float* out, int b, int r, int H2,
                                        int cstart, int W2) {
  const int warp = threadIdx.x >> 5;
  if (warp >= 4) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int m0 = warp * 16;
  const bf16* rows[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) rows[d] = c2_ring + ring3(r - 1 + d) * kRW * kPA;
  float acc[2][4];
  mma_rows<32, 3, kPA, 2>(rows, w4T, m0, 0, acc);
  // accumulator pair (16 channels) -> A fragment of a k16 product
  uint32_t a[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = 8 * j + 2 * q;
    a[2 * j] = pack_bf16(fmaxf(acc[j][0] + b4[ch], 0.f), fmaxf(acc[j][1] + b4[ch + 1], 0.f));
    a[2 * j + 1] = pack_bf16(fmaxf(acc[j][2] + b4[ch], 0.f), fmaxf(acc[j][3] + b4[ch + 1], 0.f));
  }
  const int bn = (lane >> 4) * 8 + (lane & 7), bkof = ((lane >> 3) & 1) * 8;
  uint32_t bw[4];
  ldsm_x4(bw, w6T + bn * kWH + bkof);
  float e[2][4] = {};
  mma16816(e[0], a, bw[0], bw[1]);
  mma16816(e[1], a, bw[2], bw[3]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int ch = 8 * j + 2 * q;
    a[2 * j] = pack_bf16(fmaxf(e[j][0] + b6[ch], 0.f), fmaxf(e[j][1] + b6[ch + 1], 0.f));
    a[2 * j + 1] = pack_bf16(fmaxf(e[j][2] + b6[ch], 0.f), fmaxf(e[j][3] + b6[ch + 1], 0.f));
  }
  ldsm_x4(bw, w8T + bn * kWH + bkof);
  float s[4] = {};
  mma16816(s, a, bw[0], bw[1]);
  if (q != 0) return;  // lanes with q = 0 hold output channels 0 and 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = m0 + g + 8 * h;
    const int c = cstart + p;
    if (p < kHalo || p >= kSW - kHalo || c >= W2) continue;
    float* o = out + ((size_t)(b * H2 + r) * 2) * W2 + c;
    o[0] = s[2 * h] + b8[0];
    o[W2] = s[2 * h + 1] + b8[1];
  }
}

// Fetch the step input for row r (cp.async; zeros where #3's x row is
// outside the image).  #1: t row r -> ts, ya source rows -> ys.  #3: x row
// r -> its slot of the 4-row x ring.
template <bool SEAM>
__device__ __forceinline__ void stage_row(const Args& A, unsigned char* smem, int b, int r,
                                          int cstart) {
  using S = Smem<SEAM>;
  const int H2 = A.H2, W2 = A.W2;
  if constexpr (SEAM) {
    if (r < 0 || r >= H2) return;  // the front writes a zero row itself
    bf16* ts = reinterpret_cast<bf16*>(smem + S::ts);
    const bf16* src = A.in + ((size_t)(b * H2 + r) * W2) * 128;
    for (int i = threadIdx.x; i < kSW * 16; i += kThreads) {
      const int p = i >> 4, k = i & 15, c = cstart + p;
      if (c >= 0 && c < W2) cp_async16(ts + p * kPT + k * 8, src + (size_t)c * 128 + k * 8);
    }
    const int H4 = H2 / 2, W4 = W2 / 2, kr = r >> 1;
    const int ra = (r & 1) ? kr : max(kr - 1, 0);
    const int rb = (r & 1) ? min(kr + 1, H4 - 1) : kr;
    float* ys = reinterpret_cast<float*>(smem + S::ys);
    const int k0 = cstart / 2 - 1;
    for (int i = threadIdx.x; i < 2 * kYaCols * 16; i += kThreads) {
      const int k = i & 15, qq = (i >> 4) % kYaCols, s = (i >> 4) / kYaCols;
      const int kc = k0 + qq;
      if (kc < 0 || kc >= W4) continue;
      const float* ysrc = A.ya + ((size_t)(b * H4 + (s ? rb : ra)) * W4 + kc) * 64 + k * 4;
      cp_async16(ys + (s * kYaCols + qq) * 64 + k * 4, ysrc);
    }
  } else {
    bf16* row = reinterpret_cast<bf16*>(smem + S::xr) + slot(r, 4) * kRW * kPX;
    const bool rin = r >= 0 && r < H2;
    const bf16* src = A.in + ((size_t)(b * H2 + (rin ? r : 0)) * W2) * 64;
    for (int i = threadIdx.x; i < kSW * 8; i += kThreads) {
      const int p = i >> 3, k = i & 7, c = cstart + p;
      bf16* dst = row + (p + 1) * kPX + k * 8;
      if (rin && c >= 0 && c < W2) cp_async16(dst, src + (size_t)c * 64 + k * 8);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// #1's front: x row r = bf16(relu(up2x(ya) + t @ k1b + b1)) into its ring.
__device__ __forceinline__ void seam_front(unsigned char* smem, int r, int H2, int W2, int cstart) {
  using S = Smem<true>;
  bf16* xrow = reinterpret_cast<bf16*>(smem + S::xr) + ring3(r) * kRW * kPX;
  if (r < 0 || r >= H2) {
    zero_row<kPX>(xrow);
    return;
  }
  const bf16* ts = reinterpret_cast<const bf16*>(smem + S::ts);
  const float* ys = reinterpret_cast<const float*>(smem + S::ys);
  const float* b1 = reinterpret_cast<const float*>(smem + S::bias);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const bf16* rows[1] = {ts};
  float acc[4][4];
  mma_rows<128, 1, kPT, 4>(rows, reinterpret_cast<const bf16*>(smem + S::w1), m0, n0, acc);
  // 2x bilinear upsample, half-pixel centres, in the reference's order:
  // W taps first (edge columns copy the edge input), then H taps (edge rows
  // blend the duplicated edge row, staged as ys row 0 / 1).
  const float wra = (r & 1) ? 0.75f : 0.25f, wrb = 1.f - wra;
  const int W4 = W2 / 2, k0 = cstart / 2 - 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = m0 + g + 8 * h;
    const int c = cstart + p;
    const bool in = c >= 0 && c < W2;
    const int kc = c >> 1;
    int ca, cb;
    float wca, wcb;
    if ((c & 1) == 0) {
      if (kc == 0) { ca = 0; cb = 0; wca = 0.f; wcb = 1.f; }
      else { ca = kc - 1; cb = kc; wca = 0.25f; wcb = 0.75f; }
    } else {
      if (kc == W4 - 1) { ca = kc; cb = kc; wca = 0.f; wcb = 1.f; }
      else { ca = kc; cb = kc + 1; wca = 0.75f; wcb = 0.25f; }
    }
    const float* y0a = ys + (ca - k0) * 64;
    const float* y0b = ys + (cb - k0) * 64;
    const float* y1a = y0a + kYaCols * 64;
    const float* y1b = y0b + kYaCols * 64;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = n0 + 8 * j + 2 * q;
      float v[2] = {0.f, 0.f};
      if (in) {
        const float2 pa = *reinterpret_cast<const float2*>(y0a + o);
        const float2 pb = *reinterpret_cast<const float2*>(y0b + o);
        const float2 qa = *reinterpret_cast<const float2*>(y1a + o);
        const float2 qb = *reinterpret_cast<const float2*>(y1b + o);
        const float h0[2] = {__fadd_rn(__fmul_rn(wca, pa.x), __fmul_rn(wcb, pb.x)),
                             __fadd_rn(__fmul_rn(wca, pa.y), __fmul_rn(wcb, pb.y))};
        const float h1[2] = {__fadd_rn(__fmul_rn(wca, qa.x), __fmul_rn(wcb, qb.x)),
                             __fadd_rn(__fmul_rn(wca, qa.y), __fmul_rn(wcb, qb.y))};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float up = __fadd_rn(__fmul_rn(wra, h0[u]), __fmul_rn(wrb, h1[u]));
          v[u] = fmaxf(__fadd_rn(__fadd_rn(up, acc[j][2 * h + u]), b1[o + u]), 0.f);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(xrow + (p + 1) * kPX + o) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

// The shared chain: one block = (sample, strip, segment); #1 adds the front.
template <bool SEAM>
__global__ void __launch_bounds__(kThreads, 1) tail_chain(const Args A) {
  using S = Smem<SEAM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int seg = blockIdx.x % A.nseg;
  const int strip = (blockIdx.x / A.nseg) % A.nstrip;
  const int b = blockIdx.x / (A.nseg * A.nstrip);
  const int H2 = A.H2, W2 = A.W2;
  const int cstart = strip * kTW - kHalo;
  const int s0 = seg * kSeg, s1 = min(s0 + kSeg, H2);

  {  // zero everything (ring pads, padded weight rows), then the weights
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < S::total / 16; i += kThreads) p[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if constexpr (SEAM) load_wT<128, 64, kW1>(reinterpret_cast<bf16*>(smem + S::w1), A.k1b);
  load_wT<9 * 64, 32, kWA>(reinterpret_cast<bf16*>(smem + S::wa), A.wa);
  load_wT<9 * 32, 32, kW3>(reinterpret_cast<bf16*>(smem + S::w0), A.w0);
  load_wT<9 * 32, 32, kW3>(reinterpret_cast<bf16*>(smem + S::w2), A.w2);
  load_wT<9 * 32, 16, kW3>(reinterpret_cast<bf16*>(smem + S::w4), A.w4);
  load_wT<16, 16, kWH>(reinterpret_cast<bf16*>(smem + S::w6), A.w6);
  load_wT<16, 2, kWH>(reinterpret_cast<bf16*>(smem + S::w8), A.w8);
  float* bias = reinterpret_cast<float*>(smem + S::bias);
  for (int i = threadIdx.x; i < 64; i += kThreads) {
    if constexpr (SEAM) bias[i] = A.b1[i];
    if (i < 32) {
      bias[64 + i] = A.ba[i];
      bias[96 + i] = A.b0[i];
      bias[128 + i] = A.b2[i];
    }
    if (i < 16) {
      bias[160 + i] = A.b4[i];
      bias[176 + i] = A.b6[i];
    }
    if (i < 2) bias[192 + i] = A.b8[i];
  }
  stage_row<SEAM>(A, smem, b, s0 - kHalo, cstart);

  const bf16* xr = reinterpret_cast<const bf16*>(smem + S::xr);
  bf16* ar = reinterpret_cast<bf16*>(smem + S::ar);
  bf16* c0r = reinterpret_cast<bf16*>(smem + S::c0r);
  bf16* c2r = reinterpret_cast<bf16*>(smem + S::c2r);
  for (int i = s0 - kHalo; i < s1 + kHalo; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if constexpr (SEAM) {
      seam_front(smem, i, H2, W2, cstart);
      __syncthreads();  // t and ya stage free, x row i formed
    }
    if (i + 1 < s1 + kHalo) stage_row<SEAM>(A, smem, b, i + 1, cstart);
    if (i >= s0 - 2)
      conv_layer<64, kPX>(xr, S::xslots, reinterpret_cast<const bf16*>(smem + S::wa),
                              bias + 64, ar, i - 1, H2, cstart, W2);
    __syncthreads();
    if (i >= s0)
      conv_layer<32, kPA>(ar, 3, reinterpret_cast<const bf16*>(smem + S::w0), bias + 96,
                              c0r, i - 2, H2, cstart, W2);
    __syncthreads();
    if (i >= s0 + 2)
      conv_layer<32, kPA>(c0r, 3, reinterpret_cast<const bf16*>(smem + S::w2), bias + 128,
                              c2r, i - 3, H2, cstart, W2);
    __syncthreads();
    if (i >= s0 + kHalo)
      c4_head(c2r, reinterpret_cast<const bf16*>(smem + S::w4),
              reinterpret_cast<const bf16*>(smem + S::w6),
              reinterpret_cast<const bf16*>(smem + S::w8), bias + 160, bias + 176, bias + 192,
              A.out, b, i - 4, H2, cstart, W2);
  }
}

template <bool SEAM>
int launch(Args A, int B, cudaStream_t s) {
  if (B <= 0 || A.H2 <= 0 || A.W2 <= 0 || (A.H2 & 1) || (A.W2 & 1)) return cudaErrorInvalidValue;
  A.nstrip = (A.W2 + kTW - 1) / kTW;
  A.nseg = (A.H2 + kSeg - 1) / kSeg;
  constexpr int smem = Smem<SEAM>::total;
  cudaError_t err = cudaFuncSetAttribute(tail_chain<SEAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tail_chain<SEAM><<<B * A.nstrip * A.nseg, kThreads, smem, s>>>(A);
  return cudaGetLastError();
}

}  // namespace

// The kernel's geometry, for the wrapper to check against its own copy:
// strip columns, segment rows, halo.
extern "C" int seam_tail_geometry(int* out) {
  out[0] = kTW;
  out[1] = kSeg;
  out[2] = kHalo;
  return 0;
}

// #1: the whole tail on `stream`, one launch.  H2 and W2 must be even.
// Returns the launch error (0 = cudaSuccess).
extern "C" int seam_tail_launch(
    const void* t, const void* ya, const void* k1b, const void* b1,
    const void* wa, const void* ba, const void* w0, const void* b0,
    const void* w2, const void* b2, const void* w4, const void* b4,
    const void* w6, const void* b6, const void* w8, const void* b8,
    void* out, int B, int H2, int W2, void* stream) {
  Args A = {(const bf16*)t, (const float*)ya, (const bf16*)k1b, (const bf16*)wa,
            (const bf16*)w0, (const bf16*)w2, (const bf16*)w4, (const bf16*)w6,
            (const bf16*)w8, (const float*)b1, (const float*)ba, (const float*)b0,
            (const float*)b2, (const float*)b4, (const float*)b6, (const float*)b8,
            (float*)out, H2, W2, 0, 0};
  return launch<true>(A, B, static_cast<cudaStream_t>(stream));
}

// #3: the chain alone from a formed x [B,H2,W2,64] bf16 (the TPU kernel's
// input after its XLA 1x1), out [B,H2,2,W2] f32, one launch.  H2 and W2
// must be even.
extern "C" int tail_launch(
    const void* x, const void* wa, const void* ba, const void* w0, const void* b0,
    const void* w2, const void* b2, const void* w4, const void* b4,
    const void* w6, const void* b6, const void* w8, const void* b8,
    void* out, int B, int H2, int W2, void* stream) {
  Args A = {(const bf16*)x, nullptr, nullptr, (const bf16*)wa, (const bf16*)w0,
            (const bf16*)w2, (const bf16*)w4, (const bf16*)w6, (const bf16*)w8, nullptr,
            (const float*)ba, (const float*)b0, (const float*)b2, (const float*)b4,
            (const float*)b6, (const float*)b8, (float*)out, H2, W2, 0, 0};
  return launch<false>(A, B, static_cast<cudaStream_t>(stream));
}
