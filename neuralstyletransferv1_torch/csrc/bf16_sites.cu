// K9a–K9e — the bf16 fused sites of the Johnson net.
//
// Replaces the TPU kernels of neuralstyletransferv1_tpu/models/s2d2_sites.py:
//   K9a d2_site       (_d2_kernel)   in4 affine + ReLU → deconv2 as the 3x3 phase conv 64→128
//                                    over an edge halo → bf16 raw + [Σ, Σ²]
//   K9c c2_site_bf16  (_c2_kernel)   in1 affine + ReLU → conv2, 3x3 stride 2, 32→64 → raw + sums
//   K9d c3_site_bf16  (_c3_kernel)   in2 affine + ReLU → conv3, 3x3 stride 2, 64→128 → raw + sums
//   K9e d3_rows       (_d3_kernel)   in5 affine + ReLU → deconv3's tap-packed 1x5 conv to 60
//                                    lanes over the 4-pixel reflect halo → bf16 rows
//   K9b d3_sum_site   (_d3s_kernel)  the same rows, kept on chip, then the 5-row dy-sum in f32
//                                    + bias → 12 bf16 lanes
// Two templated cores. site_kernel_bf16 is K9a/K9c/K9d: a 3x3 conv at stride 1
// (edge-copy halo) or 2 (pixel-reflect halo; an even size never reads the
// bottom or right pad) of bf16 activations that the prologue makes from the
// raw input, x' = bf16(max(f32(x)*a + c, 0)) with the product and the sum
// rounded separately; f32 accumulation; the epilogue adds the bias in f32,
// stores bf16 and sums [Σ, Σ²] of the f32 values before that round. The TPU
// kernels' strips, junk columns, halo buffer, garbage row/column with its
// fixup and 2x2 block packing are layout and are not carried over: conv2 and
// conv3 are pixel convs (each pixel tap sits once in the TPU's block weights).
// rows_kernel_bf16 is K9b/K9e: the 1x5 conv of the 128-channel space-to-depth
// tensor (4 phases x 32) to 60 lanes (5 kernel rows x 12, padded to 64 with
// zero weights). Its halo is the 4-pixel reflect of the pixels, which on the
// block grid permutes the phases: the prologue reads it through its index map
// (block R phase u is pixel 2R+u; reflect the pixel; split again), so no
// padded tensor exists. K9e writes each conv row's 60 lanes as bf16 for the
// H+4 rows of the padded grid; K9b keeps 16 conv rows in shared memory and
// writes, for its 12 output rows, bf16(Σ_dy rows[r+dy][12*dy+o] + bias[o]),
// the sum in f32 in dy order.
//
// Both cores multiply on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
// accumulate): M = 16 neighbouring output pixels of a row, N = 8 output
// channels, K = 16 input channels of one tap. A block is 256 threads = 8
// warps on 64 output channels; a warp owns one output row of the tile (two
// conv rows in K9b) and all 8 channel tiles, i.e. 64 f32 accumulators a
// thread. The activated input tile sits in shared memory as bf16 with the
// channels innermost and a pixel stride padded so that the eight pixels a
// fragment load touches fall in different banks; the weights, repacked on the
// host to [tap][co][c], are staged one kernel row (site_kernel_bf16) or one tap
// (rows_kernel_bf16) at a time. Fragments are plain 32-bit shared-memory loads.
// Products of two bf16 values are exact in f32, so only the order of the f32
// accumulation differs from any other implementation.
//
// The statistics are deterministic: per thread in a fixed order, lanes by
// shuffle, warps in order, then a [B, tiles, 2, CO] buffer that a second
// kernel reduces over tiles in order in double. No float atomics.
//
// What bounds them on an H100 (1080p, B = 8): K9a is 3.06e11 MAC = 0.62 ms at
// the 989 TFLOP/s bf16 peak against 0.475 ms for its 1.59 GB: operations; the
// other four move 0.8-1.6 GB for 0.76-1.6e11 MAC: bytes (0.24-0.48 ms). This
// code feeds the MMAs from shared memory with scalar loads (2.5-3 loads an
// MMA), which bounds it near a quarter of the tensor-core peak; ldmatrix,
// TMA-fed tiles and wgmma are later work.
//
// Two more kernels answer the TPU package's bf16 megakernel experiments:
//   K10 fused_conv  (experiments/mk1_fusedconv.py fused_conv; mk2/mk3/mk5's
//                   build tile the same function) the res-block site: a
//                   prologue on every position read of a PRE-PADDED input
//                   (f32 affine + ReLU, none, or the affine in bf16
//                   arithmetic) → 3x3 conv 128→128 → + bias → bf16 and [Σ, Σ²]
//                   (or no statistics). site_kernel_bf16<128, 1, true, ...>:
//                   the halo is whatever the caller padded, so the tile is read
//                   as given; the weights come as mk1's [9][C][CO] and are
//                   transposed while they are staged, one tap at a time (a
//                   kernel row of 128-channel weights, 52 KB, would leave one
//                   block per SM: per tap the block takes 115 KB, two a SM).
//                   3.06e11 FLOP over 0.54 GB at [8,270,480,128]: operations.
//   K11 c1_site     (experiments/mk13_c1.py c1_site) Johnson's conv1 in its f=2
//                   block form: the 5x5 conv 12→128 of the 4-px phase-reflect-
//                   padded space-to-depth image, f32 accumulation + bias → bf16.
//                   One tap's K is 12 channels; the five dx taps of a kernel row
//                   pack into K = 64 (60 + 4 zero weights) with no copy at all:
//                   a staged input row holds its pixels' 12 channels back to
//                   back, so output pixel x's packed row is the 60 contiguous
//                   values from pixel x on. 3.19e11 FLOP, but the 1.06 GB
//                   output bounds it (bytes): the tile is staged in shared
//                   memory and leaves in 16-byte coalesced stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCOT = 64;          // output channels per block
constexpr int kNT = kCOT / 8;     // n-tiles of the MMA per warp
constexpr int kTH = 8;            // output rows per site_kernel_bf16 block (one per warp)

// D += A(16x16, row) * B(16x8, col), bf16 operands, f32 accumulators.
// Lane l = 4*g + t holds: a0 (row g, k 2t..2t+1), a1 (row g+8, same k),
// a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..); b0 (k 2t..2t+1, n g),
// b1 (k 2t+8.., n g); d0/d1 (row g, n 2t / 2t+1), d2/d3 (row g+8, same n).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Source index of halo position i: pixel reflect (halo 0) or edge copy
// (halo 1), clamped into the image (the padding rows of a partial tile).
__device__ __forceinline__ int src_index(int i, int n, int halo) {
  if (halo == 0) {
    i = i < 0 ? -i : i;
    i = i >= n ? 2 * n - 2 - i : i;
  }
  return min(max(i, 0), n - 1);
}

// 4 raw bf16 channels → bf16(max(x*a + c, 0)), packed in two words
__device__ __forceinline__ uint2 activate4(const __nv_bfloat16* p, const float* s_a,
                                           const float* s_c, int ch0) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  float v[4] = {__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = fmaxf(__fadd_rn(__fmul_rn(v[k], s_a[ch0 + k]), s_c[ch0 + k]), 0.0f);
  uint2 out;
  *reinterpret_cast<__nv_bfloat162*>(&out.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&out.y) = __floats2bfloat162_rn(v[2], v[3]);
  return out;
}

// K10's prologue forms: mk1's f32 affine + ReLU, none (the raw input), and
// mk5's "bf16": x·bf16(a) → bf16, + bf16(c) → bf16, max 0. Each bf16 operation
// is done in f32 and rounded: a product or sum of two bf16 values is exact in
// f32 (or, for a sum, off by less than a bf16 half ulp), so this is the
// correctly rounded bf16 arithmetic, with no fused multiply-add.
enum { kProF32 = 0, kProNone = 1, kProBf16 = 2 };

template <int PRO>
__device__ __forceinline__ uint2 prologue4(const __nv_bfloat16* p, const float* s_a,
                                           const float* s_c, int ch0) {
  if (PRO == kProF32) return activate4(p, s_a, s_c, ch0);
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  if (PRO == kProNone) return raw;
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  float v[4] = {__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a = __bfloat162float(__float2bfloat16_rn(s_a[ch0 + k]));
    const float c = __bfloat162float(__float2bfloat16_rn(s_c[ch0 + k]));
    const float m = __bfloat162float(__float2bfloat16_rn(__fmul_rn(v[k], a)));
    v[k] = fmaxf(__bfloat162float(__float2bfloat16_rn(__fadd_rn(m, c))), 0.0f);
  }
  uint2 out;  // every v[k] is a bf16 value: the rounds below are exact
  *reinterpret_cast<__nv_bfloat162*>(&out.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&out.y) = __floats2bfloat162_rn(v[2], v[3]);
  return out;
}

// One k-sweep of a tap for NM m-tiles of a warp: xr[j] points at the word of
// m-tile j's pixel row g, channel 0; PR is the word stride between pixel rows
// g and g+1 of the fragment (the pixel stride times the conv stride).
template <int C, int NM, int PR, int PSW>
__device__ __forceinline__ void tap_mma(float (&acc)[NM][kNT][4],
                                        const uint32_t* (&xr)[NM], const uint32_t* wr,
                                        int g, int t) {
#pragma unroll
  for (int k0 = 0; k0 < C / 16; ++k0) {
    uint32_t a[NM][4];
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      const uint32_t* base = xr[j] + 8 * k0 + t;
      a[j][0] = base[0];
      a[j][1] = base[8 * PR];
      a[j][2] = base[4];
      a[j][3] = base[8 * PR + 4];
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const uint32_t* wb = wr + (n * 8 + g) * PSW + 8 * k0 + t;
      const uint32_t b0 = wb[0], b1 = wb[4];
#pragma unroll
      for (int j = 0; j < NM; ++j) mma_bf16(acc[j][n], a[j], b0, b1);
    }
  }
}

// ---------------------------------------------------------------------------
// site_kernel_bf16: the 3x3 sites (K9a, K9c, K9d)
// ---------------------------------------------------------------------------

struct SiteArgs {
  const __nv_bfloat16* x;   // [B,Hi,Wi,C] raw (K10: pre-padded, read as given)
  const float *a, *c;       // prologue affine, image b's at a + b*astride
  const __nv_bfloat16* w;   // [9,CO,C] (K10: [9,C,CO])
  const float* bias;        // [CO]
  __nv_bfloat16* out;       // [B,H,W,CO]
  float* part;              // [B,tiles,2,CO]
  int B, Hi, Wi, H, W, CO;
  int astride;              // C, or 2C for K10's stat [B,2,C]
  int halo;                 // 0 pixel reflect, 1 edge copy (K10: unused)
};

// PRE: K10's operands (a pre-padded input, [9][C][CO] weights). WR: taps of
// weights staged at a time, a kernel row, or one tap at C = 128 (smem).
template <int C, int S, bool STATS = true>
struct SiteGeom {
  static constexpr int MT = S == 1 ? 2 : 1;          // m-tiles per warp
  static constexpr int TW = 16 * MT;                 // output columns per block
  static constexpr int HR = (kTH - 1) * S + 3;       // haloed input tile rows
  static constexpr int HC = (TW - 1) * S + 3;        // and columns
  static constexpr int PSX = C / 2 + (S == 1 ? 4 : 2);  // words per pixel (bank spread)
  static constexpr int PSW = C / 2 + 4;              // words per weight row
  static constexpr int WR = C >= 128 ? 1 : 3;        // taps per weight stage
  static constexpr size_t smem = sizeof(uint32_t) * (WR * kCOT * PSW + HR * HC * PSX) +
                                 sizeof(float) * (2 * C + (STATS ? kWarps * 2 * kCOT : 0));
};

template <int C, int S, bool PRE = false, int PRO = kProF32, bool STATS = true>
__global__ void __launch_bounds__(kThreads, 2) site_kernel_bf16(SiteArgs p) {
  using G = SiteGeom<C, S, STATS>;
  constexpr int MT = G::MT, TW = G::TW, HR = G::HR, HC = G::HC, PSX = G::PSX, PSW = G::PSW;
  constexpr int WR = G::WR;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;                               // [WR][kCOT][PSW]: WR taps
  uint32_t* s_x = s_w + WR * kCOT * PSW;              // [HR][HC][PSX]
  float* s_aff = reinterpret_cast<float*>(s_x + HR * HC * PSX);  // a, c [C]
  float* s_sum = s_aff + 2 * C;                       // [kWarps][2][kCOT]

  const int tid = threadIdx.x;
  const int tiles_x = (p.W + TW - 1) / TW;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * TW;
  const int co0 = blockIdx.y * kCOT;
  const int b = blockIdx.z;

  for (int i = tid; i < C; i += kThreads) {
    s_aff[i] = p.a[b * p.astride + i];
    s_aff[C + i] = p.c[b * p.astride + i];
  }
  __syncthreads();

  // prologue: the haloed tile, activated, as bf16. K10 reads the padded input
  // as given (rows and columns past its end feed only outputs not stored).
  for (int i = tid; i < HR * HC * (C / 4); i += kThreads) {
    const int q = i % (C / 4), pix = i / (C / 4);
    const int hc = pix % HC, hr = pix / HC;
    const int sy = PRE ? min(ty0 + hr, p.Hi - 1) : src_index(ty0 * S + hr - 1, p.Hi, p.halo);
    const int sx = PRE ? min(tx0 + hc, p.Wi - 1) : src_index(tx0 * S + hc - 1, p.Wi, p.halo);
    const uint2 v = prologue4<PRO>(p.x + (((size_t)b * p.Hi + sy) * p.Wi + sx) * C + 4 * q,
                                   s_aff, s_aff + C, 4 * q);
    *reinterpret_cast<uint2*>(s_x + pix * PSX + 2 * q) = v;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][kNT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][n][k] = 0.0f;

#pragma unroll 1
  for (int st = 0; st < 9 / WR; ++st) {
    if (st > 0) __syncthreads();  // every warp is done with the previous taps
    if (PRE) {
      // [tap][c][co] → [tl][co][c]: the lanes of a warp take 32 consecutive c
      // of one 8-channel group of co, so the 16-bit stores hit 16 banks
      __nv_bfloat16* s_wh = reinterpret_cast<__nv_bfloat16*>(s_w);
      for (int i = tid; i < WR * C * (kCOT / 8); i += kThreads) {
        const int ch = i % C, j = (i / C) % (kCOT / 8), tl = i / (C * (kCOT / 8));
        const uint4 v = *reinterpret_cast<const uint4*>(
            p.w + ((size_t)(st * WR + tl) * C + ch) * p.CO + co0 + 8 * j);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) s_wh[((tl * kCOT + 8 * j + k) * PSW) * 2 + ch] = e[k];
      }
    } else {
      for (int i = tid; i < WR * kCOT * (C / 8); i += kThreads) {
        const int ch = i % (C / 8), co = (i / (C / 8)) % kCOT, tl = i / ((C / 8) * kCOT);
        const uint4 v = *reinterpret_cast<const uint4*>(
            p.w + ((size_t)(st * WR + tl) * p.CO + co0 + co) * C + 8 * ch);
        *reinterpret_cast<uint4*>(s_w + (tl * kCOT + co) * PSW + 4 * ch) = v;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int tl = 0; tl < WR; ++tl) {
      const int dy = (st * WR + tl) / 3, dx = (st * WR + tl) % 3;
      const uint32_t* xr[MT];
#pragma unroll
      for (int j = 0; j < MT; ++j)
        xr[j] = s_x + ((warp * S + dy) * HC + (16 * j + g) * S + dx) * PSX;
      tap_mma<C, MT, S * PSX, PSW>(acc, xr, s_w + tl * kCOT * PSW, g, t);
    }
  }

  // epilogue: + bias in f32, the sums of the f32 values, bf16 out
  const int oy = ty0 + warp;
  float s1[kNT][2], s2[kNT][2];
#pragma unroll
  for (int n = 0; n < kNT; ++n) s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.0f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int co = co0 + n * 8 + 2 * t;
    const float bi0 = p.bias[co], bi1 = p.bias[co + 1];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = tx0 + 16 * j + g + 8 * h;
        if (oy >= p.H || ox >= p.W) continue;
        const float f0 = __fadd_rn(acc[j][n][2 * h], bi0);
        const float f1 = __fadd_rn(acc[j][n][2 * h + 1], bi1);
        *reinterpret_cast<__nv_bfloat162*>(p.out + (((size_t)b * p.H + oy) * p.W + ox) * p.CO +
                                           co) = __floats2bfloat162_rn(f0, f1);
        if (STATS) {
          s1[n][0] = __fadd_rn(s1[n][0], f0);
          s1[n][1] = __fadd_rn(s1[n][1], f1);
          s2[n][0] = __fadd_rn(s2[n][0], __fmul_rn(f0, f0));
          s2[n][1] = __fadd_rn(s2[n][1], __fmul_rn(f1, f1));
        }
      }
  }
  if (!STATS) return;
  // lanes that differ in g share channels: fold them (xor 4, 8, 16), then the warps
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s1[n][k] = __fadd_rn(s1[n][k], __shfl_xor_sync(0xffffffffu, s1[n][k], m));
        s2[n][k] = __fadd_rn(s2[n][k], __shfl_xor_sync(0xffffffffu, s2[n][k], m));
      }
  if (g == 0) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        s_sum[(warp * 2 + 0) * kCOT + n * 8 + 2 * t + k] = s1[n][k];
        s_sum[(warp * 2 + 1) * kCOT + n * 8 + 2 * t + k] = s2[n][k];
      }
  }
  __syncthreads();
  if (tid < 2 * kCOT) {
    const int s = tid / kCOT, co = tid % kCOT;
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v = __fadd_rn(v, s_sum[(w * 2 + s) * kCOT + co]);
    p.part[(((size_t)b * gridDim.x + tile) * 2 + s) * p.CO + co0 + co] = v;
  }
}

// sums[b, s, co] = Σ over tiles, in tile order, in double.
__global__ void stats_reduce_bf16(const float* __restrict__ part, float* __restrict__ sums, int B,
                             int tiles, int CO) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 2 * CO) return;
  const int co = i % CO, s = (i / CO) % 2, b = i / (2 * CO);
  double v = 0.0;
  for (int k = 0; k < tiles; ++k) v += (double)part[(((size_t)b * tiles + k) * 2 + s) * CO + co];
  sums[i] = (float)v;
}

// Launch site_kernel_bf16 on p (p.H, p.W set) and, with STATS, the reduce.
template <int C, int S, bool PRE = false, int PRO = kProF32, bool STATS = true>
int launch_site_kernel(const SiteArgs& p, float* sums, void* stream) {
  using G = SiteGeom<C, S, STATS>;
  auto kern = site_kernel_bf16<C, S, PRE, PRO, STATS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::smem);
  if (err == cudaSuccess && PRE)  // two K10 blocks need all 228 KB of the SM
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((p.H + kTH - 1) / kTH) * ((p.W + G::TW - 1) / G::TW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<dim3(tiles, p.CO / kCOT, p.B), kThreads, G::smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !STATS) return (int)err;
  const int n = p.B * 2 * p.CO;
  stats_reduce_bf16<<<(n + 255) / 256, 256, 0, s>>>(p.part, sums, p.B, tiles, p.CO);
  return (int)cudaGetLastError();
}

template <int C, int S>
int launch_site(SiteArgs p, float* sums, void* stream) {
  if (p.B <= 0 || p.Hi < 2 || p.Wi < 2 || p.CO <= 0 || p.CO % kCOT) return (int)cudaErrorInvalidValue;
  if (S == 2 && (p.Hi % 2 || p.Wi % 2)) return (int)cudaErrorInvalidValue;
  p.H = p.Hi / S;
  p.W = p.Wi / S;
  p.astride = C;
  return launch_site_kernel<C, S>(p, sums, stream);
}

SiteArgs site_args(const __nv_bfloat16* x, const float* a, const float* c,
                   const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out, float* part,
                   int B, int Hi, int Wi, int CO, int halo) {
  SiteArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.bias = bias; p.out = out; p.part = part;
  p.B = B; p.Hi = Hi; p.Wi = Wi; p.CO = CO; p.halo = halo;
  return p;
}

// K10 at C = 128 in one of its six forms (prologue x statistics).
template <int PRO>
int launch_fused(const SiteArgs& p, int stats, float* sums, void* stream) {
  return stats ? launch_site_kernel<128, 1, true, PRO, true>(p, sums, stream)
               : launch_site_kernel<128, 1, true, PRO, false>(p, sums, stream);
}

// ---------------------------------------------------------------------------
// c1_kernel: Johnson's conv1 as the f=2 block conv (K11)
// ---------------------------------------------------------------------------

constexpr int kC1In = 12;            // input channels: 4 phases x 3 colours
constexpr int kC1Out = 128;          // output channels: 4 phases x 32
constexpr int kC1COT = 64;           // output channels per block
constexpr int kC1TW = 32;            // output columns per tile (two m-tiles a warp)
constexpr int kC1TH = kWarps;        // output rows per tile, one per warp
constexpr int kC1RG = 4;             // row tiles a block walks down its column strip
constexpr int kC1XR = kC1TH + 4;     // input rows of a tile
constexpr int kC1XW = 224;           // words of a staged input row: 37 pixels x 6, padded
constexpr int kC1PSW = 32 + 4;       // words per co row of the packed weights (K = 64)
constexpr int kC1PSO = kC1COT / 2 + 4;  // words per pixel of the staged output tile
constexpr size_t kC1Smem = sizeof(uint32_t) * (5 * kC1COT * kC1PSW + kC1XR * kC1XW +
                                               kC1TH * kC1TW * kC1PSO);

struct C1Args {
  const uint32_t* x;        // [B,H+4,W+4,12] bf16, as words (6 a pixel)
  const __nv_bfloat16* w;   // [5,5,12,128] (HWIO)
  const float* bias;        // [128]
  __nv_bfloat16* out;       // [B,H,W,128]
  int B, H, W;              // the output grid; the input is (H+4) x (W+4)
};

// A block: 8 warps on a 8 x 32 output tile and 64 output channels, walking
// kC1RG tiles down its column strip with the weights staged once. Warp w owns
// output row w. m-tile j of a warp holds pixels 16j..16j+15 with MMA row g at
// pixel 16j+2g and row g+8 at 16j+2g+1: a fragment load then touches words
// 12g + t (+const), 32 different banks. K of kernel row dy: k = 12·dx + ch,
// which is word 6·x + k/2 of the staged row for output pixel x.
__global__ void __launch_bounds__(kThreads, 2) c1_kernel(C1Args p) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;                              // [5][kC1COT][kC1PSW]
  uint32_t* s_x = s_w + 5 * kC1COT * kC1PSW;         // [kC1XR][kC1XW]
  uint32_t* s_o = s_x + kC1XR * kC1XW;               // [kC1TH][kC1TW][kC1PSO] bf16 pairs
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tx0 = blockIdx.x * kC1TW;
  const int b = blockIdx.z / (kC1Out / kC1COT), co0 = (blockIdx.z % (kC1Out / kC1COT)) * kC1COT;
  const int Hp = p.H + 4, Wp6 = (p.W + 4) * (kC1In / 2);

  // weights → [dy][co][k], the five dx taps of a row packed, k 60..63 zero
  for (int i = tid; i < 5 * kC1COT * 32; i += kThreads) {
    const int kw = i % 32, co = (i / 32) % kC1COT, dy = i / (32 * kC1COT);
    __nv_bfloat16 h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * kw + e, dx = k / kC1In, ch = k % kC1In;
      h[e] = k < 5 * kC1In ? p.w[((dy * 5 + dx) * kC1In + ch) * kC1Out + co0 + co]
                           : __float2bfloat16_rn(0.0f);
    }
    s_w[(dy * kC1COT + co) * kC1PSW + kw] = *reinterpret_cast<const uint32_t*>(h);
  }

#pragma unroll 1
  for (int rg = 0; rg < kC1RG; ++rg) {
    const int ty0 = (blockIdx.y * kC1RG + rg) * kC1TH;
    if (ty0 >= p.H) break;
    __syncthreads();  // the previous tile's s_x and s_o are read (and the weights staged)
    for (int i = tid; i < kC1XR * kC1XW; i += kThreads) {
      const int r = i / kC1XW, wd = i % kC1XW;
      const int gy = ty0 + r, gw = tx0 * (kC1In / 2) + wd;
      s_x[i] = gy < Hp && gw < Wp6 ? p.x[((size_t)b * Hp + gy) * Wp6 + gw] : 0u;
    }
    __syncthreads();

    float acc[2][kNT][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][n][k] = 0.0f;
#pragma unroll 1
    for (int dy = 0; dy < 5; ++dy) {
      const uint32_t* xr = s_x + (warp + dy) * kC1XW + 12 * g + t;
      const uint32_t* wr = s_w + (dy * kC1COT + g) * kC1PSW + t;
#pragma unroll
      for (int k0 = 0; k0 < 4; ++k0) {
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t* base = xr + 96 * j + 8 * k0;   // pixel 16j + 2g
          a[j][0] = base[0];
          a[j][1] = base[6];                             // pixel 16j + 2g + 1
          a[j][2] = base[4];
          a[j][3] = base[10];
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const uint32_t* wb = wr + n * 8 * kC1PSW + 8 * k0;
          const uint32_t b0 = wb[0], b1 = wb[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_bf16(acc[j][n], a[j], b0, b1);
        }
      }
    }

    // + bias in f32, one round to bf16, into the staged tile
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int co = n * 8 + 2 * t;
      const float bi0 = p.bias[co0 + co], bi1 = p.bias[co0 + co + 1];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * j + 2 * g + h;
          *reinterpret_cast<__nv_bfloat162*>(s_o + (warp * kC1TW + px) * kC1PSO + co / 2) =
              __floats2bfloat162_rn(__fadd_rn(acc[j][n][2 * h], bi0),
                                    __fadd_rn(acc[j][n][2 * h + 1], bi1));
        }
    }
    __syncthreads();
    // out: each pixel's 64 channels are 128 contiguous bytes, 8 lanes of 16 bytes
    for (int i = tid; i < kC1TH * kC1TW * (kC1COT / 8); i += kThreads) {
      const int c8 = i % (kC1COT / 8), px = (i / (kC1COT / 8)) % kC1TW;
      const int r = i / ((kC1COT / 8) * kC1TW);
      const int oy = ty0 + r, ox = tx0 + px;
      if (oy >= p.H || ox >= p.W) continue;
      *reinterpret_cast<uint4*>(p.out + (((size_t)b * p.H + oy) * p.W + ox) * kC1Out + co0 +
                                8 * c8) =
          *reinterpret_cast<const uint4*>(s_o + (r * kC1TW + px) * kC1PSO + 4 * c8);
    }
  }
}

// ---------------------------------------------------------------------------
// rows_kernel_bf16: deconv3's tap-packed 1x5 conv (K9b, K9e)
// ---------------------------------------------------------------------------

constexpr int kRC = 128;           // input channels (4 phases x 32)
constexpr int kRPS = kRC / 2 + 4;  // words per pixel / per weight row
constexpr int kLanes = 60;         // 5 kernel rows x 12 output lanes
constexpr int kOut = 12;           // 4 phases x 3 channels

struct RowsArgs {
  const __nv_bfloat16* x;   // [B,H,W,128] raw (the d2 site's output)
  const float *a, *c;       // [B,128] in5 affine
  const __nv_bfloat16* w;   // [5,64,128] (lanes 60..63 zero)
  const float* bias;        // K9b: [12]
  __nv_bfloat16* out;       // K9e: [B,H+4,W,60]; K9b: [B,H,W,12]
  int B, H, W;
};

// SUM false: K9e, one conv row per warp, 32 columns; SUM true: K9b, two conv
// rows per warp (16 for 12 output rows), 16 columns.
template <bool SUM>
struct RowsGeom {
  static constexpr int NM = 2;                       // m-tiles per warp
  static constexpr int KR = SUM ? 2 * kWarps : kWarps;   // conv rows per block
  static constexpr int TW = SUM ? 16 : 32;           // columns per block
  static constexpr int TH = SUM ? KR - 4 : KR;       // output rows per block
  static constexpr int HC = TW + 4;                  // haloed input tile columns
  static constexpr size_t smem = sizeof(uint32_t) * (kCOT * kRPS + KR * HC * kRPS) +
                                 sizeof(float) * 2 * kRC +
                                 (SUM ? sizeof(__nv_bfloat16) * KR * TW * kCOT : 0);
};

// Pixel reflect of block-grid position (R, phase u) over n blocks: the source
// block and phase of pixel 2R+u mirrored around the first or last pixel.
__device__ __forceinline__ int reflect_phase(int R, int u, int n, int* phase) {
  int px = 2 * R + u;
  px = px < 0 ? -px : px;
  px = px >= 2 * n ? 4 * n - 2 - px : px;
  px = min(max(px, 0), 2 * n - 1);
  *phase = px & 1;
  return px >> 1;
}

template <bool SUM>
__global__ void __launch_bounds__(kThreads, SUM ? 1 : 2) rows_kernel_bf16(RowsArgs p) {
  using G = RowsGeom<SUM>;
  constexpr int NM = G::NM, KR = G::KR, TW = G::TW, TH = G::TH, HC = G::HC;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;                                // [kCOT][kRPS]: one tap
  uint32_t* s_x = s_w + kCOT * kRPS;                   // [KR][HC][kRPS]
  float* s_aff = reinterpret_cast<float*>(s_x + KR * HC * kRPS);  // a, c [128]
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(s_aff + 2 * kRC);  // [KR][TW][kCOT]

  const int tid = threadIdx.x;
  const int tiles_x = (p.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.z;

  for (int i = tid; i < kRC; i += kThreads) {
    s_aff[i] = p.a[b * kRC + i];
    s_aff[kRC + i] = p.c[b * kRC + i];
  }
  __syncthreads();

  // prologue: conv rows ty0-2 .. and columns tx0-2 .. of the reflect-padded
  // block grid, read through the phase-permuting index map, activated
  for (int i = tid; i < KR * HC * (kRC / 4); i += kThreads) {
    const int q = i % (kRC / 4), pix = i / (kRC / 4);
    const int hc = pix % HC, hr = pix / HC;
    const int ph = q >> 3;  // 8 groups of 4 channels per phase
    int u, v;
    const int sy = reflect_phase(ty0 + hr - 2, ph >> 1, p.H, &u);
    const int sx = reflect_phase(tx0 + hc - 2, ph & 1, p.W, &v);
    const int sch = (u * 2 + v) * 32 + 4 * (q & 7);
    const uint2 val = activate4(p.x + (((size_t)b * p.H + sy) * p.W + sx) * kRC + sch, s_aff,
                                s_aff + kRC, 4 * q);
    *reinterpret_cast<uint2*>(s_x + pix * kRPS + 2 * q) = val;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[NM][kNT][4];
#pragma unroll
  for (int j = 0; j < NM; ++j)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][n][k] = 0.0f;

  // m-tile j of a warp: K9e (row warp, columns 16j..), K9b (row warp + 8j, columns 0..)
#pragma unroll 1
  for (int dx = 0; dx < 5; ++dx) {
    if (dx > 0) __syncthreads();
    for (int i = tid; i < kCOT * (kRC / 8); i += kThreads) {
      const int ch = i % (kRC / 8), co = i / (kRC / 8);
      const uint4 v = *reinterpret_cast<const uint4*>(p.w + ((size_t)dx * kCOT + co) * kRC + 8 * ch);
      *reinterpret_cast<uint4*>(s_w + co * kRPS + 4 * ch) = v;
    }
    __syncthreads();
    const uint32_t* xr[NM];
#pragma unroll
    for (int j = 0; j < NM; ++j) {
      const int row = SUM ? warp + kWarps * j : warp;
      const int col = SUM ? g : 16 * j + g;
      xr[j] = s_x + (row * HC + col + dx) * kRPS;
    }
    tap_mma<kRC, NM, kRPS, kRPS>(acc, xr, s_w, g, t);
  }

  // the conv rows, rounded to bf16 (no bias)
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    const int row = SUM ? warp + kWarps * j : warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = (SUM ? 0 : 16 * j) + g + 8 * h;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int l = n * 8 + 2 * t;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[j][n][2 * h], acc[j][n][2 * h + 1]);
        if (SUM) {
          *reinterpret_cast<__nv_bfloat162*>(s_k + (row * TW + col) * kCOT + l) = v;
        } else {
          const int oy = ty0 + row, ox = tx0 + col;
          if (oy < p.H + 4 && ox < p.W && l < kLanes)
            *reinterpret_cast<__nv_bfloat162*>(
                p.out + (((size_t)b * (p.H + 4) + oy) * p.W + ox) * kLanes + l) = v;
        }
      }
    }
  }

  if (SUM) {
    // out[r] = bf16(((((K[r][o] + K[r+1][12+o]) + K[r+2][24+o]) + K[r+3][36+o])
    //                + K[r+4][48+o]) + bias[o]), K indexed from the block's first conv row
    __syncthreads();
    for (int i = tid; i < TH * TW * kOut; i += kThreads) {
      const int o = i % kOut, col = (i / kOut) % TW, r = i / (kOut * TW);
      const int oy = ty0 + r, ox = tx0 + col;
      if (oy >= p.H || ox >= p.W) continue;
      float v = __bfloat162float(s_k[(r * TW + col) * kCOT + o]);
#pragma unroll
      for (int dy = 1; dy < 5; ++dy)
        v = __fadd_rn(v, __bfloat162float(s_k[((r + dy) * TW + col) * kCOT + dy * kOut + o]));
      v = __fadd_rn(v, p.bias[o]);
      p.out[(((size_t)b * p.H + oy) * p.W + ox) * kOut + o] = __float2bfloat16_rn(v);
    }
  }
}

template <bool SUM>
int launch_rows(const RowsArgs& p, void* stream) {
  using G = RowsGeom<SUM>;
  if (p.B <= 0 || p.H < 3 || p.W < 3) return (int)cudaErrorInvalidValue;
  auto kern = rows_kernel_bf16<SUM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = SUM ? p.H : p.H + 4;
  const dim3 grid(((rows + G::TH - 1) / G::TH) * ((p.W + G::TW - 1) / G::TW), 1, p.B);
  kern<<<grid, kThreads, G::smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a device
// pointer to a contiguous array as the comments of SiteArgs / RowsArgs
// describe; each launches on `stream` and returns a CUDA error code (0 on
// success). part is scratch [B, tiles, 2, CO] with tiles = ceil(H/8) *
// ceil(W/32) of the output grid at stride 1 and ceil(H/8) * ceil(W/16) at
// stride 2; sums is [B,2,CO].

// K9a: deconv2 in its phase form, x [B,H,W,64] → out [B,H,W,128], edge halo.
extern "C" int d2_site_launch(const __nv_bfloat16* x, const float* a, const float* c,
                              const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out,
                              float* part, float* sums, int B, int H, int W, void* stream) {
  return launch_site<64, 1>(site_args(x, a, c, w, bias, out, part, B, H, W, 128, 1), sums,
                            stream);
}

// K9c: conv2, x [B,H,W,32] (H, W even) → out [B,H/2,W/2,64], reflect halo.
extern "C" int c2_site_bf16_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const __nv_bfloat16* w, const float* bias,
                                   __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                   int W, void* stream) {
  return launch_site<32, 2>(site_args(x, a, c, w, bias, out, part, B, H, W, 64, 0), sums,
                            stream);
}

// K9d: conv3, x [B,H,W,64] (H, W even) → out [B,H/2,W/2,128], reflect halo.
extern "C" int c3_site_bf16_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const __nv_bfloat16* w, const float* bias,
                                   __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                   int W, void* stream) {
  return launch_site<64, 2>(site_args(x, a, c, w, bias, out, part, B, H, W, 128, 0), sums,
                            stream);
}

// K9e: rows out[b, R+2, x, l] = bf16(1x5 conv of the activated, reflect-padded
// x at block row R in [-2, H+2)), l < 60.
extern "C" int d3_rows_launch(const __nv_bfloat16* x, const float* a, const float* c,
                              const __nv_bfloat16* w, __nv_bfloat16* out, int B, int H, int W,
                              void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<false>(p, stream);
}

// K9b: out[b,y,x,o] = bf16(Σ_dy rows[y+dy][12*dy+o] + bias[o]) over the same rows.
extern "C" int d3_sum_site_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                  const __nv_bfloat16* w, const float* bias,
                                  __nv_bfloat16* out, int B, int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<true>(p, stream);
}

// K10: x_pad [B,Hi,Wi,128] (Hi ≥ H+2, Wi ≥ W+2) read as given, stat [B,2,128]
// (a, c), w [9,128,CO] (tap, c, co) → out [B,H,W,CO] and, with stats, sums
// [B,2,CO] (part [B, ceil(H/8)·ceil(W/32), 2, CO]). prologue: 0 f32 affine +
// ReLU, 1 none, 2 the affine in bf16 arithmetic.
extern "C" int fused_conv_launch(const __nv_bfloat16* x, const float* stat,
                                 const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out,
                                 float* part, float* sums, int B, int Hi, int Wi, int H, int W,
                                 int CO, int prologue, int stats, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hi < H + 2 || Wi < W + 2 || CO <= 0 || CO % kCOT)
    return (int)cudaErrorInvalidValue;
  SiteArgs p = site_args(x, stat, stat + 128, w, bias, out, part, B, Hi, Wi, CO, 0);
  p.H = H;
  p.W = W;
  p.astride = 2 * 128;
  switch (prologue) {
    case kProF32: return launch_fused<kProF32>(p, stats, sums, stream);
    case kProNone: return launch_fused<kProNone>(p, stats, sums, stream);
    case kProBf16: return launch_fused<kProBf16>(p, stats, sums, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K11: y12 [B,H+4,W+4,12] → out [B,H,W,128] = bf16(Σ y12·w + bias), w [5,5,12,128].
extern "C" int c1_site_launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                              __nv_bfloat16* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  C1Args p = {reinterpret_cast<const uint32_t*>(x), w, bias, out, B, H, W};
  cudaError_t err = cudaFuncSetAttribute(c1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kC1Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kC1TW - 1) / kC1TW, ((H + kC1TH - 1) / kC1TH + kC1RG - 1) / kC1RG,
                  B * (kC1Out / kC1COT));
  c1_kernel<<<grid, kThreads, kC1Smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Resident blocks per SM and dynamic shared memory of a block: which 0 is
// K10 (f32 prologue, statistics), 1 is K11.
extern "C" int bf16_occupancy(int which, int* blocks, int* smem) {
  cudaError_t err;
  if (which == 0) {
    auto kern = site_kernel_bf16<128, 1, true, kProF32, true>;
    *smem = (int)SiteGeom<128, 1, true>::smem;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads, *smem);
  } else {
    *smem = (int)kC1Smem;
    err = cudaFuncSetAttribute(c1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, c1_kernel, kThreads, *smem);
  }
  return (int)err;
}
