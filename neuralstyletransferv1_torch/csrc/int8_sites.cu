// K2–K8b — the int8 site convs of the quantized Johnson, NST_Train and ReCoNet
// paths.
//
// Replaces the TPU kernels of neuralstyletransferv1_tpu/models/s2d2_sites_i8.py:
//   K2  res_site_s8o   (_site_kernel_s8o)  quantize bf16 → 3x3 conv → s8 codes
//   K3  site_s8        (_site_kernel_s8g)  s8 codes → 3x3 conv → [affine] [+ y] → bf16 or s8
//   K4  res_site       (_site_kernel)      quantize bf16 → 3x3 conv → bf16 + stats
//   K5  res_site_skip  (_site_kernel_skip) skip-combine + quantize → 3x3 conv → bf16 + stats
//   K8a c2_site        (_c2p_kernel)       quantize bf16 → 3x3 stride-2 conv → bf16 + stats
//   K8b c3_site        (_c3p_kernel)       the same at C = 64
//   K7  d3_rows_site   (_d3_kernel)        quantize bf16 → 1x5 conv → 60 bf16 row lanes
//   K6  d3_s8_site     (_d3s8_kernel)      s8 codes → 1x5 conv → 5-row dy-sum + bias → bf16
// K2, K5 and K8 are one templated core (site_kernel): a 3x3 conv of int8
// codes at stride 1 or 2 over a 1-pixel halo (pixel reflect or edge copy;
// K2 and K3 also zero codes, the NST net's zero padding, where K2 zeroes the
// codes of the columns >= sw that pad a grid up to an aligned width, in its
// input and output, and K3 those of its s8 output), accumulated in int32
// with __dp4a, with a prologue (how the int8 tile is
// made) and an epilogue (what is written) chosen at compile time. K3 and K4
// run the same conv at stride 1 on the tensor cores (mma_kernel, below);
// ReCoNet's forms (C = 192 res grid, 96 at its d2): K4 at C in {96, 192} with
// an optional pre-round floor (FRN's TLU folded into the quantize, the Pallas
// res_site's tau); K5 at C = 192 with the post-add ReLU or TLU on v (act /
// tau_act); K2 at C = 192, also with a floored emit (qlo, tau); K3 at C = 192.
// Their site_kernel forms stay buildable as res_site_prev_launch /
// site_s8_prev_launch, for timing the two designs side by side. K8a/K8b are
// the TPU's pair-packed head sites; their pair packing and phase-permutation
// dots are layout only, and as pixel convs they are K4 at stride 2. K6/K7 are
// a second core (rows_kernel): deconv3 in its tap-packed form, a 1x5 conv of
// the 128-channel space-to-depth tensor to 60 lanes (5 kernel rows x 4
// phases x 3 channels, padded to 64 with zero weights), zero column pads.
//
// site_kernel: block = 256 threads = one 8x16-pixel output tile x 64 output
// channels of one image. The haloed input tile ((8-1)*S+3 rows x (16-1)*S+3
// columns at stride S) is quantized once into shared memory as packed
// 4-channel int32 words (channels innermost, a pixel stride of C/4+1 words
// so the four pixels a warp reads at once sit in four banks); the block's 64
// output channels of weights, repacked on the host to [tap][C/4][CO] words,
// are staged next to it. Warp w computes output row w; lane l owns output
// channels 8*(l%8)..+7 of pixels 4*(l/8)..+3, i.e. 32 int32 accumulators,
// fed per tap and word by four scalar input loads and two 16-byte weight
// loads (the weight loads of the eight lanes that share pixels cover 256
// contiguous bytes).
//
// rows_kernel: block = 256 threads = 16 output columns x all 64 lanes of 8
// (K7) or 16 (K6, two per warp) conv rows. K7 writes each row's 60 lanes as
// bf16. K6 keeps its 16 rows of bf16 K lanes in shared memory and then sums,
// for each of its 12 output rows r and 12 output channels o, K[r+dy-2] lane
// 12*dy+o over dy = 0..4 in f32 in that order, adds the bias and rounds to
// bf16. Rows outside the image are zero codes (the TPU kernel's zero-SAME
// interior; the caller overwrites the 2-block border frame with reflect
// strips, as the JAX code does).
//
// Rounding follows the reference operation by operation and the build uses
// --fmad=false: f = acc*ws + bias with __int2float_rn / __fmul_rn /
// __fadd_rn, bf16 by __float2bfloat16_rn wherever the reference
// materializes bf16, quantize by rintf (half to even, as jnp.round) then a
// clamp to [lo, 127]. The instance-norm sums are taken over the
// bf16-rounded outputs: per block, in a fixed order (4 pixels, then lanes by
// shuffle, then the 8 rows), into a [B, tiles, 2, CO] buffer that a second
// kernel reduces over tiles in order, in double. No float atomics, so
// repeated runs give identical bits.
//
// What bounds them on an H100: a res site of the 1080p B=8 slice is 3.06e11
// int8 operations (0.155 ms at the 1979 TOP/s int8 tensor-core peak) and
// moves 0.4-1.6 GB (0.12-0.48 ms at 3.35 TB/s); the head sites (K8a/K8b,
// 1.5e11 ops each) and K6/K7 (3.2e11 ops each) are bound by their bytes.
// site_kernel runs __dp4a on the CUDA cores, whose peak is ~62 TMAC/s, 16x
// below the tensor cores: it is bound by the dp4a rate (~3.1 ms a res site,
// 20x the bound). K2, K5, K8a/K8b stay on it.
//
// mma_kernel (K3, K4): the same 3x3 conv as an implicit GEMM on the int8
// tensor cores, mma.sync.m16n8k32.s8.s8.s32 fed by ldmatrix: M = the 16
// output pixels of a tile row, N = output channels, K = 9 taps x C, the A
// rows of tap (dy, dx) the haloed tile's pixels shifted by (dy, dx) (each
// lane gives ldmatrix its own row address, so a shift costs nothing). A
// persistent grid (one 256-thread block per SM, 132 on an H100) stages the
// weights of its 128 output channels once (64 at C = 192, where 128 would
// not fit in shared memory), rearranged from [tap][C/4][CO] words to
// [tap][CO][C] bytes with a 16-byte pad per row, and walks output
// tiles of 8x16 pixels in a fixed order; the haloed 10x18-pixel input tile
// is quantized (K4) or copied (K3) once per tile for all 128 channels into
// shared memory (pixel stride C + 16 bytes: the eight rows an ldmatrix
// reads sit in 32 distinct banks), and the next tile's input is loaded
// into registers while the current tile's MMAs run. Warp w owns tile rows
// 2(w%4), 2(w%4)+1 and channels 64(w/4)..+63: 2 x 8 MMAs per k32 step from
// 2 + 4 ldmatrix.x4 (at C = 192 warp w owns tile row w: 1 x 8 MMAs from 1 + 4).
// What bounds ReCoNet's sites: at the 1080p B=8 res grid (270 x 480 x 192)
// a site is 6.88e11 int8 operations (0.348 ms); d1 (192 -> 384) 1.38e12
// (0.695 ms); d2 (540 x 960, 96 -> 192) moves 2.39 GB (0.713 ms).
// The epilogue turns the accumulator fragments into f = bf16(acc*ws + bias)
// (K3: and its frozen affine), stages f as bf16 in shared memory over the
// input tile, which the MMAs no longer read, and
// writes it out 8 channels (16 bytes) a thread, coalesced; K3's residual
// add, its activation and the s8 emit run on that pass, with y loaded 16
// coalesced bytes at a time. int32 accumulation is exact in any order, so
// every output equals site_kernel's bit for bit; the sums are per tile (4
// pixels a lane, the 8 lanes of a channel by shuffle, the 4 row warps) in a
// fixed order, reduced over tiles by stats_reduce_mma (8 warps a block, in
// double, in a fixed order). The Prologue/Epilogue enums are shared with
// site_kernel; mma_kernel instantiates kQuant/kRawStats (K4) and
// kCodes/kSiteS8 (K3).
//
// Where mma_kernel's time goes (H100, chip_smoke.py --phases): the MMAs
// are issued in about a third of each tile's time; the rest is the
// fragment epilogue, the stores and K4's quantize, which this one-block
// design does not overlap with the MMAs. Interleaving that work into the
// MMA loop of the same warps, and two 64-channel blocks per SM, were both
// slower (PERF.md); warp-specialized producers and consumers are the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8, kTW = 16;          // output tile, pixels
constexpr int kCOT = 64;                  // output channels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// kSkipAct: kSkip with ReCoNet's post-add activation, v = max(v, floor[b, ch])
// (floor 0 for a ReLU, bf16(tau) for a TLU) before v is written and quantized.
// kEmitS8F: kEmitS8 with a per-channel pre-round floor (FRN's TLU folded into
// the emit) and the clamp floor qlo.
enum Prologue { kQuant = 0, kSkip = 1, kCodes = 2, kSkipAct = 3 };
enum Epilogue { kRawStats = 0, kEmitS8 = 1, kSiteS8 = 2, kEmitS8F = 3 };
// kSiteS8 epilogue steps, chosen per launch (the K3 forms of _site_kernel_s8g)
enum SiteFlags { kFAff = 1, kFYadd = 2, kFYaff = 4, kFS8Out = 8 };
// kSiteS8 per-channel rows staged in shared memory: aa, ac, qa, qc, ya, yc
constexpr int kEpRows = 6;

struct Args {
  const void* x;                 // kQuant: bf16 x; kSkip: bf16 r2; kCodes: int8 [B,Hi,Wi,C]
  const __nv_bfloat16* yp;       // kSkip: bf16 residual [B,H,W,C]
  const __nv_bfloat16* yadd;     // kSiteS8: bf16 residual [B,H,W,CO]
  const float *a, *c;            // [B,C] quantize affine
  const float *a2, *c2;          // [B,C] skip-combine affine
  const int32_t* wk;             // [9, C/4, CO] packed int8 weights
  const float *ws, *bias;        // [CO] dequant row and conv bias
  const float *ra, *rc;          // [CO] kEmitS8: output quantize
  const float* tau;              // floor rows, or null: [B,C] K4's pre-round floor
                                 // (mma_kernel TAU), [B,C] K5's post-add floor
                                 // (kSkipAct), [CO] K2's emit floor (kEmitS8F)
  const float* ep[kEpRows];      // [CO] kSiteS8: aa, ac, qa, qc, ya, yc (null if unused)
  void* out;                     // bf16 or int8 [B,H,W,CO]
  __nv_bfloat16* vout;           // kSkip: v [B,H,W,C], or null
  float* part;                   // kRawStats: [B, tiles, 2, CO]
  int B, Hi, Wi;                 // input grid
  int H, W, CO;                  // output grid
  float lo;                      // quantize floor of the prologue
  float qlo;                     // kSiteS8, kEmitS8F: floor of the s8 emit
  int flags;                     // kSiteS8: SiteFlags
  int halo;                      // 0 pixel reflect, 1 edge copy, 2 zero codes
  int sw;                        // content width: K2 zeroes its codes in columns >= sw
};

// Source index of halo position i in [-1, n] (and, for the padding rows of
// a partial tile, beyond): pixel reflect or edge, clamped into the image.
// The zero halo (kHaloZero) reads no source outside the image: see
// zero_code.
constexpr int kHaloZero = 2;
__device__ __forceinline__ int src_index(int i, int n, int halo) {
  if (halo == 0) {
    i = i < 0 ? -i : i;
    i = i >= n ? 2 * n - 2 - i : i;
  }
  return min(max(i, 0), n - 1);
}

// Under the zero halo, input position (y, x) is a zero code when it lies
// outside the image or, for a quantizing prologue, in a column >= sw (the
// content width of a grid padded up to an aligned width, as _quant_zero
// masks it).
__device__ __forceinline__ bool zero_code(int y, int x, int hi, int wz, int halo) {
  return halo == kHaloZero && (y < 0 || y >= hi || x < 0 || x >= wz);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int quantize(float v, float a, float c, float lo) {
  const float q = rintf(__fadd_rn(__fmul_rn(v, a), c));
  return (int)fminf(fmaxf(q, lo), 127.0f);
}

// quantize with a pre-round floor t: clamp(rint(max(v*a + c, t)), lo, 127)
// (a TLU max(y, tau) folded into the quantize affine, as _quant_halo's t)
__device__ __forceinline__ int quantize_floor(float v, float a, float c, float t, float lo) {
  const float q = rintf(fmaxf(__fadd_rn(__fmul_rn(v, a), c), t));
  return (int)fminf(fmaxf(q, lo), 127.0f);
}

__device__ __forceinline__ void load4_bf16(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4_bf16(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// quantize 4 bf16 channels (affine rows at s_a[ch], s_c[ch]) into one word
__device__ __forceinline__ int32_t quant_word(const float* v, const float* s_a,
                                              const float* s_c, int ch0, float lo) {
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = quantize(v[k], s_a[ch0 + k], s_c[ch0 + k], lo);
    packed |= (uint32_t)(q & 0xff) << (8 * k);
  }
  return (int32_t)packed;
}

template <int S>
struct Tile {
  static constexpr int HR = (kTH - 1) * S + 3;  // haloed input tile rows
  static constexpr int HC = (kTW - 1) * S + 3;  // and columns
};

// per-channel [C] rows the prologue stages: a, c, then kSkip's a2, c2 and
// kSkipAct's floor
template <int PRO>
__host__ __device__ constexpr int aff_rows() { return PRO == kSkipAct ? 5 : 4; }

template <int C, int S, int PRO>
constexpr size_t smem_bytes() {
  return sizeof(int32_t) * (9 * (C / 4) * kCOT + Tile<S>::HR * Tile<S>::HC * (C / 4 + 1)) +
         sizeof(float) * (aff_rows<PRO>() * C + kWarps * 2 * kCOT + kEpRows * kCOT);
}

template <int C, int S, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 2) site_kernel(Args p) {
  constexpr int CW = C / 4;   // int32 words per pixel
  constexpr int PS = CW + 1;  // padded pixel stride in shared memory
  constexpr int HR = Tile<S>::HR, HC = Tile<S>::HC;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_w = smem;                                   // [9][CW][kCOT]
  int32_t* s_x = s_w + 9 * CW * kCOT;                    // [HR][HC][PS]
  float* s_aff = reinterpret_cast<float*>(s_x + HR * HC * PS);  // a, c, a2, c2[, floor] [C]
  float* s_sum = s_aff + aff_rows<PRO>() * C;            // [kWarps][2][kCOT]
  float* s_ep = s_sum + kWarps * 2 * kCOT;               // [kEpRows][kCOT]

  const int tid = threadIdx.x;
  const int tiles_x = (p.W + kTW - 1) / kTW;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
  const int co0 = blockIdx.y * kCOT;
  const int b = blockIdx.z;

  for (int i = tid; i < 9 * CW * kCOT; i += kThreads)
    s_w[i] = p.wk[(size_t)(i / kCOT) * p.CO + co0 + i % kCOT];
  if (EPI == kSiteS8) {
    for (int i = tid; i < kEpRows * kCOT; i += kThreads) {
      const float* row = p.ep[i / kCOT];
      s_ep[i] = row != nullptr ? row[co0 + i % kCOT] : 0.0f;
    }
  }
  if (PRO != kCodes) {
    for (int i = tid; i < C; i += kThreads) {
      s_aff[i] = p.a[b * C + i];
      s_aff[C + i] = p.c[b * C + i];
      if (PRO == kSkip || PRO == kSkipAct) {
        s_aff[2 * C + i] = p.a2[b * C + i];
        s_aff[3 * C + i] = p.c2[b * C + i];
      }
      if (PRO == kSkipAct) s_aff[4 * C + i] = p.tau[b * C + i];
    }
    __syncthreads();
  }

  // prologue: the haloed tile as int8 codes, 4 channels per word
  for (int i = tid; i < HR * HC * CW; i += kThreads) {
    const int wd = i % CW, pix = i / CW;
    const int hc = pix % HC, hr = pix / HC;
    const int gy = ty0 * S + hr - 1, gx = tx0 * S + hc - 1;
    const int sy = src_index(gy, p.Hi, p.halo), sx = src_index(gx, p.Wi, p.halo);
    const size_t off = (((size_t)b * p.Hi + sy) * p.Wi + sx) * C + 4 * wd;
    int32_t word;
    if (zero_code(gy, gx, p.Hi, PRO == kCodes ? p.Wi : p.sw, p.halo)) {
      word = 0;
    } else if (PRO == kCodes) {
      word = *reinterpret_cast<const int32_t*>(static_cast<const int8_t*>(p.x) + off);
    } else {
      float v[4];
      load4_bf16(static_cast<const __nv_bfloat16*>(p.x) + off, v);
      if (PRO == kSkip || PRO == kSkipAct) {
        float y[4];
        load4_bf16(p.yp + off, y);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = 4 * wd + k;
          const float t = bf16_round(__fadd_rn(__fmul_rn(v[k], s_aff[2 * C + ch]),
                                               s_aff[3 * C + ch]));
          v[k] = bf16_round(__fadd_rn(t, y[k]));
          // the post-add ReLU / TLU: max with a bf16 floor is exact in bf16
          if (PRO == kSkipAct) v[k] = fmaxf(v[k], s_aff[4 * C + ch]);
        }
        const bool interior = hr >= 1 && hr <= kTH && hc >= 1 && hc <= kTW &&
                              gy < p.H && gx < p.W;
        if (p.vout != nullptr && blockIdx.y == 0 && interior) store4_bf16(p.vout + off, v);
      }
      word = quant_word(v, s_aff, s_aff + C, 4 * wd, p.lo);
    }
    s_x[(hr * HC + hc) * PS + wd] = word;
  }
  __syncthreads();

  // main loop: 9 taps x C/4 words, 4 pixels x 8 channels per thread
  const int warp = tid >> 5, lane = tid & 31;
  const int cg = lane & 7, px = lane >> 3;
  int acc[4][8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const int32_t* xr = s_x + ((warp * S + dy) * HC + 4 * px * S + dx) * PS;
    const int4* wr = reinterpret_cast<const int4*>(s_w + tap * CW * kCOT + cg * 8);
#pragma unroll 8
    for (int wd = 0; wd < CW; ++wd) {
      int xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = xr[k * S * PS + wd];
      const int4 w0 = wr[wd * (kCOT / 4)], w1 = wr[wd * (kCOT / 4) + 1];
      const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = __dp4a(xv[k], wv[j], acc[k][j]);
    }
  }

  // epilogue
  const int oy = ty0 + warp;
  const int cb = co0 + cg * 8;
  float ws[8], bi[8], ra[8], rc[8], rt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ws[j] = p.ws[cb + j];
    bi[j] = p.bias[cb + j];
    if (EPI == kEmitS8 || EPI == kEmitS8F) {
      ra[j] = p.ra[cb + j];
      rc[j] = p.rc[cb + j];
    }
    if (EPI == kEmitS8F)  // no floor row: -inf
      rt[j] = p.tau != nullptr ? p.tau[cb + j] : __int_as_float(0xff800000);
  }
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0f;

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ox = tx0 + 4 * px + k;
    if (oy >= p.H || ox >= p.W) continue;
    const size_t o = (((size_t)b * p.H + oy) * p.W + ox) * p.CO + cb;
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[k][j]), ws[j]), bi[j]));
    if (EPI == kRawStats) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
      store4_bf16(out, f);
      store4_bf16(out + 4, f + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] = __fadd_rn(s1[j], f[j]);
        s2[j] = __fadd_rn(s2[j], __fmul_rn(f[j], f[j]));
      }
    } else if (EPI == kEmitS8) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // the emit clamps at 0: the ReLU after the next site's norm folds in
        lo |= (uint32_t)(quantize(f[j], ra[j], rc[j], 0.0f) & 0xff) << (8 * j);
        hi |= (uint32_t)(quantize(f[j + 4], ra[j + 4], rc[j + 4], 0.0f) & 0xff) << (8 * j);
      }
      if (ox >= p.sw) lo = hi = 0;  // padding columns stay zero codes
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) = make_uint2(lo, hi);
    } else if (EPI == kEmitS8F) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= (uint32_t)(quantize_floor(f[j], ra[j], rc[j], rt[j], p.qlo) & 0xff) << (8 * j);
        hi |= (uint32_t)(quantize_floor(f[j + 4], ra[j + 4], rc[j + 4], rt[j + 4], p.qlo) & 0xff)
              << (8 * j);
      }
      if (ox >= p.sw) lo = hi = 0;
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) = make_uint2(lo, hi);
    } else {
      // K3: [frozen affine] → [+ y, y first activated by a frozen affine + ReLU]
      // → bf16 out, or the next site's s8 codes
      const float* e = s_ep + cg * 8;
      if (p.flags & kFAff) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = bf16_round(__fadd_rn(__fmul_rn(f[j], e[j]), e[kCOT + j]));
      }
      if (p.flags & kFYadd) {
        float y[8];
        load4_bf16(p.yadd + o, y);
        load4_bf16(p.yadd + o + 4, y + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (p.flags & kFYaff)
            y[j] = bf16_round(fmaxf(__fadd_rn(__fmul_rn(y[j], e[4 * kCOT + j]),
                                              e[5 * kCOT + j]), 0.0f));
          f[j] = bf16_round(__fadd_rn(f[j], y[j]));
        }
      }
      if (p.flags & kFS8Out) {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo |= (uint32_t)(quantize(f[j], e[2 * kCOT + j], e[3 * kCOT + j], p.qlo) & 0xff)
                << (8 * j);
          hi |= (uint32_t)(quantize(f[j + 4], e[2 * kCOT + j + 4], e[3 * kCOT + j + 4],
                                    p.qlo) & 0xff) << (8 * j);
        }
        if (ox >= p.sw) lo = hi = 0;
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) = make_uint2(lo, hi);
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
        store4_bf16(out, f);
        store4_bf16(out + 4, f + 4);
      }
    }
  }

  if (EPI == kRawStats) {
    // lanes px = 0..3 share channels: fold them (xor 8, then 16), then the rows
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] = __fadd_rn(s1[j], __shfl_xor_sync(0xffffffffu, s1[j], 8));
      s2[j] = __fadd_rn(s2[j], __shfl_xor_sync(0xffffffffu, s2[j], 8));
      s1[j] = __fadd_rn(s1[j], __shfl_xor_sync(0xffffffffu, s1[j], 16));
      s2[j] = __fadd_rn(s2[j], __shfl_xor_sync(0xffffffffu, s2[j], 16));
    }
    if (px == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s_sum[(warp * 2 + 0) * kCOT + cg * 8 + j] = s1[j];
        s_sum[(warp * 2 + 1) * kCOT + cg * 8 + j] = s2[j];
      }
    }
    __syncthreads();
    if (tid < 2 * kCOT) {
      const int s = tid / kCOT, co = tid % kCOT;
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, s_sum[(w * 2 + s) * kCOT + co]);
      const int tiles = gridDim.x;
      p.part[(((size_t)b * tiles + tile) * 2 + s) * p.CO + co0 + co] = t;
    }
  }
}

// sums[b, s, co] = Σ over tiles, in tile order, in double.
__global__ void stats_reduce(const float* __restrict__ part, float* __restrict__ sums,
                             int B, int tiles, int CO) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 2 * CO) return;
  const int co = i % CO, s = (i / CO) % 2, b = i / (2 * CO);
  double t = 0.0;
  for (int k = 0; k < tiles; ++k) t += (double)part[(((size_t)b * tiles + k) * 2 + s) * CO + co];
  sums[i] = (float)t;
}

template <int C, int S, int PRO, int EPI>
int launch_c(const Args& p, float* sums, cudaStream_t stream) {
  const size_t smem = smem_bytes<C, S, PRO>();
  auto kern = site_kernel<C, S, PRO, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  const dim3 grid(tiles, p.CO / kCOT, p.B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (EPI == kRawStats) {
    const int n = p.B * 2 * p.CO;
    stats_reduce<<<(n + 255) / 256, 256, 0, stream>>>(p.part, sums, p.B, tiles, p.CO);
  }
  return (int)cudaGetLastError();
}

bool valid(const Args& p) {
  return p.B > 0 && p.Hi >= 2 && p.Wi >= 2 && p.H > 0 && p.W > 0 && p.CO > 0 &&
         p.CO % kCOT == 0;
}

// stride 1: the Johnson and NST res and decoder sites, C in {64, 128}; the
// ReCoNet forms (K2's plain and floored emit, K5 with the post-add
// activation) at its res width C = 192
template <int PRO, int EPI>
int launch(const Args& p, int C, float* sums, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kReco = PRO == kSkipAct || EPI == kEmitS8F;   // ReCoNet-only forms
  constexpr bool kWide = kReco || (PRO == kQuant && EPI == kEmitS8);
  if constexpr (!kReco) {
    if (C == 128) return launch_c<128, 1, PRO, EPI>(p, sums, s);
    if (C == 64) return launch_c<64, 1, PRO, EPI>(p, sums, s);
  }
  if constexpr (kWide) {
    if (C == 192) return launch_c<192, 1, PRO, EPI>(p, sums, s);
  }
  return (int)cudaErrorInvalidValue;
}

Args make_args(int B, int H, int W, int CO, float lo, int halo) {
  Args p = {};
  p.B = B;
  p.Hi = p.H = H;
  p.Wi = p.W = W;
  p.CO = CO;
  p.lo = lo;
  p.halo = halo;
  p.sw = W;
  return p;
}

// ---------------------------------------------------------------------------
// mma_kernel: K3 and K4 on the int8 tensor cores (stride 1)
// ---------------------------------------------------------------------------

constexpr int kMRows = 8, kMCols = 16;              // output tile, pixels
constexpr int kMHC = kMCols + 2;                     // haloed tile columns
constexpr int kMPix = (kMRows + 2) * kMHC;           // haloed tile pixels
constexpr int kMThreads = 256;                       // 8 warps: row warps x 64-channel warps
constexpr int kMEpRows = 2 + kEpRows;                // ws, bias, then K3's rows

// The block's geometry at C input channels. C <= 128: 128 output channels a
// block, 4 row warps of 2 tile rows x 2 channel warps of 64. C = 192: the
// weights of 128 output channels (9 x 128 x 208 bytes) would not fit beside
// the input tile in the 227 KB a block may take, so a block stages 64 output
// channels and its 8 warps are row warps of one tile row each.
template <int C>
struct MmaSmem {
  static constexpr int CO = C > 128 ? 64 : 128;     // output channels per block
  static constexpr int RW = kMThreads / 32 / (CO / 64);  // row warps
  static constexpr int MI = kMRows / RW;            // tile rows a warp
  static constexpr int OUT = 2 * CO + 16;           // bytes per staged bf16 output pixel
  static constexpr int PX = C + 16;  // bytes per haloed pixel and per weight row
  static constexpr int W = 9 * CO * PX;
  static constexpr int X = kMPix * PX > kMRows * kMCols * OUT ? kMPix * PX : kMRows * kMCols * OUT;
  static constexpr size_t bytes = W + X + sizeof(float) * (kMEpRows + 2 * RW) * CO;
};

// the haloed tile's input, one 16-byte global chunk per thread and pass;
// where the chunks of a pixel do not divide the block (C = 96, 192), the
// threads past PPI pixels idle
template <int C, int PRO>
struct MmaIn {
  static constexpr int VB = PRO == kCodes ? 16 : 8;   // channels per chunk
  static constexpr int CH = C / VB;                   // chunks per pixel
  static constexpr int PPI = kMThreads / CH;          // pixels per pass
  static constexpr int NI = (kMPix + PPI - 1) / PPI;  // passes
  static constexpr bool FULL = kMThreads % CH == 0;
};

// bf16 → f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// two bf16-rounded f32 values → their bf16 pair
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Built with -DMMA_PHASE_CLOCKS (chip_smoke.py --phases), thread 0 of each
// block adds the clock cycles of the phases of its tile loop into
// mma_phase_clocks[block]: 0 the next tile's loads issued, 1 the MMAs issued,
// 2 the fragment epilogue (the MMAs' drain included), 3 the stores and sums,
// 4 the next tile's quantize or copy.
#ifdef MMA_PHASE_CLOCKS
constexpr int kPhases = 5, kPhaseBlocks = 1024;
__device__ unsigned long long mma_phase_clocks[kPhaseBlocks][kPhases];
#define MMA_PHASE_START unsigned long long clk_[kPhases] = {}; long long clk_t_ = clock64();
#define MMA_PHASE(k) { const long long c_ = clock64(); clk_[k] += c_ - clk_t_; clk_t_ = c_; }
#define MMA_PHASE_END \
  if (threadIdx.x == 0 && blockIdx.x < kPhaseBlocks) \
    for (int k = 0; k < kPhases; ++k) mma_phase_clocks[blockIdx.x][k] = clk_[k];
#else
#define MMA_PHASE_START
#define MMA_PHASE(k)
#define MMA_PHASE_END
#endif

// Block k of `per_half` blocks serves output channels co0 = MCO·(k / per_half)
// and walks tiles k % per_half, + per_half, ... of the B·tiles 8x16 output
// tiles (image-major, then row-major within the image). TAU (K4 at C = 96,
// 192): the quantize takes a per-(image, channel) pre-round floor (FRN's TLU).
template <int C, int PRO, int EPI, bool TAU>
__global__ void __launch_bounds__(kMThreads, 1)
    mma_kernel(Args p, int tiles_x, int tiles, int per_half) {
  static_assert((PRO == kQuant && EPI == kRawStats) || (PRO == kCodes && EPI == kSiteS8),
                "mma_kernel serves K4 (kQuant, kRawStats) and K3 (kCodes, kSiteS8)");
  static_assert(!TAU || PRO == kQuant, "the floor is a quantize's");
  using S = MmaSmem<C>;
  using In = MmaIn<C, PRO>;
  constexpr int PX = S::PX;
  constexpr int MCO = S::CO, RW = S::RW, MI = S::MI, OUT = S::OUT;
  constexpr int CW = C / 4;   // int32 words per pixel
  constexpr int KC = C / 32;  // k32 steps per tap
  constexpr int KS = 9 * KC;  // k32 steps
  extern __shared__ __align__(16) uint8_t smem8[];
  uint8_t* s_w = smem8;                                   // [9][MCO][PX] weights
  uint8_t* s_x = smem8 + S::W;                            // [kMPix][PX] codes, then outputs
  float* s_rows = reinterpret_cast<float*>(s_x + S::X);   // [kMEpRows][MCO]
  float* s_sum = s_rows + kMEpRows * MCO;                 // [RW][2][MCO]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = (blockIdx.x / per_half) * MCO;
  const int nvalid = min(MCO, p.CO - co0);
  const int total = p.B * tiles;
  int tile = blockIdx.x % per_half;
  if (tile >= total) return;

  // the block's weights, once: word (tap, k, co0 + n) → bytes 4k.. of row (tap, n)
  static_assert(9 * CW * MCO % kMThreads == 0, "weight words split evenly");
#pragma unroll 8
  for (int j = 0; j < 9 * CW * MCO / kMThreads; ++j) {
    const int i = tid + j * kMThreads;
    const int n = i % MCO, k = (i / MCO) % CW, t = i / (MCO * CW);
    *reinterpret_cast<int32_t*>(s_w + (t * MCO + n) * PX + 4 * k) =
        n < nvalid ? p.wk[((size_t)t * CW + k) * p.CO + co0 + n] : 0;
  }
  for (int i = tid; i < kMEpRows * MCO; i += kMThreads) {
    const int r = i / MCO, n = i % MCO;
    const float* row = r == 0 ? p.ws : r == 1 ? p.bias : EPI == kSiteS8 ? p.ep[r - 2] : nullptr;
    s_rows[i] = row != nullptr && n < nvalid ? row[co0 + n] : 0.0f;
  }

  // prologue: the haloed tile into registers (fetch), then as codes into s_x (stage)
  uint4 raw[In::NI];
  const int chunk = tid % In::CH, p0 = tid / In::CH;
  const bool loader = In::FULL || p0 < In::PPI;
  auto fetch = [&](int id) {
    const int b = id / tiles, t = id % tiles;
    const int y0 = (t / tiles_x) * kMRows, x0 = (t % tiles_x) * kMCols;
#pragma unroll
    for (int k = 0; k < In::NI; ++k) {
      const int px = p0 + k * In::PPI;
      if (loader && px < kMPix) {
        const int gy = y0 + px / kMHC - 1, gx = x0 + px % kMHC - 1;
        const int sy = src_index(gy, p.Hi, p.halo), sx = src_index(gx, p.Wi, p.halo);
        const size_t off = (((size_t)b * p.Hi + sy) * p.Wi + sx) * C + chunk * In::VB;
        const uint4* src = PRO == kCodes
            ? reinterpret_cast<const uint4*>(static_cast<const int8_t*>(p.x) + off)
            : reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.x) + off);
        // the zero halo is a zero code, which only K3's copied codes can carry
        raw[k] = PRO == kCodes && zero_code(gy, gx, p.Hi, p.Wi, p.halo) ? make_uint4(0, 0, 0, 0)
                                                                        : __ldg(src);
      }
    }
  };
  auto stage = [&](int id) {
    const int b = id / tiles;
    float qa[8], qc[8], qt[8];
    if (PRO == kQuant) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qa[j] = __ldg(p.a + b * C + chunk * 8 + j);
        qc[j] = __ldg(p.c + b * C + chunk * 8 + j);
        if (TAU) qt[j] = __ldg(p.tau + b * C + chunk * 8 + j);
      }
    }
#pragma unroll
    for (int k = 0; k < In::NI; ++k) {
      const int px = p0 + k * In::PPI;
      if (!loader || px >= kMPix) continue;
      uint8_t* dst = s_x + px * PX + chunk * In::VB;
      if (PRO == kCodes) {
        *reinterpret_cast<uint4*>(dst) = raw[k];
      } else {
        const uint32_t w4[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t q0, q1;
          if (TAU) {
            q0 = quantize_floor(bf16_lo(w4[j]), qa[2 * j], qc[2 * j], qt[2 * j], p.lo) & 0xff;
            q1 = quantize_floor(bf16_hi(w4[j]), qa[2 * j + 1], qc[2 * j + 1], qt[2 * j + 1],
                                p.lo) & 0xff;
          } else {
            q0 = quantize(bf16_lo(w4[j]), qa[2 * j], qc[2 * j], p.lo) & 0xff;
            q1 = quantize(bf16_hi(w4[j]), qa[2 * j + 1], qc[2 * j + 1], p.lo) & 0xff;
          }
          q[j >> 1] |= (q0 | (q1 << 8)) << (16 * (j & 1));
        }
        *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
      }
    }
  };

  const int mg = warp % RW, ng = warp / RW;  // tile rows MI·mg.., channels 64ng..
  const bool active = ng * 64 < nvalid;
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix row addresses: A rows are the 16 pixels of a tile row (lanes
  // 0-15: bytes 0-15 of the k32 slice, 16-31: bytes 16-31); B rows are the
  // output channels (lanes 0-7 / 16-23: bytes 0-15 of 8-channel groups 2q /
  // 2q+1, lanes 8-15 / 24-31: bytes 16-31)
  const uint32_t a_lane = smem_addr(s_x) + ((MI * mg) * kMHC + (lane & 15)) * PX + (lane >> 4) * 16;
  const uint32_t b_lane = smem_addr(s_w) + (ng * 64 + (lane >> 4) * 8 + (lane & 7)) * PX +
                          ((lane >> 3) & 1) * 16;

  fetch(tile);
  stage(tile);
  __syncthreads();
  MMA_PHASE_START
  for (;;) {
    const int next = tile + per_half;
    if (next < total) fetch(next);  // in flight while the MMAs run
    MMA_PHASE(0)

    int acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
    if (active) {
      uint32_t af[2][MI][4], bfr[2][8][2];
      auto load = [&](int s, uint32_t (&a)[MI][4], uint32_t (&bq)[8][2]) {
        const int tap = s / KC, kc = s % KC, dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(a[mi], a_lane + ((mi + dy) * kMHC + dx) * PX + kc * 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t r[4];
          ldsm_x4(r, b_lane + (tap * MCO + 16 * q) * PX + kc * 32);
          bq[2 * q][0] = r[0];
          bq[2 * q][1] = r[1];
          bq[2 * q + 1][0] = r[2];
          bq[2 * q + 1][1] = r[3];
        }
      };
      auto mmas = [&](const uint32_t (&a)[MI][4], const uint32_t (&bq)[8][2]) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < 8; ++nj) mma_s8(acc[mi][nj], a[mi], bq[nj][0], bq[nj][1]);
      };
      // fragments double-buffered: step s+1's ldmatrix before step s's MMAs
      // (KS is odd at C = 96: the last pair has one step)
      load(0, af[0], bfr[0]);
#pragma unroll
      for (int s = 0; s < KS; s += 2) {
        if (s + 1 < KS) load(s + 1, af[1], bfr[1]);
        mmas(af[0], bfr[0]);
        if (s + 2 < KS) load(s + 2, af[0], bfr[0]);
        if (s + 1 < KS) mmas(af[1], bfr[1]);
      }
    }
    MMA_PHASE(1)
    __syncthreads();  // s_x is free: the epilogue stages its outputs there

    // epilogue on the fragments: lane (g, tg) holds, for tile row MI·mg+mi and
    // channel group nj, pixels g and g+8 (e = 0,1 and 2,3) of channels
    // 64ng + 8nj + 2tg, +1. f = bf16(acc·ws + bias), K3's frozen affine,
    // K4's sums; f is staged as bf16 (exact: every f is bf16-rounded)
    const int b = tile / tiles, t = tile % tiles;
    const int y0 = (t / tiles_x) * kMRows, x0 = (t % tiles_x) * kMCols;
    if (active) {
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int n = ng * 64 + nj * 8 + 2 * tg;
        const float2 ws = *reinterpret_cast<const float2*>(s_rows + n);
        const float2 bi = *reinterpret_cast<const float2*>(s_rows + MCO + n);
        float2 aa = make_float2(0.0f, 0.0f), ac = aa;
        if (EPI == kSiteS8 && (p.flags & kFAff)) {
          aa = *reinterpret_cast<const float2*>(s_rows + 2 * MCO + n);
          ac = *reinterpret_cast<const float2*>(s_rows + 3 * MCO + n);
        }
        float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = MI * mg + mi, col = g + 8 * h;
            float f[2] = {
                bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][nj][2 * h]), ws.x), bi.x)),
                bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][nj][2 * h + 1]), ws.y),
                                     bi.y))};
            if (EPI == kRawStats) {
              if (y0 + r < p.H && x0 + col < p.W) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  s1[e] = __fadd_rn(s1[e], f[e]);
                  s2[e] = __fadd_rn(s2[e], __fmul_rn(f[e], f[e]));
                }
              }
            } else if (p.flags & kFAff) {
              f[0] = bf16_round(__fadd_rn(__fmul_rn(f[0], aa.x), ac.x));
              f[1] = bf16_round(__fadd_rn(__fmul_rn(f[1], aa.y), ac.y));
            }
            *reinterpret_cast<uint32_t*>(s_x + (r * kMCols + col) * OUT + 2 * n) =
                bf16_pack(f[0], f[1]);
          }
        }
        if (EPI == kRawStats) {
          // the 8 lanes g = 0..7 share the channels: fold them, then per row warp
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              s1[e] = __fadd_rn(s1[e], __shfl_xor_sync(0xffffffffu, s1[e], m));
              s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(0xffffffffu, s2[e], m));
            }
            if (g == 0) {
              s_sum[(mg * 2 + 0) * MCO + n + e] = s1[e];
              s_sum[(mg * 2 + 1) * MCO + n + e] = s2[e];
            }
          }
        }
      }
    }
    __syncthreads();
    MMA_PHASE(2)

    // the staged outputs, 8 channels (16 bytes) a thread and pass, coalesced;
    // K3 adds its residual y (loaded here, 16 coalesced bytes) and emits s8
    constexpr int CPP = MCO / 8;            // 8-channel chunks a staged pixel
    constexpr int NS = kMRows * kMCols * CPP / kMThreads;
    const int vchunks = nvalid / 8;
    const bool yadd = EPI == kSiteS8 && (p.flags & kFYadd);
    uint4 yv[NS];
    if (yadd) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int i = tid + j * kMThreads, px = i / CPP, c8 = i % CPP;
        const int oy = y0 + px / kMCols, ox = x0 + px % kMCols;
        if (c8 < vchunks && oy < p.H && ox < p.W)
          yv[j] = __ldg(reinterpret_cast<const uint4*>(
              p.yadd + (((size_t)b * p.H + oy) * p.W + ox) * p.CO + co0 + 8 * c8));
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int i = tid + j * kMThreads, px = i / CPP, c8 = i % CPP;
      const int oy = y0 + px / kMCols, ox = x0 + px % kMCols;
      if (c8 >= vchunks || oy >= p.H || ox >= p.W) continue;
      const size_t o = (((size_t)b * p.H + oy) * p.W + ox) * p.CO + co0 + 8 * c8;
      uint4 v = *reinterpret_cast<const uint4*>(s_x + px * OUT + 16 * c8);
      if (EPI == kSiteS8 && (p.flags & (kFYadd | kFS8Out))) {
        // K3: [+ y, y first activated by a frozen affine + ReLU] → bf16 out,
        // or the next site's s8 codes
        const float* ep = s_rows + 2 * MCO + 8 * c8;  // aa, ac, qa, qc, ya, yc rows
        uint32_t w[4] = {v.x, v.y, v.z, v.w};
        float f[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          f[2 * k] = bf16_lo(w[k]);
          f[2 * k + 1] = bf16_hi(w[k]);
        }
        if (yadd) {
          const uint32_t yw[4] = {yv[j].x, yv[j].y, yv[j].z, yv[j].w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float y = k & 1 ? bf16_hi(yw[k / 2]) : bf16_lo(yw[k / 2]);
            if (p.flags & kFYaff)
              y = bf16_round(fmaxf(__fadd_rn(__fmul_rn(y, ep[4 * MCO + k]), ep[5 * MCO + k]),
                                   0.0f));
            f[k] = bf16_round(__fadd_rn(f[k], y));
          }
        }
        if (p.flags & kFS8Out) {
          uint32_t q[2] = {0u, 0u};
#pragma unroll
          for (int k = 0; k < 8; ++k)
            q[k / 4] |= (uint32_t)(quantize(f[k], ep[2 * MCO + k], ep[3 * MCO + k], p.qlo) &
                                   0xff) << (8 * (k % 4));
          if (ox >= p.sw) q[0] = q[1] = 0;  // padding columns stay zero codes
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) = make_uint2(q[0], q[1]);
          continue;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = bf16_pack(f[2 * k], f[2 * k + 1]);
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) = v;
    }
    if (EPI == kRawStats && tid < 2 * MCO) {
      const int s = tid / MCO, n = tid % MCO;
      if (n < nvalid) {
        float v = 0.0f;
        for (int w = 0; w < RW; ++w) v = __fadd_rn(v, s_sum[(w * 2 + s) * MCO + n]);
        p.part[(((size_t)b * tiles + t) * 2 + s) * p.CO + co0 + n] = v;
      }
    }
    MMA_PHASE(3)
    if (next >= total) break;
    __syncthreads();  // every staged output is read
    stage(next);
    __syncthreads();
    MMA_PHASE(4)
    tile = next;
  }
  MMA_PHASE_END
}

// sums[b, s, co] = Σ over tiles in double, in a fixed order: the 8 warps of
// a block take tiles k ≡ warp (mod 8) in order for 32 channels, then warp 0
// adds the 8 warp sums in order.
__global__ void stats_reduce_mma(const float* __restrict__ part, float* __restrict__ sums,
                                 int B, int tiles, int CO) {
  __shared__ double s_part[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;  // over B·2·CO; CO % 32 == 0
  const int co = i % CO, s = (i / CO) % 2, b = i / (2 * CO);
  double t = 0.0;
#pragma unroll 4
  for (int k = warp; k < tiles; k += 8) t += (double)part[(((size_t)b * tiles + k) * 2 + s) * CO + co];
  s_part[warp][lane] = t;
  __syncthreads();
  if (warp == 0) {
    double v = 0.0;
    for (int w = 0; w < 8; ++w) v += s_part[w][lane];
    sums[i] = (float)v;
  }
}

template <int C, int PRO, int EPI, bool TAU>
int launch_mma_c(const Args& p, float* sums, cudaStream_t stream) {
  const size_t smem = MmaSmem<C>::bytes;
  auto kern = mma_kernel<C, PRO, EPI, TAU>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles_x = (p.W + kMCols - 1) / kMCols;
  const int tiles = ((p.H + kMRows - 1) / kMRows) * tiles_x;
  constexpr int MCO = MmaSmem<C>::CO;
  const int halves = (p.CO + MCO - 1) / MCO;
  int per_half = sms / halves < p.B * tiles ? sms / halves : p.B * tiles;
  per_half = per_half > 1 ? per_half : 1;
  kern<<<per_half * halves, kMThreads, smem, stream>>>(p, tiles_x, tiles, per_half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (EPI == kRawStats)
    stats_reduce_mma<<<p.B * 2 * p.CO / 32, 256, 0, stream>>>(p.part, sums, p.B, tiles, p.CO);
  return (int)cudaGetLastError();
}

// the tensor-core core: C in {64, 128} (Johnson, NST); ReCoNet's K4 at
// C in {96, 192}, with or without the TLU floor, and its K3 at C = 192
template <int PRO, int EPI>
int launch_mma(const Args& p, int C, float* sums, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tau = p.tau != nullptr;
  if (!tau && C == 128) return launch_mma_c<128, PRO, EPI, false>(p, sums, s);
  if (!tau && C == 64) return launch_mma_c<64, PRO, EPI, false>(p, sums, s);
  if constexpr (PRO == kQuant) {
    if (C == 192) return tau ? launch_mma_c<192, PRO, EPI, true>(p, sums, s)
                             : launch_mma_c<192, PRO, EPI, false>(p, sums, s);
    if (C == 96) return tau ? launch_mma_c<96, PRO, EPI, true>(p, sums, s)
                            : launch_mma_c<96, PRO, EPI, false>(p, sums, s);
  } else {
    if (!tau && C == 192) return launch_mma_c<192, PRO, EPI, false>(p, sums, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// rows_kernel: deconv3's tap-packed 1x5 conv (K6, K7)
// ---------------------------------------------------------------------------

constexpr int kRC = 128;            // input channels (4 phases x 32)
constexpr int kRCW = kRC / 4;       // int32 words per pixel
constexpr int kRPS = kRCW + 1;      // padded pixel stride in shared memory
constexpr int kRW = 16;             // output columns per block
constexpr int kRHC = kRW + 4;       // haloed input tile columns
constexpr int kLanes = 60;          // 5 kernel rows x 12 output lanes
constexpr int kOut = 12;            // 4 phases x 3 channels

struct RowsArgs {
  const void* x;          // K7: bf16 raw [B,H,W,128]; K6: int8 codes [B,H,W,128]
  const float *a, *c;     // K7: [B,128] quantize affine (floor 0)
  const int32_t* wk;      // [5, 32, 64] packed int8 weights (lanes 60..63 zero)
  const float* ws;        // [64] dequant row (lanes 60..63 zero)
  const float* bias;      // K6: [12]
  __nv_bfloat16* out;     // K7: [B,H,W,60]; K6: [B,H,W,12]
  int B, H, W;
};

template <int RPW>
__host__ __device__ constexpr int rows_th() {   // output rows per block
  return RPW == 1 ? kWarps : kWarps * RPW - 4;
}

template <int RPW>
constexpr size_t rows_smem_bytes() {
  return sizeof(int32_t) * (5 * kRCW * kCOT + kWarps * RPW * kRHC * kRPS) +
         sizeof(float) * 2 * kRC +
         (RPW == 1 ? 0 : sizeof(__nv_bfloat16) * kWarps * RPW * kRW * kCOT);
}

// PRO kQuant: K7 (rows out, one conv row per warp); PRO kCodes: K6 (two conv
// rows per warp, then the dy-sum).
template <int PRO, int RPW>
__global__ void __launch_bounds__(kThreads, 1) rows_kernel(RowsArgs p) {
  constexpr int KR = kWarps * RPW;   // conv rows per block
  constexpr int TH = rows_th<RPW>();
  constexpr int R0 = RPW == 1 ? 0 : 2;  // K6: the conv rows start 2 above the output rows
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_w = smem;                                     // [5][kRCW][kCOT]
  int32_t* s_x = s_w + 5 * kRCW * kCOT;                    // [KR][kRHC][kRPS]
  float* s_aff = reinterpret_cast<float*>(s_x + KR * kRHC * kRPS);  // a, c [128]
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(s_aff + 2 * kRC);  // [KR][kRW][kCOT]

  const int tid = threadIdx.x;
  const int tiles_x = (p.W + kRW - 1) / kRW;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * kRW;
  const int b = blockIdx.z;

  for (int i = tid; i < 5 * kRCW * kCOT; i += kThreads) s_w[i] = p.wk[i];
  if (PRO == kQuant) {
    for (int i = tid; i < kRC; i += kThreads) {
      s_aff[i] = p.a[b * kRC + i];
      s_aff[kRC + i] = p.c[b * kRC + i];
    }
    __syncthreads();
  }

  // prologue: KR rows x (16 + 4) columns of codes; zero outside the image
  for (int i = tid; i < KR * kRHC * kRCW; i += kThreads) {
    const int wd = i % kRCW, pix = i / kRCW;
    const int hc = pix % kRHC, hr = pix / kRHC;
    const int gy = ty0 - R0 + hr, gx = tx0 + hc - 2;
    int32_t word = 0;
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const size_t off = (((size_t)b * p.H + gy) * p.W + gx) * kRC + 4 * wd;
      if (PRO == kCodes) {
        word = *reinterpret_cast<const int32_t*>(static_cast<const int8_t*>(p.x) + off);
      } else {
        float v[4];
        load4_bf16(static_cast<const __nv_bfloat16*>(p.x) + off, v);
        word = quant_word(v, s_aff, s_aff + kRC, 4 * wd, 0.0f);
      }
    }
    s_x[(hr * kRHC + hc) * kRPS + wd] = word;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int cg = lane & 7, px = lane >> 3;
  const int cb = cg * 8;
  float ws[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) ws[j] = p.ws[cb + j];

#pragma unroll 1
  for (int pass = 0; pass < RPW; ++pass) {
    const int row = warp + kWarps * pass;
    int acc[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0;
#pragma unroll 1
    for (int dx = 0; dx < 5; ++dx) {
      const int32_t* xr = s_x + (row * kRHC + 4 * px + dx) * kRPS;
      const int4* wr = reinterpret_cast<const int4*>(s_w + dx * kRCW * kCOT + cb);
#pragma unroll 8
      for (int wd = 0; wd < kRCW; ++wd) {
        int xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = xr[k * kRPS + wd];
        const int4 w0 = wr[wd * (kCOT / 4)], w1 = wr[wd * (kCOT / 4) + 1];
        const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[k][j] = __dp4a(xv[k], wv[j], acc[k][j]);
      }
    }
    // K rows: bf16(acc * ws), no bias
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = bf16_round(__fmul_rn(__int2float_rn(acc[k][j]), ws[j]));
      const int col = 4 * px + k;
      if (PRO == kCodes) {
        __nv_bfloat16* kr = s_k + (row * kRW + col) * kCOT + cb;
        store4_bf16(kr, f);
        store4_bf16(kr + 4, f + 4);
      } else {
        const int oy = ty0 + row, ox = tx0 + col;
        if (oy >= p.H || ox >= p.W) continue;
        __nv_bfloat16* out = p.out + (((size_t)b * p.H + oy) * p.W + ox) * kLanes + cb;
        store4_bf16(out, f);
        if (cb + 8 <= kLanes) store4_bf16(out + 4, f + 4);
      }
    }
  }

  if (PRO == kCodes) {
    // the dy-sum: out[r] = bf16(((((K[r-2][o] + K[r-1][12+o]) + K[r][24+o])
    //                               + K[r+1][36+o]) + K[r+2][48+o]) + bias[o])
    __syncthreads();
    for (int i = tid; i < TH * kRW * kOut; i += kThreads) {
      const int o = i % kOut, col = (i / kOut) % kRW, r = i / (kOut * kRW);
      const int oy = ty0 + r, ox = tx0 + col;
      if (oy >= p.H || ox >= p.W) continue;
      float v = __bfloat162float(s_k[(r * kRW + col) * kCOT + o]);
#pragma unroll
      for (int dy = 1; dy < 5; ++dy)
        v = __fadd_rn(v, __bfloat162float(s_k[((r + dy) * kRW + col) * kCOT + dy * kOut + o]));
      v = __fadd_rn(v, p.bias[o]);
      p.out[(((size_t)b * p.H + oy) * p.W + ox) * kOut + o] = __float2bfloat16_rn(v);
    }
  }
}

template <int PRO, int RPW>
int launch_rows(const RowsArgs& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.W <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = rows_smem_bytes<RPW>();
  auto kern = rows_kernel<PRO, RPW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int TH = rows_th<RPW>();
  const dim3 grid(((p.H + TH - 1) / TH) * ((p.W + kRW - 1) / kRW), 1, p.B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a device
// pointer to a contiguous array as the comments of Args / RowsArgs
// describe; each launches on `stream` and returns a CUDA error code (0 on
// success).

// K2: s8 codes out[b,y,x,o] = clamp(rint(bf16(acc*ws + bias)*qa + qc), 0, 127);
// with a floor row tau [CO] (or qlo != 0) clamp(rint(max(f*qa + qc, tau[o])),
// qlo, 127) (ReCoNet's FRN emit; C = 192). Under the zero halo (halo 2) the
// codes of x and of out in columns >= sw are zero (sw = W: no such column).
extern "C" int res_site_s8o_launch(const void* x, const float* a, const float* c,
                                   const int32_t* wk, const float* ws, const float* bias,
                                   const float* qa, const float* qc, const float* tau,
                                   int8_t* out, int B, int H, int W, int C, int CO, float lo,
                                   float qlo, int halo, int sw, void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.sw = sw;
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.ra = qa; p.rc = qc; p.tau = tau; p.qlo = qlo; p.out = out;
  if (tau == nullptr && qlo == 0.0f) return launch<kQuant, kEmitS8>(p, C, nullptr, stream);
  return launch<kQuant, kEmitS8F>(p, C, nullptr, stream);
}

namespace {
int site_s8_args(bool prev, const int8_t* xq, const int32_t* wk, const float* ws,
                 const float* bias, const float* aa, const float* ac, const __nv_bfloat16* y,
                 const float* ya, const float* yc, const float* qa, const float* qc, void* out,
                 int B, int H, int W, int C, int CO, int flags, float qlo, int halo, int sw,
                 void* stream) {
  Args p = make_args(B, H, W, CO, 0.0f, halo);
  p.sw = sw;
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.yadd = y; p.out = out;
  p.ep[0] = aa; p.ep[1] = ac; p.ep[2] = qa; p.ep[3] = qc; p.ep[4] = ya; p.ep[5] = yc;
  p.flags = flags;
  p.qlo = qlo;
  return prev ? launch<kCodes, kSiteS8>(p, C, nullptr, stream)
              : launch_mma<kCodes, kSiteS8>(p, C, nullptr, stream);
}
}  // namespace

// K3: f = bf16(acc*ws + bias) from s8 codes xq; then, per `flags`,
// f = bf16(f*aa + ac) (kFAff); f = bf16(f + y) with y first replaced by
// bf16(max(y*ya + yc, 0)) (kFYadd, kFYaff); out = bf16 f, or s8 codes
// clamp(rint(f*qa + qc), qlo, 127) (kFS8Out), zero in columns >= sw (sw = W:
// no such column). Unused rows may be null.
extern "C" int site_s8_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                              const float* bias, const float* aa, const float* ac,
                              const __nv_bfloat16* y, const float* ya, const float* yc,
                              const float* qa, const float* qc, void* out, int B, int H,
                              int W, int C, int CO, int flags, float qlo, int halo, int sw,
                              void* stream) {
  return site_s8_args(false, xq, wk, ws, bias, aa, ac, y, ya, yc, qa, qc, out, B, H, W, C, CO,
                      flags, qlo, halo, sw, stream);
}

// K3 on the previous __dp4a core (site_kernel), for timing only.
extern "C" int site_s8_prev_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                                   const float* bias, const float* aa, const float* ac,
                                   const __nv_bfloat16* y, const float* ya, const float* yc,
                                   const float* qa, const float* qc, void* out, int B, int H,
                                   int W, int C, int CO, int flags, float qlo, int halo,
                                   int sw, void* stream) {
  return site_s8_args(true, xq, wk, ws, bias, aa, ac, y, ya, yc, qa, qc, out, B, H, W, C, CO,
                      flags, qlo, halo, sw, stream);
}

#ifdef MMA_PHASE_CLOCKS
// mma_phase_clocks → host [kPhaseBlocks][kPhases] (unsigned 64-bit).
extern "C" int mma_phase_clocks_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, mma_phase_clocks, sizeof(mma_phase_clocks));
}
#endif

// Dynamic shared memory of mma_kernel at C input channels (0 for other C).
extern "C" int mma_kernel_smem_bytes(int C) {
  switch (C) {
    case 64: return (int)MmaSmem<64>::bytes;
    case 96: return (int)MmaSmem<96>::bytes;
    case 128: return (int)MmaSmem<128>::bytes;
    case 192: return (int)MmaSmem<192>::bytes;
    default: return 0;
  }
}

// K4: bf16 raw out and sums[b, 0|1, o] = [Σ, Σ²] of it; part is scratch.
// tau (C in {96, 192}; null: none): [B,C] floor of x*a + c before the round.
extern "C" int res_site_launch(const void* x, const float* a, const float* c,
                               const float* tau, const int32_t* wk, const float* ws,
                               const float* bias, __nv_bfloat16* out, float* part, float* sums,
                               int B, int H, int W, int C, int CO, float lo, int halo,
                               void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.x = x; p.a = a; p.c = c; p.tau = tau; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  return launch_mma<kQuant, kRawStats>(p, C, sums, stream);
}

// K4 on the previous __dp4a core (site_kernel), for timing only.
// It has no floor: tau must be null.
extern "C" int res_site_prev_launch(const void* x, const float* a, const float* c,
                                    const float* tau, const int32_t* wk, const float* ws,
                                    const float* bias, __nv_bfloat16* out, float* part,
                                    float* sums, int B, int H, int W, int C, int CO, float lo,
                                    int halo, void* stream) {
  if (tau != nullptr) return (int)cudaErrorInvalidValue;
  Args p = make_args(B, H, W, CO, lo, halo);
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  return launch<kQuant, kRawStats>(p, C, sums, stream);
}

// K5: K4 on v = bf16(bf16(r2*a2 + c2) + yp), then, with a floor row [B,C]
// (C = 192), v = max(v, floor) (ReCoNet's post-add ReLU or TLU); v is
// written to vout unless null.
extern "C" int res_site_skip_launch(const void* r2, const __nv_bfloat16* yp,
                                    const float* a, const float* c, const float* a2,
                                    const float* c2, const float* floor, const int32_t* wk,
                                    const float* ws, const float* bias, __nv_bfloat16* out,
                                    __nv_bfloat16* vout, float* part, float* sums, int B,
                                    int H, int W, int C, int CO, float lo, int halo,
                                    void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.x = r2; p.yp = yp; p.a = a; p.c = c; p.a2 = a2; p.c2 = c2; p.tau = floor; p.wk = wk;
  p.ws = ws; p.bias = bias; p.out = out; p.vout = vout; p.part = part;
  if (floor != nullptr) return launch<kSkipAct, kRawStats>(p, C, sums, stream);
  return launch<kSkip, kRawStats>(p, C, sums, stream);
}

// K8a (C = 32) / K8b (C = 64): K4 at stride 2 with a pixel-reflect halo:
// x [B,H,W,C] bf16 (H, W even) → out [B,H/2,W/2,CO] bf16 and its sums.
extern "C" int site_s2_launch(const void* x, const float* a, const float* c,
                              const int32_t* wk, const float* ws, const float* bias,
                              __nv_bfloat16* out, float* part, float* sums, int B, int H,
                              int W, int C, int CO, float lo, void* stream) {
  Args p = make_args(B, H / 2, W / 2, CO, lo, 0);
  p.Hi = H;
  p.Wi = W;
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  if (!valid(p) || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32) return launch_c<32, 2, kQuant, kRawStats>(p, sums, s);
  if (C == 64) return launch_c<64, 2, kQuant, kRawStats>(p, sums, s);
  return (int)cudaErrorInvalidValue;
}

// K7: rows out[b,y,x,l] = bf16(acc_l * ws[l]), l < 60, of the 1x5 conv of
// the codes clamp(rint(x*a + c), 0, 127) with zero column pads.
extern "C" int d3_rows_launch(const __nv_bfloat16* x, const float* a, const float* c,
                              const int32_t* wk, const float* ws, __nv_bfloat16* out, int B,
                              int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<kQuant, 1>(p, stream);
}

// K6: out[b,y,x,o] = bf16(Σ_dy K[y+dy-2][12*dy+o] + bias[o]) over the codes xq,
// K the 1x5 conv rows bf16(acc*ws), zero outside the image.
extern "C" int d3_s8_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                            const float* bias, __nv_bfloat16* out, int B, int H, int W,
                            void* stream) {
  RowsArgs p = {};
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<kCodes, 2>(p, stream);
}
