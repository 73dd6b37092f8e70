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
// site_kernel is a templated core: a 3x3 conv of int8 codes at stride 1 or
// 2 over a 1-pixel halo (pixel reflect or edge copy; K2-K5 also zero codes,
// the zero padding of the NST and Torch7 nets, where K2 zeroes the codes of
// the columns >= sw that pad a grid up to an aligned width, in its input and
// output, and K3 those of its s8 output), accumulated in int32 with __dp4a,
// with a prologue (how the int8 tile is made) and an epilogue (what is
// written) chosen at compile time. K2-K5 run the same conv at stride 1 on
// the tensor cores (mma_kernel, below), K8a and K8b at stride 2
// (mma_s2_kernel), and their site_kernel forms stay buildable as
// res_site_s8o_prev_launch, site_s8_prev_launch, res_site_prev_launch,
// res_site_skip_prev_launch and site_s2_prev_launch (K8a's and K8b's), for
// timing the two designs side by side. ReCoNet's forms (C = 192 res
// grid, 96 at its d2; K4's and K3's with bf16 operands run on the wgmma
// core of int8_wgmma.cu, their instances here are its previous core and the
// f32 forms): K4 at C in {96, 192} with an optional pre-round floor
// (FRN's TLU folded into the quantize, the Pallas res_site's tau); K5 at
// C = 192 with the post-add ReLU or TLU on v (act / tau_act); K2 at C = 192,
// also with a floored emit (qlo, tau); K3 at C = 192. K8a/K8b are the TPU's
// pair-packed head sites; their pair packing and phase-permutation dots are
// layout only, and as pixel convs they are K4 at stride 2. K6/K7 are
// deconv3 in its tap-packed form, a 1x5 conv of the 128-channel
// space-to-depth tensor to 60 lanes (5 kernel rows x 4 phases x 3 channels,
// padded to 64 with zero weights), zero column pads: K6 and K7 on the
// tensor cores (d3s8_mma_kernel, d3rows_mma_kernel, below), their previous
// rows_kernel forms buildable as d3_s8_prev_launch and d3_rows_prev_launch.
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
// (K7) or 16 (K6's previous form, two per warp) conv rows. K7 writes each
// row's 60 lanes as bf16. K6 keeps its 16 rows of bf16 K lanes in shared
// memory and then sums,
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
// 20x the bound). Only the _prev forms run on it and on rows_kernel now.
//
// mma_kernel (K2-K5): the same 3x3 conv as an implicit GEMM on the int8
// tensor cores, mma.sync.m16n8k32.s8.s8.s32 fed by ldmatrix: M = the 16
// output pixels of a tile row, N = output channels, K = 9 taps x C, the A
// rows of tap (dy, dx) the haloed tile's pixels shifted by (dy, dx) (each
// lane gives ldmatrix its own row address, so a shift costs nothing). A
// persistent grid (one 256-thread block per SM, 132 on an H100) stages the
// weights of its 128 output channels once (64 at C = 192, where 128 would
// not fit in shared memory), rearranged from [tap][C/4][CO] words to
// [tap][CO][C] bytes with a 16-byte pad per row, and walks output
// tiles of 8x16 pixels in a fixed order; the haloed 10x18-pixel input tile
// is quantized (K2, K4, K5) or copied (K3) once per tile for all 128
// channels into shared memory (pixel stride C + 16 bytes: the eight rows an
// ldmatrix reads sit in 32 distinct banks), and the next tile's input is
// loaded into registers while the current tile's MMAs run. Warp w owns tile rows
// 2(w%4), 2(w%4)+1 and channels 64(w/4)..+63: 2 x 8 MMAs per k32 step from
// 2 + 4 ldmatrix.x4 (at C = 192 warp w owns tile row w: 1 x 8 MMAs from 1 + 4).
// What bounds ReCoNet's sites: at the 1080p B=8 res grid (270 x 480 x 192)
// a site is 6.88e11 int8 operations (0.348 ms); d1 (192 -> 384) 1.38e12
// (0.695 ms); d2 (540 x 960, 96 -> 192) moves 2.39 GB (0.713 ms).
// The epilogue turns the accumulator fragments into f = bf16(acc*ws + bias)
// (K3: and its frozen affine), stages f as bf16 in shared memory over the
// input tile, which the MMAs no longer read, and
// writes it out 8 channels (16 bytes) a thread, coalesced; K3's residual
// add, its activation and the s8 emit, and K2's s8 emit, run on that pass,
// with y loaded 16 coalesced bytes at a time. int32 accumulation is exact in
// any order, so every output equals site_kernel's bit for bit; the sums are
// per tile (4 pixels a lane, the 8 lanes of a channel by shuffle, the 4 row
// warps) in a fixed order, reduced over tiles by stats_reduce_mma (8 warps a
// block, in double, in a fixed order). The Prologue/Epilogue enums are
// shared with site_kernel; mma_kernel instantiates kQuant/kRawStats (K4),
// kCodes/kSiteS8 (K3), kQuant/kEmitS8 and kQuant/kEmitS8F (K2: K4's
// quantizing prologue, then K3's s8 emit with K2's own rows qa, qc and, for
// the floored emit, tau, in the rows K3 keeps for its qa, qc and ya),
// kSkip/kRawStats and kSkipAct/kRawStats (K5), and K4's forms of the int8
// probes at C = 128: kCast/kRawStats (the bare saturating cast for the
// quantize, mk31's v1) and kQuant/kRaw (no statistics: mk31's v2, mk28's
// mini site), each its own instance so that the others keep their code.
// The float32 chains hand the res chain's first sites an f32 tensor, which
// the reference reads unrounded: K2's and K4's x, K5's residual yp, K3's
// residual y. Those are the F32IN instances (res_site_f32_launch and its
// three siblings), built only at the channel counts and halos the f32
// chains reach (launch_mma_f32_k2..k5); the bf16 instances compile as before.
// The NST_Train and Torch7 int8 paths add two things to mma_kernel. The tap
// geometry (GEO, the Pallas sites' KH, KW, PT, PL): besides the 3x3 taps,
// K4's 2x2 taps at pad 1 (conv2, a 3x3 stride-2 pixel conv written as a
// block conv on its input's space-to-depth grid) and K4's and K3's 2x2 taps
// at pad 0 (a k3 stride-2 transposed conv scattered to its four output
// phases), each its own instance under the zero halo; a 2x2 tap (dy, dx)
// reads the 10x18 haloed tile at (r + dy + 1 - pt, c + dx + 1 - pt), so the
// tile, the staging and the epilogue are the 3x3 form's, with 4 taps of
// weights and 4 x C/32 k32 steps. And the content width sw for K4 and K5
// under the zero halo (K2 and K3 had it): codes in columns >= sw are 0 (K5
// still writes v there) and the sums leave those columns out.
// K5 reads two inputs, r2 and yp: holding both of the next tile in
// registers through the MMAs would double the in-flight registers (72 more
// at C = 192, where a block already holds 18 16-byte chunks of r2), and a
// shared-memory tile of yp does not fit beside the weights (C = 128: 46 KB
// over 204 KB; C = 192: 69 KB over 160 KB, 227 KB the limit). So the next
// tile's r2 and yp are loaded together before the MMAs and combined at
// once, v = bf16(bf16(r2*a2 + c2) + yp) [max(v, floor)], and the MMAs hold
// v where K4 holds x (the loads' latency is not hidden: of the placements
// tried, yp loaded after the MMAs, the combine after the fragment epilogue,
// yp two tiles ahead, codes held instead of v, this was the fastest,
// PERF.md). v is written once (blocks of output channels 0.., interior
// pixels inside the image) and quantized in the staging, as K4's x. K5's
// store loop stays rolled: unrolled, ptxas hoisted its per-pass offsets
// out of the tile loop and spilled them (148 bytes at C = 128), and the
// reloads cost a fifth of the kernel's time.
//
// Where mma_kernel's time goes (H100, chip_smoke.py --phases): the MMAs
// are issued in about a third of each tile's time; the rest is the
// fragment epilogue, the stores and K4's quantize, which this one-block
// design does not overlap with the MMAs. Interleaving that work into the
// MMA loop of the same warps, and two 64-channel blocks per SM, were both
// slower (PERF.md); warp-specialized producers and consumers are the next
// step.
//
// mma_s2_kernel (K8a): mma_kernel's quantizing prologue and raw + sums
// epilogue at stride 2, C = 32 -> 64 (M = the 16 output pixels of a tile
// row, N = 64, K = 9 taps x 32: 9 k32 steps). Its haloed 17x33 input tile
// is staged as four (row, column) parity planes, so that every tap is a
// stride-1 shift inside one plane and the eight rows an ldmatrix reads are
// eight consecutive plane pixels (at the pixel stride of 48 bytes they sit
// in 32 distinct banks; in the plain tile they would sit 96 bytes apart, two
// to a bank). K8a moves 1.59 GB at 1080p B=8 for 1.5e11 operations: the
// bytes bound it, and its prologue (the quantize of 1.1 input pixels an
// output pixel) is its largest phase. So the raw input of the next tile is
// brought into shared memory by cp.async as soon as the current one is
// quantized (no registers held for it), two blocks share an SM so that one
// block's quantize runs beside the other's MMAs and epilogue, and the
// quantize takes the round and the convert in one instruction and packs its
// codes with byte permutes. Of the forms timed on an H100 (PERF.md):
// the next tile in registers at one or two blocks an SM, rings of 2-4 tiles
// at one block an SM, this one was the fastest.
//
// mma_s2_kernel (K8b): the same at C = 64 -> 128 (18 k32 steps), 0.80 GB
// for 1.5e11 operations at 1080p B=8, bound by its bytes (0.24 ms). K8a's
// constants do not carry over: at C = 64 its block (weights 46,080 + planes
// 44,880 + rows 4,608 + one raw tile 71,808 = 167,376 bytes) no longer fits
// twice in an SM. K8b's block takes all 128 output channels: 4 row warps of
// two tile rows x 2 channel warps, as mma_kernel, with one raw tile in
// flight (92,160 + 44,880 + 5,120 + 71,808 = 213,968 bytes, one block an
// SM), so each tile is quantized once, for twice the MMAs a block. Of the
// designs timed on an H100 it was the faster; the other, K8a's two
// 64-channel halves at two blocks an SM with the quantize reading global
// memory, quantizes each tile twice (PERF.md section 6 has both times). Its
// quantize takes the round in an add (quantize_i), its epilogue sums a
// warp's two rows in registers before the shuffle fold, and its fetch and
// stage loops unroll by 6, which keeps it at 255 registers with no spill.
//
// d3s8_mma_kernel (K6): the 1x5 rows conv as an implicit GEMM, M = 16
// output columns, N = 64 lanes, K = 5 dx taps x 128 channels (20 k32
// steps); each warp walks a contiguous share of the (image, 32-column
// strip, row) space down its strips, computing every conv row once (the
// previous form computed 16 rows to emit 12) and keeping the dy-sum's
// partial sums in registers: the lanes' B rows are ordered so that the
// thread that holds output channel o of a pixel holds all five of its dy
// lanes (d3_slot_row). Its 3.2e11 operations and 0.63 GB are near balance
// on an H100; the MMAs' issue takes most of its time (--phases).
//
// d3rows_mma_kernel (K7): K6's rows conv on a bf16 input with a quantizing
// prologue and the 60 conv lanes as its output: 1.06 GB in and 0.50 GB out
// for 3.2e11 operations at 1080p B=8, bound by its bytes (0.47 ms). There
// is no dy-sum, so each (image, 32-column strip, row) is an independent item:
// each warp walks a contiguous share of them, lanes in their natural order,
// one item ahead: the raw bf16 of the item after next comes by cp.async into
// the warp's landing buffer while this item's MMAs run, and is quantized
// (quantize_i, one 16-byte chunk of 8 channels a lane and pass) into the
// other of two code slots. A code slot, once its MMAs are done, stages the
// item's 32 x 60 bf16 outputs (3,840 contiguous bytes in the output) for
// coalesced stores. Weights 46,080 bytes + 8 warps x (landing 9,216 + two
// code slots 10,368) = 202,752 bytes: a third code slot, or a separate
// output buffer beside a second landing row, would not fit. Its f32 form
// (the float32 chains' XLA-form decoder hands K7 its f32 d2 raw, which the
// reference quantizes unrounded) lands each row as f32, 18,432 bytes: at 8
// warps that is 276,480 bytes, so it runs 6 warps a block, 46,080 + 6 x
// (18,432 + 10,368) = 218,880. Of the ways that fit (each f32 row in two
// 64-channel halves through the bf16 landing row; 6 warps; the quantize
// reading f32 from device memory, as mma_kernel's F32IN stage does), 6 warps
// keeps the data path: the item after next in flight by cp.async during
// this item's MMAs and the quantize reading shared memory, where the halves
// would split the quantize around the MMAs and device-memory reads would put
// their latency into the quantize, half of the loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8, kTW = 16;          // output tile, pixels
constexpr int kCOT = 64;                  // output channels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// kSkipAct: kSkip with ReCoNet's post-add activation, v = max(v, floor[b, ch])
// (floor 0 for a ReLU, bf16(tau) for a TLU) before v is written and quantized.
// kEmitS8F: kEmitS8 with a per-channel pre-round floor (FRN's TLU folded into
// the emit) and the clamp floor qlo.
// kCast (mma_kernel only): the bare saturating cast of bf16 to s8, no affine
// (NaN -> 0, clamp(trunc(x), -128, 127): XLA's convert), mk31's v1.
// kRaw (mma_kernel only): the bf16 raw out and zero sums, no statistics
// (mk31's v2, mk28's mini site).
enum Prologue { kQuant = 0, kSkip = 1, kCodes = 2, kSkipAct = 3, kCast = 4 };
enum Epilogue { kRawStats = 0, kEmitS8 = 1, kSiteS8 = 2, kEmitS8F = 3, kRaw = 4 };
// kSiteS8 epilogue steps, chosen per launch (the K3 forms of _site_kernel_s8g)
enum SiteFlags { kFAff = 1, kFYadd = 2, kFYaff = 4, kFS8Out = 8 };
// kSiteS8 per-channel rows staged in shared memory: aa, ac, qa, qc, ya, yc
constexpr int kEpRows = 6;

struct Args {
  const void* x;                 // kQuant: bf16 x (f32 under F32IN); kSkip: bf16 r2;
                                 // kCodes: int8 [B,Hi,Wi,C]
  const __nv_bfloat16* yp;       // kSkip: bf16 residual [B,H,W,C]
  const __nv_bfloat16* yadd;     // kSiteS8: bf16 residual [B,H,W,CO]
  const float* yp32;             // kSkip under F32IN: the f32 residual [B,H,W,C]
  const float* yadd32;           // kSiteS8 under F32IN: the f32 residual [B,H,W,CO]
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
  int sw;                        // content width: K2 zeroes its codes in columns >= sw (K4
                                 // and K5 their input codes, and leave those columns out of
                                 // the sums; K3 its s8 output codes)
  int geo;                       // mma_kernel's tap geometry (Geo): 3x3, or 2x2 with pad 1 or 0
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

// XLA's saturating f32 -> s8 convert: NaN -> 0, truncate toward zero, clamp
// (cvt.rzi.s32.f32 converts NaN to 0 and saturates to the s32 range)
__device__ __forceinline__ int sat_cast(float v) {
  return min(max(__float2int_rz(v), -128), 127);
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

// The tap geometry of mma_kernel (the Pallas sites' KH, KW, PT, PL): output
// (r, c) sums taps (dy, dx) < (K, K) at input (r + dy - pt, c + dx - pt).
// kGeo33: 3x3, pt = 1 (every res and decoder site). kGeo22p1: 2x2, pt = 1
// (a 3x3 stride-2 pixel conv as a block conv on its input's space-to-depth
// grid: conv2 of the NST and Torch7 nets). kGeo22p0: 2x2, pt = 0 (a k3
// stride-2 transposed conv scattered to its four output phases: their
// deconvs). The 2x2 taps read inside the 10x18 haloed tile at the offset
// OFF = 1 - pt; the weights are [K*K][C/4][CO].
enum Geo { kGeo33 = 0, kGeo22p1 = 1, kGeo22p0 = 2 };
template <int GEO>
struct Taps {
  static constexpr int K = GEO == kGeo33 ? 3 : 2;  // taps a side
  static constexpr int N = K * K;
  static constexpr int OFF = GEO == kGeo22p0 ? 1 : 0;  // haloed-tile offset of tap (0, 0)
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

// K2's emit epilogues and K5's skip prologues on mma_kernel
__host__ __device__ constexpr bool is_emit(int epi) { return epi == kEmitS8 || epi == kEmitS8F; }
__host__ __device__ constexpr bool is_skip(int pro) { return pro == kSkip || pro == kSkipAct; }

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

// cp.async of 16 bytes (zero-filled where `valid` is false), its groups
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Built with -DMMA_PHASE_CLOCKS (chip_smoke.py --phases), thread 0 of each
// block adds the clock cycles of the phases of its tile loop into
// mma_phase_clocks[block]: 0 the next tile's loads issued, 1 the MMAs issued,
// 2 the fragment epilogue (the MMAs' drain included), 3 the stores and sums,
// 4 the next tile's quantize or copy (mma_kernel); K8a's and K8b's
// (mma_s2_kernel) 0 the quantize and the loads of the next tile issued,
// 1-3 as mma_kernel's, 4 the wait for the tile's raw input (and the barrier);
// K6's row loop (d3s8_mma_kernel, warp 0): 0 the next rows' loads issued,
// 1 the wait for the row's codes, 2 the MMAs issued, 3 the K lanes and the
// dy-sum (the drain included), 4 the row's stores.
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
// ZERO (K2, K4, K5 under the zero halo, C = 64, 128): positions outside the
// image (for K2 also the columns >= sw) are code 0; the other instances
// compile without that test.
// F32IN (the float32 chains' first sites): the operand the reference reads
// as f32 is f32 and enters the arithmetic unrounded: K2's and K4's x, read
// by the quantize in stage straight from global memory (an f32 tile held in
// registers through the MMAs would double the prefetch's registers, and it
// does not fit in shared memory beside the weights), K5's residual yp, read
// in combine, and K3's residual y, read in the store pass; each 8-channel
// chunk is two 16-byte loads. The bf16 instances compile without them.
// GEO (Geo): the tap geometry; the 2x2 forms are K4's and K3's under the
// zero halo (ZERO for K4; K3 carries it in its codes). K4's 2x2 forms also
// take the f32 x (F32IN): the NST and Torch7 float32 chains hand conv2's
// and deconv1's sites the f32 tensor; the stage reads it as for the 3x3
// taps, the haloed tile being the same.
// K4 and K5 under the zero halo also take the content width sw: their
// input codes in columns >= sw are 0 (K5 still writes v there) and the sums
// leave those columns out, as _quant_zero and the SW masks of the Pallas
// sites do.
template <int C, int PRO, int EPI, bool TAU, bool ZERO, bool F32IN, int GEO>
__global__ void __launch_bounds__(kMThreads, 1)
    mma_kernel(Args p, int tiles_x, int tiles, int per_half) {
  static_assert(((PRO == kQuant || PRO == kCast) && (EPI == kRawStats || EPI == kRaw) &&
                 !(PRO == kCast && EPI == kRaw)) ||
                    (PRO == kCodes && EPI == kSiteS8) || (PRO == kQuant && is_emit(EPI)) ||
                    (is_skip(PRO) && EPI == kRawStats),
                "mma_kernel serves K4 (kQuant, kRawStats; kCast, kRawStats; kQuant, kRaw), "
                "K3 (kCodes, kSiteS8), K2 (kQuant, kEmitS8 | kEmitS8F) and "
                "K5 (kSkip | kSkipAct, kRawStats)");
  static_assert(!TAU || (PRO == kQuant && !is_emit(EPI)), "the floor is K4's quantize's");
  static_assert(!ZERO || ((PRO == kQuant || PRO == kSkip) && !TAU),
                "K3 carries the zero halo in its codes");
  static_assert(!F32IN || (!TAU && (PRO == kQuant || PRO == kCodes || is_skip(PRO)) &&
                           EPI != kRaw),
                "the f32 operand is K2's or K4's x, K5's yp or K3's y");
  static_assert(GEO == kGeo33 || (PRO == kQuant && EPI == kRawStats && ZERO) ||
                    (!F32IN && PRO == kCodes && EPI == kSiteS8),
                "the 2x2 taps are K4's (zero halo; also with the f32 x) and K3's");
  using TP = Taps<GEO>;
  constexpr bool F32Q = F32IN && PRO == kQuant;  // K2, K4: x is f32, quantized in stage
  using S = MmaSmem<C>;
  using In = MmaIn<C, PRO>;
  constexpr int PX = S::PX;
  constexpr int MCO = S::CO, RW = S::RW, MI = S::MI, OUT = S::OUT;
  constexpr int CW = C / 4;   // int32 words per pixel
  constexpr int KC = C / 32;  // k32 steps per tap
  constexpr int KS = TP::N * KC;  // k32 steps
  extern __shared__ __align__(16) uint8_t smem8[];
  uint8_t* s_w = smem8;                                   // [taps][MCO][PX] weights
  uint8_t* s_x = smem8 + S::W;                            // [kMPix][PX] codes, then outputs
  float* s_rows = reinterpret_cast<float*>(s_x + S::X);   // [kMEpRows][MCO]
  float* s_sum = s_rows + kMEpRows * MCO;                 // [RW][2][MCO]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int co0 = (blockIdx.x / per_half) * MCO;
  const int nvalid = min(MCO, p.CO - co0);
  const int total = p.B * tiles;
  int tile = blockIdx.x % per_half;
  if (tile >= total) return;
  if (EPI == kRaw && blockIdx.x == 0)  // no statistics: p.part is the [B, 2, CO] sums
    for (int i = tid; i < p.B * 2 * p.CO; i += kMThreads) p.part[i] = 0.0f;

  // the block's weights, once: word (tap, k, co0 + n) → bytes 4k.. of row (tap, n)
  static_assert(TP::N * CW * MCO % kMThreads == 0, "weight words split evenly");
#pragma unroll 8
  for (int j = 0; j < TP::N * CW * MCO / kMThreads; ++j) {
    const int i = tid + j * kMThreads;
    const int n = i % MCO, k = (i / MCO) % CW, t = i / (MCO * CW);
    *reinterpret_cast<int32_t*>(s_w + (t * MCO + n) * PX + 4 * k) =
        n < nvalid ? p.wk[((size_t)t * CW + k) * p.CO + co0 + n] : 0;
  }
  // rows: ws, bias, then K3's aa, ac, qa, qc, ya, yc; K2 keeps its qa, qc
  // where K3 keeps its own and its floored emit's tau in K3's ya row (-inf
  // without a floor row)
  for (int i = tid; i < kMEpRows * MCO; i += kMThreads) {
    const int r = i / MCO, n = i % MCO;
    const float* row = r == 0 ? p.ws : r == 1 ? p.bias : EPI == kSiteS8 ? p.ep[r - 2]
        : is_emit(EPI) && r == 4 ? p.ra : is_emit(EPI) && r == 5 ? p.rc
        : EPI == kEmitS8F && r == 6 ? p.tau : nullptr;
    const float none = EPI == kEmitS8F && r == 6 ? __int_as_float(0xff800000) : 0.0f;
    s_rows[i] = row != nullptr && n < nvalid ? row[co0 + n] : none;
  }

  // prologue: the haloed tile into registers (fetch; K5 also its yp,
  // fetch_y, then v = combine(r2, yp) in place of r2), then as codes into
  // s_x (stage). Under the zero halo a position outside the image is a zero
  // code: K3's copied codes carry it as loaded zeros; a
  // quantize would turn a zero into round(c), so a ZERO instance's fetch
  // flags those positions in zf (bit k: pass k) and stage writes code 0
  // there. K2's zero test takes its content width sw (== W without a mask)
  // for the image's.
  uint4 raw[In::NI];
  uint4 yraw[is_skip(PRO) && !F32IN ? In::NI : 1];
  uint32_t zf = 0;
  static_assert(!ZERO || In::NI <= 32, "one flag bit a pass");
  const int chunk = tid % In::CH, p0 = tid / In::CH;
  const bool loader = In::FULL || p0 < In::PPI;
  auto fetch = [&](int id) {
    if (F32Q) return;  // stage reads the f32 x itself
    const int b = id / tiles, t = id % tiles;
    const int y0 = (t / tiles_x) * kMRows, x0 = (t % tiles_x) * kMCols;
    if (ZERO) zf = 0;
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
        if (ZERO) {
          const bool z = zero_code(gy, gx, p.Hi, PRO == kQuant ? p.sw : p.Wi, p.halo);
          zf |= (uint32_t)z << k;
          raw[k] = z ? make_uint4(0, 0, 0, 0) : __ldg(src);
        } else {
          raw[k] = PRO == kCodes && zero_code(gy, gx, p.Hi, p.Wi, p.halo)
              ? make_uint4(0, 0, 0, 0) : __ldg(src);
        }
      }
    }
  };
  auto fetch_y = [&](int id) {
    if (F32IN) return;  // combine reads the f32 yp itself
    const int b = id / tiles, t = id % tiles;
    const int y0 = (t / tiles_x) * kMRows, x0 = (t % tiles_x) * kMCols;
#pragma unroll
    for (int k = 0; k < In::NI; ++k) {
      const int px = p0 + k * In::PPI;
      const int gy = y0 + px / kMHC - 1, gx = x0 + px % kMHC - 1;
      if (loader && px < kMPix && !(ZERO && zero_code(gy, gx, p.Hi, p.Wi, p.halo))) {
        const int sy = src_index(gy, p.Hi, p.halo), sx = src_index(gx, p.Wi, p.halo);
        yraw[k] = __ldg(reinterpret_cast<const uint4*>(
            p.yp + (((size_t)b * p.Hi + sy) * p.Wi + sx) * C + chunk * In::VB));
      }
    }
  };
  // v = bf16(bf16(r2*a2 + c2) + yp) [max(v, floor)] into raw, in registers
  auto combine = [&](int id) {
    const int b = id / tiles, t = id % tiles;
    const int y0 = (t / tiles_x) * kMRows, x0 = (t % tiles_x) * kMCols;
    float sa[8], sc[8], fl[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[j] = __ldg(p.a2 + b * C + chunk * 8 + j);
      sc[j] = __ldg(p.c2 + b * C + chunk * 8 + j);
      if (PRO == kSkipAct) fl[j] = __ldg(p.tau + b * C + chunk * 8 + j);
    }
#pragma unroll
    for (int k = 0; k < In::NI; ++k) {
      const int px = p0 + k * In::PPI;
      if (!loader || px >= kMPix || (ZERO && ((zf >> k) & 1u))) continue;
      uint32_t r4[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
      float yv[8];
      if (F32IN) {
        const int gy = y0 + px / kMHC - 1, gx = x0 + px % kMHC - 1;
        const int sy = src_index(gy, p.Hi, p.halo), sx = src_index(gx, p.Wi, p.halo);
        const float4* src = reinterpret_cast<const float4*>(
            p.yp32 + (((size_t)b * p.Hi + sy) * p.Wi + sx) * C + chunk * In::VB);
        const float4 u = __ldg(src), w = __ldg(src + 1);
        yv[0] = u.x; yv[1] = u.y; yv[2] = u.z; yv[3] = u.w;
        yv[4] = w.x; yv[5] = w.y; yv[6] = w.z; yv[7] = w.w;
      } else {
        const uint32_t y4[4] = {yraw[k].x, yraw[k].y, yraw[k].z, yraw[k].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) yv[j] = j & 1 ? bf16_hi(y4[j / 2]) : bf16_lo(y4[j / 2]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float r = e ? bf16_hi(r4[j]) : bf16_lo(r4[j]);
          const float y = yv[2 * j + e];
          const float t = bf16_round(__fadd_rn(__fmul_rn(r, sa[2 * j + e]), sc[2 * j + e]));
          v[e] = bf16_round(__fadd_rn(t, y));
          if (PRO == kSkipAct) v[e] = fmaxf(v[e], fl[2 * j + e]);
        }
        r4[j] = bf16_pack(v[0], v[1]);
      }
      raw[k] = make_uint4(r4[0], r4[1], r4[2], r4[3]);
    }
  };
  auto stage = [&](int id) {
    const int b = id / tiles;
    float qa[8], qc[8], qt[8];
    if (PRO == kQuant || is_skip(PRO)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qa[j] = __ldg(p.a + b * C + chunk * 8 + j);
        qc[j] = __ldg(p.c + b * C + chunk * 8 + j);
        if (TAU) qt[j] = __ldg(p.tau + b * C + chunk * 8 + j);
      }
    }
    // K5 writes v once: from the blocks of output channels 0.., at the
    // tile's interior pixels inside the image
    const bool vwrite = is_skip(PRO) && p.vout != nullptr && co0 == 0;
    int vy0 = 0, vx0 = 0;
    if (is_skip(PRO) || F32Q) {
      const int t = id % tiles;
      vy0 = (t / tiles_x) * kMRows;
      vx0 = (t % tiles_x) * kMCols;
    }
#pragma unroll
    for (int k = 0; k < In::NI; ++k) {
      const int px = p0 + k * In::PPI;
      if (!loader || px >= kMPix) continue;
      uint8_t* dst = s_x + px * PX + chunk * In::VB;
      if (PRO == kCodes) {
        *reinterpret_cast<uint4*>(dst) = raw[k];
      } else if (F32Q) {
        // the f32 x, 8 channels as two 16-byte loads, quantized unrounded
        const int gy = vy0 + px / kMHC - 1, gx = vx0 + px % kMHC - 1;
        uint32_t q[2] = {0u, 0u};
        if (!(ZERO && zero_code(gy, gx, p.Hi, PRO == kQuant ? p.sw : p.Wi, p.halo))) {
          const int sy = src_index(gy, p.Hi, p.halo), sx = src_index(gx, p.Wi, p.halo);
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(p.x) + (((size_t)b * p.Hi + sy) * p.Wi + sx) * C +
              chunk * In::VB);
          const float4 u = __ldg(src), w = __ldg(src + 1);
          const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            q[j >> 2] |= (uint32_t)(quantize(v[j], qa[j], qc[j], p.lo) & 0xff) << (8 * (j & 3));
        }
        *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
      } else if (ZERO && ((zf >> k) & 1u)) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      } else {
        const uint32_t w4[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t q0, q1;
          if (PRO == kCast) {
            q0 = sat_cast(bf16_lo(w4[j])) & 0xff;
            q1 = sat_cast(bf16_hi(w4[j])) & 0xff;
          } else if (TAU) {
            q0 = quantize_floor(bf16_lo(w4[j]), qa[2 * j], qc[2 * j], qt[2 * j], p.lo) & 0xff;
            q1 = quantize_floor(bf16_hi(w4[j]), qa[2 * j + 1], qc[2 * j + 1], qt[2 * j + 1],
                                p.lo) & 0xff;
          } else {
            q0 = quantize(bf16_lo(w4[j]), qa[2 * j], qc[2 * j], p.lo) & 0xff;
            q1 = quantize(bf16_hi(w4[j]), qa[2 * j + 1], qc[2 * j + 1], p.lo) & 0xff;
          }
          q[j >> 1] |= (q0 | (q1 << 8)) << (16 * (j & 1));
        }
        if (ZERO && is_skip(PRO) && vx0 + px % kMHC - 1 >= p.sw) q[0] = q[1] = 0u;
        *reinterpret_cast<uint2*>(dst) = make_uint2(q[0], q[1]);
        if (is_skip(PRO)) {
          const int hr = px / kMHC, hc = px % kMHC;
          const int gy = vy0 + hr - 1, gx = vx0 + hc - 1;
          if (vwrite && hr >= 1 && hr <= kMRows && hc >= 1 && hc <= kMCols && gy < p.H &&
              gx < p.W)
            *reinterpret_cast<uint4*>(p.vout + (((size_t)b * p.H + gy) * p.W + gx) * C +
                                      chunk * In::VB) = raw[k];
        }
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

  // K5 holds v, not r2 and yp: both are loaded and combined at once
  fetch(tile);
  if (is_skip(PRO)) {
    fetch_y(tile);
    combine(tile);
  }
  stage(tile);
  __syncthreads();
  MMA_PHASE_START
  for (;;) {
    const int next = tile + per_half;
    if (next < total) {
      fetch(next);  // in flight while the MMAs run (K5: combined first)
      if (is_skip(PRO)) {
        fetch_y(next);
        combine(next);
      }
    }
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
        const int tap = s / KC, kc = s % KC;
        const int dy = tap / TP::K + TP::OFF, dx = tap % TP::K + TP::OFF;
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
              if (y0 + r < p.H && x0 + col < p.sw) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  s1[e] = __fadd_rn(s1[e], f[e]);
                  s2[e] = __fadd_rn(s2[e], __fmul_rn(f[e], f[e]));
                }
              }
            } else if (EPI == kSiteS8 && (p.flags & kFAff)) {
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
    if (yadd && !F32IN) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int i = tid + j * kMThreads, px = i / CPP, c8 = i % CPP;
        const int oy = y0 + px / kMCols, ox = x0 + px % kMCols;
        if (c8 < vchunks && oy < p.H && ox < p.W)
          yv[j] = __ldg(reinterpret_cast<const uint4*>(
              p.yadd + (((size_t)b * p.H + oy) * p.W + ox) * p.CO + co0 + 8 * c8));
      }
    }
    if (is_skip(PRO)) {
      // K5's loop stays rolled: unrolled, its per-pass offsets are hoisted out
      // of the tile loop and spilled (see the top of the file)
#pragma unroll 1
      for (int j = 0; j < NS; ++j) {
        const int i = tid + j * kMThreads, px = i / CPP, c8 = i % CPP;
        const int oy = y0 + px / kMCols, ox = x0 + px % kMCols;
        if (c8 < vchunks && oy < p.H && ox < p.W)
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                                    (((size_t)b * p.H + oy) * p.W + ox) * p.CO + co0 + 8 * c8) =
              *reinterpret_cast<const uint4*>(s_x + px * OUT + 16 * c8);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int i = tid + j * kMThreads, px = i / CPP, c8 = i % CPP;
        const int oy = y0 + px / kMCols, ox = x0 + px % kMCols;
        if (c8 >= vchunks || oy >= p.H || ox >= p.W) continue;
        const size_t o = (((size_t)b * p.H + oy) * p.W + ox) * p.CO + co0 + 8 * c8;
        uint4 v = *reinterpret_cast<const uint4*>(s_x + px * OUT + 16 * c8);
        if (is_emit(EPI)) {
          // K2: the s8 emit, clamp(rint(f*qa + qc), 0, 127), or with the floor
          // row clamp(rint(max(f*qa + qc, tau)), qlo, 127)
          const float* ep = s_rows + 4 * MCO + 8 * c8;  // qa, qc, tau rows
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          uint32_t q[2] = {0u, 0u};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float f = k & 1 ? bf16_hi(w[k / 2]) : bf16_lo(w[k / 2]);
            const int code = EPI == kEmitS8F
                ? quantize_floor(f, ep[k], ep[MCO + k], ep[2 * MCO + k], p.qlo)
                : quantize(f, ep[k], ep[MCO + k], 0.0f);
            q[k / 4] |= (uint32_t)(code & 0xff) << (8 * (k % 4));
          }
          if (ox >= p.sw) q[0] = q[1] = 0;  // padding columns stay zero codes
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) = make_uint2(q[0], q[1]);
          continue;
        }
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
            float y8[8];
            if (F32IN) {  // the f32 residual, two 16-byte loads
              const float4* src = reinterpret_cast<const float4*>(p.yadd32 + o);
              const float4 u = __ldg(src), w = __ldg(src + 1);
              y8[0] = u.x; y8[1] = u.y; y8[2] = u.z; y8[3] = u.w;
              y8[4] = w.x; y8[5] = w.y; y8[6] = w.z; y8[7] = w.w;
            } else {
              const uint32_t yw[4] = {yv[j].x, yv[j].y, yv[j].z, yv[j].w};
#pragma unroll
              for (int k = 0; k < 8; ++k) y8[k] = k & 1 ? bf16_hi(yw[k / 2]) : bf16_lo(yw[k / 2]);
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              float y = y8[k];
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

template <int C, int PRO, int EPI, bool TAU, bool ZERO = false, bool F32IN = false,
          int GEO = kGeo33>
int launch_mma_c(const Args& p, float* sums, cudaStream_t stream) {
  const size_t smem = MmaSmem<C>::bytes;
  auto kern = mma_kernel<C, PRO, EPI, TAU, ZERO, F32IN, GEO>;
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

// an instance at the tap geometry p.geo: the 2x2 forms are built for K4
// under the zero halo (both pads) and K3 (pad 0)
template <int C, int PRO, int EPI, bool ZERO>
int launch_mma_geo(const Args& p, float* sums, cudaStream_t s) {
  if (p.geo == kGeo33) return launch_mma_c<C, PRO, EPI, false, ZERO>(p, sums, s);
  if constexpr (PRO == kQuant && EPI == kRawStats && ZERO) {
    if (p.geo == kGeo22p1) return launch_mma_c<C, PRO, EPI, false, true, false, kGeo22p1>(p, sums, s);
    if (p.geo == kGeo22p0) return launch_mma_c<C, PRO, EPI, false, true, false, kGeo22p0>(p, sums, s);
  }
  if constexpr (PRO == kCodes && EPI == kSiteS8) {
    if (p.geo == kGeo22p0) return launch_mma_c<C, PRO, EPI, false, false, false, kGeo22p0>(p, sums, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the tensor-core core: C in {64, 128} (Johnson, NST; K4 also under the
// zero halo, Torch7, with sw and the 2x2 taps; K3 with the 2x2 taps at pad
// 0 under the zero halo); ReCoNet's K4 at C in {96, 192}, with or without
// the TLU floor, and its K3 at C = 192 and, for the static-norm decoder's
// d2 (96 -> 192), at C = 96 with the edge halo and a bare bf16 raw out
template <int PRO, int EPI>
int launch_mma(const Args& p, int C, float* sums, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tau = p.tau != nullptr;
  if (p.geo != kGeo33 && (p.halo != kHaloZero || tau || (C != 64 && C != 128)))
    return (int)cudaErrorInvalidValue;
  if constexpr (PRO == kQuant) {
    if (p.halo == kHaloZero) {
      if (tau) return (int)cudaErrorInvalidValue;
      if (C == 128) return launch_mma_geo<128, PRO, EPI, true>(p, sums, s);
      if (C == 64) return launch_mma_geo<64, PRO, EPI, true>(p, sums, s);
      return (int)cudaErrorInvalidValue;
    }
  }
  if (!tau && C == 128) return launch_mma_geo<128, PRO, EPI, false>(p, sums, s);
  if (!tau && C == 64) return launch_mma_geo<64, PRO, EPI, false>(p, sums, s);
  if constexpr (PRO == kQuant) {
    if (C == 192) return tau ? launch_mma_c<192, PRO, EPI, true>(p, sums, s)
                             : launch_mma_c<192, PRO, EPI, false>(p, sums, s);
    if (C == 96) return tau ? launch_mma_c<96, PRO, EPI, true>(p, sums, s)
                            : launch_mma_c<96, PRO, EPI, false>(p, sums, s);
  } else {
    if (!tau && C == 192) return launch_mma_c<192, PRO, EPI, false>(p, sums, s);
    if (!tau && C == 96 && p.halo == 1 && p.flags == 0)
      return launch_mma_c<96, PRO, EPI, false>(p, sums, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K2 on the tensor-core core: the floor-0 emit at C in {64, 128} (also
// under the zero halo, with sw) and 192; the floored emit (kEmitS8F) at 192.
// At C = 192, CO = 192 (ReCoNet's res sites) or, under the edge halo, 384
// (its static-norm d1, either emit): the same instances, whose blocks walk
// the CO / 64 channel groups
template <int EPI>
int launch_mma_s8o(const Args& p, int C, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (C == 192 && p.CO != 192 && !(p.CO == 384 && p.halo == 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (EPI == kEmitS8F) {
    if (C == 192 && p.halo != kHaloZero)
      return launch_mma_c<192, kQuant, EPI, false>(p, nullptr, s);
  } else if (p.halo == kHaloZero) {
    if (C == 128) return launch_mma_c<128, kQuant, EPI, false, true>(p, nullptr, s);
    if (C == 64) return launch_mma_c<64, kQuant, EPI, false, true>(p, nullptr, s);
  } else {
    if (C == 128) return launch_mma_c<128, kQuant, EPI, false>(p, nullptr, s);
    if (C == 64) return launch_mma_c<64, kQuant, EPI, false>(p, nullptr, s);
    if (C == 192) return launch_mma_c<192, kQuant, EPI, false>(p, nullptr, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K5 on the tensor-core core: kSkip at C in {64, 128} (also under the zero
// halo), kSkipAct at 192
template <int PRO>
int launch_mma_skip(const Args& p, int C, float* sums, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (PRO == kSkipAct) {
    if (C == 192 && p.halo != kHaloZero)
      return launch_mma_c<192, PRO, kRawStats, false>(p, sums, s);
  } else if (p.halo == kHaloZero) {
    if (C == 128) return launch_mma_c<128, PRO, kRawStats, false, true>(p, sums, s);
    if (C == 64) return launch_mma_c<64, PRO, kRawStats, false, true>(p, sums, s);
  } else {
    if (C == 128) return launch_mma_c<128, PRO, kRawStats, false>(p, sums, s);
    if (C == 64) return launch_mma_c<64, PRO, kRawStats, false>(p, sums, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4's forms of the int8 probes (mk31, mk28): C = 128, reflect halo, no floor
template <int PRO, int EPI>
int launch_mma_probe(const Args& p, int C, float* sums, void* stream) {
  if (!valid(p) || p.tau != nullptr || p.halo != 0 || C != 128) return (int)cudaErrorInvalidValue;
  return launch_mma_c<128, PRO, EPI, false>(p, sums, static_cast<cudaStream_t>(stream));
}

// The f32-operand forms (F32IN), built at the channel counts and halos the
// float32 chains reach: K4 at C = 128 (Johnson's reflect halo) and 192
// (ReCoNet's res grid, reflect, and its d1, edge), and under the zero halo
// at 64 and 128 (Torch7); K5 at 128 (Johnson), kSkipAct at 192 (ReCoNet),
// and under the zero halo at 64 and 128 (Torch7); K2 at 128 (Johnson; under
// the zero halo with sw, NST_Train) and 192 (ReCoNet, with the floored emit
// too; under the edge halo also at CO = 384, its static-norm d1); K3 at 128
// and 192. No floor (tau) on K4's. K4's 2x2 taps at pads 1 and 0 under the
// zero halo at C = 128 (conv2 and deconv1 of the NST and Torch7 nets); K3's
// 2x2 form reads no f32 operand on any path (its residual is never added).
int launch_mma_f32_k4(const Args& p, int C, float* sums, cudaStream_t s) {
  if (!valid(p) || p.tau != nullptr) return (int)cudaErrorInvalidValue;
  if (p.geo != kGeo33) {  // the 2x2 forms: zero halo, C = 128
    if (p.halo != kHaloZero || C != 128) return (int)cudaErrorInvalidValue;
    if (p.geo == kGeo22p1)
      return launch_mma_c<128, kQuant, kRawStats, false, true, true, kGeo22p1>(p, sums, s);
    if (p.geo == kGeo22p0)
      return launch_mma_c<128, kQuant, kRawStats, false, true, true, kGeo22p0>(p, sums, s);
    return (int)cudaErrorInvalidValue;
  }
  if (p.halo == kHaloZero) {
    if (C == 128) return launch_mma_c<128, kQuant, kRawStats, false, true, true>(p, sums, s);
    if (C == 64) return launch_mma_c<64, kQuant, kRawStats, false, true, true>(p, sums, s);
    return (int)cudaErrorInvalidValue;
  }
  if (C == 128) return launch_mma_c<128, kQuant, kRawStats, false, false, true>(p, sums, s);
  if (C == 192) return launch_mma_c<192, kQuant, kRawStats, false, false, true>(p, sums, s);
  return (int)cudaErrorInvalidValue;
}

int launch_mma_f32_k5(const Args& p, int C, float* sums, cudaStream_t s) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (p.tau != nullptr) {
    if (C == 192 && p.halo != kHaloZero)
      return launch_mma_c<192, kSkipAct, kRawStats, false, false, true>(p, sums, s);
    return (int)cudaErrorInvalidValue;
  }
  if (p.halo == kHaloZero) {
    if (C == 128) return launch_mma_c<128, kSkip, kRawStats, false, true, true>(p, sums, s);
    if (C == 64) return launch_mma_c<64, kSkip, kRawStats, false, true, true>(p, sums, s);
    return (int)cudaErrorInvalidValue;
  }
  if (C == 128) return launch_mma_c<128, kSkip, kRawStats, false, false, true>(p, sums, s);
  return (int)cudaErrorInvalidValue;
}

int launch_mma_f32_k2(const Args& p, int C, bool floored, cudaStream_t s) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (C == 192 && p.CO != 192 && !(p.CO == 384 && p.halo == 1)) return (int)cudaErrorInvalidValue;
  if (floored) {
    if (C == 192 && p.halo != kHaloZero)
      return launch_mma_c<192, kQuant, kEmitS8F, false, false, true>(p, nullptr, s);
    return (int)cudaErrorInvalidValue;
  }
  if (p.halo == kHaloZero) {
    if (C == 128) return launch_mma_c<128, kQuant, kEmitS8, false, true, true>(p, nullptr, s);
    return (int)cudaErrorInvalidValue;
  }
  if (C == 128) return launch_mma_c<128, kQuant, kEmitS8, false, false, true>(p, nullptr, s);
  if (C == 192) return launch_mma_c<192, kQuant, kEmitS8, false, false, true>(p, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

int launch_mma_f32_k3(const Args& p, int C, cudaStream_t s) {
  if (!valid(p) || !(p.flags & kFYadd)) return (int)cudaErrorInvalidValue;
  if (C == 128) return launch_mma_c<128, kCodes, kSiteS8, false, false, true>(p, nullptr, s);
  if (C == 192) return launch_mma_c<192, kCodes, kSiteS8, false, false, true>(p, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// mma_s2_kernel: K8a and K8b on the int8 tensor cores (stride 2)
// ---------------------------------------------------------------------------

constexpr int kSHR = 2 * kMRows + 1, kSHC = 2 * kMCols + 1;  // haloed input tile, 17 x 33
constexpr int kSPix = kSHR * kSHC;

// The haloed tile is staged as its four (row, column) parity planes, (0, 0),
// (0, 1), (1, 0), (1, 1) in that order: at stride 2, tap (dy, dx) of output
// pixel (r, c) reads tile pixel (2r + dy, 2c + dx), which is pixel
// (r + dy/2, c + dx/2) of plane (dy%2, dx%2), so the 16 A rows of an
// ldmatrix are 16 consecutive pixels of one plane row.
__host__ __device__ constexpr int s2_plane_rows(int pr) { return (kSHR + 1 - pr) / 2; }
__host__ __device__ constexpr int s2_plane_cols(int pc) { return (kSHC + 1 - pc) / 2; }
__host__ __device__ constexpr int s2_plane_off(int pr, int pc) {
  return (pr ? s2_plane_rows(0) * (s2_plane_cols(0) + s2_plane_cols(1)) : 0) +
         (pc ? s2_plane_rows(pr) * s2_plane_cols(0) : 0);
}
// the staged pixel of haloed tile pixel (hr, hc)
__host__ __device__ constexpr int s2_pixel(int hr, int hc) {
  return s2_plane_off(hr & 1, hc & 1) + (hr >> 1) * s2_plane_cols(hc & 1) + (hc >> 1);
}
static_assert(s2_plane_off(1, 1) + s2_plane_rows(1) * s2_plane_cols(1) == kSPix,
              "the planes tile the haloed tile");

// The block at C input channels and MCO output channels a block, with one
// raw input tile in flight. MCO = 64: 8 row warps of one tile row; MCO =
// 128: 4 row warps of two tile rows x 2 channel warps of 64, as mma_kernel
// at C <= 128. Shared memory: the weights; the planes of codes (pixel stride
// C + 16 bytes: the eight pixels an ldmatrix reads, consecutive in a plane,
// sit in 32 distinct banks), the staged bf16 outputs over them after the
// MMAs; ws, bias and the sums of each row warp; the raw input tile (bf16, or
// f32 under F32IN). In bytes (weights + planes + rows + raw tile):
//   K8a <32, 64>:   27,648 + 26,928 + 4,608 + 35,904 =  95,088, two blocks an SM
//   K8a f32 input:  27,648 + 26,928 + 4,608 + 71,808 = 130,992, one block an SM
//   K8b <64, 128>:  92,160 + 44,880 + 5,120 + 71,808 = 213,968, one block an SM
template <int C, int MCO, bool F32IN = false>
struct MmaS2Smem {
  static constexpr int RW = kMThreads / 32 / (MCO / 64);  // row warps
  static constexpr int MI = kMRows / RW;                  // tile rows a warp
  static constexpr int PX = C + 16;
  static constexpr int OUT = 2 * MCO + 16;
  static constexpr int W = 9 * MCO * PX;
  static constexpr int X = kSPix * PX > kMRows * kMCols * OUT ? kSPix * PX : kMRows * kMCols * OUT;
  static constexpr int ROWS = sizeof(float) * (2 + 2 * RW) * MCO;
  static constexpr int RAW = kSPix * (F32IN ? 4 : 2) * C;
  static constexpr size_t bytes = W + X + ROWS + RAW;
  static constexpr int BLOCKS = MCO == 64 && !F32IN ? 2 : 1;  // blocks an SM
  static_assert(bytes <= 232448 && BLOCKS * (bytes + 1024) <= 233472,
                "the blocks fit in an SM's shared memory");
};

// quantize for a finite v and an integer floor lo >= -127, as the code's
// low byte: equal to quantize's. The clamp commutes with the round (lo and
// 127 are integers), and adding 1.5 * 2^23 to a value in [-127, 127] rounds
// it to the nearest integer, ties to even, into the float's low mantissa
// bits: 0x4B400000 + q. Two min/max and an add in place of the convert,
// which runs at a quarter of their rate.
__device__ __forceinline__ int quantize_i(float v, float a, float c, float lo) {
  return __float_as_int(
      __fadd_rn(fminf(fmaxf(__fadd_rn(__fmul_rn(v, a), c), lo), 127.0f), 12582912.0f));
}

// the low bytes of four ints, q0 first
__device__ __forceinline__ uint32_t pack4_s8(int q0, int q1, int q2, int q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// the haloed tile's bf16 input, one 16-byte chunk (8 channels) a thread and pass
template <int C>
struct MmaS2In {
  static constexpr int CH = C / 8;                     // chunks per pixel
  static constexpr int PPI = kMThreads / CH;           // pixels per pass
  static constexpr int NI = (kSPix + PPI - 1) / PPI;   // passes
};

// K4 at stride 2 over the pixel reflect halo: the quantizing prologue and
// the raw + sums epilogue of mma_kernel, with the haloed tile in parity
// planes. Block k of `per_half` blocks serves output channels MCO·(k /
// per_half).. and walks tiles k % per_half, + per_half, ... of the B·tiles
// 8x16 output tiles; warp w computes tile rows MI·(w % RW).. (16 pixels
// each) x output channels 64·(w / RW)..+63, 9 taps x C/32 k32 steps of 8
// MMAs a row. The raw bf16 input of the next tile is brought into shared
// memory by cp.async, issued as soon as the current one is quantized, so
// those loads run through the MMAs, the epilogue and the stores of the tile
// before it (see the top of the file for the choices). F32IN (K8a under
// float32: conv1's f32 output, which the Pallas prologue reads unrounded):
// the raw tile is f32, two 16-byte copies a chunk into a staging slot of
// twice the size, quantized from there; the block then no longer fits
// twice in an SM and runs one an SM.
template <int C, int MCO, bool F32IN>
__global__ void __launch_bounds__(kMThreads, MmaS2Smem<C, MCO, F32IN>::BLOCKS)
    mma_s2_kernel(Args p, int tiles_x, int tiles, int per_half) {
  using S = MmaS2Smem<C, MCO, F32IN>;
  using In = MmaS2In<C>;
  constexpr int PX = S::PX, OUT = S::OUT, RW = S::RW, MI = S::MI;
  constexpr int CW = C / 4, KC = C / 32, KS = 9 * KC;
  // the fetch and stage loops unrolled whole at C = 32; at C = 64 (18
  // passes) by 6: unrolled whole, ptxas spilled 148 bytes of K8b and the
  // kernel took about 1.5x as long (PERF.md)
  constexpr int UN = C == 32 ? In::NI : 6;
  extern __shared__ __align__(16) uint8_t smem8[];
  uint8_t* s_w = smem8;                                   // [9][MCO][PX] weights
  uint8_t* s_x = smem8 + S::W;                            // parity planes of codes, then outputs
  float* s_rows = reinterpret_cast<float*>(s_x + S::X);   // ws, bias [MCO]
  float* s_sum = s_rows + 2 * MCO;                        // [RW][2][MCO]
  uint8_t* s_raw = reinterpret_cast<uint8_t*>(s_rows) + S::ROWS;  // [kSPix][C] bf16 or f32
  constexpr int RB = F32IN ? 4 : 2;  // bytes a raw channel

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp % RW, cw = warp / RW;  // row warp, 64-channel warp
  const int co0 = (blockIdx.x / per_half) * MCO;
  const int total = p.B * tiles;
  int tile = blockIdx.x % per_half;
  if (tile >= total) return;

  const int chunk = tid % In::CH, p0 = tid / In::CH;
  // tile `id`'s raw input into s_raw (one commit group; none past the last
  // tile, so that the wait count holds)
  // (a tile clear of the image's edges takes no reflect; offsets within an
  // image are 32-bit)
  auto fetch = [&](int id) {
    if (id < total) {
      const int b = id / tiles, t = id % tiles;
      const int iy0 = 2 * (t / tiles_x) * kMRows - 1, ix0 = 2 * (t % tiles_x) * kMCols - 1;
      const size_t img = (size_t)b * p.Hi * p.Wi * C + chunk * 8;
      const uint32_t dst = smem_addr(s_raw) + chunk * 8 * RB;
      const bool inner = iy0 >= 0 && ix0 >= 0 && iy0 + kSHR <= p.Hi && ix0 + kSHC <= p.Wi;
#pragma unroll UN
      for (int k = 0; k < In::NI; ++k) {
        const int px = p0 + k * In::PPI;
        if (px < kSPix) {
          int sy = iy0 + px / kSHC, sx = ix0 + px % kSHC;
          if (!inner) {
            sy = src_index(sy, p.Hi, 0);
            sx = src_index(sx, p.Wi, 0);
          }
          const size_t off = img + (size_t)(sy * p.Wi + sx) * C;
          if (F32IN) {
            const float* src = static_cast<const float*>(p.x) + off;
            cp_async16(dst + px * RB * C, src, true);
            cp_async16(dst + px * RB * C + 16, src + 4, true);
          } else {
            cp_async16(dst + px * RB * C, static_cast<const __nv_bfloat16*>(p.x) + off, true);
          }
        }
      }
    }
    cp_async_commit();
  };
  // 8 channels (a 16-byte bf16 chunk, or two of f32) quantized into staged
  // pixel px
  auto put = [&](int px, const uint8_t* raw, const float (&qa)[8], const float (&qc)[8],
                 float lo) {
    float v[8];
    if (F32IN) {
      const float4 u = *reinterpret_cast<const float4*>(raw);
      const float4 w = *reinterpret_cast<const float4*>(raw + 16);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(raw);
      const uint32_t w4[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = bf16_lo(w4[j]);
        v[2 * j + 1] = bf16_hi(w4[j]);
      }
    }
    int q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = quantize_i(v[j], qa[j], qc[j], lo);
    *reinterpret_cast<uint2*>(s_x + s2_pixel(px / kSHC, px % kSHC) * PX + chunk * 8) =
        make_uint2(pack4_s8(q[0], q[1], q[2], q[3]), pack4_s8(q[4], q[5], q[6], q[7]));
  };
  // tile `id` quantized into the planes from s_raw
  auto stage = [&](int id) {
    const int b = id / tiles;
    float qa[8], qc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qa[j] = __ldg(p.a + b * C + chunk * 8 + j);
      qc[j] = __ldg(p.c + b * C + chunk * 8 + j);
    }
    const float lo = p.lo;
    const uint8_t* src = s_raw + chunk * 8 * RB;
#pragma unroll UN
    for (int k = 0; k < In::NI; ++k) {
      const int px = p0 + k * In::PPI;
      if (px < kSPix) put(px, src + px * RB * C, qa, qc, lo);
    }
  };

  fetch(tile);
  static_assert(9 * CW * MCO % kMThreads == 0, "weight words split evenly");
#pragma unroll 2
  for (int j = 0; j < 9 * CW * MCO / kMThreads; ++j) {
    const int i = tid + j * kMThreads;
    const int n = i % MCO, k = (i / MCO) % CW, t = i / (MCO * CW);
    *reinterpret_cast<int32_t*>(s_w + (t * MCO + n) * PX + 4 * k) =
        p.wk[((size_t)t * CW + k) * p.CO + co0 + n];
  }
  for (int i = tid; i < 2 * MCO; i += kMThreads)
    s_rows[i] = (i < MCO ? p.ws : p.bias)[co0 + i % MCO];

  const int g = lane >> 2, tg = lane & 3;
  // A rows: 16 consecutive pixels of a plane row (lanes 0-15: bytes 0-15 of
  // the k32 slice, 16-31: bytes 16-31); B rows as mma_kernel's, from the
  // warp's 64 output channels
  const uint32_t a_lane = smem_addr(s_x) + (lane & 15) * PX + (lane >> 4) * 16;
  const uint32_t b_lane = smem_addr(s_w) + (cw * 64 + (lane >> 4) * 8 + (lane & 7)) * PX +
                          ((lane >> 3) & 1) * 16;

  MMA_PHASE_START
#pragma unroll 1
  for (;;) {
    cp_async_wait<0>();
    __syncthreads();  // the raw tile has landed; the planes are free
    MMA_PHASE(4)
    stage(tile);
    __syncthreads();  // the planes are written; s_raw is free
    fetch(tile + per_half);
    MMA_PHASE(0)

    int acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
    {
      auto load = [&](int s, uint32_t (&a)[MI][4], uint32_t (&bq)[8][2]) {
        const int tap = s / KC, kc = s % KC, dy = tap / 3, dx = tap % 3;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(a[mi], a_lane + (s2_plane_off(dy & 1, dx & 1) +
                                   (rw * MI + mi + (dy >> 1)) * s2_plane_cols(dx & 1) +
                                   (dx >> 1)) * PX +
                             kc * 32);
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
      // fragments single-buffered: the other block of the SM (K8a) or the
      // other warps (K8b) hide the ldmatrix latency, and a second buffer
      // spills
      uint32_t af[MI][4], bfr[8][2];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        load(s, af, bfr);
        mmas(af, bfr);
      }
    }
    MMA_PHASE(1)
    __syncthreads();  // the planes are free: the epilogue stages its outputs there

    // f = bf16(acc·ws + bias) of tile rows `row`, pixels g and g+8, channels
    // n = 8nj + 2tg, +1 of the warp's 64; sums over the pixels inside the
    // image, over the warp's MI rows in registers, then folded over the 8
    // lanes g of a channel (one shuffle fold for the MI rows: K8b's two
    // rows folded apart cost 3.8% of its time), then per row warp
    const int b = tile / tiles, t = tile % tiles;
    const int y0 = (t / tiles_x) * kMRows, x0 = (t % tiles_x) * kMCols;
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int n = cw * 64 + nj * 8 + 2 * tg;
      const float2 ws = *reinterpret_cast<const float2*>(s_rows + n);
      const float2 bi = *reinterpret_cast<const float2*>(s_rows + MCO + n);
      float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = rw * MI + mi;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = g + 8 * h;
          const float f[2] = {
              bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][nj][2 * h]), ws.x), bi.x)),
              bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[mi][nj][2 * h + 1]), ws.y), bi.y))};
          if (y0 + row < p.H && x0 + col < p.W) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s1[e] = __fadd_rn(s1[e], f[e]);
              s2[e] = __fadd_rn(s2[e], __fmul_rn(f[e], f[e]));
            }
          }
          *reinterpret_cast<uint32_t*>(s_x + (row * kMCols + col) * OUT + 2 * n) =
              bf16_pack(f[0], f[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1[e] = __fadd_rn(s1[e], __shfl_xor_sync(0xffffffffu, s1[e], m));
          s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(0xffffffffu, s2[e], m));
        }
        if (g == 0) {
          s_sum[(rw * 2 + 0) * MCO + n + e] = s1[e];
          s_sum[(rw * 2 + 1) * MCO + n + e] = s2[e];
        }
      }
    }
    __syncthreads();
    MMA_PHASE(2)

    // the staged outputs, 8 channels (16 bytes) a thread and pass, coalesced
    constexpr int CPP = MCO / 8;
#pragma unroll
    for (int j = 0; j < kMRows * kMCols * CPP / kMThreads; ++j) {
      const int i = tid + j * kMThreads, px = i / CPP, c8 = i % CPP;
      const int oy = y0 + px / kMCols, ox = x0 + px % kMCols;
      if (oy < p.H && ox < p.W)
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                                  (((size_t)b * p.H + oy) * p.W + ox) * p.CO + co0 + 8 * c8) =
            *reinterpret_cast<const uint4*>(s_x + px * OUT + 16 * c8);
    }
    if (tid < 2 * MCO) {
      const int s = tid / MCO, n = tid % MCO;
      float v = 0.0f;
      for (int w = 0; w < RW; ++w) v = __fadd_rn(v, s_sum[(w * 2 + s) * MCO + n]);
      p.part[(((size_t)b * tiles + t) * 2 + s) * p.CO + co0 + n] = v;
    }
    MMA_PHASE(3)
    tile += per_half;
    if (tile >= total) break;
  }
  cp_async_wait<0>();
  MMA_PHASE_END
}

template <int C, int MCO, bool F32IN = false>
int launch_mma_s2(const Args& p, float* sums, cudaStream_t stream) {
  using S = MmaS2Smem<C, MCO, F32IN>;
  if (p.CO % MCO) return (int)cudaErrorInvalidValue;
  auto kern = mma_s2_kernel<C, MCO, F32IN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles_x = (p.W + kMCols - 1) / kMCols;
  const int tiles = ((p.H + kMRows - 1) / kMRows) * tiles_x;
  const int halves = p.CO / MCO;
  int per_half = S::BLOCKS * sms / halves;
  per_half = per_half < p.B * tiles ? per_half : p.B * tiles;
  per_half = per_half > 1 ? per_half : 1;
  kern<<<per_half * halves, kMThreads, S::bytes, stream>>>(p, tiles_x, tiles, per_half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_mma<<<p.B * 2 * p.CO / 32, 256, 0, stream>>>(p.part, sums, p.B, tiles, p.CO);
  return (int)cudaGetLastError();
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

// ---------------------------------------------------------------------------
// d3s8_mma_kernel: K6 on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int kDPX = kRC + 16;      // bytes per staged pixel and per weight row
constexpr int kDStrip = 32;         // output columns a warp: two 16-pixel M tiles
constexpr int kDHC = kDStrip + 4;   // staged columns of a conv row (2-pixel halo each side)
constexpr int kDBuf = 3;            // staged conv rows a warp: the one computed, two in flight

struct D3Smem {
  static constexpr int W = 5 * kCOT * kDPX;                  // [dx][slot][kDPX] weights
  static constexpr int ROW = kDHC * kDPX;                    // one staged conv row
  static constexpr int OUT = kDStrip * kOut * 2;             // one output row of a warp, bf16
  static constexpr int WARP = kDBuf * ROW + OUT;
  static constexpr size_t bytes = W + kWarps * WARP;
};

// The B row (slot) that lane n = 12·dy + o of the tap-packed weights takes:
// with o = 3·tg + i, slot s = 5·i + dy of the threads tg = 0..3 of a quad
// (n8 tile s/2, column 2·tg + s%2 of the accumulator fragment), so that the
// thread that holds output channel o of a pixel holds all five of its dy
// lanes. Lanes 60-63 (zero weights) take slot 15.
__device__ __forceinline__ int d3_slot_row(int n) {
  const int tg = n < kLanes ? n % kOut / 3 : n - kLanes;
  const int s = n < kLanes ? 5 * (n % kOut % 3) + n / kOut : 15;
  return 8 * (s >> 1) + 2 * tg + (s & 1);
}

// Each warp walks a contiguous share of the B·strips·H (image, 32-column
// strip, output row) space, row by row down a strip, and restarts 2 conv
// rows above wherever its share starts a strip. Conv row y (its 36 staged
// columns of codes, zero outside the image, brought in by cp.async two rows
// ahead) is 20 k32 steps (5 dx taps x 128 channels) of 2 x 8 MMAs; then
// each thread turns its fragments into the K lanes bf16(acc·ws) and adds
// them to the f32 partial sums of the output rows y-2..y+1 that it holds in
// registers (P[0..3]: row y-2 completes with its dy = 4 lane, then P
// shifts and row y+2 starts from its dy = 0 lane), in dy order, exactly as
// the reference adds. Row y-2 + bias is staged as bf16 and written 8 bytes
// a lane, coalesced. The weights (slots as d3_slot_row places them) are
// staged once a block; the grid is persistent (one block an SM).
__global__ void __launch_bounds__(kThreads, 1)
    d3s8_mma_kernel(RowsArgs p, int strips_x, long long rows_total) {
  extern __shared__ __align__(16) uint8_t smem8[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* s_w = smem8;
  uint8_t* s_ring = smem8 + D3Smem::W + warp * D3Smem::WARP;
  __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(s_ring + kDBuf * D3Smem::ROW);
  const int8_t* xq = static_cast<const int8_t*>(p.x);

  // weights once: word (dx, k, n) → bytes 4k.. of row (dx, slot of n)
  for (int i = tid; i < 5 * kRCW * kCOT; i += kThreads) {
    const int n = i % kCOT, k = (i / kCOT) % kRCW, t = i / (kCOT * kRCW);
    *reinterpret_cast<int32_t*>(s_w + (t * kCOT + d3_slot_row(n)) * kDPX + 4 * k) = p.wk[i];
  }
  __syncthreads();

  const int g = lane >> 2, tg = lane & 3;
  float wsr[3][5], bi[3];  // the dequant rows of this thread's lanes, its channels' bias
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bi[i] = p.bias[3 * tg + i];
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) wsr[i][dy] = p.ws[kOut * dy + 3 * tg + i];
  }
  const uint32_t b_lane = smem_addr(s_w) + ((lane >> 4) * 8 + (lane & 7)) * kDPX +
                          ((lane >> 3) & 1) * 16;
  MMA_PHASE_START

  const long long nw = (long long)gridDim.x * kWarps, gw = (long long)blockIdx.x * kWarps + warp;
  long long pos = rows_total * gw / nw;
  const long long end = rows_total * (gw + 1) / nw;
  while (pos < end) {
    const long long strip = pos / p.H;
    const int r0 = (int)(pos % p.H);
    const int r1 = (int)min((long long)p.H, r0 + (end - pos));
    pos += r1 - r0;
    const int b = (int)(strip / strips_x), x0 = (int)(strip % strips_x) * kDStrip;
    const int y0 = r0 - 2, n = r1 - r0 + 4;  // conv rows y0 .. r1 + 1

    // conv row y0 + i into ring slot i % kDBuf: 36 pixels x 8 chunks, 9 a lane
    auto load_row = [&](int i) {
      const int y = y0 + i;
      const uint32_t dst = smem_addr(s_ring + (i % kDBuf) * D3Smem::ROW);
#pragma unroll
      for (int k = 0; k < kDHC * 8 / 32; ++k) {
        const int c = lane + 32 * k, px = c >> 3, x = x0 - 2 + px;
        const bool ok = y >= 0 && y < p.H && x >= 0 && x < p.W;
        const int8_t* src = ok ? xq + (((size_t)b * p.H + y) * p.W + x) * kRC + (c & 7) * 16 : xq;
        cp_async16(dst + px * kDPX + (c & 7) * 16, src, ok);
      }
      cp_async_commit();
    };

    float P[2][2][3][4];  // [M tile][pixel g, g + 8][channel 3tg + i][output row y-2 .. y+1]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) P[mt][h][i][k] = 0.0f;
    load_row(0);
    load_row(1);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if (i + 2 < n) load_row(i + 2);
      else cp_async_commit();  // an empty group keeps the wait count
      MMA_PHASE(0)
      cp_async_wait<2>();
      __syncwarp();
      MMA_PHASE(1)

      const uint32_t a_lane = smem_addr(s_ring + (i % kDBuf) * D3Smem::ROW) +
                              (lane & 15) * kDPX + (lane >> 4) * 16;
      int acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0;
      uint32_t af[2][2][4], bfr[2][8][2];
      auto load = [&](int s, uint32_t (&a)[2][4], uint32_t (&bq)[8][2]) {
        const int dx = s >> 2, kc = s & 3;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], a_lane + (mt * 16 + dx) * kDPX + kc * 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t r[4];
          ldsm_x4(r, b_lane + (dx * kCOT + 16 * q) * kDPX + kc * 32);
          bq[2 * q][0] = r[0];
          bq[2 * q][1] = r[1];
          bq[2 * q + 1][0] = r[2];
          bq[2 * q + 1][1] = r[3];
        }
      };
      auto mmas = [&](const uint32_t (&a)[2][4], const uint32_t (&bq)[8][2]) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nj = 0; nj < 8; ++nj) mma_s8(acc[mt][nj], a[mt], bq[nj][0], bq[nj][1]);
      };
      constexpr int KS = 5 * kRC / 32;  // 20 k32 steps
      load(0, af[0], bfr[0]);
#pragma unroll
      for (int s = 0; s < KS; s += 2) {
        load(s + 1, af[1], bfr[1]);
        mmas(af[0], bfr[0]);
        if (s + 2 < KS) load(s + 2, af[0], bfr[0]);
        mmas(af[1], bfr[1]);
      }
      MMA_PHASE(2)

      // K lanes and the dy-sum: lane (g, tg) holds pixels g and g+8 of each
      // M tile, slots 5i + dy in acc[.][s / 2][2h + s % 2]
      const bool emit = y0 + i - 2 >= r0;  // output row y - 2 is in the share
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i3 = 0; i3 < 3; ++i3) {
            float K[5];
#pragma unroll
            for (int dy = 0; dy < 5; ++dy) {
              const int s = 5 * i3 + dy;
              K[dy] = bf16_round(__fmul_rn(__int2float_rn(acc[mt][s >> 1][2 * h + (s & 1)]),
                                           wsr[i3][dy]));
            }
            float* pr = P[mt][h][i3];
            const float v = __fadd_rn(__fadd_rn(pr[0], K[4]), bi[i3]);
            pr[0] = __fadd_rn(pr[1], K[3]);
            pr[1] = __fadd_rn(pr[2], K[2]);
            pr[2] = __fadd_rn(pr[3], K[1]);
            pr[3] = __fadd_rn(0.0f, K[0]);
            if (emit) s_out[(mt * 16 + h * 8 + g) * kOut + 3 * tg + i3] = __float2bfloat16_rn(v);
          }
      MMA_PHASE(3)
      __syncwarp();
      if (emit) {  // the row's 32 x 12 bf16, 8 bytes a lane and pass
        const int r = y0 + i - 2;
        uint8_t* row = reinterpret_cast<uint8_t*>(p.out + (((size_t)b * p.H + r) * p.W + x0) * kOut);
#pragma unroll
        for (int k = 0; k < D3Smem::OUT / 8 / 32; ++k) {
          const int c = lane + 32 * k;
          if (x0 + c / 3 < p.W)
            *reinterpret_cast<uint2*>(row + 8 * c) =
                *reinterpret_cast<const uint2*>(reinterpret_cast<const uint8_t*>(s_out) + 8 * c);
        }
      }
      __syncwarp();  // the ring slot and s_out are rewritten on the next row
      MMA_PHASE(4)
    }
  }
  MMA_PHASE_END
}

int launch_d3s8_mma(const RowsArgs& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.W <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(d3s8_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D3Smem::bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int strips_x = (p.W + kDStrip - 1) / kDStrip;
  const long long rows_total = (long long)p.B * strips_x * p.H;
  // at least 16 output rows a warp: below that the 4 rows of restart weigh
  const long long want = (rows_total + 16 * kWarps - 1) / (16 * kWarps);
  const int blocks = (int)(want < sms ? (want > 0 ? want : 1) : sms);
  d3s8_mma_kernel<<<blocks, kThreads, D3Smem::bytes, static_cast<cudaStream_t>(stream)>>>(
      p, strips_x, rows_total);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// d3rows_mma_kernel: K7 on the int8 tensor cores
// ---------------------------------------------------------------------------

// K7's warps a block and per-warp buffers: the bf16 form lands a conv row's
// raw input (36 pixels x 128 channels) as bf16 at 8 warps a block; the f32
// form (the float32 chains' f32 d2 raw, quantized unrounded) lands it as f32,
// twice the bytes, at 6 warps a block.
template <bool F32>
struct D3RowsSmem {
  static constexpr int WARPS = F32 ? 6 : kWarps;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ES = F32 ? 4 : 2;             // bytes of a raw element
  static constexpr int LAND = kDHC * ES * kRC;       // one conv row's raw input
  static constexpr int CPP = ES * kRC / 16;          // its 16-byte chunks a pixel
  static constexpr int PASS = kDHC * CPP / 32;       // and a lane: 18, f32 36
  static constexpr int W = 5 * kCOT * kDPX;          // [dx][lane][kDPX] weights
  static constexpr int ROW = kDHC * kDPX;            // one conv row of codes, then its outputs
  static constexpr int OUT = kDStrip * kLanes * 2;   // one item's outputs: 32 x 60 bf16
  static constexpr int WARP = LAND + 2 * ROW;        // landing buffer, two code slots
  static constexpr size_t bytes = W + WARPS * WARP;
  static_assert(OUT <= ROW, "an item's outputs are staged in its code slot");
  static_assert(bytes <= 232448, "the block fits in an SM's shared memory");
};

// Item r of the B·strips·H (image, 32-column strip, row) space, rows down a
// strip: its image, row and first column.
struct D3Item {
  int b, y, x0;
  __device__ __forceinline__ D3Item(long long r, int H, int strips_x) {
    const long long strip = r / H;
    y = (int)(r - strip * H);
    b = (int)(strip / strips_x);
    x0 = (int)(strip - (long long)b * strips_x) * kDStrip;
  }
};

// With -DMMA_PHASE_CLOCKS (warp 0 of each block): 0 the wait for the next
// item's raw input, 1 its quantize and the loads of the one after issued,
// 2 this item's MMAs issued, 3 the fragment epilogue (the MMAs' drain
// included), 4 the item's stores.
// F32: the raw input is f32 (the float32 chains' d2 raw), landed as f32 in a
// landing row twice the size at 6 warps a block, and quantized unrounded;
// the rest is the bf16 form's.
template <bool F32>
__global__ void __launch_bounds__(kThreads, 1)
    d3rows_mma_kernel(RowsArgs p, int strips_x, long long rows_total) {
  using S = D3RowsSmem<F32>;
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  extern __shared__ __align__(16) uint8_t smem8[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* s_w = smem8;
  uint8_t* s_land = smem8 + S::W + warp * S::WARP;  // [36][128] raw bf16 or f32
  uint8_t* s_code = s_land + S::LAND;               // [2][36][kDPX] codes
  const T* x = static_cast<const T*>(p.x);

  // weights once: word (dx, k, lane n) → bytes 4k.. of row (dx, n)
  for (int i = tid; i < 5 * kRCW * kCOT; i += S::THREADS) {
    const int n = i % kCOT, k = (i / kCOT) % kRCW, t = i / (kCOT * kRCW);
    *reinterpret_cast<int32_t*>(s_w + (t * kCOT + n) * kDPX + 4 * k) = p.wk[i];
  }
  __syncthreads();

  const int g = lane >> 2, tg = lane & 3;
  float wsr[8][2];  // the dequant row of this thread's lanes 8nj + 2tg, +1
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    wsr[nj][0] = p.ws[8 * nj + 2 * tg];
    wsr[nj][1] = p.ws[8 * nj + 2 * tg + 1];
  }
  const uint32_t b_lane = smem_addr(s_w) + ((lane >> 4) * 8 + (lane & 7)) * kDPX +
                          ((lane >> 3) & 1) * 16;
  const int ch = lane & 15;  // the quantize: this lane's channels 8ch..8ch+7
  float qa[8], qc[8];
  int qb = -1;
  MMA_PHASE_START

  const long long nw = (long long)gridDim.x * S::WARPS;
  const long long gw = (long long)blockIdx.x * S::WARPS + warp;
  const long long pos = rows_total * gw / nw, end = rows_total * (gw + 1) / nw;

  // item r's raw input into the landing buffer, 36 pixels x CPP chunks, PASS
  // a lane (the columns outside the image are not read; their codes are 0)
  auto load = [&](long long r) {
    const D3Item it(r, p.H, strips_x);
    const T* row = x + ((size_t)it.b * p.H + it.y) * p.W * kRC;
    const uint32_t dst = smem_addr(s_land);
#pragma unroll
    for (int k = 0; k < S::PASS; ++k) {
      const int c = lane + 32 * k, xx = it.x0 - 2 + c / S::CPP;
      const bool ok = xx >= 0 && xx < p.W;
      cp_async16(dst + 16 * c, ok ? row + (size_t)xx * kRC + (16 / S::ES) * (c % S::CPP) : x, ok);
    }
    cp_async_commit();
  };
  // item r's codes clamp(rint(x·a + c), 0, 127) from the landing buffer into
  // `dst`, 8 channels (8 bytes) a lane and pass; 0 outside the image
  auto quant = [&](long long r, uint8_t* dst) {
    const D3Item it(r, p.H, strips_x);
    if (it.b != qb) {
      qb = it.b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qa[j] = __ldg(p.a + it.b * kRC + 8 * ch + j);
        qc[j] = __ldg(p.c + it.b * kRC + 8 * ch + j);
      }
    }
#pragma unroll 6  // unrolled by 3 or whole (18) it is no faster (PERF.md section 6)
    for (int k = 0; k < kDHC / 2; ++k) {
      const int px = (lane >> 4) + 2 * k, xx = it.x0 - 2 + px;
      uint2 w = make_uint2(0u, 0u);
      if (xx >= 0 && xx < p.W) {
        float v[8];
        if (F32) {
          const float4 lo = *reinterpret_cast<const float4*>(s_land + px * 4 * kRC + 32 * ch);
          const float4 hi = *reinterpret_cast<const float4*>(s_land + px * 4 * kRC + 32 * ch + 16);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(s_land + px * 2 * kRC + 16 * ch);
          const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = bf16_lo(w4[j]);
            v[2 * j + 1] = bf16_hi(w4[j]);
          }
        }
        int q[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) q[j] = quantize_i(v[j], qa[j], qc[j], 0.0f);
        w = make_uint2(pack4_s8(q[0], q[1], q[2], q[3]), pack4_s8(q[4], q[5], q[6], q[7]));
      }
      *reinterpret_cast<uint2*>(dst + px * kDPX + 8 * ch) = w;
    }
  };
  if (pos < end) {
    load(pos);
    cp_async_wait<0>();
    __syncwarp();
    quant(pos, s_code);
    __syncwarp();  // every lane is done with the landing buffer
    if (pos + 1 < end) load(pos + 1);
  }
  int slot = 0;
#pragma unroll 1
  for (long long r = pos; r < end; ++r, slot ^= 1) {
    uint8_t* cur = s_code + slot * S::ROW;
    if (r + 1 < end) {  // the next item quantized, the one after asked for
      cp_async_wait<0>();
      __syncwarp();
      MMA_PHASE(0)
      quant(r + 1, s_code + (slot ^ 1) * S::ROW);
      __syncwarp();
      if (r + 2 < end) load(r + 2);
      MMA_PHASE(1)
    }

    // 20 k32 steps (5 dx taps x 128 channels) of 2 x 8 MMAs
    const uint32_t a_lane = smem_addr(cur) + (lane & 15) * kDPX + (lane >> 4) * 16;
    int acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nj][e] = 0;
    uint32_t af[2][2][4], bfr[2][8][2];
    auto ld = [&](int s, uint32_t (&a)[2][4], uint32_t (&bq)[8][2]) {
      const int dx = s >> 2, kc = s & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(a[mt], a_lane + (mt * 16 + dx) * kDPX + kc * 32);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t rq[4];
        ldsm_x4(rq, b_lane + (dx * kCOT + 16 * q) * kDPX + kc * 32);
        bq[2 * q][0] = rq[0];
        bq[2 * q][1] = rq[1];
        bq[2 * q + 1][0] = rq[2];
        bq[2 * q + 1][1] = rq[3];
      }
    };
    auto mmas = [&](const uint32_t (&a)[2][4], const uint32_t (&bq)[8][2]) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) mma_s8(acc[mt][nj], a[mt], bq[nj][0], bq[nj][1]);
    };
    constexpr int KS = 5 * kRC / 32;
    ld(0, af[0], bfr[0]);
#pragma unroll
    for (int s = 0; s < KS; s += 2) {
      ld(s + 1, af[1], bfr[1]);
      mmas(af[0], bfr[0]);
      if (s + 2 < KS) ld(s + 2, af[0], bfr[0]);
      mmas(af[1], bfr[1]);
    }
    MMA_PHASE(2)

    // bf16(f32(acc)·ws) of pixels 16mt + g (+8), lanes 8nj + 2tg, +1 (< 60),
    // staged in the item's code slot, which every lane has done reading
    __syncwarp();
    uint8_t* so = cur;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int n = 8 * nj + 2 * tg;
          if (n < kLanes)
            *reinterpret_cast<uint32_t*>(so + ((16 * mt + 8 * h + g) * kLanes + n) * 2) =
                bf16_pack(bf16_round(__fmul_rn(__int2float_rn(acc[mt][nj][2 * h]), wsr[nj][0])),
                          bf16_round(__fmul_rn(__int2float_rn(acc[mt][nj][2 * h + 1]),
                                               wsr[nj][1])));
        }
    __syncwarp();
    MMA_PHASE(3)
    {  // the item's pixels inside the image, 8 bytes a lane and pass, coalesced
      const D3Item it(r, p.H, strips_x);
      uint8_t* row = reinterpret_cast<uint8_t*>(
          p.out + (((size_t)it.b * p.H + it.y) * p.W + it.x0) * kLanes);
      const int nbytes = min(kDStrip, p.W - it.x0) * kLanes * 2;
#pragma unroll
      for (int k = 0; k < S::OUT / 8 / 32; ++k) {
        const int c = lane + 32 * k;
        if (8 * c < nbytes)
          *reinterpret_cast<uint2*>(row + 8 * c) = *reinterpret_cast<const uint2*>(so + 8 * c);
      }
    }
    __syncwarp();  // the slot is quantized into again two items on
    MMA_PHASE(4)
  }
  MMA_PHASE_END
}

template <bool F32>
int launch_d3rows_mma(const RowsArgs& p, void* stream) {
  using S = D3RowsSmem<F32>;
  if (p.B <= 0 || p.H <= 0 || p.W <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(d3rows_mma_kernel<F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int strips_x = (p.W + kDStrip - 1) / kDStrip;
  const long long rows_total = (long long)p.B * strips_x * p.H;
  // one block an SM, or fewer where the items do not give each warp one
  const long long want = (rows_total + S::WARPS - 1) / S::WARPS;
  const int blocks = (int)(want < sms ? want : sms);
  d3rows_mma_kernel<F32><<<blocks, S::THREADS, S::bytes, static_cast<cudaStream_t>(stream)>>>(
      p, strips_x, rows_total);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a device
// pointer to a contiguous array as the comments of Args / RowsArgs
// describe; each launches on `stream` and returns a CUDA error code (0 on
// success).

namespace {
int res_site_s8o_args(bool prev, const void* x, const float* a, const float* c,
                      const int32_t* wk, const float* ws, const float* bias, const float* qa,
                      const float* qc, const float* tau, int8_t* out, int B, int H, int W, int C,
                      int CO, float lo, float qlo, int halo, int sw, void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.sw = sw;
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.ra = qa; p.rc = qc; p.tau = tau; p.qlo = qlo; p.out = out;
  const bool floored = tau != nullptr || qlo != 0.0f;
  if (prev)
    return floored ? launch<kQuant, kEmitS8F>(p, C, nullptr, stream)
                   : launch<kQuant, kEmitS8>(p, C, nullptr, stream);
  return floored ? launch_mma_s8o<kEmitS8F>(p, C, stream) : launch_mma_s8o<kEmitS8>(p, C, stream);
}
}  // namespace

// K2: s8 codes out[b,y,x,o] = clamp(rint(bf16(acc*ws + bias)*qa + qc), 0, 127);
// with a floor row tau [CO] (or qlo != 0) clamp(rint(max(f*qa + qc, tau[o])),
// qlo, 127) (ReCoNet's FRN emit; C = 192). Under the zero halo (halo 2; C in
// {64, 128}) the codes of x and of out in columns >= sw are zero (sw = W: no
// such column).
extern "C" int res_site_s8o_launch(const void* x, const float* a, const float* c,
                                   const int32_t* wk, const float* ws, const float* bias,
                                   const float* qa, const float* qc, const float* tau,
                                   int8_t* out, int B, int H, int W, int C, int CO, float lo,
                                   float qlo, int halo, int sw, void* stream) {
  return res_site_s8o_args(false, x, a, c, wk, ws, bias, qa, qc, tau, out, B, H, W, C, CO, lo,
                           qlo, halo, sw, stream);
}

// K2 on the previous __dp4a core (site_kernel), for timing only.
extern "C" int res_site_s8o_prev_launch(const void* x, const float* a, const float* c,
                                        const int32_t* wk, const float* ws, const float* bias,
                                        const float* qa, const float* qc, const float* tau,
                                        int8_t* out, int B, int H, int W, int C, int CO,
                                        float lo, float qlo, int halo, int sw, void* stream) {
  return res_site_s8o_args(true, x, a, c, wk, ws, bias, qa, qc, tau, out, B, H, W, C, CO, lo,
                           qlo, halo, sw, stream);
}

namespace {
int site_s8_args(bool prev, const int8_t* xq, const int32_t* wk, const float* ws,
                 const float* bias, const float* aa, const float* ac, const __nv_bfloat16* y,
                 const float* ya, const float* yc, const float* qa, const float* qc, void* out,
                 int B, int H, int W, int C, int CO, int flags, float qlo, int halo, int sw,
                 int geo, void* stream) {
  Args p = make_args(B, H, W, CO, 0.0f, halo);
  p.sw = sw;
  p.geo = geo;
  if (prev && geo != kGeo33) return (int)cudaErrorInvalidValue;
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
// no such column). Unused rows may be null. geo (Geo): the taps; 2x2 at pad
// 0 under the zero halo, C in {64, 128}.
extern "C" int site_s8_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                              const float* bias, const float* aa, const float* ac,
                              const __nv_bfloat16* y, const float* ya, const float* yc,
                              const float* qa, const float* qc, void* out, int B, int H,
                              int W, int C, int CO, int flags, float qlo, int halo, int sw,
                              int geo, void* stream) {
  return site_s8_args(false, xq, wk, ws, bias, aa, ac, y, ya, yc, qa, qc, out, B, H, W, C, CO,
                      flags, qlo, halo, sw, geo, stream);
}

// K3 on the previous __dp4a core (site_kernel), for timing only.
extern "C" int site_s8_prev_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                                   const float* bias, const float* aa, const float* ac,
                                   const __nv_bfloat16* y, const float* ya, const float* yc,
                                   const float* qa, const float* qc, void* out, int B, int H,
                                   int W, int C, int CO, int flags, float qlo, int halo,
                                   int sw, void* stream) {
  return site_s8_args(true, xq, wk, ws, bias, aa, ac, y, ya, yc, qa, qc, out, B, H, W, C, CO,
                      flags, qlo, halo, sw, kGeo33, stream);
}

#ifdef MMA_PHASE_CLOCKS
// mma_phase_clocks → host [kPhaseBlocks][kPhases] (unsigned 64-bit), then
// zeroed: a launch of fewer blocks leaves no rows of an earlier one.
extern "C" int mma_phase_clocks_read(unsigned long long* host) {
  static const unsigned long long zero[kPhaseBlocks][kPhases] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(host, mma_phase_clocks, sizeof(mma_phase_clocks));
  return err != cudaSuccess ? (int)err
                            : (int)cudaMemcpyToSymbol(mma_phase_clocks, zero, sizeof(zero));
}
#endif

// The f32-operand forms: each takes the arguments of its bf16 form, with the
// f32 operand in place of the bf16 one (K2's and K4's x, K5's yp, K3's y;
// 16-byte aligned). K3 needs the residual (kFYadd).
extern "C" int res_site_f32_launch(const float* x, const float* a, const float* c,
                                   const float* tau, const int32_t* wk, const float* ws,
                                   const float* bias, __nv_bfloat16* out, float* part,
                                   float* sums, int B, int H, int W, int C, int CO, float lo,
                                   int halo, int geo, int sw, void* stream) {
  if (sw != W && halo != kHaloZero) return (int)cudaErrorInvalidValue;
  Args p = make_args(B, H, W, CO, lo, halo);
  p.geo = geo;
  p.sw = sw;
  p.x = x; p.a = a; p.c = c; p.tau = tau; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  return launch_mma_f32_k4(p, C, sums, static_cast<cudaStream_t>(stream));
}

extern "C" int res_site_skip_f32_launch(const void* r2, const float* yp, const float* a,
                                        const float* c, const float* a2, const float* c2,
                                        const float* floor, const int32_t* wk,
                                        const float* ws, const float* bias, __nv_bfloat16* out,
                                        __nv_bfloat16* vout, float* part, float* sums, int B,
                                        int H, int W, int C, int CO, float lo, int halo, int sw,
                                        void* stream) {
  if (sw != W && halo != kHaloZero) return (int)cudaErrorInvalidValue;
  Args p = make_args(B, H, W, CO, lo, halo);
  p.sw = sw;
  p.x = r2; p.yp32 = yp; p.a = a; p.c = c; p.a2 = a2; p.c2 = c2; p.tau = floor; p.wk = wk;
  p.ws = ws; p.bias = bias; p.out = out; p.vout = vout; p.part = part;
  return launch_mma_f32_k5(p, C, sums, static_cast<cudaStream_t>(stream));
}

extern "C" int res_site_s8o_f32_launch(const float* x, const float* a, const float* c,
                                       const int32_t* wk, const float* ws, const float* bias,
                                       const float* qa, const float* qc, const float* tau,
                                       int8_t* out, int B, int H, int W, int C, int CO,
                                       float lo, float qlo, int halo, int sw, void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.sw = sw;
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.ra = qa; p.rc = qc; p.tau = tau; p.qlo = qlo; p.out = out;
  return launch_mma_f32_k2(p, C, tau != nullptr || qlo != 0.0f,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int site_s8_f32_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                                  const float* bias, const float* aa, const float* ac,
                                  const float* y, const float* ya, const float* yc,
                                  const float* qa, const float* qc, void* out, int B, int H,
                                  int W, int C, int CO, int flags, float qlo, int halo, int sw,
                                  void* stream) {
  Args p = make_args(B, H, W, CO, 0.0f, halo);
  p.sw = sw;
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.yadd32 = y; p.out = out;
  p.ep[0] = aa; p.ep[1] = ac; p.ep[2] = qa; p.ep[3] = qc; p.ep[4] = ya; p.ep[5] = yc;
  p.flags = flags;
  p.qlo = qlo;
  return launch_mma_f32_k3(p, C, static_cast<cudaStream_t>(stream));
}

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
// Under the zero halo (halo 2; C in {64, 128}) every position outside the
// image is code 0, not the quantized zero; so are the codes of the columns
// >= sw, which the sums leave out (sw = W: no such column); geo (Geo) picks
// the taps, 3x3 or 2x2 at pad 1 or 0.
extern "C" int res_site_launch(const void* x, const float* a, const float* c,
                               const float* tau, const int32_t* wk, const float* ws,
                               const float* bias, __nv_bfloat16* out, float* part, float* sums,
                               int B, int H, int W, int C, int CO, float lo, int halo, int geo,
                               int sw, void* stream) {
  if (sw != W && halo != kHaloZero) return (int)cudaErrorInvalidValue;
  Args p = make_args(B, H, W, CO, lo, halo);
  p.geo = geo;
  p.sw = sw;
  p.x = x; p.a = a; p.c = c; p.tau = tau; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  return launch_mma<kQuant, kRawStats>(p, C, sums, stream);
}

// K4's forms of the int8 probes (C = 128, reflect halo, no floor): cast 1:
// the codes are the saturating cast of x (a, c unused; kCast); stats 0: out
// only, sums zero (kRaw; part unused). cast 0 with stats 1 is res_site_launch.
extern "C" int res_site_form_launch(const void* x, const float* a, const float* c,
                                    const int32_t* wk, const float* ws, const float* bias,
                                    __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                    int W, int C, int CO, float lo, int cast, int stats,
                                    void* stream) {
  Args p = make_args(B, H, W, CO, lo, 0);
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  if (cast && stats) return launch_mma_probe<kCast, kRawStats>(p, C, sums, stream);
  if (!cast && !stats) {
    p.part = sums;
    return launch_mma_probe<kQuant, kRaw>(p, C, sums, stream);
  }
  return (int)cudaErrorInvalidValue;
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

namespace {
int res_site_skip_args(bool prev, const void* r2, const __nv_bfloat16* yp, const float* a,
                       const float* c, const float* a2, const float* c2, const float* floor,
                       const int32_t* wk, const float* ws, const float* bias,
                       __nv_bfloat16* out, __nv_bfloat16* vout, float* part, float* sums, int B,
                       int H, int W, int C, int CO, float lo, int halo, int sw, void* stream) {
  if (sw != W && (prev || halo != kHaloZero)) return (int)cudaErrorInvalidValue;
  Args p = make_args(B, H, W, CO, lo, halo);
  p.sw = sw;
  p.x = r2; p.yp = yp; p.a = a; p.c = c; p.a2 = a2; p.c2 = c2; p.tau = floor; p.wk = wk;
  p.ws = ws; p.bias = bias; p.out = out; p.vout = vout; p.part = part;
  if (prev)
    return floor != nullptr ? launch<kSkipAct, kRawStats>(p, C, sums, stream)
                            : launch<kSkip, kRawStats>(p, C, sums, stream);
  return floor != nullptr ? launch_mma_skip<kSkipAct>(p, C, sums, stream)
                          : launch_mma_skip<kSkip>(p, C, sums, stream);
}
}  // namespace

// K5: K4 on v = bf16(bf16(r2*a2 + c2) + yp), then, with a floor row [B,C]
// (C = 192), v = max(v, floor) (ReCoNet's post-add ReLU or TLU); v is
// written to vout unless null. Under the zero halo (C in {64, 128}) every
// position outside the image is code 0, and so are the codes of v in the
// columns >= sw (v itself is written there), which the sums leave out.
// part: [B, tiles, 2, CO] scratch.
extern "C" int res_site_skip_launch(const void* r2, const __nv_bfloat16* yp,
                                    const float* a, const float* c, const float* a2,
                                    const float* c2, const float* floor, const int32_t* wk,
                                    const float* ws, const float* bias, __nv_bfloat16* out,
                                    __nv_bfloat16* vout, float* part, float* sums, int B,
                                    int H, int W, int C, int CO, float lo, int halo, int sw,
                                    void* stream) {
  return res_site_skip_args(false, r2, yp, a, c, a2, c2, floor, wk, ws, bias, out, vout, part,
                            sums, B, H, W, C, CO, lo, halo, sw, stream);
}

// K5 on the previous __dp4a core (site_kernel), for timing only.
extern "C" int res_site_skip_prev_launch(const void* r2, const __nv_bfloat16* yp,
                                         const float* a, const float* c, const float* a2,
                                         const float* c2, const float* floor, const int32_t* wk,
                                         const float* ws, const float* bias, __nv_bfloat16* out,
                                         __nv_bfloat16* vout, float* part, float* sums, int B,
                                         int H, int W, int C, int CO, float lo, int halo,
                                         void* stream) {
  return res_site_skip_args(true, r2, yp, a, c, a2, c2, floor, wk, ws, bias, out, vout, part,
                            sums, B, H, W, C, CO, lo, halo, W, stream);
}

namespace {
int site_s2_args(bool prev, const void* x, const float* a, const float* c, const int32_t* wk,
                 const float* ws, const float* bias, __nv_bfloat16* out, float* part,
                 float* sums, int B, int H, int W, int C, int CO, float lo, void* stream) {
  Args p = make_args(B, H / 2, W / 2, CO, lo, 0);
  p.Hi = H;
  p.Wi = W;
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  if (!valid(p) || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32)
    return prev ? launch_c<32, 2, kQuant, kRawStats>(p, sums, s)
                : launch_mma_s2<32, 64>(p, sums, s);
  if (C == 64)
    return prev ? launch_c<64, 2, kQuant, kRawStats>(p, sums, s)
                : launch_mma_s2<64, 128>(p, sums, s);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// K8a (C = 32; CO % 64 == 0) / K8b (C = 64; CO % 128 == 0), on the int8
// tensor cores: K4 at stride 2 with a pixel-reflect halo: x [B,H,W,C] bf16 (H, W even;
// 16-byte aligned) → out [B,H/2,W/2,CO] bf16 and its sums; part: [B, tiles,
// 2, CO] scratch (8x16 output tiles).
extern "C" int site_s2_launch(const void* x, const float* a, const float* c,
                              const int32_t* wk, const float* ws, const float* bias,
                              __nv_bfloat16* out, float* part, float* sums, int B, int H,
                              int W, int C, int CO, float lo, void* stream) {
  return site_s2_args(false, x, a, c, wk, ws, bias, out, part, sums, B, H, W, C, CO, lo, stream);
}

// K8a with an f32 x (float32: conv1's f32 output; C = 32, CO % 64 == 0, x
// 16-byte aligned), its other arguments as site_s2_launch's.
extern "C" int site_s2_f32_launch(const float* x, const float* a, const float* c,
                                  const int32_t* wk, const float* ws, const float* bias,
                                  __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                  int W, int C, int CO, float lo, void* stream) {
  Args p = make_args(B, H / 2, W / 2, CO, lo, 0);
  p.Hi = H;
  p.Wi = W;
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  if (!valid(p) || H % 2 || W % 2 || C != 32) return (int)cudaErrorInvalidValue;
  return launch_mma_s2<32, 64, true>(p, sums, static_cast<cudaStream_t>(stream));
}

// K8a / K8b on the previous __dp4a core (site_kernel<C, 2>), for timing only.
extern "C" int site_s2_prev_launch(const void* x, const float* a, const float* c,
                                   const int32_t* wk, const float* ws, const float* bias,
                                   __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                   int W, int C, int CO, float lo, void* stream) {
  return site_s2_args(true, x, a, c, wk, ws, bias, out, part, sums, B, H, W, C, CO, lo, stream);
}

// K7: rows out[b,y,x,l] = bf16(acc_l * ws[l]), l < 60, of the 1x5 conv of
// the codes clamp(rint(x*a + c), 0, 127) with zero column pads (x 16-byte
// aligned); on the int8 tensor cores.
extern "C" int d3_rows_launch(const __nv_bfloat16* x, const float* a, const float* c,
                              const int32_t* wk, const float* ws, __nv_bfloat16* out, int B,
                              int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_d3rows_mma<false>(p, stream);
}

// K7 with an f32 x (the float32 chains' d2 raw, quantized unrounded; 16-byte
// aligned), its other arguments as d3_rows_launch's.
extern "C" int d3_rows_f32_launch(const float* x, const float* a, const float* c,
                                  const int32_t* wk, const float* ws, __nv_bfloat16* out, int B,
                                  int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_d3rows_mma<true>(p, stream);
}

// K7 on the previous __dp4a core (rows_kernel<kQuant, 1>), for timing only.
extern "C" int d3_rows_prev_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const int32_t* wk, const float* ws, __nv_bfloat16* out, int B,
                                   int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<kQuant, 1>(p, stream);
}

// K6: out[b,y,x,o] = bf16(Σ_dy K[y+dy-2][12*dy+o] + bias[o]) over the codes xq
// (16-byte aligned), K the 1x5 conv rows bf16(acc*ws), zero outside the
// image; on the int8 tensor cores.
extern "C" int d3_s8_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                            const float* bias, __nv_bfloat16* out, int B, int H, int W,
                            void* stream) {
  RowsArgs p = {};
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_d3s8_mma(p, stream);
}

// K6 on the previous __dp4a core (rows_kernel<kCodes, 2>), for timing only.
extern "C" int d3_s8_prev_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                                 const float* bias, __nv_bfloat16* out, int B, int H, int W,
                                 void* stream) {
  RowsArgs p = {};
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<kCodes, 2>(p, stream);
}

// Dynamic shared memory of the stride-2 tensor-core core at C input
// channels (K8a's at 32, K8b's at 64; 0 for other C), of K6's and of K7's.
extern "C" int mma_s2_smem_bytes(int C) {
  switch (C) {
    case 32: return (int)MmaS2Smem<32, 64>::bytes;
    case 64: return (int)MmaS2Smem<64, 128>::bytes;
    default: return 0;
  }
}
extern "C" int d3s8_mma_smem_bytes() { return (int)D3Smem::bytes; }
extern "C" int d3rows_mma_smem_bytes() { return (int)D3RowsSmem<false>::bytes; }
extern "C" int d3rows_mma_f32_smem_bytes() { return (int)D3RowsSmem<true>::bytes; }
