// K3 and K4 at ReCoNet's widths (C = 192 and 96 input channels) on Hopper's
// warpgroup MMAs: site_wgmma_kernel.
//
// Replaces, for ReCoNet's instances, the TPU kernels of
// neuralstyletransferv1_tpu/models/s2d2_sites_i8.py:
//   K4  res_site  (_site_kernel :139)      quantize bf16 x → 3x3 conv → bf16 raw + [Σ, Σ²]
//   K3  site_s8   (_site_kernel_s8g :670)  s8 codes → 3x3 conv → [affine] [+ y] → bf16 or s8
// at C = 192 → CO = 192 (the res grid, pixel reflect), 192 → 384 and 96 →
// 192 (the decoder's d1 and d2, edge copy), K4 also with FRN's TLU floor on
// x·a + c before the round (TAU). The function is int8_sites.cu's mma_kernel
// at these widths; that core (kept, and timed beside this one through the
// wrappers' *_prev forms) stages 64 output channels a block at C = 192,
// since 128 channels of 3x3 weights do not fit beside its tile, so it
// fetches and quantizes each tile's haloed input once per 64-channel group
// (3 times at CO = 192, 6 at 384), and its mma.sync warps hold one tile row
// x 64 channels: 1 A and 4 B ldmatrix for 8 m16n8k32 MMAs.
//
// What bounds these sites on an H100 (1080p B=8): a res site (270 x 480 x
// 192 → 192) is 6.88e11 int8 operations (0.348 ms at 1979 TOP/s) against
// 0.80 GB (0.24 ms at 3.35 TB/s); d1 (→ 384) 1.38e12 (0.695 ms); d2 (540 x
// 960, 96 → 192) 0.69e12 operations against 2.39 GB (0.713 ms): the
// operations bound the first two, the bytes the third.
//
// Design. One persistent block an SM walks the 8x16-pixel output tiles
// (image-major, row-major) and computes all CO output channels of each, so
// that each tile's haloed 10x18-pixel input is fetched and quantized once:
// at CO = 384 two passes of 192 channels run over the same codes. A block is
// three warpgroups:
//   - the producer warpgroup: its warp 8, lane 0, streams the weights from
//     L2 into a ring of 4 shared-memory slots by bulk copies, each slot one weight unit (one tap's 96 input
//     channels x the pass's 192 output channels, 18,432 bytes), completion
//     counted on the slot's mbarrier; its warps 9-11 fetch the tile after
//     next's haloed input (bf16 for K4, s8 codes for K3) 16 bytes a thread
//     and pass, through the pixel-reflect or edge map, and quantize it (K4:
//     clamp(rint(x·a + c [max tau]), lo, 127), the round by the 1.5·2^23
//     add) into the free one of two code buffers, while the consumers
//     multiply;
//   - two consumer warpgroups of 4 warps, warp w one tile row (16 pixels) of
//     the tile: per weight unit each warp loads its A fragments (the codes of
//     its row shifted by the tap (dy, dx), 3 k32 steps) by ldmatrix from
//     the code buffer (pixel stride C + 16 bytes: the eight rows of an
//     ldmatrix sit in distinct banks), and the warpgroup issues 3 wgmma
//     m64n192k32 (s8, s32 sums) with B, the slot's weights, K-major under
//     no swizzle (core matrices of 8 channels x 16 input bytes, contiguous;
//     host-packed [pass][tap][C/96][6][192][16], wgmma_weights); one unit
//     is one commit group, its fragments in one of two register sets, so
//     the next unit's loads and waits overlap the MMAs in flight.
// The epilogue is mma_kernel's, operation by operation. The consumers turn
// their fragments into f = bf16(acc·ws + bias) (K3: its frozen affine),
// stage f as bf16 in shared memory and, at C = 192, take K4's [Σ, Σ²] of
// the tile in mma_kernel's order (a lane's two pixels, the 8 lanes of a
// channel by shuffle, the 8 row warps in order) into the [B, tiles, 2, CO]
// partials that stats_reduce sums over tiles in double; then, during the
// next pass's
// MMAs (one store step after each weight unit's MMA group is issued, before
// waiting for it), they write the staged pass out, 16 bytes a thread,
// coalesced (K3: + the residual y, loaded a step ahead, its YAFF, the s8
// emit; K4 at C = 96: its sums, each of 240 threads its 8 channels over its
// 13 pixels in order, then the 10 pixel groups in order, since mma_kernel's
// blocks there sum two rows a warp, an order no warp here holds). So the
// stores use the consumer warps' issue slots while the tensor cores run;
// the fragments' conversion and the sums at C = 192 do not overlap the
// MMAs. (The stores left to the producer's warps, beside their quantize,
// made them the bottleneck; the sums at C = 192 in the store steps' order
// would part from mma_kernel's in the last bits; PERF.md section 6.) int32
// sums are exact in any order, so every output equals mma_kernel's and the
// plain version's bit for bit, and so do the sums at C = 192; at 96 they
// are within 1e-5 of the plain version's.
//
// Shared memory (C = 192): weight ring 4 x 18,432 = 73,728 + two code
// buffers 2 x 180 x 208 = 74,880 + the staged outputs 128 x 400 = 51,200 +
// rows 8 x 384 x 4 = 12,288 + sums 8 x 2 x 192 x 4 = 12,288 + barriers 256
// = 224,640 bytes; C = 96 (sums 10 x 2 x 192 x 4): 193,152. The weights stream from L2 once
// a tile and pass: 9 x C x 192 bytes (332 KB at C = 192), which at 128
// output pixels a tile is 2.6 bytes of L2 reads an output channel-pixel.
//
// Rounding follows the reference operation by operation (--fmad=false):
// __int2float_rn, __fmul_rn, __fadd_rn, __float2bfloat16_rn; the quantize's
// clamp commutes with its round (lo and 127 are integers).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

#include "hopper.cuh"

constexpr int kTR = 8, kTC = 16;          // output tile: rows x columns (pixels)
constexpr int kHC = kTC + 2;              // haloed tile columns
constexpr int kHPix = (kTR + 2) * kHC;    // haloed tile pixels: 180
constexpr int kNP = 192;                  // output channels of a pass
constexpr int kKU = 96;                   // input channels of a weight unit
constexpr int kUnit = kKU * kNP;          // bytes of a weight unit: 18,432
constexpr int kKStep = 2 * kNP * 16;      // bytes of a unit's k32 step: two core-matrix columns
constexpr int kSlots = 4;                 // weight ring slots (a fifth does not fit at C = 192;
                                          // 6 at C = 96 were no faster)
constexpr int kCons = 256;                // consumer threads: two warpgroups
constexpr int kThreads = kCons + 128;     // + the producer warpgroup
constexpr int kQThreads = 96;             // the producer's fetching and quantizing warps 9-11
constexpr int kCPP = kNP / 8;             // 16-byte chunks of a staged output pixel: 24
constexpr int kPGroups = kCons / kCPP;    // the consumers' pixel groups in a store: 10
constexpr int kStorers = kPGroups * kCPP; // the consumers that store: 240
constexpr int kOut = 2 * kNP + 16;        // bytes of a staged output pixel
constexpr int kRows = 8;                  // epilogue rows: ws, bias, then K3's aa, ac, qa, qc, ya, yc
constexpr int kMaxCO = 2 * kNP;
constexpr int kGroup = 9;                 // 16-byte loads a fetching thread keeps in flight

enum Pro { kQuant = 0, kCodes = 2 };                              // as int8_sites.cu's
enum Epi { kRawStats = 0, kSiteS8 = 2 };
enum SiteFlags { kFAff = 1, kFYadd = 2, kFYaff = 4, kFS8Out = 8 };

template <int C>
struct WgSmem {
  static constexpr int PX = C + 16;                      // bytes of a staged pixel of codes
  static constexpr int W = kSlots * kUnit;               // the weight ring
  static constexpr int X = 2 * kHPix * PX;               // two code buffers
  static constexpr int O = kTR * kTC * kOut;             // the staged outputs
  static constexpr int R = kRows * kMaxCO * 4;           // the epilogue rows
  // a pass's sums: of each row warp at C = 192, of each storing pixel group at 96
  static constexpr int S = (C == 192 ? kCons / 32 : kPGroups) * 2 * kNP * 4;
  static constexpr int BAR = 256;                        // the mbarriers
  static constexpr size_t bytes = W + X + O + R + S + BAR;
  static_assert(bytes <= 232448, "the block fits in an SM's shared memory");
};

struct WArgs {
  const void* x;                  // K4: bf16 x [B,H,W,C]; K3: s8 codes [B,H,W,C]
  const float *a, *c;             // K4: [B,C] quantize affine
  const float* tau;               // K4 TAU: [B,C] pre-round floor
  const int8_t* wg;               // [CO/192][9][C/96][6][192][16] weights (wgmma_weights)
  const float *ws, *bias;         // [CO] dequant row, conv bias
  const float* ep[6];             // K3: [CO] aa, ac, qa, qc, ya, yc (null if unused)
  const __nv_bfloat16* yadd;      // K3: bf16 residual [B,H,W,CO]
  void* out;                      // bf16 or int8 [B,H,W,CO]
  float* part;                    // K4: [B, tiles, 2, CO]
  int B, H, W, CO;
  float lo;                       // K4: quantize floor
  float qlo;                      // K3: floor of the s8 emit
  int flags;                      // K3: SiteFlags
  int halo;                       // 0 pixel reflect, 1 edge copy
  int sw;                         // K3: its s8 output codes in columns >= sw are 0
};

// Source index of halo position i in [-1, n] (and, for the padding rows of
// a partial tile, beyond): pixel reflect or edge, clamped into the image.
__device__ __forceinline__ int src_index(int i, int n, int halo) {
  if (halo == 0) {
    i = i < 0 ? -i : i;
    i = i >= n ? 2 * n - 2 - i : i;
  }
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// clamp(rint(v), lo, 127) of v = x·a + c [max t], as the code's low byte:
// the clamp commutes with the round (lo and 127 are integers), and adding
// 1.5 * 2^23 to a value in [-127, 127] rounds it half to even into the
// float's low mantissa bits
template <bool TAU>
__device__ __forceinline__ uint32_t quant_code(float x, float a, float c, float t, float lo) {
  float v = __fadd_rn(__fmul_rn(x, a), c);
  if (TAU) v = fmaxf(v, t);
  return (uint32_t)__float_as_int(__fadd_rn(fminf(fmaxf(v, lo), 127.0f), 12582912.0f)) & 0xffu;
}

// clamp(rint(f·qa + qc), qlo, 127), K3's s8 emit
__device__ __forceinline__ int emit_code(float f, float qa, float qc, float qlo) {
  const float q = rintf(__fadd_rn(__fmul_rn(f, qa), qc));
  return (int)fminf(fmaxf(q, qlo), 127.0f);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// a bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand in the no-swizzle layout: core
// matrices (8 rows x 16 bytes, contiguous) `lbo` bytes apart along K and
// `sbo` bytes apart along N
__device__ __forceinline__ uint64_t desc_noswz(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D[64 x 192] (+)= A[64 x 32] (registers) x B[32 x 192] (descriptor), s8, s32 sums
__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], const uint32_t (&a)[4], uint64_t desc,
                                              int sd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}

// Built with -DMMA_PHASE_CLOCKS (chip_smoke.py --phases), thread 0 of each
// block (consumer warp 0) adds the clock cycles of the phases of its tile
// loop into mma_phase_clocks[block]: 0 the wait for the tile's codes (the
// producer's fetch and quantize), 1 the waits for weight units (the ring's
// bulk copies), 2 the fragments loaded, the MMAs issued and the pass
// before's store steps (each unit's group waits for the one before it), 3
// the MMAs' drain, the fragment epilogue and K4's sums, 4 the last pass's
// stores (once a block).
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

// Block k walks tiles k, k + gridDim.x, ... of the B·tiles 8x16 output
// tiles; tile j of the walk uses code buffer j % 2. Each (tile, pass) is one
// event: the consumers stage its outputs in s_o after its MMAs and write
// them out between the next event's MMA groups (the last event's after the
// walk).
template <int C, int PRO, int EPI, bool TAU>
__global__ void __launch_bounds__(kThreads, 1)
    site_wgmma_kernel(const WArgs p, int tiles_x, int tiles) {
  static_assert((PRO == kQuant && EPI == kRawStats) || (PRO == kCodes && EPI == kSiteS8 && !TAU),
                "K4 (kQuant, kRawStats [TAU]) or K3 (kCodes, kSiteS8)");
  static_assert(C % kKU == 0, "C is a multiple of a weight unit's channels");
  using S = WgSmem<C>;
  constexpr int PX = S::PX;
  constexpr int KH = C / kKU;          // weight units a tap
  constexpr int U = 9 * KH;            // weight units a pass
  // K4's sums: at C = 192 in mma_kernel's order, which this core can take
  // in its fragment epilogue; at 96 mma_kernel's blocks sum two rows a warp,
  // an order no warp of this core holds, so the store steps take them
  constexpr bool EPI_SUMS = EPI == kRawStats && C == 192;
  constexpr bool STEP_SUMS = EPI == kRawStats && C != 192;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* s_w = smem;                                      // [kSlots][kUnit] weights
  uint8_t* s_x = s_w + S::W;                                // [2][kHPix][PX] codes
  uint8_t* s_o = s_x + S::X;                                // [128][kOut] staged outputs
  float* s_rows = reinterpret_cast<float*>(s_o + S::O);     // [kRows][kMaxCO]
  float* s_sum = s_rows + kRows * kMaxCO;                   // [warps or groups][2][kNP]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_o + S::O + S::R + S::S);
  uint64_t* w_full = bars;                                  // [kSlots]
  uint64_t* w_empty = bars + kSlots;                        // [kSlots]
  uint64_t* x_full = bars + 2 * kSlots;                     // [2]
  uint64_t* x_empty = x_full + 2;                           // [2]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int passes = p.CO / kNP;
  const int total = p.B * tiles;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], kCons / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&x_full[i], kQThreads);
      mbar_init(&x_empty[i], kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows: ws, bias, then K3's aa, ac, qa, qc, ya, yc
  for (int i = tid; i < kRows * p.CO; i += kThreads) {
    const int r = i / p.CO, n = i % p.CO;
    const float* row = r == 0 ? p.ws : r == 1 ? p.bias : EPI == kSiteS8 ? p.ep[r - 2] : nullptr;
    s_rows[r * kMaxCO + n] = row != nullptr ? row[n] : 0.0f;
  }
  __syncthreads();

  if (warp >= kCons / 32) {
    if (warp == kCons / 32) {
      // the weight ring: one lane, unit after unit in the consumers' order
      if (lane == 0) {
        Ring rw = {0, 0u};
        for (int tile = blockIdx.x; tile < total; tile += gridDim.x)
          for (int pz = 0; pz < passes; ++pz)
            for (int u = 0; u < U; ++u) {
              mbar_wait(&w_empty[rw.i], rw.ph ^ 1u);
              mbar_expect_tx(&w_full[rw.i], kUnit);
              bulk_load(s_w + rw.i * kUnit, p.wg + (size_t)(pz * U + u) * kUnit, kUnit,
                        &w_full[rw.i]);
              rw.next(kSlots);
            }
      }
      return;
    }
    // warps 9-11: the walk's tile j's haloed input, 16 bytes (8 bf16 or 16
    // code channels) a thread and pass, through the halo map into code
    // buffer j % 2 once the consumers have read tile j - 2's codes from it
    const int qt = tid - (kCons + 32);
    constexpr int VB = PRO == kCodes ? 16 : 8;             // channels a chunk
    constexpr int CH = C / VB;                             // chunks a pixel
    constexpr int PPI = kQThreads / CH;                    // pixels a pass
    constexpr int NI = (kHPix + PPI - 1) / PPI;            // passes
    static_assert(kQThreads % CH == 0, "the chunks of a pixel divide the fetching threads");
    const int chunk = qt % CH, p0 = qt / CH;
    float qa[8], qc[8], qf[8];
    int qb = -1;
    for (int tile = blockIdx.x, j = 0; tile < total; tile += gridDim.x, ++j) {
      const int buf = j & 1;
      mbar_wait(&x_empty[buf], ((j >> 1) & 1) ^ 1u);
      const int b = tile / tiles, t = tile % tiles;
      const int y0 = (t / tiles_x) * kTR - 1, x0 = (t % tiles_x) * kTC - 1;
      if (PRO == kQuant && b != qb) {
        qb = b;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          qa[k] = __ldg(p.a + b * C + chunk * 8 + k);
          qc[k] = __ldg(p.c + b * C + chunk * 8 + k);
          qf[k] = TAU ? __ldg(p.tau + b * C + chunk * 8 + k) : 0.0f;
        }
      }
      uint8_t* dst = s_x + buf * kHPix * PX;
      const uint8_t* src = static_cast<const uint8_t*>(p.x) +
                           (size_t)b * p.H * p.W * C * (PRO == kCodes ? 1 : 2) + chunk * 16;
#pragma unroll 1
      for (int k0 = 0; k0 < NI; k0 += kGroup) {
        uint4 raw[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int px = p0 + (k0 + k) * PPI;
          if (k0 + k < NI && px < kHPix) {
            const int sy = src_index(y0 + px / kHC, p.H, p.halo);
            const int sx = src_index(x0 + px % kHC, p.W, p.halo);
            raw[k] = __ldg(reinterpret_cast<const uint4*>(
                src + ((size_t)sy * p.W + sx) * C * (PRO == kCodes ? 1 : 2)));
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          const int px = p0 + (k0 + k) * PPI;
          if (k0 + k >= NI || px >= kHPix) continue;
          if (PRO == kCodes) {
            *reinterpret_cast<uint4*>(dst + px * PX + chunk * 16) = raw[k];
          } else {
            const uint32_t w4[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
            uint32_t q[2] = {0u, 0u};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t c0 = quant_code<TAU>(bf16_lo(w4[e]), qa[2 * e], qc[2 * e],
                                                  qf[2 * e], p.lo);
              const uint32_t c1 = quant_code<TAU>(bf16_hi(w4[e]), qa[2 * e + 1], qc[2 * e + 1],
                                                  qf[2 * e + 1], p.lo);
              q[e >> 1] |= (c0 | (c1 << 8)) << (16 * (e & 1));
            }
            *reinterpret_cast<uint2*>(dst + px * PX + chunk * 8) = make_uint2(q[0], q[1]);
          }
        }
      }
      mbar_arrive(&x_full[buf]);
    }
    return;
  }

  // the consumers: warp w computes tile row w, all channels of a pass, and
  // writes out the pass before (event e - 1) in store steps between its
  // weight units' MMAs: thread (pixel group pg, chunk c8), one of the first
  // kStorers, takes 8 channels (16 bytes) of pixels pg, pg + kPGroups, ...,
  // coalesced; K3 adds its residual y (loaded a step ahead) and emits s8;
  // K4 at C = 96 sums its channels' [Σ, Σ²] over its pixels in order, then
  // the pixel groups in order into the tile's partials
  const int g = lane >> 2, tg = lane & 3;
  const uint32_t a_lane0 = smem_addr(s_x) + (warp * kHC + (lane & 15)) * PX + (lane >> 4) * 16;
  const uint32_t w_base = smem_addr(s_w);
  constexpr int NK = (kTR * kTC + kPGroups - 1) / kPGroups;  // store steps an event: 13
  constexpr int KPU = (NK + U - 1) / U;                      // a weight unit: 1, or 2 at C = 96
  constexpr int YS = EPI == kSiteS8 ? KPU : 1;
  const int c8 = tid % kCPP, pg = tid / kCPP;
  const bool storer = tid < kStorers;
  struct Ev {
    int b, t, y0, x0, co0;
  };
  Ev ev = {-1, 0, 0, 0, 0};  // the event whose outputs s_o holds, b < 0: none
  float s1[8], s2[8];        // STEP_SUMS: this thread's [Σ, Σ²] of ev
  uint4 ynext[YS];
  // the residual chunks of store steps KPU·s.. of ev
  auto y_load = [&](int s) {
    if constexpr (EPI == kSiteS8) {
      if (!(p.flags & kFYadd)) return;
#pragma unroll
      for (int q = 0; q < KPU; ++q) {
        const int px = pg + kPGroups * (KPU * s + q);
        const int oy = ev.y0 + px / kTC, ox = ev.x0 + px % kTC;
        if (storer && px < kTR * kTC && oy < p.H && ox < p.W)
          ynext[q] = __ldg(reinterpret_cast<const uint4*>(
              p.yadd + (((size_t)ev.b * p.H + oy) * p.W + ox) * p.CO + ev.co0 + 8 * c8));
      }
    }
  };
  // store steps KPU·s.. of ev (the residual of the next steps asked for)
  auto store_steps = [&](int s) {
    if (ev.b < 0 || KPU * s >= NK) return;
    uint4 ycur[YS];
#pragma unroll
    for (int q = 0; q < YS; ++q) ycur[q] = ynext[q];
    if (KPU * (s + 1) < NK) y_load(s + 1);
    const float* ep = s_rows + 2 * kMaxCO + ev.co0 + 8 * c8;  // aa, ac, qa, qc, ya, yc rows
#pragma unroll
    for (int q = 0; q < KPU; ++q) {
      const int px = pg + kPGroups * (KPU * s + q);
      const int oy = ev.y0 + px / kTC, ox = ev.x0 + px % kTC;
      if (!storer || px >= kTR * kTC || oy >= p.H || ox >= p.W) continue;
      const size_t o = (((size_t)ev.b * p.H + oy) * p.W + ox) * p.CO + ev.co0 + 8 * c8;
      uint4 v = *reinterpret_cast<const uint4*>(s_o + px * kOut + 16 * c8);
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
      if constexpr (STEP_SUMS) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = e & 1 ? bf16_hi(w[e / 2]) : bf16_lo(w[e / 2]);
          s1[e] = __fadd_rn(s1[e], f);
          s2[e] = __fadd_rn(s2[e], __fmul_rn(f, f));
        }
      } else if (EPI == kSiteS8 && (p.flags & (kFYadd | kFS8Out))) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[2 * e] = bf16_lo(w[e]);
          f[2 * e + 1] = bf16_hi(w[e]);
        }
        if (p.flags & kFYadd) {
          const uint32_t yw[4] = {ycur[q].x, ycur[q].y, ycur[q].z, ycur[q].w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float y = e & 1 ? bf16_hi(yw[e / 2]) : bf16_lo(yw[e / 2]);
            if (p.flags & kFYaff)
              y = bf16_round(fmaxf(__fadd_rn(__fmul_rn(y, ep[4 * kMaxCO + e]),
                                             ep[5 * kMaxCO + e]), 0.0f));
            f[e] = bf16_round(__fadd_rn(f[e], y));
          }
        }
        if (p.flags & kFS8Out) {
          uint32_t qc8[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            qc8[e / 4] |= (uint32_t)(emit_code(f[e], ep[2 * kMaxCO + e], ep[3 * kMaxCO + e],
                                               p.qlo) & 0xff) << (8 * (e % 4));
          if (ox >= p.sw) qc8[0] = qc8[1] = 0;  // padding columns stay zero codes
          *reinterpret_cast<uint2*>(static_cast<int8_t*>(p.out) + o) =
              make_uint2(qc8[0], qc8[1]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = bf16_pack(f[2 * e], f[2 * e + 1]);
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + o) = v;
    }
  };
  // STEP_SUMS: ev's sums, its pixel groups in order, into the tile's partials
  auto step_sums = [&]() {
    if constexpr (STEP_SUMS) {
      if (ev.b < 0) return;
      if (storer) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s_sum[(pg * 2 + 0) * kNP + 8 * c8 + e] = s1[e];
          s_sum[(pg * 2 + 1) * kNP + 8 * c8 + e] = s2[e];
        }
      }
      bar_sync(1, kCons);
      for (int i = tid; i < 2 * kNP; i += kCons) {
        const int st = i / kNP, n = i % kNP;
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < kPGroups; ++q) v = __fadd_rn(v, s_sum[(q * 2 + st) * kNP + n]);
        p.part[(((size_t)ev.b * tiles + ev.t) * 2 + st) * p.CO + ev.co0 + n] = v;
      }
    }
  };
  int acc[96];
  uint32_t afr0[3][4], afr1[3][4];
  Ring rw = {0, 0u};
  MMA_PHASE_START

  for (int tile = blockIdx.x, j = 0; tile < total; tile += gridDim.x, ++j) {
    const int buf = j & 1;
    const int b = tile / tiles, t = tile % tiles;
    const int y0 = (t / tiles_x) * kTR, x0t = (t % tiles_x) * kTC;
    const uint32_t a_lane = a_lane0 + buf * kHPix * PX;
    mbar_wait(&x_full[buf], (j >> 1) & 1);
    MMA_PHASE(0)
    for (int pz = 0; pz < passes; ++pz) {
      const bool last_pass = pz == passes - 1;
      int prev = -1;
#pragma unroll
      for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
      if (ev.b >= 0) y_load(0);
      // one weight unit: its 3 k32 steps' fragments, 3 MMAs as one group,
      // and while they run the pass before's store steps
      auto unit = [&](int u, uint32_t (&f)[3][4]) {
        const int tap = u / KH, kh = u - tap * KH;
        const int dy = tap / 3, dx = tap - 3 * dy;
        mbar_wait(&w_full[rw.i], rw.ph);
        MMA_PHASE(1)
#pragma unroll
        for (int s = 0; s < 3; ++s)
          ldsm_x4(f[s], a_lane + (dy * kHC + dx) * PX + kh * kKU + s * 32);
        if (last_pass && u == U - 1) {  // the tile's codes are in registers
          __syncwarp();
          if (lane == 0) mbar_arrive(&x_empty[buf]);
        }
        const uint64_t d0 = desc_noswz(w_base + rw.i * kUnit, kNP * 16, 128);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 3; ++s)
          wgmma_s8_n192(acc, f[s], d0 + (uint64_t)(s * kKStep >> 4), (u | s) != 0);
        wgmma_commit();
        store_steps(u);
        wgmma_wait<1>();
        if (prev >= 0 && lane == 0) mbar_arrive(&w_empty[prev]);  // its MMAs are done
        prev = rw.i;
        rw.next(kSlots);
        MMA_PHASE(2)
      };
#pragma unroll 1
      for (int u = 0; u < U; u += 2) {
        unit(u, afr0);
        if (u + 1 < U) unit(u + 1, afr1);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&w_empty[prev]);
      step_sums();
      bar_sync(1, kCons);  // ev's stores are done with s_o, its sums with s_sum

      // epilogue on the fragments: lane (g, tg) of warp w holds, for
      // channel group jn, pixels g and g+8 of tile row w (e = 0,1 and 2,3)
      // of channels 8jn + 2tg, +1 of the pass. f = bf16(acc·ws + bias) (K3:
      // its frozen affine), staged as bf16 (exact: every f is bf16-rounded);
      // K4's sums as mma_kernel takes them: a lane's two pixels, the 8 lanes
      // of a channel by shuffle, then (below) the 8 row warps in order
      const int co0 = pz * kNP;
      const bool row_in = y0 + warp < p.H;
#pragma unroll
      for (int jn = 0; jn < kNP / 8; ++jn) {
        const int n = jn * 8 + 2 * tg;
        const float2 ws = *reinterpret_cast<const float2*>(s_rows + co0 + n);
        const float2 bi = *reinterpret_cast<const float2*>(s_rows + kMaxCO + co0 + n);
        float2 aa = make_float2(0.0f, 0.0f), ac = aa;
        if (EPI == kSiteS8 && (p.flags & kFAff)) {
          aa = *reinterpret_cast<const float2*>(s_rows + 2 * kMaxCO + co0 + n);
          ac = *reinterpret_cast<const float2*>(s_rows + 3 * kMaxCO + co0 + n);
        }
        float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float f[2] = {
              bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * jn + 2 * h]), ws.x), bi.x)),
              bf16_round(__fadd_rn(__fmul_rn(__int2float_rn(acc[4 * jn + 2 * h + 1]), ws.y),
                                   bi.y))};
          if (EPI_SUMS) {
            if (row_in && x0t + g + 8 * h < p.W) {
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
          *reinterpret_cast<uint32_t*>(s_o + (warp * kTC + g + 8 * h) * kOut + 2 * n) =
              bf16_pack(f[0], f[1]);
        }
        if (EPI_SUMS) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              s1[e] = __fadd_rn(s1[e], __shfl_xor_sync(0xffffffffu, s1[e], m));
              s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(0xffffffffu, s2[e], m));
            }
            if (g == 0) {
              s_sum[(warp * 2 + 0) * kNP + n + e] = s1[e];
              s_sum[(warp * 2 + 1) * kNP + n + e] = s2[e];
            }
          }
        }
      }
      ev = {b, t, y0, x0t, co0};
      bar_sync(1, kCons);  // s_o holds the pass: the next pass's store steps read it
      if (EPI_SUMS) {
        // the tile's sums: the 8 row warps in order
        for (int i = tid; i < 2 * kNP; i += kCons) {
          const int st = i / kNP, n = i % kNP;
          float v = 0.0f;
#pragma unroll
          for (int w = 0; w < kCons / 32; ++w) v = __fadd_rn(v, s_sum[(w * 2 + st) * kNP + n]);
          p.part[(((size_t)b * tiles + t) * 2 + st) * p.CO + co0 + n] = v;
        }
      }
      MMA_PHASE(3)
    }
  }
  // the last pass's stores (and, at C = 96, K4's sums)
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
  y_load(0);
#pragma unroll 1
  for (int s = 0; KPU * s < NK; ++s) store_steps(s);
  step_sums();
  MMA_PHASE(4)
  MMA_PHASE_END
}

// sums[b, s, co] = Σ over tiles in double, in a fixed order: the 8 warps of
// a block take tiles k ≡ warp (mod 8) in order for 32 channels, then warp 0
// adds the 8 warp sums in order (int8_sites.cu's stats_reduce_mma).
__global__ void stats_reduce(const float* __restrict__ part, float* __restrict__ sums, int B,
                             int tiles, int CO) {
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
int launch_wg(const WArgs& p, float* sums, cudaStream_t stream) {
  if (p.B <= 0 || p.H < 2 || p.W < 2 || p.CO <= 0 || p.CO % kNP || p.CO > kMaxCO ||
      (p.halo != 0 && p.halo != 1))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = WgSmem<C>::bytes;
  auto kern = site_wgmma_kernel<C, PRO, EPI, TAU>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int tiles_x = (p.W + kTC - 1) / kTC;
  const int tiles = ((p.H + kTR - 1) / kTR) * tiles_x;
  const int total = p.B * tiles;
  kern<<<total < sms ? total : sms, kThreads, smem, stream>>>(p, tiles_x, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (EPI == kRawStats)
    stats_reduce<<<p.B * 2 * p.CO / 32, 256, 0, stream>>>(p.part, sums, p.B, tiles, p.CO);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a device
// pointer to a contiguous array as WArgs describes; the weights are
// wgmma_weights' [CO/192][9][C/96][6][192][16] bytes; x, y and the weights
// 16-byte aligned. Each launches on `stream` and returns a CUDA error code
// (0 on success).

// K4 at C in {96, 192} → CO in {192, 384}: bf16 raw out and sums[b, 0|1, o]
// = [Σ, Σ²] of it (part: [B, tiles, 2, CO] scratch over 8x16 tiles); tau
// (null: none) the [B,C] floor of x*a + c before the round; halo 0 pixel
// reflect, 1 edge copy.
extern "C" int res_site_wg_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                  const float* tau, const int8_t* wg, const float* ws,
                                  const float* bias, __nv_bfloat16* out, float* part,
                                  float* sums, int B, int H, int W, int C, int CO, float lo,
                                  int halo, void* stream) {
  WArgs p = {};
  p.x = x; p.a = a; p.c = c; p.tau = tau; p.wg = wg; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  p.B = B; p.H = H; p.W = W; p.CO = CO; p.lo = lo; p.halo = halo; p.sw = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 192) return tau ? launch_wg<192, kQuant, kRawStats, true>(p, sums, s)
                           : launch_wg<192, kQuant, kRawStats, false>(p, sums, s);
  if (C == 96) return tau ? launch_wg<96, kQuant, kRawStats, true>(p, sums, s)
                          : launch_wg<96, kQuant, kRawStats, false>(p, sums, s);
  return (int)cudaErrorInvalidValue;
}

// K3 at C in {96, 192} → CO = 192: f = bf16(acc*ws + bias) from s8 codes
// xq; then, per `flags`, f = bf16(f*aa + ac) (1); f = bf16(f + y) with y
// first replaced by bf16(max(y*ya + yc, 0)) (2, 4); out = bf16 f, or s8
// codes clamp(rint(f*qa + qc), qlo, 127) (8), zero in columns >= sw.
// Unused rows may be null.
extern "C" int site_s8_wg_launch(const int8_t* xq, const int8_t* wg, const float* ws,
                                 const float* bias, const float* aa, const float* ac,
                                 const __nv_bfloat16* y, const float* ya, const float* yc,
                                 const float* qa, const float* qc, void* out, int B, int H,
                                 int W, int C, int CO, int flags, float qlo, int halo, int sw,
                                 void* stream) {
  WArgs p = {};
  p.x = xq; p.wg = wg; p.ws = ws; p.bias = bias; p.yadd = y; p.out = out;
  p.ep[0] = aa; p.ep[1] = ac; p.ep[2] = qa; p.ep[3] = qc; p.ep[4] = ya; p.ep[5] = yc;
  p.B = B; p.H = H; p.W = W; p.CO = CO; p.flags = flags; p.qlo = qlo; p.halo = halo; p.sw = sw;
  if ((flags & kFYadd) && CO != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 192) return launch_wg<192, kCodes, kSiteS8, false>(p, nullptr, s);
  if (C == 96) return launch_wg<96, kCodes, kSiteS8, false>(p, nullptr, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of site_wgmma_kernel at C input channels (0 for
// other C).
extern "C" int site_wgmma_smem_bytes(int C) {
  return C == 192 ? (int)WgSmem<192>::bytes : C == 96 ? (int)WgSmem<96>::bytes : 0;
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
