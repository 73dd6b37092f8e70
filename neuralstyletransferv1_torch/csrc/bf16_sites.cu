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
// site_kernel_bf16 is the first core of K9a, K9c and K9d, kept for
// timing (d2_site_prev_launch, c2/c3_site_bf16_prev_launch; K9a runs on
// d2_wgmma_kernel, K9c and K9d on s2_mma_bf16_kernel, below): a 3x3 conv at
// stride 1
// (edge-copy halo) or 2 (pixel-reflect halo; an even size never reads the
// bottom or right pad) of bf16 activations that the prologue makes from the
// raw input, x' = bf16(max(f32(x)*a + c, 0)) with the product and the sum
// rounded separately; f32 accumulation; the epilogue adds the bias in f32,
// stores bf16 and sums [Σ, Σ²] of the f32 values before that round. The TPU
// kernels' strips, junk columns, halo buffer, garbage row/column with its
// fixup and 2x2 block packing are layout and are not carried over: conv2 and
// conv3 are pixel convs (each pixel tap sits once in the TPU's block weights).
// rows_kernel_bf16 is the previous core of K9e and K9b, kept for timing
// only (d3_rows_prev_launch, d3_sum_site_prev_launch): the 1x5 conv of the
// 128-channel space-to-depth tensor (4 phases x 32) to 60 lanes (5 kernel
// rows x 12, padded to 64 with zero weights). Its halo is the 4-pixel reflect
// of the pixels, which on the block grid permutes the phases: the prologue
// reads it through its index map (block R phase u is pixel 2R+u; reflect the
// pixel; split again), so no padded tensor exists. K9e writes each conv row's
// 60 lanes as bf16 for the H+4 rows of the padded grid; K9b's form keeps 16
// conv rows in shared memory and writes, for its 12 output rows,
// bf16(Σ_dy rows[r+dy][12*dy+o] + bias[o]), the sum in f32 in dy order.
// d3sum_mma_kernel is K9b and d3rows_wgmma_kernel K9e (below).
//
// These two cores multiply on the tensor cores with mma.sync.m16n8k16 (bf16
// in, f32 accumulate): M = 16 neighbouring output pixels of a row, N = 8
// output channels, K = 16 input channels of one tap. A block is 256 threads
// = 8 warps on 64 output channels; a warp owns one output row of the tile
// (two conv rows in K9b's previous form) and all 8 channel tiles, i.e. 64 f32
// accumulators a thread. The activated input tile sits in shared memory as
// bf16 with the channels innermost and a pixel stride padded so that the
// eight pixels a fragment load touches fall in different banks; the weights,
// repacked on the host to [tap][co][c], are staged one kernel row
// (site_kernel_bf16) or one tap (rows_kernel_bf16) at a time. Fragments are
// plain 32-bit shared-memory loads. Products of two bf16 values are exact in
// f32, so only the order of the f32 accumulation differs from any other
// implementation.
//
// s2_mma_bf16_kernel (K9c, K9d) is K8a's and K8b's stride-2 design
// (int8_sites.cu's mma_s2_kernel) in bf16, on Hopper's warpgroup MMAs. K9c
// moves 1.59 GB at 1080p B=8 and K9d 0.80 GB, each for 1.5e11 bf16 FLOP:
// both are bound by their bytes (0.475 and 0.238 ms on an H100), K9d near
// balance with its MMAs (0.155 ms at the tensor peak). Their first core
// staged and activated a haloed tile once for each 64 output channels,
// restaged the weights in every block, fed mma.sync by scalar loads and
// overlapped nothing. Here a persistent block takes TH x 16 output tiles
// (K9c 8, K9d 4 rows) on all output channels, with the nine taps' weights
// resident; its haloed input sits in four (row, column) parity planes, so
// each tap is a stride-1 shift and its A rows are consecutive plane pixels
// that ldmatrix reads without bank conflicts under an XOR swizzle, which on
// the weights is the wgmma operand's own (128-byte rows at C = 64, 64-byte
// at C = 32). A producer warpgroup brings each tile's raw input in by
// cp.async through the reflect map straight into its plane slots, up to
// NB - 1 tiles ahead, and activates it in place once; a consumer
// warpgroup runs a group of wgmma a tap (A by ldmatrix at the tap's shift,
// B by descriptor), stages bf16(acc + bias) in the tile's buffer for a TMA
// store and keeps the [Σ, Σ²] of an image's run of tiles in registers, so a
// tile costs no shuffles or barriers for its sums. The producers' loads and
// activation run beside the MMAs (chip_smoke.py --phases: the MMA groups
// take about 71% of the consumers' tile loop, the epilogue 24%; PERF.md
// section 6 has the times and the designs that lost).
//
// d3sum_mma_kernel (K9b) is deconv3's rows conv and dy-sum as K6's
// d3s8_mma_kernel (int8_sites.cu) computes them, in bf16: mma.sync.m16n8k16
// fed by ldmatrix, M = 16 output columns, N = 64 lanes, K = 5 dx taps x 128
// channels (40 k16 steps). A persistent grid stages the weights once a block
// (the B rows ordered by d3_slot_row, so that the thread holding output
// channel o of a pixel holds its five dy lanes: the accumulator fragment has
// the s8 one's layout), and each warp walks a contiguous share of the
// (image, 16-column strip, row) space down its strips: every conv row is
// computed once (the previous form computed 16 rows to emit 12), apart from
// the 2-row restart where a share starts a strip, and four rows of f32
// partial sums live in registers. A bf16 pixel is 256 bytes, twice K6's
// codes, so K6's 32-column strips at 8 warps (322,048 bytes of rows and
// weights) do not fit in a block's 232,448: 16-column strips at 8 warps
// take 220,672. At 16 columns a step reads the weights' B fragments (4 of
// its 5 ldmatrix) for 16 pixels; computing two conv rows a step shares them
// between two rows, in the same three ring slots. Of the forms timed on an
// H100 (PERF.md section 6 has the times), this one was the fastest: one row
// a step and 32-column strips at 4 warps were slower. Each staged row is
// brought in raw by cp.async, each 16-byte chunk from the pixel and phase
// the reflect maps it to (a lane's source columns are fixed for a strip and
// computed once), and activated in place once, not once a dx tap. Each conv row is rounded
// to bf16, the five dy terms added in f32 in dy order with __fadd_rn, the
// bias added and the sum rounded once: K9b's own numbers, as
// d3_sum_site_plain takes them.
//
// The statistics are deterministic: per thread in a fixed order, lanes by
// shuffle, warps in order, then a [B, tiles, 2, CO] buffer that a second
// kernel reduces over tiles in order in double. No float atomics.
//
// d2_wgmma_kernel (K9a) is K10's fused_wgmma_kernel at 64 input channels
// with an edge halo: a tile's haloed 6 x 34 input is one 128-byte row a
// pixel (26 KB), and all nine taps' weights (147 KB, K-major as
// pack_site_weights lays them out) stay resident, loaded once a block, so
// the producer streams only input tiles (two buffers of 32 KB, each the
// tile's staged output afterwards). TMA fills the box's positions outside
// the image with zeros; a border tile copies the edge pixels over them
// (d2_patch) before the activation, which must never see the zero fill.
//
// What bounds them on an H100 (1080p, B = 8): K9a is 3.06e11 MAC = 0.62 ms at
// the 989 TFLOP/s bf16 peak against 0.475 ms for its 1.59 GB: operations; the
// other four move 0.8-1.6 GB for 0.76-1.6e11 MAC: bytes (0.24-0.48 ms); K9b
// is near balance (1.70e11 MAC at 64 of 60 lanes, 0.344 ms; 1.16 GB, 0.347
// ms). rows_kernel_bf16 (K9e's and K9b's previous core) feeds the MMAs from
// shared memory with scalar loads (2.5-3 loads an MMA), which bounds it near
// a quarter of the tensor-core peak, restages the five taps' weights in each
// of its 16,320 blocks at 1080p B=8 and overlaps nothing. K9b's ldmatrix reads 3,072 bytes of shared memory for
// every 16 MMAs, 4 of its 6 loads the weights, read again for every 32
// output pixels: at 128 bytes a clock that is 1.5 clocks an MMA, and the
// MMAs' issue takes the largest share of its row loop (--phases; PERF.md
// section 6). A warp tile of more pixels (wgmma's 64 rows) would read the
// weights fewer times; K9a, K9c, K9d and K9e run on wgmma.
//
// d3rows_wgmma_kernel (K9e) is K9c's and K9d's producer/consumer design on
// the stride-1 1x5 rows conv: 1.06 GB in and 0.50 GB out at 1080p B=8 for
// 3.4e11 bf16 FLOP, bound by its bytes (0.467 ms; its MMAs alone 0.35 ms at
// the tensor peak). A persistent block walks (image, conv row, 64-column
// segment) items: a producer warpgroup lands each item's 68 raw pixels by
// cp.async through the reflect map, a few items ahead, and activates them
// in place once; a consumer warpgroup keeps the five taps' weights in its
// registers as the wgmma's A and reads the pixels as B through a
// descriptor (a no-swizzle layout, where each tap's one-pixel shift is 16
// bytes of the start address), 5 taps x 8 wgmma m64n64k16 an item, and one
// bulk copy stores the item's 64 x 60 bf16 lanes, which are 7,680
// contiguous bytes of the output. Of the forms timed on an H100 (PERF.md
// section 6) it beat the pixels as A by ldmatrix with the weights resident
// in shared memory, both operands in shared memory at 128 and 192 pixels
// an item, two accumulator sets (255 registers) and plain global stores.
//
// Two more kernels answer the TPU package's bf16 megakernel experiments:
//   K10 fused_conv  (experiments/mk1_fusedconv.py fused_conv; mk2/mk3/mk5's
//                   build tile the same function) the res-block site: a
//                   prologue on every position read of a PRE-PADDED input
//                   (f32 affine + ReLU, none, or the affine in bf16
//                   arithmetic) → 3x3 conv 128→128 → + bias → bf16 and [Σ, Σ²]
//                   (or no statistics). 3.06e11 FLOP over 0.54 GB at
//                   [8,270,480,128]: operations (PERF.md section 6 has the
//                   times). fused_wgmma_kernel: what bounded its first core
//                   (site_kernel_bf16<128, 1, true>, kept for timing) was
//                   feeding mma.sync from shared memory by scalar loads,
//                   a tile read and activated once for each 64-channel half
//                   and the weights transposed tap by tap while staged, with
//                   no overlap of staging and MMAs. Now one persistent block
//                   an SM takes 4 x 32-pixel tiles on all 128 channels: a
//                   producer warpgroup (its registers given to the consumers
//                   by setmaxnreg) brings each tile's haloed 6 x 34 input by
//                   TMA one tile ahead (two buffers) and streams the taps'
//                   [C][CO] weight slabs, as mk1 lays them out, through three
//                   32 KB slots; two consumer warpgroups of 64 pixels run
//                   wgmma m64n128k16 with B through an MN-major descriptor
//                   (the transpose bit) and A from registers, by ldmatrix at
//                   each tap's (dy, dx) pixel shift (a one-pixel shift breaks
//                   the 8-row core matrices of an A descriptor). The prologue
//                   activates each input tile once, in place, during the MMAs
//                   of the tile before; the epilogue stages bf16 in the tile's
//                   own buffer for a TMA store and folds the statistics by a
//                   reduce-scatter over the lanes that share a channel. Of
//                   the two designs built (PERF.md section 6), this one beat
//                   64-channel halves with the weights resident (147 KB) and
//                   one input buffer, whose loads never overlapped its MMAs.
//   K11 c1_site     (experiments/mk13_c1.py c1_site) Johnson's conv1 in its f=2
//                   block form: the 5x5 conv 12→128 of the 4-px phase-reflect-
//                   padded space-to-depth image, f32 accumulation + bias → bf16.
//                   One tap's K is 12 channels; the five dx taps of a kernel row
//                   pack into K = 64 (60 + 4 zero weights) with no copy at all:
//                   a staged input row holds its pixels' 12 channels back to
//                   back, so output pixel x's packed row is the 60 contiguous
//                   values from pixel x on. 3.19e11 FLOP, but the 1.06 GB
//                   output bounds it (bytes; its MMAs at K = 64 take as
//                   long at the tensor peak). c1_kernel, its first core
//                   (kept for timing, c1_site_prev_launch), took 8 x 32
//                   tiles on 64 channels, restaged all five kernel rows'
//                   weights in each of its 8,160 blocks by scalar loads,
//                   fed mma.sync by 32-bit loads and overlapped nothing.
//                   c1_wgmma_kernel (below) is persistent, one block an SM
//                   on all 128 channels with the weights resident: a
//                   producer warpgroup lands each 68-pixel input row once
//                   for the five output rows that read it, walking column
//                   strips down the image; two consumer warpgroups on
//                   alternate tiles run 20 wgmma m64n128k16 a 64-pixel
//                   tile, A from registers (a pixel's row starts 8-byte
//                   aligned, which no ldmatrix or descriptor reads; the k
//                   order is permuted so that each lane's fragment halves
//                   are adjacent words), stage the outputs by stmatrix, and
//                   two TMA stores a tile leave during the warpgroup's next
//                   MMAs. Of the forms timed on an H100 (PERF.md section 6)
//                   it beat one consumer warpgroup, plain 32-bit staging
//                   stores, the stores issued after the staging, and a
//                   deeper ring.

#include <cuda.h>
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

#include "hopper.cuh"

// four 8x8 b16 matrices from shared memory, lane l giving row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// cp.async of 16 bytes, its groups
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v, as far as the compiler knows changed here: what is computed from it
// stays where it is used (no hoisting out of a loop into registers)
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// a named barrier's arrival that does not wait (a producer's signal; the
// consumers' bar_sync on the same barrier waits for it)
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major operand of 64-byte rows under the 64-byte
// swizzle (16-byte chunk k of row r at k ^ (r / 2 mod 4)): 8-row atoms 512
// bytes apart
__device__ __forceinline__ uint64_t desc_kmajor64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

// D[64 x 64] (+)= A[64 x 16] (registers) x B[16 x 64] (K-major descriptor), bf16, f32 sums
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t* a, uint64_t desc,
                                               int sd) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(sd));
}

// Built with -DMMA_PHASE_CLOCKS (chip_smoke.py --phases), thread 0 of each
// block adds the clock cycles of the phases of K9b's row loop (warp 0) into
// mma_phase_clocks[block]: 0 the next row's loads issued, 1 the wait for the
// row's raw input, 2 its activation, 3 the MMAs issued, 4 the K lanes, the
// dy-sum and the row's stores (the MMAs' drain included).
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
// fused_wgmma_kernel: K10 on Hopper's warpgroup MMAs, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kFTH = 4, kFTW = 32;                 // output tile: rows x columns (128 pixels)
constexpr int kFHR = kFTH + 2, kFHC = kFTW + 2;    // its haloed input tile
constexpr int kFPix = kFHR * kFHC;                 // input pixels a tile
constexpr int kFHalf = ((kFPix * kSpan + 1023) / 1024) * 1024;  // one 64-channel half, padded
constexpr int kFIn = 2 * kFHalf;                   // the staged input tile
constexpr int kFSlab = 2 * 128 * kSpan;           // one tap's weights [2 co halves][128 c][128 B]
constexpr int kFCons = 256;                        // consumers: two warpgroups of 64 pixels
constexpr int kFThreads = kFCons + 128;            // + one producer warpgroup
constexpr int kFBars = 256;

// 8 raw bf16 channels → K10's prologue, a, c the channels' affine
template <int PRO>
__device__ __forceinline__ uint4 prologue8(uint4 v, const float* a, const float* c) {
  uint2 lo = make_uint2(v.x, v.y), hi = make_uint2(v.z, v.w);
  lo = prologue4<PRO>(reinterpret_cast<const __nv_bfloat16*>(&lo), a, c, 0);
  hi = prologue4<PRO>(reinterpret_cast<const __nv_bfloat16*>(&hi), a, c, 4);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

struct alignas(64) FusedArgs {
  CUtensorMap map_x;    // x_pad [B][Hp][Wp][128]: boxes of 64 channels x kFHC x kFHR x 1
  CUtensorMap map_w;    // w [9][128][CO]: boxes of 64 co x 128 c x 1
  CUtensorMap map_out;  // out [B][H][W][CO]: boxes of 64 co x kFTW x kFTH x 1
  const float* stat;    // [B][2][128]
  const float* bias;    // [CO]
  float* part;          // [B][tiles an image][2][CO]
  int H, W, tx, tpi, tiles;  // column tiles, tiles an image, tiles in all
};

constexpr int kFNW = 3;      // weight slabs in flight
constexpr int kFNIn = 2;     // input tiles in flight
constexpr int kFActFrom = 9; // the MMA group from which the next tile is activated, two pieces a group
constexpr size_t kFSmem = 1024 + (size_t)kFNIn * kFIn + (size_t)kFNW * kFSlab +
                          sizeof(float) * (2 * 256 + 128 + 8 * 2 * 128) + kFBars;

// One level of a reduce-scatter of v over the lanes `m` apart: the lane
// whose bit m is set keeps the upper half, each kept value summed with the
// partner's.
template <int H, int M, int N>
__device__ __forceinline__ void fold_half(float (&v)[N], int lane) {
  const bool up = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H], keep = up ? v[i + H] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, M));
  }
}

// With -DMMA_PHASE_CLOCKS thread 0 adds the clocks of its tile loop's
// phases: 0 waiting for an input tile, 1 the first tile's activation (each
// later tile is activated during the MMAs of the one before), 2 waiting for
// a tap's weights, 3 the fragments loaded and the MMAs issued (the next
// tile's activation between them), 4 the epilogue and the statistics (the
// last MMAs' drain included).
template <int PRO, bool STATS>
__global__ void __launch_bounds__(kFThreads, 1) fused_wgmma_kernel(const __grid_constant__ FusedArgs p) {
  constexpr bool ACT = PRO != kProNone;
  constexpr int PIECES = 2 * kFPix * 8;  // 16-byte pieces of an input tile
  static_assert((PIECES + kFCons - 1) / kFCons <= 2 * (18 - kFActFrom), "activation outruns the MMAs");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_in = base;                                       // [kFNIn][2 halves][kFPix][128]
  uint8_t* s_w = s_in + kFNIn * kFIn;                         // [kFNW][2 co halves][128 c][128]
  float* s_aff = reinterpret_cast<float*>(s_w + kFNW * kFSlab);  // [2][a, c]: by tile parity
  float* s_bias = s_aff + 2 * 256;                            // [128]
  float* s_sum = s_bias + 128;                                // [8 warps][2][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_sum + 8 * 2 * 128);
  uint64_t* in_full = bars;
  uint64_t* in_empty = bars + kFNIn;
  uint64_t* w_full = bars + 2 * kFNIn;
  uint64_t* w_empty = w_full + kFNW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kFNIn; ++i) {
      mbar_init(&in_full[i], 1);
      mbar_init(&in_empty[i], 1);
    }
    for (int i = 0; i < kFNW; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], kFCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 128) s_bias[tid] = p.bias[tid];
  __syncthreads();

  if (warp >= kFCons / 32) {
    // the producer: one lane brings the input tiles, one tile ahead of the
    // weights, and the taps' weights
    setmaxnreg_dec<40>();  // its registers go to the consumers
    if (warp == kFCons / 32 && lane == 0) {
      Ring ri = {0, 0u}, rw = {0, 0u};
      auto load_input = [&](int t) {
        const int b = t / p.tpi, ty0 = (t % p.tpi) / p.tx * kFTH, tx0 = (t % p.tpi) % p.tx * kFTW;
        mbar_wait(&in_empty[ri.i], ri.ph ^ 1u);
        mbar_expect_tx(&in_full[ri.i], 2u * kFPix * kSpan);
        uint8_t* dst = s_in + ri.i * kFIn;
        tma_load_4d(dst, &p.map_x, &in_full[ri.i], 0, tx0, ty0, b);
        tma_load_4d(dst + kFHalf, &p.map_x, &in_full[ri.i], 64, tx0, ty0, b);
        ri.next(kFNIn);
      };
      if ((int)blockIdx.x < p.tiles) load_input(blockIdx.x);
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        for (int tap = 0; tap < 9; ++tap) {
          // the next tile's input once this tile's first slabs are asked
          // for: its buffer frees early in this tile
          if (tap == kFNW && t + (int)gridDim.x < p.tiles) load_input(t + gridDim.x);
          mbar_wait(&w_empty[rw.i], rw.ph ^ 1u);
          mbar_expect_tx(&w_full[rw.i], (uint32_t)kFSlab);
          uint8_t* slab = s_w + rw.i * kFSlab;
          tma_load_3d(slab, &p.map_w, &w_full[rw.i], 0, 0, tap);
          tma_load_3d(slab + kFSlab / 2, &p.map_w, &w_full[rw.i], 64, 0, tap);
          rw.next(kFNW);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // the consumers: warp wq of warpgroup wg computes output row 2wg + wq / 2,
  // columns 16·(wq % 2).. of the tile, on all 128 channels
  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tg = lane & 3;
  const int ly = 2 * wg + (wq >> 1), lx = 16 * (wq & 1);
  const int khalf = lane >> 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t afr[2][16];
  Ring ri = {0, 0u}, rw = {0, 0u};

  // the prologue in place on piece i of an input tile: channels 8·(its
  // swizzled position) of a 64-channel half
  auto activate = [&](uint8_t* tile, const float* aff, int i) {
    const int hc = i / (kFPix * 8), pix = (i >> 3) % kFPix, q = i & 7;
    const int ch = 64 * hc + 8 * (q ^ (pix & 7));
    uint4* ptr = reinterpret_cast<uint4*>(tile + hc * kFHalf + pix * kSpan + 16 * q);
    *ptr = prologue8<PRO>(*ptr, aff + ch, aff + 128 + ch);
  };
  MMA_PHASE_START
  if (ACT && (int)blockIdx.x < p.tiles) {
    s_aff[tid] = p.stat[blockIdx.x / p.tpi * 256 + tid];  // a (0..127), c (128..255)
    mbar_wait(&in_full[0], 0u);
    MMA_PHASE(0)
    bar_sync(1, kFCons);  // the affine is staged
    for (int i = tid; i < PIECES; i += kFCons) activate(s_in, s_aff, i);
    bar_sync(1, kFCons);  // the first tile is activated
    MMA_PHASE(1)
  }

  for (int t = blockIdx.x, n = 0; t < p.tiles; t += gridDim.x, ++n) {
    const int b = t / p.tpi, ty0 = (t % p.tpi) / p.tx * kFTH, tx0 = (t % p.tpi) % p.tx * kFTW;
    uint8_t* buf = s_in + ri.i * kFIn;
    const uint32_t buf_s = smem_addr(buf);
    // the next tile, activated during this one's MMAs
    const int tn = t + gridDim.x;
    const bool next = ACT && tn < p.tiles;
    Ring rn = ri;
    rn.next(kFNIn);
    uint8_t* nbuf = s_in + rn.i * kFIn;
    const float* naff = s_aff + ((n + 1) & 1) * 256;
    if (next) s_aff[((n + 1) & 1) * 256 + tid] = p.stat[tn / p.tpi * 256 + tid];
    mbar_wait(&in_full[ri.i], ri.ph);
    MMA_PHASE(0)

    // 9 taps x 8 k16 steps, in groups of one tap's 64-channel half (4 k16
    // steps); A by ldmatrix at the tap's (dy, dx) pixel shift, into the
    // register set the group before last used
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int pix = (ly + tap / 3) * kFHC + lx + (lane & 15) + tap % 3;
      const uint32_t rb = buf_s + (uint32_t)pix * kSpan;
      MMA_PHASE(3)
      mbar_wait(&w_full[rw.i], rw.ph);
      MMA_PHASE(2)
      const uint64_t desc = desc_mnmajor(smem_addr(s_w + rw.i * kFSlab), kFSlab / 2);
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int k = 2 * tap + hc;
        uint32_t(&f)[16] = afr[hc];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t(&fs)[4] = *reinterpret_cast<uint32_t(*)[4]>(&f[4 * s]);
          ldsm_x4(fs, rb + hc * kFHalf + (uint32_t)(((2 * s + khalf) ^ (pix & 7)) << 4));
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_bf16<1>(acc, &f[4 * s], desc + (uint64_t)((4 * hc + s) * 128), tap | hc | s);
        wgmma_commit();
        if (k == 0 && n > 0 && tid == 0) {
          bulk_wait_read<0>();  // the tile before's output has left its buffer
          mbar_arrive(&in_empty[rn.i]);
        }
        if (next && k >= kFActFrom) {
          if (k == kFActFrom) {
            MMA_PHASE(3)
            mbar_wait(&in_full[rn.i], rn.ph);
            MMA_PHASE(0)
            bar_sync(1, kFCons);  // its affine is staged
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = tid + kFCons * (2 * (k - kFActFrom) + h);
            if (i < PIECES) activate(nbuf, naff, i);
          }
        }
        wgmma_wait<1>();
        // the previous tap's last group is done: its weights may go
        if (hc == 0 && tap > 0 && lane == 0) mbar_arrive(&w_empty[(rw.i + kFNW - 1) % kFNW]);
      }
      rw.next(kFNW);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&w_empty[(rw.i + kFNW - 1) % kFNW]);
    MMA_PHASE(3)

    // epilogue: + bias in f32, bf16 into the input tile's buffer (every warp
    // is done reading it), stored by TMA (rows and columns past H, W are not
    // written); the sums of the f32 values of the pixels inside the grid,
    // per thread over its two pixels, then over the 8 lanes that share a
    // channel by a reduce-scatter (each lane keeps 4 of a pass's 32 sums)
    bar_sync(1, kFCons);
    const int oy = ty0 + ly;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float v[32];  // [Σ, Σ²][8 channel groups][2 channels]
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * pass + jj, co = 8 * j + 2 * tg;
        const float bi0 = s_bias[co], bi1 = s_bias[co + 1];
        float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = lx + gq + 8 * h;
          const float f0 = __fadd_rn(acc[4 * j + 2 * h], bi0);
          const float f1 = __fadd_rn(acc[4 * j + 2 * h + 1], bi1);
          *reinterpret_cast<__nv_bfloat162*>(buf + pass * (kFTH * kFTW * kSpan) +
                                             swz(ly * kFTW + px, jj) + 4 * tg) =
              __floats2bfloat162_rn(f0, f1);
          if (STATS && oy < p.H && tx0 + px < p.W) {
            s1[0] = __fadd_rn(s1[0], f0);
            s1[1] = __fadd_rn(s1[1], f1);
            s2[0] = __fadd_rn(s2[0], __fmul_rn(f0, f0));
            s2[1] = __fadd_rn(s2[1], __fmul_rn(f1, f1));
          }
        }
        v[2 * jj] = s1[0];
        v[2 * jj + 1] = s1[1];
        v[16 + 2 * jj] = s2[0];
        v[16 + 2 * jj + 1] = s2[1];
      }
      if (STATS) {
        fold_half<16, 16>(v, lane);  // Σ or Σ² by gq bit 2
        fold_half<8, 8>(v, lane);    // channel group bit 2 by gq bit 1
        fold_half<4, 4>(v, lane);    // channel group bit 1 by gq bit 0
        const int s = (lane >> 4) & 1, jj0 = ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_sum[(warp * 2 + s) * 128 + 8 * (8 * pass + jj0 + (i >> 1)) + 2 * tg + (i & 1)] = v[i];
      }
    }
    fence_async_smem();
    bar_sync(1, kFCons);
    if (tid == 0) {  // the buffer is released once the store has read it (next tile)
      for (int hc = 0; hc < 2; ++hc)
        tma_store_4d(&p.map_out, buf + hc * (kFTH * kFTW * kSpan), 64 * hc, tx0, ty0, b);
      bulk_commit();
    }
    ri.next(kFNIn);
    if (STATS) {  // warps in order, for the tile's partial sums
      const int s = tid >> 7, co = tid & 127;
      float v = 0.0f;
      for (int w = 0; w < kFCons / 32; ++w) v = __fadd_rn(v, s_sum[(w * 2 + s) * 128 + co]);
      p.part[(((size_t)b * p.tpi + t % p.tpi) * 2 + s) * 128 + co] = v;
    }
    MMA_PHASE(4)
  }
  if (tid == 0) bulk_wait_read<0>();
  MMA_PHASE_END
}

// K10 on fused_wgmma_kernel (CO = 128) and, with STATS, the reduce.
template <int PRO, bool STATS>
int launch_fused_wgmma(const __nv_bfloat16* x, const float* stat, const __nv_bfloat16* w,
                       const float* bias, __nv_bfloat16* out, float* part, float* sums, int B,
                       int Hi, int Wi, int H, int W, void* stream) {
  FusedArgs p = {};
  const int dx[4] = {128, Wi, Hi, B}, bx[4] = {64, kFHC, kFHR, 1};
  const int dw[3] = {128, 128, 9}, bw[3] = {64, 128, 1};
  const int dout[4] = {128, W, H, B}, bout[4] = {64, kFTW, kFTH, 1};
  const CUtensorMapDataType b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&p.map_x, b16, 2, x, 4, dx, bx) || !make_map(&p.map_w, b16, 2, w, 3, dw, bw) ||
      !make_map(&p.map_out, b16, 2, out, 4, dout, bout))
    return (int)cudaErrorInvalidValue;
  p.stat = stat; p.bias = bias; p.part = part;
  p.H = H; p.W = W;
  p.tx = (W + kFTW - 1) / kFTW;
  p.tpi = p.tx * ((H + kFTH - 1) / kFTH);
  p.tiles = B * p.tpi;
  auto kern = fused_wgmma_kernel<PRO, STATS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFSmem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<p.tiles < sms ? p.tiles : sms, kFThreads, kFSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !STATS) return (int)err;
  const int n = B * 2 * 128;
  stats_reduce_bf16<<<(n + 255) / 256, 256, 0, s>>>(part, sums, B, p.tpi, 128);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// d2_wgmma_kernel: K9a on Hopper's warpgroup MMAs, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kDC = 64, kDCO = 128;             // deconv2's phase conv: 64 → 128 channels
constexpr int kDPix = kFPix;                    // a 4 x 32 output tile's haloed 6 x 34 input
constexpr int kDIn = kDPix * kSpan;             // its bytes (64 channels: one 128-byte row a pixel)
constexpr int kDOut = kFTH * kFTW * kDCO * 2;   // the tile's bf16 output, two 64-channel halves
constexpr int kDBuf = kDOut > kDIn ? kDOut : kDIn;  // a buffer: the input, then the staged output
constexpr int kDSlab = kDCO * kSpan;            // one tap's weights [128 co][64 c]
constexpr int kDNIn = 2;                        // input tiles in flight
constexpr int kDActFrom = 6, kDActPer = 3;      // the next tile activated from tap 6, 3 pieces a tap
constexpr size_t kDSmem = 1024 + (size_t)kDNIn * kDBuf + 9 * (size_t)kDSlab +
                          sizeof(float) * (2 * 2 * kDC + kDCO + 8 * 2 * kDCO) + 64;
static_assert(kDSmem <= 232448, "the block fits in an SM's shared memory");

struct alignas(64) D2Args {
  CUtensorMap map_x;    // x [B][H][W][64]: boxes of 64 channels x kFHC x kFHR x 1 (zero fill outside)
  CUtensorMap map_w;    // w [9][128][64]: boxes of 64 c x 128 co x 1
  CUtensorMap map_out;  // out [B][H][W][128]: boxes of 64 co x kFTW x kFTH x 1
  const float *a, *c;   // [B][64] the in4 affine
  const float* bias;    // [128]
  float* part;          // [B][tiles an image][2][128]
  const float* x32;     // F32IN: x [B][H][W][64] f32 (no map_x)
  int H, W, tx, tpi, tiles;  // column tiles, tiles an image, tiles in all
};

// F32IN (d2_wgmma_kernel's f32 form): piece i of tile (b, ty0, tx0)'s
// haloed input, activated, from the f32 raw x in device memory: the 8
// channels of the piece's swizzled position at the pixel that the edge
// halo maps it to (clamped into the image: the frame's edge copy, and any
// position beyond it feeds only outputs that are not stored), each rounded
// once, bf16(max(x·a + c, 0)), as the Pallas prologue does.
__device__ __forceinline__ void d2_activate_f32(uint8_t* tile, const D2Args& p, int b, int ty0,
                                                int tx0, const float* aff, int i) {
  const int pix = i >> 3, q = i & 7;
  const int ch = 8 * (q ^ (pix & 7));
  const int sy = min(max(ty0 - 1 + pix / kFHC, 0), p.H - 1);
  const int sx = min(max(tx0 - 1 + pix % kFHC, 0), p.W - 1);
  const float4* src = reinterpret_cast<const float4*>(
      p.x32 + (((size_t)b * p.H + sy) * p.W + sx) * kDC + ch);
  const float4 u = __ldg(src), w = __ldg(src + 1);
  const float v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = fmaxf(__fadd_rn(__fmul_rn(v[2 * k], aff[ch + 2 * k]), aff[kDC + ch + 2 * k]),
                           0.0f);
    const float hi = fmaxf(__fadd_rn(__fmul_rn(v[2 * k + 1], aff[ch + 2 * k + 1]),
                                     aff[kDC + ch + 2 * k + 1]), 0.0f);
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    o[k] = *reinterpret_cast<const uint32_t*>(&r);
  }
  *reinterpret_cast<uint4*>(tile + pix * kSpan + 16 * q) = make_uint4(o[0], o[1], o[2], o[3]);
}

// The edge halo of a tile whose haloed input crosses the image's border:
// TMA filled the positions outside the image with zeros; each position of
// the image's one-pixel frame (row -1 or H, column -1 or W) takes the raw
// pixel of the nearest row and column inside, which the tile holds. Farther
// positions (a partial tile's rows past H + 1 or columns past W + 1) feed
// only outputs that are not stored. Pieces are 16 bytes, in and out of the
// 128-byte swizzle. Before the activation: x' of an edge copy is the copy of
// x'.
__device__ __forceinline__ void d2_patch(uint8_t* tile, int ty0, int tx0, int H, int W, int tid) {
  if (ty0 > 0 && tx0 > 0 && ty0 + kFTH < H && tx0 + kFTW < W) return;
  for (int i = tid; i < kDPix * 8; i += kFCons) {
    const int pix = i >> 3, q = i & 7;
    const int gy = ty0 - 1 + pix / kFHC, gx = tx0 - 1 + pix % kFHC;
    if (gy < -1 || gy > H || gx < -1 || gx > W || (gy >= 0 && gy < H && gx >= 0 && gx < W))
      continue;
    const int sy = min(max(gy, 0), H - 1), sx = min(max(gx, 0), W - 1);
    const int src = (sy - ty0 + 1) * kFHC + (sx - tx0 + 1);
    *reinterpret_cast<uint4*>(tile + swz(pix, q)) =
        *reinterpret_cast<const uint4*>(tile + swz(src, q));
  }
}

// K9a: fused_wgmma_kernel's design at C = 64 with the weights resident. A
// persistent block an SM walks 4 x 32-pixel tiles; its producer warpgroup
// brings all nine taps' [128 co][64 c] weights by TMA once (147,456 bytes)
// and then each tile's haloed 6 x 34 x 64 input one tile ahead (two
// buffers); two consumer warpgroups of 64 pixels run wgmma m64n128k16, B
// K-major through its descriptor, A from registers by ldmatrix at each
// tap's (dy, dx) shift, 9 groups (taps) of 4 k16 steps a tile. The next
// tile's halo patch (border tiles) and activation run during this tile's
// last three groups; the epilogue stages bf16 in the tile's own buffer for
// a TMA store and folds the statistics as K10's does. Of the variants timed
// on an H100 (PERF.md section 6) this was the fastest: bf16 pairs stored
// straight from the accumulators, which frees a buffer for a third input
// tile in flight, was slower, and activating from tap 7 or 8 no faster. With
// -DMMA_PHASE_CLOCKS thread 0 adds the clocks of: 0 waiting for an input
// tile, 1 the first tile's patch and activation, 2 waiting for the weights
// (once), 3 the fragments loaded and the MMAs issued (the next tile's patch
// and activation between them), 4 the epilogue and the statistics (the last
// MMAs' drain included).
// F32IN (K9a under float32: deconv1's f32 raw, which the Pallas prologue
// reads unrounded): an f32 tile (52 KB) does not fit twice beside the
// resident weights, so no TMA brings x: the consumers' activation reads
// each piece's 8 f32 channels from device memory (d2_activate_f32; the
// edge halo as clamped source pixels, no patch) and writes the bf16 piece
// into the tile's buffer, at the same point of the tap loop as the bf16
// form's in-place activation. The buffer's store two tiles back has been
// read (thread 0's wait at tap 0, before the barrier at kDActFrom).
template <bool F32IN>
__global__ void __launch_bounds__(kFThreads, 1) d2_wgmma_kernel(const __grid_constant__ D2Args p) {
  constexpr int PIECES = kDPix * 8;  // 16-byte pieces of an input tile
  static_assert((PIECES + kFCons - 1) / kFCons <= kDActPer * (9 - kDActFrom),
                "activation outruns the MMAs");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_in = base;                                         // [kDNIn][kDBuf]
  uint8_t* s_w = s_in + kDNIn * kDBuf;                          // [9][128 co][128 B]
  float* s_aff = reinterpret_cast<float*>(s_w + 9 * kDSlab);    // [2][a 64, c 64]: by tile parity
  float* s_bias = s_aff + 2 * 2 * kDC;                          // [128]
  float* s_sum = s_bias + kDCO;                                 // [8 warps][2][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_sum + 8 * 2 * kDCO);
  uint64_t* in_full = bars;
  uint64_t* in_empty = bars + kDNIn;
  uint64_t* w_full = bars + 2 * kDNIn;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kDNIn; ++i) {
      mbar_init(&in_full[i], 1);
      mbar_init(&in_empty[i], 1);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kDCO) s_bias[tid] = p.bias[tid];
  __syncthreads();

  auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / p.tpi;
    ty0 = (t % p.tpi) / p.tx * kFTH;
    tx0 = (t % p.tpi) % p.tx * kFTW;
  };
  if (warp >= kFCons / 32) {
    // the producer: one lane brings the weights, then the input tiles
    setmaxnreg_dec<40>();  // its registers go to the consumers
    if (warp == kFCons / 32 && lane == 0) {
      mbar_expect_tx(w_full, 9u * kDSlab);
      for (int tap = 0; tap < 9; ++tap) tma_load_3d(s_w + tap * kDSlab, &p.map_w, w_full, 0, 0, tap);
      Ring ri = {0, 0u};
      for (int t = blockIdx.x; t < (F32IN ? 0 : p.tiles); t += gridDim.x) {
        int b, ty0, tx0;
        tile_of(t, b, ty0, tx0);
        mbar_wait(&in_empty[ri.i], ri.ph ^ 1u);
        mbar_expect_tx(&in_full[ri.i], (uint32_t)kDIn);
        tma_load_4d(s_in + ri.i * kDBuf, &p.map_x, &in_full[ri.i], 0, tx0 - 1, ty0 - 1, b);
        ri.next(kDNIn);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // the consumers: warp wq of warpgroup wg computes output row 2wg + wq / 2,
  // columns 16·(wq % 2).. of the tile, on all 128 channels
  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tg = lane & 3;
  const int ly = 2 * wg + (wq >> 1), lx = 16 * (wq & 1);
  const int khalf = lane >> 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  uint32_t afr[2][16];
  Ring ri = {0, 0u};

  // the affine of image b into parity slot `par` (threads 0..127)
  auto stage_aff = [&](int par, int b) {
    if (tid < 2 * kDC) s_aff[par * 2 * kDC + tid] = (tid < kDC ? p.a : p.c)[b * kDC + tid % kDC];
  };
  // the prologue in place on piece i of an input tile: channels 8·(its
  // swizzled position)
  auto activate = [&](uint8_t* tile, const float* aff, int i) {
    const int pix = i >> 3, q = i & 7;
    const int ch = 8 * (q ^ (pix & 7));
    uint4* ptr = reinterpret_cast<uint4*>(tile + pix * kSpan + 16 * q);
    *ptr = prologue8<kProF32>(*ptr, aff + ch, aff + kDC + ch);
  };
  MMA_PHASE_START
  if ((int)blockIdx.x < p.tiles) {
    int b, ty0, tx0;
    tile_of(blockIdx.x, b, ty0, tx0);
    stage_aff(0, b);
    if (!F32IN) {
      mbar_wait(&in_full[0], 0u);
      MMA_PHASE(0)
      d2_patch(s_in, ty0, tx0, p.H, p.W, tid);
    }
    bar_sync(1, kFCons);  // the affine is staged, the halo patched
    for (int i = tid; i < PIECES; i += kFCons) {
      if (F32IN)
        d2_activate_f32(s_in, p, b, ty0, tx0, s_aff, i);
      else
        activate(s_in, s_aff, i);
    }
    bar_sync(1, kFCons);  // the first tile is activated
    MMA_PHASE(1)
    mbar_wait(w_full, 0u);
    MMA_PHASE(2)
  }

  for (int t = blockIdx.x, n = 0; t < p.tiles; t += gridDim.x, ++n) {
    int b, ty0, tx0;
    tile_of(t, b, ty0, tx0);
    uint8_t* buf = s_in + ri.i * kDBuf;
    const uint32_t buf_s = smem_addr(buf);
    // the next tile, patched and activated during this one's MMAs
    const int tn = t + gridDim.x;
    const bool next = tn < p.tiles;
    int nb = 0, nty0 = 0, ntx0 = 0;
    if (next) tile_of(tn, nb, nty0, ntx0);
    Ring rn = ri;
    rn.next(kDNIn);
    uint8_t* nbuf = s_in + rn.i * kDBuf;
    const float* naff = s_aff + ((n + 1) & 1) * 2 * kDC;
    if (next) stage_aff((n + 1) & 1, nb);
    if (!F32IN) mbar_wait(&in_full[ri.i], ri.ph);
    MMA_PHASE(0)

    // 9 taps x 4 k16 steps, a group a tap; A by ldmatrix at the tap's (dy,
    // dx) pixel shift, into the register set the group before last used
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int pix = (ly + tap / 3) * kFHC + lx + (lane & 15) + tap % 3;
      const uint32_t rb = buf_s + (uint32_t)pix * kSpan;
      const uint64_t desc = desc_kmajor(smem_addr(s_w + tap * kDSlab));
      uint32_t(&f)[16] = afr[tap & 1];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t(&fs)[4] = *reinterpret_cast<uint32_t(*)[4]>(&f[4 * s]);
        ldsm_x4(fs, rb + (uint32_t)(((2 * s + khalf) ^ (pix & 7)) << 4));
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_bf16<0>(acc, &f[4 * s], desc + 2 * s, tap | s);
      wgmma_commit();
      if (tap == 0 && n > 0 && tid == 0) {
        bulk_wait_read<0>();  // the tile before's output has left its buffer
        if (!F32IN) mbar_arrive(&in_empty[rn.i]);
      }
      if (next && tap >= kDActFrom) {
        if (tap == kDActFrom) {
          MMA_PHASE(3)
          if (!F32IN) {
            mbar_wait(&in_full[rn.i], rn.ph);
            MMA_PHASE(0)
            d2_patch(nbuf, nty0, ntx0, p.H, p.W, tid);
          }
          bar_sync(1, kFCons);  // its affine is staged, its halo patched (F32IN: its buffer free)
        }
#pragma unroll
        for (int h = 0; h < kDActPer; ++h) {
          const int i = tid + kFCons * (kDActPer * (tap - kDActFrom) + h);
          if (i < PIECES) {
            if (F32IN)
              d2_activate_f32(nbuf, p, nb, nty0, ntx0, naff, i);
            else
              activate(nbuf, naff, i);
          }
        }
      }
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    MMA_PHASE(3)

    // epilogue: + bias in f32, bf16 into the input tile's buffer (every warp
    // is done reading it), stored by TMA (rows and columns past H, W are not
    // written); the sums of the f32 values of the pixels inside the grid,
    // per thread over its two pixels, then over the 8 lanes that share a
    // channel by a reduce-scatter (each lane keeps 4 of a pass's 32 sums)
    bar_sync(1, kFCons);
    const int oy = ty0 + ly;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float v[32];  // [Σ, Σ²][8 channel groups][2 channels]
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * pass + jj, co = 8 * j + 2 * tg;
        const float bi0 = s_bias[co], bi1 = s_bias[co + 1];
        float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = lx + gq + 8 * h;
          const float f0 = __fadd_rn(acc[4 * j + 2 * h], bi0);
          const float f1 = __fadd_rn(acc[4 * j + 2 * h + 1], bi1);
          *reinterpret_cast<__nv_bfloat162*>(buf + pass * (kFTH * kFTW * kSpan) +
                                             swz(ly * kFTW + px, jj) + 4 * tg) =
              __floats2bfloat162_rn(f0, f1);
          if (oy < p.H && tx0 + px < p.W) {
            s1[0] = __fadd_rn(s1[0], f0);
            s1[1] = __fadd_rn(s1[1], f1);
            s2[0] = __fadd_rn(s2[0], __fmul_rn(f0, f0));
            s2[1] = __fadd_rn(s2[1], __fmul_rn(f1, f1));
          }
        }
        v[2 * jj] = s1[0];
        v[2 * jj + 1] = s1[1];
        v[16 + 2 * jj] = s2[0];
        v[16 + 2 * jj + 1] = s2[1];
      }
      fold_half<16, 16>(v, lane);  // Σ or Σ² by gq bit 2
      fold_half<8, 8>(v, lane);    // channel group bit 2 by gq bit 1
      fold_half<4, 4>(v, lane);    // channel group bit 1 by gq bit 0
      const int s = (lane >> 4) & 1, jj0 = ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s_sum[(warp * 2 + s) * kDCO + 8 * (8 * pass + jj0 + (i >> 1)) + 2 * tg + (i & 1)] = v[i];
    }
    fence_async_smem();
    bar_sync(1, kFCons);
    if (tid == 0) {  // the buffer is released once the store has read it (next tile)
      for (int hc = 0; hc < 2; ++hc)
        tma_store_4d(&p.map_out, buf + hc * (kFTH * kFTW * kSpan), 64 * hc, tx0, ty0, b);
      bulk_commit();
    }
    ri.next(kDNIn);
    {  // warps in order, for the tile's partial sums
      const int s = tid >> 7, co = tid & 127;
      float v = 0.0f;
      for (int w = 0; w < kFCons / 32; ++w) v = __fadd_rn(v, s_sum[(w * 2 + s) * kDCO + co]);
      p.part[(((size_t)b * p.tpi + t % p.tpi) * 2 + s) * kDCO + co] = v;
    }
    MMA_PHASE(4)
  }
  if (tid == 0) bulk_wait_read<0>();
  MMA_PHASE_END
}

// K9a on d2_wgmma_kernel and the reduce; F32IN: x is f32.
template <bool F32IN>
int launch_d2_wgmma(const void* x, const float* a, const float* c,
                    const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out, float* part,
                    float* sums, int B, int H, int W, void* stream) {
  if (B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  D2Args p = {};
  const int dx[4] = {kDC, W, H, B}, bx[4] = {kDC, kFHC, kFHR, 1};
  const int dw[3] = {kDC, kDCO, 9}, bw[3] = {kDC, kDCO, 1};
  const int dout[4] = {kDCO, W, H, B}, bout[4] = {64, kFTW, kFTH, 1};
  const CUtensorMapDataType b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((!F32IN && !make_map(&p.map_x, b16, 2, x, 4, dx, bx)) ||
      !make_map(&p.map_w, b16, 2, w, 3, dw, bw) ||
      !make_map(&p.map_out, b16, 2, out, 4, dout, bout))
    return (int)cudaErrorInvalidValue;
  if (F32IN) p.x32 = static_cast<const float*>(x);
  p.a = a; p.c = c; p.bias = bias; p.part = part;
  p.H = H; p.W = W;
  p.tx = (W + kFTW - 1) / kFTW;
  p.tpi = p.tx * ((H + kFTH - 1) / kFTH);
  p.tiles = B * p.tpi;
  cudaError_t err = cudaFuncSetAttribute(d2_wgmma_kernel<F32IN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDSmem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  d2_wgmma_kernel<F32IN><<<p.tiles < sms ? p.tiles : sms, kFThreads, kDSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * 2 * kDCO;
  stats_reduce_bf16<<<(n + 255) / 256, 256, 0, s>>>(part, sums, B, p.tpi, kDCO);
  return (int)cudaGetLastError();
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
  const float* x32;         // K9e's f32 form: the raw [B,H,W,128] in f32 (x unused)
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

// ---------------------------------------------------------------------------
// d3sum_mma_kernel: K9b on the bf16 tensor cores
// ---------------------------------------------------------------------------

constexpr int kBPX = 2 * kRC + 16;  // bytes per staged pixel and per weight row (bf16, 16-byte pad)
constexpr int kBBuf = 3;            // staged conv rows a warp: the two computed, one in flight
constexpr int kBRows = 2;           // conv rows a step

// Shared memory: the weights [dx][slot][kBPX], 5 x 64 x 272 = 87,040 bytes
// (staged once a block); a warp's ring of kBBuf conv rows of HC pixels
// (STRIP + 4: a 2-pixel halo each side) and its output row: 8 warps x (3 x
// 20 x 272 + 384) = 133,632, 220,672 in all (32-column strips at 8 warps
// would take 322,048).
struct D3SumSmem {
  static constexpr int WARPS = kWarps;
  static constexpr int STRIP = 16;              // output columns a warp
  static constexpr int HC = STRIP + 4;          // staged columns of a conv row
  static constexpr int W = 5 * kCOT * kBPX;
  static constexpr int ROW = HC * kBPX;
  static constexpr int OUT = STRIP * kOut * 2;  // one output row of a warp, bf16
  static constexpr int WARP = kBBuf * ROW + OUT;
  static constexpr size_t bytes = W + WARPS * WARP;
  static_assert(bytes <= 232448, "a block's shared memory");
};

// The B row (slot) that lane n = 12·dy + o of the tap-packed weights takes:
// with o = 3·tg + i, slot s = 5·i + dy of the threads tg = 0..3 of a quad
// (n8 tile s/2, column 2·tg + s%2 of the accumulator fragment), so that the
// thread that holds output channel o of a pixel holds all five of its dy
// lanes. Lanes 60-63 (zero weights) take slot 15. (As K6's in int8_sites.cu.)
__device__ __forceinline__ int d3_slot_row(int n) {
  const int tg = n < kLanes ? n % kOut / 3 : n - kLanes;
  const int s = n < kLanes ? 5 * (n % kOut % 3) + n / kOut : 15;
  return 8 * (s >> 1) + 2 * tg + (s & 1);
}

// two bf16 (the low half first) → bf16(max(f32(x)·a + c, 0)) each, as activate4
__device__ __forceinline__ uint32_t activate2f(float x0, float x1, float a0, float c0, float a1,
                                               float c1) {
  const float lo = fmaxf(__fadd_rn(__fmul_rn(x0, a0), c0), 0.0f);
  const float hi = fmaxf(__fadd_rn(__fmul_rn(x1, a1), c1), 0.0f);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t activate2(uint32_t w, float a0, float c0, float a1, float c1) {
  return activate2f(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u), a0, c0, a1, c1);
}

// Each warp walks a contiguous share of the B·strips·H (image, STRIP-column
// strip, output row) space, two conv rows a step down a strip, and restarts
// 2 conv rows above wherever its share starts a strip. Conv row y of the
// reflect-padded block grid (its HC staged columns, brought in raw by
// cp.async, each 16-byte chunk from the pixel and phase that the 4-pixel
// reflect maps it to) is activated in place by the lanes that loaded it,
// then is 40 k16 steps (5 dx taps x 128 channels) of 8 MMAs, the two rows
// of a step sharing each step's B fragments. The three ring slots hold the
// step's two rows and the next step's first, so its second row's load is
// exposed and the other warps run meanwhile. Each thread rounds its
// fragments to the K lanes bf16(acc) and adds them to the f32 partial sums
// of the output rows y-2..y+1 that it holds in registers (P[0..3]: row y-2
// completes with its dy = 4 lane, then P shifts and row y+2 starts from its
// dy = 0 lane), in dy order, as the reference adds. Row y-2 + bias, rounded to bf16 once, is staged and written 8 bytes
// a lane. The weights (slots as d3_slot_row places them) are staged once a
// block; the grid is persistent (one block an SM).
__global__ void __launch_bounds__(32 * D3SumSmem::WARPS, 1)
    d3sum_mma_kernel(RowsArgs p, int strips_x, long long rows_total) {
  using S = D3SumSmem;
  constexpr int R = kBRows;
  constexpr int NW = S::WARPS, STRIP = S::STRIP, HC = S::HC;
  constexpr int CPL = HC * 16 / 32;  // 16-byte chunks a lane of a staged row
  extern __shared__ __align__(16) uint8_t smem8[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* s_w = smem8;
  uint8_t* s_ring = smem8 + S::W + warp * S::WARP;
  __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(s_ring + kBBuf * S::ROW);

  // weights once: row (dx, n) of [5][64][128] → row (dx, slot of n), 16 bytes a thread
  for (int i = tid; i < 5 * kCOT * (kRC / 8); i += 32 * NW) {
    const int ch = i % (kRC / 8), n = (i / (kRC / 8)) % kCOT, dx = i / ((kRC / 8) * kCOT);
    *reinterpret_cast<uint4*>(s_w + (dx * kCOT + d3_slot_row(n)) * kBPX + 16 * ch) =
        *reinterpret_cast<const uint4*>(p.w + ((size_t)dx * kCOT + n) * kRC + 8 * ch);
  }
  __syncthreads();

  const int g = lane >> 2, tg = lane & 3;
  float bi[3];  // the bias of this thread's output channels 3tg..3tg+2
#pragma unroll
  for (int i = 0; i < 3; ++i) bi[i] = p.bias[3 * tg + i];
  const uint32_t b_lane = smem_addr(s_w) + ((lane >> 4) * 8 + (lane & 7)) * kBPX +
                          ((lane >> 3) & 1) * 16;
  // lane l loads and activates the 16-byte chunk l % 16 (channels 8(l % 16)..
  // +7, phase (l % 16) / 4) of the staged pixels l / 16, + 2, ...
  const int ck = lane & 15, ph = ck >> 2;
  MMA_PHASE_START

  const long long nw = (long long)gridDim.x * NW, gw = (long long)blockIdx.x * NW + warp;
  long long pos = rows_total * gw / nw;
  const long long end = rows_total * (gw + 1) / nw;
  int cur_b = -1;
  float qa[8], qc[8];  // the activation affine of the lane's 8 channels
  while (pos < end) {
    const long long strip = pos / p.H;
    const int r0 = (int)(pos % p.H);
    const int r1 = (int)min((long long)p.H, r0 + (end - pos));
    pos += r1 - r0;
    const int b = (int)(strip / strips_x), x0 = (int)(strip % strips_x) * STRIP;
    const int y0 = r0 - 2, n = r1 - r0 + 4;  // conv rows y0 .. r1 + 1
    if (b != cur_b) {
      cur_b = b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qa[j] = p.a[b * kRC + 8 * ck + j];
        qc[j] = p.c[b * kRC + 8 * ck + j];
      }
    }
    const __nv_bfloat16* img = p.x + (size_t)b * p.H * p.W * kRC + 8 * (ck & 3);
    // the lane's chunks' source columns and column phases, the same on every
    // row of the strip: staged column j is block column x0 - 2 + j
    int cols[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      int v;
      const int sx = reflect_phase(x0 - 2 + (lane >> 4) + 2 * k, ph & 1, p.W, &v);
      cols[k] = sx * kRC + v * 32;
    }

    // conv row y0 + i of the padded grid, raw, into ring slot i % kBBuf
    auto load_row = [&](int i) {
      int u;
      const int sy = reflect_phase(y0 + i, ph >> 1, p.H, &u);
      const uint32_t dst = smem_addr(s_ring + (i % kBBuf) * S::ROW) + 16 * ck;
      const __nv_bfloat16* src = img + (size_t)sy * p.W * kRC + u * 64;
#pragma unroll
      for (int k = 0; k < CPL; ++k) cp_async16(dst + ((lane >> 4) + 2 * k) * kBPX, src + cols[k]);
      cp_async_commit();
    };

    float P[2][3][4];  // [pixel g, g + 8][channel 3tg + i][output row y-2 .. y+1]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) P[h][i][k] = 0.0f;
    load_row(0);
#pragma unroll 1
    for (int i = 0; i < n; i += R) {  // conv rows i, i + 1 (those below n)
      // rows i + 1 and i + 2 into the slots of rows i - 2 and i - 1: row
      // i + 1's wait is exposed, and the other warps run meanwhile (an empty
      // group past the last row keeps the wait count)
      if (i + 1 < n) load_row(i + 1);
      else cp_async_commit();
      if (i + 2 < n) load_row(i + 2);
      else cp_async_commit();
      MMA_PHASE(0)
      cp_async_wait<1>();  // this lane's chunks of rows i and i + 1 have landed
      MMA_PHASE(1)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i + r >= n) break;
        uint8_t* row = s_ring + ((i + r) % kBBuf) * S::ROW;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          uint4* q = reinterpret_cast<uint4*>(row + ((lane >> 4) + 2 * k) * kBPX + 16 * ck);
          uint4 v = *q;
          v.x = activate2(v.x, qa[0], qc[0], qa[1], qc[1]);
          v.y = activate2(v.y, qa[2], qc[2], qa[3], qc[3]);
          v.z = activate2(v.z, qa[4], qc[4], qa[5], qc[5]);
          v.w = activate2(v.w, qa[6], qc[6], qa[7], qc[7]);
          *q = v;
        }
      }
      __syncwarp();  // the activated rows are visible to the warp's ldmatrix
      MMA_PHASE(2)

      uint32_t a_lane[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        a_lane[r] = smem_addr(s_ring + ((i + r) % kBBuf) * S::ROW) + (lane & 15) * kBPX +
                    (lane >> 4) * 16;
      float acc[R][8][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][nj][e] = 0.0f;
      uint32_t af[2][R][4], bfr[2][8][2];
      auto load = [&](int s, uint32_t (&a)[R][4], uint32_t (&bq)[8][2]) {
        const int dx = s >> 3, kc = s & 7;  // tap dx, channels 16kc..+15
#pragma unroll
        for (int r = 0; r < R; ++r) ldsm_x4(a[r], a_lane[r] + dx * kBPX + kc * 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t rr[4];
          ldsm_x4(rr, b_lane + (dx * kCOT + 16 * q) * kBPX + kc * 32);
          bq[2 * q][0] = rr[0];
          bq[2 * q][1] = rr[1];
          bq[2 * q + 1][0] = rr[2];
          bq[2 * q + 1][1] = rr[3];
        }
      };
      auto mmas = [&](const uint32_t (&a)[R][4], const uint32_t (&bq)[8][2]) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int nj = 0; nj < 8; ++nj) mma_bf16(acc[r][nj], a[r], bq[nj][0], bq[nj][1]);
      };
      constexpr int KS = 5 * kRC / 16;  // 40 k16 steps
      load(0, af[0], bfr[0]);
#pragma unroll
      for (int s = 0; s < KS; s += 2) {
        load(s + 1, af[1], bfr[1]);
        mmas(af[0], bfr[0]);
        if (s + 2 < KS) load(s + 2, af[0], bfr[0]);
        mmas(af[1], bfr[1]);
      }
      MMA_PHASE(3)

#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i + r >= n) break;
        // K lanes and the dy-sum of conv row y0 + i + r: lane (g, tg) holds
        // pixels g and g+8, slots 5i + dy in acc[r][s / 2][2h + s % 2]
        const bool emit = y0 + i + r - 2 >= r0;  // output row y - 2 is in the share
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i3 = 0; i3 < 3; ++i3) {
            float K[5];
#pragma unroll
            for (int dy = 0; dy < 5; ++dy) {
              const int s = 5 * i3 + dy;
              K[dy] = __bfloat162float(__float2bfloat16_rn(acc[r][s >> 1][2 * h + (s & 1)]));
            }
            float* pr = P[h][i3];
            const float v = __fadd_rn(__fadd_rn(pr[0], K[4]), bi[i3]);
            pr[0] = __fadd_rn(pr[1], K[3]);
            pr[1] = __fadd_rn(pr[2], K[2]);
            pr[2] = __fadd_rn(pr[3], K[1]);
            pr[3] = __fadd_rn(0.0f, K[0]);
            if (emit) s_out[(h * 8 + g) * kOut + 3 * tg + i3] = __float2bfloat16_rn(v);
          }
        __syncwarp();
        if (emit) {  // the row's STRIP x 12 bf16, 8 bytes (4 lanes of a pixel) a lane and pass
          const int y = y0 + i + r - 2;
          uint8_t* orow =
              reinterpret_cast<uint8_t*>(p.out + (((size_t)b * p.H + y) * p.W + x0) * kOut);
#pragma unroll
          for (int c = lane; c < S::OUT / 8; c += 32)
            if (x0 + c / 3 < p.W)
              *reinterpret_cast<uint2*>(orow + 8 * c) = *reinterpret_cast<const uint2*>(
                  reinterpret_cast<const uint8_t*>(s_out) + 8 * c);
        }
        __syncwarp();  // the ring slots and s_out are rewritten next
      }
      MMA_PHASE(4)
    }
  }
  MMA_PHASE_END
}

int launch_d3sum_mma(const RowsArgs& p, void* stream) {
  using S = D3SumSmem;
  if (p.B <= 0 || p.H < 3 || p.W < 3) return (int)cudaErrorInvalidValue;
  auto kern = d3sum_mma_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int strips_x = (p.W + S::STRIP - 1) / S::STRIP;
  const long long rows_total = (long long)p.B * strips_x * p.H;
  // at least 16 output rows a warp: below that the 4 rows of restart weigh
  const long long want = (rows_total + 16 * S::WARPS - 1) / (16 * S::WARPS);
  const int blocks = (int)(want < sms ? (want > 0 ? want : 1) : sms);
  kern<<<blocks, 32 * S::WARPS, S::bytes, static_cast<cudaStream_t>(stream)>>>(p, strips_x,
                                                                              rows_total);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// s2_mma_bf16_kernel: K9c and K9d on the bf16 tensor cores (stride 2)
// ---------------------------------------------------------------------------

// The block at C input and CO output channels: output tiles of TH rows x 16
// columns; one consumer warpgroup (warp w computes tile rows MI·w .. MI·w
// + MI - 1, MI = TH / 4, as the MI m64 halves of the tile) and one producer
// warpgroup, over a ring of NB plane buffers. The haloed (2TH + 1) x 33
// input tile is staged as its four (row, column) parity planes
// (int8_sites.cu's s2_pixel, at this tile's size): tap (dy, dx) of output
// pixel (r, c) reads plane (dy%2, dx%2) at (r + dy/2, c + dx/2), so the 16
// A rows of an ldmatrix are 16 consecutive plane pixels. A staged pixel and
// a weight row are 2C bytes (no pad) under an XOR swizzle of their 16-byte
// chunks (swz): any eight consecutive rows an ldmatrix reads fall in eight
// distinct bank groups, and on the 1024-byte-aligned weights it is the
// 128-byte (C = 64) or 64-byte (C = 32) swizzle of a K-major wgmma operand.
// Shared memory: alignment slack, the nine taps' weights [9][CO][C]
// (resident for the block's life), NB plane buffers of whole kilobytes
// (each holds its tile's bf16 outputs after the MMAs, as the TMA store
// reads them) and the bias; one block an SM:
//   K9c <32, 64, 8, 4>:   1,024 + 36,864 + 4 x 36,864 + 256 = 185,600
//   K9d <64, 128, 4, 2>:  1,024 + 147,456 + 2 x 38,912 + 512 = 226,816
template <int C, int CO, int TH, int NB>
struct S2Bf16 {
  static constexpr int IC = C, OC = CO, TROWS = TH, NBUF = NB;  // the arguments
  static constexpr int TW = 16;
  static constexpr int HR = 2 * TH + 1, HC = 2 * TW + 1, PIX = HR * HC;
  static constexpr int MI = TH / 4, NJ = CO / 8;  // a consumer warp's m16 tiles and n8 tiles
  static constexpr int CTHREADS = 128, PTHREADS = 128, THREADS = CTHREADS + PTHREADS;
  static constexpr int CH = C / 8;  // 16-byte chunks a pixel
  static constexpr int RB = 2 * C;  // bytes a staged pixel or weight row
  static constexpr int W = 9 * CO * RB;
  static constexpr int X = (PIX * RB + 1023) / 1024 * 1024;
  static constexpr int OUTH = TH * TW * 128;  // a tile's staged outputs, a 64-channel half
  static constexpr size_t bytes = 1024 + W + NB * X + sizeof(float) * CO;
  static_assert((C == 64 && CO == 128) || (C == 32 && CO == 64),
                "128- or 64-byte rows, n = CO of a wgmma");
  static_assert(TH % 4 == 0 && NB >= 2 && 1 + 2 * NB < 16, "a warpgroup; named barriers");
  static_assert(CO / 64 * OUTH <= X && bytes <= 232448, "shared memory");

  __host__ __device__ static constexpr int rows(int pr) { return (HR + 1 - pr) / 2; }
  __host__ __device__ static constexpr int cols(int pc) { return (HC + 1 - pc) / 2; }
  // planes (0, 0), (0, 1), (1, 0), (1, 1) in that order
  __host__ __device__ static constexpr int off(int pr, int pc) {
    return (pr ? rows(0) * (cols(0) + cols(1)) : 0) + (pc ? rows(pr) * cols(0) : 0);
  }
  // the staged pixel of haloed tile pixel (hr, hc)
  __host__ __device__ static constexpr int pixel(int hr, int hc) {
    return off(hr & 1, hc & 1) + (hr >> 1) * cols(hc & 1) + (hc >> 1);
  }
  // the swizzle of row p: 128 bytes hold 8 / CH rows, and chunk k of row p
  // sits at chunk k ^ swf(p), so that 8 consecutive rows' chunk k take the 8
  // 16-byte bank groups once each
  __host__ __device__ static constexpr int swf(int p) { return (p >> (CH == 4 ? 1 : 0)) & (CH - 1); }
  __host__ __device__ static constexpr uint32_t swz(int p, int k) {
    return (uint32_t)p * RB + (uint32_t)((k ^ swf(p)) << 4);
  }
};

struct alignas(64) S2Args {
  CUtensorMap map_out;      // out [B][H][W][CO]: boxes of 64 co x 16 x TH x 1
  const __nv_bfloat16* x;   // [B,Hi,Wi,C] raw, 16-byte aligned
  const float *a, *c;       // [B,C] the prologue affine
  const __nv_bfloat16* w;   // [9,CO,C], 16-byte aligned
  const float* bias;        // [CO]
  float* part;              // [B,slots,2,CO], slots = gridDim.x · 4
  int B, Hi, Wi, H, W, tiles_x, tiles;
};

// sums[b, s, co] = Σ over the slots of part in double: 8 warps over the
// slots in a fixed stride, then in warp order (as int8_sites.cu's
// stats_reduce_mma).
__global__ void stats_reduce_s2(const float* __restrict__ part, float* __restrict__ sums,
                                int slots, int CO) {
  __shared__ double s_part[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;  // over B·2·CO; CO % 32 == 0
  const int co = i % CO, s = (i / CO) % 2, b = i / (2 * CO);
  double t = 0.0;
#pragma unroll 4
  for (int k = warp; k < slots; k += 8) t += (double)part[(((size_t)b * slots + k) * 2 + s) * CO + co];
  s_part[warp][lane] = t;
  __syncthreads();
  if (warp == 0) {
    double v = 0.0;
    for (int w = 0; w < 8; ++w) v += s_part[w][lane];
    sums[i] = (float)v;
  }
}

constexpr int kS2Group = 4;  // passes of the activation loaded before their stores

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of the B·tiles
// output tiles. Its producer warpgroup brings a tile's raw bf16 input in by
// cp.async, each 16-byte chunk from the pixel the reflect maps it to,
// straight into its swizzled plane slot, and activates in place the chunks
// each thread brought in, once (a tile is read and activated once for all
// CO output channels); it keeps NB - 1 tiles' loads in flight, each fetched
// as soon as the consumers release its buffer. The consumer warpgroup waits
// for a full buffer and runs, a group a tap, MI x C/16 wgmma m64 n(CO) k16:
// A by ldmatrix at the tap's plane shift, B the tap's weights through a
// descriptor. Its epilogue adds the bias in f32 and stages bf16 in the
// tile's buffer, from which one TMA store a 64-channel half writes the tile
// (rows and columns past the image clipped); the buffer is released once
// the store has read it, during the next tile's first group. Each consumer
// thread sums the f32 values of its pixels inside the image over the
// block's run of tiles of one image (a block's tiles go in image order),
// folds them over the 8 lanes of a channel by shuffles when the run ends,
// and writes them to its warp's slot of part (zeros for an image the block
// has no tile of). The named barriers: buffer b full 1 + b, empty 1 + NB +
// b; the consumers alone 1 + 2NB.
template <int C, int CO, int TH, int NB>
__global__ void __launch_bounds__(S2Bf16<C, CO, TH, NB>::THREADS, 1)
    s2_mma_bf16_kernel(const __grid_constant__ S2Args p) {
  using S = S2Bf16<C, CO, TH, NB>;
  constexpr int FULL = 1, EMPTY = 1 + NB, CONS = 1 + 2 * NB;
  constexpr int CH = S::CH, RB = S::RB, TW = S::TW, MI = S::MI, NJ = S::NJ, NT = S::THREADS;
  constexpr int KC = C / 16;  // k16 steps a tap
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // the weights are a wgmma operand under the 128- or 64-byte swizzle, and
  // the staged outputs a TMA source under the 128-byte one: 1024-byte aligned
  uint8_t* smem8 = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_w = smem8;                                              // [9][CO] rows
  uint8_t* s_x0 = smem8 + S::W;                                      // NB plane buffers
  float* s_bias = reinterpret_cast<float*>(smem8 + S::W + NB * S::X);  // [CO]

  const int tid = threadIdx.x;
  const int total = p.B * p.tiles, first = blockIdx.x;
  const int n = (total - first + (int)gridDim.x - 1) / (int)gridDim.x;  // the block's tiles
  if (n <= 0) return;

  if (tid >= S::CTHREADS) {
    // ---- producers ----
    constexpr int PPI = S::PTHREADS / CH;         // pixels a pass
    constexpr int NI = (S::PIX + PPI - 1) / PPI;  // passes
    const int pt = tid - S::CTHREADS, chunk = pt % CH, p0 = pt / CH;
    // pass k's staged offset | hr << 16 | hc << 22, the same for every tile;
    // each use goes through opaque(), so that no field of them is hoisted
    // out of the tile loop into registers of its own
    static_assert(S::X <= 65536 && S::HR <= 64 && S::HC <= 64, "the fields fit");
    uint32_t pk[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      const int px = min(p0 + k * PPI, S::PIX - 1), hr = px / S::HC, hc = px % S::HC;
      pk[k] = S::swz(S::pixel(hr, hc), chunk) | (uint32_t)hr << 16 | (uint32_t)hc << 22;
    }
    // the block's tile j's raw input into its buffer, one commit group
    // (empty past the block's last tile, so that the wait count holds)
    auto fetch = [&](int j) {
      if (j >= n) {
        cp_async_commit();
        return;
      }
      const int id = first + j * (int)gridDim.x;
      uint8_t* dst = s_x0 + (j % NB) * S::X;
      const int b = id / p.tiles, t = id % p.tiles;
      const int iy0 = 2 * (t / p.tiles_x) * TH - 1, ix0 = 2 * (t % p.tiles_x) * TW - 1;
      const __nv_bfloat16* img = p.x + (size_t)b * p.Hi * p.Wi * C + chunk * 8;
      const uint32_t base = smem_addr(dst);
      const bool inner = iy0 >= 0 && ix0 >= 0 && iy0 + S::HR <= p.Hi && ix0 + S::HC <= p.Wi;
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        if (p0 + k * PPI < S::PIX) {
          const uint32_t f = opaque(pk[k]);
          int sy = iy0 + (int)(f >> 16 & 63), sx = ix0 + (int)(f >> 22);
          if (!inner) {
            sy = src_index(sy, p.Hi, 0);
            sx = src_index(sx, p.Wi, 0);
          }
          cp_async16(base + (f & 0xffffu), img + ((size_t)sy * p.Wi + sx) * C);
        }
      }
      cp_async_commit();
    };
    // the weights, once: row (tap, co) of [9][CO][C], swizzled
    for (int i = pt; i < 9 * CO * CH; i += S::PTHREADS)
      cp_async16(smem_addr(s_w) + S::swz(i / CH, i % CH), p.w + (size_t)i * 8);
    for (int i = pt; i < CO; i += S::PTHREADS) s_bias[i] = p.bias[i];
    for (int j = 0; j < NB - 1; ++j) fetch(j);
    int cur_b = -1;
    float qa[8], qc[8];  // the affine of the thread's 8 channels
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const int id = first + j * (int)gridDim.x;
      uint8_t* buf = s_x0 + (j % NB) * S::X;
      const int b = id / p.tiles;
      if (b != cur_b) {
        cur_b = b;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          qa[e] = __ldg(p.a + b * C + chunk * 8 + e);
          qc[e] = __ldg(p.c + b * C + chunk * 8 + e);
        }
      }
      cp_async_wait<NB - 2>();  // the thread's chunks of the tile have landed
      if (j == 0) fence_async_smem();  // the weights, before wgmma reads them
      // the thread's chunks activated in place, kS2Group loads ahead of
      // their stores
#pragma unroll
      for (int k0 = 0; k0 < NI; k0 += kS2Group) {
        uint4 v[kS2Group];
#pragma unroll
        for (int k = k0; k < k0 + kS2Group && k < NI; ++k)
          if (p0 + k * PPI < S::PIX)
            v[k - k0] = *reinterpret_cast<const uint4*>(buf + (opaque(pk[k]) & 0xffffu));
#pragma unroll
        for (int k = k0; k < k0 + kS2Group && k < NI; ++k)
          if (p0 + k * PPI < S::PIX) {
            uint4 u = v[k - k0];
            u.x = activate2(u.x, qa[0], qc[0], qa[1], qc[1]);
            u.y = activate2(u.y, qa[2], qc[2], qa[3], qc[3]);
            u.z = activate2(u.z, qa[4], qc[4], qa[5], qc[5]);
            u.w = activate2(u.w, qa[6], qc[6], qa[7], qc[7]);
            *reinterpret_cast<uint4*>(buf + (opaque(pk[k]) & 0xffffu)) = u;
          }
      }
      bar_arrive(FULL + j % NB, NT);
      // tile j + NB - 1 into tile j - 1's buffer, once its outputs have left it
      if (j >= 1 && j + NB - 1 < n) bar_sync(EMPTY + (j - 1) % NB, NT);
      fetch(j + NB - 1);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers ----
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int arow = lane & 15, akb = lane >> 4;  // A rows: output columns, k half
  // the running [Σ f, Σ f²] of the thread's channels c = 8nj + 2tg, +1 over
  // its pixels of the block's tiles of image cur_b
  float s1[NJ][2], s2[NJ][2];
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj) s1[nj][0] = s1[nj][1] = s2[nj][0] = s2[nj][1] = 0.0f;
  int cur_b = -1;
  const int slot = blockIdx.x * 4 + warp, slots = (int)gridDim.x * 4;
  // image cur_b's sums (folded over the 8 lanes g of a channel) into the
  // warp's slot, zeros for images cur_b + 1 .. upto - 1, and the sums reset
  auto flush = [&](int upto) {
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1[nj][e] = __fadd_rn(s1[nj][e], __shfl_xor_sync(0xffffffffu, s1[nj][e], m));
          s2[nj][e] = __fadd_rn(s2[nj][e], __shfl_xor_sync(0xffffffffu, s2[nj][e], m));
        }
    if (g == 0) {
      for (int bb = max(cur_b, 0); bb < upto; ++bb) {
        const bool run = bb == cur_b;
        float* q = p.part + ((size_t)bb * slots + slot) * 2 * CO + 2 * tg;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            q[nj * 8 + e] = run ? s1[nj][e] : 0.0f;
            q[CO + nj * 8 + e] = run ? s2[nj][e] : 0.0f;
          }
      }
    }
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) s1[nj][0] = s1[nj][1] = s2[nj][0] = s2[nj][1] = 0.0f;
  };

  MMA_PHASE_START
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const int id = first + j * (int)gridDim.x;
    uint8_t* xb = s_x0 + (j % NB) * S::X;
    bar_sync(FULL + j % NB, NT);  // the tile is activated
    MMA_PHASE(0)

    // a group a tap: MI x KC wgmma m64 n(CO) k16, A (warp w's 16 rows of
    // m64 half mi: tile row MI·w + mi) by ldmatrix into the register set
    // the group before last used
    float acc[MI][NJ][4];
    {
      const uint32_t a_base = smem_addr(xb);
      // the lane's A row for each column parity, hidden from the compiler so
      // that the taps' offsets are not hoisted out of the tile loop
      const int lr[2] = {(int)opaque(warp * MI * S::cols(0) + arow),
                         (int)opaque(warp * MI * S::cols(1) + arow)};
      uint32_t afr[2][MI * KC * 4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3, pc = dx & 1;
        const int pp = S::off(dy & 1, pc) + (dy >> 1) * S::cols(pc) + (dx >> 1) + lr[pc];
        uint32_t(&f)[MI * KC * 4] = afr[tap & 1];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int kc = 0; kc < KC; ++kc)
            ldsm_x4(*reinterpret_cast<uint32_t(*)[4]>(&f[4 * (mi * KC + kc)]),
                    a_base + S::swz(pp + mi * S::cols(pc), 2 * kc + akb));
        const uint32_t w_tap = smem_addr(s_w + tap * CO * RB);
        const uint64_t desc = RB == 128 ? desc_kmajor(w_tap) : desc_kmajor64(w_tap);
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            float(&d)[4 * NJ] = *reinterpret_cast<float(*)[4 * NJ]>(&acc[mi][0][0]);
            if constexpr (NJ == 16)
              wgmma_bf16<0>(d, &f[4 * (mi * KC + kc)], desc + 2 * kc, tap | kc);
            else
              wgmma_bf16_n64(d, &f[4 * (mi * KC + kc)], desc + 2 * kc, tap | kc);
          }
        wgmma_commit();
        if (tap == 0 && j > 0) {  // the tile before's outputs have left its buffer
          if (tid == 0) bulk_wait_read<0>();
          __syncwarp();
          if (j - 1 + NB < n) bar_arrive(EMPTY + (j - 1) % NB, NT);
        }
        wgmma_wait<1>();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) fence_acc(*reinterpret_cast<float(*)[4 * NJ]>(&acc[mi][0][0]));
    }
    MMA_PHASE(1)
    bar_sync(CONS, S::CTHREADS);  // every warp is done with the planes: the outputs go there

    // f = acc + bias in f32 for tile rows MI·warp + mi, pixels g and g+8,
    // channels c = 8nj + 2tg, +1: staged as bf16 pairs in the TMA box's
    // layout (a 64-channel half's 128-byte rows, swizzled), and added to the
    // image's running sums
    const int b = id / p.tiles, t = id % p.tiles;
    const int y0 = (t / p.tiles_x) * TH, x0 = (t % p.tiles_x) * TW;
    if (b != cur_b) {
      flush(b);
      cur_b = b;
    }
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int c = nj * 8 + 2 * tg;
      const float2 bi = *reinterpret_cast<const float2*>(s_bias + c);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row = warp * MI + mi;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = g + 8 * h, px = row * TW + col;
          const float f0 = __fadd_rn(acc[mi][nj][2 * h], bi.x);
          const float f1 = __fadd_rn(acc[mi][nj][2 * h + 1], bi.y);
          if (y0 + row < p.H && x0 + col < p.W) {
            s1[nj][0] = __fadd_rn(s1[nj][0], f0);
            s1[nj][1] = __fadd_rn(s1[nj][1], f1);
            s2[nj][0] = __fadd_rn(s2[nj][0], __fmul_rn(f0, f0));
            s2[nj][1] = __fadd_rn(s2[nj][1], __fmul_rn(f1, f1));
          }
          *reinterpret_cast<__nv_bfloat162*>(xb + (nj >> 3) * S::OUTH + swz(px, nj & 7) + 4 * tg) =
              __floats2bfloat162_rn(f0, f1);
        }
      }
    }
    fence_async_smem();
    bar_sync(CONS, S::CTHREADS);
    MMA_PHASE(2)
    if (tid == 0) {
#pragma unroll
      for (int hf = 0; hf < CO / 64; ++hf)
        tma_store_4d(&p.map_out, xb + hf * S::OUTH, 64 * hf, x0, y0, b);
      bulk_commit();
    }
    MMA_PHASE(3)
  }
  if (tid == 0) bulk_wait_read<0>();
  flush(p.B);
  MMA_PHASE(4)
  MMA_PHASE_END
}

// K9c's and K9d's instances
using S2C2 = S2Bf16<32, 64, 8, 4>;
using S2C3 = S2Bf16<64, 128, 4, 2>;
static_assert(S2C2::off(1, 1) + S2C2::rows(1) * S2C2::cols(1) == S2C2::PIX &&
                  S2C3::off(1, 1) + S2C3::rows(1) * S2C3::cols(1) == S2C3::PIX,
              "the planes tile the haloed tile");

template <class S>
int launch_s2_bf16(const __nv_bfloat16* x, const float* a, const float* c,
                   const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out, float* part,
                   float* sums, int B, int Hi, int Wi, void* stream) {
  if (B <= 0 || Hi < 2 || Wi < 2 || Hi % 2 || Wi % 2) return (int)cudaErrorInvalidValue;
  S2Args p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.bias = bias; p.part = part;
  p.B = B; p.Hi = Hi; p.Wi = Wi; p.H = Hi / 2; p.W = Wi / 2;
  const int dout[4] = {S::OC, p.W, p.H, B}, bout[4] = {64, S::TW, S::TROWS, 1};
  if (!make_map(&p.map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, 4, dout, bout))
    return (int)cudaErrorInvalidValue;
  p.tiles_x = (p.W + S::TW - 1) / S::TW;
  p.tiles = (p.H + S::TROWS - 1) / S::TROWS * p.tiles_x;
  auto kern = s2_mma_bf16_kernel<S::IC, S::OC, S::TROWS, S::NBUF>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const long long total = (long long)B * p.tiles;
  const int blocks = (int)(total < sms ? total : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<blocks, S::THREADS, S::bytes, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stats_reduce_s2<<<B * 2 * S::OC / 32, 256, 0, s>>>(part, sums, blocks * 4, S::OC);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// d3rows_wgmma_kernel: K9e on Hopper's warpgroup MMAs
// ---------------------------------------------------------------------------

// The block: one producer and one consumer warpgroup. An item is one conv
// row of one image (row R + 2 of the H + 4 rows of the reflect-padded block
// grid) over a segment of 64 output columns x0 .. x0 + 63; its raw input is
// block row R's 68 pixels x0 - 2 .. x0 + 65 of the padded grid, 128 bf16
// channels (4 phases x 32) a pixel. A tap is D[64 lanes][64 pixels] =
// W[lanes][128 channels] x X[channels][pixels]: the weights are the wgmma's
// A, held in the consumer's registers for the block's life (5 taps x 8 k16
// steps x 4 words a thread); the pixels are its B, read through a
// descriptor from the staged row in the no-swizzle K-major layout (16-byte
// chunk k of staged pixel j at k·CK + 16j: a core matrix is 8 consecutive
// pixels of one chunk, 128 contiguous bytes), so a tap's one-pixel shift is
// 16 bytes of the descriptor's start address. Shared memory: alignment
// slack, NB input buffers, two output buffers of an item's 64 x 60 bf16
// lanes (the 7,680 contiguous bytes of the output it writes), and for the
// f32 form (F32IN) NB staging slots of an item's f32 raw row:
//   128 + 4 x 17,408 + 2 x 7,680 = 85,120; F32IN + 4 x 34,816 = 224,384
struct D3RowsW {
  static constexpr int SEG = 64, PIX = SEG + 4, NB = 4, NOUT = 2;
  static constexpr int CTHREADS = 128, PTHREADS = 128, THREADS = CTHREADS + PTHREADS;
  static constexpr int CK = PIX * 16;          // one chunk column: 1,088 bytes
  static constexpr int X = 16 * CK;            // an item's staged row: 17,408
  static constexpr int OUT = SEG * kLanes * 2;
  static constexpr int XF = PIX * kRC * 4;     // an item's f32 raw row: 34,816
  static constexpr size_t bytes = 128 + NB * X + NOUT * OUT;
  static constexpr size_t bytes_f32 = bytes + NB * XF;
  static_assert(bytes_f32 <= 232448 && 1 + 2 * NB < 16, "shared memory; named barriers");
};

// wgmma descriptor of a K-major operand in the no-swizzle layout: core
// matrices (8 rows x 16 bytes, contiguous) `lbo` bytes apart along K and
// `sbo` bytes apart along M/N
__device__ __forceinline__ uint64_t desc_noswz(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// A persistent block walks items blockIdx.x, + gridDim.x, ... of the
// B·(H+4)·segs items (segments fastest, then conv rows, then images). Its
// producer warpgroup brings an item's raw row in by cp.async, 32 bytes (one
// phase's 16 channels) of a pixel a thread and pass, each from the block
// row, column and phases that the 4-pixel reflect maps it to (the row's map
// once an item, the columns' only in a segment that reaches the halo), up
// to NB - 1 items ahead, and activates in place the chunks each thread
// brought in, once, with the affine of the chunk's (padded-grid) channels.
// The consumer warpgroup waits for a full buffer, issues the item's 40
// wgmma m64n64k16 as one group and, while they run, the item before's
// store; once they are done it releases the buffer, rounds the f32 sums to
// bf16 and stages lanes 0..59 in an output buffer. On an even W one bulk
// copy writes them (the item's outputs are contiguous and 16-byte aligned),
// on an odd W the consumers copy them 8 bytes a lane. Named barriers:
// buffer b full 1 + b, empty 1 + NB + b; the consumers alone 1 + 2NB.
//
// With -DMMA_PHASE_CLOCKS (consumer thread 0): 0 the wait for the item's
// activated input, 1 the wgmma group and the item before's store issued, 2
// the MMAs' drain, 3 the staging of the bf16 lanes, 4 the last item's store
// (once).
// F32IN (K9e under float32: the d2 raw in f32, which the Pallas prologue
// reads unrounded): the f32 raw cannot land in the bf16 row as it is, so
// each producer thread copies its 16 f32 channels of a pixel (four 16-byte
// cp.async) into the item's f32 staging slot, at its own place (thread kp's
// pixels in a 64-byte column), and the activation reads them from there,
// rounds once, bf16(max(x·a + c, 0)), and writes the bf16 row the MMAs
// read; the rest is the bf16 form's.
template <bool F32IN>
__global__ void __launch_bounds__(D3RowsW::THREADS, 1)
    d3rows_wgmma_kernel(RowsArgs p, int segs, int items) {
  using S = D3RowsW;
  constexpr int NB = S::NB, FULL = 1, EMPTY = 1 + NB, CONS = 1 + 2 * NB, NT = S::THREADS;
  constexpr int CK = S::CK;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem8 = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  uint8_t* s_x0 = smem8;
  uint8_t* s_o0 = s_x0 + NB * S::X;
  uint8_t* s_f0 = s_o0 + S::NOUT * S::OUT;  // F32IN: [NB][8 kp][PIX][16] f32
  const int tid = threadIdx.x, first = blockIdx.x, rows = p.H + 4;
  const int n = (items - first + (int)gridDim.x - 1) / (int)gridDim.x;
  if (n <= 0) return;

  if (tid >= S::CTHREADS) {
    // ---- producers: thread (kp, jl) takes chunks 2kp, 2kp + 1 (channels
    // 16kp .. 16kp + 15, one phase) of staged pixels jl, jl + 16, ...
    constexpr int NI = (S::PIX + 15) / 16;
    const int pt = tid - S::CTHREADS, kp = pt >> 4, jl = pt & 15;
    const int u = kp >> 2, v = (kp >> 1) & 1;
    auto fetch = [&](int j) {
      if (j >= n) {
        cp_async_commit();
        return;
      }
      const int id = first + j * (int)gridDim.x;
      const int x0 = (id % segs) * S::SEG, rr = id / segs, b = rr / rows;
      int uu;
      const int sy = reflect_phase(rr % rows - 2, u, p.H, &uu);
      const size_t src = ((size_t)b * p.H + sy) * p.W * kRC + uu * 64 + 16 * (kp & 1);
      const uint32_t base = smem_addr(s_x0 + (j % NB) * S::X) + 2 * kp * CK;
      const uint32_t fbase = smem_addr(s_f0 + (j % NB) * S::XF) + kp * S::PIX * 64;
      const bool inner = x0 >= 2 && x0 + S::PIX - 2 <= p.W;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int px = jl + 16 * i;
        if (px < S::PIX) {
          int sx = x0 - 2 + px, vv = v;
          if (!inner) sx = reflect_phase(sx, v, p.W, &vv);
          const size_t s0 = src + (size_t)sx * kRC + vv * 32;
          if (F32IN) {
#pragma unroll
            for (int e = 0; e < 4; ++e) cp_async16(fbase + px * 64 + 16 * e, p.x32 + s0 + 4 * e);
          } else {
            cp_async16(base + px * 16, p.x + s0);
            cp_async16(base + CK + px * 16, p.x + s0 + 8);
          }
        }
      }
      cp_async_commit();
    };
    for (int j = 0; j < NB - 1; ++j) fetch(j);
    int cur_b = -1;
    float qa[16], qc[16];
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const int id = first + j * (int)gridDim.x;
      uint8_t* buf = s_x0 + (j % NB) * S::X + 2 * kp * CK;
      const float* fbuf = reinterpret_cast<const float*>(s_f0 + (j % NB) * S::XF +
                                                         kp * S::PIX * 64);
      const int b = id / segs / rows;
      if (b != cur_b) {
        cur_b = b;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          qa[e] = __ldg(p.a + b * kRC + 16 * kp + e);
          qc[e] = __ldg(p.c + b * kRC + 16 * kp + e);
        }
      }
      cp_async_wait<NB - 2>();
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int px = jl + 16 * i;
        if (px < S::PIX) {
          uint4* q0 = reinterpret_cast<uint4*>(buf + px * 16);
          uint4* q1 = reinterpret_cast<uint4*>(buf + CK + px * 16);
          if (F32IN) {
            const float4* f4 = reinterpret_cast<const float4*>(fbuf + 16 * px);
            uint32_t o[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 f = f4[e];
              o[2 * e] = activate2f(f.x, f.y, qa[4 * e], qc[4 * e], qa[4 * e + 1], qc[4 * e + 1]);
              o[2 * e + 1] =
                  activate2f(f.z, f.w, qa[4 * e + 2], qc[4 * e + 2], qa[4 * e + 3], qc[4 * e + 3]);
            }
            *q0 = make_uint4(o[0], o[1], o[2], o[3]);
            *q1 = make_uint4(o[4], o[5], o[6], o[7]);
            continue;
          }
          uint4 w0 = *q0, w1 = *q1;
          w0.x = activate2(w0.x, qa[0], qc[0], qa[1], qc[1]);
          w0.y = activate2(w0.y, qa[2], qc[2], qa[3], qc[3]);
          w0.z = activate2(w0.z, qa[4], qc[4], qa[5], qc[5]);
          w0.w = activate2(w0.w, qa[6], qc[6], qa[7], qc[7]);
          w1.x = activate2(w1.x, qa[8], qc[8], qa[9], qc[9]);
          w1.y = activate2(w1.y, qa[10], qc[10], qa[11], qc[11]);
          w1.z = activate2(w1.z, qa[12], qc[12], qa[13], qc[13]);
          w1.w = activate2(w1.w, qa[14], qc[14], qa[15], qc[15]);
          *q0 = w0;
          *q1 = w1;
        }
      }
      fence_async_smem();  // the activated row, before wgmma reads it
      bar_arrive(FULL + j % NB, NT);
      if (j >= 1 && j + NB - 1 < n) bar_sync(EMPTY + (j - 1) % NB, NT);
      fetch(j + NB - 1);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers ----
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const bool bulk = (p.W & 1) == 0;
  // A: the weights of warp rows 16·warp + g (+8), k 2tg (+8) of each tap's k16 steps
  uint32_t wa[5][8][4];
  {
    const uint32_t* wg = reinterpret_cast<const uint32_t*>(p.w);
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        const uint32_t* w0 = wg + (dx * kCOT + r0) * (kRC / 2) + kc * 8 + tg;
        wa[dx][kc][0] = __ldg(w0);
        wa[dx][kc][1] = __ldg(w0 + 8 * (kRC / 2));
        wa[dx][kc][2] = __ldg(w0 + 4);
        wa[dx][kc][3] = __ldg(w0 + 8 * (kRC / 2) + 4);
      }
  }
  const uint64_t desc0 = desc_noswz(smem_addr(s_x0), CK, 128);
  // item j's outputs, staged in output buffer j % 2, into out: one bulk
  // copy (thread 0; an even W) or 8 bytes a lane and pass (an odd W, where
  // a row's start is 8-byte aligned)
  auto store = [&](int j) {
    const int id = first + j * (int)gridDim.x;
    const int x0 = (id % segs) * S::SEG, nv = min(S::SEG, p.W - x0);
    __nv_bfloat16* dst = p.out + ((size_t)(id / segs) * p.W + x0) * kLanes;
    const uint8_t* so = s_o0 + (j % S::NOUT) * S::OUT;
    if (bulk) {
      if (tid == 0) {
        bulk_store(dst, so, (uint32_t)(nv * kLanes * 2));
        bulk_commit();
        bulk_wait_read<S::NOUT - 1>();  // the store before has read its buffer
      }
    } else {
      for (int c = tid; c < nv * kLanes / 4; c += S::CTHREADS)
        reinterpret_cast<uint2*>(dst)[c] = reinterpret_cast<const uint2*>(so)[c];
    }
  };
  MMA_PHASE_START
  float acc[32];
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    bar_sync(FULL + j % NB, NT);
    MMA_PHASE(0)
    const uint64_t d = desc0 + (uint64_t)((j % NB) * (S::X >> 4));
    wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
#pragma unroll
      for (int kc = 0; kc < 8; ++kc)
        wgmma_bf16_n64(acc, wa[dx][kc], d + (2 * kc * CK + 16 * dx) / 16, dx | kc);
    wgmma_commit();
    // the item before's store, issued while the MMAs run
    if (j > 0) store(j - 1);
    MMA_PHASE(1)
    wgmma_wait<0>();
    fence_acc(acc);
    if (j + NB < n) bar_arrive(EMPTY + j % NB, NT);  // wgmma has read the row
    MMA_PHASE(2)
    bar_sync(CONS, S::CTHREADS);  // output buffer j % 2's store two items back has read it
    // bf16(acc) of lanes 16·warp + g (+8) below 60, pixels 8nj + 2tg (+1)
    __nv_bfloat16* sb = reinterpret_cast<__nv_bfloat16*>(s_o0 + (j % S::NOUT) * S::OUT);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 16 * warp + g + 8 * h;
      if (l < kLanes) {
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sb[(8 * nj + 2 * tg + e) * kLanes + l] = __float2bfloat16_rn(acc[4 * nj + 2 * h + e]);
      }
    }
    if (bulk) fence_async_smem();
    bar_sync(CONS, S::CTHREADS);
    MMA_PHASE(3)
  }
  store(n - 1);
  if (tid == 0) bulk_wait_all();
  MMA_PHASE(4)
  MMA_PHASE_END
}

template <bool F32IN = false>
int launch_d3rows_wgmma(const RowsArgs& p, void* stream) {
  using S = D3RowsW;
  if (p.B <= 0 || p.H < 3 || p.W < 3) return (int)cudaErrorInvalidValue;
  const int segs = (p.W + S::SEG - 1) / S::SEG;
  const long long items = (long long)p.B * (p.H + 4) * segs;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kern = d3rows_wgmma_kernel<F32IN>;
  const size_t smem = F32IN ? S::bytes_f32 : S::bytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int blocks = (int)(items < sms ? items : sms);
  kern<<<blocks, S::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, segs, (int)items);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// c1_wgmma_kernel: K11 on Hopper's warpgroup MMAs
// ---------------------------------------------------------------------------

// A tile is 64 output pixels x0 .. x0 + 63 of one output row y of one image,
// on all 128 output channels: D[64 px][128 co] = Σ_dy A_dy[64 px][64 k] ·
// B_dy[64 k][128 co], 5 kernel rows x 4 wgmma m64n128k16. A_dy's row for
// pixel x is the 60 contiguous bf16 values of input row y + dy from pixel
// x on (the five dx taps x 12 channels; k 60..63 meet zero weights), and
// pixel x's row starts at byte 24x of the staged row: 8-byte aligned only,
// which no ldmatrix or descriptor core matrix reads. So A comes from
// registers, each thread's fragment by 64-bit shared loads: the k order
// inside a kernel row is permuted (logical k word L = 8kc + 4h + t of k16
// step kc, fragment half h, lane t reads physical word P = 8t + 2kc + h of
// the pixel's row), so that a lane's a0/a2 (and a1/a3) words are adjacent,
// and the weights B are staged in that permuted k order. Warp w's lanes
// (g, t) read pixel 16w + g (+8) at word 6p + 8t + 2kc: bank pair 3g + 4t +
// kc mod 16, distinct over each half-warp. The weights (the five kernel
// rows, [128 co][64 k] bf16 each, K-major under the 128-byte swizzle) stay
// resident for the block's life. Two consumer warpgroups take alternate
// tiles, each with its own accumulators, so that one's epilogue runs
// beside the other's MMAs. NB tiles are in flight, and before them the
// other warpgroup's unfinished tile: 5 input rows each. Shared memory (one
// block an SM):
//   1,024 slack + 5 x 16,384 weights + 4 x 16,384 staged outputs
//   + 30 x 1,664 input rows + 512 bias = 198,912
struct C1W {
  static constexpr int SEG = 64, NB = 4, NC = 2;
  static constexpr int ROWS = 5 * (NB + NC);
  static constexpr int ROW = 1664;            // a staged input row: 68 pixels x 24 bytes + zeros
  static constexpr int WDY = kC1Out * 128;    // a kernel row's weights [128 co][64 k] bf16
  static constexpr int OUT = SEG * kC1Out * 2;
  static constexpr int CTHREADS = 128 * NC, PTHREADS = 128, THREADS = CTHREADS + PTHREADS;
  static constexpr size_t bytes = 1024 + 5 * WDY + 2 * NC * OUT + ROWS * ROW + 4 * kC1Out;
  static_assert(bytes <= 232448 && 2 * NB + NC < 15 && NB % NC == 0,
                "shared memory; named barriers; a tile slot's barriers serve one warpgroup");
  static_assert(ROW >= 24 * (SEG - 1) + 4 * 32 && ROW % 16 == 0, "the last pixel's window fits");
};

struct alignas(64) C1WArgs {
  CUtensorMap map_out;      // out [B][H][W][128]: boxes of 64 co x 64 px x 1 x 1
  const __nv_bfloat16* x;   // y12 [B][H+4][W+4][12], 16-byte aligned
  const __nv_bfloat16* w;   // [5][5][12][128] (HWIO)
  const float* bias;        // [128]
  int H, W, segs;           // the output grid; segs = ceil(W / 64)
  int tiles;                // B · segs · H
};

// cp.async of `bytes` (0..16, or 0..8) of `src` into 16 (8) bytes at dst,
// the rest zero-filled
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// four 8x8 b16 matrices to shared memory, lane l giving the address of row
// l % 8 of matrix l / 8 and, in register i, its fragment of matrix i (row
// l / 4, columns 2(l % 4), +1: an MMA accumulator's layout)
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// The physical element (dx · 12 + channel) of a kernel row's packed 64 k
// that logical k (the wgmma's k) stands for, or -1 (a zero weight).
__device__ __forceinline__ int c1_k_source(int k) {
  const int L = k >> 1, kc = L >> 3, h = (L >> 2) & 1, t = L & 3;
  const int q = 2 * (8 * t + 2 * kc + h) + (k & 1);
  return q < 5 * kC1In ? q : -1;
}

// A tile's place, stepped through a block's run: output row y of the
// 64-column segment seg of image b; `fresh` at the start of the run or of
// a strip (all five input rows new), and ld the load index of its last row
struct C1Tile {
  int y, seg, b, ld;
  bool fresh;
  __device__ void start(int t, int H, int segs) {
    const int s = t / H;
    y = t - s * H;
    b = s / segs;
    seg = s - b * segs;
    ld = 4;
    fresh = true;
  }
  __device__ void next(int H, int segs) {
    fresh = ++y == H;
    if (fresh) {
      y = 0;
      if (++seg == segs) {
        seg = 0;
        ++b;
      }
    }
    ld += fresh ? 5 : 1;
  }
};

// A persistent block takes a contiguous run of the B·segs·H tiles, numbered
// output rows fastest, then 64-column segments, then images: it walks
// column strips down the image, so that each tile needs one new input row
// (five at the start of a run or a strip). Its producer warpgroup lands the
// rows by cp.async (16-byte pieces, 8-byte ones where W + 4 is odd and rows
// are 8-byte aligned only; past the image's right edge zero-filled) into a
// ring of ROWS row slots, a tile's rows one commit group, up to NB - 1
// tiles ahead; tile j reads the 5 rows landed last, and a tile's slot is
// refilled once the tile before it is done, when the other warpgroup's
// tile before that may still run. Consumer warpgroup c takes the run's
// tiles j ≡ c (mod 2): a group of 4 wgmma a kernel row, its A fragments
// loaded while the row before's group runs (two register sets); during the
// first group, the two TMA stores of the warpgroup's tile before (a
// 64-channel half each, clipped at the image's right edge); then bf16(acc +
// bias) staged by stmatrix under the 128-byte swizzle in one of its two
// output buffers. Named barriers: tile slot s full 1 + s, empty 1 + NB + s
// (the producers and one consumer warpgroup: NB is even, so a slot's tiles
// are one warpgroup's); consumer warpgroup c alone 1 + 2NB + c; the
// consumers together 15, once.
//
// With -DMMA_PHASE_CLOCKS (consumer thread 0): 0 the wait for the tile's
// input rows, 1 the A loads and the wgmma groups (their drain and the tile
// before's store issue included), 2 the wait for the output buffer (the
// warpgroup's store two tiles back has read it), 3 the epilogue's staging,
// 4 the other warpgroup's tile skipped and the next tile's place.
__global__ void __launch_bounds__(C1W::THREADS, 1) c1_wgmma_kernel(const __grid_constant__ C1WArgs p) {
  using S = C1W;
  constexpr int NB = S::NB, NC = S::NC, FULL = 1, EMPTY = 1 + NB, CONS = 1 + 2 * NB, NT = 256;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem8 = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* s_w = smem8;                          // [5][128 co] rows of 128 bytes, swizzled
  uint8_t* s_o = s_w + 5 * S::WDY;               // 2NC x [2 halves][64 px] rows of 128 bytes
  uint8_t* s_x = s_o + 2 * NC * S::OUT;          // [ROWS] input rows
  float* s_bias = reinterpret_cast<float*>(s_x + S::ROWS * S::ROW);
  const int tid = threadIdx.x;
  const int t0 = (int)((long long)blockIdx.x * p.tiles / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * p.tiles / gridDim.x) - t0;
  if (n <= 0) return;

  if (tid >= S::CTHREADS) {
    // ---- producers ----
    const int pt = tid - S::CTHREADS;
    const int rowb = (p.W + 4) * kC1In * 2;      // bytes of an input row
    const bool a16 = (rowb & 15) == 0;
    const uint32_t rows0 = smem_addr(s_x);
    C1Tile tl;
    tl.start(t0, p.H, p.segs);
    // the rows tile j needs (tl is at tile j), one commit group (empty past
    // the block's last tile, so that the wait count holds)
    auto fetch = [&](int j) {
      if (j < n) {
        if (j > 0) tl.next(p.H, p.segs);
        const int x0 = tl.seg * S::SEG;
        const int avail = min(S::SEG + 4, p.W + 4 - x0) * kC1In * 2;
        for (int dy = tl.fresh ? 0 : 4; dy < 5; ++dy) {
          const uint8_t* src = reinterpret_cast<const uint8_t*>(p.x) +
                               ((size_t)tl.b * (p.H + 4) + tl.y + dy) * rowb +
                               (size_t)x0 * kC1In * 2;
          const uint32_t dst = rows0 + ((tl.ld - 4 + dy) % S::ROWS) * S::ROW;
          if (a16) {
            for (int i = pt; i < S::ROW / 16; i += S::PTHREADS) {
              const int nb = min(max(avail - 16 * i, 0), 16);
              cp_async16_zfill(dst + 16 * i, nb ? src + 16 * i : src, nb);
            }
          } else {
            for (int i = pt; i < S::ROW / 8; i += S::PTHREADS) {
              const int nb = min(max(avail - 8 * i, 0), 8);
              cp_async8_zfill(dst + 8 * i, nb ? src + 8 * i : src, nb);
            }
          }
        }
      }
      cp_async_commit();
    };
    for (int j = 0; j < NB - 1; ++j) fetch(j);
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      cp_async_wait<NB - 2>();  // the thread's pieces of tile j's rows have landed
      bar_arrive(FULL + j % NB, NT);
      if (j >= 1 && j + NB - 1 < n) bar_sync(EMPTY + (j - 1) % NB, NT);
      fetch(j + NB - 1);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers: warpgroup wg takes the block's tiles j = wg, wg + NC, ...
  const int wg = tid >> 7, ct = tid & 127;
  const int warp = ct >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  // the weights, once: chunk c (logical k 8c .. 8c + 7) of row co of kernel
  // row dy, co fastest so that the global reads coalesce
  for (int i = tid; i < 5 * 8 * kC1Out; i += S::CTHREADS) {
    const int co = i % kC1Out, c = (i / kC1Out) % 8, dy = i / (8 * kC1Out);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q0 = c1_k_source(8 * c + 2 * e), q1 = c1_k_source(8 * c + 2 * e + 1);
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      const __nv_bfloat16 w0 =
          q0 < 0 ? zero : p.w[((dy * 5 + q0 / kC1In) * kC1In + q0 % kC1In) * kC1Out + co];
      const __nv_bfloat16 w1 =
          q1 < 0 ? zero : p.w[((dy * 5 + q1 / kC1In) * kC1In + q1 % kC1In) * kC1Out + co];
      v[e] = (uint32_t)__bfloat16_as_ushort(w0) | (uint32_t)__bfloat16_as_ushort(w1) << 16;
    }
    *reinterpret_cast<uint4*>(s_w + dy * S::WDY + swz(co, c)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = tid; i < kC1Out; i += S::CTHREADS) s_bias[i] = p.bias[i];
  fence_async_smem();  // the weights, before wgmma reads them
  bar_sync(15, S::CTHREADS);

  const uint32_t rows0 = smem_addr(s_x);
  const uint32_t lane_off = 24 * (16 * warp + g) + 32 * tg;  // pixel 16w + g, word 8tg
  // A fragments of kernel row dy, k16 steps 0..3, from row slot `slot`:
  // pixel p0 = 16w + g (a0, a2) and p0 + 8 (a1, a3)
  auto load_a = [&](uint32_t (&f)[16], int slot) {
    const uint32_t a = rows0 + slot * S::ROW + lane_off;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint2 v0 = lds64(a + 8 * kc), v1 = lds64(a + 24 * 8 + 8 * kc);
      f[4 * kc + 0] = v0.x;
      f[4 * kc + 1] = v1.x;
      f[4 * kc + 2] = v0.y;
      f[4 * kc + 3] = v1.y;
    }
  };
  const uint64_t desc_w = desc_kmajor(smem_addr(s_w));
  // the stmatrix lane's row: matrices (nj, pixels +0), (nj, +8), (nj + 1,
  // +0), (nj + 1, +8); lane l addresses row l % 8 of matrix l / 8
  const int smi = lane >> 3, spx = 16 * warp + 8 * (smi & 1) + (lane & 7);
  // the warpgroup's tile before, stored during this tile's first group
  int pend_x0 = -1, pend_y = 0, pend_b = 0;
  uint8_t* pend_so = s_o;
  auto store = [&]() {
    if (ct == 0 && pend_x0 >= 0) {
      tma_store_4d(&p.map_out, pend_so, 0, pend_x0, pend_y, pend_b);
      tma_store_4d(&p.map_out, pend_so + S::OUT / 2, 64, pend_x0, pend_y, pend_b);
      bulk_commit();
    }
  };
  C1Tile tl;
  tl.start(t0, p.H, p.segs);
  float acc[64];
  MMA_PHASE_START
#pragma unroll 1
  for (int j = wg; j < n; j += NC) {
    if (j > 0) tl.next(p.H, p.segs);
    if (j > wg) tl.next(p.H, p.segs);  // the other warpgroup's tile
    MMA_PHASE(4)
    bar_sync(FULL + j % NB, NT);
    MMA_PHASE(0)
    uint32_t f[2][16];
    load_a(f[0], (tl.ld - 4) % S::ROWS);
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_bf16<0>(acc, &f[dy & 1][4 * kc], desc_w + (uint64_t)((dy * S::WDY + 32 * kc) >> 4),
                      dy | kc);
      wgmma_commit();
      if (dy == 0) store();
      wgmma_wait<1>();  // the group before has read its register set
      if (dy < 4) load_a(f[(dy + 1) & 1], (tl.ld - 3 + dy) % S::ROWS);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (j + NB < n) bar_arrive(EMPTY + j % NB, NT);  // the tile's rows are read
    MMA_PHASE(1)
    uint8_t* so = s_o + (2 * wg + (j / NC & 1)) * S::OUT;
    if (ct == 0) bulk_wait_read<1>();  // the warpgroup's store two tiles back has read it
    bar_sync(CONS + wg, 128);
    MMA_PHASE(2)
    // bf16(acc + bias) of pixels 16w + g (+8), channels 8nj + 2tg (+1):
    // half nj / 8, 16-byte chunk nj % 8 of the pixel's 128-byte row
    const uint32_t so_a = smem_addr(so);
#pragma unroll
    for (int nj = 0; nj < 16; nj += 2) {
      const float2 b0 = *reinterpret_cast<const float2*>(s_bias + 8 * nj + 2 * tg);
      const float2 b1 = *reinterpret_cast<const float2*>(s_bias + 8 * nj + 8 + 2 * tg);
      const int ch = nj + (smi >> 1);
      stsm_x4(so_a + (ch >> 3) * (S::OUT / 2) + swz(spx, ch & 7),
              pack_bf16(__fadd_rn(acc[4 * nj], b0.x), __fadd_rn(acc[4 * nj + 1], b0.y)),
              pack_bf16(__fadd_rn(acc[4 * nj + 2], b0.x), __fadd_rn(acc[4 * nj + 3], b0.y)),
              pack_bf16(__fadd_rn(acc[4 * nj + 4], b1.x), __fadd_rn(acc[4 * nj + 5], b1.y)),
              pack_bf16(__fadd_rn(acc[4 * nj + 6], b1.x), __fadd_rn(acc[4 * nj + 7], b1.y)));
    }
    fence_async_smem();
    bar_sync(CONS + wg, 128);
    MMA_PHASE(3)
    pend_so = so;
    pend_x0 = tl.seg * S::SEG;
    pend_y = tl.y;
    pend_b = tl.b;
  }
  store();
  if (ct == 0) bulk_wait_all();
  MMA_PHASE_END
}

int launch_c1_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                    __nv_bfloat16* out, int B, int H, int W, void* stream) {
  using S = C1W;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  C1WArgs p = {};
  p.x = x; p.w = w; p.bias = bias;
  p.H = H; p.W = W;
  p.segs = (W + S::SEG - 1) / S::SEG;
  const long long tiles = (long long)B * p.segs * H;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int dout[4] = {kC1Out, W, H, B}, bout[4] = {64, S::SEG, 1, 1};
  if (!make_map(&p.map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, 4, dout, bout))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(c1_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  c1_wgmma_kernel<<<blocks, S::THREADS, S::bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a device
// pointer to a contiguous array as the comments of SiteArgs / RowsArgs
// describe; each launches on `stream` and returns a CUDA error code (0 on
// success). part is scratch [B, tiles, 2, CO] with tiles = ceil(H/8) *
// ceil(W/32) of the output grid at stride 1 and ceil(H/8) * ceil(W/16) at
// stride 2 (the site_kernel_bf16 forms; the others say theirs); sums is
// [B,2,CO].

// K9a: deconv2 in its phase form, x [B,H,W,64] → out [B,H,W,128], edge halo;
// on d2_wgmma_kernel (x, w and out 16-byte aligned; part [B, ceil(H/4)·
// ceil(W/32), 2, 128]).
extern "C" int d2_site_launch(const __nv_bfloat16* x, const float* a, const float* c,
                              const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out,
                              float* part, float* sums, int B, int H, int W, void* stream) {
  return launch_d2_wgmma<false>(x, a, c, w, bias, out, part, sums, B, H, W, stream);
}

// K9a with an f32 x (float32: deconv1's f32 raw, read unrounded; 16-byte
// aligned), its other arguments as d2_site_launch's.
extern "C" int d2_site_f32_launch(const float* x, const float* a, const float* c,
                                  const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out,
                                  float* part, float* sums, int B, int H, int W, void* stream) {
  return launch_d2_wgmma<true>(x, a, c, w, bias, out, part, sums, B, H, W, stream);
}

// K9a on its previous core (site_kernel_bf16<64, 1>: 8 x 32 tiles on 64
// channels), for timing only.
extern "C" int d2_site_prev_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const __nv_bfloat16* w, const float* bias,
                                   __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                   int W, void* stream) {
  return launch_site<64, 1>(site_args(x, a, c, w, bias, out, part, B, H, W, 128, 1), sums,
                            stream);
}

// Dynamic shared memory of K9a's block (d2_wgmma_kernel).
extern "C" int d2_wgmma_smem_bytes() { return (int)kDSmem; }

// K9c: conv2, x [B,H,W,32] (H, W even) → out [B,H/2,W/2,64], reflect halo;
// on s2_mma_bf16_kernel (x and w 16-byte aligned, 8 x 16 output tiles; part
// [B, 4·min(SMs, B·ceil(H/16)·ceil(W/32)), 2, 64]: a block's consumer warps'
// partials).
extern "C" int c2_site_bf16_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const __nv_bfloat16* w, const float* bias,
                                   __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                   int W, void* stream) {
  return launch_s2_bf16<S2C2>(x, a, c, w, bias, out, part, sums, B, H, W, stream);
}

// K9d: conv3, x [B,H,W,64] (H, W even) → out [B,H/2,W/2,128], reflect halo;
// on s2_mma_bf16_kernel (x and w 16-byte aligned, 4 x 16 output tiles; part
// [B, 4·min(SMs, B·ceil(H/8)·ceil(W/32)), 2, 128]).
extern "C" int c3_site_bf16_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const __nv_bfloat16* w, const float* bias,
                                   __nv_bfloat16* out, float* part, float* sums, int B, int H,
                                   int W, void* stream) {
  return launch_s2_bf16<S2C3>(x, a, c, w, bias, out, part, sums, B, H, W, stream);
}

// K9c and K9d on their previous core (site_kernel_bf16<C, 2>: 8 x 16 tiles
// on 64 output channels, part [B, ceil(H/16)·ceil(W/32), 2, CO]), for timing.
extern "C" int c2_site_bf16_prev_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                        const __nv_bfloat16* w, const float* bias,
                                        __nv_bfloat16* out, float* part, float* sums, int B,
                                        int H, int W, void* stream) {
  return launch_site<32, 2>(site_args(x, a, c, w, bias, out, part, B, H, W, 64, 0), sums,
                            stream);
}

extern "C" int c3_site_bf16_prev_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                        const __nv_bfloat16* w, const float* bias,
                                        __nv_bfloat16* out, float* part, float* sums, int B,
                                        int H, int W, void* stream) {
  return launch_site<64, 2>(site_args(x, a, c, w, bias, out, part, B, H, W, 128, 0), sums,
                            stream);
}

// Dynamic shared memory of K9c's (C = 32) or K9d's (C = 64) block
// (s2_mma_bf16_kernel); 0 for another C.
extern "C" int s2_bf16_smem_bytes(int C) {
  return C == 32 ? (int)S2C2::bytes : C == 64 ? (int)S2C3::bytes : 0;
}

// K9e: rows out[b, R+2, x, l] = bf16(1x5 conv of the activated, reflect-padded
// x at block row R in [-2, H+2)), l < 60; on d3rows_wgmma_kernel (x and w
// 16-byte aligned).
extern "C" int d3_rows_launch(const __nv_bfloat16* x, const float* a, const float* c,
                              const __nv_bfloat16* w, __nv_bfloat16* out, int B, int H, int W,
                              void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_d3rows_wgmma<false>(p, stream);
}

// K9e with the raw x in f32 (float32: the d2 raw, read unrounded; 16-byte
// aligned), its other arguments as d3_rows_launch's.
extern "C" int d3_rows_f32_launch(const float* x, const float* a, const float* c,
                                  const __nv_bfloat16* w, __nv_bfloat16* out, int B, int H, int W,
                                  void* stream) {
  RowsArgs p = {};
  p.x32 = x; p.a = a; p.c = c; p.w = w; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_d3rows_wgmma<true>(p, stream);
}

// K9e on its previous core (rows_kernel_bf16<false>), for timing only.
extern "C" int d3_rows_prev_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                   const __nv_bfloat16* w, __nv_bfloat16* out, int B, int H,
                                   int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<false>(p, stream);
}

// Dynamic shared memory of K9e's block (d3rows_wgmma_kernel).
extern "C" int d3_rows_smem_bytes() { return (int)D3RowsW::bytes; }
// ... and of its f32 form's.
extern "C" int d3_rows_f32_smem_bytes() { return (int)D3RowsW::bytes_f32; }

// K9b: out[b,y,x,o] = bf16(Σ_dy rows[y+dy][12*dy+o] + bias[o]) over the same
// rows (x 16-byte aligned); on the bf16 tensor cores (d3sum_mma_kernel).
extern "C" int d3_sum_site_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                  const __nv_bfloat16* w, const float* bias,
                                  __nv_bfloat16* out, int B, int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_d3sum_mma(p, stream);
}

// K9b on its previous core (rows_kernel_bf16<true>), for timing only.
extern "C" int d3_sum_site_prev_launch(const __nv_bfloat16* x, const float* a, const float* c,
                                       const __nv_bfloat16* w, const float* bias,
                                       __nv_bfloat16* out, int B, int H, int W, void* stream) {
  RowsArgs p = {};
  p.x = x; p.a = a; p.c = c; p.w = w; p.bias = bias; p.out = out;
  p.B = B; p.H = H; p.W = W;
  return launch_rows<true>(p, stream);
}

// Dynamic shared memory of K9b's block.
extern "C" int d3sum_mma_smem_bytes() { return (int)D3SumSmem::bytes; }

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

// K10: x_pad [B,Hi,Wi,128] (Hi ≥ H+2, Wi ≥ W+2) read as given, stat [B,2,128]
// (a, c), w [9,128,128] (tap, c, co) → out [B,H,W,128] and, with stats, sums
// [B,2,128] (part [B, ceil(H/4)·ceil(W/32), 2, 128]), on fused_wgmma_kernel.
// prologue: 0 f32 affine + ReLU, 1 none, 2 the affine in bf16 arithmetic.
// x_pad, w and out 16-byte aligned.
extern "C" int fused_conv_launch(const __nv_bfloat16* x, const float* stat,
                                 const __nv_bfloat16* w, const float* bias, __nv_bfloat16* out,
                                 float* part, float* sums, int B, int Hi, int Wi, int H, int W,
                                 int CO, int prologue, int stats, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hi < H + 2 || Wi < W + 2 || CO != 128)
    return (int)cudaErrorInvalidValue;
#define K10_FORM(PRO)                                                                        \
  if (prologue == PRO)                                                                       \
    return stats ? launch_fused_wgmma<PRO, true>(x, stat, w, bias, out, part, sums, B, Hi, Wi, H, \
                                                 W, stream)                                   \
                 : launch_fused_wgmma<PRO, false>(x, stat, w, bias, out, part, sums, B, Hi, Wi,  \
                                                  H, W, stream);
  K10_FORM(kProF32)
  K10_FORM(kProNone)
  K10_FORM(kProBf16)
#undef K10_FORM
  return (int)cudaErrorInvalidValue;
}

// K10 on its previous core (site_kernel_bf16<128, 1, PRE = true>: 8 x 32
// tiles on 64 channels, part [B, ceil(H/8)·ceil(W/32), 2, CO]), for timing.
extern "C" int fused_conv_prev_launch(const __nv_bfloat16* x, const float* stat,
                                      const __nv_bfloat16* w, const float* bias,
                                      __nv_bfloat16* out, float* part, float* sums, int B, int Hi,
                                      int Wi, int H, int W, int CO, int prologue, int stats,
                                      void* stream) {
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

// K11: y12 [B,H+4,W+4,12] → out [B,H,W,128] = bf16(Σ y12·w + bias), w [5,5,12,128];
// on c1_wgmma_kernel (y12 and out 16-byte aligned).
extern "C" int c1_site_launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                              __nv_bfloat16* out, int B, int H, int W, void* stream) {
  return launch_c1_wgmma(x, w, bias, out, B, H, W, stream);
}

// K11 on its previous core (c1_kernel: 8 x 32 tiles on 64 channels), for
// timing only.
extern "C" int c1_site_prev_launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                   const float* bias, __nv_bfloat16* out, int B, int H, int W,
                                   void* stream) {
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

// Dynamic shared memory of K11's block (c1_wgmma_kernel).
extern "C" int c1_wgmma_smem_bytes() { return (int)C1W::bytes; }

// Resident blocks per SM and dynamic shared memory of a block: which 0 is
// K10 (f32 prologue, statistics: fused_wgmma_kernel), 1 K11
// (c1_wgmma_kernel), 2 K10's previous core (site_kernel_bf16<128, 1,
// true>), 3 K11's previous core (c1_kernel).
extern "C" int bf16_occupancy(int which, int* blocks, int* smem) {
  cudaError_t err;
  if (which == 0) {
    auto kern = fused_wgmma_kernel<kProF32, true>;
    *smem = (int)kFSmem;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kFThreads, *smem);
  } else if (which == 1) {
    *smem = (int)C1W::bytes;
    err = cudaFuncSetAttribute(c1_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, c1_wgmma_kernel, C1W::THREADS,
                                                          *smem);
  } else if (which == 2) {
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
