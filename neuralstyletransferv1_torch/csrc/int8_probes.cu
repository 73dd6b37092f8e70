// K12 shift_dot and K13 pad_inject — the int8 probes of experiments/.
//
// Replaces the TPU kernels of the int8 probe scripts:
//   K12 shift_dot   experiments/mk20_int8_smoke.py  probe2_pallas_dot (kern :75, a plain
//                   s8 x s8 -> s32 / bf16 x bf16 -> f32 dot) and probe3_res_shape (kern
//                   :137, the 8-row-strip flat 9-tap dot);
//                   experiments/mk21_int8_res_sweep.py  kern :36 (tap9, k384, noq);
//                   experiments/mk27_pallas_s8_dot.py   _k_bf16 :42, _k_s8_aligned :52,
//                   _k_s8_unaligned :63, _k_bf16cast :74
//   K13 pad_inject  experiments/mk28_probe.py  p1_pad :40 (an in-kernel column pad) and
//                   p2_inject :60 (quantize + pad + two injected halo columns)
//
// K12 computes out[g, m, :] = epi(sum_r pro(A)[g, src(m, r), :] . W[r]) over
// flat rows: A [G, MA, K], the taps' weights packed [R, N, K] (k innermost),
// out [G, M, N]. src(m, r) = m + off[r]. In the strip form (mk20 probe 3,
// mk21) A is x [B, H+2, W, C] viewed as [B, (H+2)·W, C], off[r] = dy·W + dx,
// and output row m of strip j = m / (TS·W) reads the strip's own rows
// [TS·j, TS·j + TS + 2) of x flattened, then zeros: a source past
// (TS+2)·W rows of its strip reads 0 (the TPU scratch's zero row). The dx
// taps run off the end of one image row into the next: there is no column
// halo. Prologues: none (s8 or bf16 operands as given), quantize
// (bf16 -> s8 clamp(rint(x·qscale), -127, 127)) or cast (bf16 -> s8
// saturating: NaN -> 0, else clamp(trunc(x), -128, 127), XLA's convert).
// Epilogues: s32, f32, or bf16(f32(acc)·oscale).
//
// What bounds it on an H100 (3.35 TB/s; 1979 TOP/s int8, 989 TFLOP/s bf16
// dense): bytes, or near balance. mk20's probe-2 dot [16384, 512] x [512,
// 256] moves 25.3 MB (s8 -> s32) or 33.8 MB (bf16 -> f32) for 4.3e9 MAC;
// the strip form at [8, 274, 488, 128] -> [8, 272, 488, 128] is 3.13e11
// operations over 546 MB (int8 prologue: bytes; bf16: operations); mk27 at
// G = 32 moves 101-135 MB for 5.2e10. PERF.md section 6 has the times.
//
// Design (shift_wgmma_kernel). What bounded the first core (shift_dot_kernel,
// kept for timing: one non-persistent 128 x 128 tile a block, the A rows
// staged by synchronous loads before any MMA, mma.sync, fragment stores)
// was that nothing overlapped: every tile loaded, multiplied and stored in
// turn. Here one persistent block an SM walks the (slice, 128-row,
// 128-channel) tiles; a producer warpgroup (one lane, its registers given to
// the consumers by setmaxnreg) keeps two rings full by TMA under the
// 128-byte swizzle: A slots, each one 128-byte k-chunk of the tile's staged
// rows, and weight slots, each one tap's 128 channels x one k-chunk. The
// staged rows keep the first core's plan: taps whose offsets lie within 128
// rows of each other share one segment of 128 + span rows (mk27: one; the
// strip form at W = 488: three), each segment in TMA boxes of at most 256
// rows that start on 1024-byte swizzle atoms. The prologues convert each
// landed bf16 chunk once into a code buffer (two raw chunks of 64 make one
// of 128 codes) and free its slot before the MMAs, so the next tile's rows
// load behind this tile's work. Two consumer warpgroups of 64 rows run
// wgmma m64n128k32 (s8) or m64n128k16 (bf16, f32 sums), B from the weight
// slot through a K-major descriptor. A tap's shift is one row, which breaks
// the 8-row core matrices an A descriptor needs, so A comes from registers:
// ldmatrix at each lane's shifted row (a warp's fragment is its 16 rows of
// the warpgroup's 64), or at a zero row where a strip's source lies past its
// rows. One tap of one k-chunk (4 k steps) is a commit group, its fragments
// in one of two register sets, so the next group's loads overlap the MMAs in
// flight. The epilogue goes through shared memory in 64-row x 128-byte
// slices, two in flight a warpgroup, each stored by TMA (rows past M are
// not written). Tiles are 128 x 128 (probe 2's 256 channels as two tiles:
// 256-channel tiles did not lift the bf16 form past torch.mm, PERF.md).
// The producer warpgroup drops to 40 registers so that each consumer
// thread may hold 232: its 64 accumulators, two 16-register fragment sets
// and the epilogue. shift_dot_smem_bytes (and int8_probes.smem_plan) give
// the slots that fit: at least two of each ring, or the form is refused.
//
// K13: column c of [B, R, WP, C] reads input column c - 1 for 1 <= c <= W0,
// else 0 (P1, bf16); P2 quantizes clamp(rint(x·qscale), -127, 127) to s8
// and injects input column 1 at column 0 and input column W0 - 2 at column
// W0 + 2 (the probe's own indices). It moves bytes only: at the int8 res
// site's input [8, 270, 480, 128] -> 488 columns, P1 moves 535 MB (0.160
// ms at 3.35 TB/s), P2 400 MB (0.120 ms). Its first core
// (pad_inject_kernel, kept for timing) was a grid-stride loop over 16-byte
// pieces capped at 4,096 blocks, each piece placed by 64-bit % and / by
// runtime divisors, one load in flight a thread. pad_inject_v2_kernel (a
// 2-D grid of row and column chunk, 32-bit offsets with no division,
// several loads in flight before the first store, P1 as a shifted row
// copy, P2's codes 16 bytes a store) replaces it.
//
// Rounding follows the reference operation by operation (built with
// --fmad=false): __int2float_rn, __fmul_rn, rintf (half to even, as
// jnp.round), __float2bfloat16_rn. s8 sums are exact int32; bf16 products
// are exact in f32 and their sums run in the MMA's order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;  // output tile: rows x channels
constexpr int kKC = 128;             // k elements of a staged weight unit
constexpr int kMaxTaps = 9;
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may take

enum Pro { kNone = 0, kQuant = 1, kCast = 2 };
enum Epi { kS32 = 0, kF32 = 1, kBf16 = 2 };

struct Plan {
  int nseg;
  int seg_base[kMaxTaps];   // first source row (relative to the tile's m0) of a segment
  int seg_rows[kMaxTaps];   // rows staged: kBM + the span of its offsets
  int seg_first[kMaxTaps];  // its first staged row
  int tap_row[kMaxTaps];    // a tap's first staged row (its segment's first + offset - base)
  int rows;                 // staged rows in all; the zero row follows them
};

struct Args {
  const void* a;    // [G, MA, K] int8 or bf16
  const void* wt;   // [R, N, K] int8 or bf16
  void* out;        // [G, M, N] int32, f32 or bf16
  int G, M, MA, K, N, R;
  int off[kMaxTaps];
  int strip;        // TS·W output rows a strip (0: the flat form)
  int zlim;         // (TS+2)·W: a source at or past it, strip-local, reads 0
  float qscale, oscale;
  Plan plan;
};

// Group the taps' offsets into staged segments: a new segment where the next
// offset lies more than kBM rows past the current one's end.
Plan make_plan(const int* off, int R) {
  Plan pl = {};
  int order[kMaxTaps];
  for (int r = 0; r < R; ++r) order[r] = r;
  for (int i = 1; i < R; ++i)  // insertion sort by offset
    for (int j = i; j > 0 && off[order[j]] < off[order[j - 1]]; --j) {
      const int t = order[j]; order[j] = order[j - 1]; order[j - 1] = t;
    }
  int seg = -1, end = 0;
  for (int i = 0; i < R; ++i) {
    const int o = off[order[i]];
    if (seg < 0 || o - end > kBM) {
      ++seg;
      pl.seg_base[seg] = o;
    }
    end = o;
    pl.seg_rows[seg] = kBM + (o - pl.seg_base[seg]);
    pl.tap_row[order[i]] = seg;  // the segment, for now
  }
  pl.nseg = seg + 1;
  for (int s = 0; s < pl.nseg; ++s) {
    pl.seg_first[s] = pl.rows;
    pl.rows += pl.seg_rows[s];
  }
  for (int r = 0; r < R; ++r) {
    const int s = pl.tap_row[r];
    pl.tap_row[r] = pl.seg_first[s] + off[r] - pl.seg_base[s];
  }
  return pl;
}

// bytes of a staged A row (K operands + 16 bytes: the eight rows an
// ldmatrix reads sit in 32 distinct banks) and of a staged weight row
size_t smem_bytes(const Plan& pl, int K, bool mma_bf16) {
  const int es = mma_bf16 ? 2 : 1;
  const size_t rs = (size_t)K * es + 16, ws = (size_t)kKC * es + 16;
  return (pl.rows + 1) * rs + 2 * kBN * ws;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

#include "hopper.cuh"

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bf16 -> f32 is exact: the bf16 bits are the f32's high half
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t quant_code(float v, float scale) {
  return (uint32_t)(int)fminf(fmaxf(rintf(__fmul_rn(v, scale)), -127.0f), 127.0f) & 0xffu;
}

// XLA's saturating f32 -> s8 convert: NaN -> 0, truncate toward zero, clamp
// (cvt.rzi.s32.f32 converts NaN to 0 and saturates to the s32 range)
__device__ __forceinline__ uint32_t cast_code(float v) {
  return (uint32_t)min(max(__float2int_rz(v), -128), 127) & 0xffu;
}

// A_BF16: A in device memory is bf16 (else int8); PRO: how its rows become
// operands; EPI: what is written. The MMA runs in bf16 when A is bf16 and
// not converted, else in s8.
template <bool A_BF16, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 1) shift_dot_kernel(Args p) {
  constexpr bool MB = A_BF16 && PRO == kNone;  // bf16 MMA
  static_assert(A_BF16 || PRO == kNone, "the prologues convert bf16");
  static_assert(EPI != kS32 || !MB, "s32 out is the s8 MMA's");
  static_assert(EPI != kF32 || MB, "f32 out is the bf16 MMA's");
  using Acc = typename std::conditional<MB, float, int>::type;
  constexpr int ES = MB ? 2 : 1;         // bytes of a staged operand
  constexpr int AES = A_BF16 ? 2 : 1;    // bytes of an A element in device memory
  constexpr int WS = kKC * ES + 16;      // bytes of a staged weight row
  constexpr int STEPS = kKC * ES / 32;   // 32-byte k steps a weight unit

  extern __shared__ __align__(16) uint8_t smem[];
  const int RS = p.K * ES + 16;          // bytes of a staged A row
  uint8_t* s_a = smem;                                  // [plan.rows + 1][RS]
  uint8_t* s_w = smem + (size_t)(p.plan.rows + 1) * RS; // [2][kBN][WS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, g = blockIdx.z;
  const int kch = p.K / kKC, units = p.R * kch;

  // a weight unit u = (tap u / kch, k chunk u % kch) into buffer u & 1
  const uint8_t* wt = static_cast<const uint8_t*>(p.wt);
  auto stage_w = [&](int u) {
    const int r = u / kch, kc = u % kch;
    uint8_t* dst = s_w + (u & 1) * kBN * WS;
    constexpr int PR = kKC * ES / 16;  // 16-byte pieces a row
    for (int i = tid; i < kBN * PR; i += kThreads) {
      const int n = i / PR, q = i % PR;
      cp_async16(dst + n * WS + 16 * q,
                 wt + (((size_t)r * p.N + n0 + n) * p.K + (size_t)kc * kKC) * ES + 16 * q);
    }
    cp_async_commit();
  };
  stage_w(0);

  // the tile's source rows, through the prologue, once; then the zero row
  const uint8_t* a = static_cast<const uint8_t*>(p.a) + (size_t)g * p.MA * p.K * AES;
  const int cpr = p.K * AES / 16;  // 16-byte pieces of an A row in device memory
  for (int s = 0; s < p.plan.nseg; ++s) {
    const int q0 = m0 + p.plan.seg_base[s], first = p.plan.seg_first[s];
    for (int i = tid; i < p.plan.seg_rows[s] * cpr; i += kThreads) {
      const int row = i / cpr, piece = i % cpr, q = q0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q < p.MA) v = __ldg(reinterpret_cast<const uint4*>(a + ((size_t)q * p.K) * AES) + piece);
      uint8_t* dst = s_a + (size_t)(first + row) * RS;
      if (PRO == kNone) {
        *reinterpret_cast<uint4*>(dst + 16 * piece) = v;
      } else {
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
        uint32_t c[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = bf16_lo(w4[j]), hi = bf16_hi(w4[j]);
          const uint32_t c0 = PRO == kQuant ? quant_code(lo, p.qscale) : cast_code(lo);
          const uint32_t c1 = PRO == kQuant ? quant_code(hi, p.qscale) : cast_code(hi);
          c[j >> 1] |= (c0 | (c1 << 8)) << (16 * (j & 1));
        }
        *reinterpret_cast<uint2*>(dst + 8 * piece) = make_uint2(c[0], c[1]);
      }
    }
  }
  for (int i = tid; i < RS / 16; i += kThreads)
    *reinterpret_cast<uint4*>(s_a + (size_t)p.plan.rows * RS + 16 * i) = make_uint4(0u, 0u, 0u, 0u);

  const int wm = warp & 3, wn = warp >> 2;  // rows 32wm.., channels 64wn..
  const int gq = lane >> 2, tg = lane & 3;
  Acc acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  // the row each lane hands ldmatrix for fragment mi, relative to a tap's first staged row
  const int lrow = wm * 32 + (lane & 15);
  const uint32_t a_base = smem_addr(s_a) + (lane >> 4) * 16;
  const uint32_t b_lane = (wn * 64 + (lane >> 4) * 8 + (lane & 7)) * WS + ((lane >> 3) & 1) * 16;

  for (int u = 0; u < units; ++u) {
    if (u + 1 < units) {
      stage_w(u + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u's weights and (u = 0) the staged rows are in place
    const int r = u / kch, kc = u % kch;
    uint32_t a_row[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      int srow = p.plan.tap_row[r] + lrow + 16 * mi;
      if (p.strip > 0 && (m0 + lrow + 16 * mi) % p.strip + p.off[r] >= p.zlim) srow = p.plan.rows;
      a_row[mi] = a_base + (uint32_t)srow * RS + kc * kKC * ES;
    }
    const uint32_t b_base = smem_addr(s_w + (u & 1) * kBN * WS) + b_lane;
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      uint32_t af[2][4], bq[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldsm_x4(af[mi], a_row[mi] + 32 * st);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t t[4];
        ldsm_x4(t, b_base + 16 * q * WS + 32 * st);
        bq[2 * q][0] = t[0];
        bq[2 * q][1] = t[1];
        bq[2 * q + 1][0] = t[2];
        bq[2 * q + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) mma(acc[mi][nj], af[mi], bq[nj][0], bq[nj][1]);
    }
    __syncthreads();  // buffer u & 1 is read before unit u + 2 overwrites it
  }

  // lane (gq, tg) holds rows gq, gq + 8 of fragment mi, channels 8nj + 2tg, +1
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + 16 * mi + gq + 8 * h;
      if (m >= p.M) continue;
      const size_t o = ((size_t)g * p.M + m) * p.N + n0 + wn * 64 + 2 * tg;
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const Acc v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (EPI == kS32) {
          *reinterpret_cast<int2*>(static_cast<int32_t*>(p.out) + o + 8 * nj) =
              make_int2((int)v0, (int)v1);
        } else if (EPI == kF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o + 8 * nj) =
              make_float2((float)v0, (float)v1);
        } else {
          const float f0 = MB ? (float)v0 : __int2float_rn((int)v0);
          const float f1 = MB ? (float)v1 : __int2float_rn((int)v1);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o + 8 * nj) =
              __floats2bfloat162_rn(__fmul_rn(f0, p.oscale), __fmul_rn(f1, p.oscale));
        }
      }
    }
  }
}

template <bool A_BF16, int PRO, int EPI>
int launch_shift(const Args& p, cudaStream_t stream) {
  constexpr bool MB = A_BF16 && PRO == kNone;
  const size_t smem = smem_bytes(p.plan, p.K, MB);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = shift_dot_kernel<A_BF16, PRO, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.M + kBM - 1) / kBM, p.N / kBN, p.G);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// shift_wgmma_kernel: K12 on Hopper's warpgroup MMAs, fed by TMA
// ---------------------------------------------------------------------------

constexpr int kCons = 256;              // consumer threads: two warpgroups of 64 output rows
constexpr int kWThreads = kCons + 128;  // + one producer warpgroup
constexpr int kEpiRows = 64;            // rows of an epilogue slice (a warpgroup's)
constexpr int kEpiBytes = 2 * 2 * kEpiRows * kSpan;  // two slices in flight a warpgroup
constexpr int kBarBytes = 256;          // the ring's mbarriers
constexpr int kZeroBytes = 128;         // the zero row of the strip form
constexpr int kMaxSlots = 6;            // weight slots at most (A slots: 4)

// The staged rows of one k-chunk: make_plan's segments, each brought in by
// TMA boxes of `box` rows (a multiple of 8, at most 256), so that every
// segment starts on a 1024-byte swizzle atom.
struct WPlan {
  int nseg;
  int seg_base[kMaxTaps];  // first source row (relative to the tile's m0)
  int seg_nbox[kMaxTaps];  // its boxes
  int seg_first[kMaxTaps]; // its first staged row
  int tap_row[kMaxTaps];   // a tap's first staged row
  int box;                 // rows of a box
  int rows;                // staged rows of a k-chunk
};

WPlan make_wplan(const int* off, int R) {
  const Plan pl = make_plan(off, R);
  WPlan w = {};
  w.nseg = pl.nseg;
  int most = 0;
  for (int s = 0; s < pl.nseg; ++s) most = pl.seg_rows[s] > most ? pl.seg_rows[s] : most;
  const int nb = (most + 255) / 256;
  w.box = 8 * ((most + 8 * nb - 1) / (8 * nb));
  for (int s = 0; s < pl.nseg; ++s) {
    w.seg_base[s] = pl.seg_base[s];
    w.seg_nbox[s] = (pl.seg_rows[s] + w.box - 1) / w.box;
    w.seg_first[s] = w.rows;
    w.rows += w.seg_nbox[s] * w.box;
  }
  for (int r = 0; r < R; ++r) {
    int s = 0;  // the segment holding tap r: the last whose base is at or below its offset
    for (int t = 0; t < pl.nseg; ++t)
      if (pl.seg_base[t] <= off[r]) s = t;
    w.tap_row[r] = w.seg_first[s] + off[r] - w.seg_base[s];
  }
  return w;
}

// Ring slots and dynamic shared memory: na A slots (one k-chunk of the
// staged rows each), for the prologues one code buffer, nw weight slots (one
// tap's kBN rows of a k-chunk), the epilogue slices, the barriers and the
// zero row, after up to 1024 bytes of alignment. As many slots as fit, at
// least two of each (else bytes > kSmemMax: the form is not launched).
struct WBudget {
  int na, nw;
  size_t bytes;
};

WBudget wbudget(const WPlan& pl, bool pro) {
  const size_t a = (size_t)pl.rows * kSpan, w = (size_t)kBN * kSpan;
  auto total = [&](int na, int nw) {
    return 1024 + a * (na + (pro ? 1 : 0)) + w * nw + kEpiBytes + kBarBytes + kZeroBytes;
  };
  WBudget b = {2, 2, total(2, 2)};
  for (bool grew = true; grew;) {
    grew = false;
    if (b.nw < kMaxSlots && total(b.na, b.nw + 1) <= (size_t)kSmemMax) { ++b.nw; grew = true; }
    if (b.na < 4 && total(b.na + 1, b.nw) <= (size_t)kSmemMax) { ++b.na; grew = true; }
  }
  b.bytes = total(b.na, b.nw);
  return b;
}

struct alignas(64) WArgs {
  CUtensorMap map_a;    // A [G][MA][K]: boxes of 128 bytes x plan.box rows
  CUtensorMap map_w;    // weights [R][N][K]: boxes of 128 bytes x kBN rows
  CUtensorMap map_out;  // out [G][M][N]: boxes of 128 bytes x 64 rows
  int R, kch;           // kch: k-chunks of 128 operand bytes
  int mtiles, ntiles, tiles;
  int off[kMaxTaps];
  int strip, zlim;
  float qscale, oscale;
  int na, nw;
  WPlan plan;
};

// Built with -DMMA_PHASE_CLOCKS (chip_smoke.py --phases), thread 0 of each
// block adds the clock cycles of the phases of its tile loop into
// mma_phase_clocks[block]: 0 waiting for a k-chunk's rows, 1 waiting for a
// tap's weights, 2 the prologue's conversion, 3 the fragments loaded and
// the MMAs issued (a group waits for the one before it), 4 the epilogue
// (the last MMAs' drain included).
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

// One tap of one k-chunk: the four k steps' A fragments of this lane's
// shifted row into afr (rb: the row's staged address, or the zero row), then
// four MMAs into acc, committed as one group; returns once the previous
// group is done.
template <bool MB, typename Acc, int NACC>
__device__ __forceinline__ void tap_unit(Acc (&acc)[NACC], uint32_t (&afr)[16], uint32_t rb, int sw,
                                         bool zero, uint32_t zero_s, int khalf, uint64_t desc,
                                         bool first) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t adr = zero ? zero_s : rb + (uint32_t)(((2 * s + khalf) ^ sw) << 4);
    uint32_t (&f)[4] = *reinterpret_cast<uint32_t(*)[4]>(&afr[4 * s]);
    ldsm_x4(f, adr);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if constexpr (MB)
      wgmma_bf16<0>(acc, &afr[4 * s], desc + 2 * s, !(first && s == 0));
    else
      wgmma_s8(acc, &afr[4 * s], desc + 2 * s, !(first && s == 0));
  }
  wgmma_commit();
  wgmma_wait<1>();
}

template <bool A_BF16, int PRO, int EPI>
__global__ void __launch_bounds__(kWThreads, 1) shift_wgmma_kernel(const __grid_constant__ WArgs p) {
  constexpr bool MB = A_BF16 && PRO == kNone;  // bf16 MMA
  static_assert(A_BF16 || PRO == kNone, "the prologues convert bf16");
  static_assert(EPI != kS32 || !MB, "s32 out is the s8 MMA's");
  static_assert(EPI != kF32 || MB, "f32 out is the bf16 MMA's");
  using Acc = typename std::conditional<MB, float, int>::type;
  constexpr int AE = A_BF16 ? 2 : 1;                // bytes of an A element in device memory
  constexpr int WE = MB ? 2 : 1;                    // of a weight
  constexpr int HALVES = PRO == kNone ? 1 : 2;      // staged A chunks a k-chunk of codes
  constexpr int OES = EPI == kBf16 ? 2 : 4;         // bytes of an output element
  constexpr int NACC = kBN / 2;                      // accumulators a thread
  constexpr int SLICES = kBN * OES / kSpan;          // epilogue slices of a warpgroup's tile
  constexpr int JS = kSpan / (8 * OES);             // 8-channel groups a slice

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int a_bytes = p.plan.rows * kSpan;
  uint8_t* s_a = base;                                          // [na][rows][128]
  uint8_t* s_code = s_a + (size_t)p.na * a_bytes;               // [rows][128] (prologues)
  uint8_t* s_w = s_code + (PRO != kNone ? a_bytes : 0);         // [nw][kBN][128]
  uint8_t* s_epi = s_w + (size_t)p.nw * kBN * kSpan;             // [2 warpgroups][2][64][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_epi + kEpiBytes);
  uint64_t* a_full = bars;
  uint64_t* a_empty = bars + p.na;
  uint64_t* w_full = bars + 2 * p.na;
  uint64_t* w_empty = w_full + p.nw;
  uint8_t* s_zero = s_epi + kEpiBytes + kBarBytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < p.na; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], kCons / 32);
    }
    for (int i = 0; i < p.nw; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kZeroBytes / 16) reinterpret_cast<uint4*>(s_zero)[tid] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  if (warp >= kCons / 32) {
    // the producer: one lane keeps the rings full, tile after tile
    setmaxnreg_dec<40>();  // its registers go to the consumers
    if (warp == kCons / 32 && lane == 0) {
      Ring ra = {0, 0u}, rw = {0, 0u};
      for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
        const int n0 = (t % p.ntiles) * kBN, m0 = (t / p.ntiles % p.mtiles) * 128;
        const int g = t / (p.ntiles * p.mtiles);
        for (int c = 0; c < p.kch; ++c) {
          for (int h = 0; h < HALVES; ++h) {
            mbar_wait(&a_empty[ra.i], ra.ph ^ 1u);
            mbar_expect_tx(&a_full[ra.i], (uint32_t)a_bytes);
            uint8_t* dst = s_a + (size_t)ra.i * a_bytes;
            const int k0 = (c * HALVES + h) * (kSpan / AE);
            for (int s = 0; s < p.plan.nseg; ++s)
              for (int b = 0; b < p.plan.seg_nbox[s]; ++b)
                tma_load_3d(dst + (size_t)(p.plan.seg_first[s] + b * p.plan.box) * kSpan, &p.map_a,
                            &a_full[ra.i], k0, m0 + p.plan.seg_base[s] + b * p.plan.box, g);
            ra.next(p.na);
          }
          for (int r = 0; r < p.R; ++r) {
            mbar_wait(&w_empty[rw.i], rw.ph ^ 1u);
            mbar_expect_tx(&w_full[rw.i], (uint32_t)(kBN * kSpan));
            tma_load_3d(s_w + (size_t)rw.i * kBN * kSpan, &p.map_w, &w_full[rw.i],
                        c * (kSpan / WE), n0, r);
            rw.next(p.nw);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // the consumers: warpgroup wg computes rows 64wg.. of the tile, all kBN channels
  const int wg = warp >> 2, wq = warp & 3, gq = lane >> 2, tg = lane & 3;
  const int lrow = 64 * wg + 16 * wq + (lane & 15);  // the row this lane hands ldmatrix
  const int khalf = lane >> 4;
  const uint32_t zero_s = smem_addr(s_zero);
  Acc acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  uint32_t afr[2][16];
  Ring ra = {0, 0u}, rw = {0, 0u};
  int epi_n = 0;  // epilogue slices this warpgroup has stored
  MMA_PHASE_START

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int n0 = (t % p.ntiles) * kBN, m0 = (t / p.ntiles % p.mtiles) * 128;
    const int g = t / (p.ntiles * p.mtiles);
    int u = 0, w_prev = -1;
    for (int c = 0; c < p.kch; ++c) {
      uint32_t ob;  // the k-chunk's operand rows
      if constexpr (PRO != kNone) {
        MMA_PHASE(3)
        bar_sync(1, kCons);  // every warp is done with the previous codes
        for (int h = 0; h < 2; ++h) {
          mbar_wait(&a_full[ra.i], ra.ph);
          MMA_PHASE(0)
          const uint8_t* raw = s_a + (size_t)ra.i * a_bytes;
          for (int i = tid; i < p.plan.rows * 8; i += kCons) {
            const int row = i >> 3, q = i & 7;
            const uint4 v = *reinterpret_cast<const uint4*>(raw + swz(row, q));
            const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
            uint32_t cc[2] = {0u, 0u};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float lo = bf16_lo(w4[j]), hi = bf16_hi(w4[j]);
              const uint32_t c0 = PRO == kQuant ? quant_code(lo, p.qscale) : cast_code(lo);
              const uint32_t c1 = PRO == kQuant ? quant_code(hi, p.qscale) : cast_code(hi);
              cc[j >> 1] |= (c0 | (c1 << 8)) << (16 * (j & 1));
            }
            *reinterpret_cast<uint2*>(s_code + swz(row, 4 * h + (q >> 1)) + 8 * (q & 1)) =
                make_uint2(cc[0], cc[1]);
          }
          if (lane == 0) mbar_arrive(&a_empty[ra.i]);
          ra.next(p.na);
          MMA_PHASE(2)
        }
        bar_sync(1, kCons);  // the codes are in place
        ob = smem_addr(s_code);
      } else {
        MMA_PHASE(3)
        mbar_wait(&a_full[ra.i], ra.ph);
        MMA_PHASE(0)
        ob = smem_addr(s_a + (size_t)ra.i * a_bytes);
      }
      for (int r = 0; r < p.R; ++r) {
        MMA_PHASE(3)
        mbar_wait(&w_full[rw.i], rw.ph);
        MMA_PHASE(1)
        const int row = p.plan.tap_row[r] + lrow;
        const bool zero = p.strip > 0 && (m0 + lrow) % p.strip + p.off[r] >= p.zlim;
        const uint32_t rb = ob + (uint32_t)row * kSpan;
        const uint64_t desc = desc_kmajor(smem_addr(s_w + (size_t)rw.i * kBN * kSpan));
        const bool first = c == 0 && r == 0;
        if (u & 1)
          tap_unit<MB>(acc, afr[1], rb, row & 7, zero, zero_s, khalf, desc, first);
        else
          tap_unit<MB>(acc, afr[0], rb, row & 7, zero, zero_s, khalf, desc, first);
        if (w_prev >= 0 && lane == 0) mbar_arrive(&w_empty[w_prev]);  // its MMAs are done
        w_prev = rw.i;
        rw.next(p.nw);
        ++u;
      }
      if constexpr (PRO == kNone) {
        if (lane == 0) mbar_arrive(&a_empty[ra.i]);  // the fragments are in registers
        ra.next(p.na);
      }
    }
    MMA_PHASE(3)
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&w_empty[w_prev]);

    // epilogue: slices of 64 rows x 128 bytes through shared memory (the
    // 128-byte swizzle), each stored by TMA (rows past M are not written)
    const int m0w = m0 + 64 * wg;
#pragma unroll
    for (int sl = 0; sl < SLICES; ++sl) {
      uint8_t* buf = s_epi + (size_t)(2 * wg + (epi_n & 1)) * kEpiRows * kSpan;
      if (tid % 128 == 0) bulk_wait_read<1>();  // the slice stored from buf before is read
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int jj = sl * JS + j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * wq + gq + 8 * h;
          const Acc v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
          if constexpr (EPI == kS32) {
            *reinterpret_cast<int2*>(buf + swz(row, 2 * j + (tg >> 1)) + 8 * (tg & 1)) =
                make_int2((int)v0, (int)v1);
          } else if constexpr (EPI == kF32) {
            *reinterpret_cast<float2*>(buf + swz(row, 2 * j + (tg >> 1)) + 8 * (tg & 1)) =
                make_float2((float)v0, (float)v1);
          } else {
            const float f0 = MB ? (float)v0 : __int2float_rn((int)v0);
            const float f1 = MB ? (float)v1 : __int2float_rn((int)v1);
            *reinterpret_cast<__nv_bfloat162*>(buf + swz(row, j) + 4 * tg) =
                __floats2bfloat162_rn(__fmul_rn(f0, p.oscale), __fmul_rn(f1, p.oscale));
          }
        }
      }
      fence_async_smem();
      bar_sync(2 + wg, 128);
      if (tid % 128 == 0) {
        tma_store_3d(&p.map_out, buf, n0 + sl * (kSpan / OES), m0w, g);
        bulk_commit();
      }
      ++epi_n;
    }
    MMA_PHASE(4)
  }
  if (tid % 128 == 0) bulk_wait_read<0>();
  MMA_PHASE_END
}

template <bool A_BF16, int PRO, int EPI>
int launch_wgmma(const void* a, const void* wt, void* out, int G, int M, int MA, int K, int N, int R,
                 const int* off, int strip, int zlim, float qscale, float oscale,
                 cudaStream_t stream) {
  constexpr bool MB = A_BF16 && PRO == kNone;
  WArgs p = {};
  p.plan = make_wplan(off, R);
  const WBudget bud = wbudget(p.plan, PRO != kNone);
  if (bud.bytes > (size_t)kSmemMax || p.plan.box > 256) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, b16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType od = EPI == kS32 ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                 : EPI == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : b16;
  constexpr int AE = A_BF16 ? 2 : 1, WE = MB ? 2 : 1, OE = EPI == kBf16 ? 2 : 4;
  const int da[3] = {K, MA, G}, ba[3] = {kSpan / AE, p.plan.box, 1};
  const int dw[3] = {K, N, R}, bw[3] = {kSpan / WE, kBN, 1};
  const int dout[3] = {N, M, G}, bout[3] = {kSpan / OE, kEpiRows, 1};
  if (!make_map(&p.map_a, A_BF16 ? b16 : u8, AE, a, 3, da, ba) ||
      !make_map(&p.map_w, MB ? b16 : u8, WE, wt, 3, dw, bw) ||
      !make_map(&p.map_out, od, OE, out, 3, dout, bout))
    return (int)cudaErrorInvalidValue;
  p.R = R;
  p.kch = K * (MB ? 2 : 1) / kSpan;
  p.mtiles = (M + 127) / 128;
  p.ntiles = N / kBN;
  p.tiles = G * p.mtiles * p.ntiles;
  for (int r = 0; r < R; ++r) p.off[r] = off[r];
  p.strip = strip; p.zlim = zlim; p.qscale = qscale; p.oscale = oscale;
  p.na = bud.na; p.nw = bud.nw;
  auto kern = shift_wgmma_kernel<A_BF16, PRO, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bud.bytes);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  kern<<<p.tiles < sms ? p.tiles : sms, kWThreads, bud.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// K13's first core (pad_inject_prev_launch, for timing)
template <bool INJECT>
__global__ void pad_inject_kernel(const __nv_bfloat16* __restrict__ x, void* __restrict__ out,
                                  int B, int R, int W0, int WP, int C, float qscale) {
  const int cpp = C / 8;  // 8-channel pieces a pixel
  const size_t total = (size_t)B * R * WP * cpp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int piece = (int)(i % cpp);
    const size_t pix = i / cpp;
    const int col = (int)(pix % WP);
    const size_t row = pix / WP;  // b·R + r
    int src = col >= 1 && col <= W0 ? col - 1 : -1;
    if (INJECT && col == 0) src = 1;
    if (INJECT && col == W0 + 2) src = W0 - 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src >= 0) v = __ldg(reinterpret_cast<const uint4*>(x + (row * W0 + src) * C) + piece);
    if (!INJECT) {
      reinterpret_cast<uint4*>(out)[i] = v;
    } else {
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
      uint32_t c[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j >> 1] |= (quant_code(bf16_lo(w4[j]), qscale) | (quant_code(bf16_hi(w4[j]), qscale) << 8))
                     << (16 * (j & 1));
      reinterpret_cast<uint2*>(out)[i] = make_uint2(c[0], c[1]);
    }
  }
}

// K13 on its new core. A block takes a chunk of kPadThreads x U units of
// one output row (blockIdx.x the chunk, blockIdx.y the row, and +
// gridDim.y ...); a unit is one 16-byte piece of bf16 (P1) or PC pieces'
// 8-byte codes (P2: PC = 2, one 16-byte store, where a row holds an even
// number of pieces; else 1). U = kPadUnits where that still gives two
// blocks an SM, else 1 (a strip of a few rows: more blocks, less work a
// thread). Piece i of an output row (8 channels; cpp pieces a pixel)
// reads piece src(i) of the input row: P1 i - cpp for
// cpp <= i < (W0 + 1)·cpp, a row copy shifted by one pixel (2C bytes, a
// multiple of 16), else zero; P2 also piece i + cpp for i < cpp (column 0
// <- column 1) and i - 4·cpp for (W0 + 2)·cpp <= i < (W0 + 3)·cpp (column
// W0 + 2 <- column W0 - 2). All index arithmetic is 32-bit, with no
// division; each thread issues its U (x PC) loads before its first store.
constexpr int kPadThreads = 256, kPadUnits = 4;

__device__ __forceinline__ int pad_src(int i, int nin, int cpp, int w0, bool inject) {
  if (inject && i < cpp) return i + cpp;
  if ((unsigned)(i - cpp) < (unsigned)nin) return i - cpp;
  if (inject && (unsigned)(i - (w0 + 2) * cpp) < (unsigned)cpp) return i - 4 * cpp;
  return -1;
}

template <bool INJECT, int PC, int U>
__global__ void __launch_bounds__(kPadThreads) pad_inject_v2_kernel(
    const uint4* __restrict__ x, void* __restrict__ out, int rows, int w0, int cpp, int nout,
    float qscale) {
  const int nin = w0 * cpp, units = nout / PC;
  const int u0 = blockIdx.x * (kPadThreads * U) + threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint4* xr = x + (size_t)row * nin;
    uint4 v[U][PC];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < PC; ++k) {
        const int src = pad_src((u0 + u * kPadThreads) * PC + k, nin, cpp, w0, INJECT);
        v[u][k] = src >= 0 ? __ldg(xr + src) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int unit = u0 + u * kPadThreads;
      if (unit >= units) break;
      if (!INJECT) {
        reinterpret_cast<uint4*>(out)[(size_t)row * units + unit] = v[u][0];
      } else {
        uint32_t c[2 * PC];
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          const uint32_t w4[4] = {v[u][k].x, v[u][k].y, v[u][k].z, v[u][k].w};
          c[2 * k] = c[2 * k + 1] = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            c[2 * k + (j >> 1)] |=
                (quant_code(bf16_lo(w4[j]), qscale) | (quant_code(bf16_hi(w4[j]), qscale) << 8))
                << (16 * (j & 1));
        }
        if constexpr (PC == 2)
          reinterpret_cast<uint4*>(out)[(size_t)row * units + unit] = make_uint4(c[0], c[1], c[2], c[3]);
        else
          reinterpret_cast<uint2*>(out)[(size_t)row * units + unit] = make_uint2(c[0], c[1]);
      }
    }
  }
}

template <bool INJECT, int PC>
int launch_pad_v2(const void* x, void* out, int rows, int w0, int cpp, int nout, float qscale,
                  cudaStream_t s) {
  const int units = nout / PC, gy = rows < 65535 ? rows : 65535;
  const int per = kPadThreads * kPadUnits, sms = sm_count();
  const uint4* xv = static_cast<const uint4*>(x);
  if ((long long)(units + per - 1) / per * gy >= 2LL * sms) {
    pad_inject_v2_kernel<INJECT, PC, kPadUnits><<<dim3((units + per - 1) / per, gy), kPadThreads,
                                                  0, s>>>(xv, out, rows, w0, cpp, nout, qscale);
  } else {
    pad_inject_v2_kernel<INJECT, PC, 1><<<dim3((units + kPadThreads - 1) / kPadThreads, gy),
                                          kPadThreads, 0, s>>>(xv, out, rows, w0, cpp, nout,
                                                               qscale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory K12 takes for these R offsets with a prologue (pro
// 1: the code buffer) or without; more than a block may take (kSmemMax):
// the form is not launched.
extern "C" int shift_dot_smem_bytes(const int* off, int R, int pro) {
  if (R < 1 || R > kMaxTaps) return -1;
  return (int)wbudget(make_wplan(off, R), pro != 0).bytes;
}

namespace {

bool shift_args_ok(int G, int M, int MA, int K, int N, int R, const int* off, int strip) {
  if (G < 1 || M < 1 || MA < 1 || K < kKC || K % kKC || N < kBN || N % kBN || R < 1 ||
      R > kMaxTaps || strip < 0)
    return false;
  for (int r = 0; r < R; ++r)
    if (off[r] < 0) return false;
  return true;
}

}  // namespace

// K12: out [G, M, N] = epi(sum_r pro(a)[g, m + off[r], :] . wt[r]^T) over
// a [G, MA, K], wt [R, N, K]. a_bf16: a is bf16 (else int8); pro 0 none, 1
// quantize (qscale), 2 saturating cast; epi 0 s32, 1 f32, 2 bf16(f32(acc)·
// oscale). strip > 0: the strip form, a source at or past zlim rows of its
// output row's strip (m / strip) reads 0. Needs K % 128 == 0, N % 128 == 0,
// sources within MA rows or zero-read, 16-byte aligned tensors. On
// shift_wgmma_kernel.
extern "C" int shift_dot_launch(const void* a, const void* wt, void* out, int G, int M, int MA,
                                int K, int N, int R, const int* off, int strip, int zlim,
                                float qscale, float oscale, int a_bf16, int pro, int epi,
                                void* stream) {
  if (!shift_args_ok(G, M, MA, K, N, R, off, strip)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K12_FORM(AB, PRO, EPI)                                                             \
  if (!!a_bf16 == AB && pro == PRO && epi == EPI)                                          \
    return launch_wgmma<AB, PRO, EPI>(a, wt, out, G, M, MA, K, N, R, off, strip, zlim, qscale, \
                                      oscale, s);
  // the forms the probes run
  K12_FORM(false, kNone, kS32)
  K12_FORM(false, kNone, kBf16)
  K12_FORM(true, kNone, kF32)
  K12_FORM(true, kNone, kBf16)
  K12_FORM(true, kQuant, kBf16)
  K12_FORM(true, kCast, kBf16)
#undef K12_FORM
  return (int)cudaErrorInvalidValue;
}

// K12 on its previous core (shift_dot_kernel: 128 x 128 tiles, one a block,
// mma.sync), the same arguments; for timing the two side by side only.
extern "C" int shift_dot_prev_launch(const void* a, const void* wt, void* out, int G, int M,
                                     int MA, int K, int N, int R, const int* off, int strip,
                                     int zlim, float qscale, float oscale, int a_bf16, int pro,
                                     int epi, void* stream) {
  if (!shift_args_ok(G, M, MA, K, N, R, off, strip)) return (int)cudaErrorInvalidValue;
  Args p = {};
  p.a = a; p.wt = wt; p.out = out;
  p.G = G; p.M = M; p.MA = MA; p.K = K; p.N = N; p.R = R;
  for (int r = 0; r < R; ++r) p.off[r] = off[r];
  p.strip = strip; p.zlim = zlim; p.qscale = qscale; p.oscale = oscale;
  p.plan = make_plan(off, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!a_bf16 && pro == kNone && epi == kS32) return launch_shift<false, kNone, kS32>(p, s);
  if (!a_bf16 && pro == kNone && epi == kBf16) return launch_shift<false, kNone, kBf16>(p, s);
  if (a_bf16 && pro == kNone && epi == kF32) return launch_shift<true, kNone, kF32>(p, s);
  if (a_bf16 && pro == kNone && epi == kBf16) return launch_shift<true, kNone, kBf16>(p, s);
  if (a_bf16 && pro == kQuant && epi == kBf16) return launch_shift<true, kQuant, kBf16>(p, s);
  if (a_bf16 && pro == kCast && epi == kBf16) return launch_shift<true, kCast, kBf16>(p, s);
  return (int)cudaErrorInvalidValue;
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

// K13: x [B, R, W0, C] bf16 -> out [B, R, WP, C]: inject 0 (P1) bf16, column
// c = x column c - 1 for 1 <= c <= W0, else 0; inject 1 (P2) int8 codes
// clamp(rint(x·qscale), -127, 127) in the same places, and column 0 = code
// of x column 1, column W0 + 2 = code of x column W0 - 2. C % 8 == 0; x and
// out 16-byte aligned. On pad_inject_v2_kernel.
extern "C" int pad_inject_launch(const void* x, void* out, int B, int R, int W0, int WP, int C,
                                 int inject, float qscale, void* stream) {
  if (B < 1 || R < 1 || W0 < 3 || WP < W0 + (inject ? 3 : 1) || C < 8 || C % 8)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * R, nout = (long long)WP * (C / 8);
  if (rows > 0x7fffffffLL || nout * 2 > 0x7fffffffLL || (long long)W0 * (C / 8) * 4 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = (int)rows, cpp = C / 8, n = (int)nout;
  if (!inject) return launch_pad_v2<false, 1>(x, out, r, W0, cpp, n, qscale, s);
  return n % 2 == 0 ? launch_pad_v2<true, 2>(x, out, r, W0, cpp, n, qscale, s)
                    : launch_pad_v2<true, 1>(x, out, r, W0, cpp, n, qscale, s);
}

// K13 on its previous core (pad_inject_kernel: a grid-stride loop over
// 16-byte pieces), the same arguments; for timing the two side by side only.
extern "C" int pad_inject_prev_launch(const void* x, void* out, int B, int R, int W0, int WP,
                                      int C, int inject, float qscale, void* stream) {
  if (B < 1 || R < 1 || W0 < 3 || WP < W0 + (inject ? 3 : 1) || C < 8 || C % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)B * R * WP * (C / 8);
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (inject)
    pad_inject_kernel<true><<<blocks, 256, 0, s>>>(xb, out, B, R, W0, WP, C, qscale);
  else
    pad_inject_kernel<false><<<blocks, 256, 0, s>>>(xb, out, B, R, W0, WP, C, qscale);
  return (int)cudaGetLastError();
}
