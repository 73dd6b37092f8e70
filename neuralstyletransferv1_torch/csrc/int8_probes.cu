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
// Design. Block = 256 threads = one 128-row x 128-channel output tile of one
// slice g; 8 warps as 4 row warps of 32 rows x 2 channel warps of 64. The
// rows the tile's taps read are staged once a block into shared memory,
// through the prologue (quantized or cast once a block, not once a tap), as
// a few segments: taps whose offsets lie within 128 rows of each other share
// one segment (mk27: one; the strip form at W = 488: three, one a dy). The
// weights stream through two shared buffers, one tap x 128 k a unit, loaded
// with cp.async while the previous unit's MMAs run. The MMAs are
// mma.sync.m16n8k32.s8.s8.s32 (s8 operands) or mma.sync.m16n8k16 bf16 with
// f32 accumulation, fed by ldmatrix: both read 16 rows x 32 bytes of A and
// 8 channels x 32 bytes of W a fragment, so one addressing serves both. A
// tap's shift is the per-lane row address of ldmatrix; in the strip form a
// lane whose source lies past its strip's rows points at a zero row instead.
// The epilogue writes each lane's fragment pairs (8 bytes s32/f32, 4 bf16).
//
// What bounds it on an H100 (3.35 TB/s; 1979 TOP/s int8, 989 TFLOP/s bf16
// dense): the strip form at [8, 274, 488, 128] -> [8, 272, 488, 128] is
// 3.13e11 operations and moves 546 MB (int8 prologue: 0.163 ms, bytes; bf16:
// 0.317 ms, operations); mk27 at G = 32 moves 101 MB (s8: 30 us, bytes);
// mk20's probe-2 dot 25.3 MB (7.6 us). The first design is simple: no
// overlap of the A staging with the MMAs, fragment stores to device memory.
//
// K13: one thread per 8 channels of one output pixel of [B, R, WP, C]:
// column c reads input column c - 1 for 1 <= c <= W0, else 0 (P1, bf16);
// P2 quantizes clamp(rint(x·qscale), -127, 127) to s8 and injects input
// column 1 at column 0 and input column W0 - 2 at column W0 + 2 (the
// probe's own indices). It moves bytes only.
//
// Rounding follows the reference operation by operation (built with
// --fmad=false): __int2float_rn, __fmul_rn, rintf (half to even, as
// jnp.round), __float2bfloat16_rn. s8 sums are exact int32; bf16 products
// are exact in f32 and their sums run in the MMA's order.

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

// K13
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

}  // namespace

// Dynamic shared memory K12 takes for these R offsets at K, with the bf16
// MMA (mma_bf16 1) or the s8 MMA (0); more than a block may take: the form
// is not launched.
extern "C" int shift_dot_smem_bytes(const int* off, int R, int K, int mma_bf16) {
  if (R < 1 || R > kMaxTaps) return -1;
  return (int)smem_bytes(make_plan(off, R), K, mma_bf16 != 0);
}

// K12: out [G, M, N] = epi(sum_r pro(a)[g, m + off[r], :] . wt[r]^T) over
// a [G, MA, K], wt [R, N, K]. a_bf16: a is bf16 (else int8); pro 0 none, 1
// quantize (qscale), 2 saturating cast; epi 0 s32, 1 f32, 2 bf16(f32(acc)·
// oscale). strip > 0: the strip form, a source at or past zlim rows of its
// output row's strip (m / strip) reads 0. Needs K % 128 == 0, N % 128 == 0,
// sources within MA rows or zero-read, 16-byte aligned tensors.
extern "C" int shift_dot_launch(const void* a, const void* wt, void* out, int G, int M, int MA,
                                int K, int N, int R, const int* off, int strip, int zlim,
                                float qscale, float oscale, int a_bf16, int pro, int epi,
                                void* stream) {
  if (G < 1 || M < 1 || MA < 1 || K < kKC || K % kKC || N < kBN || N % kBN || R < 1 ||
      R > kMaxTaps || strip < 0)
    return (int)cudaErrorInvalidValue;
  Args p = {};
  p.a = a; p.wt = wt; p.out = out;
  p.G = G; p.M = M; p.MA = MA; p.K = K; p.N = N; p.R = R;
  for (int r = 0; r < R; ++r) {
    if (off[r] < 0) return (int)cudaErrorInvalidValue;
    p.off[r] = off[r];
  }
  p.strip = strip; p.zlim = zlim; p.qscale = qscale; p.oscale = oscale;
  p.plan = make_plan(off, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the forms the probes run
  if (!a_bf16 && pro == kNone && epi == kS32) return launch_shift<false, kNone, kS32>(p, s);
  if (!a_bf16 && pro == kNone && epi == kBf16) return launch_shift<false, kNone, kBf16>(p, s);
  if (a_bf16 && pro == kNone && epi == kF32) return launch_shift<true, kNone, kF32>(p, s);
  if (a_bf16 && pro == kNone && epi == kBf16) return launch_shift<true, kNone, kBf16>(p, s);
  if (a_bf16 && pro == kQuant && epi == kBf16) return launch_shift<true, kQuant, kBf16>(p, s);
  if (a_bf16 && pro == kCast && epi == kBf16) return launch_shift<true, kCast, kBf16>(p, s);
  return (int)cudaErrorInvalidValue;
}

// K13: x [B, R, W0, C] bf16 -> out [B, R, WP, C]: inject 0 (P1) bf16, column
// c = x column c - 1 for 1 <= c <= W0, else 0; inject 1 (P2) int8 codes
// clamp(rint(x·qscale), -127, 127) in the same places, and column 0 = code
// of x column 1, column W0 + 2 = code of x column W0 - 2. C % 8 == 0.
extern "C" int pad_inject_launch(const void* x, void* out, int B, int R, int W0, int WP, int C,
                                 int inject, float qscale, void* stream) {
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
