// K2–K8b — the int8 site convs of the quantized Johnson path.
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
// K2–K5 and K8 are one templated core (site_kernel): a 3x3 conv of int8
// codes at stride 1 or 2 over a 1-pixel halo (pixel reflect or edge copy),
// accumulated in int32 with __dp4a, with a prologue (how the int8 tile is
// made) and an epilogue (what is written) chosen at compile time. K8a/K8b are
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
// 1.5e11 ops each) and K6/K7 (3.2e11 ops each) are bound by their bytes. This
// code runs __dp4a on the CUDA cores, whose peak is ~62 TMAC/s, 16x below
// the tensor cores: it is bound by the dp4a rate (~3.1 ms a res site, 20x the
// bound). A simple correct core comes first; IMMA/wgmma tensor-core MMAs fed
// by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8, kTW = 16;          // output tile, pixels
constexpr int kCOT = 64;                  // output channels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Prologue { kQuant = 0, kSkip = 1, kCodes = 2 };
enum Epilogue { kRawStats = 0, kEmitS8 = 1, kSiteS8 = 2 };
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
  const float* ep[kEpRows];      // [CO] kSiteS8: aa, ac, qa, qc, ya, yc (null if unused)
  void* out;                     // bf16 or int8 [B,H,W,CO]
  __nv_bfloat16* vout;           // kSkip: v [B,H,W,C], or null
  float* part;                   // kRawStats: [B, tiles, 2, CO]
  int B, Hi, Wi;                 // input grid
  int H, W, CO;                  // output grid
  float lo;                      // quantize floor of the prologue
  float qlo;                     // kSiteS8: floor of the s8 emit
  int flags;                     // kSiteS8: SiteFlags
  int halo;                      // 0 pixel reflect, 1 edge copy
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

__device__ __forceinline__ int quantize(float v, float a, float c, float lo) {
  const float q = rintf(__fadd_rn(__fmul_rn(v, a), c));
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

template <int C, int S>
constexpr size_t smem_bytes() {
  return sizeof(int32_t) * (9 * (C / 4) * kCOT + Tile<S>::HR * Tile<S>::HC * (C / 4 + 1)) +
         sizeof(float) * (4 * C + kWarps * 2 * kCOT + kEpRows * kCOT);
}

template <int C, int S, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 2) site_kernel(Args p) {
  constexpr int CW = C / 4;   // int32 words per pixel
  constexpr int PS = CW + 1;  // padded pixel stride in shared memory
  constexpr int HR = Tile<S>::HR, HC = Tile<S>::HC;
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_w = smem;                                   // [9][CW][kCOT]
  int32_t* s_x = s_w + 9 * CW * kCOT;                    // [HR][HC][PS]
  float* s_aff = reinterpret_cast<float*>(s_x + HR * HC * PS);  // a, c, a2, c2 [C]
  float* s_sum = s_aff + 4 * C;                          // [kWarps][2][kCOT]
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
      if (PRO == kSkip) {
        s_aff[2 * C + i] = p.a2[b * C + i];
        s_aff[3 * C + i] = p.c2[b * C + i];
      }
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
    if (PRO == kCodes) {
      word = *reinterpret_cast<const int32_t*>(static_cast<const int8_t*>(p.x) + off);
    } else {
      float v[4];
      load4_bf16(static_cast<const __nv_bfloat16*>(p.x) + off, v);
      if (PRO == kSkip) {
        float y[4];
        load4_bf16(p.yp + off, y);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ch = 4 * wd + k;
          const float t = bf16_round(__fadd_rn(__fmul_rn(v[k], s_aff[2 * C + ch]),
                                               s_aff[3 * C + ch]));
          v[k] = bf16_round(__fadd_rn(t, y[k]));
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
  float ws[8], bi[8], ra[8], rc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ws[j] = p.ws[cb + j];
    bi[j] = p.bias[cb + j];
    if (EPI == kEmitS8) {
      ra[j] = p.ra[cb + j];
      rc[j] = p.rc[cb + j];
    }
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
  const size_t smem = smem_bytes<C, S>();
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

// stride 1: the res and decoder sites, C in {64, 128}
template <int PRO, int EPI>
int launch(const Args& p, int C, float* sums, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128) return launch_c<128, 1, PRO, EPI>(p, sums, s);
  if (C == 64) return launch_c<64, 1, PRO, EPI>(p, sums, s);
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
  return p;
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

// K2: s8 codes out[b,y,x,o] = clamp(rint(bf16(acc*ws + bias)*qa + qc), 0, 127).
extern "C" int res_site_s8o_launch(const void* x, const float* a, const float* c,
                                   const int32_t* wk, const float* ws, const float* bias,
                                   const float* qa, const float* qc, int8_t* out, int B,
                                   int H, int W, int C, int CO, float lo, int halo,
                                   void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.ra = qa; p.rc = qc; p.out = out;
  return launch<kQuant, kEmitS8>(p, C, nullptr, stream);
}

// K3: f = bf16(acc*ws + bias) from s8 codes xq; then, per `flags`,
// f = bf16(f*aa + ac) (kFAff); f = bf16(f + y) with y first replaced by
// bf16(max(y*ya + yc, 0)) (kFYadd, kFYaff); out = bf16 f, or s8 codes
// clamp(rint(f*qa + qc), qlo, 127) (kFS8Out). Unused rows may be null.
extern "C" int site_s8_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                              const float* bias, const float* aa, const float* ac,
                              const __nv_bfloat16* y, const float* ya, const float* yc,
                              const float* qa, const float* qc, void* out, int B, int H,
                              int W, int C, int CO, int flags, float qlo, int halo,
                              void* stream) {
  Args p = make_args(B, H, W, CO, 0.0f, halo);
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.yadd = y; p.out = out;
  p.ep[0] = aa; p.ep[1] = ac; p.ep[2] = qa; p.ep[3] = qc; p.ep[4] = ya; p.ep[5] = yc;
  p.flags = flags;
  p.qlo = qlo;
  return launch<kCodes, kSiteS8>(p, C, nullptr, stream);
}

// K4: bf16 raw out and sums[b, 0|1, o] = [Σ, Σ²] of it; part is scratch.
extern "C" int res_site_launch(const void* x, const float* a, const float* c,
                               const int32_t* wk, const float* ws, const float* bias,
                               __nv_bfloat16* out, float* part, float* sums, int B, int H,
                               int W, int C, int CO, float lo, int halo, void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.x = x; p.a = a; p.c = c; p.wk = wk; p.ws = ws; p.bias = bias;
  p.out = out; p.part = part;
  return launch<kQuant, kRawStats>(p, C, sums, stream);
}

// K5: K4 on v = bf16(bf16(r2*a2 + c2) + yp); v is written to vout unless null.
extern "C" int res_site_skip_launch(const void* r2, const __nv_bfloat16* yp,
                                    const float* a, const float* c, const float* a2,
                                    const float* c2, const int32_t* wk, const float* ws,
                                    const float* bias, __nv_bfloat16* out,
                                    __nv_bfloat16* vout, float* part, float* sums, int B,
                                    int H, int W, int C, int CO, float lo, int halo,
                                    void* stream) {
  Args p = make_args(B, H, W, CO, lo, halo);
  p.x = r2; p.yp = yp; p.a = a; p.c = c; p.a2 = a2; p.c2 = c2; p.wk = wk; p.ws = ws;
  p.bias = bias; p.out = out; p.vout = vout; p.part = part;
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
