// K2–K5 — the int8 3x3 site convs of the quantized Johnson path.
//
// Replaces the TPU kernels of neuralstyletransferv1_tpu/models/s2d2_sites_i8.py:
//   K2 res_site_s8o   (_site_kernel_s8o)  quantize bf16 → conv → s8 codes
//   K3 site_s8        (_site_kernel_s8g)  s8 codes → conv → affine → + y
//   K4 res_site       (_site_kernel)      quantize bf16 → conv → bf16 + stats
//   K5 res_site_skip  (_site_kernel_skip) skip-combine + quantize → conv → bf16 + stats
// All four are one templated core: a 3x3 conv of int8 codes over a 1-pixel
// halo (pixel reflect or edge copy), accumulated in int32 with __dp4a, with
// a prologue (how the int8 tile is made) and an epilogue (what is written)
// chosen at compile time.
//
// Block = 256 threads = one 8x16-pixel output tile x 64 output channels of
// one image. The haloed 10x18-pixel input tile is quantized once into
// shared memory as packed 4-channel int32 words (channels innermost, a
// pixel stride of C/4+1 words so the four pixels a warp reads at once sit
// in four banks); the block's 64 output channels of weights, repacked on
// the host to [tap][C/4][CO] words, are staged next to it. Warp w computes
// output row w; lane l owns output channels 8*(l%8)..+7 of pixels
// 4*(l/8)..+3, i.e. 32 int32 accumulators, fed per tap and word by four
// scalar input loads and two 16-byte weight loads (the weight loads of the
// eight lanes that share pixels cover 256 contiguous bytes).
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
// What bounds it on an H100: a res site of the 1080p B=8 slice is 3.06e11
// int8 operations (0.155 ms at the 1979 TOP/s int8 tensor-core peak) and
// moves 0.4-1.6 GB (0.12-0.48 ms at 3.35 TB/s), so the site is bound by
// bytes or operations about equally. This core issues __dp4a on the CUDA
// cores, whose peak is ~62 TMAC/s, 16x below the tensor cores: it is bound
// by dp4a issue (~3.1 ms a res site, 20x the bound). A simple correct core
// comes first; IMMA/wgmma tensor-core MMAs fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8, kTW = 16;          // output tile, pixels
constexpr int kHR = kTH + 2, kHC = kTW + 2;  // haloed input tile
constexpr int kCOT = 64;                  // output channels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Prologue { kQuant = 0, kSkip = 1, kCodes = 2 };
enum Epilogue { kRawStats = 0, kEmitS8 = 1, kAffAdd = 2 };

struct Args {
  const void* x;                 // kQuant: bf16 x; kSkip: bf16 r2; kCodes: int8 [B,H,W,C]
  const __nv_bfloat16* yp;       // kSkip: bf16 residual [B,H,W,C]
  const __nv_bfloat16* yadd;     // kAffAdd: bf16 residual [B,H,W,CO]
  const float *a, *c;            // [B,C] quantize affine
  const float *a2, *c2;          // [B,C] skip-combine affine
  const int32_t* wk;             // [9, C/4, CO] packed int8 weights
  const float *ws, *bias;        // [CO] dequant row and conv bias
  const float *ra, *rc;          // [CO] kEmitS8: output quantize; kAffAdd: frozen affine
  void* out;                     // bf16 or int8 [B,H,W,CO]
  __nv_bfloat16* vout;           // kSkip: v [B,H,W,C], or null
  float* part;                   // kRawStats: [B, tiles, 2, CO]
  int B, H, W, CO;
  float lo;
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

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(int32_t) * (9 * (C / 4) * kCOT + kHR * kHC * (C / 4 + 1)) +
         sizeof(float) * (4 * C + kWarps * 2 * kCOT);
}

template <int C, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 2) site_kernel(Args p) {
  constexpr int CW = C / 4;   // int32 words per pixel
  constexpr int PS = CW + 1;  // padded pixel stride in shared memory
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_w = smem;                                   // [9][CW][kCOT]
  int32_t* s_x = s_w + 9 * CW * kCOT;                    // [kHR][kHC][PS]
  float* s_aff = reinterpret_cast<float*>(s_x + kHR * kHC * PS);  // a, c, a2, c2 [C]
  float* s_sum = s_aff + 4 * C;                          // [kWarps][2][kCOT]

  const int tid = threadIdx.x;
  const int tiles_x = (p.W + kTW - 1) / kTW;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTH, tx0 = (tile % tiles_x) * kTW;
  const int co0 = blockIdx.y * kCOT;
  const int b = blockIdx.z;

  for (int i = tid; i < 9 * CW * kCOT; i += kThreads)
    s_w[i] = p.wk[(size_t)(i / kCOT) * p.CO + co0 + i % kCOT];
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
  for (int i = tid; i < kHR * kHC * CW; i += kThreads) {
    const int wd = i % CW, pix = i / CW;
    const int hc = pix % kHC, hr = pix / kHC;
    const int gy = ty0 + hr - 1, gx = tx0 + hc - 1;
    const int sy = src_index(gy, p.H, p.halo), sx = src_index(gx, p.W, p.halo);
    const size_t off = (((size_t)b * p.H + sy) * p.W + sx) * C + 4 * wd;
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
      uint32_t packed = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = 4 * wd + k;
        const int q = quantize(v[k], s_aff[ch], s_aff[C + ch], p.lo);
        packed |= (uint32_t)(q & 0xff) << (8 * k);
      }
      word = (int32_t)packed;
    }
    s_x[(hr * kHC + hc) * PS + wd] = word;
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
    const int32_t* xr = s_x + ((warp + dy) * kHC + 4 * px + dx) * PS;
    const int4* wr = reinterpret_cast<const int4*>(s_w + tap * CW * kCOT + cg * 8);
#pragma unroll 8
    for (int wd = 0; wd < CW; ++wd) {
      int xv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = xr[k * PS + wd];
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
    if (EPI != kRawStats) {
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
      float y[8];
      load4_bf16(p.yadd + o, y);
      load4_bf16(p.yadd + o + 4, y + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = bf16_round(__fadd_rn(__fmul_rn(f[j], ra[j]), rc[j]));
        f[j] = __fadd_rn(t, y[j]);
      }
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
      store4_bf16(out, f);
      store4_bf16(out + 4, f + 4);
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

template <int C, int PRO, int EPI>
int launch_c(const Args& p, float* sums, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>();
  auto kern = site_kernel<C, PRO, EPI>;
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

template <int PRO, int EPI>
int launch(const Args& p, int C, float* sums, void* stream) {
  if (p.B <= 0 || p.H < 2 || p.W < 2 || p.CO <= 0 || p.CO % kCOT != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128) return launch_c<128, PRO, EPI>(p, sums, s);
  if (C == 64) return launch_c<64, PRO, EPI>(p, sums, s);
  return (int)cudaErrorInvalidValue;
}

Args make_args(int B, int H, int W, int CO, float lo, int halo) {
  Args p = {};
  p.B = B;
  p.H = H;
  p.W = W;
  p.CO = CO;
  p.lo = lo;
  p.halo = halo;
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every pointer is a device
// pointer to a contiguous array as the comments of Args describe; each
// launches on `stream` and returns a CUDA error code (0 on success).

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

// K3: out = bf16(bf16(bf16(acc*ws + bias)*aa + ac) + y) from s8 codes xq.
extern "C" int site_s8_launch(const int8_t* xq, const int32_t* wk, const float* ws,
                              const float* bias, const float* aa, const float* ac,
                              const __nv_bfloat16* y, __nv_bfloat16* out, int B, int H,
                              int W, int C, int CO, int halo, void* stream) {
  Args p = make_args(B, H, W, CO, 0.0f, halo);
  p.x = xq; p.wk = wk; p.ws = ws; p.bias = bias; p.ra = aa; p.rc = ac;
  p.yadd = y; p.out = out;
  return launch<kCodes, kAffAdd>(p, C, nullptr, stream);
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
