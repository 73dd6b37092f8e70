// K1 — DIS inverse-search Gauss–Newton iterations, 8 lanes per 8x8 patch.
//
// Replaces the TPU kernel neuralstyletransferv1_tpu/ops/dis_flow.py
// ::_iter_search_pallas / _iter_kernel. For every patch it runs `iters`
// Gauss–Newton steps on an offset o in [0, 2R - 1e-3] inside the patch's
// pre-warped (8+2R)^2 neighbourhood `nb`, from o = u0 - lo, then writes
// u = o + lo and the photometric residual mean|warped - t|.
//
// What bounds it on an H100: latency and occupancy, not bandwidth. A
// finest-level launch at 1080p (ds2 flow, 8 frame pairs) has ~15k patches
// and reads ~35 MB (nb is 1.6 KB a patch; t, gx, gy 0.77 KB), one pass over
// device memory (~10 us at 3.35 TB/s); the coarsest has 144 patches. The
// iterations are a serial chain of 16 + 1 dependent steps, each a bilinear
// sample of the patch, two 64-term reductions and a 2x2 solve.
//
// Design (dis_iter_kernel):
//   - 8 lanes a patch, 4 patches a warp, 32 patches a 256-thread block: lane
//     j of a patch's group holds patch column j of t, gx and gy in
//     registers (8 pixels each; a warp's load of one row of them reads 4
//     whole 32-byte sectors) and takes that column's 8 bilinear samples a
//     step. Each J sum adds the column's products as the first core's lanes
//     did (rows i and i + 4 first, then (0, 2) and (1, 3), then the two),
//     then 3 __shfl_xor_sync levels across the group's columns (xor 4, 2,
//     1), the first core's last three: the sums, and so every offset and
//     residual, are the first core's bit for bit, and the 4 patches of a
//     warp share every shuffle. At the finest 1080p level the 472 blocks
//     fit in one wave (4 blocks an SM);
//   - the warp's 4 neighbourhoods are staged in shared memory by 16-byte
//     loads, interleaved word by word (element (r, c) of patch slot q at
//     word 4(rS + c) + q, S = nbw | 1 odd): a sample's read by the 32 lanes
//     (8 consecutive columns of 4 patches at any offsets) falls in 32
//     distinct banks, and so do the staging stores (lane l stores rows
//     l / 4 + 8k of slot l % 4);
//   - the bilinear sample reads rows floor(oy) + 0..8 at columns floor(ox)
//     + j and + j + 1 straight from shared memory, rows first, then
//     columns, as the reference (the TPU kernel's one-hot row/column
//     selection was a lane layout workaround whose extra terms are exact
//     zeros); every lane of a group holds the same offset (no divergence);
//   - 1/det (__fdiv_rn) and o0 = u0 - lo are computed here, so a level is
//     one launch;
//   - a tail slot (a patch index past n) computes on the last patch and
//     skips its store: no lane leaves before the last shuffle;
//   - floorf only; the build uses --fmad=false so the sampling arithmetic
//     rounds exactly where the reference's separate multiplies and adds do.
// dis_iter_prev_kernel is the first core (one warp a patch, 8 patches a
// block, 2 samples a lane and 5-level shuffles; 1/det and o0 from the
// caller), kept for timing only (dis_iter_prev_launch).

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kGroup = 8;                               // lanes a patch (one a patch column)
constexpr int kSlots = 32 / kGroup;                     // patches a warp
constexpr int kPatchesPerBlock = kWarpsPerBlock * kSlots;

// the odd row stride (in elements) of a staged neighbourhood
__host__ __device__ constexpr int nb_stride(int nbw) { return nbw | 1; }

// the shared-memory word of element (r, c) of patch slot q of a warp's
// interleaved neighbourhoods
__device__ __forceinline__ int nb_word(int r, int c, int q, int S) { return ((r * S + c) << 2) + q; }

// the sum over the 8 lanes of a patch's group (every lane gets it)
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int m = kGroup / 2; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// column j of the patch at offset (iy, ix) + (fy, fx), j folded into ix:
// its 8 bilinear samples (rows first, then columns, each as the first
// core's sample) from the warp's staged neighbourhoods
__device__ __forceinline__ void sample_col(float (&w)[kPatch], const float* s, int S, int q,
                                           int iy, int ix, float fy, float fx) {
  const float* c0 = s + nb_word(iy, ix, q, S);
  float top0 = c0[0], top1 = c0[4];
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const float bot0 = c0[(i + 1) * 4 * S], bot1 = c0[(i + 1) * 4 * S + 4];
    const float a = (1.0f - fy) * top0 + fy * bot0;
    const float b = (1.0f - fy) * top1 + fy * bot1;
    w[i] = (1.0f - fx) * a + fx * b;
    top0 = bot0;
    top1 = bot1;
  }
}

// the sum over a patch of a column's 8 terms v: (v0 + v4) + (v2 + v6) and
// (v1 + v5) + (v3 + v7) added, then over the group's columns (the first
// core's order: its lanes held rows i and i + 4, summed by xor 16 and 8)
__device__ __forceinline__ float patch_sum(const float (&v)[kPatch]) {
  const float a0 = v[0] + v[4], a1 = v[1] + v[5], a2 = v[2] + v[6], a3 = v[3] + v[7];
  return group_sum((a0 + a2) + (a1 + a3));
}

// column j of an 8 x 8 patch
__device__ __forceinline__ void load_col(float (&v)[kPatch], const float* src) {
#pragma unroll
  for (int i = 0; i < kPatch; ++i) v[i] = __ldg(src + i * kPatch);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
dis_iter_kernel(const float* __restrict__ nb, const float* __restrict__ t,
                const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ hxx, const float* __restrict__ hxy,
                const float* __restrict__ hyy, const float* __restrict__ det,
                const float* __restrict__ u0, const float* __restrict__ lo,
                float* __restrict__ u, float* __restrict__ res,
                int n, int nbw, int iters, float hi) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, j = lane & 7;  // patch slot, patch column
  const int S = nb_stride(nbw), nb_len = nbw * nbw;
  float* s = smem + warp * (4 * nbw * S);
  const long long p0 = ((long long)blockIdx.x * kWarpsPerBlock + warp) * kSlots;
  const long long last = (long long)n - 1;

  // staging: lane (qs, r0) = (lane & 3, lane >> 2) brings in rows r0, r0 +
  // 8, ... of patch slot qs, 16 bytes at a time (nbw % 4 == 0), else 4
  {
    const int qs = lane & 3, r0 = lane >> 2;
    const float* src = nb + min(p0 + qs, last) * nb_len;
    if ((nbw & 3) == 0) {
      for (int r = r0; r < nbw; r += 8)
        for (int c = 0; c < nbw; c += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src + r * nbw + c));
          float* d = s + nb_word(r, c, qs, S);
          d[0] = v.x; d[4] = v.y; d[8] = v.z; d[12] = v.w;
        }
    } else {
      for (int r = r0; r < nbw; r += 8)
        for (int c = 0; c < nbw; ++c) s[nb_word(r, c, qs, S)] = __ldg(src + r * nbw + c);
    }
  }

  const long long p = min(p0 + q, last);  // a tail slot computes on the last patch
  float tc[kPatch], gxc[kPatch], gyc[kPatch];
  load_col(tc, t + p * (kPatch * kPatch) + j);
  load_col(gxc, gx + p * (kPatch * kPatch) + j);
  load_col(gyc, gy + p * (kPatch * kPatch) + j);
  const float h_xx = hxx[p], h_xy = hxy[p], h_yy = hyy[p];
  const float idet = __fdiv_rn(1.0f, det[p]);
  const float lx = lo[2 * p], ly = lo[2 * p + 1];
  float ox = __fsub_rn(u0[2 * p], lx), oy = __fsub_rn(u0[2 * p + 1], ly);
  const float step = 0.5f * kPatch;
  __syncwarp();

  float w[kPatch], px[kPatch], py[kPatch];
  for (int it = 0; it < iters; ++it) {
    const float fyf = floorf(oy), fxf = floorf(ox);
    sample_col(w, s, S, q, (int)fyf, (int)fxf + j, oy - fyf, ox - fxf);
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
      const float r = w[i] - tc[i];
      px[i] = gxc[i] * r;
      py[i] = gyc[i] * r;
    }
    const float j0 = patch_sum(px), j1 = patch_sum(py);
    float dux = (h_yy * j0 - h_xy * j1) * idet;
    float duy = (h_xx * j1 - h_xy * j0) * idet;
    dux = fminf(fmaxf(dux, -step), step);
    duy = fminf(fmaxf(duy, -step), step);
    ox = fminf(fmaxf(ox - dux, 0.0f), hi);
    oy = fminf(fmaxf(oy - duy, 0.0f), hi);
  }

  const float fyf = floorf(oy), fxf = floorf(ox);
  sample_col(w, s, S, q, (int)fyf, (int)fxf + j, oy - fyf, ox - fxf);
#pragma unroll
  for (int i = 0; i < kPatch; ++i) px[i] = fabsf(w[i] - tc[i]);
  const float total = patch_sum(px);
  if (j == 0 && p0 + q <= last) {
    u[2 * p] = ox + lx;
    u[2 * p + 1] = oy + ly;
    res[p] = total * (1.0f / (kPatch * kPatch));
  }
}

// ---------------------------------------------------------------------------
// the first core (timing only): one warp a patch
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Bilinear sample of pixel (i, j) of the patch at offset (ox, oy) inside the
// nbw x nbw neighbourhood: rows first, then columns (the reference's order).
__device__ __forceinline__ float sample(const float* s, int nbw, int iy, int ix,
                                        float fy, float fx, int i, int j) {
  const float* r0 = s + (iy + i) * nbw + ix + j;
  const float* r1 = r0 + nbw;
  const float a = (1.0f - fy) * r0[0] + fy * r1[0];
  const float b = (1.0f - fy) * r0[1] + fy * r1[1];
  return (1.0f - fx) * a + fx * b;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dis_iter_prev_kernel(const float* __restrict__ nb, const float* __restrict__ t,
                     const float* __restrict__ gx, const float* __restrict__ gy,
                     const float* __restrict__ hxx, const float* __restrict__ hxy,
                     const float* __restrict__ hyy, const float* __restrict__ inv_det,
                     const float* __restrict__ o0, const float* __restrict__ lo,
                     float* __restrict__ u, float* __restrict__ res,
                     int n, int nbw, int iters, float hi) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n) return;  // the whole warp leaves together

  const int nb_len = nbw * nbw;
  float* s = smem + warp * nb_len;
  const float* src = nb + p * nb_len;
  for (int k = lane; k < nb_len; k += 32) s[k] = src[k];
  __syncwarp();

  const int i0 = lane >> 3, j = lane & 7, i1 = i0 + 4;
  const long long q = p * (kPatch * kPatch);
  const float t0 = t[q + lane], t1 = t[q + lane + 32];
  const float gx0 = gx[q + lane], gx1 = gx[q + lane + 32];
  const float gy0 = gy[q + lane], gy1 = gy[q + lane + 32];
  const float h_xx = hxx[p], h_xy = hxy[p], h_yy = hyy[p], idet = inv_det[p];
  float ox = o0[2 * p], oy = o0[2 * p + 1];
  const float step = 0.5f * kPatch;

  for (int it = 0; it < iters; ++it) {
    const float fyf = floorf(oy), fxf = floorf(ox);
    const int iy = (int)fyf, ix = (int)fxf;
    const float fy = oy - fyf, fx = ox - fxf;
    const float r0 = sample(s, nbw, iy, ix, fy, fx, i0, j) - t0;
    const float r1 = sample(s, nbw, iy, ix, fy, fx, i1, j) - t1;
    const float j0 = warp_sum(gx0 * r0 + gx1 * r1);
    const float j1 = warp_sum(gy0 * r0 + gy1 * r1);
    float dux = (h_yy * j0 - h_xy * j1) * idet;
    float duy = (h_xx * j1 - h_xy * j0) * idet;
    dux = fminf(fmaxf(dux, -step), step);
    duy = fminf(fmaxf(duy, -step), step);
    ox = fminf(fmaxf(ox - dux, 0.0f), hi);
    oy = fminf(fmaxf(oy - duy, 0.0f), hi);
  }

  const float fyf = floorf(oy), fxf = floorf(ox);
  const int iy = (int)fyf, ix = (int)fxf;
  const float fy = oy - fyf, fx = ox - fxf;
  const float e = fabsf(sample(s, nbw, iy, ix, fy, fx, i0, j) - t0) +
                  fabsf(sample(s, nbw, iy, ix, fy, fx, i1, j) - t1);
  const float total = warp_sum(e);
  if (lane == 0) {
    u[2 * p] = ox + lo[2 * p];
    u[2 * p + 1] = oy + lo[2 * p + 1];
    res[p] = total * (1.0f / (kPatch * kPatch));
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). All pointers are device
// pointers to contiguous float32 arrays: nb [n, nbw, nbw]; t, gx, gy
// [n, 8, 8]; hxx, hxy, hyy, det [n]; u0, lo, u [n, 2]; res [n]; nb, t, gx
// and gy 16-byte aligned, nbw even. Launches on `stream` and returns a CUDA
// error code.
extern "C" int dis_iter_launch(const float* nb, const float* t, const float* gx,
                               const float* gy, const float* hxx, const float* hxy,
                               const float* hyy, const float* det, const float* u0,
                               const float* lo, float* u, float* res, int n, int nbw, int iters,
                               float hi, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nbw < 10 || nbw % 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarpsPerBlock * 4 * nbw * nb_stride(nbw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dis_iter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kPatchesPerBlock - 1) / kPatchesPerBlock);
  dis_iter_kernel<<<grid, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      nb, t, gx, gy, hxx, hxy, hyy, det, u0, lo, u, res, n, nbw, iters, hi);
  return (int)cudaGetLastError();
}

// The first core, for timing only: inv_det [n] and o0 [n, 2] = u0 - lo come
// from the caller.
extern "C" int dis_iter_prev_launch(const float* nb, const float* t, const float* gx,
                                    const float* gy, const float* hxx, const float* hxy,
                                    const float* hyy, const float* inv_det, const float* o0,
                                    const float* lo, float* u, float* res, int n, int nbw,
                                    int iters, float hi, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kWarpsPerBlock * nbw * nbw * sizeof(float);
  const unsigned grid = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dis_iter_prev_kernel<<<grid, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      nb, t, gx, gy, hxx, hxy, hyy, inv_det, o0, lo, u, res, n, nbw, iters, hi);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a dis_iter_kernel block at neighbourhood width nbw.
extern "C" int dis_iter_smem_bytes(int nbw) {
  return (int)((size_t)kWarpsPerBlock * 4 * nbw * nb_stride(nbw) * sizeof(float));
}
