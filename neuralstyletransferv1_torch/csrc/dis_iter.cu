// K1 — DIS inverse-search Gauss–Newton iterations, one warp per 8x8 patch.
//
// Replaces the TPU kernel neuralstyletransferv1_tpu/ops/dis_flow.py
// ::_iter_search_pallas / _iter_kernel. For every patch it runs `iters`
// Gauss–Newton steps on an offset o in [0, 2R - 1e-3] inside the patch's
// pre-warped (8+2R)^2 neighbourhood `nb`, then writes u = o + lo and the
// photometric residual mean|warped - t|.
//
// What bounds it on an H100: latency and occupancy, not bandwidth. A
// finest-level launch at 1080p (ds2 flow, 8 frame pairs) has ~15k patches
// and reads ~35 MB (nb is 1.6 KB a patch; t, gx, gy 0.77 KB), one pass over
// device memory (~10 us at 3.35 TB/s). The iterations are a serial chain of
// 16 dependent steps, each a bilinear sample, two 64-term reductions and a
// 2x2 solve; nothing in the chain can be batched across steps.
//
// Design (simple and right first):
//   - one warp per patch, 8 patches per 256-thread block, so every SM keeps
//     many independent chains in flight to hide the shuffle/shared latency;
//   - the patch's nb is staged once in shared memory (1.6 KB), t/gx/gy stay
//     in registers: lane l owns pixels l and l + 32 (rows l/8 and l/8 + 4,
//     column l%8);
//   - the bilinear sample reads the four taps straight from shared memory at
//     floor(o); the TPU kernel's one-hot row/column selection was a lane
//     layout workaround whose extra terms are exact zeros, so the values are
//     the same;
//   - J is reduced with __shfl_xor_sync, so every lane holds the step and
//     the offset stays warp-uniform (no divergence, no shared write-back);
//   - floorf only; the build uses --fmad=false so the sampling arithmetic
//     rounds exactly where the reference's separate multiplies and adds do.
// A later step reads nb straight from the padded pre-warped image instead of
// the materialised [N,20,20] stack.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 8;
constexpr int kWarpsPerBlock = 8;

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
dis_iter_kernel(const float* __restrict__ nb, const float* __restrict__ t,
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

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers to contiguous float32 arrays: nb [n, nbw, nbw]; t, gx, gy
// [n, 8, 8]; hxx, hxy, hyy, inv_det [n]; o0, lo, u [n, 2]; res [n].
// Launches on `stream` and returns cudaGetLastError().
extern "C" int dis_iter_launch(const float* nb, const float* t, const float* gx,
                               const float* gy, const float* hxx, const float* hxy,
                               const float* hyy, const float* inv_det,
                               const float* o0, const float* lo, float* u,
                               float* res, int n, int nbw, int iters, float hi,
                               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)kWarpsPerBlock * nbw * nbw * sizeof(float);
  const unsigned grid = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dis_iter_kernel<<<grid, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      nb, t, gx, gy, hxx, hxy, hyy, inv_det, o0, lo, u, res, n, nbw, iters, hi);
  return (int)cudaGetLastError();
}
