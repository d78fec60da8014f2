// K10: the whole circumcenter feature of each cluster slot in one kernel.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// centroid_pallas.py::circumcenter_xy_pallas (body _kernel -> _one), the
// reference's getCentroid (src/multiple_object_tracking_lidar.cpp:708-822):
//  1. the farthest member pair (Pi, Pj) by centred 3-D d2, the first
//     maximum in row-major (i, j) order: K3's column scan (pair_scan.cuh),
//     then i* = the smallest firstrow among the columns reaching the global
//     maximum and j* = the first such column whose firstrow is i*; (0, 0)
//     where no member pair exists;
//  2. the member farthest from the PiPj line in XY,
//       |ex (y - piy) - ey (x - pix)| / max(||(ex, ey)||, 1e-30),
//     skipping members equal in value to Pi or Pj; the first lane on ties,
//     lane 0 where no member qualifies;
//  3. the circumcenter of (Pi, Pj, Pk) by the determinant formula, Pi where
//     G == 0 (collinear).
// Output (C, 2) [x, y].  A slot without members takes i* = j* = k* = 0, as
// the plain version does (the JAX docstring calls that row garbage).
//
// The plain version is ops/centroid_cuda.py::pair_stats_plain followed by
// ops/centroid.py::circumcenter_from_pair_stats, and K10 equals it bit for
// bit: the same ops in the same order, every product, sum, quotient and
// root spelled __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn.
// That spelling is the point: Mosaic contracted a*b - c*d into an FMA in the
// TPU's all-in-kernel version, whose ~1e-8 residual broke the G == 0 test
// (centroid_pallas.py:185-191); here nothing is contracted.  The line
// distance divides by the clamped norm rather than multiplying by its
// reciprocal, as the JAX kernel does (:84): the reciprocal would move the
// argmax ties.
//
// What bounds it on the H100: the launch -- a handful of active slots of
// P^2/2 pair terms (74k at P = 384) and one O(P) line scan each; the
// (C, P) colmax / firstrow that K3 writes for the eager selection stay in
// shared memory here, and the eager chain of ~40 small launches after K3
// becomes none.  Design: one CTA of 256 threads per slot; a slot without
// members returns at once (as K3's empty slots); the reductions over the
// slot's columns and lanes are warp shuffles plus one shared exchange.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Block-wide maximum (non-NaN values) / minimum; every thread of the CTA
// calls them in the same order and gets the result.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  __syncthreads();  // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = red[w] > r ? red[w] : r;
  return r;
}

__device__ int block_min(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < kWarps; ++w) r = min(r, red[w]);
  return r;
}

__global__ void __launch_bounds__(kThreads)
circumcenter_kernel(const float* __restrict__ mpts, const uint8_t* __restrict__ mm,
                    int P, float* __restrict__ out) {
  extern __shared__ float sh[];  // pcx, pcy, pcz, sq, colmax: 5P floats; firstrow: P ints
  __shared__ float s_mean[3];
  __shared__ int s_cnt;
  __shared__ float s_redf[kWarps];
  __shared__ int s_redi[kWarps];
  float* pcx = sh;
  float* pcy = sh + P;
  float* pcz = sh + 2 * P;
  float* sq = sh + 3 * P;
  float* cm = sh + 4 * P;
  int* fr = reinterpret_cast<int*>(sh + 5 * P);
  const int c = blockIdx.x;
  const float* M = mpts + (size_t)c * P * 3;
  const uint8_t* mk = mm + (size_t)c * P;

  member_mean(M, mk, P, s_mean, &s_cnt);
  __syncthreads();
  int i_star = 0, j_star = 0, k_star = 0;
  if (s_cnt > 0) {
    // 1. the farthest pair
    centre_members(M, mk, P, s_mean, pcx, pcy, pcz, sq);
    __syncthreads();
    float local = -INFINITY;
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
      column_max(j, mk, pcx, pcy, pcz, sq, &cm[j], &fr[j]);
      local = cm[j] > local ? cm[j] : local;
    }
    const float gmax = block_max(local, s_redf);
    if (gmax > -0.5f) {
      int li = P;
      for (int j = threadIdx.x; j < P; j += blockDim.x)
        if (cm[j] == gmax) li = min(li, fr[j]);
      i_star = block_min(li, s_redi);
      int lj = P;
      for (int j = threadIdx.x; j < P; j += blockDim.x)
        if (cm[j] == gmax && fr[j] == i_star) lj = min(lj, j);
      j_star = block_min(lj, s_redi);
    }

    // 2. the member farthest from the PiPj line in XY
    const float pix = M[3 * i_star], piy = M[3 * i_star + 1], piz = M[3 * i_star + 2];
    const float pjx = M[3 * j_star], pjy = M[3 * j_star + 1], pjz = M[3 * j_star + 2];
    const float ex = __fsub_rn(pjx, pix), ey = __fsub_rn(pjy, piy);
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
    const float den = norm < 1e-30f ? 1e-30f : norm;
    float best = -INFINITY;
    int lk = P;
    for (int m = threadIdx.x; m < P; m += blockDim.x) {
      const float x = M[3 * m], y = M[3 * m + 1], z = M[3 * m + 2];
      const float cross = fabsf(__fsub_rn(__fmul_rn(ex, __fsub_rn(y, piy)),
                                          __fmul_rn(ey, __fsub_rn(x, pix))));
      const bool eq_i = x == pix && y == piy && z == piz;
      const bool eq_j = x == pjx && y == pjy && z == pjz;
      const float ld = (mk[m] && !eq_i && !eq_j) ? __fdiv_rn(cross, den) : -1.0f;
      if (ld > best) {
        best = ld;
        lk = m;
      }
    }
    const float ld_max = block_max(best, s_redf);
    k_star = block_min(best == ld_max ? lk : P, s_redi);
  }

  // 3. the circumcenter determinant
  if (threadIdx.x == 0) {
    const float pix = M[3 * i_star], piy = M[3 * i_star + 1];
    const float pjx = M[3 * j_star], pjy = M[3 * j_star + 1];
    const float pkx = M[3 * k_star], pky = M[3 * k_star + 1];
    const float a = __fsub_rn(pjx, pix);
    const float b = __fsub_rn(pjy, piy);
    const float cc = __fsub_rn(pkx, pix);
    const float d = __fsub_rn(pky, piy);
    const float e = __fadd_rn(__fmul_rn(a, __fadd_rn(pix, pjx)), __fmul_rn(b, __fadd_rn(piy, pjy)));
    const float f = __fadd_rn(__fmul_rn(cc, __fadd_rn(pix, pkx)), __fmul_rn(d, __fadd_rn(piy, pky)));
    const float g = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(a, __fsub_rn(pky, pjy)),
                                              __fmul_rn(b, __fsub_rn(pkx, pjx))));
    const bool collinear = g == 0.0f;
    out[2 * c] = collinear ? pix : __fdiv_rn(__fsub_rn(__fmul_rn(d, e), __fmul_rn(b, f)), g);
    out[2 * c + 1] = collinear ? piy : __fdiv_rn(__fsub_rn(__fmul_rn(a, f), __fmul_rn(cc, e)), g);
  }
}

}  // namespace

// mpts (C, P, 3) f32, mm (C, P) u8 -> out (C, 2) f32 circumcenter [x, y].
extern "C" int motl_circumcenter(const float* mpts, const uint8_t* mm, int C, int P,
                                 float* out, void* stream) {
  const size_t smem = (size_t)6 * P * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      circumcenter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  circumcenter_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(mpts, mm, P, out);
  return (int)cudaGetLastError();
}
