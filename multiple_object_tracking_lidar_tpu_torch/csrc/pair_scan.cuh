// The farthest-pair scan of one cluster slot, shared by K3 (centroid.cu)
// and K10 (circumcenter.cu), so that both compute d2 in one written order:
//   mean  = f32(sequential f64 sum of the member coordinates) / f32(count)
//   pc_i  = p_i - mean for members, 0 elsewhere
//   sq_i  = (x_i^2 + y_i^2) + z_i^2
//   d2[i, j] = (sq_i + sq_j) - 2 * ((x_i x_j + y_i y_j) + z_i z_j)
// with every product and sum rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA): the plain PyTorch version (ops/centroid_cuda.py::
// pair_stats_plain) runs the same elementwise ops.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Threads 0-2 each sum one axis of the members of M (P, 3); s_mean and
// s_cnt hold the mean and the member count after the caller's barrier.
static __device__ __forceinline__ void member_mean(const float* __restrict__ M,
                                                   const uint8_t* __restrict__ mk, int P,
                                                   float* s_mean, int* s_cnt) {
  if (threadIdx.x < 3) {
    double acc = 0.0;
    int cnt = 0;
    for (int i = 0; i < P; ++i) {
      if (mk[i]) {
        acc += (double)M[3 * i + threadIdx.x];
        ++cnt;
      }
    }
    s_mean[threadIdx.x] = __double2float_rn(acc) / fmaxf((float)cnt, 1.0f);
    if (threadIdx.x == 0) *s_cnt = cnt;
  }
}

// The centred members and their squared norms, into shared memory (valid
// after the caller's barrier).
static __device__ __forceinline__ void centre_members(const float* __restrict__ M,
                                                      const uint8_t* __restrict__ mk, int P,
                                                      const float* s_mean, float* pcx,
                                                      float* pcy, float* pcz, float* sq) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const bool m = mk[i] != 0;
    const float x = m ? __fsub_rn(M[3 * i], s_mean[0]) : 0.0f;
    const float y = m ? __fsub_rn(M[3 * i + 1], s_mean[1]) : 0.0f;
    const float z = m ? __fsub_rn(M[3 * i + 2], s_mean[2]) : 0.0f;
    pcx[i] = x;
    pcy[i] = y;
    pcz[i] = z;
    sq[i] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  }
}

// Column j: colmax = max over member rows i < j of d2[i, j] and firstrow =
// the smallest row reaching it (rows in ascending order, strict '>'); -1
// and row 0 where column j has no member pair.
static __device__ __forceinline__ void column_max(int j, const uint8_t* __restrict__ mk,
                                                  const float* pcx, const float* pcy,
                                                  const float* pcz, const float* sq,
                                                  float* colmax, int* firstrow) {
  float best = -1.0f;
  int row = 0;
  if (mk[j]) {
    const float xj = pcx[j], yj = pcy[j], zj = pcz[j], sqj = sq[j];
    for (int i = 0; i < j; ++i) {
      if (!mk[i]) continue;
      const float g = __fadd_rn(__fadd_rn(__fmul_rn(pcx[i], xj), __fmul_rn(pcy[i], yj)),
                                __fmul_rn(pcz[i], zj));
      const float d2 = __fsub_rn(__fadd_rn(sq[i], sqj), __fmul_rn(2.0f, g));
      if (d2 > best) {
        best = d2;
        row = i;
      }
    }
  }
  *colmax = best;
  *firstrow = row;
}
