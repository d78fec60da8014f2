// K3: farthest-pair column statistics of each cluster slot.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// centroid_pallas.py::pair_stats_pallas_dyn (body _kernel_v5_dyn).  For a
// slot with members, centre them (pc = (p - mean) * member), take
//   d2[i, j] = (sq_i + sq_j) - 2 * ((x_i x_j + y_i y_j) + z_i z_j),
//   sq_i = (x_i^2 + y_i^2) + z_i^2,
// masked to member pairs i < j (else -1), and return per column j
// colmax[j] = max_i d2m[i, j] and firstrow[j] = the smallest i reaching it.
// A slot without members returns the init values (-1, P) at once: this
// replaces the TPU kernel's dynamic loop bound (last active slot + 1).
//
// What bounds it on the H100: nothing much -- P^2/2 = 74k pair terms per
// active slot at P = 384, a handful of active slots per frame; the cost is
// the launch.  Design: one CTA per slot; the centred members sit in shared
// memory; each thread owns columns j and scans rows i < j in ascending
// order with a strict '>' update, so ties keep the first row.  The gram is
// computed in the fixed order written above, with __fmul_rn / __fadd_rn /
// __fsub_rn (no FMA), so it matches the plain PyTorch version bit for bit.
// The member mean is a sequential f64 sum of the f32 coordinates, rounded
// to f32, divided by the f32 member count.  Mean, centring and column scan
// live in pair_scan.cuh, shared with K10 (circumcenter.cu).
// Selection, the line scan and the determinant stay in eager PyTorch
// (ops/centroid.py::circumcenter_from_pair_stats).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_scan.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pair_stats_kernel(const float* __restrict__ mpts, const uint8_t* __restrict__ mm,
                  int P, float* __restrict__ colmax, int* __restrict__ firstrow) {
  extern __shared__ float sh[];  // pcx, pcy, pcz, sq: 4 * P floats
  __shared__ float s_mean[3];
  __shared__ int s_cnt;
  float* pcx = sh;
  float* pcy = sh + P;
  float* pcz = sh + 2 * P;
  float* sq = sh + 3 * P;
  const int c = blockIdx.x;
  const float* M = mpts + (size_t)c * P * 3;
  const uint8_t* mk = mm + (size_t)c * P;
  float* cm = colmax + (size_t)c * P;
  int* fr = firstrow + (size_t)c * P;

  member_mean(M, mk, P, s_mean, &s_cnt);
  __syncthreads();
  if (s_cnt == 0) {
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
      cm[j] = -1.0f;
      fr[j] = P;
    }
    return;
  }
  centre_members(M, mk, P, s_mean, pcx, pcy, pcz, sq);
  __syncthreads();
  for (int j = threadIdx.x; j < P; j += blockDim.x)
    column_max(j, mk, pcx, pcy, pcz, sq, &cm[j], &fr[j]);
}

}  // namespace

// mpts (C, P, 3) f32, mm (C, P) u8 -> colmax (C, P) f32, firstrow (C, P) i32.
extern "C" int motl_pair_stats(const float* mpts, const uint8_t* mm, int C, int P,
                               float* colmax, int* firstrow, void* stream) {
  const size_t smem = (size_t)4 * P * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pair_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_stats_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(mpts, mm, P, colmax, firstrow);
  return (int)cudaGetLastError();
}
