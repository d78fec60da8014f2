// K3: farthest-pair column statistics of each cluster slot.
//
// Replaces the Pallas kernel multiple_object_tracking_lidar_tpu/ops/
// centroid_pallas.py::pair_stats_pallas_dyn (body _kernel_v5_dyn).  For a
// slot with members, centre them (pc = p - mean), take
//   d2[i, j] = (sq_i + sq_j) - 2 * ((x_i x_j + y_i y_j) + z_i z_j),
//   sq_i = (x_i^2 + y_i^2) + z_i^2,
// over member pairs i < j, and return per column j colmax[j] = the
// maximum d2 by the serial rule (ascending rows, strict '>' from -1: a NaN
// never wins) and firstrow[j] = the first row reaching it; (-1, 0) for a
// column without a member pair, (-1, P) for every column of a slot without
// members.  The empty slot replaces the TPU kernel's dynamic loop bound
// (last active slot + 1).
//
// No tracking path launches it: they run the whole circumcenter feature in
// one launch (K3f, circumcenter.cu).  This entry keeps the column
// statistics for pair_stats and the JAX-named entries
// (ops/centroid_pallas.py).
//
// What bounds it on the H100: the launch -- a handful of active slots of
// n^2 / 2 pair terms (74k at n = 384) per call.  Design: one CTA of 512
// threads per slot; the compaction, staging, mean and banded pair scan of
// pair_scan.cuh (shared with K10 and K3f, so the three compute d2 in one
// order); the compacted columns' statistics are then spread back over the
// slot's P lanes.  An empty slot writes its init values and returns before
// reading a coordinate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_scan.cuh"

namespace {

using namespace pair_scan;

__global__ void __launch_bounds__(kThreads)
pair_stats_kernel(const float* __restrict__ mpts, const uint8_t* __restrict__ mm,
                  int P, float* __restrict__ colmax, int* __restrict__ firstrow) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ Scratch<float> ss;
  const Slot<float> s = slot_layout<float>(sh, P);
  const int c = blockIdx.x;
  float* cm = colmax + (size_t)c * P;
  int* fr = firstrow + (size_t)c * P;

  const int n = compact_members(mm + (size_t)c * P, P, s, ss);
  if (n == 0) {
    for (int j = threadIdx.x; j < P; j += kThreads) {
      cm[j] = -1.0f;
      fr[j] = P;
    }
    return;
  }
  scan_slot(mpts + (size_t)c * P * 3, P, n, s, ss);
  for (int j = threadIdx.x; j < P; j += kThreads) {
    const int r = s.rank[j];
    cm[j] = r >= 0 ? s.cm[r] : -1.0f;
    fr[j] = r >= 0 ? s.fr[r] : 0;
  }
}

}  // namespace

// mpts (C, P, 3) f32, mm (C, P) u8 -> colmax (C, P) f32, firstrow (C, P) i32.
extern "C" int motl_pair_stats(const float* mpts, const uint8_t* mm, int C, int P,
                               float* colmax, int* firstrow, void* stream) {
  if (C < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = slot_smem_bytes<float>(P);
  cudaError_t err = cudaFuncSetAttribute(
      pair_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pair_stats_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(mpts, mm, P, colmax, firstrow);
  return (int)cudaGetLastError();
}
