// K10 and K3f: the whole circumcenter feature of each cluster slot in one
// kernel body, templated on the output.
//
// K10 (motl_circumcenter, out (C, 2) [x, y]) replaces the Pallas kernel
// multiple_object_tracking_lidar_tpu/ops/centroid_pallas.py::
// circumcenter_xy_pallas (body _kernel -> _one).  K3f
// (motl_circumcenter_features, out (C, 4) [x, y, 0, t]) is the tracking
// paths' feature: it replaces what the JAX pipeline runs as
// centroid_pallas.py::circumcenter_features_table_pallas_v2 -- the Pallas
// pair stats (pair_stats_pallas_dyn, body _kernel_v5_dyn) and the jnp
// selection, line scan and determinant after them -- in one launch that
// reads t on the device.  Both are the reference's getCentroid
// (src/multiple_object_tracking_lidar.cpp:708-822):
//  1. the farthest member pair (Pi, Pj) by centred 3-D d2, the first
//     maximum in row-major (i, j) order: pair_scan.cuh's column scan, then
//     i* = the smallest firstrow among the columns reaching the global
//     maximum and j* = the first such column whose firstrow is i*; (0, 0)
//     where no member pair exists;
//  2. the member farthest from the PiPj line in XY,
//       |ex (y - piy) - ey (x - pix)| / max(||(ex, ey)||, 1e-30),
//     skipping members equal in value to Pi or Pj and NaN distances; the
//     first lane on ties, lane 0 where no member qualifies;
//  3. the circumcenter of (Pi, Pj, Pk) by the determinant formula, Pi where
//     G == 0 (collinear).
// A slot without members takes i* = j* = k* = 0, as the plain version does
// (the JAX docstring calls that row garbage).
//
// The plain version is ops/centroid_cuda.py::pair_stats_plain followed by
// ops/centroid.py::circumcenter_from_pair_stats, and both entries equal it
// bit for bit: the same ops in the same order, every product, sum,
// quotient and root spelled __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn.  That spelling is the point: Mosaic contracted a*b - c*d
// into an FMA in the TPU's all-in-kernel version, whose ~1e-8 residual
// broke the G == 0 test (centroid_pallas.py:185-191); here nothing is
// contracted.  The line distance divides by the clamped norm rather than
// multiplying by its reciprocal, as the JAX kernel does (:84): the
// reciprocal would move the argmax ties.
//
// What bounds it on the H100: the launch -- a handful of active slots of
// n^2 / 2 pair terms (74k at n = 384) and one O(n) line scan each, against
// S * C slots; the bytes are the member table (4.6-6 KB a slot).  Design:
// one CTA of 512 threads per slot (S * C CTAs for S stacked frames, grid
// not sized from a host read); pair_scan.cuh's compaction, staging and
// banded scan; the selection is one lexicographic block reduction over the
// compacted columns, the line scan one over the compacted members, both
// from shared memory.  An empty slot knows it after the mask's prefix sum
// and only reads its row 0.  On the tracking paths K3f replaces K3 plus
// the ~85 eager launches of the selection, line scan and determinant.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "pair_scan.cuh"

namespace {

using namespace pair_scan;

// kOut = 2: out (C, 2) [x, y] (K10); kOut = 4: out (C, 4) [x, y, 0,
// t[c / t_div]] (K3f).
template <int kOut>
__global__ void __launch_bounds__(kThreads)
circumcenter_kernel(const float* __restrict__ mpts, const uint8_t* __restrict__ mm,
                    const float* __restrict__ t, int t_div, int P, float* __restrict__ out) {
  extern __shared__ float sh[];
  __shared__ Scratch ss;
  const Slot s = slot_layout(sh, P);
  const int c = blockIdx.x;
  const float* M = mpts + (size_t)c * P * 3;

  const int n = compact_members(mm + (size_t)c * P, P, s, ss);
  const float* rows = M;  // where Pi, Pj, Pk are read: global for an empty slot
  int i_star = 0, j_star = 0, k_star = 0;
  if (n > 0) {
    scan_slot(M, P, n, s, ss);
    rows = s.raw;

    // 1. the farthest pair: larger colmax, then smaller firstrow, then
    //    smaller column
    float v = -INFINITY;
    int a = INT_MAX, b = INT_MAX;
    for (int jj = threadIdx.x; jj < n; jj += kThreads) {
      const float ov = s.cm[jj];
      const int oa = s.fr[jj], ob = s.lane[jj];
      if (ov > v || (ov == v && (oa < a || (oa == a && ob < b)))) {
        v = ov;
        a = oa;
        b = ob;
      }
    }
    block_best(v, a, b, ss);
    if (v > -0.5f) {
      i_star = a;
      j_star = b;
    }

    // 2. the member farthest from the PiPj line in XY
    const float pix = rows[3 * i_star], piy = rows[3 * i_star + 1], piz = rows[3 * i_star + 2];
    const float pjx = rows[3 * j_star], pjy = rows[3 * j_star + 1], pjz = rows[3 * j_star + 2];
    const float ex = __fsub_rn(pjx, pix), ey = __fsub_rn(pjy, piy);
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
    const float den = norm < 1e-30f ? 1e-30f : norm;
    float best = -1.0f;
    int lk = INT_MAX, unused = 0;
    for (int ii = threadIdx.x; ii < n; ii += kThreads) {
      const int L = s.lane[ii];
      const float x = rows[3 * L], y = rows[3 * L + 1], z = rows[3 * L + 2];
      const bool eq_i = x == pix && y == piy && z == piz;
      const bool eq_j = x == pjx && y == pjy && z == pjz;
      if (!eq_i && !eq_j) {
        const float cross = fabsf(__fsub_rn(__fmul_rn(ex, __fsub_rn(y, piy)),
                                            __fmul_rn(ey, __fsub_rn(x, pix))));
        const float ld = __fdiv_rn(cross, den);
        if (ld > best) {
          best = ld;
          lk = L;
        }
      }
    }
    block_best(best, lk, unused, ss);
    k_star = best > -0.5f ? lk : 0;
  }

  // 3. the circumcenter determinant
  if (threadIdx.x == 0) {
    const float pix = rows[3 * i_star], piy = rows[3 * i_star + 1];
    const float pjx = rows[3 * j_star], pjy = rows[3 * j_star + 1];
    const float pkx = rows[3 * k_star], pky = rows[3 * k_star + 1];
    const float a = __fsub_rn(pjx, pix);
    const float b = __fsub_rn(pjy, piy);
    const float cc = __fsub_rn(pkx, pix);
    const float d = __fsub_rn(pky, piy);
    const float e = __fadd_rn(__fmul_rn(a, __fadd_rn(pix, pjx)), __fmul_rn(b, __fadd_rn(piy, pjy)));
    const float f = __fadd_rn(__fmul_rn(cc, __fadd_rn(pix, pkx)), __fmul_rn(d, __fadd_rn(piy, pky)));
    const float g = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(a, __fsub_rn(pky, pjy)),
                                              __fmul_rn(b, __fsub_rn(pkx, pjx))));
    const bool collinear = g == 0.0f;
    float* o = out + (size_t)c * kOut;
    o[0] = collinear ? pix : __fdiv_rn(__fsub_rn(__fmul_rn(d, e), __fmul_rn(b, f)), g);
    o[1] = collinear ? piy : __fdiv_rn(__fsub_rn(__fmul_rn(a, f), __fmul_rn(cc, e)), g);
    if (kOut == 4) {
      o[2] = 0.0f;
      o[3] = t[c / t_div];
    }
  }
}

template <int kOut>
int launch(const float* mpts, const uint8_t* mm, const float* t, int t_div, int C, int P,
           float* out, void* stream) {
  if (C < 1 || P < 1 || t_div < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = slot_smem_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      circumcenter_kernel<kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  circumcenter_kernel<kOut><<<C, kThreads, smem, (cudaStream_t)stream>>>(mpts, mm, t, t_div, P,
                                                                         out);
  return (int)cudaGetLastError();
}

}  // namespace

// K10: mpts (C, P, 3) f32, mm (C, P) u8 -> out (C, 2) f32 circumcenter [x, y].
extern "C" int motl_circumcenter(const float* mpts, const uint8_t* mm, int C, int P,
                                 float* out, void* stream) {
  return launch<2>(mpts, mm, nullptr, 1, C, P, out, stream);
}

// K3f: mpts (C, P, 3) f32, mm (C, P) u8, t (C / t_div,) f32 -> out (C, 4)
// f32 [x, y, 0, t[c / t_div]]: t_div = 1 for a time per slot, C / S for S
// stacked frames of C / S slots each.
extern "C" int motl_circumcenter_features(const float* mpts, const uint8_t* mm, const float* t,
                                          int C, int P, int t_div, float* out, void* stream) {
  return launch<4>(mpts, mm, t, t_div, C, P, out, stream);
}
