// K5: exact two-digit voxel histogram + in-kernel finalize.
//
// Replaces the Pallas kernels multiple_object_tracking_lidar_tpu/ops/
// voxel_grid.py::_accumulate_pallas_v6, ::_accumulate_pallas_v6_stacked,
// ::_accumulate_pallas_v3 and ::_accumulate_pallas_v3_stacked (bodies
// _acc_v6_body / _acc_v3_body with _v6_quant_cm, finalize _v3_finalize_into).
// All four give the same integers: v6 sums the digits in f32 on the MXU
// while N*128 < 2^24, v3 in int32 beyond.  Here the sums are int32 in every
// regime, so one kernel covers both.
//
// Per point: the voxel cell `lin` and, per axis, the cell-relative offset
// fq = round-half-even((p - cell0 - leaf/2) * 2^19)  (2^14 for z), split into
// two balanced digits d0 = ((fq + 128) & 255) - 128, d1 = (fq - d0) >> 8.
// A point is dropped when masked, out of bounds or NaN, tested on the float
// floor before any float->int cast.  Seven int32 channels per cell
// (x d0, x d1, y d0, y d1, z d0, z d1, count); per frame the mask-nonzero
// point count (out-of-bounds points included, as voxel_grid.py:1429 counts).
// Finalize: cnt * (c + half) + (s0 + 256 * s1) * 2^-19 (2^-14 for z).
//
// What bounds it on the H100: one pass over 13 bytes per point (1.4 MB per
// 106,496-point frame), 16 bytes out per cell, and seven integer atomics per
// kept point.  Design: K1's (csrc/digit_cluster.cuh), per channel group:
// the cells in C ranges, each CTA holding its range in shared memory, the
// points in R chunks, the R CTAs of a range one thread-block cluster that
// sums its copies over distributed shared memory; one launch per call,
// nothing global zeroed or merged.  Seven channels would take 28 B per
// cell, so the channels are split over three groups (blockIdx.y), one per
// axis: that axis's two digits and the count, 12 B per cell, so K5 holds
// at least K1's cells.  Every group keeps the count because the finalize of
// an axis needs it: a 4 + 3 split (x and y digits; z digits and count)
// leaves the x and y finalize without it, so the fused entry could not
// finish in one launch.  The raw entry keeps the count in group 0 alone
// (seven atomics per point; the fused entry nine).  Every group reads the
// points; each finalizes its own axis, group 0 also the count, with the same
// __device__ function as the fin entry, so fused == raw + fin bit for bit.
// Integer sums are exact in any order, so the result is deterministic, and
// no float is ever summed with atomics.  Every product and sum is spelled
// (__fmul_rn / __fadd_rn / __fsub_rn, __fmaf_rn where XLA contracts the
// JAX quantize and finalize: digit_cluster.cuh), so no contraction of
// nvcc's changes a bit against the plain PyTorch version
// (ops/voxel_grid_cuda.py).  Entries: motl_voxel_exact (fused),
// motl_voxel_exact_raw (replaces the raw stacked kernels
// _accumulate_pallas_v6_stacked_raw / _v3_stacked_raw) and
// motl_voxel_finalize_exact (the jnp finalize_exact_digits).

#include "digit_cluster.cuh"

namespace {

using digit_cluster::VoxParams;
using digit_cluster::cell_centre;
using digit_cluster::finalize_axis;

__device__ __forceinline__ int exact_fq(float p, float fl, float leaf,
                                        float half, float sq) {
  // _v6_quant_cm: frac = p - cell0 - 0.5*leaf (p - fl * leaf one FMA, as
  // XLA contracts it); round(frac * 2^k); no clip
  const float frac = __fsub_rn(__fmaf_rn(-fl, leaf, p), half);
  return (int)rintf(__fmul_rn(frac, sq));
}

// Three channel groups, one per axis g: slots d0, d1 and the count (the raw
// entry's groups 1 and 2 keep d0, d1 alone).
struct ExactDigits {
  static constexpr int kGroups = 3;
  static constexpr int kMaxSlots = 3;
  static constexpr int kRawChannels = 7;

  static __device__ int slots(int g, bool raw) { return raw && g > 0 ? 2 : 3; }

  static __device__ void digits(int g, bool, const VoxParams& p, float x, float y, float z,
                                float fx, float fy, float fz, int* d) {
    const int fq = g == 0   ? exact_fq(x, fx, p.leaf_xy, p.half_xy, p.sq_xy)
                   : g == 1 ? exact_fq(y, fy, p.leaf_xy, p.half_xy, p.sq_xy)
                            : exact_fq(z, fz, p.leaf_z, p.half_z, p.sq_z);
    d[0] = ((fq + 128) & 255) - 128;
    d[1] = (fq - d[0]) >> 8;  // arithmetic shift: fq - d0 is a multiple of 256
    d[2] = 1;
  }

  static __device__ void store_raw(int g, int* A, int nc, int lin, const int* v) {
    A[2 * g * nc + lin] = v[0];
    A[(2 * g + 1) * nc + lin] = v[1];
    if (g == 0) A[6 * nc + lin] = v[2];
  }

  // _v3_finalize_into, axis g: cnt * (cell0 + half) + (s0 + 256*s1) * 2^-k,
  // as XLA's FMAs round it (digit_cluster.cuh; 256 * s1 is exact)
  static __device__ void finalize(int g, const VoxParams& p, int lin, const int* v, float* O,
                                  int nc) {
    const float cnt = (float)v[2];
    const float sum = __fadd_rn((float)v[0], __fmul_rn(256.0f, (float)v[1]));
    O[g * nc + lin] = finalize_axis(cnt, cell_centre(p, lin, g), sum,
                                    g == 2 ? p.invq_z : p.invq_xy);
    if (g == 0) O[3 * nc + lin] = cnt;
  }
};

__global__ void exact_finalize_kernel(const int* __restrict__ acc,
                                      float* __restrict__ out, int S,
                                      VoxParams p) {
  const int nc = p.n_cells;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * nc) return;
  const int s = t / nc, lin = t - s * nc;
  const int* A = acc + (size_t)s * 7 * nc;
  for (int g = 0; g < 3; ++g) {
    const int v[3] = {A[2 * g * nc + lin], A[(2 * g + 1) * nc + lin], A[6 * nc + lin]};
    ExactDigits::finalize(g, p, lin, v, out + (size_t)s * 4 * nc, nc);
  }
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8 (nonzero = keep); the cells in
// `ranges` ranges and the points in `chunks` chunks, per channel group
// (digit_cluster.cuh); out (S, 4, n_cells) f32, npts (S,) i32.  One launch;
// nothing needs zeroing.
extern "C" int motl_voxel_exact(
    const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
    void* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float sq_xy, float sq_z, float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy,
              leaf_z, half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return digit_cluster::launch<ExactDigits, false, false>(pts, mask, S, N, ranges, chunks, p,
                                                          out, npts, (cudaStream_t)stream);
}

// The two-digit histogram alone (the kernel fleet all-reduces these
// integers over its space group before one finalize): out (S, 7, n_cells)
// i32; the same arguments as the fused entry (invq unused).
extern "C" int motl_voxel_exact_raw(
    const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
    void* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float sq_xy, float sq_z, float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy,
              leaf_z, half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return digit_cluster::launch<ExactDigits, false, true>(pts, mask, S, N, ranges, chunks, p,
                                                         out, npts, (cudaStream_t)stream);
}

// The finalize alone: acc (S, 7, n_cells) i32 digit sums -> out (S, 4,
// n_cells) f32.
extern "C" int motl_voxel_finalize_exact(
    const int* acc, float* out, int S, int n_cells, int gx, int gy, int bx,
    int by, int bz, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, 1, bx, by, bz, n_cells, 0.0f, 0.0f, leaf_xy, leaf_z,
              half_xy, half_z, 0.0f, 0.0f, invq_xy, invq_z};
  const int total = S * n_cells;
  exact_finalize_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(acc, out, S, p);
  return (int)cudaGetLastError();
}
