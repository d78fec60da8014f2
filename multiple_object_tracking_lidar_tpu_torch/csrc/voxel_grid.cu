// K1: single-digit ("fast") voxel histogram + in-kernel finalize.
//
// Replaces the Pallas kernels multiple_object_tracking_lidar_tpu/ops/
// voxel_grid.py::_accumulate_pallas_v5 and ::_accumulate_pallas_v5_stacked
// (bodies _acc_kernel_v5{,_stacked} -> _acc_v5_body, _v5_quant_cm,
// _v4_finalize_into).  Per point: the voxel cell `lin`, one int8 digit per
// axis of the point's offset from its cell centre (round-half-even, clipped
// to +-127), dropped when masked, out of bounds or NaN.  Per cell: the
// integer digit sums and the count, finalized to f32
// [sum_x, sum_y, sum_z, count]; per frame: the mask-nonzero point count
// (out-of-bounds points included, as voxel_grid.py:240 and :1144 count).
//
// What bounds it on the H100: one pass over 12 bytes of points + 1 byte of
// mask per point (1.4 MB per 106,496-point frame), 16 bytes out per cell,
// and four integer atomics per kept point.  Design (csrc/digit_cluster.cuh):
// one launch per call; the frame's cells in C ranges (each CTA holds its
// range's four int32 channels in shared memory, 16 B per cell, so C ranges
// hold C x 14,520 cells: the headline's 5,500 in one, the CLI's 70,200 in
// 8, the default scene's 193,536 in 16, a 30 m floor's 1,119,963 at the
// 0.05 m leaf in 128 -- "K1 wide", each CTA then reading every point of
// its frame) and its points in R chunks, the R
// CTAs of a range one thread-block cluster.  Each CTA adds the digits of
// its chunk's points that fall in its range with local shared-memory
// atomics; the cluster then sums its R copies over distributed shared
// memory and writes the range out, finalized in the same kernel.  Nothing
// global is zeroed or merged.  Integer sums are exact in any order, so the
// result is deterministic; no float is ever summed with atomics.
//
// Entries: motl_voxel_accumulate (fused: the finalize runs in the same
// kernel, on each rank's range), motl_voxel_accumulate_raw (the int32 sums
// alone, for the kernel fleet's all-reduce; replaces the raw stacked kernels
// _accumulate_pallas_v5_stacked_raw / _v4_stacked_raw) and
// motl_voxel_finalize_fast (the finalize alone, the jnp
// finalize_fast_digits).  Fused and fin call one __device__ finalize
// (FastDigits::finalize), so fused == raw + fin bit for bit.
//
// K1-cm (motl_voxel_accumulate_cm, _cm_raw) reads the points channel-major,
// (S, 3, N) planes, instead of (S, N, 3) rows: the operand layout of the
// TPU's accumulator probes (scripts/micro_acc_v5.py, micro_acc_v7.py,
// micro_transpose.py), which all compute this histogram and differ only in
// layout.  The point read is a template parameter; the function and its
// bits do not change.  Every f32 product and sum is spelled (__fmul_rn /
// __fadd_rn / __fsub_rn, and __fmaf_rn where XLA's CPU code contracts the
// JAX quantize and finalize: digit_cluster.cuh), so nvcc's contraction
// changes no bit against the plain PyTorch version (ops/voxel_grid_cuda.py).

#include "digit_cluster.cuh"

namespace {

using digit_cluster::VoxParams;
using digit_cluster::cell_centre;
using digit_cluster::finalize_axis;

__device__ __forceinline__ int fast_digit(float p, float fl, float leaf,
                                          float half, float sq) {
  // _v5_quant_cm: frac = p - cell0 - 0.5*leaf (p - fl * leaf one FMA, as
  // XLA contracts it); round(frac * 2^k); clip
  const float frac = __fsub_rn(__fmaf_rn(-fl, leaf, p), half);
  int d = (int)rintf(__fmul_rn(frac, sq));
  return d < -127 ? -127 : (d > 127 ? 127 : d);
}

// One channel group of four slots: the x, y, z digits and the count.
struct FastDigits {
  static constexpr int kGroups = 1;
  static constexpr int kMaxSlots = 4;
  static constexpr int kRawChannels = 4;

  static __device__ int slots(int, bool) { return 4; }

  static __device__ void digits(int, bool, const VoxParams& p, float x, float y, float z,
                                float fx, float fy, float fz, int* d) {
    d[0] = fast_digit(x, fx, p.leaf_xy, p.half_xy, p.sq_xy);
    d[1] = fast_digit(y, fy, p.leaf_xy, p.half_xy, p.sq_xy);
    d[2] = fast_digit(z, fz, p.leaf_z, p.half_z, p.sq_z);
    d[3] = 1;
  }

  static __device__ void store_raw(int, int* A, int nc, int lin, const int* v) {
    for (int c = 0; c < 4; ++c) A[c * nc + lin] = v[c];
  }

  // _v4_finalize_into: cnt * (cell0 + half) + digit_sum * 2^-k, as XLA's
  // FMAs round it (digit_cluster.cuh)
  static __device__ void finalize(int, const VoxParams& p, int lin, const int* v, float* O,
                                  int nc) {
    const float cnt = (float)v[3];
    O[lin] = finalize_axis(cnt, cell_centre(p, lin, 0), (float)v[0], p.invq_xy);
    O[nc + lin] = finalize_axis(cnt, cell_centre(p, lin, 1), (float)v[1], p.invq_xy);
    O[2 * nc + lin] = finalize_axis(cnt, cell_centre(p, lin, 2), (float)v[2], p.invq_z);
    O[3 * nc + lin] = cnt;
  }
};

__global__ void voxel_finalize_kernel(const int* __restrict__ acc,
                                      float* __restrict__ out, int S,
                                      VoxParams p) {
  const int nc = p.n_cells;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * nc) return;
  const int s = t / nc, lin = t - s * nc;
  const int* A = acc + (size_t)s * 4 * nc;
  const int v[4] = {A[lin], A[nc + lin], A[2 * nc + lin], A[3 * nc + lin]};
  FastDigits::finalize(0, p, lin, v, out + (size_t)s * 4 * nc, nc);
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8 (nonzero = keep); the cells in
// `ranges` ranges and the points in `chunks` chunks (digit_cluster.cuh);
// out (S, 4, n_cells) f32, npts (S,) i32.  One launch; nothing needs
// zeroing.
extern "C" int motl_voxel_accumulate(
    const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
    void* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float sq_xy, float sq_z, float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return digit_cluster::launch<FastDigits, false, false>(pts, mask, S, N, ranges, chunks, p,
                                                         out, npts, (cudaStream_t)stream);
}

// K1-cm: the same with points given channel-major, (S, 3, N) f32.
extern "C" int motl_voxel_accumulate_cm(
    const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
    void* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float sq_xy, float sq_z, float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return digit_cluster::launch<FastDigits, true, false>(pts, mask, S, N, ranges, chunks, p,
                                                        out, npts, (cudaStream_t)stream);
}

// The histogram alone (the kernel fleet all-reduces these integers over its
// space group before one finalize): out (S, 4, n_cells) i32 digit sums
// [x, y, z, count]; the same arguments as the fused entry (invq unused).
extern "C" int motl_voxel_accumulate_raw(
    const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
    void* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float sq_xy, float sq_z, float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return digit_cluster::launch<FastDigits, false, true>(pts, mask, S, N, ranges, chunks, p,
                                                        out, npts, (cudaStream_t)stream);
}

// K1-cm's histogram alone: points (S, 3, N) f32.
extern "C" int motl_voxel_accumulate_cm_raw(
    const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
    void* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float sq_xy, float sq_z, float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return digit_cluster::launch<FastDigits, true, true>(pts, mask, S, N, ranges, chunks, p,
                                                       out, npts, (cudaStream_t)stream);
}

// The finalize alone: acc (S, 4, n_cells) i32 digit sums -> out (S, 4,
// n_cells) f32.
extern "C" int motl_voxel_finalize_fast(
    const int* acc, float* out, int S, int n_cells, int gx, int gy, int bx,
    int by, int bz, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, 1, bx, by, bz, n_cells, 0.0f, 0.0f, leaf_xy, leaf_z,
              half_xy, half_z, 0.0f, 0.0f, invq_xy, invq_z};
  const int total = S * n_cells;
  voxel_finalize_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(acc, out, S, p);
  return (int)cudaGetLastError();
}
