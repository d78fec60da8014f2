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
// 106,496-point frame) and one shared-memory integer atomic per channel per
// kept point.  Seven int32 channels would take 28 B per cell, so one CTA's
// 227 KB would hold only 8,301 cells.  Design: the channels are split over
// two CTA groups (blockIdx.z): group 0 keeps channels 0-3, group 1 channels
// 4-6, each in a (4, n_cells) int32 histogram in dynamic shared memory, so
// K5 holds the same 14,528 cells as K1 (the dense scene's 11,000 included).
// Both groups read the points (the read is cheap next to the atomics).
// Each CTA merges its histogram into the global int32 (S, 7, n_cells) with
// integer atomics: exact in any order, so the result is deterministic, and
// no float is ever summed with atomics.  A second kernel finalizes to f32
// with __fmul_rn / __fadd_rn / __fsub_rn only, so no FMA contraction changes
// a bit against the plain PyTorch version (ops/voxel_grid_cuda.py).  The two
// kernels are also entries of their own (motl_voxel_exact_raw,
// motl_voxel_finalize_exact), which replace the raw stacked kernels
// _accumulate_pallas_v6_stacked_raw / _v3_stacked_raw and the jnp
// finalize_exact_digits: the fused entry is the same two launches back to
// back, so its bits equal raw + finalize.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ExactParams {
  int gx, gy, gz, bx, by, bz, n_cells;
  float inv_xy, inv_z;      // f32(1/leaf): f64 constants cast to f32
  float leaf_xy, leaf_z;    // f32(leaf)
  float half_xy, half_z;    // f32(0.5*leaf)
  float sq_xy, sq_z;        // 2^19, 2^14 digit scales
  float invq_xy, invq_z;    // 2^-19, 2^-14
};

__device__ __forceinline__ int exact_fq(float p, float fl, float leaf,
                                        float half, float sq) {
  // _v6_quant_cm: frac = p - cell0 - 0.5*leaf; round(frac * 2^k); no clip
  const float cell0 = __fmul_rn(fl, leaf);
  const float frac = __fsub_rn(__fsub_rn(p, cell0), half);
  return (int)rintf(__fmul_rn(frac, sq));
}

__device__ __forceinline__ void split_digits(int fq, int& d0, int& d1) {
  d0 = ((fq + 128) & 255) - 128;
  d1 = (fq - d0) >> 8;  // arithmetic shift: fq - d0 is a multiple of 256
}

__global__ void exact_hist_kernel(const float* __restrict__ pts,
                                  const uint8_t* __restrict__ mask, int n,
                                  int pts_per_cta, ExactParams p,
                                  int* __restrict__ acc, int* __restrict__ npts) {
  extern __shared__ int hist[];  // (4, n_cells) int32: this group's channels
  const int nc = p.n_cells;
  const int s = blockIdx.y;
  const int group = blockIdx.z;        // 0: channels 0-3, 1: channels 4-6
  const int n_ch = group == 0 ? 4 : 3;
  for (int i = threadIdx.x; i < n_ch * nc; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const float* P = pts + (size_t)s * n * 3;
  const uint8_t* M = mask + (size_t)s * n;
  const int start = blockIdx.x * pts_per_cta;
  const int end = min(n, start + pts_per_cta);
  int kept = 0;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    if (M[i] == 0) continue;
    ++kept;
    const float x = P[3 * i], y = P[3 * i + 1], z = P[3 * i + 2];
    const float fx = floorf(__fmul_rn(x, p.inv_xy));
    const float fy = floorf(__fmul_rn(y, p.inv_xy));
    const float fz = floorf(__fmul_rn(z, p.inv_z));
    // bounds on the float floor, before any cast: NaN fails every compare
    const bool ok = fx >= (float)p.bx && fx < (float)(p.bx + p.gx) &&
                    fy >= (float)p.by && fy < (float)(p.by + p.gy) &&
                    fz >= (float)p.bz && fz < (float)(p.bz + p.gz);
    if (!ok) continue;
    const int lin = ((int)fx - p.bx) +
                    p.gx * (((int)fy - p.by) + p.gy * ((int)fz - p.bz));
    int d0, d1;
    if (group == 0) {
      split_digits(exact_fq(x, fx, p.leaf_xy, p.half_xy, p.sq_xy), d0, d1);
      atomicAdd(&hist[lin], d0);
      atomicAdd(&hist[nc + lin], d1);
      split_digits(exact_fq(y, fy, p.leaf_xy, p.half_xy, p.sq_xy), d0, d1);
      atomicAdd(&hist[2 * nc + lin], d0);
      atomicAdd(&hist[3 * nc + lin], d1);
    } else {
      split_digits(exact_fq(z, fz, p.leaf_z, p.half_z, p.sq_z), d0, d1);
      atomicAdd(&hist[lin], d0);
      atomicAdd(&hist[nc + lin], d1);
      atomicAdd(&hist[2 * nc + lin], 1);
    }
  }
  // mask-nonzero count, once (group 0): warp sum, one global atomic per warp
  if (group == 0) {
    for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, o);
    if ((threadIdx.x & 31) == 0 && kept) atomicAdd(&npts[s], kept);
  }
  __syncthreads();

  int* A = acc + ((size_t)s * 7 + (group == 0 ? 0 : 4)) * nc;
  for (int i = threadIdx.x; i < n_ch * nc; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(&A[i], v);
  }
}

__global__ void exact_finalize_kernel(const int* __restrict__ acc,
                                      float* __restrict__ out, int S,
                                      ExactParams p) {
  const int nc = p.n_cells;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * nc) return;
  const int s = t / nc, lin = t - s * nc;
  const int* A = acc + (size_t)s * 7 * nc;
  float* O = out + (size_t)s * 4 * nc;
  // _v3_finalize_into: cnt * (cell0 + half) + (s0 + 256*s1) * 2^-k
  const int ix = lin % p.gx, iyz = lin / p.gx;
  const int iy = iyz % p.gy, iz = iyz / p.gy;
  const float cx = __fmul_rn((float)(p.bx + ix), p.leaf_xy);
  const float cy = __fmul_rn((float)(p.by + iy), p.leaf_xy);
  const float cz = __fmul_rn((float)(p.bz + iz), p.leaf_z);
  const float cnt = (float)A[6 * nc + lin];
  const float sx = __fadd_rn((float)A[lin], __fmul_rn(256.0f, (float)A[nc + lin]));
  const float sy = __fadd_rn((float)A[2 * nc + lin], __fmul_rn(256.0f, (float)A[3 * nc + lin]));
  const float sz = __fadd_rn((float)A[4 * nc + lin], __fmul_rn(256.0f, (float)A[5 * nc + lin]));
  O[lin] = __fadd_rn(__fmul_rn(cnt, __fadd_rn(cx, p.half_xy)), __fmul_rn(sx, p.invq_xy));
  O[nc + lin] = __fadd_rn(__fmul_rn(cnt, __fadd_rn(cy, p.half_xy)), __fmul_rn(sy, p.invq_xy));
  O[2 * nc + lin] = __fadd_rn(__fmul_rn(cnt, __fadd_rn(cz, p.half_z)), __fmul_rn(sz, p.invq_z));
  O[3 * nc + lin] = cnt;
}

int launch_hist(const float* pts, const uint8_t* mask, int S, int N,
                int pts_per_cta, const ExactParams& p, int* acc, int* npts,
                cudaStream_t st) {
  const size_t smem = (size_t)4 * p.n_cells * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      exact_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + pts_per_cta - 1) / pts_per_cta, S, 2);
  exact_hist_kernel<<<grid, 256, smem, st>>>(pts, mask, N, pts_per_cta, p, acc, npts);
  return (int)cudaGetLastError();
}

int launch_finalize(const int* acc, float* out, int S, const ExactParams& p,
                    cudaStream_t st) {
  const int total = S * p.n_cells;
  exact_finalize_kernel<<<(total + 255) / 256, 256, 0, st>>>(acc, out, S, p);
  return (int)cudaGetLastError();
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8; acc (S, 7, n_cells) i32 and
// npts (S,) i32 zeroed by the caller; out (S, 4, n_cells) f32.
extern "C" int motl_voxel_exact(
    const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
    int* acc, float* out, int* npts, int n_cells, int gx, int gy, int gz,
    int bx, int by, int bz, float inv_xy, float inv_z, float leaf_xy,
    float leaf_z, float half_xy, float half_z, float sq_xy, float sq_z,
    float invq_xy, float invq_z, void* stream) {
  ExactParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy,
                leaf_z, half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_hist(pts, mask, S, N, pts_per_cta, p, acc, npts, st);
  if (err != 0) return err;
  return launch_finalize(acc, out, S, p, st);
}

// The two-digit histogram alone (the kernel fleet all-reduces these
// integers over its space group before one finalize): acc (S, 7, n_cells)
// i32 and npts (S,) i32 zeroed by the caller.
extern "C" int motl_voxel_exact_raw(
    const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
    int* acc, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by,
    int bz, float inv_xy, float inv_z, float leaf_xy, float leaf_z,
    float half_xy, float half_z, float sq_xy, float sq_z, void* stream) {
  ExactParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy,
                leaf_z, half_xy, half_z, sq_xy, sq_z, 0.0f, 0.0f};
  return launch_hist(pts, mask, S, N, pts_per_cta, p, acc, npts, (cudaStream_t)stream);
}

// The finalize alone: acc (S, 7, n_cells) i32 digit sums -> out (S, 4,
// n_cells) f32.
extern "C" int motl_voxel_finalize_exact(
    const int* acc, float* out, int S, int n_cells, int gx, int gy, int bx,
    int by, int bz, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float invq_xy, float invq_z, void* stream) {
  ExactParams p{gx, gy, 1, bx, by, bz, n_cells, 0.0f, 0.0f, leaf_xy, leaf_z,
                half_xy, half_z, 0.0f, 0.0f, invq_xy, invq_z};
  return launch_finalize(acc, out, S, p, (cudaStream_t)stream);
}
