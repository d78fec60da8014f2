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
// mask per point (1.4 MB per 106,496-point frame) and one shared-memory
// atomic per channel per kept point.  Design: gridDim = (point blocks, S);
// each CTA keeps an int32 (4, n_cells) histogram in dynamic shared memory
// (88 KB at 5,500 cells) and merges it into a global int32 (S, 4, n_cells)
// with atomicAdd.  Integer sums are exact in any order, so the result is
// deterministic; no float is ever summed with atomics.  A second small
// kernel finalizes to f32.  The two kernels are also entries of their own
// (motl_voxel_accumulate_raw, motl_voxel_finalize_fast), which replace the
// raw stacked kernels _accumulate_pallas_v5_stacked_raw / _v4_stacked_raw
// and the jnp finalize_fast_digits: the fused entry is the same two
// launches back to back, so its bits equal raw + finalize.
//
// K1-cm (motl_voxel_accumulate_cm, _cm_raw) reads the points channel-major,
// (S, 3, N) planes, instead of (S, N, 3) rows: the operand layout of the
// TPU's accumulator probes (scripts/micro_acc_v5.py, micro_acc_v7.py,
// micro_transpose.py), which all compute this histogram and differ only in
// layout.  The point read is a template parameter; the function and its
// bits do not change.  Every f32
// product and sum uses __fmul_rn /
// __fadd_rn / __fsub_rn so no FMA contraction changes a bit against the
// plain PyTorch version (ops/voxel_grid_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct VoxParams {
  int gx, gy, gz, bx, by, bz, n_cells;
  float inv_xy, inv_z;      // f32(1/leaf): f64 constants cast to f32
  float leaf_xy, leaf_z;    // f32(leaf)
  float half_xy, half_z;    // f32(0.5*leaf)
  float sq_xy, sq_z;        // 2^k digit scales
  float invq_xy, invq_z;    // 2^-k
};

__device__ __forceinline__ int fast_digit(float p, float fl, float leaf,
                                          float half, float sq) {
  // _v5_quant_cm: frac = p - cell0 - 0.5*leaf; round(frac * 2^k); clip
  const float cell0 = __fmul_rn(fl, leaf);
  const float frac = __fsub_rn(__fsub_rn(p, cell0), half);
  int d = (int)rintf(__fmul_rn(frac, sq));
  return d < -127 ? -127 : (d > 127 ? 127 : d);
}

// CM: the points' layout.  false: row-major (S, N, 3) rows, 12 bytes per
// point; true: channel-major (S, 3, N) planes, each thread's three loads
// coalesced across the warp (K1-cm).
template <bool CM>
__global__ void voxel_hist_kernel(const float* __restrict__ pts,
                                  const uint8_t* __restrict__ mask, int n,
                                  int pts_per_cta, VoxParams p,
                                  int* __restrict__ acc, int* __restrict__ npts) {
  extern __shared__ int hist[];  // (4, n_cells) int32
  const int nc = p.n_cells;
  const int s = blockIdx.y;
  for (int i = threadIdx.x; i < 4 * nc; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const float* P = pts + (size_t)s * n * 3;
  const uint8_t* M = mask + (size_t)s * n;
  const int start = blockIdx.x * pts_per_cta;
  const int end = min(n, start + pts_per_cta);
  int kept = 0;
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    if (M[i] == 0) continue;
    ++kept;
    const float x = CM ? P[i] : P[3 * i];
    const float y = CM ? P[n + i] : P[3 * i + 1];
    const float z = CM ? P[2 * n + i] : P[3 * i + 2];
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
    atomicAdd(&hist[lin], fast_digit(x, fx, p.leaf_xy, p.half_xy, p.sq_xy));
    atomicAdd(&hist[nc + lin], fast_digit(y, fy, p.leaf_xy, p.half_xy, p.sq_xy));
    atomicAdd(&hist[2 * nc + lin], fast_digit(z, fz, p.leaf_z, p.half_z, p.sq_z));
    atomicAdd(&hist[3 * nc + lin], 1);
  }
  // mask-nonzero count: warp sum, one global atomic per warp
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, o);
  if ((threadIdx.x & 31) == 0 && kept) atomicAdd(&npts[s], kept);
  __syncthreads();

  int* A = acc + (size_t)s * 4 * nc;
  for (int i = threadIdx.x; i < 4 * nc; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(&A[i], v);
  }
}

__global__ void voxel_finalize_kernel(const int* __restrict__ acc,
                                      float* __restrict__ out, int S,
                                      VoxParams p) {
  const int nc = p.n_cells;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * nc) return;
  const int s = t / nc, lin = t - s * nc;
  const int* A = acc + (size_t)s * 4 * nc;
  float* O = out + (size_t)s * 4 * nc;
  // _v4_finalize_into: cnt * (cell0 + half) + digit_sum * 2^-k
  const int ix = lin % p.gx, iyz = lin / p.gx;
  const int iy = iyz % p.gy, iz = iyz / p.gy;
  const float cx = __fmul_rn((float)(p.bx + ix), p.leaf_xy);
  const float cy = __fmul_rn((float)(p.by + iy), p.leaf_xy);
  const float cz = __fmul_rn((float)(p.bz + iz), p.leaf_z);
  const float cnt = (float)A[3 * nc + lin];
  O[lin] = __fadd_rn(__fmul_rn(cnt, __fadd_rn(cx, p.half_xy)),
                     __fmul_rn((float)A[lin], p.invq_xy));
  O[nc + lin] = __fadd_rn(__fmul_rn(cnt, __fadd_rn(cy, p.half_xy)),
                          __fmul_rn((float)A[nc + lin], p.invq_xy));
  O[2 * nc + lin] = __fadd_rn(__fmul_rn(cnt, __fadd_rn(cz, p.half_z)),
                              __fmul_rn((float)A[2 * nc + lin], p.invq_z));
  O[3 * nc + lin] = cnt;
}

template <bool CM>
int launch_hist(const float* pts, const uint8_t* mask, int S, int N,
                int pts_per_cta, const VoxParams& p, int* acc, int* npts,
                cudaStream_t st) {
  const size_t smem = (size_t)4 * p.n_cells * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      voxel_hist_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + pts_per_cta - 1) / pts_per_cta, S);
  voxel_hist_kernel<CM><<<grid, 256, smem, st>>>(pts, mask, N, pts_per_cta, p, acc, npts);
  return (int)cudaGetLastError();
}

int launch_finalize(const int* acc, float* out, int S, const VoxParams& p,
                    cudaStream_t st) {
  const int total = S * p.n_cells;
  voxel_finalize_kernel<<<(total + 255) / 256, 256, 0, st>>>(acc, out, S, p);
  return (int)cudaGetLastError();
}

template <bool CM>
int accumulate(const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
               int* acc, float* out, int* npts, const VoxParams& p, cudaStream_t st) {
  const int err = launch_hist<CM>(pts, mask, S, N, pts_per_cta, p, acc, npts, st);
  if (err != 0) return err;
  return launch_finalize(acc, out, S, p, st);
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8; acc (S, 4, n_cells) i32 and
// npts (S,) i32 zeroed by the caller; out (S, 4, n_cells) f32.
extern "C" int motl_voxel_accumulate(
    const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
    int* acc, float* out, int* npts, int n_cells, int gx, int gy, int gz,
    int bx, int by, int bz, float inv_xy, float inv_z, float leaf_xy,
    float leaf_z, float half_xy, float half_z, float sq_xy, float sq_z,
    float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return accumulate<false>(pts, mask, S, N, pts_per_cta, acc, out, npts, p,
                           (cudaStream_t)stream);
}

// K1-cm: the same with points given channel-major, (S, 3, N) f32.
extern "C" int motl_voxel_accumulate_cm(
    const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
    int* acc, float* out, int* npts, int n_cells, int gx, int gy, int gz,
    int bx, int by, int bz, float inv_xy, float inv_z, float leaf_xy,
    float leaf_z, float half_xy, float half_z, float sq_xy, float sq_z,
    float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, invq_xy, invq_z};
  return accumulate<true>(pts, mask, S, N, pts_per_cta, acc, out, npts, p,
                          (cudaStream_t)stream);
}

// The histogram alone (the kernel fleet all-reduces these integers over its
// space group before one finalize): acc (S, 4, n_cells) i32 and npts (S,)
// i32 zeroed by the caller.
extern "C" int motl_voxel_accumulate_raw(
    const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
    int* acc, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by,
    int bz, float inv_xy, float inv_z, float leaf_xy, float leaf_z,
    float half_xy, float half_z, float sq_xy, float sq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, 0.0f, 0.0f};
  return launch_hist<false>(pts, mask, S, N, pts_per_cta, p, acc, npts, (cudaStream_t)stream);
}

// K1-cm's histogram alone: points (S, 3, N) f32.
extern "C" int motl_voxel_accumulate_cm_raw(
    const float* pts, const uint8_t* mask, int S, int N, int pts_per_cta,
    int* acc, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by,
    int bz, float inv_xy, float inv_z, float leaf_xy, float leaf_z,
    float half_xy, float half_z, float sq_xy, float sq_z, void* stream) {
  VoxParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z, leaf_xy, leaf_z,
              half_xy, half_z, sq_xy, sq_z, 0.0f, 0.0f};
  return launch_hist<true>(pts, mask, S, N, pts_per_cta, p, acc, npts, (cudaStream_t)stream);
}

// The finalize alone: acc (S, 4, n_cells) i32 digit sums -> out (S, 4,
// n_cells) f32.
extern "C" int motl_voxel_finalize_fast(
    const int* acc, float* out, int S, int n_cells, int gx, int gy, int bx,
    int by, int bz, float leaf_xy, float leaf_z, float half_xy, float half_z,
    float invq_xy, float invq_z, void* stream) {
  VoxParams p{gx, gy, 1, bx, by, bz, n_cells, 0.0f, 0.0f, leaf_xy, leaf_z,
              half_xy, half_z, 0.0f, 0.0f, invq_xy, invq_z};
  return launch_finalize(acc, out, S, p, (cudaStream_t)stream);
}
