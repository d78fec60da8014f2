// K2: fused voxel finalize + per-cell static drop + dense-grid connected
// components, one CTA per frame.
//
// Replaces the Pallas kernels multiple_object_tracking_lidar_tpu/ops/
// grid_pallas.py::fused_finalize_static_cc and
// ::fused_finalize_static_cc_stacked (bodies _kernel, _kernel_stacked).
// Per cell: centroid = sums / max(count, 1); the static drop bit from the
// per-cell map window (f32 rotate, truncation toward zero, window-bit
// lookup); dyn = occupied & not dropped.  Then the radius graph on the
// stencil (d^2 <= tol^2 between dynamic neighbours) and min-label
// propagation to its fixpoint: labels[i] = min flat cell index of i's
// component, n_cells for cells that are not dynamic.
//
// What bounds it on the H100: shared memory.  Labels (two buffers) and the
// packed adjacency words live in shared memory, 4 * (2 + n_words) bytes per
// cell (12 B/cell with <= 32 stencil offsets: 66 KB at 5,500 cells), so one
// CTA holds up to ~19k cells within the 227 KB a block may use; the wrapper
// (ops/grid_cuda.py) derives that bound and raises past it.  The work is a
// few thousand cells x 24 offsets per sweep, so one CTA per frame is enough
// for a first kernel.  Design: each iteration is a Jacobi sweep
// (B = min(A, min over adjacent neighbours of A)) followed by one pointer
// jump (A = B[B]) -- the jump stays inside the component and at most halves
// its depth, so real scenes converge in a handful of iterations.  A
// block-wide "changed" vote (__syncthreads_or) ends the loop; the cap is
// 2 (gx + gy + gz) iterations, and `saturated` reports an exit at the cap
// while labels still changed, as grid_pallas.py:226-231 does.  The fixpoint
// is schedule-independent, so labels equal the JAX kernel's; the plain
// PyTorch version runs the same schedule, so the sweep count matches it.
// All f32 arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn (no FMA) and
// IEEE division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOffsets = 128;  // 4 packed adjacency words per cell
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
grid_cc_kernel(const float* __restrict__ acc, const int* __restrict__ brow,
               const int* __restrict__ bcol, const int* __restrict__ bits,
               const int* __restrict__ offs, int n_off,
               const float* __restrict__ scal, int gx, int gy, int gz,
               int kwin, int max_sweeps, float* __restrict__ cent,
               uint8_t* __restrict__ dyn_out, int* __restrict__ lab_out,
               int* __restrict__ nsw) {
  extern __shared__ int sm[];
  __shared__ int s_dx[kMaxOffsets], s_dy[kMaxOffsets], s_dz[kMaxOffsets],
      s_shift[kMaxOffsets];
  const int n = gx * gy * gz;
  const int n_words = (n_off + 31) >> 5;
  int* labA = sm;
  int* labB = sm + n;
  unsigned* adj = reinterpret_cast<unsigned*>(sm + 2 * n);  // [w * n + i]
  const int s = blockIdx.x;
  const float* A = acc + (size_t)s * 4 * n;
  float* C = cent + (size_t)s * 3 * n;

  for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
    const int dz = offs[3 * o], dy = offs[3 * o + 1], dx = offs[3 * o + 2];
    s_dz[o] = dz;
    s_dy[o] = dy;
    s_dx[o] = dx;
    s_shift[o] = dx + gx * (dy + gy * dz);
  }
  const float ox = scal[0], oy = scal[1], cosv = scal[2], sinv = scal[3],
              invr = scal[4], tol2 = scal[5];

  // ---- phase 1: finalize + static drop bit --------------------------------
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float cnt = A[3 * n + i];
    const float den = fmaxf(cnt, 1.0f);
    const float cx = A[i] / den, cy = A[n + i] / den, cz = A[2 * n + i] / den;
    C[i] = cx;
    C[n + i] = cy;
    C[2 * n + i] = cz;
    const float xm = __fsub_rn(cx, ox), ym = __fsub_rn(cy, oy);
    const int col = (int)__fmul_rn(__fsub_rn(__fmul_rn(cosv, xm), __fmul_rn(sinv, ym)), invr);
    const int row = (int)__fmul_rn(__fadd_rn(__fmul_rn(sinv, xm), __fmul_rn(cosv, ym)), invr);
    const int qr = row - brow[i], qc = col - bcol[i];
    const bool in_win = qr >= 0 && qr < kwin && qc >= 0 && qc < kwin;
    int q = qr * kwin + qc;
    q = q < 0 ? 0 : (q > kwin * kwin - 1 ? kwin * kwin - 1 : q);
    const int bit = (int)(((unsigned)bits[i] >> q) & 1u);
    const int drop = in_win ? bit : 1;
    const bool dyn = cnt > 0.0f && drop == 0;
    dyn_out[(size_t)s * n + i] = dyn ? 1 : 0;
    labB[i] = dyn ? 1 : 0;  // dyn flags, until the sweeps reuse the buffer
    labA[i] = dyn ? i : n;
  }
  __syncthreads();

  // ---- phase 2: packed adjacency words (d^2 <= tol^2, both dynamic) -------
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if (labB[i]) {
      const int x = i % gx, yz = i / gx, y = yz % gy, z = yz / gy;
      const float cx = C[i], cy = C[n + i], cz = C[2 * n + i];
      for (int o = 0; o < n_off; ++o) {
        const int nx = x + s_dx[o], ny = y + s_dy[o], nz = z + s_dz[o];
        if (nx < 0 || nx >= gx || ny < 0 || ny >= gy || nz < 0 || nz >= gz) continue;
        const int j = i + s_shift[o];
        if (!labB[j]) continue;
        const float ddx = __fsub_rn(cx, C[j]);
        const float ddy = __fsub_rn(cy, C[n + j]);
        const float ddz = __fsub_rn(cz, C[2 * n + j]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)),
                                   __fmul_rn(ddz, ddz));
        if (d2 <= tol2) w[o >> 5] |= 1u << (o & 31);
      }
    }
    for (int k = 0; k < n_words; ++k) adj[k * n + i] = w[k];
  }
  __syncthreads();

  // ---- phase 3: Jacobi min-label sweep + pointer jump, to the fixpoint ----
  int it = 0;
  int changed = 1;
  while (changed && it < max_sweeps) {
    int local = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int old = labA[i];
      int l = old;
      if (old < n) {
        for (int k = 0; k < n_words; ++k) {
          unsigned wk = adj[k * n + i];
          while (wk) {
            const int b = __ffs(wk) - 1;
            wk &= wk - 1;
            l = min(l, labA[i + s_shift[(k << 5) + b]]);
          }
        }
      }
      labB[i] = l;
      local |= (l != old);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int b = labB[i];
      const int j = b < n ? labB[b] : n;
      labA[i] = j;
      local |= (j != b);
    }
    changed = __syncthreads_or(local);
    ++it;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) lab_out[(size_t)s * n + i] = labA[i];
  if (threadIdx.x == 0) {
    nsw[2 * s] = it;
    nsw[2 * s + 1] = (changed && it >= max_sweeps) ? 1 : 0;
  }
}

}  // namespace

// acc (S, 4, n) f32; brow/bcol/bits (n,) i32; offs (n_off, 3) i32 as
// (dz, dy, dx); scal (6,) f32 = origin_x, origin_y, cos, sin, inv_res, tol2.
// Outputs: cent (S, 3, n) f32, dyn (S, n) u8, labels (S, n) i32,
// nsw (S, 2) i32 = [iterations, saturated].
extern "C" int motl_grid_cc(const float* acc, const int* brow, const int* bcol,
                            const int* bits, const int* offs, int n_off,
                            const float* scal, int S, int gx, int gy, int gz,
                            int kwin, int max_sweeps, float* cent, uint8_t* dyn,
                            int* labels, int* nsw, void* stream) {
  if (n_off > kMaxOffsets) return (int)cudaErrorInvalidValue;
  const int n = gx * gy * gz;
  const int n_words = (n_off + 31) >> 5;
  const size_t smem = (size_t)(2 + n_words) * n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      grid_cc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  grid_cc_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      acc, brow, bcol, bits, offs, n_off, scal, gx, gy, gz, kwin, max_sweeps,
      cent, dyn, labels, nsw);
  return (int)cudaGetLastError();
}
