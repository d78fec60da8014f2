// K2: fused voxel finalize + per-cell static drop + dense-grid connected
// components, one thread-block cluster per frame.
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
// What bounds it on the H100: latency and shared memory.  The work is a few
// thousand to a few hundred thousand cells x up to 256 offsets per sweep,
// over a handful of sweeps; the labels (two buffers, read by every
// neighbour) must stay on chip, and so should the packed adjacency words:
// 4 * (2 + n_words) bytes per cell (12 B/cell with <= 32 stencil offsets,
// the 0.1 m headline's 24; 28 B/cell with the 146 of a 0.05 m leaf and
// three z slabs).  Design: one cluster of C CTAs per frame (C = 1, 2, 4, 8
// or 16, chosen by the wrapper from the cell count, ops/grid_cuda.py::
// cluster_size).  The frame's flat cells are split into C contiguous
// ranges of R = ceil(n / C) cells, one per CTA; each CTA keeps its range's
// two label buffers and adjacency words in its own shared memory, so the
// cluster holds C x 227 KB: ~19k cells per CTA at <= 32 offsets, 304k per
// 16-CTA cluster.  Where the adjacency words do not fit beside the labels
// (the default scene: 193,536 cells x 146 offsets), they go to a global
// scratch the wrapper allocates, read back only by the thread that wrote
// them; the labels alone (8 B/cell) fit 456k cells.  Stencil neighbours and the pointer
// jump read the other ranks' labels through distributed shared memory
// (cluster.map_shared_rank; the owner of cell j is j / R).  A neighbour's
// centroid is recomputed from the (read-only) accumulator, the same IEEE
// ops as its owner's, so no CTA reads global memory another CTA wrote.
//
// Schedule, the same as the one-CTA kernel before it and the plain
// version: each iteration is one Jacobi sweep over all cells
// (B = min(A, min over adjacent neighbours of A)) followed by one pointer
// jump (A = B[B]) -- the jump stays inside the component and at most
// halves its depth, so real scenes converge in a handful of iterations.
// cluster.sync() separates the phases, and the "changed" vote is
// cluster-wide (each CTA ORs its block vote into rank 0's shared word,
// double-buffered by iteration parity).  The cap is 2 (gx + gy + gz)
// iterations, and `saturated` reports an exit at the cap while labels
// still changed, as grid_pallas.py:226-231 does.  Because the sweep is
// global, labels, the iteration count and `saturated` do not depend on C,
// and equal the plain PyTorch version's; the fixpoint is schedule-
// independent, so labels equal the JAX kernel's.  All f32 arithmetic uses
// __fmul_rn / __fadd_rn / __fsub_rn (no FMA) and IEEE division.
//
// The double build (motl_grid_cc_f64, dtype="float64") is the same kernel
// on an f64 accumulator, for the JAX package's f64 route: finalize_dense_cm
// in f64, remove_static_cells on the centroid cast to f32 (the map
// transform stays f32: promoting its products would move the truncation),
// then the jnp stencil CC on the f64 centroids (pipeline.py:527-534,
// :600-613), whose d^2 XLA's CPU code contracts into fma(dz, dz, fma(dx,
// dx, dy * dy)) against tol^2 in f64 -- spelled so with __fma_rn.  A
// neighbour's centroid is recomputed from the accumulator, and shared
// memory holds only labels and adjacency bits, so the double build keeps
// the f32 build's cell bounds (ops/grid_cuda.py::max_kernel_cells).
//
// The double build fed f32 sums (motl_grid_cc_f64_f32sums) is the JAX f64
// route of voxel_mode="runs" on the dense grid: its accumulator is f32
// (voxel_pallas.py:158-243), finalize_dense_cm divides in f32
// (pipeline.py:591), the static drop reads that f32 centroid, and the
// centroid is widened to f64 (:600) for the stencil CC's f64 d^2.  So the
// centroid is the f32 build's, the d^2 and the output the double build's
// (a template parameter for the accumulator's type).  Dividing the f32
// sums in f64 instead would give other bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_half.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxOffsets = 256;  // 8 packed adjacency words per cell
constexpr int kMaxWords = kMaxOffsets / 32;
constexpr int kThreads = 1024;
constexpr int kMaxCluster = 16;   // non-portable on the H100 (portable: 8)

template <class T>
struct Cent {
  T x, y, z;
};

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// cell i's centroid from the channel-major accumulator, as its owner
// computes it: divided in the accumulator's type TA, then widened to T
template <class T, class TA>
__device__ __forceinline__ Cent<T> centroid(const TA* A, int n, int i) {
  const TA den = fmax(A[3 * n + i], TA(1));
  return {(T)div_rn(A[i], den), (T)div_rn(A[n + i], den), (T)div_rn(A[2 * n + i], den)};
}

// d^2 of two centroids: the f32 build in the JAX kernel's order, unfused;
// the double build as XLA contracts the jnp stencil's sum of squares
__device__ __forceinline__ float dist2(const Cent<float>& a, const Cent<float>& b) {
  const float ddx = __fsub_rn(a.x, b.x), ddy = __fsub_rn(a.y, b.y), ddz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)), __fmul_rn(ddz, ddz));
}
__device__ __forceinline__ double dist2(const Cent<double>& a, const Cent<double>& b) {
  const double ddx = __dsub_rn(a.x, b.x), ddy = __dsub_rn(a.y, b.y), ddz = __dsub_rn(a.z, b.z);
  return __fma_rn(ddz, ddz, __fma_rn(ddx, ddx, __dmul_rn(ddy, ddy)));
}

// The f32 / f64 builds' arithmetic (centroid and dist2 above)
template <class T, class TA>
struct Exact {
  using CT = T;
  static __device__ __forceinline__ Cent<T> cent(const TA* A, int n, int i) {
    return centroid<T, TA>(A, n, i);
  }
  static __device__ __forceinline__ T store(T v) { return v; }
  static __device__ __forceinline__ bool occupied(TA c) { return c > TA(0); }
  static __device__ __forceinline__ T d2(const Cent<T>& a, const Cent<T>& b) {
    return dist2(a, b);
  }
  // tol^2: the f32 build's scal[5], the double build's argument
  static __device__ __forceinline__ T tol2(const float* scal, T arg) {
    return sizeof(T) == sizeof(float) ? (T)scal[5] : arg;
  }
};

// The half builds (motl_grid_cc_bf16 / _f16): the JAX half route's
// finalize (the half sums and count widened, divided in f32, rounded), its
// stencil d^2 (each difference and square rounded; under f16 the two
// multiply-adds XLA contracts, fp_half.cuh), against tol^2 rounded to the
// half type (the argument); the map transform takes the half centroid
// widened, as the f32 builds take theirs.
template <class H>
struct Half {
  using S = typename H::storage;
  using CT = float;
  static __device__ __forceinline__ Cent<float> cent(const S* A, int n, int i) {
    const float den = fmaxf(H::load(A[3 * n + i]), 1.0f);
    return {fp::hdiv<H>(H::load(A[i]), den), fp::hdiv<H>(H::load(A[n + i]), den),
            fp::hdiv<H>(H::load(A[2 * n + i]), den)};
  }
  static __device__ __forceinline__ S store(float v) { return H::store(v); }
  static __device__ __forceinline__ bool occupied(S c) { return H::load(c) > 0.0f; }
  static __device__ __forceinline__ float d2(const Cent<float>& a, const Cent<float>& b) {
    const float dx = fp::hsub<H>(a.x, b.x), dy = fp::hsub<H>(a.y, b.y),
                dz = fp::hsub<H>(a.z, b.z);
    return H::madd(dz, dz, H::madd(dx, dx, fp::hmul<H>(dy, dy)));
  }
  static __device__ __forceinline__ float tol2(const float*, float arg) { return arg; }
};

// The half builds fed f32 sums (motl_grid_cc_bf16_f32sums / _f16_f32sums):
// the JAX half route of voxel_mode="runs" on the dense grid.  Its
// accumulator is f32 (K7's), the finalize divides in f32 (pipeline.py:591),
// the static drop reads that f32 centroid, and the centroid is rounded to
// the half type (:600) for the output and the stencil's half d^2 (Half's).
template <class H>
struct HalfF32Sums {
  using CT = float;
  static __device__ __forceinline__ Cent<float> cent(const float* A, int n, int i) {
    return centroid<float, float>(A, n, i);
  }
  static __device__ __forceinline__ typename H::storage store(float v) { return H::store(v); }
  static __device__ __forceinline__ bool occupied(float c) { return c > 0.0f; }
  static __device__ __forceinline__ float d2(const Cent<float>& a, const Cent<float>& b) {
    return Half<H>::d2({H::rnd(a.x), H::rnd(a.y), H::rnd(a.z)},
                       {H::rnd(b.x), H::rnd(b.y), H::rnd(b.z)});
  }
  static __device__ __forceinline__ float tol2(const float*, float arg) { return arg; }
};

template <class T, class TA, class P>
__global__ void __launch_bounds__(kThreads)
grid_cc_kernel(const TA* __restrict__ acc, const int* __restrict__ brow,
               const int* __restrict__ bcol, const int* __restrict__ bits,
               const int* __restrict__ offs, int n_off,
               const float* __restrict__ scal, typename P::CT tol2_arg, int gx, int gy,
               int gz,
               int kwin, int max_sweeps, int range, unsigned* adj_global,
               T* __restrict__ cent,
               uint8_t* __restrict__ dyn_out, int* __restrict__ lab_out,
               int* __restrict__ nsw) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int sm[];
  __shared__ int s_dx[kMaxOffsets], s_dy[kMaxOffsets], s_dz[kMaxOffsets],
      s_shift[kMaxOffsets];
  __shared__ int s_vote[2];
  const int n = gx * gy * gz;
  const int n_words = (n_off + 31) >> 5;
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / (int)cluster.num_blocks();  // the frame
  const int lo = rank * range;
  const int hi = min(n, lo + range);
  int* labA = sm;                                               // [range]
  int* labB = sm + range;                                       // [range]
  // [w * range + li]: in shared memory, or this CTA's slab of the scratch
  unsigned* adj = adj_global ? adj_global + (size_t)blockIdx.x * n_words * range
                             : reinterpret_cast<unsigned*>(sm + 2 * range);
  const TA* A = acc + (size_t)s * 4 * n;
  T* C = cent + (size_t)s * 3 * n;
  // label of cell j in its owner's buffer `buf` (labA or labB)
  auto remote = [&](int* buf, int j) -> int {
    const int r = j / range;
    return cluster.map_shared_rank(buf, r)[j - r * range];
  };

  for (int o = threadIdx.x; o < n_off; o += blockDim.x) {
    const int dz = offs[3 * o], dy = offs[3 * o + 1], dx = offs[3 * o + 2];
    s_dz[o] = dz;
    s_dy[o] = dy;
    s_dx[o] = dx;
    s_shift[o] = dx + gx * (dy + gy * dz);
  }
  if (threadIdx.x < 2) s_vote[threadIdx.x] = 0;
  const float ox = scal[0], oy = scal[1], cosv = scal[2], sinv = scal[3],
              invr = scal[4];
  const typename P::CT tol2 = P::tol2(scal, tol2_arg);

  // ---- phase 1: finalize + static drop bit, this CTA's range ------------
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const TA cnt = A[3 * n + i];
    const auto c = P::cent(A, n, i);
    C[i] = P::store(c.x);
    C[n + i] = P::store(c.y);
    C[2 * n + i] = P::store(c.z);
    // the map transform in f32 (a double centroid rounded once)
    const float xm = __fsub_rn((float)c.x, ox), ym = __fsub_rn((float)c.y, oy);
    const int col = (int)__fmul_rn(__fsub_rn(__fmul_rn(cosv, xm), __fmul_rn(sinv, ym)), invr);
    const int row = (int)__fmul_rn(__fadd_rn(__fmul_rn(sinv, xm), __fmul_rn(cosv, ym)), invr);
    const int qr = row - brow[i], qc = col - bcol[i];
    const bool in_win = qr >= 0 && qr < kwin && qc >= 0 && qc < kwin;
    int q = qr * kwin + qc;
    q = q < 0 ? 0 : (q > kwin * kwin - 1 ? kwin * kwin - 1 : q);
    const int bit = (int)(((unsigned)bits[i] >> q) & 1u);
    const int drop = in_win ? bit : 1;
    const bool dyn = P::occupied(cnt) && drop == 0;
    dyn_out[(size_t)s * n + i] = dyn ? 1 : 0;
    labB[i - lo] = dyn ? 1 : 0;  // dyn flags, until the sweeps reuse the buffer
    labA[i - lo] = dyn ? i : n;
  }
  cluster.sync();

  // ---- phase 2: packed adjacency words (d^2 <= tol^2, both dynamic) -------
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    unsigned w[kMaxWords] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (labB[i - lo]) {
      const int x = i % gx, yz = i / gx, y = yz % gy, z = yz / gy;
      const auto c = P::cent(A, n, i);
      for (int o = 0; o < n_off; ++o) {
        const int nx = x + s_dx[o], ny = y + s_dy[o], nz = z + s_dz[o];
        if (nx < 0 || nx >= gx || ny < 0 || ny >= gy || nz < 0 || nz >= gz) continue;
        const int j = i + s_shift[o];
        if (!remote(labB, j)) continue;
        if (P::d2(c, P::cent(A, n, j)) <= tol2) w[o >> 5] |= 1u << (o & 31);
      }
    }
    for (int k = 0; k < n_words; ++k) adj[k * range + (i - lo)] = w[k];
  }
  cluster.sync();  // every rank is done reading the dyn flags in labB

  // ---- phase 3: Jacobi min-label sweep + pointer jump, to the fixpoint ----
  int it = 0;
  int changed = 1;
  while (changed && it < max_sweeps) {
    int local = 0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int old = labA[i - lo];
      int l = old;
      if (old < n) {
        for (int k = 0; k < n_words; ++k) {
          unsigned wk = adj[k * range + (i - lo)];
          while (wk) {
            const int b = __ffs(wk) - 1;
            wk &= wk - 1;
            l = min(l, remote(labA, i + s_shift[(k << 5) + b]));
          }
        }
      }
      labB[i - lo] = l;
      local |= (l != old);
    }
    cluster.sync();  // labB complete on every rank
    // rank 0 clears the vote word of the next iteration: every rank read
    // it (as the previous iteration's) before this barrier
    if (rank == 0 && threadIdx.x == 0) s_vote[(it + 1) & 1] = 0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int b = labB[i - lo];
      const int j = b < n ? remote(labB, b) : n;
      labA[i - lo] = j;
      local |= (j != b);
    }
    if (__syncthreads_or(local) && threadIdx.x == 0)
      atomicOr(cluster.map_shared_rank(&s_vote[it & 1], 0), 1);
    cluster.sync();  // labA complete and every vote in
    const int v = threadIdx.x == 0 ? *cluster.map_shared_rank(&s_vote[it & 1], 0) : 0;
    changed = __syncthreads_or(v);
    ++it;
  }
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    lab_out[(size_t)s * n + i] = labA[i - lo];
  if (rank == 0 && threadIdx.x == 0) {
    nsw[2 * s] = it;
    nsw[2 * s + 1] = (changed && it >= max_sweeps) ? 1 : 0;
  }
  cluster.sync();  // no rank leaves while another may read its shared memory
}

template <class T, class TA, class P>
cudaError_t set_attributes(size_t smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      grid_cc_kernel<T, TA, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(grid_cc_kernel<T, TA, P>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <class T, class TA = T, class P = Exact<T, TA>>
int launch(const TA* acc, const int* brow, const int* bcol, const int* bits, const int* offs,
           int n_off, const float* scal, typename P::CT tol2, int S, int gx, int gy, int gz,
           int kwin,
           int max_sweeps, int cluster, unsigned* adj_global, T* cent, uint8_t* dyn,
           int* labels, int* nsw, void* stream) {
  if (n_off > kMaxOffsets || cluster < 1 || cluster > kMaxCluster || S < 1)
    return (int)cudaErrorInvalidValue;
  const int n = gx * gy * gz;
  const int n_words = (n_off + 31) >> 5;
  const int range = (n + cluster - 1) / cluster;
  const size_t smem = (size_t)(2 + (adj_global ? 0 : n_words)) * range * sizeof(int);
  cudaError_t err = set_attributes<T, TA, P>(smem, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, grid_cc_kernel<T, TA, P>, acc, brow, bcol, bits, offs, n_off, scal,
                           tol2, gx, gy, gz, kwin, max_sweeps, range, adj_global, cent, dyn,
                           labels, nsw);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// acc (S, 4, n) f32; brow/bcol/bits (n,) i32; offs (n_off, 3) i32 as
// (dz, dy, dx); scal (6,) f32 = origin_x, origin_y, cos, sin, inv_res, tol2.
// `cluster` CTAs per frame (1, 2, 4, 8 or 16), each owning ceil(n / cluster)
// cells; adj_global null keeps the adjacency words in shared memory, else
// it is a scratch of S * cluster * ceil(n_off / 32) * ceil(n / cluster)
// u32.  Outputs: cent (S, 3, n) f32, dyn (S, n) u8, labels (S, n) i32,
// nsw (S, 2) i32 = [iterations, saturated].
extern "C" int motl_grid_cc(const float* acc, const int* brow, const int* bcol,
                            const int* bits, const int* offs, int n_off,
                            const float* scal, int S, int gx, int gy, int gz,
                            int kwin, int max_sweeps, int cluster, unsigned* adj_global,
                            float* cent, uint8_t* dyn, int* labels, int* nsw,
                            void* stream) {
  if (scal == nullptr) return (int)cudaErrorInvalidValue;
  float tol2 = 0.0f;  // scal[5], read on the device
  return launch<float>(acc, brow, bcol, bits, offs, n_off, scal, tol2, S, gx, gy, gz, kwin,
                       max_sweeps, cluster, adj_global, cent, dyn, labels, nsw, stream);
}

// The double build: acc (S, 4, n) f64, cent (S, 3, n) f64, tol2 the f64
// tol * tol (scal[5] unread); the rest as motl_grid_cc.
extern "C" int motl_grid_cc_f64(const double* acc, const int* brow, const int* bcol,
                                const int* bits, const int* offs, int n_off,
                                const float* scal, double tol2, int S, int gx, int gy, int gz,
                                int kwin, int max_sweeps, int cluster, unsigned* adj_global,
                                double* cent, uint8_t* dyn, int* labels, int* nsw,
                                void* stream) {
  return launch<double>(acc, brow, bcol, bits, offs, n_off, scal, tol2, S, gx, gy, gz, kwin,
                        max_sweeps, cluster, adj_global, cent, dyn, labels, nsw, stream);
}

// The double build fed f32 sums: acc (S, 4, n) f32, finalized in f32 and
// widened; cent (S, 3, n) f64 and tol2 the f64 tol * tol, as
// motl_grid_cc_f64.
extern "C" int motl_grid_cc_f64_f32sums(const float* acc, const int* brow, const int* bcol,
                                        const int* bits, const int* offs, int n_off,
                                        const float* scal, double tol2, int S, int gx, int gy,
                                        int gz, int kwin, int max_sweeps, int cluster,
                                        unsigned* adj_global, double* cent, uint8_t* dyn,
                                        int* labels, int* nsw, void* stream) {
  return launch<double, float>(acc, brow, bcol, bits, offs, n_off, scal, tol2, S, gx, gy, gz,
                               kwin, max_sweeps, cluster, adj_global, cent, dyn, labels, nsw,
                               stream);
}

// The half builds: acc (S, 4, n) and cent (S, 3, n) bf16 (motl_grid_cc_bf16)
// or f16 (motl_grid_cc_f16), tol2 the half-rounded tol * tol as a float
// (scal[5] unread); the rest as motl_grid_cc.
extern "C" int motl_grid_cc_bf16(const __nv_bfloat16* acc, const int* brow, const int* bcol,
                                 const int* bits, const int* offs, int n_off, const float* scal,
                                 float tol2, int S, int gx, int gy, int gz, int kwin,
                                 int max_sweeps, int cluster, unsigned* adj_global,
                                 __nv_bfloat16* cent, uint8_t* dyn, int* labels, int* nsw,
                                 void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, Half<fp::BF16>>(
      acc, brow, bcol, bits, offs, n_off, scal, tol2, S, gx, gy, gz, kwin, max_sweeps, cluster,
      adj_global, cent, dyn, labels, nsw, stream);
}

extern "C" int motl_grid_cc_f16(const __half* acc, const int* brow, const int* bcol,
                                const int* bits, const int* offs, int n_off, const float* scal,
                                float tol2, int S, int gx, int gy, int gz, int kwin,
                                int max_sweeps, int cluster, unsigned* adj_global, __half* cent,
                                uint8_t* dyn, int* labels, int* nsw, void* stream) {
  return launch<__half, __half, Half<fp::F16>>(acc, brow, bcol, bits, offs, n_off, scal, tol2, S,
                                               gx, gy, gz, kwin, max_sweeps, cluster, adj_global,
                                               cent, dyn, labels, nsw, stream);
}

// The half builds fed f32 sums: acc (S, 4, n) f32, finalized in f32 (the
// static drop on that centroid), cent (S, 3, n) bf16 / f16 and tol2 as
// motl_grid_cc_bf16 / _f16.
extern "C" int motl_grid_cc_bf16_f32sums(const float* acc, const int* brow, const int* bcol,
                                         const int* bits, const int* offs, int n_off,
                                         const float* scal, float tol2, int S, int gx, int gy,
                                         int gz, int kwin, int max_sweeps, int cluster,
                                         unsigned* adj_global, __nv_bfloat16* cent, uint8_t* dyn,
                                         int* labels, int* nsw, void* stream) {
  return launch<__nv_bfloat16, float, HalfF32Sums<fp::BF16>>(
      acc, brow, bcol, bits, offs, n_off, scal, tol2, S, gx, gy, gz, kwin, max_sweeps, cluster,
      adj_global, cent, dyn, labels, nsw, stream);
}

extern "C" int motl_grid_cc_f16_f32sums(const float* acc, const int* brow, const int* bcol,
                                        const int* bits, const int* offs, int n_off,
                                        const float* scal, float tol2, int S, int gx, int gy,
                                        int gz, int kwin, int max_sweeps, int cluster,
                                        unsigned* adj_global, __half* cent, uint8_t* dyn,
                                        int* labels, int* nsw, void* stream) {
  return launch<__half, float, HalfF32Sums<fp::F16>>(
      acc, brow, bcol, bits, offs, n_off, scal, tol2, S, gx, gy, gz, kwin, max_sweeps, cluster,
      adj_global, cent, dyn, labels, nsw, stream);
}

// The largest cluster (16, 8, 4, 2 or 1 CTAs) of which the card can hold
// at least one at `smem` bytes of dynamic shared memory per CTA, written
// to *out (a host int).
extern "C" int motl_grid_cc_max_cluster(int smem, int* out) {
  for (int c = kMaxCluster; c >= 1; c >>= 1) {
    cudaError_t err = set_attributes<float, float, Exact<float, float>>((size_t)smem, c);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&n_clusters,
                                         grid_cc_kernel<float, float, Exact<float, float>>, &cfg);
    if (err == cudaSuccess && n_clusters >= 1) {
      *out = c;
      return 0;
    }
    cudaGetLastError();  // a refused size is an answer, not a fault
  }
  *out = 0;
  return 0;
}
