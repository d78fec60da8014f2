// The digit histograms' shared body (K1, csrc/voxel_grid.cu; K5,
// csrc/voxel_exact.cu): one launch per call, a frame's cells split into C
// ranges and its points into R chunks, each (range, chunk) one CTA, and the
// R CTAs of a range one thread-block cluster.
//
// A CTA keeps its range's int32 slots (ceil(n_cells / C) cells, rounded up
// to a multiple of 4) in its own shared memory, slot-major:
// hist[slot * span + (cell - lo)].  It reads its chunk of the frame's points
// (16-byte loads, four points at a time), keeps those whose cell lies in its
// range, and adds their integer digits with shared-memory atomics -- local
// atomics only.  After cluster.sync(), cluster rank q sums its share of the
// range over the R ranks' copies through distributed shared memory
// (cluster.map_shared_rank; integer adds, exact in any order) and writes it
// out: the raw entries store the int32 sums, the fused entries finalize them
// (the same __device__ function as the fin entries) and store f32.  Each CTA
// zeroes only its own copy, so there is nothing global to zero or merge: the
// wrapper allocates its outputs with torch.empty, and a call is one launch.
// Integer sums are exact in any order, so the result is deterministic; no
// float is ever summed with atomics.  The frame's mask-nonzero count is
// taken by the cluster of range 0 (whose chunks cover every point): a warp
// sum, one DSMEM atomic per warp into a word of its rank 0, which rank 0
// writes out.
//
// C = 1 is every CTA keeping the whole grid (the headline's 5,500 cells fit
// one CTA: a cluster of R CTAs over the points, reduced over DSMEM); R = 1
// is every CTA reading all the frame's points and keeping one range (a grid
// past one CTA).  C is any power of two: past 16 ranges of 14,520 cells
// (232,320) the grid takes more ranges ("K1 wide", "K5 wide": 128 for a 30
// m floor's 1,119,963 cells at 0.05 m, one chunk each), so every grid is one
// launch with no atomic leaving its CTA, at the cost of C reads of each
// point from L2.  The wrapper picks (C, R) (ops/voxel_grid_cuda.py::
// digit_layout).  No point's atomic leaves its CTA: sending each kept
// point's atomics to the rank that owns its cell through DSMEM (one cluster
// of C ranks per frame, the points split over them) measured 3-7x slower on
// every grid, and summing a warp's equal cells first (__match_any_sync,
// __reduce_add_sync) slower still (scripts/micro_torch_digits.py --sweep;
// PERF.md section 6, PR 8).
//
// A policy type D supplies the group's slots, the digits of a point and the
// finalize (see FastDigits, ExactDigits).  Every f32 product and sum is
// spelled: __fmul_rn / __fadd_rn / __fsub_rn, and __fmaf_rn exactly where
// XLA's CPU code contracts the JAX package's jitted quantize and finalize
// (p - fl * leaf, (base + i) * leaf + half, cnt * centre + s * 2^-k), so
// the sums equal the JAX package's (ROADMAP Queue 3, F8) and the plain
// PyTorch version's (ops/voxel_grid_cuda.py, fma32); bounds are tested on
// the float floor before any cast, so NaN fails every compare.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace digit_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 16;   // non-portable on the H100 (portable: 8)

struct VoxParams {
  int gx, gy, gz, bx, by, bz, n_cells;
  float inv_xy, inv_z;      // f32(1/leaf): f64 constants cast to f32
  float leaf_xy, leaf_z;    // f32(leaf)
  float half_xy, half_z;    // f32(0.5*leaf)
  float sq_xy, sq_z;        // 2^k digit scales
  float invq_xy, invq_z;    // 2^-k
};

// The point's cell: floors fx, fy, fz and the flat index lin; false where
// out of bounds or NaN (tested on the float floor, before any cast).
__device__ __forceinline__ bool point_cell(float x, float y, float z, const VoxParams& p,
                                           float& fx, float& fy, float& fz, int& lin) {
  fx = floorf(__fmul_rn(x, p.inv_xy));
  fy = floorf(__fmul_rn(y, p.inv_xy));
  fz = floorf(__fmul_rn(z, p.inv_z));
  const bool ok = fx >= (float)p.bx && fx < (float)(p.bx + p.gx) &&
                  fy >= (float)p.by && fy < (float)(p.by + p.gy) &&
                  fz >= (float)p.bz && fz < (float)(p.bz + p.gz);
  if (ok)
    lin = ((int)fx - p.bx) + p.gx * (((int)fy - p.by) + p.gy * ((int)fz - p.bz));
  return ok;
}

// The centre cell0 + half of flat cell lin on axis a (0: x, 1: y, 2: z), as
// _v4_finalize_into decomposes it: (base + i) * leaf + half rounded once,
// the FMA XLA's CPU code contracts it into
__device__ __forceinline__ float cell_centre(const VoxParams& p, int lin, int a) {
  const int ix = lin % p.gx, iyz = lin / p.gx;
  if (a == 0) return __fmaf_rn((float)(p.bx + ix), p.leaf_xy, p.half_xy);
  if (a == 1) return __fmaf_rn((float)(p.by + iyz % p.gy), p.leaf_xy, p.half_xy);
  return __fmaf_rn((float)(p.bz + iyz / p.gy), p.leaf_z, p.half_z);
}

// cnt * centre + s * 2^-k, the product and the sum rounded once (XLA's FMA)
__device__ __forceinline__ float finalize_axis(float cnt, float centre, float s, float invq) {
  return __fmaf_rn(cnt, centre, __fmul_rn(s, invq));
}

template <class D, bool CM, bool RAW>
__global__ void __launch_bounds__(kThreads)
digit_hist_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask, int n,
                  VoxParams p, int n_ranges, int span, void* __restrict__ out,
                  int* __restrict__ npts) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  int* hist = reinterpret_cast<int*>(smem4);  // [slot * span + cell - lo]
  __shared__ int s_kept;
  const int R = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int cid = blockIdx.x / R;                  // the cluster
  const int s = cid / n_ranges;                    // the frame
  const int r = cid - s * n_ranges;                // the range this CTA holds
  const int g = blockIdx.y;                        // the channel group
  const int nch = D::slots(g, RAW);
  const int nc = p.n_cells;
  const int lo = r * span;
  const int hi = min(nc, lo + span);
  for (int i = threadIdx.x; i < nch * span / 4; i += blockDim.x) smem4[i] = make_int4(0, 0, 0, 0);
  if (threadIdx.x == 0) s_kept = 0;
  cluster.sync();  // every copy zeroed before any atomic reaches it

  const float* P = pts + (size_t)s * n * 3;
  const uint8_t* M = mask + (size_t)s * n;
  const int per = ((n + R - 1) / R + 3) & ~3;      // chunk q of R, whole groups of 4
  const int start = min(n, q * per);
  const int end = min(n, start + per);
  const bool count = g == 0 && r == 0;  // these CTAs cover each point once
  int kept = 0;
  auto add = [&](float x, float y, float z) {
    float fx, fy, fz;
    int lin;
    if (!point_cell(x, y, z, p, fx, fy, fz, lin) || lin < lo || lin >= hi) return;
    int d[D::kMaxSlots];
    D::digits(g, RAW, p, x, y, z, fx, fy, fz, d);
#pragma unroll
    for (int c = 0; c < D::kMaxSlots; ++c)
      if (c < nch) atomicAdd(&hist[c * span + lin - lo], d[c]);
  };
  const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(pts) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  if (vec) {  // four points per thread and step: three float4 (rows or CM planes), one u32
    for (int i4 = start / 4 + (int)threadIdx.x; i4 < end / 4; i4 += blockDim.x) {
      const uint32_t m4 = reinterpret_cast<const uint32_t*>(M)[i4];
      float x[4], y[4], z[4];
      if (CM) {
        const float4 X = reinterpret_cast<const float4*>(P)[i4];
        const float4 Y = reinterpret_cast<const float4*>(P + n)[i4];
        const float4 Z = reinterpret_cast<const float4*>(P + 2 * n)[i4];
        x[0] = X.x; x[1] = X.y; x[2] = X.z; x[3] = X.w;
        y[0] = Y.x; y[1] = Y.y; y[2] = Y.z; y[3] = Y.w;
        z[0] = Z.x; z[1] = Z.y; z[2] = Z.z; z[3] = Z.w;
      } else {
        const float4 a = reinterpret_cast<const float4*>(P)[3 * i4];
        const float4 b = reinterpret_cast<const float4*>(P)[3 * i4 + 1];
        const float4 c = reinterpret_cast<const float4*>(P)[3 * i4 + 2];
        x[0] = a.x; y[0] = a.y; z[0] = a.z; x[1] = a.w;
        y[1] = b.x; z[1] = b.y; x[2] = b.z; y[2] = b.w;
        z[2] = c.x; x[3] = c.y; y[3] = c.z; z[3] = c.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((m4 >> (8 * k)) & 0xffu) {
          ++kept;
          add(x[k], y[k], z[k]);
        }
      }
    }
  } else {
    for (int i = start + (int)threadIdx.x; i < end; i += blockDim.x) {
      if (M[i] == 0) continue;
      ++kept;
      if (CM) add(P[i], P[n + i], P[2 * n + i]);
      else add(P[3 * i], P[3 * i + 1], P[3 * i + 2]);
    }
  }
  if (count) {
    for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, o);
    if ((threadIdx.x & 31) == 0 && kept) atomicAdd(cluster.map_shared_rank(&s_kept, 0), kept);
  }
  cluster.sync();  // every atomic in

  // write out: rank q its share of the range, summed over the R copies
  const int share = (span + R - 1) / R;
  const int j0 = q * share;
  const int j1 = min(min(span, j0 + share), hi - lo);
  for (int j = j0 + (int)threadIdx.x; j < j1; j += blockDim.x) {
    int v[D::kMaxSlots];
#pragma unroll
    for (int c = 0; c < D::kMaxSlots; ++c) v[c] = 0;
    for (int rr = 0; rr < R; ++rr) {
      const int* h = cluster.map_shared_rank(hist, rr);
#pragma unroll
      for (int c = 0; c < D::kMaxSlots; ++c)
        if (c < nch) v[c] += h[c * span + j];
    }
    if (RAW)
      D::store_raw(g, static_cast<int*>(out) + (size_t)s * D::kRawChannels * nc, nc, lo + j, v);
    else
      D::finalize(g, p, lo + j, v, static_cast<float*>(out) + (size_t)s * 4 * nc, nc);
  }
  if (count && q == 0 && threadIdx.x == 0) npts[s] = s_kept;
  cluster.sync();  // no rank leaves while another reads its copy
}

// One launch of the histogram: the cells in `ranges` ranges, the points in
// `chunks` chunks (the cluster size: 1, 2, 4, 8 or 16).  out is (S, 4,
// n_cells) f32, or with RAW (S, D::kRawChannels, n_cells) int32; npts (S,)
// int32.  Nothing needs zeroing beforehand.
template <class D, bool CM, bool RAW>
int launch(const float* pts, const uint8_t* mask, int S, int N, int ranges, int chunks,
           const VoxParams& p, void* out, int* npts, cudaStream_t st) {
  if (S < 1 || N < 0 || ranges < 1 || chunks < 1 || chunks > kMaxCluster ||
      (chunks & (chunks - 1)))
    return (int)cudaErrorInvalidValue;
  auto kern = digit_hist_kernel<D, CM, RAW>;
  const int span = (((p.n_cells + ranges - 1) / ranges) + 3) & ~3;
  const size_t smem = (size_t)D::kMaxSlots * span * sizeof(int);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && chunks > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * ranges * chunks, D::kGroups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, pts, mask, N, p, ranges, span, out, npts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace digit_cluster
