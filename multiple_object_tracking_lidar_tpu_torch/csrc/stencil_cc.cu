// K14: the dense grid's stencil connected components (grid_cc="jnp", a map
// with no per-cell static table -- the vmap fleet --, a grid past K2's
// cells), one thread-block cluster per frame, one launch per call.
//
// Replaces no TPU kernel: the JAX package runs multiple_object_tracking_
// lidar_tpu/ops/cluster_grid.py::connected_components_grid (:60) as jnp
// inside its jitted step, one while_loop (its fused Pallas CC stops at
// 32,768 cells, grid_pallas.py:44-54).  Before this kernel the port ran it
// in plain torch with one host sync per iteration and (O, n) neighbour
// tables (0.9 GB at 744,200 cells and 146 offsets).  Semantics, kept bit
// for bit (ops/cluster_grid.py::connected_components_grid_plain):
//   - labels are int32, the min flat cell index of each component, n for
//     cells that are not dynamic;
//   - neighbour j = i + (dx, dy, dz) of cell i is adjacent when both are
//     dynamic and fma(dz, dz, fma(dx, dx, dy * dy)) <= tol^2 in the
//     centroids' type (d = c_i - c_j; __fmaf_rn / __fma_rn, as XLA's CPU
//     code contracts sum((c - c_j) ** 2)); a neighbour outside the grid is
//     never dynamic;
//   - an iteration is `sweeps` Jacobi sweeps (each reads the labels the
//     previous one wrote: new_i = min(lab_i, min over adjacent j of lab_j))
//     then `jumps` pointer jumps (lab_i = lab[lab_i]); `changed` compares
//     the iteration's result with its start; a frame stops at no change or
//     after max_iters iterations; n_sweeps = iterations * sweeps and
//     saturated = changed && iterations >= max_iters.
//
// What bounds it on the H100: latency.  A frame holds a few thousand
// dynamic cells of up to a million and more (1,119,963 on the 30 m floor
// at 0.05 m), and each pass is a barrier-separated step over them; the
// bytes (the (S, n) flags read once, the (S, n) labels written once) take
// microseconds at the card's rate but not on one SM.  The design spreads
// each frame over one thread-block cluster of C CTAs (1-16, the wrapper's
// choice by cell count, ops/stencil_cc_cuda.py::cluster_size), 1,024
// threads each, and keeps every step's dependent loads few and in flight
// together:
//   1. the flags read as 16-byte chunks, each CTA a contiguous share of the
//      frame's chunks and each warp a contiguous part of it, 32 chunks a
//      step: one pass counts the dynamic cells (warp reductions, then the
//      CTAs' counts exchanged over distributed shared memory), a second
//      lists them in ascending order (a warp scan per step, the CTA's and
//      the warp's offsets from the counts) and writes every label (n, or
//      the cell's own index) beside them, 16-byte stores where aligned;
//   2. each listed cell's adjacency words ((O + 31) / 32 of them, 146
//      offsets: 5) by one warp: lane b tests offset 32 w + b of every word
//      w; the cluster's warps split the list into contiguous parts, a warp
//      taking its part 32 cells at a time (their indices and centroids one
//      load a lane, handed round by shuffles), and each lane loads all its
//      words' neighbour flags and centroids at once, so a cell costs one
//      round of loads; one __ballot_sync per word;
//   3. the iterations over the list, split into C contiguous shares: the
//      Jacobi passes between the output and a scratch buffer (each thread
//      keeps its first cell and its words in registers, reads its
//      neighbours' labels four at a time), cluster.sync() between passes;
//      the "changed" vote is rank 0's shared word, raised by atomicMax to 1
//      + the iteration by every warp whose labels fell (labels only fall,
//      so "changed since the iteration's start" is "some pass lowered a
//      label"), read after the iteration's last barrier: a CTA that goes
//      on has seen this iteration's vote, so no later vote can reach a
//      slower CTA's read first.  No host sync; frames never wait for each
//      other.
// Labels, list and words written by one CTA and read by another go through
// L2 (__stcg / __ldcg).  The scratch (list, second label buffer, adjacency
// words: (2 + W) int32 per cell and frame) is the wrapper's; nothing in it
// needs zeroing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fp_half.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOffsets = 256;
constexpr int kMaxWords = kMaxOffsets / 32;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;

// The nonzero bytes of a word as 4 bits, byte 0 first.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  const unsigned t = __vcmpne4(w, 0u);
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) | ((t >> 28) & 8u);
}

// Chunk q of a frame's flags: the 16 bytes at a0 + 16 q (a0 the frame's
// first byte rounded down to 16, `lead` bytes before it), as a 16-bit
// mask of the dynamic cells c0 + b (c0 = 16 q - lead) inside [0, n).
__device__ __forceinline__ unsigned chunk_mask(const uint8_t* dv, const uint8_t* a0, int lead,
                                               int n, int q) {
  const int c0 = 16 * q - lead;
  if (c0 >= 0 && c0 + 16 <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(a0 + 16 * (size_t)q));
    return nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4) | (nonzero_bytes(v.z) << 8) |
           (nonzero_bytes(v.w) << 12);
  }
  unsigned m = 0u;
  for (int b = 0; b < 16; ++b) {
    const int c = c0 + b;
    if (c >= 0 && c < n && dv[c]) m |= 1u << b;
  }
  return m;
}

// The labels of chunk q's cells: c where dynamic, n elsewhere.
__device__ __forceinline__ void chunk_labels(int* lab, int c0, unsigned m, int n) {
  if (c0 >= 0 && c0 + 16 <= n && ((uintptr_t)(lab + c0) & 15u) == 0) {
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + 4 * k;
      const int4 v = {(m >> (4 * k)) & 1u ? c : n, (m >> (4 * k + 1)) & 1u ? c + 1 : n,
                      (m >> (4 * k + 2)) & 1u ? c + 2 : n, (m >> (4 * k + 3)) & 1u ? c + 3 : n};
      __stcg(reinterpret_cast<int4*>(lab + c), v);
    }
    return;
  }
  for (int b = 0; b < 16; ++b) {
    const int c = c0 + b;
    if (c >= 0 && c < n) __stcg(lab + c, (m >> b) & 1u ? c : n);
  }
}

struct Words {
  uint32_t w[kMaxWords];
};

__device__ __forceinline__ Words load_words(const uint32_t* adj, int q, int W) {
  Words r;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) r.w[w] = w < W ? __ldcg(adj + (size_t)q * W + w) : 0u;
  return r;
}

// One pass over cell i: a sweep (the min of its label and its adjacent
// neighbours', read four at a time) or a pointer jump; writes dst[i] and
// returns whether the label fell.
__device__ __forceinline__ bool relax(int i, const Words& wd, int W, bool sweep, const int* src,
                                      int* dst, const int* s_delta) {
  const int old = __ldcg(src + i);
  int v = old;
  if (sweep) {
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w >= W) break;
      uint32_t word = wd.w[w];
      while (word) {
        int o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          o[k] = word ? 32 * w + __ffs(word) - 1 : -1;
          word &= word - 1u;
        }
        int l[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) l[k] = o[k] >= 0 ? __ldcg(src + i + s_delta[o[k]]) : INT_MAX;
        v = min(v, min(min(l[0], l[1]), min(l[2], l[3])));
      }
    }
  } else {
    v = __ldcg(src + old);
  }
  __stcg(dst + i, v);
  return v != old;
}

// The centroids' arithmetic per storage type S: f32 and f64 compute in
// their own type (fp_rn.cuh); the half builds (motl_stencil_cc_bf16 /
// _f16) hold each half value in a float and round every difference and
// square to the half type, under f16 the two multiply-adds XLA contracts
// one FMA each (fp_half.cuh) -- the plain version's ops/cluster_pallas.py::
// fma on half tensors.
template <class S>
struct Num {
  using T = S;
  static __device__ __forceinline__ T ld(const S* p) { return __ldg(p); }
  static __device__ __forceinline__ T d2(T ci0, T ci1, T ci2, T cj0, T cj1, T cj2) {
    const T dx = fp::sub(ci0, cj0), dy = fp::sub(ci1, cj1), dz = fp::sub(ci2, cj2);
    return fp::fma(dz, dz, fp::fma(dx, dx, fp::mul(dy, dy)));
  }
};

template <class H>
struct NumHalf {
  using T = float;
  static __device__ __forceinline__ T ld(const typename H::storage* p) {
    return H::load(__ldg(p));
  }
  static __device__ __forceinline__ T d2(T ci0, T ci1, T ci2, T cj0, T cj1, T cj2) {
    const T dx = fp::hsub<H>(ci0, cj0), dy = fp::hsub<H>(ci1, cj1), dz = fp::hsub<H>(ci2, cj2);
    return H::madd(dz, dz, H::madd(dx, dx, fp::hmul<H>(dy, dy)));
  }
};

template <>
struct Num<__nv_bfloat16> : NumHalf<fp::BF16> {};
template <>
struct Num<__half> : NumHalf<fp::F16> {};

template <class S>
__global__ void __launch_bounds__(kThreads)
stencil_cc_kernel(const S* __restrict__ cent, const uint8_t* __restrict__ dyn, int gx, int gy,
                  int gz, const int* __restrict__ offsets, int n_off, typename Num<S>::T tol2,
                  int max_iters, int sweeps, int jumps, int* labels, int* __restrict__ nsw,
                  int* scratch) {
  using T = typename Num<S>::T;
  __shared__ int s_dx[kMaxOffsets], s_dy[kMaxOffsets], s_dz[kMaxOffsets], s_delta[kMaxOffsets];
  __shared__ int s_wcnt[kWarps];
  __shared__ int s_count;  // this CTA's dynamic cells
  __shared__ int s_fell;   // rank 0's: 1 + the last iteration in which a label fell
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int f = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = gx * gy * gz;
  const int W = (n_off + 31) / 32;
  const S* cx = cent + (size_t)f * 3 * n;
  const S* cy = cx + n;
  const S* cz = cy + n;
  const uint8_t* dv = dyn + (size_t)f * n;
  int* lab_a = labels + (size_t)f * n;
  int* base = scratch + (size_t)f * n * (2 + W);
  int* list = base;
  int* lab_b = base + n;
  uint32_t* adj = reinterpret_cast<uint32_t*>(base + 2 * (size_t)n);
  for (int o = tid; o < n_off; o += kThreads) {
    s_dz[o] = offsets[3 * o];
    s_dy[o] = offsets[3 * o + 1];
    s_dx[o] = offsets[3 * o + 2];
    s_delta[o] = s_dx[o] + gx * (s_dy[o] + gy * s_dz[o]);
  }
  if (tid == 0) s_fell = 0;

  // 1. the dynamic cells, listed in ascending order; every label.  The
  //    frame's 16-byte chunks split into C contiguous shares, each share
  //    into 32 contiguous warp parts
  const uint8_t* a0 = reinterpret_cast<const uint8_t*>((uintptr_t)dv & ~(uintptr_t)15);
  const int lead = (int)(dv - a0);
  const int nq = (lead + n + 15) / 16;
  const int qc = (nq + C - 1) / C;
  const int cq0 = min(nq, rank * qc), cq1 = min(nq, cq0 + qc);
  const int qw = (cq1 - cq0 + kWarps - 1) / kWarps;
  const int wq0 = min(cq1, cq0 + warp * qw), wq1 = min(cq1, wq0 + qw);
  int cnt = 0;
  for (int q = wq0 + lane; q < wq1; q += 32) cnt += __popc(chunk_mask(dv, a0, lead, n, q));
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) s_wcnt[warp] = cnt;
  __syncthreads();
  int at = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_wcnt[w];
    at += w < warp ? c : 0;
    total += c;
  }
  if (tid == 0) s_count = total;
  cluster.sync();  // every CTA's count
  const int c_rank = lane < C ? *cluster.map_shared_rank(&s_count, lane) : 0;
  at += __reduce_add_sync(kFull, lane < rank ? c_rank : 0);
  const int nd = __reduce_add_sync(kFull, c_rank);  // the frame's dynamic cells
  for (int q0 = wq0; q0 < wq1; q0 += 32) {
    const int q = q0 + lane;
    const unsigned m = q < wq1 ? chunk_mask(dv, a0, lead, n, q) : 0u;
    const int c = __popc(m);
    int x = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int c0 = 16 * q - lead;
    int k = at + x - c;
    for (unsigned mm = m; mm; mm &= mm - 1u) __stcg(list + k++, c0 + __ffs(mm) - 1);
    if (q < wq1) chunk_labels(lab_a, c0, m, n);
    at += __shfl_sync(kFull, x, 31);
  }
  cluster.sync();  // the list and the labels complete

  // 2. each listed cell's adjacency words, one warp per cell: lane b tests
  //    offset 32 w + b of word w.  The cluster's warps split the list into
  //    contiguous parts; a warp takes its part 32 cells at a time, each lane
  //    loading one cell's index and centroid, handed to the warp by
  //    shuffles; each lane then loads every word's neighbour flag and
  //    centroid at once (its own cell's where the offset leaves the grid),
  //    so a cell costs one round of loads
  const int per = (nd + C * kWarps - 1) / (C * kWarps);
  const int p0 = min(nd, (rank * kWarps + warp) * per), p1 = min(nd, p0 + per);
  for (int base = p0; base < p1; base += 32) {
    const int i_l = base + lane < p1 ? __ldcg(list + base + lane) : 0;
    const T c0_l = Num<S>::ld(cx + i_l), c1_l = Num<S>::ld(cy + i_l),
            c2_l = Num<S>::ld(cz + i_l);
    const int m = min(32, p1 - base);
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const int i = __shfl_sync(kFull, i_l, k);
      const T ci0 = __shfl_sync(kFull, c0_l, k), ci1 = __shfl_sync(kFull, c1_l, k),
              ci2 = __shfl_sync(kFull, c2_l, k);
      const int x = i % gx, y = (i / gx) % gy, z = i / (gx * gy);
      unsigned hit = 0u;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        if (w >= W) break;
        const int o = 32 * w + lane;
        const int oc = min(o, n_off - 1);
        const int xx = x + s_dx[oc], yy = y + s_dy[oc], zz = z + s_dz[oc];
        const bool in = o < n_off && xx >= 0 && xx < gx && yy >= 0 && yy < gy && zz >= 0 &&
                        zz < gz;
        const int j = in ? i + s_delta[oc] : i;
        const bool dj = __ldg(dv + j) != 0;
        const T d2 = Num<S>::d2(ci0, ci1, ci2, Num<S>::ld(cx + j), Num<S>::ld(cy + j),
                                Num<S>::ld(cz + j));
        if (in && dj && d2 <= tol2) hit |= 1u << w;
      }
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        if (w >= W) break;
        const unsigned word = __ballot_sync(kFull, (hit >> w) & 1u);
        if (lane == w) __stcg(adj + (size_t)(base + k) * W + w, word);
      }
    }
  }
  cluster.sync();  // the words complete

  // 3. the iterations, Jacobi between lab_a and lab_b; the list split into
  //    C contiguous shares, each thread's first cell and words in registers
  const int qs = (nd + C - 1) / C;
  const int e0 = min(nd, rank * qs), e1 = min(nd, e0 + qs);
  const int q_first = e0 + tid;
  const bool has = q_first < e1;
  const int i_first = has ? __ldcg(list + q_first) : 0;
  const Words w_first = load_words(adj, has ? q_first : 0, has ? W : 0);
  int* fell = cluster.map_shared_rank(&s_fell, 0);
  int* src = lab_a;
  int* dst = lab_b;
  const int passes = sweeps + jumps;
  int it = 0;
  bool changed = true;
  while (changed && it < max_iters) {
    bool moved = false;
    for (int p = 0; p < passes; ++p) {
      const bool sweep = p < sweeps;
      if (has) moved |= relax(i_first, w_first, W, sweep, src, dst, s_delta);
      for (int q = q_first + kThreads; q < e1; q += kThreads)
        moved |= relax(__ldcg(list + q), load_words(adj, q, W), W, sweep, src, dst, s_delta);
      if (p == passes - 1 && __any_sync(kFull, moved) && lane == 0) atomicMax(fell, it + 1);
      cluster.sync();  // this pass's labels (and, after the last, the vote) complete
      int* t = src;
      src = dst;
      dst = t;
    }
    const int v = lane == 0 ? *fell : 0;
    changed = __shfl_sync(kFull, v, 0) >= it + 1;
    ++it;
  }
  if (src != lab_a)
    for (int q = e0 + tid; q < e1; q += kThreads) {
      const int i = __ldcg(list + q);
      __stcg(lab_a + i, __ldcg(src + i));
    }
  if (rank == 0 && tid == 0) {
    nsw[2 * f] = it * sweeps;
    nsw[2 * f + 1] = (changed && it >= max_iters) ? 1 : 0;
  }
  cluster.sync();  // no rank leaves while another may read its shared memory
}

template <class T>
cudaError_t set_attributes(int cluster) {
  if (cluster <= 8) return cudaSuccess;
  return cudaFuncSetAttribute(stencil_cc_kernel<T>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <class T>
int launch(const T* cent, const uint8_t* dyn, int S, int gx, int gy, int gz, const int* offsets,
           int n_off, typename Num<T>::T tol2, int max_iters, int sweeps, int jumps,
           int cluster, int* labels, int* nsw, int* scratch, void* stream) {
  if (S < 1 || gx < 1 || gy < 1 || gz < 1 || n_off < 0 || n_off > kMaxOffsets || max_iters < 0 ||
      sweeps < 0 || jumps < 0 || (n_off > 0 && offsets == nullptr) || scratch == nullptr ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes<T>(cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stencil_cc_kernel<T>, cent, dyn, gx, gy, gz, offsets, n_off,
                           tol2, max_iters, sweeps, jumps, labels, nsw, scratch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// S frames: cent (S, 3, n) f32 channel-major centroids, dyn (S, n) u8 (the
// cell holds a dynamic point), n = gx * gy * gz; offsets (n_off, 3) i32
// (dz, dy, dx) in device memory, n_off <= 256; tol2 = tol^2 in f32; the
// schedule max_iters, sweeps, jumps; `cluster` CTAs per frame (1, 2, 4, 8
// or 16).  Outputs: labels (S, n) i32, nsw (S, 2) i32 [n_sweeps,
// saturated].  scratch: S * n * (2 + ceil(n_off / 32)) int32 of device
// memory.
extern "C" int motl_stencil_cc(const float* cent, const uint8_t* dyn, int S, int gx, int gy,
                               int gz, const int* offsets, int n_off, float tol2, int max_iters,
                               int sweeps, int jumps, int cluster, int* labels, int* nsw,
                               int* scratch, void* stream) {
  return launch(cent, dyn, S, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, cluster,
                labels, nsw, scratch, stream);
}

// The double build: cent (S, 3, n) f64, tol2 in f64; the rest as
// motl_stencil_cc.
extern "C" int motl_stencil_cc_f64(const double* cent, const uint8_t* dyn, int S, int gx, int gy,
                                   int gz, const int* offsets, int n_off, double tol2,
                                   int max_iters, int sweeps, int jumps, int cluster, int* labels,
                                   int* nsw, int* scratch, void* stream) {
  return launch(cent, dyn, S, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, cluster,
                labels, nsw, scratch, stream);
}

// The half builds: cent (S, 3, n) bf16 (motl_stencil_cc_bf16) or f16
// (motl_stencil_cc_f16), tol2 the half-rounded tol * tol as a float; the
// rest as motl_stencil_cc.
extern "C" int motl_stencil_cc_bf16(const __nv_bfloat16* cent, const uint8_t* dyn, int S, int gx,
                                    int gy, int gz, const int* offsets, int n_off, float tol2,
                                    int max_iters, int sweeps, int jumps, int cluster,
                                    int* labels, int* nsw, int* scratch, void* stream) {
  return launch(cent, dyn, S, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, cluster,
                labels, nsw, scratch, stream);
}

extern "C" int motl_stencil_cc_f16(const __half* cent, const uint8_t* dyn, int S, int gx, int gy,
                                   int gz, const int* offsets, int n_off, float tol2,
                                   int max_iters, int sweeps, int jumps, int cluster, int* labels,
                                   int* nsw, int* scratch, void* stream) {
  return launch(cent, dyn, S, gx, gy, gz, offsets, n_off, tol2, max_iters, sweeps, jumps, cluster,
                labels, nsw, scratch, stream);
}

// The largest cluster (16, 8, 4, 2 or 1 CTAs of 1,024 threads) of which
// the card can hold at least one, written to *out (a host int).
extern "C" int motl_stencil_cc_max_cluster(int* out) {
  for (int c = kMaxCluster; c >= 1; c >>= 1) {
    cudaError_t err = set_attributes<float>(c);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&n_clusters, stencil_cc_kernel<float>, &cfg);
    if (err == cudaSuccess && n_clusters >= 1) {
      *out = c;
      return 0;
    }
    cudaGetLastError();  // a refused size is an answer, not a fault
  }
  *out = 0;
  return 0;
}
