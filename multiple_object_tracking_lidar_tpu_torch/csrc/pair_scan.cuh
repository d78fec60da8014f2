// The farthest-pair scan of one cluster slot, shared by K3 (centroid.cu),
// K10 and K3f (circumcenter.cu), so that all three compute d2 in one
// written order:
//   mean  = f32(sequential f64 sum of the member coordinates, ascending
//           lane) / f32(count)
//   pc_i  = p_i - mean for members
//   sq_i  = (x_i^2 + y_i^2) + z_i^2
//   d2[i, j] = (sq_i + sq_j) - 2 * ((x_i x_j + y_i y_j) + z_i z_j)
// with every product and sum rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, no FMA, no tensor cores: the gram's separately rounded
// products have no wgmma or mma counterpart): the plain PyTorch version
// (ops/centroid_cuda.py::pair_stats_plain) runs the same elementwise ops.
//
// Column j's statistics: colmax = max over member rows i < j of d2[i, j],
// taken by the serial rule "rows in ascending order, update on a strict
// '>' from -1" -- so a NaN d2 never wins and ties keep the first row --
// and firstrow = the row reaching it; (-1, row 0) where column j has no
// member pair.
//
// Design (one CTA of kThreads = 512 per slot; the slot is 4.6 KB at P = 384):
//  1. compaction: a stable block-wide prefix sum over the mask gives each
//     member its rank and keeps its original lane, so the triangle is
//     n_members^2, not P^2; a slot without members is known here, before
//     any coordinate is read;
//  2. staging: the slot's (P, 3) rows, one coalesced copy into shared
//     memory (16-byte loads where aligned), then the members gathered into
//     three padded coordinate arrays;
//  3. the mean: threads 0-2 each sum one axis in ascending lane from
//     shared memory (a tree or shuffle f64 sum is not bit-exact: f32 values
//     whose exponents span more than ~20 bits do not add exactly in f64);
//  4. the pair scan: one warp per compacted column, its rows split over the
//     32 lanes (lane l takes rows l, l + 32, ...), each lane keeping a
//     partial (best, row) by the serial rule; the partials merge by larger
//     value, then smaller row -- exact in any order, so the split keeps the
//     serial rule's bits.
// Every tie rule and fallback is stated on original lanes.
//
// Templated on the float type T: float for K3, K10 and K3f, double for K3f's
// double build (dtype="float64"), whose mean is the sequential f64 sum of
// the f64 coordinates in ascending lane, over the f64 count -- no wider
// type, so the order is the one written (the plain version sums lane by
// lane too) -- and whose products and sums are __dmul_rn / __dadd_rn /
// __dsub_rn (fp_rn.cuh).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fp_rn.cuh"

namespace pair_scan {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// The slot's shared memory: raw (3P floats, the rows as in global memory);
// the compacted members' centred coordinates pcx / pcy / pcz (P + 1 floats
// each, so the mean's three threads read three banks) and sq (P); the
// compacted columns' cm (P floats) and fr (P ints, original lanes); lane
// (P ints: compacted index -> original lane) and rank (P ints: lane ->
// compacted index, -1 for a non-member).
template <class T>
struct Slot {
  T *raw, *pcx, *pcy, *pcz, *sq, *cm;
  int *fr, *lane, *rank;
};

template <class T>
inline size_t slot_smem_bytes(int P) {
  return (size_t)(8 * P + 3) * sizeof(T) + (size_t)3 * P * sizeof(int);
}

template <class T>
__device__ __forceinline__ Slot<T> slot_layout(void* shv, int P) {
  T* sh = static_cast<T*>(shv);
  Slot<T> s;
  s.raw = sh;
  s.pcx = sh + 3 * P;
  s.pcy = s.pcx + (P + 1);
  s.pcz = s.pcy + (P + 1);
  s.sq = s.pcz + (P + 1);
  s.cm = s.sq + P;
  s.fr = reinterpret_cast<int*>(s.cm + P);
  s.lane = s.fr + P;
  s.rank = s.lane + P;
  return s;
}

// Per-CTA scratch for the block-wide scans and reductions.
template <class T>
struct Scratch {
  int warp_cnt[kWarps];
  T mean[3];
  T red_v[kWarps];
  int red_a[kWarps];
  int red_b[kWarps];
};

// Step 1: rank[j] and lane[rank] for every member (stable, ascending
// lane); returns the member count in every thread, behind a barrier.
template <class T>
__device__ __forceinline__ int compact_members(const uint8_t* __restrict__ mk, int P,
                                               const Slot<T>& s, Scratch<T>& ss) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  int base = 0;
  for (int j0 = 0; j0 < P; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool m = j < P && mk[j] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (l == 0) ss.warp_cnt[w] = __popc(bal);
    __syncthreads();
    int before = base, total = base;
    for (int v = 0; v < kWarps; ++v) {
      before += v < w ? ss.warp_cnt[v] : 0;
      total += ss.warp_cnt[v];
    }
    const int pos = before + __popc(bal & ((1u << l) - 1u));
    if (j < P) s.rank[j] = m ? pos : -1;
    if (m) s.lane[pos] = j;
    base = total;
    __syncthreads();  // warp_cnt is rewritten by the next tile
  }
  return base;
}

// Steps 2-4 for a slot with n > 0 members: stage, gather, mean, centre,
// scan.  Afterwards (behind a barrier) raw holds the slot's rows and cm /
// fr the statistics of every compacted column.
template <class T>
__device__ __forceinline__ void scan_slot(const T* __restrict__ M, int P, int n,
                                          const Slot<T>& s, Scratch<T>& ss) {
  // 2. staging: one coalesced copy of the rows (16-byte words where
  //    aligned), then the members gathered
  const int n_vals = 3 * P;
  const int n_bytes = n_vals * (int)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(M) & 15) == 0 && (n_bytes & 15) == 0) {
    const int4* src = reinterpret_cast<const int4*>(M);
    int4* dst = reinterpret_cast<int4*>(s.raw);
    for (int k = threadIdx.x; k < n_bytes / 16; k += kThreads) dst[k] = src[k];
  } else {
    for (int k = threadIdx.x; k < n_vals; k += kThreads) s.raw[k] = M[k];
  }
  __syncthreads();
  for (int ii = threadIdx.x; ii < n; ii += kThreads) {
    const int L = s.lane[ii];
    s.pcx[ii] = s.raw[3 * L];
    s.pcy[ii] = s.raw[3 * L + 1];
    s.pcz[ii] = s.raw[3 * L + 2];
  }
  __syncthreads();

  // 3. the mean: one sequential f64 sum per axis, ascending lane (for f32
  //    members rounded to f32, then over the f32 count)
  if (threadIdx.x < 3) {
    const T* a = threadIdx.x == 0 ? s.pcx : (threadIdx.x == 1 ? s.pcy : s.pcz);
    double acc = 0.0;
#pragma unroll 8
    for (int ii = 0; ii < n; ++ii) acc = __dadd_rn(acc, (double)a[ii]);
    if (sizeof(T) == sizeof(float))
      ss.mean[threadIdx.x] = (T)fp::div(__double2float_rn(acc), fmaxf((float)n, 1.0f));
    else
      ss.mean[threadIdx.x] = (T)fp::div(acc, fmax((double)n, 1.0));
  }
  __syncthreads();
  for (int ii = threadIdx.x; ii < n; ii += kThreads) {
    const T x = fp::sub(s.pcx[ii], ss.mean[0]);
    const T y = fp::sub(s.pcy[ii], ss.mean[1]);
    const T z = fp::sub(s.pcz[ii], ss.mean[2]);
    s.pcx[ii] = x;
    s.pcy[ii] = y;
    s.pcz[ii] = z;
    s.sq[ii] = fp::add(fp::add(fp::mul(x, x), fp::mul(y, y)), fp::mul(z, z));
  }
  __syncthreads();

  // 4. the pair scan: warp w takes compacted columns w, w + kWarps, ...
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int jj = w; jj < n; jj += kWarps) {
    const T xj = s.pcx[jj], yj = s.pcy[jj], zj = s.pcz[jj], sqj = s.sq[jj];
    T best = T(-1);
    int row = INT_MAX;
    for (int ii = l; ii < jj; ii += 32) {
      const T g = fp::add(fp::add(fp::mul(s.pcx[ii], xj), fp::mul(s.pcy[ii], yj)),
                          fp::mul(s.pcz[ii], zj));
      const T d2 = fp::sub(fp::add(s.sq[ii], sqj), fp::mul(T(2), g));
      if (d2 > best) {
        best = d2;
        row = ii;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const T ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int orow = __shfl_xor_sync(0xffffffffu, row, o);
      if (ob > best || (ob == best && orow < row)) {
        best = ob;
        row = orow;
      }
    }
    if (l == 0) {
      s.cm[jj] = best;
      s.fr[jj] = best > T(-1) ? s.lane[row] : 0;
    }
  }
  __syncthreads();
}

// The lexicographic order of block_best's default: (v, a, b) beats (bv,
// ba, bb) on a larger v, then a smaller a, then a smaller b; a NaN never
// wins.
struct LexBeats {
  template <class T>
  __device__ __forceinline__ bool operator()(T v, int a, int b, T bv, int ba, int bb) const {
    return v > bv || (v == bv && (a < ba || (a == ba && b < bb)));
  }
};

// Block-wide choice of (v, a, b) under `beats` (a total order, so exact in
// any order of merging).  Every thread calls it in the same order and gets
// the winner.
template <class T, class Beats = LexBeats>
__device__ __forceinline__ void block_best(T& v, int& a, int& b, Scratch<T>& ss,
                                           Beats beats = {}) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oa = __shfl_xor_sync(0xffffffffu, a, o);
    const int ob = __shfl_xor_sync(0xffffffffu, b, o);
    if (beats(ov, oa, ob, v, a, b)) {
      v = ov;
      a = oa;
      b = ob;
    }
  }
  __syncthreads();  // the previous call's readers are done with red_*
  if ((threadIdx.x & 31) == 0) {
    ss.red_v[threadIdx.x >> 5] = v;
    ss.red_a[threadIdx.x >> 5] = a;
    ss.red_b[threadIdx.x >> 5] = b;
  }
  __syncthreads();
  v = ss.red_v[0];
  a = ss.red_a[0];
  b = ss.red_b[0];
  for (int k = 1; k < kWarps; ++k) {
    const T ov = ss.red_v[k];
    const int oa = ss.red_a[k], ob = ss.red_b[k];
    if (beats(ov, oa, ob, v, a, b)) {
      v = ov;
      a = oa;
      b = ob;
    }
  }
}

}  // namespace pair_scan
