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
//
// K3f's double build (motl_circumcenter_features_f64, dtype="float64") is
// the same kernel on f64 members, templated on the float type: the JAX
// package's f64 route runs the jnp circumcenter_features_table on f64
// members (ops/centroid.py:121-133), the same picks and formulas; every
// product, sum, quotient and root is __dmul_rn / __dadd_rn / __dsub_rn /
// __ddiv_rn / __dsqrt_rn (fp_rn.cuh), nothing contracted, and the mean is
// pair_scan.cuh's sequential f64 sum.  Its plain version is the same plain
// functions on f64 tensors.

#include <cuda_runtime.h>
#include <limits.h>

#include "fp_half.cuh"
#include <math.h>
#include <stdint.h>

#include "pair_scan.cuh"

namespace {

using namespace pair_scan;

// kOut = 2: out (C, 2) [x, y] (K10); kOut = 4: out (C, 4) [x, y, 0,
// t[c / t_div]] (K3f); T the float type (double: K3f's double build).
template <class T, int kOut>
__global__ void __launch_bounds__(kThreads)
circumcenter_kernel(const T* __restrict__ mpts, const uint8_t* __restrict__ mm,
                    const T* __restrict__ t, int t_div, int P, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char sh[];
  __shared__ Scratch<T> ss;
  const Slot<T> s = slot_layout<T>(sh, P);
  const int c = blockIdx.x;
  const T* M = mpts + (size_t)c * P * 3;

  const int n = compact_members(mm + (size_t)c * P, P, s, ss);
  const T* rows = M;  // where Pi, Pj, Pk are read: global for an empty slot
  int i_star = 0, j_star = 0, k_star = 0;
  if (n > 0) {
    scan_slot(M, P, n, s, ss);
    rows = s.raw;

    // 1. the farthest pair: larger colmax, then smaller firstrow, then
    //    smaller column
    T v = -INFINITY;
    int a = INT_MAX, b = INT_MAX;
    for (int jj = threadIdx.x; jj < n; jj += kThreads) {
      const T ov = s.cm[jj];
      const int oa = s.fr[jj], ob = s.lane[jj];
      if (ov > v || (ov == v && (oa < a || (oa == a && ob < b)))) {
        v = ov;
        a = oa;
        b = ob;
      }
    }
    block_best(v, a, b, ss);
    if (v > T(-0.5)) {
      i_star = a;
      j_star = b;
    }

    // 2. the member farthest from the PiPj line in XY
    const T pix = rows[3 * i_star], piy = rows[3 * i_star + 1], piz = rows[3 * i_star + 2];
    const T pjx = rows[3 * j_star], pjy = rows[3 * j_star + 1], pjz = rows[3 * j_star + 2];
    const T ex = fp::sub(pjx, pix), ey = fp::sub(pjy, piy);
    const T norm = fp::sqrt(fp::add(fp::mul(ex, ex), fp::mul(ey, ey)));
    const T tiny = T(1e-30);  // the JAX clamp, in the members' dtype
    const T den = norm < tiny ? tiny : norm;
    T best = T(-1);
    int lk = INT_MAX, unused = 0;
    for (int ii = threadIdx.x; ii < n; ii += kThreads) {
      const int L = s.lane[ii];
      const T x = rows[3 * L], y = rows[3 * L + 1], z = rows[3 * L + 2];
      const bool eq_i = x == pix && y == piy && z == piz;
      const bool eq_j = x == pjx && y == pjy && z == pjz;
      if (!eq_i && !eq_j) {
        const T cross = fabs(fp::sub(fp::mul(ex, fp::sub(y, piy)),
                                     fp::mul(ey, fp::sub(x, pix))));
        const T ld = fp::div(cross, den);
        if (ld > best) {
          best = ld;
          lk = L;
        }
      }
    }
    block_best(best, lk, unused, ss);
    k_star = best > T(-0.5) ? lk : 0;
  }

  // 3. the circumcenter determinant
  if (threadIdx.x == 0) {
    const T pix = rows[3 * i_star], piy = rows[3 * i_star + 1];
    const T pjx = rows[3 * j_star], pjy = rows[3 * j_star + 1];
    const T pkx = rows[3 * k_star], pky = rows[3 * k_star + 1];
    const T a = fp::sub(pjx, pix);
    const T b = fp::sub(pjy, piy);
    const T cc = fp::sub(pkx, pix);
    const T d = fp::sub(pky, piy);
    const T e = fp::add(fp::mul(a, fp::add(pix, pjx)), fp::mul(b, fp::add(piy, pjy)));
    const T f = fp::add(fp::mul(cc, fp::add(pix, pkx)), fp::mul(d, fp::add(piy, pky)));
    const T g = fp::mul(T(2), fp::sub(fp::mul(a, fp::sub(pky, pjy)),
                                      fp::mul(b, fp::sub(pkx, pjx))));
    const bool collinear = g == T(0);
    T* o = out + (size_t)c * kOut;
    o[0] = collinear ? pix : fp::div(fp::sub(fp::mul(d, e), fp::mul(b, f)), g);
    o[1] = collinear ? piy : fp::div(fp::sub(fp::mul(a, f), fp::mul(cc, e)), g);
    if (kOut == 4) {
      o[2] = T(0);
      o[3] = t[c / t_div];
    }
  }
}

template <class T, int kOut>
int launch(const T* mpts, const uint8_t* mm, const T* t, int t_div, int C, int P, T* out,
           void* stream) {
  if (C < 1 || P < 1 || t_div < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = slot_smem_bytes<T>(P);
  cudaError_t err = cudaFuncSetAttribute(
      circumcenter_kernel<T, kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  circumcenter_kernel<T, kOut><<<C, kThreads, smem, (cudaStream_t)stream>>>(mpts, mm, t, t_div,
                                                                            P, out);
  return (int)cudaGetLastError();
}

// K3f's half builds (motl_circumcenter_features_bf16 / _f16): the JAX
// package's half dtypes run the jnp circumcenter_features_table
// (ops/centroid.py:121-133, _one_cluster per slot) -- a gram d2, not the
// pair-stats route -- so these builds are that algorithm, every value a
// half value held in a float (fp_half.cuh):
//  1. the member mean: the masked members summed in f32 in lane order (in
//     windows of 32 lanes past 32, the windows' sums added in order: XLA's
//     split reduction), rounded, divided by the count rounded to the half
//     type; the centred members pc rounded per op; sq = ((x^2 + y^2) + z^2)
//     of pc in f32, rounded once;
//  2. d2_ij = (sq_i + sq_j) - 2 gram_ij, the gram an f32 dot rounded once,
//     under f16 the doubling contracted into the difference (one FMA),
//     over the member pairs i < j (-1 elsewhere); its first maximum in
//     row-major (i, j) order (jnp.argmax's rule: a NaN counts as the
//     maximum, here and below);
//  3. the line scan and the determinant per op, under f16 the cross
//     product, e, f, G and both numerators one FMA each (the first product
//     of each sum or difference) -- as XLA's compiled f16 tracking step has
//     them (ops/centroid_cuda.py::circumcenter_features_half_plain, the
//     plain version these builds equal bit for bit).
// The f32 table build (motl_circumcenter_features_table, policy TableF32)
// is the same body on f32 values: the JAX point list's f32 _one_cluster as
// bind_env's program computes it (the runs' point list under a half dtype
// casts it): the mean and d2 as above, sq and the gram as XLA's loops,
// fma(z, z', fma(y, y', x * x')), the cross product, e, f, G and the
// numerators one f32 FMA each, and the norm one FMA, fma(ex, ex, ey^2), only
// on the slots XLA's fused loop runs in its scalar epilogue (its 8-wide
// vector body takes a frame's first 8 floor((C - 1) / 8) slots uncontracted).
//
// Design: one CTA of kThreads = 512 per slot, as the f32 build; no loop of
// one to three threads over P.
//  - compaction: pair_scan.cuh's compact_members (a stable prefix sum over
//    the mask).  A slot without members reads only its row 0 and computes
//    the determinant on it with the same ops (i* = j* = k* = 0), so a NaN
//    there gives the plain version's bits;
//  - staging: the rows widened into three per-axis arrays padded by a word
//    per 32 lanes, each lane holding its term of the mean -- its value for
//    a member, 0 * value for another lane (a non-finite non-member reaches
//    the mean as a NaN, as the plain mpts * mm lets it) -- and row 0 kept
//    raw beside them (the picks fall back to it);
//  - the mean: a thread per (axis, 32-lane window) sums its window in lane
//    order (the padding keeps the windows' reads on distinct banks), then
//    three threads add the window sums in order: a chain of 32 + P / 32
//    adds;
//  - the pair stage over the compacted members: the upper triangle's 32 x
//    32 tiles dealt round-robin to the warps; in a tile a lane holds its
//    column in registers and reads the rows by broadcast, keeping the
//    tile's first maximum of its column, then merges it into its partial
//    (d2, row, column) under jnp.argmax's total order: a NaN beats every
//    number and NaNs tie; then larger d2, smaller row, smaller column.  A
//    total order, so any split and merge order gives the serial answer.
//    Every partial starts at the sentinel (-1, row 0, column 0) -- d2m's -1
//    at column 0 -- so a pair at d2 <= -1 never wins and no pair gives
//    (0, 0).  Compacted indices keep the lanes' order, so the order is
//    stated on them and the winner mapped back to its lanes;
//  - the line pick: a block reduction under the same order over the
//    compacted members, -1 where a lane is skipped, lane 0 where none
//    qualifies; thread 0 then computes the determinant.

// The f32 table build's policy: f32 values, no rounding past f32's own, the
// contracted multiply-adds as f32 FMAs.
struct TableF32 {
  using storage = float;
  static constexpr bool kF32 = true;
  static __device__ __forceinline__ float rnd(float x) { return x; }
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float madd(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
};

template <class H>
constexpr bool kTableF32 = false;
template <>
constexpr bool kTableF32<TableF32> = true;

// The three-term dot of the squared norms and the gram: the half builds sum
// the exact products in f32 and round once; the f32 build is XLA's loop,
// an FMA per term from the first product.
template <class H>
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  if constexpr (kTableF32<H>)
    return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
  return H::rnd(__fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz)));
}

// a lane's place in the padded per-axis arrays: one spare word per 32 lanes
__host__ __device__ constexpr int half_pad(int l) { return l + (l >> 5); }

// Dynamic shared memory of a slot: the compacted members (x, y, z, sq) as
// float4, P rounded up to whole 32-row tiles (a tile's rows are read before
// they are masked); the three padded per-axis arrays; compact_members' rank
// and lane [P] each.  The wrapper's bound on P (ops/centroid_cuda.py::
// HALF_P_MAX) is the same formula.
inline size_t half_smem_bytes(int P) {
  const size_t tiles = (size_t)(P + 31) >> 5;
  return 16 * 32 * tiles + 3 * ((size_t)P + tiles) * sizeof(float) +
         2 * (size_t)P * sizeof(int);
}

// jnp.argmax's total order on (value, a, b), block_best's order for the
// half builds: a NaN beats every number and NaNs tie; then the larger
// value, the smaller a, the smaller b.  (block_best's default, where a NaN
// never wins, is the f32 build's.)
struct ArgmaxBeats {
  __device__ __forceinline__ bool operator()(float v, int a, int b, float bv, int ba,
                                             int bb) const {
    const bool vn = isnan(v), bn = isnan(bv);
    if (vn != bn) return vn;
    if (!vn && v != bv) return v > bv;
    return a < ba || (a == ba && b < bb);
  }
};

// The circumcenter of (Pi, Pj, Pk) per op of policy H into o = [x, y, 0, t].
template <class H>
__device__ __forceinline__ void half_circumcenter(float pix, float piy, float pjx, float pjy,
                                                  float pkx, float pky, int cy_alt,
                                                  typename H::storage tval,
                                                  typename H::storage* o) {
  const float a = fp::hsub<H>(pjx, pix), b = fp::hsub<H>(pjy, piy);
  const float cc = fp::hsub<H>(pkx, pix), d = fp::hsub<H>(pky, piy);
  const float s1 = fp::hadd<H>(pix, pjx), s2 = fp::hadd<H>(piy, pjy);
  const float s3 = fp::hadd<H>(pix, pkx), s4 = fp::hadd<H>(piy, pky);
  const float e = H::madd(a, s1, fp::hmul<H>(b, s2));
  const float f = H::madd(cc, s3, fp::hmul<H>(d, s4));
  const float g = fp::hmul<H>(2.0f, H::madd(a, fp::hsub<H>(pky, pjy),
                                            -fp::hmul<H>(b, fp::hsub<H>(pkx, pjx))));
  const bool collinear = g == 0.0f;
  const float gs = collinear ? 1.0f : g;
  const float cx = collinear ? pix : fp::hdiv<H>(H::madd(d, e, -fp::hmul<H>(b, f)), gs);
  // cy_alt (the f16 fleet on a mesh of several devices): XLA's program
  // contracts cy's own copies of e and f on their second product
  const float e2 = cy_alt ? H::madd(b, s2, fp::hmul<H>(a, s1)) : e;
  const float f2 = cy_alt ? H::madd(d, s4, fp::hmul<H>(cc, s3)) : f;
  const float cy = collinear ? piy : fp::hdiv<H>(H::madd(a, f2, -fp::hmul<H>(cc, e2)), gs);
  o[0] = H::store(cx);
  o[1] = H::store(cy);
  o[2] = H::store(0.0f);
  o[3] = tval;
}

template <class H>
__global__ void __launch_bounds__(kThreads, 2)
circumcenter_half_kernel(const typename H::storage* __restrict__ mpts,
                         const uint8_t* __restrict__ mm, const typename H::storage* __restrict__ t,
                         int t_div, int P, int cy_alt, typename H::storage* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char hsh[];
  const int padded = P + ((P + 31) >> 5);
  float4* q = reinterpret_cast<float4*>(hsh);      // [P to 32 rows] compacted: x, y, z, sq
  float* ax = reinterpret_cast<float*>(q + 32 * ((P + 31) >> 5));  // [padded] the mean's terms
  float* ay = ax + padded;
  float* az = ay + padded;
  Slot<float> s{};
  s.rank = reinterpret_cast<int*>(az + padded);    // [P] lane -> compacted index, -1
  s.lane = s.rank + P;                             // [P] compacted index -> lane
  __shared__ Scratch<float> ss;
  __shared__ float r0[3], cen[3];
  const int c = blockIdx.x;
  const typename H::storage* mp = mpts + (size_t)c * P * 3;
  typename H::storage* o = out + (size_t)c * 4;

  const int n = compact_members(mm + (size_t)c * P, P, s, ss);
  if (n == 0) {  // i* = j* = k* = 0: the determinant on row 0
    if (threadIdx.x == 0) {
      const float x = H::load(mp[0]), y = H::load(mp[1]);
      half_circumcenter<H>(x, y, x, y, x, y, cy_alt, t[c / t_div], o);
    }
    return;
  }

  // staging: each lane's term of the mean (x * 0 keeps a non-finite
  // non-member's NaN and a finite one's sign), row 0 raw
  for (int k = threadIdx.x; k < 3 * P; k += kThreads) {
    const int l = k / 3, a = k - 3 * l;
    const float v = H::load(mp[k]);
    float* arr = a == 0 ? ax : (a == 1 ? ay : az);
    arr[half_pad(l)] = s.rank[l] >= 0 ? v : 0.0f * v;
    if (k < 3) r0[k] = v;
  }
  __syncthreads();

  // 1. the mean: a thread per (axis, window), then the windows in order
  const int n_win = (P + 31) >> 5;
  float* wsum = reinterpret_cast<float*>(q);       // [3 * n_win], before q is written
  for (int u = threadIdx.x; u < 3 * n_win; u += kThreads) {
    const int a = u / n_win, w = u - a * n_win;
    const float* v = (a == 0 ? ax : (a == 1 ? ay : az)) + 33 * w;
    const int len = min(32, P - 32 * w);
    float part = v[0];
#pragma unroll
    for (int k = 1; k < 32; ++k)
      if (k < len) part = __fadd_rn(part, v[k]);
    wsum[u] = part;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const float* ws = wsum + threadIdx.x * n_win;
    float total = ws[0];
    for (int w = 1; w < n_win; ++w) total = __fadd_rn(total, ws[w]);
    cen[threadIdx.x] = fp::hdiv<H>(H::rnd(total), H::rnd((float)n));
  }
  __syncthreads();
  for (int ii = threadIdx.x; ii < n; ii += kThreads) {
    const int L = half_pad(s.lane[ii]);
    const float x = fp::hsub<H>(ax[L], cen[0]);
    const float y = fp::hsub<H>(ay[L], cen[1]);
    const float z = fp::hsub<H>(az[L], cen[2]);
    q[ii] = make_float4(x, y, z, dot3<H>(x, y, z, x, y, z));
  }
  __syncthreads();

  // 2. the farthest pair: the triangle's tiles, column-major (tile = jb (jb
  //    + 1) / 2 + ib, ib <= jb), round-robin over the warps
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int nb = (n + 31) >> 5;
  const int n_tiles = nb * (nb + 1) / 2;
  float bv = -1.0f;
  int bi = -1, bj = -1;  // the sentinel: below every pair's (row, column)
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    int jb = (int)((sqrtf(8.0f * (float)tile + 1.0f) - 1.0f) * 0.5f);
    while (jb * (jb + 1) / 2 > tile) --jb;
    while ((jb + 1) * (jb + 2) / 2 <= tile) ++jb;
    const int ib = tile - jb * (jb + 1) / 2;
    const int jj = 32 * jb + l;
    const int rows = jj >= n ? 0 : (ib == jb ? l : 32);  // rows 32 ib + r < jj
    const float4 cj = q[min(jj, n - 1)];
    const float4* qi = q + 32 * ib;
    float tv = -1.0f;
    int tr = -1;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {  // branch-free: the rows' d2 overlap, past `rows` unused
      const float4 ci = qi[r];
      const float g = dot3<H>(ci.x, ci.y, ci.z, cj.x, cj.y, cj.z);
      // 2 g unrounded: f16's is XLA's contracted fma(-2, g, s) (rounding f32's
      // exact 2 g and difference once to f16 gives its bits for every f16 s
      // and g), bf16's and f32's 2 g is exact
      const float v = fp::hsub<H>(fp::hadd<H>(ci.w, cj.w), __fmul_rn(2.0f, g));
      if (r < rows && tv == tv && !(v <= tv)) {  // the column's first maximum, a NaN first
        tv = v;
        tr = r;
      }
    }
    if (tr >= 0 && ArgmaxBeats{}(tv, 32 * ib + tr, jj, bv, bi, bj)) {
      bv = tv;
      bi = 32 * ib + tr;
      bj = jj;
    }
  }
  block_best(bv, bi, bj, ss, ArgmaxBeats{});
  const int i_star = bi < 0 ? 0 : s.lane[bi];
  const int j_star = bi < 0 ? 0 : s.lane[bj];

  // 3. the member farthest from the PiPj line in XY
  const auto row = [&](const float* arr, int a, int L) {
    return L == 0 ? r0[a] : arr[half_pad(L)];  // a member's term is its value
  };
  const float pix = row(ax, 0, i_star), piy = row(ay, 1, i_star), piz = row(az, 2, i_star);
  const float pjx = row(ax, 0, j_star), pjy = row(ay, 1, j_star), pjz = row(az, 2, j_star);
  const float ex = fp::hsub<H>(pjx, pix), ey = fp::hsub<H>(pjy, piy);
  // the f32 build: contracted on the slots of a frame's scalar epilogue
  const int in_frame = c % t_div;
  const bool tail = kTableF32<H> && in_frame >= 8 * ((t_div - 1) / 8);
  const float norm = fp::hsqrt<H>(tail ? H::madd(ex, ex, fp::hmul<H>(ey, ey))
                                       : fp::hadd<H>(fp::hmul<H>(ex, ex), fp::hmul<H>(ey, ey)));
  const float den = fmaxf(norm, H::rnd(1e-30f));  // the JAX clamp, in the half dtype
  float kv = -1.0f;  // a skipped lane's -1; every qualifying distance is >= 0 or NaN
  int kl = 0, unused = 0;
  for (int ii = threadIdx.x; ii < n; ii += kThreads) {
    const int L = s.lane[ii], pl = half_pad(L);
    const float x = ax[pl], y = ay[pl], z = az[pl];
    const bool eq_i = x == pix && y == piy && z == piz;
    const bool eq_j = x == pjx && y == pjy && z == pjz;
    if (!eq_i && !eq_j) {
      const float cross = fabsf(H::madd(ex, fp::hsub<H>(y, piy),
                                        -fp::hmul<H>(ey, fp::hsub<H>(x, pix))));
      const float v = fp::hdiv<H>(cross, den);
      if (ArgmaxBeats{}(v, L, 0, kv, kl, 0)) {
        kv = v;
        kl = L;
      }
    }
  }
  block_best(kv, kl, unused, ss, ArgmaxBeats{});

  // 4. the circumcenter determinant
  if (threadIdx.x == 0)
    half_circumcenter<H>(pix, piy, pjx, pjy, row(ax, 0, kl), row(ay, 1, kl), cy_alt,
                         t[c / t_div], o);
}

template <class H>
int launch_half(const typename H::storage* mpts, const uint8_t* mm,
                const typename H::storage* t, int t_div, int C, int P,
                typename H::storage* out, void* stream, int cy_alt = 0) {
  if (C < 1 || P < 1 || t_div < 1 || t == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = half_smem_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(circumcenter_half_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  circumcenter_half_kernel<H><<<C, kThreads, smem, (cudaStream_t)stream>>>(mpts, mm, t, t_div,
                                                                          P, cy_alt, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K10: mpts (C, P, 3) f32, mm (C, P) u8 -> out (C, 2) f32 circumcenter [x, y].
extern "C" int motl_circumcenter(const float* mpts, const uint8_t* mm, int C, int P,
                                 float* out, void* stream) {
  return launch<float, 2>(mpts, mm, nullptr, 1, C, P, out, stream);
}

// K3f: mpts (C, P, 3) f32, mm (C, P) u8, t (C / t_div,) f32 -> out (C, 4)
// f32 [x, y, 0, t[c / t_div]]: t_div = 1 for a time per slot, C / S for S
// stacked frames of C / S slots each.
extern "C" int motl_circumcenter_features(const float* mpts, const uint8_t* mm, const float* t,
                                          int C, int P, int t_div, float* out, void* stream) {
  return launch<float, 4>(mpts, mm, t, t_div, C, P, out, stream);
}

// K3f's double build: mpts (C, P, 3) f64, mm (C, P) u8, t (C / t_div,) f64
// -> out (C, 4) f64 [x, y, 0, t[c / t_div]].
extern "C" int motl_circumcenter_features_f64(const double* mpts, const uint8_t* mm,
                                              const double* t, int C, int P, int t_div,
                                              double* out, void* stream) {
  return launch<double, 4>(mpts, mm, t, t_div, C, P, out, stream);
}

// K3f's half builds: mpts (C, P, 3), t (C / t_div,) and out (C, 4) bf16
// (motl_circumcenter_features_bf16) or f16 (_f16), mm (C, P) u8; cy_alt
// != 0 spells cy as the JAX fleet's program on a mesh of several devices
// has it (f16: e and f contracted on their second product; bf16 contracts
// nothing, so it changes no bit there).
extern "C" int motl_circumcenter_features_bf16(const __nv_bfloat16* mpts, const uint8_t* mm,
                                               const __nv_bfloat16* t, int C, int P, int t_div,
                                               int cy_alt, __nv_bfloat16* out, void* stream) {
  return launch_half<fp::BF16>(mpts, mm, t, t_div, C, P, out, stream, cy_alt);
}

extern "C" int motl_circumcenter_features_f16(const __half* mpts, const uint8_t* mm,
                                              const __half* t, int C, int P, int t_div,
                                              int cy_alt, __half* out, void* stream) {
  return launch_half<fp::F16>(mpts, mm, t, t_div, C, P, out, stream, cy_alt);
}

// K3f's f32 table build: mpts (C, P, 3) f32, mm (C, P) u8, t (C / t_div,)
// f32 -> out (C, 4) f32, through the JAX jnp route (_one_cluster) of the
// half builds on f32 values; t per frame, t_div = C / S slots a frame (the
// slot's place in its frame picks its norm's spelling).
extern "C" int motl_circumcenter_features_table(const float* mpts, const uint8_t* mm,
                                                const float* t, int C, int P, int t_div,
                                                float* out, void* stream) {
  return launch_half<TableF32>(mpts, mm, t, t_div, C, P, out, stream);
}
