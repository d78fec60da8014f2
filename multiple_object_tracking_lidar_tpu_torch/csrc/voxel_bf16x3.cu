// K6: voxel sums in a fixed summation order -- bf16x3 mode and f32 mode.
//
// Mode 0 (bf16x3) replaces the Pallas kernel multiple_object_tracking_lidar_
// tpu/ops/voxel_grid.py::_accumulate_pallas_v2 (body _acc_kernel_v2), which
// exact mode takes when the leaf is too coarse for two int8 digits
// (_v3_leaf_ok fails), and the jnp bf16x3 lowering of the same sums
// (voxel_grid.py:256-278) that exact mode takes when no point block tiles N.
// Per kept point (mask nonzero, in bounds, not NaN: tested on the float
// floor before any cast) each coordinate v splits into three bf16 parts,
// round-to-nearest-even: h1 = bf16(v), h2 = bf16(v - h1),
// h3 = bf16((v - h1) - h2).  Per cell: the f32 sums S1, S2, S3 of each
// part, combined as (S1 + S2) + S3, and the exact count.
//
// The key entry (motl_voxel_bf16x3_keys) replaces the Pallas kernel
// voxel_grid.py::_accumulate_pallas (body _acc_kernel), the TPU's first
// one-hot accumulator, whose caller quantizes: it takes precomputed ix,
// iyz and in_bounds and sums the same bf16x3 parts over the (gyz, gx) grid.
// Its first stage takes the key in_bounds ? iyz * gx + ix : -1 instead of
// quantizing, and drops ix outside [0, gx) and iyz outside [0, gyz): no
// one-hot row matches them (voxel_grid.py:314-317).  The rest is shared.
//
// Mode 1 (f32) is the point-list dense accumulator, ops/voxel.py::
// voxel_accumulate: no Pallas kernel, an XLA scatter-add of (x, y, z, 1),
// which XLA's CPU code applies one update at a time in ascending point
// index.  Per cell: the plain f32 sum of each coordinate and the count.
// Its double build (motl_voxel_sums_f64, dtype="float64") is the same
// kernels on f64 points: the cell keys from the points rounded to f32 (the
// JAX quantize is f32 in every dtype), the f64 coordinates gathered and
// summed with __dadd_rn in the same order -- the JAX f64 scatter-add's
// sums, and the sums of the f64 one-hot contraction that voxel_quant=
// "exact" takes under f64 (voxel_grid.py:242-254), there up to XLA's own
// summation order.
// Its half builds (motl_voxel_sums_bf16 / _f16, dtype="bfloat16" /
// "float16") are mode 1 on f32 points that hold the frame's points rounded
// to the half type: the JAX half scatter-add keeps a half accumulator and
// XLA's CPU code rounds each update to it (bf16: an f32 add rounded; f16:
// the native add -- both the correctly rounded half sum), so each add here
// is __fadd_rn rounded to the half type, in the same order, and the count
// is the half sum of ones, which stops at 256 in bf16 and 2,048 in f16.
// Past 65,504 an f16 sum is inf, as in JAX.
//
// The summation order.  Float atomics would change the bits from run to
// run, and the TPU's MXU order (mode 0) has no counterpart to copy.  So K6
// fixes its order: per cell, each sum starts at +0.0f and adds the cell's
// points one at a time in ASCENDING POINT INDEX, each add rounded to
// nearest (__fadd_rn) -- in mode 1 exactly the scatter-add's order.  The
// plain PyTorch versions (ops/voxel_grid_cuda.py) run the same adds in the
// same order.
//
// How the order is reached: a stable LSD radix sort of the kept points'
// cell keys, 8-bit digits (ceil(bits(n_cells) / 8) passes: 2 at the
// headline's 5,500 cells, 3 at the default configuration's 193,536), over
// tiles of kTile = 2,048 points, one CTA of 256 threads each:
//  1. keys (grid (tiles, S)): each point's cell key, -1 when dropped, the
//     tile's digit-0 histogram of the kept keys and its mask-nonzero count,
//     written in full (nothing to zero first); the CTA also initialises
//     its share of the frame's per-cell positions and zeroes its rows of
//     the later passes' histograms;
//  2. one pass per digit (grid (tiles, S)): each CTA reads the frame's
//     (tile, digit) histogram and takes its own offsets (a scan over
//     256 digits x tiles, from L2), ranks its tile's keys stably -- warp w
//     owns 256 consecutive keys, walked 32 at a time, __match_any_sync
//     ranking equal digits by lane, per-warp digit counters in shared
//     memory, then a scan over the 8 warps per digit -- reorders the tile by
//     digit in shared memory and writes it out in runs of consecutive
//     positions.
//     Dropped keys (-1) never enter: pass 0 skips them, so later passes
//     see only the kept points.  Every pass but the last adds its output's
//     next-digit histogram (integer atomics, aggregated by (tile, digit)
//     within a warp step).  The last pass gathers the points' coordinates
//     into sorted order instead of writing (key, index) pairs, and takes
//     each cell's run from integer atomics on the sorted positions: the
//     atomicMin of its first and the atomicMax of one past its last (one of
//     each per cell and warp step).  The run is contiguous, so that is its
//     start and its count, and no scan over n_cells is needed: at 193,536
//     cells a one-CTA-per-frame scan took 0.25 ms on an H100, more than
//     the sort.
//     Tile 0 also adds up the frame's mask-nonzero count;
//  3. sum (one thread per (frame, cell)): a run of at most kLong points is
//     walked by its own thread over contiguous memory, kBatch points' loads
//     in flight before their adds, as 16-byte loads (a thread's scalar
//     loads touch one cache line per lane, which made the walk LSU-bound:
//     27 us on an H100 at the headline, S = 1); a longer one by the whole
//     warp, which stages 32 points at a time with one coalesced load (their
//     bf16 parts computed in parallel) and adds them in order through
//     shuffles -- every lane holds the same running sums.  So one dense
//     cell costs its chain of dependent adds, not a dependent load per
//     point.  (A warp takes its long runs one after another, which is why
//     kLong is high: at thresholds of 64 and 256 the headline's wall cells,
//     hundreds of points each and side by side, made the sum 3x slower
//     than the rest on an H100.)
// Launches per call: 2 + passes (4 at the headline, 5 at 193,536 cells),
// and none in the wrapper (the mask is read as bytes, the kernels
// initialise their own counters and make the point count).  No float
// atomics.
//
// Scratch, O(N + digits x tiles + n_cells) per frame, laid out by the
// wrapper (ops/voxel_grid_cuda.py::sorted_sums_plan): the keys (N), up to
// two (key, index) buffers (2N each), the histograms (passes x tiles x
// 256), the tiles' mask counts, the cells' first and end positions
// (2 n_cells) and the sorted coordinates (3N floats).  At the default
// configuration (N = 131,072, 193,536 cells) that is 5.9 MB per frame (the
// counting sort it replaces kept a 49.5 MB count matrix and its offsets
// per frame).
//
// What bounds it on the H100: its bytes.  The function reads 13 bytes per
// point and writes 16 per cell (1.7 + 3.1 MB per default frame: ~1.4 us
// at 3.35 TB/s); the sort moves ~80 bytes per point and ~24 per cell
// through L2 and memory, so the design's floor is a few times the bound;
// the dense-cell case is bound by its chain of dependent f32 adds (~4
// cycles each), which the fixed order requires.  The double build reads 25
// bytes per point and writes 32 per cell; its sort moves the same keys,
// its last pass and its sum 24 bytes a point instead of 12, and its chain
// is one of dependent f64 adds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fp_half.cuh"

namespace {

constexpr int kTile = 2048;     // points per CTA in the key and radix stages
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = kTile / kWarps;   // 256 keys, 8 steps of 32
constexpr int kSteps = kPerWarp / 32;
constexpr int kRadix = 256;
constexpr int kLong = 2048;     // a longer cell's run is summed by its warp
// points whose loads a thread has in flight: 16 f32 points, 8 f64 ones
template <class T>
constexpr int kBatch = sizeof(T) == 4 ? 16 : 8;

// 16-byte loads of T: four floats or two doubles
__device__ __forceinline__ void unpack(const float4& w, float* q) {
  q[0] = w.x;
  q[1] = w.y;
  q[2] = w.z;
  q[3] = w.w;
}
__device__ __forceinline__ void unpack(const double2& w, double* q) {
  q[0] = w.x;
  q[1] = w.y;
}
template <class T>
using Vec16 = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
template <class T>
constexpr int kVecN = 16 / (int)sizeof(T);

struct BfParams {
  int gx, gy, gz, bx, by, bz, n_cells;
  float inv_xy, inv_z;  // f32(1/leaf): f64 constants cast to f32
};

__device__ __forceinline__ float bf16_rne(float v) {
  // round-to-nearest-even to the top 16 bits (finite inputs only)
  unsigned u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// The per-frame scratch, as ops/voxel_grid_cuda.py::sorted_sums_plan lays
// it out.
struct Scratch {
  int* keys;     // (S, N) pass 0's input: cell key, -1 when dropped
  int* pairs;    // up to 2 buffers of (S, N) keys then (S, N) indices
  int* hist;     // (passes, S, tiles, 256) digit counts per (tile, digit)
  int* tilecnt;  // (S, tiles) mask-nonzero points per tile
  int* cells;    // (S, 2, n_cells): each cell's first sorted position and
                 // one past its last (INT_MAX and 0 while empty)
  void* sorted;  // (S, N, 3) kept points' coordinates in key order (f32 or f64)
};

// Stage 1's common tail: the tile's histogram and mask count, the zeroing
// of the frame's share of the cell counters and later histograms.
__device__ __forceinline__ void key_tile_tail(int* s_hist, int mcount, int* s_red,
                                              const Scratch& sc, int S, int n_tiles,
                                              int n_passes, int n_cells) {
  const int s = blockIdx.y, tile = blockIdx.x, d = threadIdx.x;
  for (int o = 16; o > 0; o >>= 1) mcount += __shfl_xor_sync(0xffffffffu, mcount, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = mcount;
  __syncthreads();
  const size_t tile_row = ((size_t)s * n_tiles + tile) * kRadix;
  sc.hist[tile_row + d] = s_hist[d];
  for (int p = 1; p < n_passes; ++p)
    sc.hist[(size_t)p * S * n_tiles * kRadix + tile_row + d] = 0;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < kWarps; ++w) m += s_red[w];
    sc.tilecnt[(size_t)s * n_tiles + tile] = m;
  }
  const int per = (n_cells + n_tiles - 1) / n_tiles;
  int* first = sc.cells + (size_t)s * 2 * n_cells;
  const int hi = min(n_cells, (tile + 1) * per);
  for (int j = tile * per + threadIdx.x; j < hi; j += kThreads) {
    first[j] = 0x7fffffff;
    first[n_cells + j] = 0;
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
key_kernel(const T* __restrict__ pts, const uint8_t* __restrict__ mask, int S, int N,
           int n_tiles, int n_passes, BfParams p, Scratch sc) {
  __shared__ int s_hist[kRadix];
  __shared__ int s_red[kWarps];
  const int s = blockIdx.y, tile = blockIdx.x;
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const T* P = pts + (size_t)s * N * 3;
  const uint8_t* M = mask + (size_t)s * N;
  int* K = sc.keys + (size_t)s * N;
  int mcount = 0;
  const int end = min(N, (tile + 1) * kTile);
  for (int i = tile * kTile + threadIdx.x; i < end; i += kThreads) {
    int key = -1;
    if (M[i] != 0) {
      ++mcount;
      // the cell from the point rounded to f32 (a no-op on f32 points)
      const float fx = floorf(__fmul_rn((float)P[3 * i], p.inv_xy));
      const float fy = floorf(__fmul_rn((float)P[3 * i + 1], p.inv_xy));
      const float fz = floorf(__fmul_rn((float)P[3 * i + 2], p.inv_z));
      // bounds on the float floor, before any cast: NaN fails every compare
      if (fx >= (float)p.bx && fx < (float)(p.bx + p.gx) &&
          fy >= (float)p.by && fy < (float)(p.by + p.gy) &&
          fz >= (float)p.bz && fz < (float)(p.bz + p.gz)) {
        key = ((int)fx - p.bx) + p.gx * (((int)fy - p.by) + p.gy * ((int)fz - p.bz));
        atomicAdd(&s_hist[key & (kRadix - 1)], 1);
      }
    }
    K[i] = key;
  }
  __syncthreads();
  key_tile_tail(s_hist, mcount, s_red, sc, S, n_tiles, n_passes, p.n_cells);
}

// Stage 1 of the key entry: the keys given as grid indices.
__global__ void __launch_bounds__(kThreads)
key_idx_kernel(const int* __restrict__ ix, const int* __restrict__ iyz,
               const uint8_t* __restrict__ inb, int S, int N, int n_tiles, int n_passes,
               int gx, int gyz, Scratch sc) {
  __shared__ int s_hist[kRadix];
  __shared__ int s_red[kWarps];
  const int s = blockIdx.y, tile = blockIdx.x;
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int* X = ix + (size_t)s * N;
  const int* YZ = iyz + (size_t)s * N;
  const uint8_t* B = inb + (size_t)s * N;
  int* K = sc.keys + (size_t)s * N;
  int mcount = 0;
  const int end = min(N, (tile + 1) * kTile);
  for (int i = tile * kTile + threadIdx.x; i < end; i += kThreads) {
    int key = -1;
    const int x = X[i], yz = YZ[i];
    if (B[i] != 0) {
      ++mcount;
      if (x >= 0 && x < gx && yz >= 0 && yz < gyz) {
        key = yz * gx + x;
        atomicAdd(&s_hist[key & (kRadix - 1)], 1);
      }
    }
    K[i] = key;
  }
  __syncthreads();
  key_tile_tail(s_hist, mcount, s_red, sc, S, n_tiles, n_passes, gx * gyz);
}

// One LSD pass over digit (key >> shift) & 255.  Pass 0 reads the keys
// with their point index as the value and skips dropped keys; a later
// pass reads the previous pass's (key, index) pairs, the frame's n_kept of
// them.  The last pass writes the points' coordinates in sorted order,
// each cell's first and past-the-end position (integer atomicMin /
// atomicMax, one per cell and warp step) and, in tile 0, the frame's
// mask-nonzero count (when npts is given).
template <class T>
__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const T* __restrict__ pts, int S, int N, int n_tiles, int shift,
                  bool first, bool last, const int* __restrict__ kin,
                  const int* __restrict__ iin, int* __restrict__ kout, int* __restrict__ iout,
                  const int* __restrict__ hist, int* __restrict__ hist_next,
                  int* __restrict__ cells, int n_cells, T* __restrict__ sorted,
                  const int* __restrict__ tilecnt, int* __restrict__ npts) {
  __shared__ int s_base[kWarps][kRadix];   // per-warp counts, then bases
  __shared__ int s_off[kRadix];
  __shared__ int s_tpre[kRadix];
  __shared__ int s_key[kTile];
  __shared__ int s_val[kTile];
  __shared__ int s_wtot[kWarps];
  __shared__ int s_nin, s_tcount;
  const int s = blockIdx.y, tile = blockIdx.x;
  const int d = threadIdx.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // this tile's offset per digit: all earlier digits, then this digit in
  // the earlier tiles
  const int* H = hist + (size_t)s * n_tiles * kRadix;
  int total = 0, before = 0;
#pragma unroll 16
  for (int t = 0; t < n_tiles; ++t) {
    const int h = H[(size_t)t * kRadix + d];
    total += h;
    before += t < tile ? h : 0;
  }
  int inc = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) s_wtot[w] = inc;
  for (int v = 0; v < kWarps; ++v) s_base[v][d] = 0;
  __syncthreads();
  int wbase = 0;
  for (int v = 0; v < w; ++v) wbase += s_wtot[v];
  s_off[d] = wbase + inc - total + before;
  if (d == kRadix - 1) s_nin = wbase + inc;   // the frame's kept points
  __syncthreads();
  const int n_in = first ? N : s_nin;

  const size_t fo = (size_t)s * N;
  int kk[kSteps], vv[kSteps], rk[kSteps];
  const int e0 = tile * kTile + w * kPerWarp;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int e = e0 + 32 * k + lane;
    int key = -1, val = 0;
    if (e < n_in) {
      key = kin[fo + e];
      val = first ? e : iin[fo + e];
    }
    const int dig = key >= 0 ? (key >> shift) & (kRadix - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    const int leader = __ffs(peers) - 1;
    const int base = dig >= 0 ? s_base[w][dig] : 0;
    __syncwarp();
    if (dig >= 0 && lane == leader) s_base[w][dig] = base + __popc(peers);
    __syncwarp();
    rk[k] = base + __popc(peers & ((1u << lane) - 1u));
    kk[k] = key;
    vv[k] = val;
  }
  __syncthreads();
  {  // per-warp counts -> warp bases within the tile's digit run; the tile's
     // digit runs -> their start in the tile and their global offset
    int run = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int c = s_base[v][d];
      s_base[v][d] = run;
      run += c;
    }
    int tinc = run;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, tinc, o);
      if (lane >= o) tinc += u;
    }
    if (lane == 31) s_wtot[w] = tinc;
    __syncthreads();
    int tb = 0;
    for (int v = 0; v < w; ++v) tb += s_wtot[v];
    s_tpre[d] = tb + tinc - run;
    s_off[d] -= tb + tinc - run;        // global position = tile position + this
    if (d == kRadix - 1) s_tcount = tb + tinc;
  }
  __syncthreads();
  // the tile in digit order in shared memory, so the writes below go out
  // in runs of consecutive positions
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int key = kk[k];
    if (key >= 0) {
      const int dig = (key >> shift) & (kRadix - 1);
      const int lp = s_tpre[dig] + s_base[w][dig] + rk[k];
      s_key[lp] = key;
      s_val[lp] = vv[k];
    }
  }
  __syncthreads();

  const T* P = pts + fo * 3;
  int* cfirst = cells + (size_t)s * 2 * n_cells;
  const int m = s_tcount;
#pragma unroll
  for (int p0 = 0; p0 < kTile; p0 += kThreads) {
    const int p = p0 + threadIdx.x;
    const int key = p < m ? s_key[p] : -1;
    const int dest = key >= 0 ? p + s_off[(key >> shift) & (kRadix - 1)] : -1;
    if (last) {
      if (key >= 0) {
        T* D = sorted + (fo + dest) * 3;
        const int i = s_val[p];
        D[0] = P[3 * i];
        D[1] = P[3 * i + 1];
        D[2] = P[3 * i + 2];
      }
      // equal keys of a warp's run sit at consecutive positions
      const unsigned pk = __match_any_sync(0xffffffffu, key);
      const int top = 31 - __clz(pk);
      const int dest_top = __shfl_sync(0xffffffffu, dest, top);
      if (key >= 0 && lane == __ffs(pk) - 1) {
        atomicMin(&cfirst[key], dest);
        atomicMax(&cfirst[n_cells + key], dest_top + 1);
      }
    } else {
      if (key >= 0) {
        kout[fo + dest] = key;
        iout[fo + dest] = s_val[p];
      }
      const int nd = (key >> (shift + 8)) & (kRadix - 1);
      const int comb = key >= 0 ? (dest / kTile) * kRadix + nd : -1;
      const unsigned pk = __match_any_sync(0xffffffffu, comb);
      if (key >= 0 && lane == __ffs(pk) - 1)
        atomicAdd(&hist_next[(size_t)s * n_tiles * kRadix + comb], __popc(pk));
    }
  }
  if (last && npts != nullptr && tile == 0 && w == 0) {
    int m = 0;
    for (int t = lane; t < n_tiles; t += 32) m += tilecnt[(size_t)s * n_tiles + t];
    for (int o = 16; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
    if (lane == 0) npts[s] = m;
  }
}

// The values summed for one point: mode 0 the three bf16 parts of each
// coordinate (x h1, h2, h3, y ..., z ...), mode 1 the coordinates, in T
// (f32, or f64 for the double build; mode 0 is f32 alone).
template <int kMode, class T>
struct Parts {
  static constexpr int n = kMode == 0 ? 9 : 3;
  __device__ __forceinline__ static void of(const T* q, T* v) {
    if constexpr (kMode == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float h1 = bf16_rne(q[a]);
        const float r1 = __fsub_rn(q[a], h1);
        const float h2 = bf16_rne(r1);
        v[3 * a] = h1;
        v[3 * a + 1] = h2;
        v[3 * a + 2] = bf16_rne(__fsub_rn(r1, h2));
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = q[a];
    }
  }
  // the (sum_x, sum_y, sum_z) of the running sums
  __device__ __forceinline__ static void result(const T* acc, T* r) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      r[a] = kMode == 0 ? fp::add(fp::add(acc[3 * a], acc[3 * a + 1]), acc[3 * a + 2]) : acc[a];
  }
};

// How the sums add and store: in the points' type T (f32, f64), each add
// rounded to it; or, for the half builds, in the half type of policy H on
// f32 points that hold half values: each add rounded to H, as XLA's CPU
// scatter-add rounds each update of its half accumulator, and the count a
// half sum of ones -- exact up to 2^p (256 in bf16, 2,048 in f16), where
// adding 1 rounds back to it.
template <class T>
struct ExactAcc {
  using out_t = T;
  static __device__ __forceinline__ T add(T a, T b) { return fp::add(a, b); }
  static __device__ __forceinline__ out_t store(T v) { return v; }
  static __device__ __forceinline__ out_t count(int n) { return (T)n; }
};
template <class H>
struct HalfAcc {
  using out_t = typename H::storage;
  static __device__ __forceinline__ float add(float a, float b) { return fp::hadd<H>(a, b); }
  static __device__ __forceinline__ out_t store(float v) { return H::store(v); }
  static __device__ __forceinline__ out_t count(int n) {
    return H::store((float)min(n, H::kCountSat));
  }
};

template <int kMode, class T, class A = ExactAcc<T>>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const T* __restrict__ sorted, const int* __restrict__ cells, int S, int N,
           int n_cells, typename A::out_t* __restrict__ out) {
  using Pt = Parts<kMode, T>;
  constexpr int B = kBatch<T>, V = kVecN<T>;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = t < S * n_cells;
  int s = 0, cell = 0, lo = 0, hi = 0;
  if (valid) {
    s = t / n_cells;
    cell = t - s * n_cells;
    const int* first = cells + (size_t)s * 2 * n_cells;
    const int f = first[cell], e = first[n_cells + cell];   // empty: INT_MAX, 0
    lo = e > f ? f : 0;
    hi = e > f ? e : 0;
  }
  const bool is_long = valid && hi - lo > kLong;
  T acc[Pt::n], v[Pt::n], r[3];
#pragma unroll
  for (int k = 0; k < Pt::n; ++k) acc[k] = T(0);
  if (valid && !is_long) {
    // the thread's own run: single points up to a multiple of V (the values
    // per 16 bytes), then B points at a time as 16-byte loads, all in
    // flight before their adds (the frame's rows start 16-byte aligned
    // when N % V == 0)
    const T* src = sorted + (size_t)s * N * 3;
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    int j = lo;
    for (; vec && j < hi && (j % V); ++j) {
      Pt::of(src + 3 * (size_t)j, v);
#pragma unroll
      for (int k = 0; k < Pt::n; ++k) acc[k] = A::add(acc[k], v[k]);
    }
    for (; j + B <= hi; j += B) {
      T q[3 * B];
      if (vec) {
        const Vec16<T>* q4 = reinterpret_cast<const Vec16<T>*>(src + 3 * (size_t)j);
#pragma unroll
        for (int e = 0; e < 3 * B / V; ++e) unpack(q4[e], q + V * e);
      } else {
#pragma unroll
        for (int e = 0; e < 3 * B; ++e) q[e] = src[3 * (size_t)j + e];
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        Pt::of(q + 3 * u, v);
#pragma unroll
        for (int k = 0; k < Pt::n; ++k) acc[k] = A::add(acc[k], v[k]);
      }
    }
    for (; j < hi; ++j) {
      Pt::of(src + 3 * (size_t)j, v);
#pragma unroll
      for (int k = 0; k < Pt::n; ++k) acc[k] = A::add(acc[k], v[k]);
    }
  }
  Pt::result(acc, r);

  // long runs: the whole warp stages 32 points at a time (one coalesced
  // load, the parts computed in parallel), every lane adds them in order
  // through shuffles (the same sums on every lane), the owner keeps them
  unsigned longs = __ballot_sync(0xffffffffu, is_long);
  while (longs) {
    const int L = __ffs(longs) - 1;
    longs &= longs - 1;
    const int llo = __shfl_sync(0xffffffffu, lo, L), lhi = __shfl_sync(0xffffffffu, hi, L);
    const T* src = sorted + (size_t)__shfl_sync(0xffffffffu, s, L) * N * 3;
#pragma unroll
    for (int k = 0; k < Pt::n; ++k) acc[k] = T(0);
    for (int b = llo; b < lhi; b += 32) {
      const int j = b + lane;
      if (j < lhi) {
        Pt::of(src + 3 * (size_t)j, v);
      } else {
#pragma unroll
        for (int k = 0; k < Pt::n; ++k) v[k] = T(0);
      }
      if (lhi - b >= 32) {
#pragma unroll
        for (int q = 0; q < 32; ++q) {
#pragma unroll
          for (int k = 0; k < Pt::n; ++k)
            acc[k] = A::add(acc[k], __shfl_sync(0xffffffffu, v[k], q));
        }
      } else {
        for (int q = 0; q < lhi - b; ++q) {
#pragma unroll
          for (int k = 0; k < Pt::n; ++k)
            acc[k] = A::add(acc[k], __shfl_sync(0xffffffffu, v[k], q));
        }
      }
    }
    if (lane == L) Pt::result(acc, r);
  }
  if (valid) {
    typename A::out_t* O = out + (size_t)s * 4 * n_cells;
    O[cell] = A::store(r[0]);
    O[n_cells + cell] = A::store(r[1]);
    O[2 * n_cells + cell] = A::store(r[2]);
    O[3 * n_cells + cell] = A::count(hi - lo);
  }
}

int passes_for(int n_cells) {
  int bits = 1;
  while (bits < 31 && (1 << bits) < n_cells) ++bits;
  return (bits + 7) / 8;
}

bool bad_plan(int S, int N, int n_tiles, int n_passes, int n_cells) {
  return S < 1 || N < 1 || n_cells < 1 || n_tiles != (N + kTile - 1) / kTile ||
         n_passes != passes_for(n_cells) || (long long)S * n_cells > 0x7fffffffLL;
}

// Stages 2-3 of every entry, after stage 1 has written the keys and the
// first histogram and initialised the rest; T the points' and sums' type.
template <int kMode, class T, class A = ExactAcc<T>>
int launch_sorted_sums(const T* pts, int S, int N, int n_tiles, int n_passes,
                       const Scratch& sc, int n_cells, typename A::out_t* out, int* npts,
                       cudaStream_t st) {
  const size_t frame = (size_t)S * N;
  const size_t hist_pass = (size_t)S * n_tiles * kRadix;
  T* sorted = static_cast<T*>(sc.sorted);
  const int* kin = sc.keys;
  const int* iin = nullptr;
  for (int p = 0; p < n_passes; ++p) {
    const bool last = p == n_passes - 1;
    int* kout = sc.pairs + (size_t)(p % 2) * 2 * frame;
    int* iout = kout + frame;
    radix_pass_kernel<T><<<dim3(n_tiles, S), kThreads, 0, st>>>(
        pts, S, N, n_tiles, 8 * p, p == 0, last, kin, iin, last ? nullptr : kout,
        last ? nullptr : iout, sc.hist + p * hist_pass,
        last ? nullptr : sc.hist + (p + 1) * hist_pass, sc.cells, n_cells, sorted,
        sc.tilecnt, npts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kin = kout;
    iin = iout;
  }
  const long long total = (long long)S * n_cells;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  sum_kernel<kMode, T, A><<<blocks, kThreads, 0, st>>>(sorted, sc.cells, S, N, n_cells, out);
  return (int)cudaGetLastError();
}

template <class T, class A = ExactAcc<T>>
int launch_points(const T* pts, const uint8_t* mask, int S, int N, int n_tiles, int n_passes,
                  const Scratch& sc, typename A::out_t* out, int* npts, const BfParams& p,
                  int mode, cudaStream_t st) {
  key_kernel<T><<<dim3(n_tiles, S), kThreads, 0, st>>>(pts, mask, S, N, n_tiles, n_passes, p,
                                                       sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same<A, ExactAcc<float>>::value) {
    if (mode == 0)
      return launch_sorted_sums<0, T>(pts, S, N, n_tiles, n_passes, sc, p.n_cells, out, npts,
                                      st);
  }
  return launch_sorted_sums<1, T, A>(pts, S, N, n_tiles, n_passes, sc, p.n_cells, out, npts,
                                     st);
}

// The key entries: stage 1 from the given bins (yz * gx + x), then the
// sums of mode kMode in the points' type T.
template <int kMode, class T>
int launch_keys(const T* pts, const int* ix, const int* iyz, const uint8_t* inb, int S, int N,
                int n_tiles, int n_passes, const Scratch& sc, T* out, int gx, int gyz,
                void* stream) {
  if (gx < 1 || gyz < 1 || (long long)gx * gyz > 0x7fffffffLL ||
      bad_plan(S, N, n_tiles, n_passes, gx * gyz))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  key_idx_kernel<<<dim3(n_tiles, S), kThreads, 0, st>>>(ix, iyz, inb, S, N, n_tiles, n_passes,
                                                        gx, gyz, sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sorted_sums<kMode, T>(pts, S, N, n_tiles, n_passes, sc, gx * gyz, out, nullptr,
                                      st);
}

}  // namespace

// points (S, N, 3) f32, mask (S, N) u8 (nonzero = keep).  Scratch from the
// caller, laid out by ops/voxel_grid_cuda.py::sorted_sums_plan for
// n_tiles = ceil(N / kTile) tiles and n_passes = ceil(bits(n_cells) / 8)
// digits (checked here): keys, pairs, hist, tilecnt, cells, sorted, none
// of which needs zeroing.  Output out (S, 4, n_cells) f32 [sum_x, sum_y,
// sum_z, count] (mode 0 the bf16x3 sums, mode 1 the plain f32 sums) and
// npts (S,) i32, the mask-nonzero points per frame.
extern "C" int motl_voxel_bf16x3(
    const float* pts, const uint8_t* mask, int S, int N, int n_tiles, int n_passes,
    int* keys, int* pairs, int* hist, int* tilecnt, int* cells, float* sorted, float* out,
    int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz, float inv_xy,
    float inv_z, int mode, void* stream) {
  if (bad_plan(S, N, n_tiles, n_passes, n_cells) || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const BfParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z};
  const Scratch sc{keys, pairs, hist, tilecnt, cells, sorted};
  return launch_points<float>(pts, mask, S, N, n_tiles, n_passes, sc, out, npts, p, mode,
                              (cudaStream_t)stream);
}

// The double build of mode 1: points (S, N, 3) f64, their cells from the
// points rounded to f32; sorted (S, N, 3) and out (S, 4, n_cells) f64 (the
// f64 sums in ascending point index and the count); the rest as
// motl_voxel_bf16x3.
extern "C" int motl_voxel_sums_f64(
    const double* pts, const uint8_t* mask, int S, int N, int n_tiles, int n_passes,
    int* keys, int* pairs, int* hist, int* tilecnt, int* cells, double* sorted, double* out,
    int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz, float inv_xy,
    float inv_z, void* stream) {
  if (bad_plan(S, N, n_tiles, n_passes, n_cells)) return (int)cudaErrorInvalidValue;
  const BfParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z};
  const Scratch sc{keys, pairs, hist, tilecnt, cells, sorted};
  return launch_points<double>(pts, mask, S, N, n_tiles, n_passes, sc, out, npts, p, 1,
                               (cudaStream_t)stream);
}

// K6f's half builds of mode 1 (motl_voxel_sums_bf16 / _f16, the JAX half
// route's scatter-add, ops/voxel.py:55-97 under dtype="bfloat16" /
// "float16"): points (S, N, 3) f32 holding half values (the frame's points
// rounded to the half type and widened), their cells as the f32 build's;
// sorted (S, N, 3) f32; out (S, 4, n_cells) of the half type -- each sum
// from +0 in ascending point index, every add rounded to the half type,
// the count the half sum of ones; the rest as motl_voxel_bf16x3.
template <class H>
int voxel_sums_half(const float* pts, const uint8_t* mask, int S, int N, int n_tiles,
                    int n_passes, int* keys, int* pairs, int* hist, int* tilecnt, int* cells,
                    float* sorted, typename H::storage* out, int* npts, int n_cells, int gx,
                    int gy, int gz, int bx, int by, int bz, float inv_xy, float inv_z,
                    void* stream) {
  if (bad_plan(S, N, n_tiles, n_passes, n_cells)) return (int)cudaErrorInvalidValue;
  const BfParams p{gx, gy, gz, bx, by, bz, n_cells, inv_xy, inv_z};
  const Scratch sc{keys, pairs, hist, tilecnt, cells, sorted};
  return launch_points<float, HalfAcc<H>>(pts, mask, S, N, n_tiles, n_passes, sc, out, npts, p,
                                          1, (cudaStream_t)stream);
}

// The key entry: ix, iyz (S, N) i32 and in_bounds (S, N) u8 instead of the
// mask and the grid geometry; n_cells = gyz * gx in iyz-major order.  The
// bf16x3 sums of mode 0; the same scratch and output as motl_voxel_bf16x3,
// without the point count.
extern "C" int motl_voxel_bf16x3_keys(
    const float* pts, const int* ix, const int* iyz, const uint8_t* inb, int S, int N,
    int n_tiles, int n_passes, int* keys, int* pairs, int* hist, int* tilecnt, int* cells,
    float* sorted, float* out, int gx, int gyz, void* stream) {
  const Scratch sc{keys, pairs, hist, tilecnt, cells, sorted};
  return launch_keys<0, float>(pts, ix, iyz, inb, S, N, n_tiles, n_passes, sc, out, gx, gyz,
                               stream);
}

// K6f's key entry (ops/voxel.py::voxel_downsample_sort's sums, by run): the
// arguments of motl_voxel_bf16x3_keys, each bin's coordinates summed as
// mode 1 sums them -- from +0.0, in ascending point index, one rounded f32
// add at a time -- and its count.
extern "C" int motl_voxel_sums_keys(
    const float* pts, const int* ix, const int* iyz, const uint8_t* inb, int S, int N,
    int n_tiles, int n_passes, int* keys, int* pairs, int* hist, int* tilecnt, int* cells,
    float* sorted, float* out, int gx, int gyz, void* stream) {
  const Scratch sc{keys, pairs, hist, tilecnt, cells, sorted};
  return launch_keys<1, float>(pts, ix, iyz, inb, S, N, n_tiles, n_passes, sc, out, gx, gyz,
                               stream);
}

// Its double build: points, sorted and out f64, the sums in f64.
extern "C" int motl_voxel_sums_keys_f64(
    const double* pts, const int* ix, const int* iyz, const uint8_t* inb, int S, int N,
    int n_tiles, int n_passes, int* keys, int* pairs, int* hist, int* tilecnt, int* cells,
    double* sorted, double* out, int gx, int gyz, void* stream) {
  const Scratch sc{keys, pairs, hist, tilecnt, cells, sorted};
  return launch_keys<1, double>(pts, ix, iyz, inb, S, N, n_tiles, n_passes, sc, out, gx, gyz,
                                stream);
}

// K6f's half builds (voxel_sums_half above): points and sorted f32, out
// (S, 4, n_cells) bf16 / f16.
extern "C" int motl_voxel_sums_bf16(
    const float* pts, const uint8_t* mask, int S, int N, int n_tiles, int n_passes,
    int* keys, int* pairs, int* hist, int* tilecnt, int* cells, float* sorted,
    __nv_bfloat16* out, int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz,
    float inv_xy, float inv_z, void* stream) {
  return voxel_sums_half<fp::BF16>(pts, mask, S, N, n_tiles, n_passes, keys, pairs, hist,
                                   tilecnt, cells, sorted, out, npts, n_cells, gx, gy, gz, bx, by,
                                   bz, inv_xy, inv_z, stream);
}

extern "C" int motl_voxel_sums_f16(
    const float* pts, const uint8_t* mask, int S, int N, int n_tiles, int n_passes,
    int* keys, int* pairs, int* hist, int* tilecnt, int* cells, float* sorted, __half* out,
    int* npts, int n_cells, int gx, int gy, int gz, int bx, int by, int bz, float inv_xy,
    float inv_z, void* stream) {
  return voxel_sums_half<fp::F16>(pts, mask, S, N, n_tiles, n_passes, keys, pairs, hist,
                                  tilecnt, cells, sorted, out, npts, n_cells, gx, gy, gz, bx, by,
                                  bz, inv_xy, inv_z, stream);
}
