// The eps-scaling Jacobi auction of association="hungarian", as a device
// function that one warp runs for one (D, K) problem: every phase and its
// convergence test inside, no host sync.  K4's Hungarian builds
// (csrc/assign.cu) run it as the decision stage of the track step; K12
// (csrc/auction.cu) runs it alone on given cost matrices.
//
// Replaces no TPU kernel: the JAX package runs multiple_object_tracking_
// lidar_tpu/ops/hungarian.py::auction_assign (:34) as jnp inside a bounded
// while_loop per phase.  Its semantics, kept exactly (the plain version is
// ops/hungarian.py::auction_assign_plain):
//   - a square problem of n = D + K rows and columns: real row r < D sees
//     value(r, c) = -cost or NEG on real column c < K and -penalty on each
//     of the D virtual columns; every dummy row r >= D sees -penalty2 on
//     every column;
//   - each phase resets the owners, keeps the prices, and iterates while a
//     row is unassigned and fewer than max_iters iterations have run: every
//     unassigned row takes net = value - price, its first maximum (best_v
//     at best_k), the maximum over the other columns (second_v; if that is
//     <= NEG / 2, best_v), and bids (price[best_k] + (best_v - second_v)) +
//     eps_p on best_k; each column bid on goes to its highest bid, the
//     first row on ties, at that price, and its previous owner becomes
//     unassigned; a phase cut at max_iters with a row unassigned counts as
//     saturated.
//
// What bounds it on the H100: latency.  The iterations are sequential and
// many (the dummy rows win one column per iteration, so a phase takes at
// least K of them; on the headline's D = 32, K = 64 the four phases run
// 64 + 560 + 560 + 250, and from K = 256 the second phase reaches the
// 3,000 cap), so the design keeps an iteration to one warp, no block
// barrier and as few dependent steps as it can:
//   - per-column state (price, owner, each row's column, the bid keys) in
//     shared memory, about 28 KB at n = 1,152 with the lists;
//   - the cost recomputed from the problem's inputs, never stored (K4: the
//     detections and the slots' last x / y in shared memory; (D, K) f32
//     would be 512 KB at K = 1,024, D = 128);
//   - the dummy rows' shortcut: they all see the same value row, so every
//     unassigned dummy row has the same best column and the same bid, and
//     of them only the first (smallest index) can win; one bid stands for
//     them all, which cuts an iteration from n^2 work to (unassigned real
//     rows) * K + n.  The tests hold it against the literal plain version;
//   - the column summaries the bids need -- the dummy nets' top two over
//     all columns, the virtual nets' (fp::sub(neg_pen, price), c >= K) top
//     two, the first unassigned dummy row -- kept per lane over the lane's
//     columns c = lane, lane + 32, ... (and the rows of the same indices),
//     keyed on the rounded nets with first-index ties (two f32 prices may
//     round to one net), and recomputed only where a price or an owner
//     changed (one to three lanes' columns in a dummy-only iteration),
//     never by a pass over all n columns: the marked lanes recompute
//     theirs with four loads in flight (interleaved accumulators merged by
//     index); in a dummy-only iteration past n = 256 (8 columns a lane) the
//     whole warp recomputes the changed column's lane instead (32
//     lanes over its n / 32 columns, then one warp top two) and searches
//     the first free row past the one just taken, 32 rows a step; a freed
//     row is at most its lane's new minimum.  The warp's top two and
//     first dummy row come from the lanes' by single-instruction warp
//     reductions, two deep;
//   - most iterations have no real row unassigned (66-68% on the headline's
//     and the dense scene's own problems, 86% at K = 1,024): then the only
//     bid is the first free dummy row's, on the dummy top two's column, and
//     it wins.  That iteration takes no key table, atomics, ballots or bid
//     list: every lane reads the column and computes the bid, and each
//     table entry is written by the lane that owns its index; the column's
//     old owner is freed, and once a real row is freed (evicted) the
//     general iteration resumes.  Each is one iteration (the count per
//     phase, the cap and the convergence test are the plain version's);
//   - in the general iteration each real row's feasible columns are listed
//     once per problem (up to kMaxFeas = 4: a detection gates a few
//     tracks), so the unassigned real rows bid one per lane in one pass,
//     each over its list and the virtual columns' top two (a row whose list
//     overflowed scans all K columns with the whole warp): real rows are
//     evicted and re-bid many times a phase, and a warp-wide scan of K
//     columns per re-bid, in turn, costs more than the whole iteration else
//     (PERF.md §6);
//   - each column's winner by one 64-bit atomicMax on a packed key: the high
//     word is the bid's order-preserving bits, the low word ~row, so the max
//     is exact in any order and ties go to the first row (a max, not a
//     float sum).

// Arithmetic: every f32 sum and difference __fadd_rn / __fsub_rn, in the
// order JAX writes them; the comparisons strict where argmax and max put
// them (a later equal value never takes the first maximum's place).  A
// summary is the one-pass top two of the same nets, so every bid is the
// one the full pass gave.
//
// The tables come in two forms with the same indexing: AuctionScratch /
// WideKeys, arrays of compile-time size in static shared memory (K4's narrow
// builds, K12), and AuctionTables / WideTables, pointers to tables sized at
// run time for n = D + K columns (K4 xl, csrc/assign.cu: in dynamic shared
// memory while they fit, in device memory past that).  The device functions
// take either; the arrays of compile-time size keep their builds' code.
//
// Templated on the float type T of the values, prices and bids: float for
// K4's f32 builds and K12, double for K4's double builds (dtype="float64";
// the JAX auction runs in the costs' dtype, with _NEG, the penalties and
// eps_p in f64), and HV<H> (fp_half.cuh: a bf16 / f16 value's bits) for
// the half builds of K4 and K12 (dtype="bfloat16" / "float16": every sum
// and difference computed in f32 and rounded once to the half dtype, as
// XLA's CPU code computes them; auction_half.cuh holds HV's warp top two).
// A half value is an f32 value, so the half builds key their bids as the
// f32 build does (bid_key of the widened bid, exact).  In f16 _NEG and _NEG
// / 2 are -inf (the JAX cast overflows): an infeasible pair's value is
// -inf, never a row's first maximum, and the second-maximum rule keeps
// best_v only for -inf; the lists and summaries need nothing else.  A 64-bit word cannot hold a double bid beside its row, so
// the double build picks each column's winner in two steps: one 64-bit
// atomicMax of the bid's order-preserving bits, then, after a __syncwarp,
// an atomicMin of the row among the bids equal to that maximum -- the same
// (largest bid, then first row) rule, exact in any order.  Its warp top two
// reduce the order-preserving 64-bit words as two 32-bit halves (the high
// half's max, then the low half's among the lanes holding it).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "fp_rn.cuh"

namespace motl_auction {

constexpr int kMaxRows = 128;    // real rows (detections): K4's bound
constexpr int kMaxPhases = 16;   // eps phases (4 at the defaults)
constexpr int kMaxFeas = 4;      // a row's listed feasible columns; past it the row scans all K
constexpr int kSmallCols = 256;  // past here (8 columns a lane) the warp recomputes a lane's summaries
constexpr unsigned kFull = 0xffffffffu;

template <class T>
struct AuctionParams {
  T neg;        // _NEG in T: an infeasible pair's value
  T neg_half;   // _NEG / 2 in T: the second-maximum and "took" threshold
  T neg_pen;    // -penalty in T: a real row's value on a virtual column
  T neg_pen2;   // -penalty2 in T: a dummy row's value everywhere
  T eps[kMaxPhases];
  int n_phases;
  int max_iters;
};

// Host: the parameters from the wrapper's values [neg, neg_half, neg_pen,
// neg_pen2, eps_0, ..., eps_{n_phases - 1}] of type T; false when out of
// range.
template <class T>
inline bool read_params(const T* f, int n_phases, int max_iters, AuctionParams<T>* p) {
  if (f == nullptr || n_phases < 1 || n_phases > kMaxPhases || max_iters < 0) return false;
  p->neg = f[0];
  p->neg_half = f[1];
  p->neg_pen = f[2];
  p->neg_pen2 = f[3];
  for (int i = 0; i < kMaxPhases; ++i) p->eps[i] = i < n_phases ? f[4 + i] : T{};
  p->n_phases = n_phases;
  p->max_iters = max_iters;
  return true;
}

template <class T, int kCols>
struct AuctionScratch {
  T price[kCols];
  int owner[kCols];              // column -> row, -1 unowned
  int row_col[kCols];            // row -> column, -1 unassigned
  unsigned long long key[kCols];  // this iteration's best bid per column, 0 none
  int bid_col[kMaxRows + 1];     // this iteration's bids: column and row
  int bid_row[kMaxRows + 1];
  int feas_n[kMaxRows];          // each real row's feasible columns, ascending
  int feas_col[kMaxRows][kMaxFeas];
  T feas_val[kMaxRows][kMaxFeas];
};

// The double build's second step: each bid's value, and each column's
// winning row (INT_MAX none).
template <int kCols>
struct WideKeys {
  double bid_val[kMaxRows + 1];
  int krow[kCols];
};

// AuctionScratch's tables as pointers, for D real rows and n = D + K
// columns sized at run time: price, owner, row_col and key hold n entries,
// bid_col and bid_row D + 1, feas_n, feas_col and feas_val D.
template <class T>
struct AuctionTables {
  T* price;
  int* owner;
  int* row_col;
  unsigned long long* key;
  int* bid_col;
  int* bid_row;
  int* feas_n;
  int (*feas_col)[kMaxFeas];
  T (*feas_val)[kMaxFeas];
};

// WideKeys's as pointers: bid_val D + 1 entries, krow n.
struct WideTables {
  double* bid_val;
  int* krow;
};

// The largest value, the first index holding it, and the largest value at
// any other index.
template <class T>
struct Top2 {
  T v1;
  int i1;
  T v2;
};

template <class T>
__device__ __forceinline__ Top2<T> top2_empty() {
  return {T(-INFINITY), 0x7fffffff, T(-INFINITY)};
}

// Push value x at index i; a lane pushes in ascending i.
template <class T>
__device__ __forceinline__ void top2_push(Top2<T>& t, T x, int i) {
  if (x > t.v1) {
    t.v2 = t.v1;
    t.v1 = x;
    t.i1 = i;
  } else if (x > t.v2) {
    t.v2 = x;
  }
}

// Merge two disjoint index sets: the larger v1 wins, the smaller index on
// ties; the loser's v1 becomes a candidate second.
template <class T>
__device__ __forceinline__ Top2<T> top2_merge(Top2<T> a, Top2<T> b) {
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1)) return {b.v1, b.i1, fmax(a.v1, b.v2)};
  return {a.v1, a.i1, fmax(a.v2, b.v1)};
}

// A float's bits as an unsigned word of the same order (-0 first made +0,
// which compares equal to it; no NaN reaches here), and back.
__device__ __forceinline__ unsigned ord_bits(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ord(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The warp's top two from each lane's, by warp reductions (one instruction
// each on sm_80 and later), two deep: the largest first value; then at once
// the smallest index holding it, how many lanes hold it, and the largest of
// every other lane's first value and the holders' seconds -- the second is
// that unless two lanes hold the first value (then it is the first value).
__device__ __forceinline__ Top2<float> top2_warp(Top2<float> t) {
  const unsigned o1 = ord_bits(t.v1);
  const unsigned best = __reduce_max_sync(kFull, o1);
  const bool holds = o1 == best;
  const int bi = __reduce_min_sync(kFull, holds ? t.i1 : 0x7fffffff);
  const unsigned sec = __reduce_max_sync(kFull, holds ? ord_bits(t.v2) : o1);
  const bool tie = __popc(__ballot_sync(kFull, holds)) > 1;
  return {from_ord(best), bi, from_ord(tie ? best : sec)};
}

__device__ __forceinline__ int min_warp(int v) { return __reduce_min_sync(kFull, v); }

// A bid and its row as one key whose unsigned order is (bid, then smaller
// row): the bid's bits mapped to an order-preserving unsigned word.
__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  unsigned u = __float_as_uint(bid);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~row);
}

__device__ __forceinline__ float key_bid(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_row(unsigned long long key) { return ~(int)(unsigned)key; }

// A double's bits as an unsigned 64-bit word of the same order (-0 first
// made +0; no NaN reaches here, and no key is 0), and back.
__device__ __forceinline__ unsigned long long ord_bits64(double x) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(__dadd_rn(x, 0.0));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

__device__ __forceinline__ double from_ord64(unsigned long long u) {
  return __longlong_as_double((long long)((u >> 63) ? (u & ~(1ull << 63)) : ~u));
}

// The max of an order-preserving 64-bit word over the warp: the high
// halves' max, then the low halves' among the lanes holding it.
__device__ __forceinline__ unsigned long long max_warp64(unsigned long long u) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(u >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(u >> 32) == hi ? (unsigned)u : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// The double build's warp top two: top2_warp<float>'s steps on the 64-bit
// order-preserving words (the same value, first index and second as five
// butterfly rounds of top2_merge give).
__device__ __forceinline__ Top2<double> top2_warp(Top2<double> t) {
  const unsigned long long o1 = ord_bits64(t.v1);
  const unsigned long long best = max_warp64(o1);
  const bool holds = o1 == best;
  const int bi = __reduce_min_sync(kFull, holds ? t.i1 : 0x7fffffff);
  const unsigned long long sec = max_warp64(holds ? ord_bits64(t.v2) : o1);
  const bool tie = __popc(__ballot_sync(kFull, holds)) > 1;
  return {from_ord64(best), bi, from_ord64(tie ? best : sec)};
}

// The bid of a row whose net values have top two t.
template <class T>
__device__ __forceinline__ T bid_of(const Top2<T>& t, T price_best, T eps, T neg_half) {
  const T second = t.v2 <= neg_half ? t.v1 : t.v2;
  return fp::add(fp::add(price_best, fp::sub(t.v1, second)), eps);
}

// Enter a bid on column c for row r: the f32 and half builds' packed key
// (a half bid widened to f32, exactly), or the double build's bid bits (its
// row settles in the second step).
template <class T, class Tab>
__device__ __forceinline__ void place_bid(Tab& sm, int c, T bid, int r) {
  if constexpr (sizeof(T) != sizeof(double))
    atomicMax(&sm.key[c], bid_key(static_cast<float>(bid), r));
  else
    atomicMax(&sm.key[c], ord_bits64(bid));
}

// Each real row's feasible columns (value != neg), ascending, up to
// kMaxFeas of them, and their count (past kMaxFeas the row scans all K
// columns when it bids).  The warps of the block split the rows: warp w of
// n_warps takes rows w, w + n_warps, ...  An infeasible column never
// decides a bid: its net (NEG - price) is below NEG / 2, so it is neither a
// row's first maximum (a virtual column beats it) nor a second maximum the
// NEG / 2 rule keeps.  The caller synchronises before the auction reads them.
template <class T, class Tab, class Value>
__device__ void auction_lists(const Value& value, int D, int K, T neg, Tab& sm, int warp,
                              int n_warps) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int r = warp; r < D; r += n_warps) {
    int cnt = 0;
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int c = c0 + lane;
      const T v = c < K ? value(r, c) : neg;
      const bool f = v != neg;
      const unsigned m = __ballot_sync(kFull, f);
      const int q = cnt + __popc(m & below);
      if (f && q < kMaxFeas) {
        sm.feas_col[r][q] = c;
        sm.feas_val[r][q] = v;
      }
      cnt += __popc(m);
    }
    if (lane == 0) sm.feas_n[r] = cnt;
  }
}

// A lane's column summaries, recomputed from the tables.  The lane's
// columns are c = lane, lane + 32, ... < n (and its rows the same
// indices).  Each pushes its columns in ascending order into accumulators
// over interleaved columns, merged by top2_merge (disjoint index sets,
// first index on ties), so that the loads are in flight together and the
// pushes' dependent chains short; the result is the one-pass push's.
//
// The top two dummy nets (neg_pen2 - price) over all the lane's columns.
template <class T, class Tab>
__device__ __forceinline__ Top2<T> lane_dummy_top2(const Tab& sm, T neg_pen2, int n) {
  Top2<T> a[4] = {top2_empty<T>(), top2_empty<T>(), top2_empty<T>(), top2_empty<T>()};
  int c = threadIdx.x & 31;
  for (; c + 96 < n; c += 128) {
    T q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = sm.price[c + 32 * k];
#pragma unroll
    for (int k = 0; k < 4; ++k) top2_push(a[k], fp::sub(neg_pen2, q[k]), c + 32 * k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (c + 32 * k < n) top2_push(a[k], fp::sub(neg_pen2, sm.price[c + 32 * k]), c + 32 * k);
  return top2_merge(top2_merge(a[0], a[1]), top2_merge(a[2], a[3]));
}

// The top two virtual nets (neg_pen - price) over the lane's columns c >= K.
template <class T, class Tab>
__device__ __forceinline__ Top2<T> lane_virtual_top2(const Tab& sm, T neg_pen, int n, int K) {
  const int lane = threadIdx.x & 31;
  Top2<T> a = top2_empty<T>(), b = top2_empty<T>();
  int c = K <= lane ? lane : lane + ((K - lane + 31) >> 5) * 32;
  for (; c + 32 < n; c += 64) {
    const T p0 = sm.price[c], p1 = sm.price[c + 32];
    top2_push(a, fp::sub(neg_pen, p0), c);
    top2_push(b, fp::sub(neg_pen, p1), c + 32);
  }
  if (c < n) top2_push(a, fp::sub(neg_pen, sm.price[c]), c);
  return top2_merge(a, b);
}

// The lane's first unassigned dummy row at or after `from` (from >= D, a
// row of the lane): INT_MAX none.
template <class Tab>
__device__ __forceinline__ int lane_first_free(const Tab& sm, int n, int from) {
  int c = from;
  for (; c + 96 < n; c += 128) {
    int r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = sm.row_col[c + 32 * k];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r[k] < 0) return c + 32 * k;
  }
  for (; c < n; c += 32)
    if (sm.row_col[c] < 0) return c;
  return INT_MAX;
}

// The lane's first dummy row (>= D).
__device__ __forceinline__ int lane_first_dummy(int D) {
  const int lane = threadIdx.x & 31;
  return D <= lane ? lane : lane + ((D - lane + 31) >> 5) * 32;
}

// Lane `ln`'s dummy top two (and, with want_v, virtual top two) computed by
// the whole warp: lane k pushes the columns ln + 32 (k + 32 m), m = 0, 1,
// ..., in ascending order, and the warp's top two combine them -- the same
// values and first index as lane ln's own pass, at one warp reduction's
// latency instead of n / 32 pushes.
template <class T, class Tab>
__device__ __forceinline__ void warp_lane_top2(const Tab& sm, const AuctionParams<T>& p, int n,
                                               int K, int ln, bool want_v, Top2<T>& d,
                                               Top2<T>& v) {
  Top2<T> a = top2_empty<T>(), b = top2_empty<T>();
  for (int c = ln + 32 * (threadIdx.x & 31); c < n; c += 1024) {
    const T pc = sm.price[c];
    top2_push(a, fp::sub(p.neg_pen2, pc), c);
    if (c >= K) top2_push(b, fp::sub(p.neg_pen, pc), c);
  }
  d = top2_warp(a);
  if (want_v) v = top2_warp(b);
}

// The first unassigned row of from, from + 32, ... (< n), searched by the
// whole warp 32 rows a step (INT_MAX none; the same in every lane).
template <class Tab>
__device__ __forceinline__ int warp_first_free(const Tab& sm, int n, int from) {
  for (int base = from; base < n; base += 1024) {
    const int r = base + 32 * (threadIdx.x & 31);
    const unsigned m = __ballot_sync(kFull, r < n && sm.row_col[r] < 0);
    if (m) return base + 32 * (__ffs(m) - 1);
  }
  return INT_MAX;
}

// The auction over D real rows and K real columns, run by the 32 lanes of
// one warp (the only threads that touch `sm` until it returns) on the lists
// of auction_lists.  value(r, c) gives a real row's value on a real column
// (-cost, or p.neg where the pair is infeasible); it is read again only for
// a row whose list overflowed.  On return sm.row_col[r] (r < D) is the
// column row r owns after the last phase (a real one when < K, else
// virtual; -1 if unassigned) and sm.owner[c] column c's owner; returns the
// saturated phase count (the same in every lane).  iters_out, when given,
// receives each phase's iterations (lane 0 writes), and fast_out those
// of them with no real row unassigned (the dummy-only ones).  wk is the double
// build's second-step scratch (unused, and may be null, in the f32 build).
// D >= 1, K >= 1, and the tables hold D rows and D + K columns (kMaxRows
// and kCols for AuctionScratch).
template <class T, class Tab, class Wide, class Value>
__device__ int auction_warp(const Value& value, int D, int K, const AuctionParams<T>& p,
                            Tab& sm, Wide* wk, int* iters_out, int* fast_out = nullptr) {
  constexpr bool kWide = sizeof(T) == sizeof(double);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n = D + K;
  const bool small = n <= kSmallCols;
  for (int c = lane; c < n; c += 32) {
    sm.price[c] = T(0);
    sm.key[c] = 0ull;
    if constexpr (kWide) wk->krow[c] = INT_MAX;
  }
  int saturated = 0;
  for (int ph = 0; ph < p.n_phases; ++ph) {
    const T eps = p.eps[ph];
    for (int c = lane; c < n; c += 32) {
      sm.owner[c] = -1;
      sm.row_col[c] = -1;
    }
    __syncwarp();
    // this lane's summaries (the prices carry over, the owners reset)
    Top2<T> ld = lane_dummy_top2(sm, p.neg_pen2, n);
    Top2<T> lv = lane_virtual_top2(sm, p.neg_pen, n, K);
    int ldmin = lane_first_free(sm, n, lane_first_dummy(D));
    int n_free = n;     // unassigned rows, the same in every lane
    int real_free = D;  // of them real
    int it = 0, n_fast = 0;
    while (n_free > 0 && it < p.max_iters) {
      // 1. the dummy rows' top two nets and the first unassigned dummy row
      const Top2<T> td = top2_warp(ld);
      const int dmin = min_warp(ldmin);
      if (real_free == 0) {
        // no real row unassigned: the first free dummy row's bid (it exists:
        // n_free > 0) is the only one and takes its column.  Every lane reads
        // the column and computes the bid; each table entry is then written
        // by the lane that owns its index, which alone reads it again for
        // its summaries: the column's lane its price (the dummy and virtual
        // top two afresh), dmin's lane its row (its next free dummy row, past
        // dmin), the old owner's lane its row (freed: at most a new minimum)
        ++n_fast;
        const int c = td.i1;
        const T pc = sm.price[c];
        const int old = sm.owner[c];
        const T bid = bid_of(td, pc, eps, p.neg_half);
        __syncwarp();  // every lane has read the column before its lane writes it
        if (bid > p.neg_half) {
          if (lane == (c & 31)) {
            sm.owner[c] = dmin;
            sm.price[c] = bid;
          }
          if (old >= 0 && lane == (old & 31)) sm.row_col[old] = -1;
          if (lane == (dmin & 31)) sm.row_col[dmin] = c;
          if (small) {
            // a few columns a lane: the column's lane recomputes its top
            // twos, dmin's lane searches its rows past dmin (each reads only
            // entries it wrote or that the last barrier published)
            if (lane == (c & 31)) {
              ld = lane_dummy_top2(sm, p.neg_pen2, n);
              if (c >= K) lv = lane_virtual_top2(sm, p.neg_pen, n, K);
            }
            if (lane == (dmin & 31)) ldmin = lane_first_free(sm, n, dmin + 32);
          } else {
            // many: the warp recomputes the column's lane's top twos and
            // searches dmin's lane past dmin
            __syncwarp();  // the new entries seen by every lane
            Top2<T> d2, v2;
            warp_lane_top2(sm, p, n, K, c & 31, c >= K, d2, v2);
            const int f = warp_first_free(sm, n, dmin + 32);
            if (lane == (c & 31)) {
              ld = d2;
              if (c >= K) lv = v2;
            }
            if (lane == (dmin & 31)) ldmin = f;
          }
          // a freed dummy row is at most its lane's new minimum
          if (old >= D && lane == (old & 31)) ldmin = min(ldmin, old);
          if (old < 0)
            --n_free;
          else if (old < D)
            ++real_free;  // a real row evicted: the general iteration resumes
        }
      } else {
        // 2. bids.  The real rows' virtual top two; each unassigned real
        //    row with a short list: one lane per row, its listed columns
        //    merged with the virtual top two
        const Top2<T> tv = top2_warp(lv);
        int nb = 0;
        for (int r0 = 0; r0 < D; r0 += 32) {
          const int r = r0 + lane;
          const int nf = r < D ? sm.feas_n[r] : 0;
          const bool bids = r < D && sm.row_col[r] < 0 && nf <= kMaxFeas;
          int bc = 0;
          T bid = T(0);
          if (bids) {
            Top2<T> t = top2_empty<T>();
            for (int j = 0; j < nf; ++j) {
              const int c = sm.feas_col[r][j];
              top2_push(t, fp::sub(sm.feas_val[r][j], sm.price[c]), c);
            }
            t = top2_merge(t, tv);
            bc = t.i1;
            bid = bid_of(t, sm.price[bc], eps, p.neg_half);
            place_bid(sm, bc, bid, r);
          }
          const unsigned m = __ballot_sync(kFull, bids);
          if (bids) {
            const int q = nb + __popc(m & below);
            sm.bid_col[q] = bc;
            sm.bid_row[q] = r;
            if constexpr (kWide) wk->bid_val[q] = bid;
          }
          nb += __popc(m);
        }
        //    each unassigned row whose list overflowed: the warp scans its K
        //    columns
        for (int r0 = 0; r0 < D; r0 += 32) {
          const int r = r0 + lane;
          unsigned todo =
              __ballot_sync(kFull, r < D && sm.row_col[r] < 0 && sm.feas_n[r] > kMaxFeas);
          while (todo) {
            const int rr = r0 + __ffs(todo) - 1;
            todo &= todo - 1;
            Top2<T> t = top2_empty<T>();
            for (int c = lane; c < K; c += 32)
              top2_push(t, fp::sub(value(rr, c), sm.price[c]), c);
            t = top2_merge(top2_warp(t), tv);
            const T bid = bid_of(t, sm.price[t.i1], eps, p.neg_half);
            if (lane == 0) {
              place_bid(sm, t.i1, bid, rr);
              sm.bid_col[nb] = t.i1;
              sm.bid_row[nb] = rr;
              if constexpr (kWide) wk->bid_val[nb] = bid;
            }
            ++nb;
          }
        }
        //    the dummy rows' one bid
        if (dmin < n) {
          const T bid = bid_of(td, sm.price[td.i1], eps, p.neg_half);
          if (lane == 0) {
            place_bid(sm, td.i1, bid, dmin);
            sm.bid_col[nb] = td.i1;
            sm.bid_row[nb] = dmin;
            if constexpr (kWide) wk->bid_val[nb] = bid;
          }
          ++nb;
        }
        __syncwarp();
        if constexpr (kWide) {
          // the double build's second step: the first row among each
          // column's bids equal to its maximum
          for (int j = lane; j < nb; j += 32) {
            const int c = sm.bid_col[j];
            if (ord_bits64(wk->bid_val[j]) == sm.key[c]) atomicMin(&wk->krow[c], sm.bid_row[j]);
          }
          __syncwarp();
        }
        // 3. each column bid on goes to its key's row at its key's bid: the
        //    bid entry of that row applies it and clears the key (every
        //    other entry of the column has read the key before, at the
        //    barrier); the lanes of the changed columns and rows are marked
        int gained = 0, real_moved = 0;
        unsigned cols = 0u, rows = 0u;
        for (int j0 = 0; j0 < nb; j0 += 32) {
          const int j = j0 + lane;
          int c = 0, w = 0;
          unsigned long long key = 0ull;
          bool mine = false;
          if (j < nb) {
            c = sm.bid_col[j];
            key = sm.key[c];
            if constexpr (kWide)
              w = wk->krow[c];
            else
              w = key_row(key);
            mine = key != 0ull && w == sm.bid_row[j];
          }
          __syncwarp();
          bool got = false;
          unsigned mark_c = 0u, mark_r = 0u;
          int moved = 0;  // real rows freed minus real rows assigned
          if (mine) {
            sm.key[c] = 0ull;
            if constexpr (kWide) wk->krow[c] = INT_MAX;
            T bid;
            if constexpr (kWide)
              bid = from_ord64(key);
            else
              bid = T(key_bid(key));  // the half builds' bid: exact
            if (bid > p.neg_half) {
              const int old = sm.owner[c];
              sm.owner[c] = w;
              sm.price[c] = bid;
              sm.row_col[w] = c;
              mark_c = 1u << (c & 31);
              mark_r = 1u << (w & 31);
              moved = w < D ? -1 : 0;
              if (old >= 0) {
                sm.row_col[old] = -1;
                mark_r |= 1u << (old & 31);
                moved += old < D ? 1 : 0;
              } else {
                got = true;
              }
            }
          }
          gained += __popc(__ballot_sync(kFull, got));
          cols |= __reduce_or_sync(kFull, mark_c);
          rows |= __reduce_or_sync(kFull, mark_r);
          real_moved += __reduce_add_sync(kFull, moved);
          __syncwarp();
        }
        n_free -= gained;
        real_free += real_moved;
        // 4. the marked lanes' summaries afresh
        if ((cols >> lane) & 1u) {
          ld = lane_dummy_top2(sm, p.neg_pen2, n);
          lv = lane_virtual_top2(sm, p.neg_pen, n, K);
        }
        if ((rows >> lane) & 1u) ldmin = lane_first_free(sm, n, lane_first_dummy(D));
      }
      __syncwarp();  // this iteration's writes seen by every lane
      ++it;
    }
    if (n_free > 0 && it >= p.max_iters) ++saturated;
    if (iters_out != nullptr && lane == 0) iters_out[ph] = it;
    if (fast_out != nullptr && lane == 0) fast_out[ph] = n_fast;
  }
  __syncwarp();
  return saturated;
}

}  // namespace motl_auction
