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
// 3,000 cap), each a few hundred operations over n <= 1,152 columns.  So
// the design keeps an iteration to one warp and no block barrier:
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
//   - each real row's feasible columns listed once per problem (up to
//     kMaxFeas = 4: a detection gates a few tracks), so the unassigned real
//     rows bid one per lane in one pass, each over its list and the virtual
//     columns' top two (a row whose list overflowed scans all K columns
//     with the whole warp): real rows are evicted and re-bid many times a
//     phase, and a warp-wide scan of K columns per re-bid, in turn, costs
//     more than the whole iteration else (PERF.md §6);
//   - the warp's top two by single-instruction warp reductions
//     (__reduce_max_sync / __reduce_min_sync on order-preserving bits), not
//     five rounds of shuffles;
//   - each column's winner by one 64-bit atomicMax on a packed key: the high
//     word is the bid's order-preserving bits, the low word ~row, so the max
//     is exact in any order and ties go to the first row (a max, not a
//     float sum).
//
// Arithmetic: every f32 sum and difference __fadd_rn / __fsub_rn, in the
// order JAX writes them; the comparisons strict where argmax and max put
// them (a later equal value never takes the first maximum's place).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace motl_auction {

constexpr int kMaxRows = 128;    // real rows (detections): K4's bound
constexpr int kMaxPhases = 16;   // eps phases (4 at the defaults)
constexpr int kMaxFeas = 4;      // a row's listed feasible columns; past it the row scans all K
constexpr unsigned kFull = 0xffffffffu;

struct AuctionParams {
  float neg;        // f32(_NEG): an infeasible pair's value
  float neg_half;   // f32(_NEG / 2): the second-maximum and "took" threshold
  float neg_pen;    // f32(-penalty): a real row's value on a virtual column
  float neg_pen2;   // f32(-penalty2): a dummy row's value everywhere
  float eps[kMaxPhases];
  int n_phases;
  int max_iters;
};

// Host: the parameters from the wrapper's f32 values [neg, neg_half,
// neg_pen, neg_pen2, eps_0, ..., eps_{n_phases - 1}]; false when out of range.
inline bool read_params(const float* f, int n_phases, int max_iters, AuctionParams* p) {
  if (f == nullptr || n_phases < 1 || n_phases > kMaxPhases || max_iters < 0) return false;
  p->neg = f[0];
  p->neg_half = f[1];
  p->neg_pen = f[2];
  p->neg_pen2 = f[3];
  for (int i = 0; i < kMaxPhases; ++i) p->eps[i] = i < n_phases ? f[4 + i] : 0.0f;
  p->n_phases = n_phases;
  p->max_iters = max_iters;
  return true;
}

template <int kCols>
struct AuctionScratch {
  float price[kCols];
  int owner[kCols];              // column -> row, -1 unowned
  int row_col[kCols];            // row -> column, -1 unassigned
  unsigned long long key[kCols];  // this iteration's best bid per column, 0 none
  int bid_col[kMaxRows + 1];     // this iteration's bids: column and row
  int bid_row[kMaxRows + 1];
  int feas_n[kMaxRows];          // each real row's feasible columns, ascending
  int feas_col[kMaxRows][kMaxFeas];
  float feas_val[kMaxRows][kMaxFeas];
};

// The largest value, the first index holding it, and the largest value at
// any other index.
struct Top2 {
  float v1;
  int i1;
  float v2;
};

__device__ __forceinline__ Top2 top2_empty() {
  const float ninf = __int_as_float(0xff800000);
  return {ninf, 0x7fffffff, ninf};
}

// Push value x at index i; a lane pushes in ascending i.
__device__ __forceinline__ void top2_push(Top2& t, float x, int i) {
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
__device__ __forceinline__ Top2 top2_merge(Top2 a, Top2 b) {
  if (b.v1 > a.v1 || (b.v1 == a.v1 && b.i1 < a.i1)) return {b.v1, b.i1, fmaxf(a.v1, b.v2)};
  return {a.v1, a.i1, fmaxf(a.v2, b.v1)};
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

// The warp's top two from each lane's, by three warp reductions (one
// instruction each on sm_80 and later): the largest first value, the
// smallest index holding it, and the largest of every other lane's first
// value and the holder's second.
__device__ __forceinline__ Top2 top2_warp(Top2 t) {
  const unsigned o1 = ord_bits(t.v1);
  const unsigned best = __reduce_max_sync(kFull, o1);
  const int bi = __reduce_min_sync(kFull, o1 == best ? t.i1 : 0x7fffffff);
  const unsigned sec = __reduce_max_sync(kFull, t.i1 == bi ? ord_bits(t.v2) : o1);
  return {from_ord(best), bi, from_ord(sec)};
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

// The bid of a row whose net values have top two t.
__device__ __forceinline__ float bid_of(const Top2& t, float price_best, float eps,
                                        float neg_half) {
  const float second = t.v2 <= neg_half ? t.v1 : t.v2;
  return __fadd_rn(__fadd_rn(price_best, __fsub_rn(t.v1, second)), eps);
}

// Each real row's feasible columns (value != neg), ascending, up to
// kMaxFeas of them, and their count (past kMaxFeas the row scans all K
// columns when it bids).  The warps of the block split the rows: warp w of
// n_warps takes rows w, w + n_warps, ...  An infeasible column never
// decides a bid: its net (NEG - price) is below NEG / 2, so it is neither a
// row's first maximum (a virtual column beats it) nor a second maximum the
// NEG / 2 rule keeps.  The caller synchronises before the auction reads them.
template <int kCols, class Value>
__device__ void auction_lists(const Value& value, int D, int K, float neg,
                              AuctionScratch<kCols>& sm, int warp, int n_warps) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int r = warp; r < D; r += n_warps) {
    int cnt = 0;
    for (int c0 = 0; c0 < K; c0 += 32) {
      const int c = c0 + lane;
      const float v = c < K ? value(r, c) : neg;
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

// The auction over D real rows and K real columns, run by the 32 lanes of
// one warp (the only threads that touch `sm` until it returns) on the lists
// of auction_lists.  value(r, c) gives a real row's value on a real column
// (-cost, or p.neg where the pair is infeasible); it is read again only for
// a row whose list overflowed.  On return sm.row_col[r] (r < D) is the
// column row r owns after the last phase (a real one when < K, else
// virtual; -1 if unassigned) and sm.owner[c] column c's owner; returns the
// saturated phase count (the same in every lane).  iters_out, when given,
// receives each phase's iterations (lane 0 writes).  1 <= D <= kMaxRows,
// K >= 1, D + K <= kCols.
template <int kCols, class Value>
__device__ int auction_warp(const Value& value, int D, int K, const AuctionParams& p,
                            AuctionScratch<kCols>& sm, int* iters_out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int n = D + K;
  for (int c = lane; c < n; c += 32) {
    sm.price[c] = 0.0f;
    sm.key[c] = 0ull;
  }
  int saturated = 0;
  for (int ph = 0; ph < p.n_phases; ++ph) {
    const float eps = p.eps[ph];
    for (int c = lane; c < n; c += 32) {
      sm.owner[c] = -1;
      sm.row_col[c] = -1;
    }
    __syncwarp();
    int n_free = n;  // unassigned rows, the same in every lane
    int it = 0;
    while (n_free > 0 && it < p.max_iters) {
      // 1. one pass over the columns (and, by the same index, the rows): a
      //    dummy row's top two nets, a real row's over the virtual columns,
      //    the first unassigned dummy row
      Top2 td = top2_empty(), tv = top2_empty();
      int dmin = 0x7fffffff;
      for (int c = lane; c < n; c += 32) {
        const float pc = sm.price[c];
        top2_push(td, __fsub_rn(p.neg_pen2, pc), c);
        if (c >= K) top2_push(tv, __fsub_rn(p.neg_pen, pc), c);
        if (c >= D && sm.row_col[c] < 0) dmin = min(dmin, c);
      }
      td = top2_warp(td);
      tv = top2_warp(tv);
      dmin = min_warp(dmin);
      // 2. bids.  Each unassigned real row with a short list: one lane per
      //    row, its listed columns merged with the virtual top two
      int nb = 0;
      for (int r0 = 0; r0 < D; r0 += 32) {
        const int r = r0 + lane;
        const int nf = r < D ? sm.feas_n[r] : 0;
        const bool bids = r < D && sm.row_col[r] < 0 && nf <= kMaxFeas;
        int bc = 0;
        if (bids) {
          Top2 t = top2_empty();
          for (int j = 0; j < nf; ++j) {
            const int c = sm.feas_col[r][j];
            top2_push(t, __fsub_rn(sm.feas_val[r][j], sm.price[c]), c);
          }
          t = top2_merge(t, tv);
          bc = t.i1;
          atomicMax(&sm.key[bc], bid_key(bid_of(t, sm.price[bc], eps, p.neg_half), r));
        }
        const unsigned m = __ballot_sync(kFull, bids);
        if (bids) {
          const int q = nb + __popc(m & below);
          sm.bid_col[q] = bc;
          sm.bid_row[q] = r;
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
          Top2 t = top2_empty();
          for (int c = lane; c < K; c += 32) top2_push(t, __fsub_rn(value(rr, c), sm.price[c]), c);
          t = top2_merge(top2_warp(t), tv);
          const float bid = bid_of(t, sm.price[t.i1], eps, p.neg_half);
          if (lane == 0) {
            atomicMax(&sm.key[t.i1], bid_key(bid, rr));
            sm.bid_col[nb] = t.i1;
            sm.bid_row[nb] = rr;
          }
          ++nb;
        }
      }
      //    the dummy rows' one bid
      if (dmin < n) {
        const float bid = bid_of(td, sm.price[td.i1], eps, p.neg_half);
        if (lane == 0) {
          atomicMax(&sm.key[td.i1], bid_key(bid, dmin));
          sm.bid_col[nb] = td.i1;
          sm.bid_row[nb] = dmin;
        }
        ++nb;
      }
      __syncwarp();
      // 3. each column bid on goes to its key's row at its key's bid: the
      //    bid entry of that row applies it and clears the key (every other
      //    entry of the column has read the key before, at the barrier)
      int gained = 0;
      for (int j0 = 0; j0 < nb; j0 += 32) {
        const int j = j0 + lane;
        int c = 0;
        unsigned long long key = 0ull;
        bool mine = false;
        if (j < nb) {
          c = sm.bid_col[j];
          key = sm.key[c];
          mine = key != 0ull && key_row(key) == sm.bid_row[j];
        }
        __syncwarp();
        bool got = false;
        if (mine) {
          sm.key[c] = 0ull;
          const float bid = key_bid(key);
          if (bid > p.neg_half) {
            const int w = key_row(key), old = sm.owner[c];
            sm.owner[c] = w;
            sm.price[c] = bid;
            sm.row_col[w] = c;
            if (old >= 0)
              sm.row_col[old] = -1;
            else
              got = true;
          }
        }
        gained += __popc(__ballot_sync(kFull, got));
        __syncwarp();
      }
      n_free -= gained;
      ++it;
    }
    if (n_free > 0 && it >= p.max_iters) ++saturated;
    if (iters_out != nullptr && lane == 0) iters_out[ph] = it;
  }
  __syncwarp();
  return saturated;
}

}  // namespace motl_auction
