"""The Hungarian auction's device schedule (``csrc/auction.cuh::
auction_warp``) on the CPU, against the literal plain version
(``ops/hungarian.py::auction_assign_plain``), bit for bit: assigned
columns, saturated phases and iterations per phase.

- ``_rehearse`` follows the kernel's steps in numpy, f32 and f64: each
  lane's column summaries (the dummy nets' and the virtual nets' top two,
  the first unassigned dummy row) over its strided columns, in four and
  two interleaved accumulators merged by index; the warp's by the
  reductions' rule, checked each iteration against the tables; the
  iteration with no real row unassigned applied alone (the first free
  dummy row's one bid, its column's old owner freed; the column's lane
  recomputing its top twos -- past 256 columns the warp does, for it --,
  dmin's lane searching past dmin, a freed dummy row's lane taking the
  minimum); the general iteration (lists,
  packed-key or two-step winners) where a real row bids, resumed once a
  dummy bid evicts a real row; only the lanes whose column or row changed
  recomputing those summaries.  Its dummy-only iterations
  per phase are the plain version's count (``return_split``).
- The problems: the existing ones (tests/test_torch_hungarian.py's
  cases), hypothesis-drawn gated problems, a problem whose distinct f32
  prices round to one dummy net (the first index wins, not the lower
  price), long dummy-only stretches cut by real-row evictions (also past
  256 columns, where the warp recomputes a lane's summaries), and the
  headline and dense scenes' own problems under hungarian
  (``tests/golden/torch_auction_problems.npz``, made by
  ``scripts/make_torch_auction_problems.py``).
- The CUDA source itself, compiled for the host with g++ (a shim runs the
  warp's 32 lanes as coroutines on one thread, each warp intrinsic a
  hand-over point): K12's entry
  (``csrc/auction.cu``, f32) and the double build of the same device
  function, on the small problems.

Everything is exact: the schedule's decisions are integers and its prices
the plain version's roundings.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
    auction_assign_plain,
    auction_negs,
    auction_schedule,
)

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)

# thousands of small torch ops (the plain auction's iterations): one intra-op
# thread, so that the suite's workers do not oversubscribe the cores
pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBLEMS = os.path.join(REPO, "tests", "golden", "torch_auction_problems.npz")
MAX_FEAS = 4          # csrc/auction.cuh::kMaxFeas
SMALL_COLS = 256      # csrc/auction.cuh::kSmallCols
INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# the problems
# ---------------------------------------------------------------------------
def _case(name):
    """(cost (D, K) f32, feasible (D, K), eps, max_cost, max_iters)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    f32 = np.float32
    if name == "random-gated":
        cost = rng.uniform(0, 0.8, (12, 10)).astype(f32)
        return cost, (cost < 0.5) & (rng.uniform(size=cost.shape) < 0.8), 1e-3, 0.5, 3000
    if name == "near-ties":
        cost = (f32(0.25) + rng.uniform(0, 1e-4, (16, 16))).astype(f32)
        cost[3, :] = cost[4, :]
        return cost, np.ones(cost.shape, bool), 1e-4, 1.0, 3000
    if name == "infeasible-rows":
        cost = rng.uniform(0, 0.5, (10, 12)).astype(f32)
        feas = rng.uniform(size=cost.shape) < 0.6
        feas[[0, 3, 7]] = False
        return cost, feas, 1e-3, 0.5, 3000
    if name == "d-gt-k":
        cost = rng.uniform(0, 0.5, (20, 6)).astype(f32)
        return cost, rng.uniform(size=cost.shape) < 0.7, 1e-3, 0.5, 3000
    if name == "d-lt-k":
        cost = rng.uniform(0, 0.5, (5, 30)).astype(f32)
        return cost, rng.uniform(size=cost.shape) < 0.3, 1e-3, 0.5, 3000
    if name == "max-iters-1":
        cost = (f32(0.5) + rng.uniform(0, 1e-3, (16, 16))).astype(f32)
        return cost, np.ones(cost.shape, bool), 1e-4, 1.0, 1
    if name == "net-ties":
        return net_tie_problem()
    if name == "dummy-stretches":
        return dummy_stretch_problem(rng)
    if name == "capped":
        cost, feas, eps, max_cost, _ = dummy_stretch_problem(rng)
        return cost, feas, eps, max_cost, 40
    if name == "wide":
        return dummy_stretch_problem(rng, 6, 260)
    raise ValueError(name)


def net_tie_problem(d=8, k=24):
    """Costs 0.3 + j * 2^-22 (exact in f32): bids then differ by less than
    an ulp of the dummy nets (-penalty2 - price, |net| ~ 9), so distinct
    prices round to one net and the first index, not the lower price,
    takes a dummy bid.  Each row gates three columns, one row none."""
    f32 = np.float32
    j = np.arange(d * k).reshape(d, k)
    cost = (f32(0.3) + (j % 7).astype(f32) * f32(2.0**-22)).astype(f32)
    feas = np.zeros((d, k), bool)
    for r in range(d - 1):
        feas[r, [(3 * r) % k, (3 * r + 1) % k, (3 * r + 5) % k]] = True
    return cost, feas, 1e-3, 0.5, 3000


def dummy_stretch_problem(rng, d=6, k=120):
    """Few real rows, many columns: each phase is long runs of dummy-only
    iterations, cut where a dummy bid takes a column a real row holds."""
    cost = rng.uniform(0, 0.6, (d, k)).astype(np.float32)
    feas = (cost < 0.5) & (rng.uniform(size=(d, k)) < 0.03)
    feas[1] = False
    return cost, feas, 1e-3, 0.5, 3000


CASES = ["random-gated", "near-ties", "infeasible-rows", "d-gt-k", "d-lt-k", "max-iters-1",
         "net-ties", "dummy-stretches", "capped", "wide"]


# ---------------------------------------------------------------------------
# the kernel's schedule in numpy
# ---------------------------------------------------------------------------
def _push(t, x, i):
    v1, i1, v2 = t
    if x > v1:
        return (x, i, v1)
    return (v1, i1, x) if x > v2 else t


def _merge(a, b):
    if b[0] > a[0] or (b[0] == a[0] and b[1] < a[1]):
        return (b[0], b[1], max(a[0], b[2]))
    return (a[0], a[1], max(a[2], b[0]))


def _warp(lanes, dt):
    """``top2_warp``: the largest first value (-0 made +0), the smallest
    index holding it, the largest of the other lanes' first values and
    the holder's second."""
    z = dt(0.0)
    canon = [(v1 + z, i1, v2 + z) for v1, i1, v2 in lanes]
    best = max(c[0] for c in canon)
    bi = min(c[1] if c[0] == best else INT_MAX for c in canon)
    sec = max(c[2] if c[1] == bi else c[0] for c in canon)
    return best, bi, sec


def _rehearse(cost, feas, eps, max_cost, max_iters, dtype=torch.float32):
    """csrc/auction.cuh::auction_warp step by step in numpy (``dtype`` f32
    or f64).  Returns (assigned, saturated, iterations per phase, stats):
    stats counts the dummy-only and the general iterations, the general
    iterations resumed by a dummy bid's eviction of a real row, and the
    dummy top twos whose first column holds a higher price than a later
    column of the same net."""
    dt = np.float32 if dtype == torch.float32 else np.float64
    d, k = cost.shape
    n = d + k
    neg_pen, neg_pen2, eps_ps = auction_schedule(d, eps, max_cost, dtype=dtype)
    neg, neg_half = auction_negs(dtype)
    neg_pen, neg_pen2, neg, neg_half = dt(neg_pen), dt(neg_pen2), dt(neg), dt(neg_half)
    value = np.where(feas, -cost.astype(dt), neg).astype(dt)
    lists = [[c for c in range(k) if value[r, c] != neg] for r in range(d)]
    empty = (dt(-np.inf), INT_MAX, dt(-np.inf))
    price = np.zeros(n, dt)
    stats = dict(fast=0, general=0, resumed=0, net_ties=0, fast_per_phase=[])
    sat, iters = 0, []

    def lane_cols(c0, step=32):
        return range(c0, n, step)

    def acc_top2(values, cols, ways):
        """``ways`` accumulators over interleaved columns, merged by index."""
        acc = [empty] * ways
        for j, c in enumerate(cols):
            acc[j % ways] = _push(acc[j % ways], values[c], c)
        while len(acc) > 1:
            acc = [_merge(acc[i], acc[i + 1]) for i in range(0, len(acc), 2)]
        return acc[0]

    def dummy_top2(lane):
        """``lane_dummy_top2``: four accumulators."""
        return acc_top2(neg_pen2 - price, lane_cols(lane), 4)

    def virtual_top2(lane):
        """``lane_virtual_top2``: two accumulators over its columns >= k."""
        return acc_top2(neg_pen - price, [c for c in lane_cols(lane) if c >= k], 2)

    def first_free(start, row_col):
        """``lane_first_free``: the lane's first free row at or past start."""
        return next((r for r in lane_cols(start) if row_col[r] < 0), INT_MAX)

    def first_dummy(lane):
        return lane if d <= lane else lane + -(-(d - lane) // 32) * 32

    def bid_of(t, eps_p):
        second = t[0] if t[2] <= neg_half else t[2]
        return (price[t[1]] + (t[0] - second)) + eps_p

    for eps_p in eps_ps:
        eps_p = dt(eps_p)
        owner = [-1] * n
        row_col = [-1] * n
        lanes = [[dummy_top2(lane), virtual_top2(lane), first_free(first_dummy(lane), row_col)]
                 for lane in range(32)]
        n_free, real_free, it = n, d, 0
        evicted = False
        while n_free > 0 and it < max_iters:
            td = _warp([s[0] for s in lanes], dt)
            dmin = min(s[2] for s in lanes)
            # the kept summaries against the tables: the first maximum and
            # the second of the dummy nets, the first free dummy row
            nets = neg_pen2 - price
            free = np.flatnonzero(np.asarray(row_col[d:]) < 0)
            assert td[:2] == (nets.max(), int(np.argmax(nets)))
            assert td[2] == np.delete(nets, td[1]).max(initial=-np.inf)
            assert dmin == (d + int(free[0]) if len(free) else INT_MAX)
            later = np.flatnonzero(nets[td[1] + 1:] == nets[td[1]]) + td[1] + 1
            stats["net_ties"] += int((price[later] < price[td[1]]).any())
            cols, rows = set(), set()
            if real_free == 0:
                # the dummy-only iteration: each lane writes its own entries
                # and updates its own summaries
                stats["fast"] += 1
                c = td[1]
                b = bid_of(td, eps_p)
                if b > neg_half:
                    old = owner[c]
                    owner[c], price[c] = dmin, b
                    if old >= 0:
                        row_col[old] = -1
                    row_col[dmin] = c
                    src = c % 32
                    if n <= SMALL_COLS:           # c's lane recomputes its top twos
                        lanes[src][0] = dummy_top2(src)
                        if c >= k:
                            lanes[src][1] = virtual_top2(src)
                    else:                         # the warp recomputes c's lane
                        part = [acc_top2(neg_pen2 - price, lane_cols(src + 32 * q, 1024), 1)
                                for q in range(32)]
                        lanes[src][0] = _warp(part, dt)
                        if c >= k:
                            part = [acc_top2(neg_pen - price, [x for x in lane_cols(
                                src + 32 * q, 1024) if x >= k], 1) for q in range(32)]
                            lanes[src][1] = _warp(part, dt)
                    lanes[dmin % 32][2] = first_free(dmin + 32, row_col)
                    if old >= d:                  # a freed dummy row: at most the new minimum
                        lanes[old % 32][2] = min(lanes[old % 32][2], old)
                    if old < 0:
                        n_free -= 1
                    elif old < d:
                        real_free += 1
                        evicted = True
            else:
                stats["general"] += 1
                stats["resumed"] += int(evicted)
                evicted = False
                tv = _warp([s[1] for s in lanes], dt)
                vnets = neg_pen - price[k:]
                assert tv[:2] == (vnets.max(), k + int(np.argmax(vnets)))
                best, bids = {}, []       # column -> (bid, -row); the bid list

                def place(t, r):
                    b = bid_of(t, eps_p)
                    best[t[1]] = max(best.get(t[1], (neg, -INT_MAX)), (b, -r))
                    bids.append((t[1], r))

                for r in range(d):        # one lane per row with a short list
                    if row_col[r] < 0 and len(lists[r]) <= MAX_FEAS:
                        t = empty
                        for c in lists[r]:
                            t = _push(t, value[r, c] - price[c], c)
                        place(_merge(t, tv), r)
                for r in range(d):        # the warp over an overflowed row's K columns
                    if row_col[r] < 0 and len(lists[r]) > MAX_FEAS:
                        part = [empty] * 32
                        for c in range(k):
                            part[c % 32] = _push(part[c % 32], value[r, c] - price[c], c)
                        place(_merge(_warp(part, dt), tv), r)
                if dmin < n:
                    place(td, dmin)
                for c, r in bids:         # the winner's entry applies its column
                    b, w = best[c]
                    if -w != r or not b > neg_half:
                        continue
                    old = owner[c]
                    owner[c], price[c], row_col[r] = r, b, c
                    cols.add(c % 32)
                    rows.add(r % 32)
                    real_free -= int(r < d)
                    if old >= 0:
                        row_col[old] = -1
                        rows.add(old % 32)
                        real_free += int(old < d)
                    else:
                        n_free -= 1
            for lane in cols:             # the marked lanes' summaries afresh
                lanes[lane][:2] = [dummy_top2(lane), virtual_top2(lane)]
            for lane in rows:
                lanes[lane][2] = first_free(first_dummy(lane), row_col)
            it += 1
        sat += int(n_free > 0 and it >= max_iters)
        iters.append(it)
        stats["fast_per_phase"].append(stats["fast"] - sum(stats["fast_per_phase"]))
    assigned = [c if 0 <= c < k else -1 for c in row_col[:d]]
    return np.asarray(assigned, np.int32), sat, iters, stats


def _check(cost, feas, eps, max_cost, max_iters, dtype=torch.float32):
    got, sat, iters, stats = _rehearse(cost, feas, eps, max_cost, max_iters, dtype)
    c = torch.from_numpy(cost).to(dtype)
    pa, ps, pit, pfast = auction_assign_plain(c, torch.from_numpy(feas), eps, max_cost,
                                              max_iters, return_split=True)
    np.testing.assert_array_equal(got, pa.numpy())
    assert sat == int(ps) and iters == pit
    assert stats["fast"] + stats["general"] == sum(iters)
    assert stats["fast_per_phase"] == pfast
    return stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_schedule_rehearsed_matches_plain(name, dtype):
    """The kept summaries, the dummy-only iterations and the general ones
    give the literal version's assignment, saturation and iterations per
    phase; the stretches problem resumes the general iteration after
    evictions, the net-tie problem meets distinct prices of one net."""
    stats = _check(*_case(name), dtype=dtype)
    if name in ("dummy-stretches", "d-lt-k", "wide"):
        assert stats["fast"] > stats["general"] > 0
    if name in ("dummy-stretches", "wide"):
        assert stats["resumed"] > 0
    if name == "net-ties" and dtype == torch.float32:
        assert stats["net_ties"] > 0


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(d=st.integers(1, 12), k=st.integers(1, 40), seed=st.integers(0, 2**16),
       density=st.sampled_from([0.05, 0.3, 0.9]), f64=st.booleans())
def test_schedule_rehearsed_on_drawn_gated_problems(d, k, seed, density, f64):
    """Drawn gated problems (costs in [0, 0.8), the gate at 0.5, some rows
    past the list's length): the rehearsal equals the plain version."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 0.8, (d, k)).astype(np.float32)
    feas = (cost < 0.5) & (rng.uniform(size=(d, k)) < density)
    _check(cost, feas, 1e-3, 0.5, 3000, torch.float64 if f64 else torch.float32)


def _scene_problems():
    z = np.load(PROBLEMS)
    out = []
    for scene in ("headline", "dense"):
        thr = float(z[f"{scene}_thr"])
        for f in range(z[f"{scene}_cost"].shape[0]):
            out.append(pytest.param(scene, f, thr, id=f"{scene}-{f}"))
    return out


@pytest.mark.parametrize("scene,frame,thr", _scene_problems())
def test_schedule_rehearsed_on_the_scenes_own_problems(scene, frame, thr):
    """The headline's and the dense scene's own auction problems under
    hungarian (each frame's gate costs of the bank before it): the
    rehearsal equals the plain version, and the dummy-only iterations
    occur."""
    z = np.load(PROBLEMS)
    stats = _check(z[f"{scene}_cost"][frame], z[f"{scene}_feas"][frame], 1e-3, thr, 3000)
    assert stats["fast"] > 0


# ---------------------------------------------------------------------------
# the CUDA source on the host
# ---------------------------------------------------------------------------
SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <climits>
#include <ucontext.h>
#include <vector>
using std::fmax; using std::max; using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
// The warp's 32 lanes as coroutines on one thread: a lane runs to its next
// warp collective and hands over to the next lane; the last to arrive
// computes the collective's result, which every lane reads as it resumes.
struct Dim { int x; };
inline Dim threadIdx, blockIdx;
inline ucontext_t g_main, g_lane[32];
inline unsigned long long g_slot[32];
inline unsigned long long g_result;
inline int g_done;
inline void warp_switch_from(int lane) {
  const int next = (lane + 1) & 31;
  threadIdx.x = next;
  swapcontext(&g_lane[lane], &g_lane[next]);
}
template <class F> unsigned long long warp_exchange(unsigned long long v, F f) {
  const int lane = threadIdx.x;
  g_slot[lane] = v;
  if (lane == 31) g_result = f();
  warp_switch_from(lane);
  return g_result;
}
inline void __syncwarp(unsigned = 0xffffffffu) { warp_exchange(0, [] { return 0ull; }); }
inline unsigned __ballot_sync(unsigned, bool p) {
  return (unsigned)warp_exchange(p, [] { unsigned m = 0; for (int i = 0; i < 32; ++i)
    if (g_slot[i]) m |= 1u << i; return (unsigned long long)m; });
}
inline int __shfl_sync(unsigned, int v, int src) {
  return (int)(unsigned)warp_exchange((unsigned)v, [src] { return g_slot[src]; });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return (unsigned)warp_exchange(v, [] { unsigned long long m = 0;
    for (int i = 0; i < 32; ++i) m = std::max(m, g_slot[i]); return m; });
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)warp_exchange(v, [] { unsigned long long m = 0;
    for (int i = 0; i < 32; ++i) m |= g_slot[i]; return m; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return (int)(unsigned)warp_exchange((unsigned)v, [] { int m = INT_MAX;
    for (int i = 0; i < 32; ++i) m = std::min(m, (int)(unsigned)g_slot[i]);
    return (unsigned long long)(unsigned)m; });
}
inline int __reduce_add_sync(unsigned, int v) {
  return (int)(unsigned)warp_exchange((unsigned)v, [] { unsigned s = 0;
    for (int i = 0; i < 32; ++i) s += (unsigned)g_slot[i]; return (unsigned long long)s; });
}
inline unsigned long long atomicMax(unsigned long long* a, unsigned long long v) {
  const auto o = *a; *a = std::max(o, v); return o;
}
inline int atomicMin(int* a, int v) { const int o = *a; *a = std::min(o, v); return o; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline long long __double_as_longlong(double f) { long long u; std::memcpy(&u, &f, 8); return u; }
inline double __longlong_as_double(long long u) { double f; std::memcpy(&f, &u, 8); return f; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// Runs body() as the 32 lanes of one warp for each block; a lane that
// returns hands over to the next, the last back to the caller.
template <class F> void run_warp(F& body) {
  static F* g_body;
  g_body = &body;
  std::vector<std::vector<char>> stacks(32, std::vector<char>(1 << 16));
  for (int t = 0; t < 32; ++t) {
    getcontext(&g_lane[t]);
    g_lane[t].uc_stack.ss_sp = stacks[t].data();
    g_lane[t].uc_stack.ss_size = stacks[t].size();
    g_lane[t].uc_link = nullptr;
    makecontext(&g_lane[t], (void (*)())+[] {
      (*g_body)();
      const int lane = threadIdx.x;
      if (++g_done == 32) setcontext(&g_main);
      warp_switch_from(lane);
    }, 0);
  }
  g_done = 0;
  threadIdx.x = 0;
  swapcontext(&g_main, &g_lane[0]);
}
#define LAUNCH(kernel, grid, ...) do { \
  for (int b_ = 0; b_ < (int)(grid); ++b_) { \
    blockIdx.x = b_; \
    auto body_ = [&] { kernel(__VA_ARGS__); }; \
    run_warp(body_); } } while (0)
"""

# The CUDA half headers for the host (fp_half.cuh's half builds, compiled
# by K12's source): bf16 rounded to nearest even from the f32 bits, f16 by
# g++'s _Float16, whose conversions round correctly.
SHIM_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x7fffu + ((u >> 16) & 1u);
  else if (u & 0x7fffffu) u |= 0x400000u;
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.x << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __double2bfloat16(double d) {
  // to f32 rounded to odd (exact for the second rounding), then to bf16
  float f = (float)d;
  if ((double)f != d) {
    uint32_t u; std::memcpy(&u, &f, 4);
    if (!(u & 1u)) { u += ((double)f < d) == (f > 0) ? 1 : -1; std::memcpy(&f, &u, 4); }
  }
  return __float2bfloat16_rn(f);
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short b) { return {b}; }
"""
SHIM_F16 = r"""
#pragma once
#include <cstring>
struct __half { unsigned short x; };
inline __half __float2half_rn(float f) {
  const _Float16 h = (_Float16)f; __half r; std::memcpy(&r.x, &h, 2); return r;
}
inline __half __double2half(double d) {
  const _Float16 h = (_Float16)d; __half r; std::memcpy(&r.x, &h, 2); return r;
}
inline float __half2float(__half h) { _Float16 v; std::memcpy(&v, &h.x, 2); return (float)v; }
inline unsigned short __half_as_ushort(__half h) { return h.x; }
inline __half __ushort_as_half(unsigned short b) { return {b}; }
"""

# The double build of the device function, as K4's double builds call it:
# K12's kernel on f64 values, the second step's scratch beside the tables.
HARNESS_F64 = r"""
#include "auction.cuh"
namespace {
using namespace motl_auction;
constexpr int kMaxCols = 1024 + kMaxRows;
struct MatrixValue64 {
  const double* cost; const uint8_t* feas; int K; double neg;
  double operator()(int r, int c) const {
    const size_t i = (size_t)r * K + c;
    return feas[i] ? -cost[i] : neg;
  }
};
void auction_kernel_f64(const double* cost, const uint8_t* feas, int D, int K,
                        AuctionParams<double> p, int* assigned, int* saturated, int* iters,
                        int* fast) {
  __shared__ AuctionScratch<double, kMaxCols> sm;
  __shared__ WideKeys<kMaxCols> wk;
  const size_t b = blockIdx.x;
  const MatrixValue64 value{cost + b * D * K, feas + b * D * K, K, p.neg};
  auction_lists(value, D, K, p.neg, sm, 0, 1);
  __syncwarp();
  const int sat = auction_warp(value, D, K, p, sm, &wk, iters + b * p.n_phases,
                               fast + b * p.n_phases);
  for (int r = threadIdx.x; r < D; r += 32) {
    const int c = sm.row_col[r];
    assigned[b * D + r] = (c >= 0 && c < K) ? c : -1;
  }
  if (threadIdx.x == 0) saturated[b] = sat;
}
}  // namespace
extern "C" int host_auction_f64(const double* cost, const uint8_t* feas, const double* f,
                                int n_phases, int max_iters, int B, int D, int K, int* assigned,
                                int* saturated, int* iters, int* fast) {
  AuctionParams<double> p;
  if (!read_params(f, n_phases, max_iters, &p)) return 1;
  LAUNCH(auction_kernel_f64, B, cost, feas, D, K, p, assigned, saturated, iters, fast);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_auction(tmp_path_factory):
    """K12's source (f32 and its half builds) and the f64 harness, built
    for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the auction's source for the host")
    csrc = os.path.join(REPO, "multiple_object_tracking_lidar_tpu_torch", "csrc")
    d = tmp_path_factory.mktemp("auction")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "cuda_bf16.h").write_text(SHIM_BF16)
    (d / "cuda_fp16.h").write_text(SHIM_F16)
    src = open(os.path.join(csrc, "auction.cu")).read()
    src, n = re.subn(r"auction_kernel<T><<<B, 32, 0, \(cudaStream_t\)stream>>>\(",
                     "LAUNCH(auction_kernel<T>, B, ", src)
    assert n == 1
    (d / "k12.cpp").write_text(src)
    (d / "f64.cpp").write_text(HARNESS_F64)
    so = str(d / "libauction.so")
    subprocess.run([cxx, "-O1", "-ffp-contract=off", "-std=c++20", "-fPIC",
                    "-shared", "-I", str(d), "-I", csrc, "-o", so, str(d / "k12.cpp"),
                    str(d / "f64.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.motl_auction_assign.argtypes = [P, P, P, I, I, I, I, I, P, P, P, P, P]
    lib.host_auction_f64.argtypes = [P, P, P, I, I, I, I, I, P, P, P, P]
    return lib


# (case, dtype): four small cases and the wide one (past 256 columns: the
# warp's recomputation of one lane's summaries), in both builds
HOST_CASES = [(name, dt) for name in ("random-gated", "max-iters-1", "net-ties", "capped", "wide")
              for dt in (torch.float32, torch.float64)]


@pytest.mark.parametrize("name,dtype", HOST_CASES,
                         ids=[f"{n}-{'f32' if d == torch.float32 else 'f64'}"
                              for n, d in HOST_CASES])
def test_auction_source_on_the_host_matches_plain(host_auction, name, dtype):
    """csrc/auction.cuh compiled for the host (K12's entry in f32, the
    double build's two-step winner in f64) equals the plain version bit
    for bit: assignment, saturated phases, iterations per phase and the
    dummy-only ones among them."""
    cost, feas, eps, max_cost, max_iters = _case(name)
    d, k = cost.shape
    neg_pen, neg_pen2, eps_ps = auction_schedule(d, eps, max_cost, dtype=dtype)
    neg, neg_half = auction_negs(dtype)
    dt = np.float32 if dtype == torch.float32 else np.float64
    params = np.asarray([neg, neg_half, neg_pen, neg_pen2, *eps_ps], dt)
    c = np.ascontiguousarray(cost.astype(dt))
    f = np.ascontiguousarray(feas.astype(np.uint8))
    assigned, sat = np.zeros(d, np.int32), np.zeros(1, np.int32)
    iters, fast = np.zeros(len(eps_ps), np.int32), np.zeros(len(eps_ps), np.int32)
    entry = host_auction.motl_auction_assign if dt is np.float32 else host_auction.host_auction_f64
    extra = (None,) if dt is np.float32 else ()
    err = entry(c.ctypes.data, f.ctypes.data, params.ctypes.data, len(eps_ps), max_iters, 1, d, k,
                assigned.ctypes.data, sat.ctypes.data, iters.ctypes.data, fast.ctypes.data,
                *extra)
    assert err == 0
    pa, ps, pit, pfast = auction_assign_plain(torch.from_numpy(c), torch.from_numpy(feas), eps,
                                              max_cost, max_iters, return_split=True)
    np.testing.assert_array_equal(assigned, pa.numpy())
    assert int(sat[0]) == int(ps) and iters.tolist() == pit and fast.tolist() == pfast
