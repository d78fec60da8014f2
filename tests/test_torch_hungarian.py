"""Hungarian association (``association="hungarian"``) in the port against
the JAX package on the CPU: the auction and the associator.

- ``jax.jit`` on the CPU contracts the gate's ``dx * dx + dy * dy`` into
  fma(dx, dx, dy * dy): the port spells the cost that way
  (``ops/hungarian.py::gate_costs``, K4's ``TrackValue``).
- ``auction_assign_plain`` against the JAX ``auction_assign`` (f32 inputs
  from a numpy seed on both sides, the JAX side under ``jax.jit``) bit for
  bit, assigned columns and saturated phases: random gated costs, near
  ties, all-infeasible rows, D > K and D < K, and ``max_iters=1``, which
  must saturate.
- The kernel's bidding rules (``csrc/auction.cuh``: each row's feasible
  columns listed, 32 lanes over strided columns, the lanes' top-two values
  combined by three warp reductions, one lane per bidding row, one bid for all the dummy
  rows, packed-key winners) rehearsed in numpy f32 against the literal
  plain version on the same cases, iterations per phase included, with
  every column summary taken afresh each iteration (the first schedule's
  pass): its shortcuts (the dummy rows' one bid, the infeasible columns
  left out, rows past the list's length) are checked here; the device
  schedule that keeps the summaries and applies the dummy-only iterations
  apart is rehearsed in tests/test_torch_auction_schedule.py.
- ``hungarian_associate_and_update_plain`` against the JAX function on
  the crossing, unmatched and no-duplicate scenes of
  tests/test_hungarian.py:96-150, every field.
- The whole track step (``track_step`` -> K4's plain version) under
  hungarian against the JAX ``track_step`` (jitted) on scripted scenes:
  a crossing the greedy scan gets wrong, registrations into free slots by
  rank, a full bank's overflow, an interpolation backfill, expiry; under
  ``lpf`` and ``ihgp``.
- ``track_route`` takes K4 under hungarian whatever ``assoc_backend`` says
  (the JAX package passes the backend to greedy only).

Tolerances: decisions, ids, counters and flags exact; positions within
1e-5 m, velocities within 1e-4 m/s, windows within 1e-6 and GP carries
within 1e-4 (test_torch_ihgp_position.py's bounds and reasons: the JAX
side applies the smoother weights as an einsum summed in XLA's order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.ops.hungarian import auction_assign as j_auction
from multiple_object_tracking_lidar_tpu.ops.hungarian import (
    hungarian_associate_and_update as j_hassoc,
)
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Perception as JPerception
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step
from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank as JBank
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities as TCaps
from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig as TConfig
from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda
from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
    NEG32,
    NEG_HALF32,
    auction_assign_plain,
    auction_schedule,
    gate_costs,
    hungarian_associate_and_update_plain,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception as TPerception
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_route, track_step
from multiple_object_tracking_lidar_tpu_torch.tracker.state import FrameOutput, TrackBank

TOL_POS, TOL_VEL, TOL_WIN, TOL_M = 1e-5, 1e-4, 1e-6, 1e-4
F32 = np.float32


# ---------------------------------------------------------------------------
# the cost: XLA's FMA
# ---------------------------------------------------------------------------
def _bank_np(xy, alive, L=4):
    """A (K, L, 4) f32 window whose rows all sit at xy, and its bank."""
    k = len(xy)
    w = np.zeros((k, L, 4), F32)
    w[:, :, :2] = xy[:, None, :]
    w[:, :, 3] = np.arange(L, dtype=F32)[None, :] * F32(0.1)
    obj = np.where(alive, np.arange(k), -1).astype(np.int32)
    birth = np.where(alive, np.arange(k), 2**30).astype(np.int32)
    return w, obj, birth


def _tbank(w, alive, obj, birth):
    return TrackBank(alive=torch.from_numpy(alive), obj_id=torch.from_numpy(obj),
                     birth_seq=torch.from_numpy(birth), window=torch.from_numpy(w),
                     m0=torch.zeros((len(alive), 2, 2)))


def _jbank(w, alive, obj, birth):
    return JBank(alive=jnp.asarray(alive), obj_id=jnp.asarray(obj), birth_seq=jnp.asarray(birth),
                 window=jnp.asarray(w), m0=jnp.zeros((len(alive), 2, 2), jnp.float32))


def test_jit_contracts_the_gate_cost_into_an_fma():
    """The JAX expression (hungarian.py:160-163) under jax.jit on the CPU
    is sqrt(fma(dx, dx, dy * dy)): the port's ``gate_costs`` gives its
    bits, and the unfused spelling does not."""
    rng = np.random.default_rng(3)
    d, k = 32, 64
    dets = np.zeros((d, 4), F32)
    dets[:, :2] = rng.uniform(-5, 5, (d, 2))
    xy = rng.uniform(-5, 5, (k, 2)).astype(F32)
    w, obj, birth = _bank_np(xy, np.ones(k, bool))

    @jax.jit
    def cost(dets, window):
        last = window[:, -1, :]
        dx = dets[:, 0:1] - last[None, :, 0]
        dy = dets[:, 1:2] - last[None, :, 1]
        return jnp.sqrt(dx * dx + dy * dy)

    want = np.asarray(cost(jnp.asarray(dets), jnp.asarray(w)))
    got, _ = gate_costs(_tbank(w, np.ones(k, bool), obj, birth), torch.from_numpy(dets),
                        torch.ones(d, dtype=torch.bool), 0.5, True)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    dx = dets[:, 0:1] - xy[None, :, 0]
    dy = dets[:, 1:2] - xy[None, :, 1]
    unfused = np.sqrt(dx * dx + dy * dy)
    assert (unfused != want).sum() > 0


# ---------------------------------------------------------------------------
# the auction
# ---------------------------------------------------------------------------
def _case(name):
    """(cost (D, K) f32, feasible (D, K), eps, max_cost, max_iters)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random-gated":
        cost = rng.uniform(0, 0.8, (12, 10)).astype(F32)
        return cost, (cost < 0.5) & (rng.uniform(size=cost.shape) < 0.8), 1e-3, 0.5, 3000
    if name == "near-ties":
        cost = (F32(0.25) + rng.uniform(0, 1e-4, (16, 16))).astype(F32)
        cost[3, :] = cost[4, :]                       # exact ties too
        return cost, np.ones(cost.shape, bool), 1e-4, 1.0, 3000
    if name == "infeasible-rows":
        cost = rng.uniform(0, 0.5, (10, 12)).astype(F32)
        feas = rng.uniform(size=cost.shape) < 0.6
        feas[[0, 3, 7]] = False
        return cost, feas, 1e-3, 0.5, 3000
    if name == "d-gt-k":
        cost = rng.uniform(0, 0.5, (20, 6)).astype(F32)
        return cost, rng.uniform(size=cost.shape) < 0.7, 1e-3, 0.5, 3000
    if name == "d-lt-k":
        cost = rng.uniform(0, 0.5, (5, 30)).astype(F32)
        return cost, rng.uniform(size=cost.shape) < 0.3, 1e-3, 0.5, 3000
    if name == "max-iters-1":
        cost = (F32(0.5) + rng.uniform(0, 1e-3, (16, 16))).astype(F32)
        return cost, np.ones(cost.shape, bool), 1e-4, 1.0, 1
    raise ValueError(name)


CASES = ["random-gated", "near-ties", "infeasible-rows", "d-gt-k", "d-lt-k", "max-iters-1"]


@functools.lru_cache(maxsize=None)
def _jax_auction(eps, max_cost, max_iters):
    return jax.jit(functools.partial(j_auction, eps=eps, max_cost=max_cost, max_iters=max_iters))


@functools.lru_cache(maxsize=None)
def _plain(name):
    cost, feas, eps, max_cost, max_iters = _case(name)
    return auction_assign_plain(torch.from_numpy(cost), torch.from_numpy(feas), eps, max_cost,
                                max_iters, return_iters=True)


@pytest.mark.parametrize("name", CASES)
def test_auction_plain_matches_jax(name):
    cost, feas, eps, max_cost, max_iters = _case(name)
    ja, js = _jax_auction(eps, max_cost, max_iters)(jnp.asarray(cost), jnp.asarray(feas))
    ta, ts, iters = _plain(name)
    assert ta.dtype == torch.int32 and ts.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(ts) == int(js)
    if name == "max-iters-1":
        assert int(ts) > 0 and iters == [1] * len(iters)
    else:
        assert int(ts) == 0
        a = ta.numpy()
        used = a[a >= 0]
        assert len(used) == len(set(used.tolist())) and all(feas[i, a[i]] for i in np.flatnonzero(a >= 0))


@pytest.mark.parametrize("dtype,max_iters", [
    *((torch.float32, m) for m in (1, 31, 32, 33, 70, 3000)),   # f32 converges
    *((torch.bfloat16, m) for m in (1, 31, 32, 33, 70, 200)),   # bf16 caps phases
])
def test_auction_plain_chunked_reads_match_a_read_every_iteration(max_iters, dtype,
                                                                  monkeypatch):
    """The plain auction reads its convergence once per ``CHECK_EVERY``
    iterations and runs the rest of a chunk past convergence (iterations
    that bid nothing): the assignment, saturated phases, iterations per
    phase and dummy-only ones equal a read after every iteration's, with
    caps below, at and past a chunk's end (bf16's near ties cap every
    phase after the first: 200, not 3,000, keeps it short)."""
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian as th

    cost, feas, eps, max_cost, _ = _case("near-ties")
    c, f = torch.from_numpy(cost).to(dtype), torch.from_numpy(feas)
    got = auction_assign_plain(c, f, eps, max_cost, max_iters, return_split=True)
    monkeypatch.setattr(th, "CHECK_EVERY", 1)
    ref = auction_assign_plain(c, f, eps, max_cost, max_iters, return_split=True)
    assert torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
    assert got[2] == ref[2] and got[3] == ref[3]
    assert max(ref[2]) <= max_iters and (int(ref[1]) > 0) == (max(ref[2]) == max_iters)


def _top2_push(t, x, i):
    v1, i1, v2 = t
    if x > v1:
        return (x, i, v1)
    return (v1, i1, x) if x > v2 else t


def _top2_merge(a, b):
    if b[0] > a[0] or (b[0] == a[0] and b[1] < a[1]):
        return (b[0], b[1], max(a[0], b[2]))
    return (a[0], a[1], max(a[2], b[0]))


def _butterfly(lanes):
    """The warp's top two from the lanes' by the kernel's three warp
    reductions (``top2_warp``): the largest first value (-0 made +0), the
    smallest index holding it, then the largest of the other lanes' first
    values and the holder's second; checked against the xor-shuffle merge
    of every lane pair."""
    canon = [(F32(v1 + F32(0.0)), i1, F32(v2 + F32(0.0))) for v1, i1, v2 in lanes]
    best = max(c[0] for c in canon)
    bi = min(c[1] if c[0] == best else 2**31 - 1 for c in canon)
    sec = max(c[2] if c[1] == bi else c[0] for c in canon)
    merged = lanes
    for o in (16, 8, 4, 2, 1):
        merged = [_top2_merge(merged[i], merged[i ^ o]) for i in range(32)]
    assert len(set(merged)) == 1 and merged[0] == (best, bi, sec)
    return best, bi, sec


EMPTY = (F32(-np.inf), 2**31 - 1, F32(-np.inf))


def _warp_top2(vals, idx):
    """Lane l pushes entries l, l + 32, ... of (vals, idx) in order."""
    lanes = [EMPTY] * 32
    for j, (x, i) in enumerate(zip(vals, idx)):
        lanes[j % 32] = _top2_push(lanes[j % 32], x, i)
    return _butterfly(lanes)


def _key(bid, row):
    u = int(np.asarray(bid, F32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (~row & 0xFFFFFFFF)


def _unkey(key):
    u = key >> 32
    u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
    return np.asarray(u, np.uint32).view(F32)[()], ~(key & 0xFFFFFFFF) & 0xFFFFFFFF


MAX_FEAS = 4   # csrc/auction.cuh::kMaxFeas


def _rehearse_kernel(cost, feas, eps, max_cost, max_iters):
    """csrc/auction.cuh's bidding rules in numpy f32: each row's feasible
    columns listed (up to MAX_FEAS, ascending), then per iteration the
    lanes' strided sweep (every summary afresh) and warp reductions, one
    lane per unassigned row with a short list, the warp over the K columns
    of a row whose list overflowed, one bid for the dummy rows, packed-key
    winners, each column applied by its winner's bid entry."""
    d, k = cost.shape
    n = d + k
    neg_pen, neg_pen2, eps_ps = auction_schedule(d, eps, max_cost)
    neg_pen, neg_pen2, neg, neg_half = F32(neg_pen), F32(neg_pen2), F32(NEG32), F32(NEG_HALF32)
    value = np.where(feas, -cost, neg).astype(F32)
    lists = [[c for c in range(k) if value[r, c] != neg] for r in range(d)]
    price = np.zeros(n, F32)
    sat, iters = 0, []
    for eps_p in eps_ps:
        eps_p = F32(eps_p)
        owner = [-1] * n
        row_col = [-1] * n
        n_free, it = n, 0
        while n_free > 0 and it < max_iters:
            cols = list(range(n))
            td = _warp_top2([neg_pen2 - price[c] for c in cols], cols)
            lanes = [EMPTY] * 32              # lane c % 32 pushes virtual column c
            for c in range(k, n):
                lanes[c % 32] = _top2_push(lanes[c % 32], neg_pen - price[c], c)
            tv = _butterfly(lanes)
            dmin = min([r for r in range(d, n) if row_col[r] < 0], default=None)
            keys, entries = {}, []

            def bid(t, r):
                second = t[0] if t[2] <= neg_half else t[2]
                b = F32(F32(price[t[1]] + F32(t[0] - second)) + eps_p)
                keys[t[1]] = max(keys.get(t[1], 0), _key(b, r))
                entries.append((t[1], r))

            for r in range(d):                # one lane per row with a short list
                if row_col[r] < 0 and len(lists[r]) <= MAX_FEAS:
                    t = EMPTY
                    for c in lists[r]:
                        t = _top2_push(t, value[r, c] - price[c], c)
                    bid(_top2_merge(t, tv), r)
            for r in range(d):                # the warp over an overflowed row's K columns
                if row_col[r] < 0 and len(lists[r]) > MAX_FEAS:
                    bid(_top2_merge(_warp_top2([value[r, c] - price[c] for c in range(k)],
                                               list(range(k))), tv), r)
            if dmin is not None:
                bid(td, dmin)
            read = [(c, r, keys.get(c, 0)) for c, r in entries]
            for c, r, key in read:            # the winner's entry applies its column
                if key == 0 or _unkey(key)[1] != r:
                    continue
                b, w = _unkey(key)
                if not b > neg_half:
                    continue
                old = owner[c]
                owner[c], price[c], row_col[w] = w, b, c
                if old >= 0:
                    row_col[old] = -1
                else:
                    n_free -= 1
            it += 1
        sat += int(n_free > 0 and it >= max_iters)
        iters.append(it)
    assigned = [c if 0 <= c < k else -1 for c in row_col[:d]]
    return np.asarray(assigned, np.int32), sat, iters


@pytest.mark.parametrize("name", CASES)
def test_kernel_auction_rehearsed_matches_plain(name):
    """The kernel's one-warp auction with its dummy-row shortcut gives the
    literal version's assignment, saturation and iterations per phase."""
    cost, feas, eps, max_cost, max_iters = _case(name)
    got, sat, iters = _rehearse_kernel(cost, feas, eps, max_cost, max_iters)
    ta, ts, titers = _plain(name)
    np.testing.assert_array_equal(got, ta.numpy())
    assert sat == int(ts) and iters == titers


def test_k12_wrapper_on_the_cpu_is_the_plain_version():
    """``hungarian_cuda.auction_assign`` on CPU tensors runs the plain
    version problem by problem (no launch): stacked and single problems."""
    probs = [_case(n) for n in ("random-gated", "infeasible-rows")]
    n0 = hungarian_cuda.auction_assign.launches
    for cost, feas, eps, max_cost, max_iters in probs:
        c, f = torch.from_numpy(cost), torch.from_numpy(feas)
        a, s, it = hungarian_cuda.auction_assign(c, f, eps, max_cost, return_iters=True)
        pa, ps, pit = auction_assign_plain(c, f, eps, max_cost, return_iters=True)
        assert torch.equal(a, pa) and int(s) == int(ps) and it.tolist() == pit
        a2, s2 = hungarian_cuda.auction_assign(torch.stack([c, c]), torch.stack([f, f]), eps,
                                               max_cost)
        assert a2.shape == (2, cost.shape[0]) and torch.equal(a2[1], pa) and s2.tolist() == [0, 0]
    assert hungarian_cuda.auction_assign.launches == n0


# ---------------------------------------------------------------------------
# the associator on tests/test_hungarian.py's scenes
# ---------------------------------------------------------------------------
L_A, DT = 6, 0.1
ASSOC_SCENES = {  # name: (track positions, detections [(x, y)], next_obj_num)
    "crossing": ([(0.0, 0.0), (0.3, 0.0)], [(0.28, 0.0), (0.02, 0.0)], 2),
    "unmatched": ([(0.0, 0.0)], [(0.1, 0.0), (5.0, 5.0), (8.0, 8.0)], 1),
    "no-duplicates": ([(0.0, 0.0)], [(0.2, 0.0), (0.05, 0.0)], 1),
}


@pytest.mark.parametrize("name", list(ASSOC_SCENES))
def test_hungarian_associate_plain_matches_jax(name):
    tracks, det_xy, nxt = ASSOC_SCENES[name]
    k = 8
    xy = np.zeros((k, 2), F32)
    xy[:len(tracks)] = tracks
    alive = np.arange(k) < len(tracks)
    w, obj, birth = _bank_np(xy, alive, L_A)
    dets = np.zeros((len(det_xy), 4), F32)
    dets[:, :2] = det_xy
    dets[:, 3] = F32(DT) + w[0, -1, 3]
    dv = np.ones(len(det_xy), bool)
    jfn = jax.jit(functools.partial(j_hassoc, id_threshold=0.5, dt_gp=DT))
    j = jfn(_jbank(w, alive, obj, birth), jnp.int32(nxt), jnp.int32(nxt), jnp.asarray(dets),
            jnp.asarray(dv))
    t = hungarian_associate_and_update_plain(
        _tbank(w, alive, obj, birth), torch.tensor(nxt, dtype=torch.int32),
        torch.tensor(nxt, dtype=torch.int32), torch.from_numpy(dets), torch.from_numpy(dv),
        0.5, DT)
    for f in ("next_obj_num", "next_birth", "det_slot", "det_id", "det_new", "det_ok",
              "overflow", "assoc_saturated"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in ("alive", "obj_id", "birth_seq", "window", "m0"):
        np.testing.assert_array_equal(getattr(t.bank, f).numpy(), np.asarray(getattr(j.bank, f)),
                                      err_msg=f)
    ids = t.det_id.numpy()
    assert len(set(ids.tolist())) == len(ids)
    if name == "crossing":
        assert ids.tolist() == [1, 0]


# ---------------------------------------------------------------------------
# the whole track step on scripted scenes
# ---------------------------------------------------------------------------
L, K, D = 10, 6, 8
CAPS = dict(n_max_points=2048, m_max_voxels=512, m_max_dynamic=256, c_max_clusters=D,
            p_max_cluster=64, k_max_tracks=K)
CFG = dict(data_length=L, prune_period=0.6, voxel_leaf_size=0.1, max_cluster_size=300,
           association="hungarian")

# frames of (t, [(x, y), ...] valid detections, {lane: (x, y)} invalid lanes)
SCENES = {
    "crossing": [
        (0.1, [(0.0, 0.0), (0.3, 0.0), (3.0, 3.0)], {}),
        (0.2, [(0.28, 0.0), (0.02, 0.0), (3.02, 3.0)], {}),
        (0.3, [(0.05, 0.01), (0.26, 0.0), (0.15, 0.2)], {1: (0.1, 0.0)}),
        (0.4, [(0.07, 0.0), (0.24, 0.0), (0.15, 0.25), (3.1, 3.05)], {}),
    ],
    "overflow": [
        (0.1, [(0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)], {}),
        (0.2, [(0.0, 5.0), (1.0, 5.0), (2.0, 5.0), (3.0, 5.0), (0.02, 0.0)], {}),
        (0.3, [(4.0, 4.0), (1.01, 5.0), (0.03, 0.01)], {}),
        (0.4, [(4.0, 4.0), (5.0, 5.0)], {2: (7.0, 7.0)}),
    ],
    "interp": [
        (0.1, [(0.0, 0.0), (1.0, -1.0)], {}),
        (0.2, [(0.03, 0.01), (1.02, -1.0)], {}),
        (0.9, [(0.2, 0.05), (1.1, -0.95)], {}),                 # gap 0.7 s: 6 backfilled
        (1.0, [(0.22, 0.06)], {}),
        (3.0, [(0.3, 0.1), (1.2, -0.9)], {}),                   # past the window
    ],
    "expiry": [(0.1 * (k + 1), [(0.01 * k, 0.0)] + ([(2.0, 2.0)] if k < 2 else []), {})
               for k in range(7)]
    + [(0.8, [], {}), (0.9, [(0.08, 0.0)], {})]
    + [(1.0 + 0.1 * k, [(0.09 + 0.01 * k, 0.0)], {}) for k in range(4)],
}


def _scene_frames(name):
    """(t, dets (D, 4) f32, valid (D,)) per frame; lanes past the valid
    ones carry noise (a NaN among them)."""
    rng = np.random.default_rng(sum(map(ord, name)) + 17)
    out = []
    for t, xy, invalid in SCENES[name]:
        dets = rng.uniform(-5, 5, (D, 4)).astype(F32)
        dets[D - 1, 0] = np.nan
        valid = np.zeros(D, bool)
        lane = 0
        for x, y in xy:
            while lane in invalid:
                dets[lane, :2] = invalid[lane]
                lane += 1
            dets[lane] = [x, y, 0.0, t]
            valid[lane] = True
            lane += 1
        out.append((F32(t), dets, valid))
    return out


@functools.lru_cache(maxsize=None)
def _pair(position_filter):
    jcfg = JConfig(caps=JCaps(**CAPS), position_filter=position_filter, **CFG)
    tcfg = TConfig(caps=TCaps(**CAPS), position_filter=position_filter, **CFG)
    jt = JTracker(jcfg)
    jstep = jax.jit(functools.partial(j_track_step, config=jcfg, gains_xy=jt.gains_xy))
    return jt, jstep, TTracker(tcfg, "cpu"), tcfg


def _jp(t, dets, valid):
    z = jnp.int32(0)
    return JPerception(dets=jnp.asarray(dets), det_valid=jnp.asarray(valid), t=jnp.float32(t),
                       n_points=z, n_vox=z, n_dynamic=z, n_clusters=jnp.int32(valid.sum()),
                       cc_saturated=z)


def _tp(t, dets, valid):
    z = torch.tensor(0, dtype=torch.int32)
    return TPerception(dets=torch.from_numpy(dets), det_valid=torch.from_numpy(valid),
                       t=torch.tensor(t), n_points=z, n_vox=z, n_dynamic=z,
                       n_clusters=torch.tensor(int(valid.sum()), dtype=torch.int32),
                       cc_saturated=z)


@pytest.mark.parametrize("position_filter", ["lpf", "ihgp"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_hungarian_track_step_matches_jax(name, position_filter):
    jt, jstep, tt, tcfg = _pair(position_filter)
    js, ts = jt.init_state(), tt.init_state()
    seen = dict(overflow=0, expired=0, interp=0, published=0)
    for k, (t, dets, valid) in enumerate(_scene_frames(name)):
        alive_before = ts.bank.alive.clone()
        js, jo = jstep(js, _jp(t, dets, valid))
        ts, to = track_step(ts, _tp(t, dets, valid), config=tcfg, gains_xy=tt.gains_xy)
        v = np.asarray(jo.valid)
        for f in FrameOutput._fields:
            a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
            if f in ("pos", "vel"):
                tol = TOL_VEL if f == "vel" else TOL_POS
                np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{k} {f}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"frame {k} {f}")
        for f in ("alive", "obj_id", "birth_seq"):
            np.testing.assert_array_equal(getattr(ts.bank, f).numpy(),
                                          np.asarray(getattr(js.bank, f)), err_msg=f"{k} {f}")
        for f in ("next_obj_num", "next_birth", "spin_counter", "initialized"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"{k} {f}")
        np.testing.assert_allclose(ts.bank.window.numpy(), np.asarray(js.bank.window),
                                   rtol=0, atol=TOL_WIN, err_msg=f"{k} window")
        np.testing.assert_allclose(ts.bank.m0.numpy(), np.asarray(js.bank.m0), rtol=0,
                                   atol=TOL_M, err_msg=f"{k} m0")
        ids = to.obj_id.numpy()[to.valid.numpy()]
        assert len(ids) == len(set(ids.tolist()))            # one detection per track
        seen["overflow"] += int(to.overflow)
        seen["expired"] += int((alive_before & ~ts.bank.alive).sum())
        seen["interp"] += int(name == "interp" and k == 2)
        seen["published"] += int(to.valid.sum())
    want = {"overflow": "overflow", "expiry": "expired", "interp": "interp",
            "crossing": "published"}[name]
    assert seen[want] > 0, seen


def test_crossing_scene_is_one_greedy_gets_wrong():
    """On the crossing scene's second frame the greedy scan hands detection
    0 to track 0 (first match in registration order) where the auction
    pairs it with track 1."""
    _, _, tt, tcfg = _pair("lpf")
    frames = _scene_frames("crossing")
    ids = {}
    for assoc in ("greedy", "hungarian"):
        cfg = tcfg.replace(association=assoc)
        st = tt.init_state()
        for t, dets, valid in frames[:2]:
            st, out = track_step(st, _tp(t, dets, valid), config=cfg, gains_xy=tt.gains_xy)
        ids[assoc] = out.obj_id.numpy()[:2].tolist()
    assert ids["hungarian"] == [1, 0] and ids["greedy"] == [0, 0]


@pytest.mark.parametrize("backend", ["auto", "pallas", "jnp"])
def test_track_route_takes_k4_under_hungarian_whatever_the_backend(backend):
    cfg = bench_cases.bench_config().replace(association="hungarian", assoc_backend=backend)
    assert track_route(cfg, 64, 32) == "kernel"
    assert track_route(cfg, 2048, 32) == "kernel"      # past K4's narrow builds: K4 xl
    assert track_route(cfg, 64, 256) == "kernel"
    assert track_route(cfg.replace(association="greedy"), 64, 32) == "kernel"
    assert track_route(cfg, 2048, 32, "cpu") == "plain"


@pytest.mark.parametrize("entry", ["Tracker", "TrackerNode"])
def test_hungarian_config_builds(entry):
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    cfg = bench_cases.hungarian_case()[0]
    built = TTracker(cfg, device="cpu") if entry == "Tracker" else TrackerNode(cfg, device="cpu")
    tracker = built if entry == "Tracker" else built.tracker
    assert tracker.config.association == "hungarian"


def test_dense_case_is_the_bench_copy():
    """``bench_cases.dense_case`` is ``bench.dense_case``: the same config
    and the same frames."""
    import bench

    jc, _, jsc = bench.dense_case()
    tc, _, tsc = bench_cases.dense_case()
    for f in dataclasses.fields(jc):
        assert repr(getattr(jc, f.name)) == repr(getattr(tc, f.name)), f.name
    for k in (0, 5):
        (a, ta), (b, tb) = jsc.frame_arrays(k), tsc.frame_arrays(k)
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    assert bench_cases.dense_hungarian_case()[0] == tc.replace(association="hungarian")
