"""``association="hungarian"`` under ``dtype="bfloat16"`` / ``"float16"``:
the port's plain versions against the JAX package on the CPU, bit for bit,
and K12's half builds (``csrc/auction.cu``, the auction on ``HV<H>``
values) compiled for the host against the plain version.

- The auction alone: ``ops/hungarian.py::auction_assign_plain`` on half
  costs against the jitted JAX ``auction_assign`` on the same half costs,
  on problems built to tie (costs on a 1/8 m lattice, rows equal) and to be
  infeasible (most pairs, whole rows, a lone row with no feasible pair --
  in f16 ``_NEG`` is -inf, so its second maximum is -inf), and one cut at
  a small ``max_iters``: assignments, saturated phases and the iterations
  of every phase (the JAX loop's count read by a ``jax.debug.callback``
  on each ``while_loop``'s final carry).
- The same problems through K12's half builds compiled for the host with
  g++ (``tests/test_torch_auction_schedule.py``'s shim, with host CUDA
  half headers): assignments, saturated phases, iterations per phase and
  the dummy-only ones among them.
- The associator (``hungarian_associate_and_update_plain``) and the whole
  track step on scripted scenes against the jitted JAX functions in half.
"""

import ctypes
import functools
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps  # noqa: E402
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig  # noqa: E402
from multiple_object_tracking_lidar_tpu.ops import hungarian as jh  # noqa: E402
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Perception as JPerception  # noqa: E402
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker  # noqa: E402
from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step  # noqa: E402
from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank as JBank  # noqa: E402

from multiple_object_tracking_lidar_tpu_torch.config import Capacities as TCaps  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig as TConfig  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (  # noqa: E402
    auction_assign_plain,
    auction_negs,
    auction_schedule,
    hungarian_associate_and_update_plain,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception as TPerception  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_step  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.tracker.state import FrameOutput, TrackBank  # noqa: E402

from test_torch_auction_schedule import host_auction  # noqa: E402, F401  (the fixture)
from test_torch_golden import one_intra_op_thread  # noqa: E402, F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
F32 = np.float32


# ---------------------------------------------------------------------------
# the auction
# ---------------------------------------------------------------------------
def _problem(name):
    """(cost (D, K) f32 holding values any half dtype rounds alike or not,
    feasible (D, K), eps, max_cost, max_iters)."""
    rng = np.random.default_rng(sum(map(ord, name)) + 3)
    if name == "lattice-ties":         # costs on a 1/8 m lattice: exact in both dtypes
        cost = (rng.integers(0, 7, (12, 10)) / 8).astype(F32)
        cost[5] = cost[2]
        return cost, cost < 0.5, 1e-3, 0.5, 3000
    if name == "equal-columns":        # every feasible pair the same cost
        cost = np.full((8, 16), 0.25, F32)
        return cost, rng.uniform(size=cost.shape) < 0.5, 1e-3, 0.5, 3000
    if name == "infeasible-heavy":     # few feasible pairs, whole rows without one
        cost = rng.uniform(0, 0.5, (20, 12)).astype(F32)
        feas = rng.uniform(size=cost.shape) < 0.15
        feas[[1, 4, 9, 15]] = False
        return cost, feas, 1e-3, 0.5, 3000
    if name == "all-infeasible":
        cost = rng.uniform(0, 0.5, (6, 8)).astype(F32)
        return cost, np.zeros(cost.shape, bool), 1e-3, 0.5, 3000
    if name == "lone-row":             # D = 1 and no feasible pair: one virtual column
        cost = rng.uniform(0, 0.5, (1, 9)).astype(F32)
        return cost, np.zeros(cost.shape, bool), 1e-3, 0.5, 3000
    if name == "headline-shape":       # the headline's (D, K) at its gate
        cost = rng.uniform(0, 0.8, (32, 64)).astype(F32)
        return cost, (cost < 0.5) & (rng.uniform(size=cost.shape) < 0.8), 1e-3, 0.5, 3000
    if name == "capped":
        cost = (F32(0.25) + rng.uniform(0, 0.01, (16, 16))).astype(F32)
        return cost, np.ones(cost.shape, bool), 1e-3, 1.0, 40
    raise ValueError(name)


PROBLEMS = ["lattice-ties", "equal-columns", "infeasible-heavy", "all-infeasible", "lone-row",
            "headline-shape", "capped"]
CASES = [(p, d) for p in PROBLEMS for d in DTYPES]
IDS = [f"{p}-{d}" for p, d in CASES]


def _half(cost, dtype):
    """The f32 costs rounded to ``dtype``: (torch tensor, jnp array)."""
    t = torch.from_numpy(cost).to(DTYPES[dtype])
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


_ITERS = []


def _counting_while_loop(cond, body, init):
    out = _REAL_WHILE_LOOP(cond, body, init)
    jax.debug.callback(lambda it: _ITERS.append(int(it)), out[2])
    return out


_REAL_WHILE_LOOP = jax.lax.while_loop


def _jax_auction(cost, feas, eps, max_cost, max_iters):
    """The jitted JAX auction: (assigned, saturated, iterations per phase)."""
    fn = jax.jit(functools.partial(jh.auction_assign, eps=eps, max_cost=max_cost,
                                   max_iters=max_iters))
    _ITERS.clear()
    jax.lax.while_loop = _counting_while_loop
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # f16's -inf _NEG cast
            a, s = fn(cost, jnp.asarray(feas))
            a, s = np.asarray(a), int(s)
    finally:
        jax.lax.while_loop = _REAL_WHILE_LOOP
    return a, s, list(_ITERS)


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_half_auction_plain_matches_jax(name, dtype):
    cost, feas, eps, max_cost, max_iters = _problem(name)
    tc, jc = _half(cost, dtype)
    ja, js, jit = _jax_auction(jc, feas, eps, max_cost, max_iters)
    ta, ts, tit = auction_assign_plain(tc, torch.from_numpy(feas), eps, max_cost, max_iters,
                                       return_iters=True)
    np.testing.assert_array_equal(ta.numpy(), ja)
    assert int(ts) == js and tit == jit, (int(ts), js, tit, jit)
    if name == "capped":
        assert js > 0
    if name in ("all-infeasible", "lone-row"):
        assert (ja == -1).all()


def test_half_auction_negs_are_the_jax_casts():
    """``_NEG`` and ``_NEG / 2`` in the half dtypes: finite in bf16, -inf in
    f16 (as jnp casts the weak-typed constant), with no warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        neg, half = auction_negs(torch.float16)
        nb, hb = auction_negs(torch.bfloat16)
    assert neg == half == -np.inf
    assert np.isfinite(nb) and np.isfinite(hb) and nb < hb < -1e38
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for dt, (n, h) in (("bfloat16", (nb, hb)), ("float16", (neg, half))):
            assert float(jnp.asarray(jh._NEG, dt)) == n
            assert float(jnp.asarray(jh._NEG / 2, dt)) == h


@pytest.mark.parametrize("name,dtype", CASES, ids=IDS)
def test_half_auction_source_on_the_host_matches_plain(host_auction, name, dtype):  # noqa: F811
    """K12's half build (``motl_auction_assign_bf16`` / ``_f16``) compiled
    for the host: the plain version's assignment, saturated phases,
    iterations per phase and dummy-only iterations, bit for bit."""
    cost, feas, eps, max_cost, max_iters = _problem(name)
    tc, _ = _half(cost, dtype)
    d, k = cost.shape
    neg_pen, neg_pen2, eps_ps = auction_schedule(d, eps, max_cost, dtype=DTYPES[dtype])
    params = np.asarray([*auction_negs(DTYPES[dtype]), neg_pen, neg_pen2, *eps_ps], F32)
    bits = np.ascontiguousarray(tc.view(torch.int16).numpy())
    f = np.ascontiguousarray(feas.astype(np.uint8))
    assigned, sat = np.zeros(d, np.int32), np.zeros(1, np.int32)
    iters, fast = np.zeros(len(eps_ps), np.int32), np.zeros(len(eps_ps), np.int32)
    entry = getattr(host_auction, "motl_auction_assign_" + ("bf16" if dtype == "bfloat16"
                                                            else "f16"))
    P, I = ctypes.c_void_p, ctypes.c_int
    entry.argtypes = [P, P, P, I, I, I, I, I, P, P, P, P, P]
    err = entry(bits.ctypes.data, f.ctypes.data, params.ctypes.data, len(eps_ps), max_iters, 1,
                d, k, assigned.ctypes.data, sat.ctypes.data, iters.ctypes.data,
                fast.ctypes.data, None)
    assert err == 0
    pa, ps, pit, pfast = auction_assign_plain(tc, torch.from_numpy(feas), eps, max_cost,
                                              max_iters, return_split=True)
    np.testing.assert_array_equal(assigned, pa.numpy())
    assert int(sat[0]) == int(ps) and iters.tolist() == pit and fast.tolist() == pfast


def test_k12_wrapper_on_the_cpu_runs_the_half_plain_version():
    """K12's wrapper on half CPU tensors is the plain version, stacked or
    not, and launches nothing."""
    n0 = sum(hungarian_cuda.auction_assign.launches_by.values())
    for dtype in DTYPES.values():
        probs = [_problem(n) for n in ("lattice-ties", "infeasible-heavy")]
        c = torch.stack([torch.from_numpy(p[0][:12, :10]).to(dtype) for p in probs])
        f = torch.stack([torch.from_numpy(p[1][:12, :10]) for p in probs])
        a, s, it = hungarian_cuda.auction_assign(c, f, 1e-3, 0.5, return_iters=True)
        for b in range(2):
            pa, ps, pit = auction_assign_plain(c[b], f[b], 1e-3, 0.5, return_iters=True)
            assert torch.equal(a[b], pa) and int(s[b]) == int(ps) and it[b].tolist() == pit
    assert sum(hungarian_cuda.auction_assign.launches_by.values()) == n0


# ---------------------------------------------------------------------------
# the associator and the track step
# ---------------------------------------------------------------------------
DT = 0.1


@pytest.mark.parametrize("dtype", DTYPES)
def test_half_hungarian_associate_matches_jax(dtype):
    """The gate costs (f16: one FMA and the f16 root; bf16: each op
    rounded), the auction and the lifecycle on a bank of 24 slots (16
    alive) and 20 detections scattered about them, some on the gate's
    edge, some invalid: every field against the jitted JAX associator."""
    rng = np.random.default_rng(7)
    k, L = 24, 5
    xy = rng.uniform(-2, 2, (k, 2)).astype(F32)
    alive = np.arange(k) < 16
    w = np.zeros((k, L, 4), F32)
    w[:, :, :2] = xy[:, None, :]
    w[:, :, 3] = np.arange(L, dtype=F32)[None, :] * F32(DT)
    obj = np.where(alive, np.arange(k), -1).astype(np.int32)
    birth = np.where(alive, np.arange(k), 2**30).astype(np.int32)
    dets = np.zeros((20, 4), F32)
    near = rng.integers(0, 16, 20)
    ang = rng.uniform(0, 2 * np.pi, 20)
    r = np.where(np.arange(20) % 4 == 0, 0.5, rng.uniform(0, 0.7, 20))   # some on the gate
    dets[:, 0] = xy[near, 0] + r * np.cos(ang)
    dets[:, 1] = xy[near, 1] + r * np.sin(ang)
    dets[:, 3] = F32(L * DT)
    dv = rng.uniform(size=20) < 0.85
    hd = DTYPES[dtype]
    tw, td = torch.from_numpy(w).to(hd), torch.from_numpy(dets).to(hd)
    tbank = TrackBank(alive=torch.from_numpy(alive), obj_id=torch.from_numpy(obj),
                      birth_seq=torch.from_numpy(birth), window=tw,
                      m0=torch.zeros((k, 2, 2), dtype=hd))
    jbank = JBank(alive=jnp.asarray(alive), obj_id=jnp.asarray(obj),
                  birth_seq=jnp.asarray(birth), window=jnp.asarray(tw.float().numpy()).astype(dtype),
                  m0=jnp.zeros((k, 2, 2), dtype))
    jfn = jax.jit(functools.partial(jh.hungarian_associate_and_update, id_threshold=0.5,
                                    dt_gp=DT))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        j = jfn(jbank, jnp.int32(16), jnp.int32(16),
                jnp.asarray(td.float().numpy()).astype(dtype), jnp.asarray(dv))
    t = hungarian_associate_and_update_plain(
        tbank, torch.tensor(16, dtype=torch.int32), torch.tensor(16, dtype=torch.int32), td,
        torch.from_numpy(dv), 0.5, DT)
    for f in ("next_obj_num", "next_birth", "det_slot", "det_id", "det_new", "det_ok",
              "overflow", "assoc_saturated"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in ("alive", "obj_id", "birth_seq", "window", "m0"):
        a = getattr(t.bank, f)
        np.testing.assert_array_equal(a.float().numpy() if a.is_floating_point() else a.numpy(),
                                      np.asarray(getattr(j.bank, f)).astype(
                                          np.float32 if a.is_floating_point() else None),
                                      err_msg=f)
    assert int(t.det_ok.sum()) >= 10 and (t.det_ok & ~t.det_new).any()


L_S, K_S, D_S = 10, 6, 8
CAPS = dict(n_max_points=2048, m_max_voxels=512, m_max_dynamic=256, c_max_clusters=D_S,
            p_max_cluster=64, k_max_tracks=K_S)
CFG = dict(data_length=L_S, prune_period=0.6, voxel_leaf_size=0.1, max_cluster_size=300,
           association="hungarian")
SCENES = {  # frames of (t, [(x, y), ...] valid detections)
    "crossing": [(0.1, [(0.0, 0.0), (0.3, 0.0), (3.0, 3.0)]),
                 (0.2, [(0.28, 0.0), (0.02, 0.0), (3.02, 3.0)]),
                 (0.3, [(0.05, 0.01), (0.26, 0.0), (0.15, 0.2)]),
                 (0.4, [(0.07, 0.0), (0.24, 0.0), (0.15, 0.25), (3.1, 3.05)])],
    "overflow": [(0.1, [(0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)]),
                 (0.2, [(0.0, 5.0), (1.0, 5.0), (2.0, 5.0), (3.0, 5.0), (0.02, 0.0)]),
                 (0.3, [(4.0, 4.0), (1.01, 5.0), (0.03, 0.01)]),
                 (0.4, [(4.0, 4.0), (5.0, 5.0)])],
    "interp": [(0.1, [(0.0, 0.0), (1.0, -1.0)]), (0.2, [(0.03, 0.01), (1.02, -1.0)]),
               (0.9, [(0.2, 0.05), (1.1, -0.95)]), (1.0, [(0.22, 0.06)])],
}


def _scene(name, dtype):
    """(t, dets (D, 4), valid (D,)) per frame, dets rounded to ``dtype``
    and held as f32; the lanes past the valid ones noise."""
    rng = np.random.default_rng(sum(map(ord, name)) + 29)
    out = []
    for t, xy in SCENES[name]:
        dets = rng.uniform(-5, 5, (D_S, 4)).astype(F32)
        valid = np.zeros(D_S, bool)
        for lane, (x, y) in enumerate(xy):
            dets[lane] = [x, y, 0.0, t]
            valid[lane] = True
        dets = torch.from_numpy(dets).to(DTYPES[dtype]).float().numpy()
        out.append((t, dets, valid))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_half_hungarian_track_step_matches_jax(name, dtype):
    """The whole track step under hungarian in half on scripted scenes
    (crossing tracks, a full bank, an interpolation gap): every output,
    the bank and the window bit for bit the jitted JAX ``track_step``."""
    jcfg = JConfig(caps=JCaps(**CAPS), dtype=dtype, **CFG)
    tcfg = TConfig(caps=TCaps(**CAPS), dtype=dtype, **CFG)
    jt, tt = JTracker(jcfg), TTracker(tcfg, "cpu")
    jstep = jax.jit(functools.partial(j_track_step, config=jcfg, gains_xy=jt.gains_xy))
    js, ts = jt.init_state(), tt.init_state()
    hd = DTYPES[dtype]
    z, zj = torch.tensor(0, dtype=torch.int32), jnp.int32(0)
    published = 0
    for k, (t, dets, valid) in enumerate(_scene(name, dtype)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            js, jo = jstep(js, JPerception(
                dets=jnp.asarray(dets).astype(dtype), det_valid=jnp.asarray(valid),
                t=jnp.asarray(t, dtype), n_points=zj, n_vox=zj, n_dynamic=zj,
                n_clusters=jnp.int32(valid.sum()), cc_saturated=zj))
        ts, to = track_step(ts, TPerception(
            dets=torch.from_numpy(dets).to(hd), det_valid=torch.from_numpy(valid),
            t=torch.tensor(t, dtype=hd), n_points=z, n_vox=z, n_dynamic=z,
            n_clusters=torch.tensor(int(valid.sum()), dtype=torch.int32), cc_saturated=z),
            config=tcfg, gains_xy=tt.gains_xy)
        for f in FrameOutput._fields:
            a, b = np.asarray(getattr(jo, f)), getattr(to, f)
            b = b.float().numpy() if b.is_floating_point() else b.numpy()
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f"frame {k} {f}")
        for f in ("alive", "obj_id", "birth_seq", "window", "m0"):
            b = getattr(ts.bank, f)
            b = b.float().numpy() if b.is_floating_point() else b.numpy()
            np.testing.assert_array_equal(b, np.asarray(getattr(js.bank, f)).astype(b.dtype),
                                          err_msg=f"frame {k} {f}")
        published += int(to.valid.sum())
    assert published > 0
