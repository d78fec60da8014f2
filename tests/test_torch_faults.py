"""The port's repaired faults against the JAX package, on the CPU (their
GPU halves are in tests/test_torch_cuda.py):

- F1: the track step past K4's narrow builds -- a default bank grown past
  1,024 slots, and C = 256 detection slots -- and under
  ``assoc_backend="jnp"``: K4 (K4 xl past the narrow builds) on the card,
  the plain version on the CPU (``track_route``), which matches the JAX
  track_step;
- F2: the CLI's 70,200-cell grid, past one CTA's histogram, takes K1 and
  K5 (eight ranges of CTAs; their plain versions here) and matches the
  JAX package; past their 232,320-cell layouts too (the wide layout: more
  ranges), matching the JAX fast-digit route;
- F3: ``bind_env(env, donate_state=...)`` and ``bind_env_multi(env,
  donate_state=..., hoist=...)`` take the JAX keywords, refuse exactly the
  configs the JAX package refuses, and every hoist gives the same bits;
- F4: ``TrackerNode.run(frames, realtime=True)`` paces frames at the
  config's frequency, as the JAX node's ``run``;
- F5: ``TrackerNode.outputs`` stays empty unless ``keep_outputs=True`` (the
  JAX node keeps no outputs);
- F6: ``grid_cc="pallas"`` runs K2 on a 22,374-cell grid (past one CTA,
  within the JAX fused CC's 32,768) and matches the JAX package there;
- F7: the point list's CC takes the ``m_max_dynamic`` values the JAX
  package takes: K8a (the jnp CC's adjacency) any M, K8 the Pallas rule
  "M % 256 == 0 past 256" alone; past ``MAX_ROWS`` (the frame in shared
  memory) both wrappers launch with the frame in device memory, up to
  ``MAX_DEVICE_ROWS``; the jnp CC at a ragged M = 1,000 matches the JAX jnp
  CC under jit (K8's prep spells XLA's tree column sum).

Tolerances as in test_torch_track_kernel.py: decisions and integers exact,
positions 1e-5 m, velocities 1e-4 m/s, windows 1e-6, GP carries 1e-4.
"""

import dataclasses
import functools
import inspect
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.ops.grid_pallas import fused_cc_fits as j_fused_cc_fits
from multiple_object_tracking_lidar_tpu.ops import voxel_grid as jvg
from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot_cm
from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Perception as JPerception
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.pipeline import perceive_from_acc as j_perceive
from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step
from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank as JBank
from multiple_object_tracking_lidar_tpu.tracker.state import TrackerState as JState
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities as TCaps
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig as TConfig
from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid as tvg
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vgc
from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.tracker import pipeline as tpipe
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception as TPerception
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame
from multiple_object_tracking_lidar_tpu_torch.tracker.state import state_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_POS, TOL_VEL, TOL_WIN, TOL_M = 1e-5, 1e-4, 1e-6, 1e-4


# ---------------------------------------------------------------------------
# F1
# ---------------------------------------------------------------------------
def _bank(k, L, live, rng):
    """A bank of k slots with tracks alive in ``live``, moving in x."""
    alive = np.zeros(k, bool)
    alive[live] = True
    obj_id = np.where(alive, np.arange(k) + 7, -1).astype(np.int32)
    birth = np.full(k, 2**30, np.int32)
    birth[live] = rng.permutation(len(live))
    window = np.zeros((k, L, 4), np.float32)
    xy = rng.uniform(-20, 20, (k, 2)).astype(np.float32)
    for j in range(L):
        window[:, j, 0] = xy[:, 0] + np.float32(0.02) * j
        window[:, j, 1] = xy[:, 1]
        window[:, j, 3] = np.float32(1.0 - (L - 1 - j) * 0.1)
    m0 = rng.normal(0, 0.05, (k, 2, 2)).astype(np.float32)
    return dict(alive=alive, obj_id=obj_id, birth_seq=birth, window=window, m0=m0)


def _run_f1(k, d, live, n_new):
    rng = np.random.default_rng(k + d)
    L = 10
    caps = dict(n_max_points=1024, m_max_voxels=256, m_max_dynamic=128, c_max_clusters=d,
                p_max_cluster=32, k_max_tracks=k)
    jcfg = JConfig(data_length=L, caps=JCaps(**caps))
    tcfg = TConfig(data_length=L, caps=TCaps(**caps))
    assert tpipe.track_route(tcfg, k, d, "cpu") == "plain"
    bank = _bank(k, L, live, rng)
    scal = dict(next_obj_num=np.int32(500), next_birth=np.int32(len(live)),
                spin_counter=np.int32(0), initialized=np.bool_(True))
    js = JState(bank=JBank(**{f: jnp.asarray(v) for f, v in bank.items()}),
                **{f: jnp.asarray(v) for f, v in scal.items()})
    ts = state_from_numpy(JState(bank=JBank(**bank), **scal))
    jt, tt = JTracker(jcfg), TTracker(tcfg, "cpu")
    jstep = jax.jit(functools.partial(j_track_step, config=jcfg, gains_xy=jt.gains_xy))
    for f in range(3):
        t = np.float32(1.1 + 0.1 * f)
        dets = rng.uniform(-30, 30, (d, 4)).astype(np.float32)
        valid = np.zeros(d, bool)
        lane = 0
        for s in live:                                   # every track seen, one twice
            for _ in range(2 if s == live[-1] else 1):
                dets[lane] = [bank["window"][s, -1, 0] + 0.02 * (f + 1), bank["window"][s, -1, 1],
                              0.0, t]
                valid[lane] = True
                lane += 3                                # invalid lanes in between
        for q in range(n_new):                           # registrations: lowest free slots
            dets[lane] = [40.0 + q, 40.0 + 10.0 * f, 0.0, t]
            valid[lane] = True
            lane += 1
        z = jnp.int32(0)
        js, jo = jstep(js, JPerception(jnp.asarray(dets), jnp.asarray(valid), jnp.float32(t),
                                       z, z, z, jnp.int32(valid.sum()), z))
        zt = torch.tensor(0, dtype=torch.int32)
        ts, to = tpipe.track_step(
            ts, TPerception(torch.from_numpy(dets), torch.from_numpy(valid), torch.tensor(t),
                            zt, zt, zt, torch.tensor(int(valid.sum())), zt),
            config=tcfg, gains_xy=tt.gains_xy)
        v = np.asarray(jo.valid)
        assert 0 < v.sum() <= valid.sum()
        for name in jo._fields:
            a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
            if name in ("pos", "vel"):
                np.testing.assert_allclose(b[v], a[v], rtol=0,
                                           atol=TOL_POS if name == "pos" else TOL_VEL)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"frame {f} {name}")
        for name in ("alive", "obj_id", "birth_seq"):
            np.testing.assert_array_equal(getattr(ts.bank, name).numpy(),
                                          np.asarray(getattr(js.bank, name)))
        np.testing.assert_allclose(ts.bank.window.numpy(), np.asarray(js.bank.window), rtol=0,
                                   atol=TOL_WIN)
        np.testing.assert_allclose(ts.bank.m0.numpy(), np.asarray(js.bank.m0), rtol=0, atol=TOL_M)
    return to


def test_f1_bank_grown_past_1024_slots_matches_jax():
    """A default bank (K = 64) grown five times, to 2,048 slots, with
    tracks alive past slot 1,024: past K4's one-CTA bound."""
    to = _run_f1(2048, 32, [3, 100, 1030, 1800, 2047], 2)
    assert int(to.n_alive) == 11


def test_f1_256_detection_slots_match_jax():
    """``caps.c_max_clusters = 256``: past K4's 128-detection buffer."""
    to = _run_f1(64, 256, list(range(0, 60, 3)), 30)
    assert int(to.overflow) == 30        # 20 tracks + 30 registrations a frame in 64 slots


def test_f1_routes():
    """K4 on the card at every size -- K4 xl past its narrow builds' 1,024
    slots and 128 detections -- and under every ``assoc_backend`` (the JAX
    package documents its jnp and Pallas scans' decisions as the same,
    config.py:179-186); the plain version on the CPU."""
    cfg = TConfig()
    for c in (cfg, cfg.replace(assoc_backend="pallas"), cfg.replace(assoc_backend="jnp")):
        for k, d in ((64, 32), (1024, 128), (1025, 32), (64, 129), (4096, 512)):
            assert tpipe.track_route(c, k, d) == "kernel"
            assert tpipe.track_route(c, k, d, "cuda") == "kernel"
            assert tpipe.track_route(c, k, d, "cpu") == "plain"


# ---------------------------------------------------------------------------
# F2
# ---------------------------------------------------------------------------
F2_SCENE = dict(x_min=0.0, x_max=5.15, y_min=0.0, y_max=11.24, z_min=0.0, z_max=2.0)


def _jit_fast_route(pts, mask, scene, leaf, leaf_z):
    """The JAX package's fast-digit jnp route under ``jax.jit`` (the
    program its tracking paths run): ((4, n_cells) f32, point count)."""
    acc, n = jax.jit(lambda p, m: voxel_accumulate_onehot_cm(
        p, m, scene, leaf, leaf_z, quant="fast", with_npts=True))(jnp.asarray(pts), jnp.asarray(mask))
    return np.asarray(acc), n


def _f2_points(rng, n, leaf, hi=(5.5, 11.5, 2.2)):
    """n points over the F2 scenes (and past their edges), 300 on leaf
    boundaries, 10 NaN rows and a 1,000-point blob in one cell."""
    pts = np.stack([rng.uniform(-0.3, hi[0], n), rng.uniform(-0.3, hi[1], n),
                    rng.uniform(-0.2, hi[2], n)], 1).astype(np.float32)
    pts[:300] = (np.round(pts[:300] / leaf) * leaf).astype(np.float32)   # leaf boundaries
    pts[300:310, 0] = np.nan
    pts[400:1400] = pts[400] + rng.normal(0, 0.01, (1000, 3)).astype(np.float32)  # one blob
    return pts


@pytest.mark.parametrize("quant", ["fast", "exact"])
def test_f2_digit_sums_past_the_one_cta_histogram(quant):
    """70,200 cells (104 x 225 x 3, the CLI's grid on the sim map), past
    one CTA's histogram (14,520 cells): the grid fits K1's and K5's
    ranges of CTAs (``max_cells``, 232,320), so the dispatcher takes
    the kernels (on the CPU their plain versions) and never the plain
    route, and matches the JAX package in the same mode on the same points
    and mask.  Fast mode: its fast-digit route (the same integer sums; the
    f32 finalize too, under ``jax.jit``: test_torch_voxel.py).  Exact
    mode: the TPU's exact program, the stacked v6 kernel (interpret mode)
    -- its raw two-digit sums and point count exact, the port's accumulator
    equal to its jitted ``finalize_exact_digits`` (the FMAs XLA's CPU code
    contracts, which K5 spells); also K5's plain version bit for bit."""
    scene, leaf, leaf_z = TScene(**F2_SCENE), 0.05, 1.0
    assert vgc.kernel_params(scene, leaf, leaf_z)["n_cells"] == 70_200 <= vgc.max_cells()
    assert vgc.digit_layout(70_200, 1)[0] == 8                  # ceil(70,200 / 8) <= 14,520
    rng = np.random.default_rng(70)
    n = 4096
    pts = _f2_points(rng, n, leaf)
    mask = rng.random(n) < 0.95
    P, M = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
    routes = tvg.digit_sums_stacked.plain_routes
    acc, npts = tvg.voxel_accumulate_stacked(P, M, scene, leaf, leaf_z, quant=quant)
    sums, _ = tvg.digit_sums_stacked(P, M, scene, leaf, leaf_z, quant)
    assert tvg.digit_sums_stacked.plain_routes == routes + 1     # a CPU call
    assert sums.dtype == torch.int32 and int(npts[0]) == int(mask.sum())
    if quant == "exact":
        ref, _ = vgc.accumulate_exact_stacked_plain(P, M, scene, leaf, leaf_z)
        assert torch.equal(acc.view(torch.int32), ref.view(torch.int32))
        js = JScene(**F2_SCENE)
        raw, jn = jvg._accumulate_pallas_v6_stacked_raw(
            jnp.asarray(pts[None]), jnp.asarray(mask[None]), js, leaf, leaf_z, block=2048,
            interpret=True)
        np.testing.assert_array_equal(
            sums[0].numpy(), np.asarray(raw).reshape(7, -1)[:, :70_200].astype(np.int32))
        assert int(jn[0]) == int(npts[0])
        jacc = np.asarray(jax.jit(lambda r: jvg.finalize_exact_digits(r, js, leaf, leaf_z))(raw),
                          np.float32)
        jacc = jacc.reshape(4, -1)[:, :70_200]
        assert np.isfinite(jacc).all()
        np.testing.assert_array_equal(acc[0].numpy(), jacc)
        return
    jacc, jn = _jit_fast_route(pts, mask, JScene(**F2_SCENE), leaf, leaf_z)
    np.testing.assert_array_equal(acc[0, 3].numpy(), jacc[3])
    assert int(jn) == int(npts[0])
    np.testing.assert_array_equal(acc[0].numpy(), jacc)


F2_BIG_SCENE = dict(x_min=0.0, x_max=6.43, y_min=0.0, y_max=12.83, z_min=0.0, z_max=2.1)


@pytest.mark.parametrize("quant", ["fast", "exact"])
def test_f2_digit_sums_past_the_cluster_capacity(quant):
    """298,377 cells (129 x 257 x 9 at 0.05 m / 0.25 m), past K1's and K5's
    16 ranges of CTAs (232,320 cells): the kernels take their wide layout
    (32 ranges, each CTA reading every point; on the CPU their plain
    versions, not the digit sums' route, so ``plain_routes`` stays), the
    same bits as the plain digit sums finalized; fast mode matches the JAX
    package's fast-digit route under jit bit for bit, exact mode the JAX
    fast route's counts (the same integers in either mode)."""
    scene, leaf, leaf_z = TScene(**F2_BIG_SCENE), 0.05, 0.25
    nc = vgc.kernel_params(scene, leaf, leaf_z)["n_cells"]
    assert nc == 129 * 257 * 9 > vgc.max_cells() == 232_320
    assert vgc.digit_layout(nc, 1) == (32, 2)
    rng = np.random.default_rng(71)
    pts = _f2_points(rng, 4096, leaf, hi=(6.7, 13.1, 2.3))
    mask = rng.random(4096) < 0.95
    P, M = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
    routes = tvg.digit_sums_stacked.plain_routes
    acc, npts = tvg.voxel_accumulate_stacked(P, M, scene, leaf, leaf_z, quant=quant)
    assert tvg.digit_sums_stacked.plain_routes == routes
    plain = (vgc.accumulate_fast_stacked_plain if quant == "fast"
             else vgc.accumulate_exact_stacked_plain)(P, M, scene, leaf, leaf_z)
    sums, _ = tvg.digit_sums_stacked(P, M, scene, leaf, leaf_z, quant)
    fin = vgc.finalize_fast_stacked if quant == "fast" else vgc.finalize_exact_stacked
    assert torch.equal(fin(sums, scene, leaf, leaf_z).view(torch.int32),
                       plain[0].view(torch.int32))
    assert torch.equal(acc.view(torch.int32), plain[0].view(torch.int32))
    assert int(npts[0]) == int(mask.sum()) == int(plain[1][0])
    jacc, jn = _jit_fast_route(pts, mask, JScene(**F2_BIG_SCENE), leaf, leaf_z)
    assert jacc.shape == (4, nc) and int(jn) == int(npts[0])
    np.testing.assert_array_equal(acc[0, 3].numpy(), jacc[3])
    assert 0 < int(jacc[3].sum()) < int(mask.sum())
    if quant == "fast":
        np.testing.assert_array_equal(acc[0].numpy(), jacc)


# ---------------------------------------------------------------------------
# F3
# ---------------------------------------------------------------------------
def _f3_case(name):
    """(JAX config, port config, JAX env, port env) of a named F3 case."""
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, _ = bench.headline_case()
    tcfg, tenv, _ = bench_cases.headline_case()
    small = dict(n_max_points=2048, c_max_clusters=16, p_max_cluster=128, k_max_tracks=16)
    kw = dict(caps=dataclasses.replace(jcfg.caps, **small))
    kw |= {"pointlist": dict(cluster_backend="jnp", voxel_mode="dense"),
           "fine-grid": dict(voxel_leaf_size=0.03),
           "grid-jnp-cc": dict(grid_cc="jnp"),
           "headline": {}}[name]
    tkw = dict(kw, caps=TCaps(**dataclasses.asdict(kw["caps"])))
    return jcfg.replace(**kw), tcfg.replace(**tkw), jenv, tenv


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("name", ["headline", "pointlist", "fine-grid", "grid-jnp-cc"])
def test_f3_bind_keywords_refuse_what_jax_refuses(name):
    jcfg, tcfg, jenv, tenv = _f3_case(name)
    jt, tt = JTracker(jcfg), TTracker(tcfg, "cpu")
    tt.bind_env(tenv, donate_state=True)
    tt.bind_env(tenv, donate_state=False)
    got = {}
    for hoist in ("auto", "on", "batch", "off", "scan"):
        j = _raises(lambda: jt.bind_env_multi(jenv, donate_state=True, hoist=hoist))
        t = _raises(lambda: tt.bind_env_multi(tenv, donate_state=True, hoist=hoist))
        assert j == t, (name, hoist, j, t)
        got[hoist] = t
    assert got["scan"] and not got["auto"] and not got["off"]
    assert got["on"] == (name == "pointlist")
    assert got["batch"] == (name != "headline")


def test_f3_every_hoist_runs_the_same_program():
    _, tcfg, _, tenv = _f3_case("headline")
    tt = TTracker(tcfg, "cpu")
    _, _, sc = bench_cases.headline_case()
    rows = [bench_cases.padded_frame(sc, k, tcfg.caps.n_max_points) for k in range(2)]
    frames = TFrame(torch.from_numpy(np.stack([r[0] for r in rows])),
                    torch.from_numpy(np.stack([r[1] for r in rows])),
                    torch.tensor([r[2] for r in rows], dtype=torch.float32))
    outs = [tt.bind_env_multi(tenv, donate_state=False, hoist=h)(tt.init_state(), frames)[1]
            for h in ("auto", "on", "batch", "off")]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               b.view(torch.int32) if b.is_floating_point() else b)


# ---------------------------------------------------------------------------
# F4, F5
# ---------------------------------------------------------------------------
def _node_frames(n):
    from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject

    sc = Scenario(grid=bench_cases.load_sim_grid(), objects=[ScenarioObject(0.0, 0.6, 0.05, 0.0)],
                  static_points_per_frame=200, seed=5)
    return [sc.frame(k) for k in range(n)]


def _node_config(frequency=10.0):
    return TConfig(voxel_leaf_size=0.1, data_length=6, frequency=frequency,
                   caps=TCaps(n_max_points=512, m_max_voxels=256, m_max_dynamic=128,
                              c_max_clusters=8, p_max_cluster=64, k_max_tracks=4))


def test_f4_run_realtime_paces_frames_as_the_jax_node():
    assert list(inspect.signature(TrackerNode.run).parameters) == \
        list(inspect.signature(JNode.run).parameters)
    frames = _node_frames(3)
    replies = {}
    for realtime in (False, True):
        node = TrackerNode(_node_config(frequency=4.0), device="cpu")
        node.on_map(bench_cases.load_sim_grid())
        t0 = time.perf_counter()
        replies[realtime] = node.run(frames, realtime=realtime)
        elapsed = time.perf_counter() - t0
        if realtime:
            assert elapsed >= 3 * 0.25 - 1e-3
    assert [r is None for r in replies[True]] == [r is None for r in replies[False]]


def test_f5_outputs_are_kept_only_when_asked():
    assert not hasattr(JNode(JConfig()), "outputs")
    frames = _node_frames(2)
    for keep in (False, True):
        node = TrackerNode(_node_config(), device="cpu", keep_outputs=keep)
        node.on_map(bench_cases.load_sim_grid())
        node.run(frames)
        assert len(node.stats) == 2
        assert len(node.outputs) == (2 if keep else 0)


# ---------------------------------------------------------------------------
# F6
# ---------------------------------------------------------------------------
def test_f6_pallas_grid_cc_past_one_cta_matches_jax():
    """The headline scene at a 0.06 m leaf over x <= 3.5 m, y <= 12 m:
    99 x 226 = 22,374 cells with 44 stencil offsets, past one CTA's 14,208
    cells.  ``grid_cc="pallas"`` plans K2 on a cluster of CTAs (the parent
    commit raised here); the JAX package's bound is 32,768.  Perception
    from the same accumulators matches JAX's (its jnp CC on the CPU, which
    its tests pin to its fused kernel): detections within 1e-5 m,
    everything else exact."""
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, sc = bench.headline_case()
    tcfg, tenv, _ = bench_cases.headline_case()
    caps = dict(n_max_points=8192, c_max_clusters=16, p_max_cluster=128, k_max_tracks=16)
    kw = dict(voxel_leaf_size=0.06, scene=dataclasses.replace(jcfg.scene, x_max=3.5, y_max=12.0))
    jcfg = jcfg.replace(caps=dataclasses.replace(jcfg.caps, **caps), grid_cc="auto", **kw)
    tcfg = tcfg.replace(caps=dataclasses.replace(tcfg.caps, **caps), grid_cc="pallas",
                        voxel_leaf_size=0.06,
                        scene=dataclasses.replace(tcfg.scene, x_max=3.5, y_max=12.0))
    plan = tpipe.make_plan(tcfg, tenv, "cpu")
    n = plan.dims[0] * plan.dims[1] * plan.dims[2]
    n_off = len(grid_cuda.kernel_offsets(plan.dims, tcfg.cluster_tolerance, 0.06, tcfg.leaf_z))
    assert plan.k2 and n == 22_374 and j_fused_cc_fits(n)
    assert grid_cuda.cta_cells(n_off) < n and grid_cuda.cluster_size(n, n_off) > 1
    jp = jax.jit(functools.partial(j_perceive, env=jenv, config=jcfg))
    for k in range(2):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])
        buf = np.zeros((8192, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(8192, bool)
        mask[: len(sub)] = True
        acc, npts = tvg.voxel_accumulate_stacked(torch.from_numpy(buf)[None],
                                                 torch.from_numpy(mask)[None], tcfg.scene,
                                                 0.06, tcfg.leaf_z, quant=tcfg.voxel_quant)
        tp = tpipe.perceive_from_acc_stacked(acc, torch.tensor([t], dtype=torch.float32), npts,
                                             plan, config=tcfg)
        jpp = jp(jnp.asarray(acc[0].numpy().T), jnp.float32(t), jnp.int32(int(npts[0])))
        assert int(tp.n_clusters[0]) == int(jpp.n_clusters) >= 2
        for f in jpp._fields:
            a, b = np.asarray(getattr(jpp, f)), getattr(tp, f)[0].numpy()
            if f == "dets":
                np.testing.assert_allclose(b, a, rtol=0, atol=TOL_POS)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f)


# ---------------------------------------------------------------------------
# F7
# ---------------------------------------------------------------------------
def _f7_points(m, seed=7):
    """m points in six blobs (chains under 0.15 m), 90% valid."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, (6, 3)) * np.array([1, 1, 0.1])
    pts = (centres[rng.integers(0, 6, m)] + rng.normal(0, 0.06, (m, 3))).astype(np.float32)
    mask = rng.random(m) < 0.9
    return pts, mask


def test_f7_jnp_cc_at_a_ragged_m_matches_jax():
    """M = 1,000 (no multiple of 256): the port's jnp CC (K8a's plain
    adjacency + sweeps, the CPU route) against the JAX jnp CC under jit:
    the adjacency, the labels and the sweep count exactly."""
    from multiple_object_tracking_lidar_tpu.ops import cluster as jcl
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster as tcl

    pts, mask = _f7_points(1000)
    jp, jm = jnp.asarray(pts, jnp.float32), jnp.asarray(mask)
    j_adj = jax.jit(jcl._pairwise_adjacency, static_argnums=2)(jp, jm, 0.15)
    j_lab, j_it = jax.jit(jcl.connected_components, static_argnums=(2, 3, 4))(jp, jm, 0.15, 32, 4)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    np.testing.assert_array_equal(tcl._pairwise_adjacency(tp, tm, 0.15).numpy(),
                                  np.asarray(j_adj))
    t_lab, t_it = tcl.connected_components(tp, tm, 0.15, 32, 4)
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    assert int(t_it) == int(j_it)
    assert len(np.unique(np.asarray(j_lab)[mask])) >= 3


def _mock_cc_lib(monkeypatch):
    """Stand the kernel library in with one that records each entry's
    (name, M, cluster, bits scratch, frame scratch) and launches nothing."""
    from multiple_object_tracking_lidar_tpu_torch import _build

    launched = []

    class _Lib:
        def __getattr__(self, entry):
            def call(*args):
                i = 8 if entry == "motl_cc_labels" else 7  # past n_sweeps
                launched.append((entry, args[5], args[i], args[i + 1] is not None,
                                 args[i + 2] is not None))
                return 0
            return call

    monkeypatch.setattr(_build, "load", lambda: _Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: None)
    return launched


def test_f7_k8_keeps_the_jax_rule_and_k8a_takes_any_m(monkeypatch):
    """The row rule is K8's: at M = 1,000 its wrapper (and plain version)
    raise before any launch, as the JAX Pallas wrapper does, while K8a's
    wrapper goes on to its launch; past ``MAX_ROWS`` both wrappers launch
    (the frame in device memory), and past ``MAX_DEVICE_ROWS`` both raise."""
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster_pallas as tcp

    launched = _mock_cc_lib(monkeypatch)
    pts, mask = _f7_points(1000)
    tp, tm = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
    tcp.cc_adjacency(tp.to("meta"), tm.to("meta"), 0.15)
    assert [x[:2] for x in launched] == [("motl_cc_adjacency", 1000)]
    for call in (lambda: tcp.connected_components_pallas(tp.to("meta"), tm.to("meta"), 0.15),
                 lambda: tcp.connected_components_pallas(tp, tm, 0.15)):
        with pytest.raises(ValueError, match="multiple of 256"):
            call()
    assert len(launched) == 1
    for m in (tcp.MAX_ROWS + 256, tcp.MAX_DEVICE_ROWS):
        big = torch.zeros((1, m, 3), device="meta")
        tcp.cc_adjacency(big, torch.ones(big.shape[:2], dtype=torch.bool, device="meta"), 0.15)
        tcp.connected_components_pallas(big, torch.ones(big.shape[:2], dtype=torch.bool,
                                                        device="meta"), 0.15)
    assert [x[:2] for x in launched[1:]] == [("motl_cc_adjacency", tcp.MAX_ROWS + 256),
                                             ("motl_cc_labels", tcp.MAX_ROWS + 256),
                                             ("motl_cc_adjacency", tcp.MAX_DEVICE_ROWS),
                                             ("motl_cc_labels", tcp.MAX_DEVICE_ROWS)]
    big = torch.zeros((1, tcp.MAX_DEVICE_ROWS + 256, 3), device="meta")
    for wrapper in (tcp.cc_adjacency, tcp.connected_components_pallas):
        with pytest.raises(ValueError, match="rows per frame"):
            wrapper(big, torch.ones(big.shape[:2], dtype=torch.bool, device="meta"), 0.15)


@pytest.mark.parametrize("m", [4096, 8192, 8448, 65536])
def test_f7_route_past_max_rows_is_counted(monkeypatch, m):
    """Past ``MAX_ROWS`` each wrapper makes one launch, counted in its
    ``.launches``, on the largest cluster with the adjacency bits and the
    frame in device-memory scratches (the frame's sized for each CTA's p,
    sq and partials and K8's labels); up to it, ``cc_layout``'s layout and
    no frame scratch.  A meta tensor stands in for the card."""
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster_pallas as tcp

    launched = _mock_cc_lib(monkeypatch)
    pts = torch.zeros((2, m, 3), device="meta")
    mask = torch.ones((2, m), dtype=torch.bool, device="meta")
    n0 = (tcp.cc_adjacency.launches, tcp.connected_components_pallas.launches)
    tcp.cc_adjacency(pts, mask, 0.15)
    tcp.connected_components_pallas(pts, mask, 0.15)
    assert (tcp.cc_adjacency.launches, tcp.connected_components_pallas.launches) == (
        n0[0] + 1, n0[1] + 1)
    device_frame = m > tcp.MAX_ROWS
    want = ((16, True, True) if device_frame
            else (tcp.cc_layout(m)[0], not tcp.cc_layout(m)[1], False))
    assert [x[2:] for x in launched] == [want, want]
    assert tcp._layout(m, None, "meta") == (want[0], not want[1], device_frame)
    if device_frame:                    # the cluster asked for is kept; the frame stays out
        assert tcp._layout(m, 4, "meta") == (4, False, True)
