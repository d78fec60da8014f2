"""``dtype="float64"`` on the dense grid (``voxel_mode="onehot"``,
``cluster_backend="grid"``, ``voxel_quant="fast"``) against the JAX package
under the same dtype, on the CPU (tests/conftest.py turns x64 on).

- ``fma64``, the emulated f64 FMA the plain versions take where the
  double builds take ``__fma_rn``, against ``fractions.Fraction`` on random,
  cancelling and half-way triples.
- Module by module, on the headline scene's geometry at a few thousand
  points (``_case``): K1's f32 sums cast to f64 as the JAX fast route casts
  them; the finalize, the static drop and the stencil CC (the JAX f64
  route's) and K2's plain f64 version; the cluster table and the
  circumcenter (K3f's plain f64 version against the jnp
  ``circumcenter_features_table``); the track step under both filters and
  both associations on the JAX perception's f64 detections.
- The entry points: ``bind_env`` (greedy + lpf, hungarian + ihgp),
  ``bind_env_multi`` and ``bind_env_pipelined``; ``TrackerNode`` with bank
  growth and checkpoint/resume, ``StreamingNode``; the vmap fleet
  (``ShardedTracker`` on 1 x 1 meshes).
- The exact, runs and scan modes and the point list under f64 (which
  raised naming ROADMAP item 27 before they were ported) against the JAX
  ``bind_env``; tests/test_torch_f64_pointlist.py holds the rest of them.
- What raises: the kernel fleet (``kernel_path="on"``, as JAX's); no f64
  step raises for its size or engine on the card (the digit sums past
  K1's 232,320 cells, the stencil CC without K2 -- K14's double build --
  and the step past K4's narrow builds or under assoc_backend="jnp" run
  kernels there).

Integers, flags and decisions exact; detections and positions within
1e-9 m, velocities within 1e-8 m/s (the JAX package's own f64 bounds,
tests/test_grid.py:241).  The spelled FMAs make the voxel sums and the
stencil's d^2 exact; what stays apart is summation order: XLA's CPU f64
reductions (a member mean, the 39-term smoother sums) run in their own
order, the port's in ascending index.
"""

import dataclasses
import os
import random
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma, fma32, fma64
from multiple_object_tracking_lidar_tpu_torch.tracker import pipeline as tpipe
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_POS, TOL_VEL = 1e-9, 1e-8
N, C, P, K = 4096, 16, 64, 16
N_FRAMES = 6


# ---------------------------------------------------------------------------
# fma64
# ---------------------------------------------------------------------------
def _triples(kind, rng):
    n = 4000
    a = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    b = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    if kind == "random":
        c = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)
    elif kind == "cancelling":     # c = -a*b to within a few ulps: the product's low bits decide
        c = -(a * b) * (1.0 + rng.integers(-4, 5, n) * 2.0**-52)
    else:   # a * b + c = 2^54 + 2 + 4q exactly: half-way between two doubles 4 apart
        i, j = rng.integers(1, 2**20, n), rng.integers(1, 2**20, n)
        q = rng.integers(0, 1000, n)
        a = (2**27 + i).astype(np.float64)
        b = (2**27 + j).astype(np.float64)
        c = (2 + 4 * q - (i + j) * 2**27 - i * j).astype(np.float64)   # exact: |c| < 2^53
    return a, b, c


@pytest.mark.parametrize("kind", ["random", "cancelling", "halfway"])
def test_fma64_is_correctly_rounded(kind):
    """fma64(a, b, c) is a * b + c rounded once to nearest even, as
    ``Fraction`` computes it exactly (Python 3.12 has no ``math.fma``)."""
    rng = np.random.default_rng(["random", "cancelling", "halfway"].index(kind))
    a, b, c = _triples(kind, rng)
    got = fma64(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    if kind == "cancelling":       # an FMA, not a * b + c rounded twice
        assert (a * b + c != want).sum() > 100


def test_fma_takes_the_tensors_dtype():
    """``fma`` is ``fma32`` on f32 tensors and ``fma64`` on f64 ones."""
    r = random.Random(5)
    x = [torch.tensor([r.uniform(-3, 3) for _ in range(64)]) for _ in range(3)]
    assert torch.equal(fma(*x), fma32(*x)) and fma(*x).dtype == torch.float32
    x64 = [v.double() for v in x]
    assert torch.equal(fma(*x64), fma64(*x64)) and fma(*x64).dtype == torch.float64


# ---------------------------------------------------------------------------
# the modules and the entry points against JAX
# ---------------------------------------------------------------------------
def _configs(**fields):
    """(JAX config, port config) of the headline cut to N points, C slots
    of P members and K tracks, under dtype="float64" and ``fields``."""
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, sc = bench.headline_case()
    jcfg = jcfg.replace(caps=dataclasses.replace(
        jcfg.caps, n_max_points=N, c_max_clusters=C, p_max_cluster=P, k_max_tracks=K),
        data_length=10, dtype="float64", **fields)
    tcfg, tenv, _ = bench_cases.headline_case()
    tcfg = tcfg.replace(caps=Capacities(**dataclasses.asdict(jcfg.caps)), data_length=10,
                        dtype="float64", **fields)
    return jcfg, jenv, tcfg, tenv, sc


def _frames(sc, n=N_FRAMES):
    """Headline frames cut to N points (every 40th wall return, every 4th
    object point, the clutter), in f64 on both sides."""
    out = []
    for k in range(n):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:40], pts[95200:99700:4], pts[99700:]])
        buf = np.zeros((N, 3), np.float64)
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        out.append((buf, mask, np.float64(t)))
    return out


@pytest.fixture(scope="module")
def case():
    jcfg, jenv, tcfg, tenv, sc = _configs()
    return dict(jcfg=jcfg, jenv=jenv, tcfg=tcfg, tenv=tenv, frames=_frames(sc))


def _check(tag, got, ref):
    """got: FrameOutput of tensors (or numpy); ref: JAX FrameOutput of numpy."""
    v = np.asarray(ref.valid)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        if f in ("pos", "vel", "raw_centroid"):
            assert b.dtype == np.float64, (tag, f, b.dtype)
            sel = v if f != "raw_centroid" else np.ones(a.shape[:-1], bool)
            np.testing.assert_allclose(b[sel], a[sel], rtol=0,
                                       atol=TOL_VEL if f == "vel" else TOL_POS,
                                       err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


def _jax_outputs(jcfg, jenv, frames, entry="bind_env"):
    jt = JTracker(jcfg)
    js = jt.init_state()
    if entry == "bind_env":
        step = jt.bind_env(jenv, donate_state=False)
        outs = []
        for buf, mask, t in frames:
            js, o = step(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float64(t)))
            outs.append(jax.tree.map(np.asarray, o))
        return outs, js
    stacked = [np.stack([f[i] for f in frames]) for i in range(3)]
    js, o = jt.bind_env_multi(jenv, donate_state=False)(js, JFrame(*map(jnp.asarray, stacked)))
    o = jax.tree.map(np.asarray, o)
    return [type(o)(*(x[k] for x in o)) for k in range(len(frames))], js


def _tframe(fr):
    buf, mask, t = fr
    return TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t))


@pytest.fixture(scope="module")
def jax_run(case):
    return _jax_outputs(case["jcfg"], case["jenv"], case["frames"])


def test_accumulator_is_k1_cast_to_f64(case):
    """The f64 accumulator is K1's f32 sums (the JAX fast route's f32
    quantize and finalize) cast to f64, equal to the JAX jitted route on
    f64 points; the stamp stays f64."""
    from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot_cm

    tcfg = case["tcfg"]
    buf, mask, t = case["frames"][2]
    tt = TTracker(tcfg, device="cpu")
    fr = tt._frame(TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t + 1e-12)))
    assert fr.points.dtype == torch.float32 and fr.t.dtype == torch.float64
    assert float(fr.t) == t + 1e-12                          # not rounded through f32
    accs, npts = tt.accumulate(fr.points[None], fr.mask[None])
    assert accs.dtype == torch.float64
    js = JScene(**dataclasses.asdict(tcfg.scene))
    ref = jax.jit(lambda p, m: voxel_accumulate_onehot_cm(
        p, m, js, tcfg.voxel_leaf_size, tcfg.leaf_z, quant="fast"))(jnp.asarray(buf),
                                                                   jnp.asarray(mask))
    assert ref.dtype == jnp.float64
    np.testing.assert_array_equal(accs[0].numpy(), np.asarray(ref))
    assert int(npts[0]) == int(mask.sum())


def test_finalize_static_drop_and_stencil_cc_match_jax(case):
    """The JAX f64 route's finalize, static drop (on the centroid cast to
    f32) and stencil CC, and K2's plain f64 version, on the same f64
    accumulators: labels, dynamic cells and centroids exact."""
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import (
        connected_components_grid as j_ccg)
    from multiple_object_tracking_lidar_tpu.ops.static_mask import (
        get_cell_static_table, remove_static_cells as j_rsc)
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import finalize_dense_cm as j_fin
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import connected_components_grid
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import remove_static_cells
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense_cm

    jcfg, tcfg = case["jcfg"], case["tcfg"]
    tt = TTracker(tcfg, device="cpu")
    plan = tt.plan(case["tenv"])
    assert plan.k2
    frames = case["frames"][:3]
    P = torch.from_numpy(np.stack([f[0] for f in frames])).float()
    M = torch.from_numpy(np.stack([f[1] for f in frames]))
    accs, _ = tt.accumulate(P, M)
    dims, tol, leaf = plan.dims, tcfg.cluster_tolerance, tcfg.voxel_leaf_size
    jtab = get_cell_static_table(case["jenv"], jcfg.scene, leaf, *dims)
    k2 = grid_cuda.fused_finalize_static_cc_stacked(
        accs, plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits,
        dims=dims, tol=tol, leaf_xy=leaf, leaf_z=tcfg.leaf_z, kwin=plan.table.k)
    jccg = jax.jit(lambda c, d: j_ccg(c, d, dims, tol, leaf, tcfg.leaf_z, 32, 6, 2))
    for s in range(accs.shape[0]):
        jc, jocc, _ = j_fin(jnp.asarray(accs[s].numpy()))
        jdyn = j_rsc(jc, jocc, case["jenv"], jtab)
        jlab, _, jsat = jccg(jc, jdyn)
        cent, occ, _ = finalize_dense_cm(accs[s])
        dyn = remove_static_cells(cent, occ, plan.env, plan.table)
        lab, _, sat = connected_components_grid(cent, dyn, dims, tol, leaf, tcfg.leaf_z)
        np.testing.assert_array_equal(cent.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(dyn.numpy(), np.asarray(jdyn))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
        assert int(sat) == int(jsat) == 0
        np.testing.assert_array_equal(k2[0][s].numpy(), cent.numpy())
        np.testing.assert_array_equal(k2[1][s].numpy(), dyn.numpy())
        np.testing.assert_array_equal(k2[2][s].numpy(), lab.numpy())
        assert int((lab < lab.numel()).sum()) > 50


def test_cluster_table_and_circumcenter_match_jax(case):
    """The cluster table of f64 centroids (copied values: exact) and K3f's
    plain f64 version against the jnp ``circumcenter_features_table`` on
    the JAX table."""
    from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features_table
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import cluster_table_grid as j_ctg
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
        cluster_table_grid, connected_components_grid)
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import remove_static_cells
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense_cm

    tcfg = case["tcfg"]
    tt = TTracker(tcfg, device="cpu")
    plan = tt.plan(case["tenv"])
    dims = plan.dims
    active = 0
    for buf, mask, t in case["frames"][1:3]:
        accs, _ = tt.accumulate(torch.from_numpy(buf).float()[None], torch.from_numpy(mask)[None])
        cent, occ, _ = finalize_dense_cm(accs[0])
        dyn = remove_static_cells(cent, occ, plan.env, plan.table)
        lab, n_it, _ = connected_components_grid(cent, dyn, dims, tcfg.cluster_tolerance,
                                                 tcfg.voxel_leaf_size, tcfg.leaf_z)
        args = (dims[0], tcfg.min_cluster_size, tcfg.max_cluster_size, C, P)
        tab = cluster_table_grid(lab, n_it, cent, dyn, *args)
        jtab = j_ctg(jnp.asarray(lab.numpy()), jnp.asarray(n_it.numpy()),
                     jnp.asarray(cent.numpy()), jnp.asarray(dyn.numpy()), *args)
        assert tab.mpts.dtype == torch.float64
        for f in ("mpts", "member_mask", "sizes", "cluster_valid", "roots", "n_clusters"):
            np.testing.assert_array_equal(getattr(tab, f).numpy(), np.asarray(getattr(jtab, f)))
        got = centroid_cuda.circumcenter_features(tab.mpts, tab.member_mask, torch.tensor(t))
        ref = np.asarray(circumcenter_features_table(jtab.mpts, jtab.member_mask,
                                                     jnp.float64(t)))
        v = tab.cluster_valid.numpy()
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy()[v], ref[v], rtol=0, atol=TOL_POS)
        active += int(v.sum())
    assert active >= 4


@pytest.mark.parametrize("association,position_filter",
                         [("greedy", "lpf"), ("greedy", "ihgp"),
                          ("hungarian", "lpf"), ("hungarian", "ihgp")])
def test_track_step_matches_jax(case, association, position_filter):
    """The track step (K4's plain f64 version) on the JAX f64 perception's
    detections, every output and the final bank."""
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import perceive as j_perceive
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception, track_step

    fields = dict(association=association, position_filter=position_filter)
    jcfg, tcfg = case["jcfg"].replace(**fields), case["tcfg"].replace(**fields)
    jt, tt = JTracker(jcfg), TTracker(tcfg, device="cpu")
    jperc = jax.jit(lambda f: j_perceive(f, case["jenv"], config=jcfg))
    jstep = jax.jit(lambda s, p: j_track_step(s, p, config=jcfg, gains_xy=jt.gains_xy))
    js, ts = jt.init_state(), tt.init_state()
    published = 0
    for k, (buf, mask, t) in enumerate(case["frames"]):
        p = jperc(JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float64(t)))
        js, jo = jstep(js, p)
        tp = Perception(*(torch.from_numpy(np.array(x)) for x in p))
        assert tp.dets.dtype == torch.float64
        ts, to = track_step(ts, tp, config=tcfg, gains_xy=tt.gains_xy)
        _check(f"{association}/{position_filter} frame {k}", to, jax.tree.map(np.asarray, jo))
        published += int(to.valid.sum())
    assert published >= 2 * (N_FRAMES - 1)
    for f in ("window", "m0"):
        a, b = np.asarray(getattr(js.bank, f)), getattr(ts.bank, f).numpy()
        assert b.dtype == np.float64
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL_POS, err_msg=f)


@pytest.mark.parametrize("association,position_filter", [("greedy", "lpf"), ("hungarian", "ihgp")])
def test_bind_env_matches_jax(case, jax_run, association, position_filter):
    fields = dict(association=association, position_filter=position_filter)
    if fields == {"association": "greedy", "position_filter": "lpf"}:
        ref, _ = jax_run
    else:
        ref, _ = _jax_outputs(case["jcfg"].replace(**fields), case["jenv"], case["frames"])
    tt = TTracker(case["tcfg"].replace(**fields), device="cpu")
    step, st = tt.bind_env(case["tenv"]), tt.init_state()
    for k, fr in enumerate(case["frames"]):
        st, out = step(st, _tframe(fr))
        _check(f"bind_env frame {k}", out, ref[k])
    assert st.bank.window.dtype == torch.float64
    assert sum(int(r.valid.sum()) for r in ref) >= 2 * (N_FRAMES - 1)


def test_bind_env_multi_and_pipelined_match_jax(case):
    """``bind_env_multi`` (S = 3, twice) against the JAX ``bind_env_multi``
    on all 6 frames, and ``bind_env_pipelined`` (multi's program) bit for
    bit multi."""
    ref, _ = _jax_outputs(case["jcfg"], case["jenv"], case["frames"], entry="multi")
    tt = TTracker(case["tcfg"], device="cpu")
    stacked = [torch.from_numpy(np.stack([f[i] for f in case["frames"]])) for i in range(3)]
    for entry in ("bind_env_multi", "bind_env_pipelined"):
        run, st = getattr(tt, entry)(case["tenv"]), tt.init_state()
        rows = []
        for lo in (0, 3):
            st, o = run(st, TFrame(*(x[lo:lo + 3] for x in stacked)))
            rows += [type(o)(*(x[k] for x in o)) for k in range(3)]
        for k, r in enumerate(rows):
            _check(f"{entry} frame {k}", r, ref[k])


def _grid_node_configs(k_max=2):
    """(JAX, port) configs of a node on the sim map's grid: the headline
    geometry at 2,048 points, f64, a ``k_max``-slot bank that grows."""
    sys.path.insert(0, REPO)
    import bench

    jcfg = bench.headline_case()[0]
    caps = dataclasses.replace(jcfg.caps, n_max_points=2048, c_max_clusters=16,
                               p_max_cluster=64, k_max_tracks=k_max)
    jcfg = jcfg.replace(caps=caps, data_length=6, dtype="float64")
    tcfg = bench_cases.bench_config().replace(caps=Capacities(**dataclasses.asdict(caps)),
                                              data_length=6, dtype="float64")
    return jcfg, tcfg


OBJECTS = [(-1.2, 0.6, 0.05, 0.0), (0.0, 0.6, 0.0, 0.05), (1.2, 0.6, -0.05, 0.0),
           (-0.8, 3.6, 0.05, 0.0), (0.8, 3.6, 0.0, 0.05)]   # tests/test_torch_node.py's


def _node_frames(pkg, n=8):
    if pkg == "jax":
        from multiple_object_tracking_lidar_tpu.io.scenario import Scenario, ScenarioObject
        from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml

        grid = load_map_yaml(bench_cases.SIM_MAP)
    else:
        from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject

        grid = bench_cases.load_sim_grid()
    sc = Scenario(grid=grid, objects=[ScenarioObject(*o) for o in OBJECTS],
                  static_points_per_frame=300, seed=3)
    return grid, [sc.frame(k) for k in range(n)]


def test_node_growth_and_checkpoint_match_jax(tmp_path):
    """``TrackerNode`` under f64 on a two-slot bank against the JAX node:
    the same growths, every step's outputs within the tolerances, an f64
    bank; a checkpoint saved mid-way keeps the f64 bank, loads in the JAX
    ``load_state`` and resumes in a fresh node bit for bit the
    uninterrupted run."""
    from multiple_object_tracking_lidar_tpu.runtime import checkpoint as jckpt
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
    from multiple_object_tracking_lidar_tpu_torch.runtime import checkpoint as tckpt
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import node_outputs

    jcfg, tcfg = _grid_node_configs()
    jgrid, jframes = _node_frames("jax")
    tgrid, tframes = _node_frames("torch")
    ref = node_outputs(JNode(jcfg), jgrid, jframes)
    node = TrackerNode(tcfg, device="cpu", keep_outputs=True)
    node.on_map(tgrid)
    growths, path = [], str(tmp_path / "mid.npz")
    for k, msg in enumerate(tframes):
        node.on_pointcloud(msg)
        growths.append(node.n_growths)
        if k == 3:
            tckpt.save_state(path, node.state, extra=node.checkpoint_extra())
            n_mid = len(node.outputs)
    assert growths == ref["n_growths"].tolist() and growths[-1] >= 1
    assert node.config.caps.k_max_tracks == ref["k_max_tracks"][-1]
    assert len(node.outputs) == ref["publish"].shape[0]
    for k, o in enumerate(node.outputs):
        _check(f"node step {k}", o, type(o)(*(ref[f][k] for f in o._fields)))
    assert node.state.bank.window.dtype == torch.float64

    jst, _ = jckpt.load_state(path)
    st, extra = tckpt.load_state(path, device="cpu")
    assert st.bank.window.dtype == torch.float64 and np.asarray(jst.bank.window).dtype == np.float64
    np.testing.assert_array_equal(np.asarray(jst.bank.window), st.bank.window.numpy())
    fresh = TrackerNode(tcfg, device="cpu", keep_outputs=True)
    fresh.on_map(tgrid)
    fresh.resume(st, extra)
    for msg in tframes[4:]:
        fresh.on_pointcloud(msg)
    assert len(fresh.outputs) == len(node.outputs) - n_mid
    for a, b in zip(fresh.outputs, node.outputs[n_mid:]):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def test_streaming_node_publishes_what_the_node_publishes():
    """``StreamingNode`` under f64 publishes bit for bit what the f64
    ``TrackerNode`` publishes."""
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode

    _, tcfg = _grid_node_configs(k_max=16)
    grid, frames = _node_frames("torch")
    sync = TrackerNode(tcfg, device="cpu")
    sync.on_map(grid)
    want = [r for r in (sync.on_pointcloud(m) for m in frames) if r is not None]
    got = []
    node = StreamingNode(tcfg, on_outputs=lambda *recs: got.append(recs), depth=3, device="cpu")
    node.on_map(grid)
    for m in frames:
        node.submit(m)
    node.flush()
    assert len(got) == len(want) >= 6
    for (a_obs, _, _), (b_obs, _, _) in zip(got, want):
        assert [o.id for o in a_obs.obstacles] == [o.id for o in b_obs.obstacles]
        for oa, ob in zip(a_obs.obstacles, b_obs.obstacles):
            np.testing.assert_array_equal(oa.position, ob.position)
            np.testing.assert_array_equal(oa.velocity, ob.velocity)


def test_vmap_fleet_matches_jax(case):
    """``ShardedTracker`` under f64 takes the vmap fleet, as JAX's does
    (its kernel fleet is f32 only): B = 2 streams x 2 steps on 1 x 1
    meshes, f64 scatter sums (the plain K6f sums in f64), every output."""
    from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker as JSharded
    from multiple_object_tracking_lidar_tpu.parallel.sharding import make_mesh as jmesh
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

    js = JSharded(JTracker(case["jcfg"]), jmesh(1, 1))
    ts = ShardedTracker(TTracker(case["tcfg"], device="cpu"), make_mesh(1, 1, device="cpu"))
    assert not js._use_kernel_fleet and not ts._use_kernel_fleet
    jstate, tstate = js.init_state(2), ts.init_state(2)
    step = ts.bind_env(case["tenv"])
    frames = case["frames"]
    for k in range(2):
        arr = [np.stack([frames[k][i], frames[k + 3][i]]) for i in range(3)]
        jstate, jo = js.step(jstate, *(jnp.asarray(a) for a in arr), case["jenv"])
        tstate, to = step(tstate, *(torch.from_numpy(a) for a in arr))
        jo = jax.tree.map(np.asarray, jo)
        for b in range(2):
            _check(f"fleet step {k} stream {b}", type(to)(*(x[b] for x in to)),
                   type(jo)(*(x[b] for x in jo)))


def test_kernel_fleet_refuses_f64_as_jax_does(case):
    from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker as JSharded
    from multiple_object_tracking_lidar_tpu.parallel.sharding import make_mesh as jmesh
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

    with pytest.raises(ValueError, match="dtype=float32"):
        JSharded(JTracker(case["jcfg"]), jmesh(1, 1), kernel_path="on")
    with pytest.raises(ValueError, match="dtype=float32"):
        ShardedTracker(TTracker(case["tcfg"], device="cpu"), make_mesh(1, 1, device="cpu"),
                       kernel_path="on")


@pytest.mark.parametrize("fields", [
    {"voxel_quant": "exact"}, {"voxel_mode": "runs"},
    {"voxel_mode": "scan", "cluster_backend": "jnp"},
    {"voxel_mode": "dense", "cluster_backend": "pallas"},
], ids=["exact", "runs", "scan", "pointlist"])
def test_other_f64_configs_raise_naming_item_27(fields):
    """The headline's config under f64 and ``fields`` -- the exact and runs
    modes on the dense grid, the scan and the point list, which raised
    naming ROADMAP item 27 until they were ported -- constructs and
    matches the JAX ``bind_env`` (``test_torch_f64_pointlist.matches_jax``:
    integers exact, floats within 1e-12 m, 1e-9 m on the exact route)."""
    from test_torch_f64_pointlist import matches_jax

    cfg = bench_cases.bench_config().replace(dtype="float64", **fields)
    TTracker(cfg, device="cpu")
    matches_jax({f: getattr(cfg, f) for f in ("voxel_mode", "cluster_backend", "voxel_quant")})


def test_f64_track_route_and_plan_check_their_routes(case, monkeypatch):
    """No f64 step raises for its size or its engine: ``track_route`` sends
    every f64 step on the card to K4 (K4 xl past the narrow builds'
    bounds, the greedy one under ``assoc_backend="jnp"`` too) and to the
    plain version on the CPU, and ``make_plan`` plans the stencil CC (K14's
    double build) where K2 does not run -- grid_cc="jnp", a map with no
    cell table, a grid past K2's cells -- as it does in f32."""
    cfg, env = case["tcfg"], case["tenv"]
    for c in (cfg, cfg.replace(association="hungarian"), cfg.replace(assoc_backend="jnp")):
        for k, d in ((64, 32), (1025, 32), (64, 129), (2048, 256)):
            assert tpipe.track_route(c, k, d, "cuda") == "kernel"
            assert tpipe.track_route(c, k, d, "cpu") == "plain"
    assert tpipe.make_plan(cfg, env, "cpu").k2
    for c, kw in ((cfg.replace(grid_cc="jnp"), {}), (cfg, dict(cell_table=False))):
        plan = tpipe.make_plan(c, env, "cpu", **kw)
        assert not plan.k2 and plan.scal is None
    with monkeypatch.context() as m:
        m.setattr(tpipe, "fused_cc_fits", lambda *a: False)
        assert not tpipe.make_plan(cfg, env, "cpu").k2
    assert not hasattr(tpipe, "check_f64_routes") and not hasattr(tpipe, "F64_TAIL")
