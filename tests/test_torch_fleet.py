"""The port's fleet and the modules it needs, against the JAX package on
the CPU (``device="cpu"``, tiny caps; inputs made with numpy and handed to
both sides as f32, since tests/conftest.py turns x64 on).

- K1's and K5's histograms without their finalize (the kernel fleet's
  ``accumulate_*_stacked_raw``, plain versions here) equal the JAX raw
  stacked kernels v5/v4 and v6/v3 in interpret mode, bit for bit.  Their
  finalize wrappers equal ``finalize_fast_digits`` / ``finalize_exact_digits``
  under ``jax.jit`` bit for bit: they spell the FMAs XLA's CPU code
  contracts the quantize and the finalize into.
- ``connected_components_grid`` (the stencil CC) equals JAX's, jitted:
  labels, sweep counts and the saturation flag, on a scene, a chain long
  enough to hit ``max_iters`` and a lattice at the tolerance's spacing.
- The dense grid without the K2 route -- a rotated map (no per-cell table),
  ``grid_cc="jnp"``, exact mode at a coarse leaf (K6, no table) -- through
  ``bind_env`` against JAX.
- ``ShardedTracker`` on a 1 x 1 mesh against the JAX ``ShardedTracker`` on
  ``make_mesh(1, 1)``: the kernel fleet (B = 4, two chained steps; also
  exact mode at a 0.15 m leaf, K6's sums), the vmap fleet on a point-list
  config and on the dense + grid config of
  tests/test_parallel.py.  Then the (2, 2) mesh on 4 gloo ranks: bit for bit
  the 1 x 1 run, exactly two ``all_reduce`` calls per step.
- ``merge_lidar_frames`` (and the sharded form on 2 gloo ranks),
  ``MultiplexedTracker``, and the entry points' default device.

Tolerances against JAX: integers, booleans and decisions exact;
detections and positions within 1e-5 m, velocities within 1e-4 m/s (the
reasons are test_torch_pipeline.py's); pos / vel compared where ``valid``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm
from multiple_object_tracking_lidar_tpu.ops import voxel_grid as jvg
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu.utils.pgm import MapInfo as JMapInfo
from multiple_object_tracking_lidar_tpu.utils.pgm import OccupancyGrid as JGrid
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
from multiple_object_tracking_lidar_tpu_torch.ops import static_mask as tsm
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as kv
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import connected_components_grid
from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import OccupancyGrid as TGrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_DETS, TOL_VEL = 1e-5, 1e-4
SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
TINY = dict(n_max_points=512, m_max_voxels=256, m_max_dynamic=128, c_max_clusters=8,
            p_max_cluster=32, k_max_tracks=8)


def _points(rng, n, scene, leaf):
    """Uniform points over the scene and 0.5 m past it, a quarter on leaf
    boundaries, a one-cell blob, NaN / inf / far points, masked points."""
    pts = np.stack([rng.uniform(scene["x_min"] - 0.5, scene["x_max"] + 0.5, n),
                    rng.uniform(scene["y_min"] - 0.5, scene["y_max"] + 0.5, n),
                    rng.uniform(scene["z_min"] - 0.5, scene["z_max"] + 0.5, n)], 1).astype(np.float32)
    q = n // 8
    pts[:q, :2] = (np.round(pts[:q, :2] / leaf) * leaf).astype(np.float32)
    pts[q:q + 7, 0] = np.nan
    pts[q + 7:q + 11, 2] = np.inf
    pts[q + 11] = [-999.0, 999.0, 0.0]
    pts[2 * q:3 * q] = (np.float32([0.05, 1.05, 0.5]) + rng.normal(0, 0.01, (q, 3))).astype(np.float32)
    return pts, rng.random(n) < 0.85


def _jraw(raw, nc):
    """JAX (S, C, w1, 128) raw sums -> (S, C, nc) int32."""
    raw = np.asarray(raw)
    return raw.reshape(raw.shape[0], raw.shape[1], -1)[..., :nc].astype(np.int32)


RAW = {  # JAX raw stacked kernel -> (port raw wrapper, port finalize, JAX finalize, quant)
    "v5": (jvg._accumulate_pallas_v5_stacked_raw, kv.accumulate_fast_stacked_raw,
           kv.finalize_fast_stacked, jvg.finalize_fast_digits, "fast"),
    "v4": (jvg._accumulate_pallas_v4_stacked_raw, kv.accumulate_fast_stacked_raw,
           kv.finalize_fast_stacked, jvg.finalize_fast_digits, "fast"),
    "v6": (jvg._accumulate_pallas_v6_stacked_raw, kv.accumulate_exact_stacked_raw,
           kv.finalize_exact_stacked, jvg.finalize_exact_digits, "exact"),
    "v3": (jvg._accumulate_pallas_v3_stacked_raw, kv.accumulate_exact_stacked_raw,
           kv.finalize_exact_stacked, jvg.finalize_exact_digits, "exact"),
}


@pytest.mark.parametrize("kernel", list(RAW))
def test_raw_sums_and_finalize_match_jax(kernel):
    """The plain raw wrappers equal the JAX raw stacked kernels (interpret
    mode) bit for bit, counts included; the finalize wrappers on those sums
    equal the jitted JAX finalize bit for bit (the FMAs XLA contracts it
    into).  On CPU tensors no kernel launches."""
    jraw_fn, raw_fn, fin_fn, jfin_fn, quant = RAW[kernel]
    rng = np.random.default_rng(len(kernel) + ord(kernel[1]))
    frames = [_points(rng, 2048, SCENE, 0.1) for _ in range(2)]
    pts = np.stack([f[0] for f in frames])
    mask = np.stack([f[1] for f in frames])
    js, ts = JScene(**SCENE), TScene(**SCENE)
    jraw, jn = jraw_fn(jnp.asarray(pts), jnp.asarray(mask), js, 0.1, 2.0, block=1024, interpret=True)
    launches = (raw_fn.launches, fin_fn.launches)
    raw, n = raw_fn(torch.from_numpy(pts), torch.from_numpy(mask), ts, 0.1, 2.0)
    nc = raw.shape[2]
    assert raw.dtype == torch.int32 and raw.shape == (2, 7 if quant == "exact" else 4, nc)
    np.testing.assert_array_equal(raw.numpy(), _jraw(jraw, nc))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert int(raw[:, -1].sum()) > 1000

    fin = fin_fn(raw, ts, 0.1, 2.0).numpy()
    ref_jit = np.asarray(jax.jit(lambda a: jfin_fn(a, js, 0.1, 2.0))(jraw), np.float32)
    np.testing.assert_array_equal(fin, ref_jit)
    assert (raw_fn.launches, fin_fn.launches) == launches


# ---------------------------------------------------------------------------
# the stencil CC
# ---------------------------------------------------------------------------
def _cc_case(name):
    """(cent (3, n) f32, dyn (n,) bool) on the headline grid (50 x 110 x 1)."""
    gx, gy = 50, 110
    n = gx * gy
    rng = np.random.default_rng(5)
    lin = np.arange(n)
    ix, iy = lin % gx, lin // gx
    cent = np.stack([ix * 0.1 - 2.4 + 0.05 + rng.normal(0, 0.02, n),
                     iy * 0.1 - 1.5 + 0.05 + rng.normal(0, 0.02, n),
                     np.full(n, 0.5)]).astype(np.float32)
    if name == "scene":
        dyn = rng.random(n) < 0.4
    elif name == "chain":             # a snake over every other row, 2,800 cells long
        dyn = np.zeros(n, bool)
        for y in range(0, gy, 2):
            dyn[y * gx:(y + 1) * gx] = True
            if y + 1 < gy:
                dyn[(y + 1) * gx + (gx - 1 if (y // 2) % 2 == 0 else 0)] = True
    else:                             # a lattice at the tolerance's spacing, +-1e-7 m
        cent = np.stack([ix * 0.15, iy * 0.15, np.zeros(n)]).astype(np.float32)
        cent = (cent + rng.normal(0, 1e-7, cent.shape)).astype(np.float32)
        dyn = rng.random(n) < 0.9
    return cent, dyn


@pytest.mark.parametrize("name", ["scene", "chain", "lattice"])
def test_connected_components_grid_matches_jax(name):
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import (
        connected_components_grid as jccg,
    )

    cent, dyn = _cc_case(name)
    dims = (50, 110, 1)
    # the capacities' schedule; the pointer jumps shorten a chain's
    # 2,800-cell path to a few iterations, so the chain gets max_iters = 3
    args = (dims, 0.15, 0.1, 2.0, 3 if name == "chain" else 32, 2, 2)
    jl, jn, js = (np.asarray(x) for x in jax.jit(lambda c, d: jccg(c, d, *args))(
        jnp.asarray(cent), jnp.asarray(dyn)))
    tl, tn, ts = connected_components_grid(torch.from_numpy(cent), torch.from_numpy(dyn), *args)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert (int(tn), int(ts)) == (int(jn), int(js))
    if name == "chain":
        assert int(ts) == 1 and int(tn) == 6           # cut at max_iters, flagged
    # stacked frames give each frame's own result
    other = _cc_case("scene")
    sl, sn, ss = connected_components_grid(
        torch.from_numpy(np.stack([cent, other[0]])), torch.from_numpy(np.stack([dyn, other[1]])),
        *args)
    np.testing.assert_array_equal(sl[0].numpy(), jl)
    assert (int(sn[0]), int(ss[0])) == (int(jn), int(js))


# ---------------------------------------------------------------------------
# the dense grid without K2: bind_env against JAX
# ---------------------------------------------------------------------------
def _jax_config(tcfg):
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["caps"] = JCaps(**dataclasses.asdict(tcfg.caps))
    kw["scene"] = JScene(**dataclasses.asdict(tcfg.scene))
    return JConfig(**kw)


def _maps(yaw, resolution=None):
    """(JAX grid, port grid): the sim map, turned by ``yaw`` about its
    origin and, with ``resolution``, read at that cell size."""
    sim = bench_cases.load_sim_grid()
    info = dataclasses.replace(sim.info, origin_yaw=yaw,
                               resolution=resolution or sim.info.resolution)
    return (JGrid(data=np.asarray(sim.data), info=JMapInfo(**dataclasses.asdict(info))),
            TGrid(data=np.asarray(sim.data), info=info))


def _check(tag, got, ref):
    """got: FrameOutput of tensors; ref: JAX FrameOutput of numpy."""
    v = np.asarray(ref.valid)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        if f in ("pos", "vel"):
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=TOL_VEL if f == "vel" else TOL_DETS,
                                       err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_DETS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


def _headline_frames(n, n_frames, start=0):
    """Headline frames cut to n points: every 20th wall return, every 2nd
    object point, all clutter (as test_torch_pipeline.py)."""
    sc = bench_cases.headline_case()[2]
    out = []
    for k in range(start, start + n_frames):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])[:n]
        buf = np.zeros((n, 3), np.float32)
        buf[:len(sub)] = sub
        mask = np.zeros(n, bool)
        mask[:len(sub)] = True
        out.append((buf, mask, np.float32(t)))
    return out


NO_K2 = {  # name: (config fields, map yaw)
    "rotated-map": ({}, 0.6),
    "grid_cc-jnp": ({"grid_cc": "jnp"}, 0.0),
    "coarse-exact-K6": ({"voxel_quant": "exact", "voxel_leaf_size": 0.15}, 0.0),
}


@pytest.mark.parametrize("name", list(NO_K2))
def test_dense_grid_without_k2_matches_jax(name):
    fields, yaw = NO_K2[name]
    tcfg = bench_cases.bench_config().replace(**fields)
    tcfg = tcfg.replace(caps=dataclasses.replace(
        tcfg.caps, n_max_points=8192, c_max_clusters=16, p_max_cluster=128, k_max_tracks=16))
    jgrid, tgrid = _maps(yaw)
    jcfg = _jax_config(tcfg)
    jenv = jsm.build_static_mask(jgrid, jcfg.static_tolarance, jcfg.occupied_threshold)
    tenv = tsm.build_static_mask(tgrid, tcfg.static_tolarance, tcfg.occupied_threshold)
    tt = TTracker(tcfg, device="cpu")
    plan = tt.plan(tenv)
    assert not plan.k2 and (plan.table is None) == (name != "grid_cc-jnp")
    jt = JTracker(jcfg)
    jstep = jt.bind_env(jenv, donate_state=False)
    tstep = tt.bind_env(tenv)
    js, ts = jt.init_state(), tt.init_state()
    for k, (buf, mask, t) in enumerate(_headline_frames(8192, 4)):
        js, jo = jstep(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
        ts, to = tstep(ts, TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        _check(f"{name} frame {k}", to, jax.tree.map(np.asarray, jo))
    assert int(to.n_clusters) >= 1
    if name != "grid_cc-jnp":        # an explicit K2 request cannot be honoured here
        with pytest.raises(ValueError, match="grid_cc='pallas'"):
            TTracker(tcfg.replace(grid_cc="pallas"), device="cpu").plan(tenv)


@pytest.mark.parametrize("name", ["grid", "pointlist"])
def test_step_from_voxel_acc_matches_jax(name):
    """``step_from_voxel_acc`` on the (n_cells, 4) accumulator of JAX's own
    ``voxel_accumulate`` (the entry a point-sharded deployment calls after
    summing partial accumulators), two chained frames, against JAX's."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_accumulate
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import (
        step_from_voxel_acc as jstep_from_acc,
    )
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import step_from_voxel_acc

    tcfg = bench_cases.bench_config().replace(data_length=10)
    if name == "pointlist":
        tcfg = tcfg.replace(voxel_mode="dense", cluster_backend="jnp")
    tcfg = tcfg.replace(caps=dataclasses.replace(
        tcfg.caps, n_max_points=8192, c_max_clusters=16, p_max_cluster=128, k_max_tracks=16))
    jcfg = _jax_config(tcfg)
    jgrid, tgrid = _maps(0.0)
    jenv = jsm.build_static_mask(jgrid, jcfg.static_tolarance, jcfg.occupied_threshold)
    tenv = tsm.build_static_mask(tgrid, tcfg.static_tolarance, tcfg.occupied_threshold)
    jt, tt = JTracker(jcfg), TTracker(tcfg, device="cpu")
    js, ts = jt.init_state(), tt.init_state()
    for k, (buf, mask, t) in enumerate(_headline_frames(8192, 2)):
        acc = np.array(voxel_accumulate(jnp.asarray(buf), jnp.asarray(mask), jcfg.scene,
                                          jcfg.voxel_leaf_size, jcfg.leaf_z), np.float32)
        n = int(mask.sum())
        js, jo = jstep_from_acc(js, jnp.asarray(acc), jnp.float32(t), jnp.int32(n), jenv,
                                config=jcfg, gains_xy=jt.gains_xy)
        ts, to = step_from_voxel_acc(ts, torch.from_numpy(acc), torch.tensor(t),
                                     torch.tensor(n, dtype=torch.int32), tenv, config=tcfg,
                                     gains_xy=tt.gains_xy)
        _check(f"{name} frame {k}", to, jax.tree.map(np.asarray, jo))
    assert int(to.n_clusters) >= 3 and int(to.valid.sum()) == 3


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------
def _fleet_frames(b, n, n_steps, seed=100):
    """(points (steps, B, n, 3), mask (steps, B, n), t (steps, B)): per
    stream a scenario with two moving objects on the sim map."""
    grid = bench_cases.load_sim_grid()
    pts = np.zeros((n_steps, b, n, 3), np.float32)
    mask = np.zeros((n_steps, b, n), bool)
    ts = np.zeros((n_steps, b), np.float32)
    for s in range(b):
        sc = Scenario(grid=grid, objects=[ScenarioObject(0.1 * s, 1.0, 0.0, 0.4, points_per_frame=40),
                                          ScenarioObject(0.9, 6.0, -0.3, 0.0, points_per_frame=40)],
                      static_points_per_frame=200, seed=seed + s)
        for k in range(n_steps):
            p, t = sc.frame_arrays(k)
            pts[k, s, :min(len(p), n)] = p[:n]
            mask[k, s, :min(len(p), n)] = True
            ts[k, s] = t
    return pts, mask, ts


FLEETS = {  # name: (config fields, kernel_path, map resolution)
    "kernel-fleet": ({}, "on", None),
    # exact mode past the two-digit leaf: K6 sums and an f32 all-reduce; a
    # 0.1 m map keeps the 0.15 m cell's window within the 32-bit table
    "kernel-fleet-exact-coarse": ({"voxel_quant": "exact", "voxel_leaf_size": 0.15}, "on", 0.1),
    "vmap-pointlist": ({"voxel_mode": "dense", "cluster_backend": "jnp"}, "auto", None),
    "vmap-dense-grid": ({"voxel_mode": "dense",
                         "scene": TScene(x_min=-2.6, x_max=2.6, y_min=-1.6, y_max=9.6,
                                         z_min=0.0, z_max=1.0)}, "auto", None),
}


def _fleet_config(name):
    fields = FLEETS[name][0]
    cfg = bench_cases.bench_config().replace(data_length=6, **fields)
    return cfg.replace(caps=dataclasses.replace(cfg.caps, **TINY))


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_matches_jax_sharded_tracker(name):
    """B = 4 streams, two chained steps, on 1 x 1 meshes of both packages."""
    from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker as JSharded
    from multiple_object_tracking_lidar_tpu.parallel.sharding import make_mesh as jmesh

    tcfg = _fleet_config(name)
    jcfg = _jax_config(tcfg)
    _, kpath, resolution = FLEETS[name]
    grid_j, grid_t = _maps(0.0, resolution)
    jenv = jsm.build_static_mask(grid_j, jcfg.static_tolarance, jcfg.occupied_threshold)
    tenv = tsm.build_static_mask(grid_t, tcfg.static_tolarance, tcfg.occupied_threshold)
    jst = JSharded(JTracker(jcfg), jmesh(1, 1), kernel_path=kpath)
    tst = ShardedTracker(TTracker(tcfg, device="cpu"), make_mesh(1, 1, device="cpu"),
                         kernel_path=kpath)
    assert tst._use_kernel_fleet == jst._use_kernel_fleet == name.startswith("kernel-fleet")
    b = 4
    pts, mask, ts = _fleet_frames(b, tcfg.caps.n_max_points, 2)
    jstate, tstate = jst.init_state(b), tst.init_state(b)
    step = tst.bind_env(tenv)
    for k in range(2):
        jstate, jo = jst.step(jstate, jnp.asarray(pts[k]), jnp.asarray(mask[k]),
                              jnp.asarray(ts[k]), jenv)
        jo = jax.tree.map(np.asarray, jo)
        tstate, to = step(tstate, torch.from_numpy(pts[k]), torch.from_numpy(mask[k]),
                          torch.from_numpy(ts[k]))
        for s in range(b):
            _check(f"{name} step {k} stream {s}", type(to)(*(f[s] for f in to)),
                   type(jo)(*(f[s] for f in jo)))
    assert int(to.n_clusters.min()) >= 1 and int(to.valid.sum()) >= b
    js_np = jax.tree.map(np.asarray, jstate)
    for f in ("alive", "obj_id", "birth_seq"):
        np.testing.assert_array_equal(getattr(tstate.bank, f).numpy(), getattr(js_np.bank, f))


def test_fleet_rules_match_jax():
    cfg = _fleet_config("vmap-pointlist")
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="kernel_path='on'"):
        ShardedTracker(TTracker(cfg, device="cpu"), mesh, kernel_path="on")
    with pytest.raises(ValueError, match="unknown kernel_path"):
        ShardedTracker(TTracker(cfg, device="cpu"), mesh, kernel_path="yes")
    with pytest.raises(ValueError, match="assoc_backend='pallas'"):
        ShardedTracker(TTracker(cfg.replace(assoc_backend="pallas"), device="cpu"), mesh)
    kcfg = _fleet_config("kernel-fleet")
    st = ShardedTracker(TTracker(kcfg, device="cpu"), mesh)
    assert st._use_kernel_fleet
    assert not ShardedTracker(TTracker(kcfg, device="cpu"), mesh, kernel_path="off")._use_kernel_fleet
    with pytest.raises(ValueError, match="per-cell static table"):
        st.bind_env(tsm.build_static_mask(_maps(0.6)[1], 2, 50))


FLEET_WORKER = textwrap.dedent(
    """
    import sys, datetime
    sys.path.insert(0, REPO)
    import numpy as np, torch, torch.distributed as dist
    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=90))
    import dataclasses
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask
    from multiple_object_tracking_lidar_tpu_torch.parallel.sharding import (
        ShardedTracker, local_shard, make_mesh)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    cfg = bench_cases.bench_config().replace(data_length=6)
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, **TINY))
    env = build_static_mask(bench_cases.load_sim_grid(), cfg.static_tolarance,
                            cfg.occupied_threshold)
    mesh = make_mesh(2, 2, device="cpu")
    st = ShardedTracker(Tracker(cfg, device="cpu"), mesh, kernel_path="on")
    step = st.bind_env(env)
    calls = {"all_reduce": 0, "other": 0}
    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    dist.all_reduce = counting("all_reduce", dist.all_reduce)
    for other in ("all_gather", "all_gather_into_tensor", "broadcast", "reduce",
                  "reduce_scatter_tensor", "all_to_all_single", "send", "recv"):
        setattr(dist, other, counting("other", getattr(dist, other)))
    d = np.load(inp)
    state = st.init_state(d["pts"].shape[1])
    rows = {}
    for k in range(d["pts"].shape[0]):
        before = dict(calls)
        state, o = step(state, *(torch.from_numpy(local_shard(d[f][k], mesh))
                                 for f in ("pts", "mask", "t")))
        assert calls["all_reduce"] - before["all_reduce"] == 2, calls
        assert calls["other"] == before["other"], calls
        for f, v in zip(o._fields, o):
            rows[f"{k}/{f}"] = v.numpy()
    np.savez(out, **rows)
    dist.destroy_process_group()
    print("RANK_OK", rank)
    """
)


def _run_ranks(script, n_ranks, args_of, tmp_path, timeout=120):
    """Start n_ranks interpreters on ``script``; join each within timeout."""
    head = f"REPO = {REPO!r}\nTINY = {TINY!r}\n"
    procs = [subprocess.Popen([sys.executable, "-c", head + script, *args_of(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for r in range(n_ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in o, o
    return outs


def test_space_split_on_gloo_is_bit_identical_with_two_all_reduces(tmp_path):
    """The kernel fleet on a (2, 2) mesh of 4 gloo ranks (2 streams and half
    of each cloud per rank: 256 points, padded to 512) against the 1 x 1
    fleet in this process: every output bit for bit, exactly two
    all_reduce calls and no other collective per step."""
    cfg = _fleet_config("kernel-fleet")
    b, n_steps = 4, 2
    pts, mask, ts = _fleet_frames(b, cfg.caps.n_max_points, n_steps, seed=300)
    inp = tmp_path / "in.npz"
    np.savez(inp, pts=pts, mask=mask, t=ts)
    _run_ranks(FLEET_WORKER, 4, lambda r: [str(r), str(tmp_path / "store"), str(inp),
                                            str(tmp_path / f"out{r}.npz")], tmp_path)

    env = tsm.build_static_mask(bench_cases.load_sim_grid(), cfg.static_tolarance,
                                cfg.occupied_threshold)
    st = ShardedTracker(TTracker(cfg, device="cpu"), make_mesh(1, 1, device="cpu"), kernel_path="on")
    step = st.bind_env(env)
    state = st.init_state(b)
    for k in range(n_steps):
        state, ref = step(state, torch.from_numpy(pts[k]), torch.from_numpy(mask[k]),
                          torch.from_numpy(ts[k]))
        for r in range(4):
            got = np.load(tmp_path / f"out{r}.npz")
            rows = slice(2 * (r // 2), 2 * (r // 2) + 2)      # rank r serves streams of stream rank r // 2
            for f, v in zip(ref._fields, ref):
                want = v.numpy()[rows]
                g = got[f"{k}/{f}"]
                assert g.shape == want.shape and g.dtype == want.dtype, (f, r)
                assert g.tobytes() == want.tobytes(), (k, r, f)
    assert int(ref.n_clusters.min()) >= 1


# ---------------------------------------------------------------------------
# multi-LiDAR merge
# ---------------------------------------------------------------------------
def _clouds(rng, n):
    from multiple_object_tracking_lidar_tpu_torch.parallel.multi_lidar import rigid_transform

    clouds = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    tfs = np.stack([rigid_transform([0.0, 0.0, 0.0], 0.0),
                    rigid_transform([5.0, 0.0, 0.2], np.pi / 4, 0.1, -0.2)]).astype(np.float32)
    return clouds, tfs


def test_merge_lidar_frames_matches_jax():
    from multiple_object_tracking_lidar_tpu.parallel import multi_lidar as jml
    from multiple_object_tracking_lidar_tpu_torch.parallel import multi_lidar as tml

    np.testing.assert_array_equal(jml.rigid_transform([1, 2, 3], 0.3, 0.2, 0.1),
                                  tml.rigid_transform([1, 2, 3], 0.3, 0.2, 0.1))
    clouds, tfs = _clouds(np.random.default_rng(4), 64)
    masks = np.random.default_rng(5).random((2, 64)) < 0.8
    jm, jk = jml.merge_lidar_frames(jnp.asarray(clouds), jnp.asarray(masks), jnp.asarray(tfs))
    tm, tk = tml.merge_lidar_frames(torch.from_numpy(clouds), torch.from_numpy(masks),
                                    torch.from_numpy(tfs))
    assert tm.dtype == torch.float32 and tm.shape == (128, 3)
    # f32 products summed in another order than XLA's dot: a few ulp at |p| <= 6 m
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tm[:64].numpy(), clouds[0])     # the identity moves nothing


MERGE_WORKER = textwrap.dedent(
    """
    import sys, datetime
    sys.path.insert(0, REPO)
    import numpy as np, torch, torch.distributed as dist
    from multiple_object_tracking_lidar_tpu_torch.parallel.multi_lidar import (
        merge_lidar_frames_sharded)
    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    d = np.load(inp)
    m, k = merge_lidar_frames_sharded(torch.from_numpy(d["clouds"][rank]),
                                      torch.from_numpy(d["masks"][rank]),
                                      torch.from_numpy(d["tfs"][rank]))
    np.savez(out, merged=m.numpy(), mask=k.numpy())
    dist.destroy_process_group()
    print("RANK_OK", rank)
    """
)


def test_merge_lidar_frames_sharded_on_two_gloo_ranks(tmp_path):
    from multiple_object_tracking_lidar_tpu_torch.parallel import multi_lidar as tml

    clouds, tfs = _clouds(np.random.default_rng(6), 32)
    masks = np.random.default_rng(7).random((2, 32)) < 0.7
    np.savez(tmp_path / "in.npz", clouds=clouds, masks=masks, tfs=tfs)
    _run_ranks(MERGE_WORKER, 2, lambda r: [str(r), str(tmp_path / "store"), str(tmp_path / "in.npz"),
                                            str(tmp_path / f"out{r}.npz")], tmp_path)
    want, want_mask = tml.merge_lidar_frames(torch.from_numpy(clouds), torch.from_numpy(masks),
                                             torch.from_numpy(tfs))
    for r in range(2):
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(got["merged"], want.numpy())
        np.testing.assert_array_equal(got["mask"], want_mask.numpy())


# ---------------------------------------------------------------------------
# MultiplexedTracker and the default device
# ---------------------------------------------------------------------------
def test_multiplexed_tracker_equals_per_stream_bind_env():
    from multiple_object_tracking_lidar_tpu_torch.runtime.fleet import MultiplexedTracker

    cfg = _fleet_config("kernel-fleet")
    env = tsm.build_static_mask(bench_cases.load_sim_grid(), cfg.static_tolarance,
                                cfg.occupied_threshold)
    tr = TTracker(cfg, device="cpu")
    b, n_steps = 3, 3
    pts, mask, ts = _fleet_frames(b, cfg.caps.n_max_points, n_steps, seed=40)
    mux = MultiplexedTracker(tr, env, b)
    assert mux.n_streams == b and not bool(mux.state(0).initialized)
    got = [[None] * n_steps for _ in range(b)]
    for k in range(n_steps):
        for s in range(b):     # round robin
            got[s][k] = mux.step(s, TFrame(*(torch.tensor(a[k][s]) for a in (pts, mask, ts))))
    for s in range(b):
        step = tr.bind_env(env)
        st = tr.init_state()
        for k in range(n_steps):
            st, want = step(st, TFrame(*(torch.tensor(a[k][s]) for a in (pts, mask, ts))))
            for f, x, y in zip(want._fields, got[s][k], want):
                assert x.numpy().tobytes() == y.numpy().tobytes(), (s, k, f)
        assert torch.equal(mux.state(s).bank.obj_id, st.bank.obj_id)
    assert int(mux.state(1).next_obj_num) >= 1
    mux.reset_stream(1)
    assert int(mux.state(1).next_obj_num) == 0 and int(mux.state(0).next_obj_num) >= 1


def test_entry_points_default_to_the_card_and_raise_without_one():
    """Without a CUDA device every entry point raises unless the caller
    asks for the CPU; none falls back quietly."""
    from multiple_object_tracking_lidar_tpu_torch.runtime.fleet import MultiplexedTracker
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = _fleet_config("kernel-fleet")
    for make in (lambda: TTracker(cfg), lambda: TrackerNode(cfg), lambda: StreamingNode(cfg),
                 lambda: make_mesh(1, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    tr = TTracker(cfg, device="cpu")
    assert tr.device.type == "cpu"
    env = tsm.build_static_mask(bench_cases.load_sim_grid(), 2, 50)
    assert MultiplexedTracker(tr, env, 1, warm=False).tracker.device.type == "cpu"
    assert ShardedTracker(tr, make_mesh(1, 1, device="cpu")).tracker.device.type == "cpu"
