"""The point-list path (``cluster_backend`` "jnp" / "pallas", the JAX
package's default ``TrackerConfig()``) of the port against the JAX package
on the CPU.

- The dense accumulator (K6 f32 mode's plain version) against
  ``voxel_accumulate``, bit for bit: out-of-bounds and masked points, points
  on leaf boundaries, one cell holding most of the points, N not a multiple
  of 2,048.  A frame with NaN and inf points is held against a numpy loop
  (each cell summed from +0.0 in ascending point index, NaN dropped): JAX
  casts floor(NaN) to int32 before its bounds test and keeps the point.
- ``voxel_finalize``, ``voxel_downsample_scan``, ``compact_points`` (with
  overflow) and ``voxel_downsample_runs`` against JAX, bit for bit, on
  NaN-free inputs; stacked calls give each frame's own result.
- ``remove_static`` against JAX, exact: the sim map, the sim map turned
  by 0.6 rad (``build_cell_static_table`` returns None for it), a coarse
  map with unknown cells, out-of-map points.
- ``circumcenter_features_sorted``: collinear clusters exact (the pick
  itself comes out), the others within 1e-5 m.
- The slice on tiny caps (5 frames): configurations C, D, E, F, G's
  field values, onehot into the point list, and a coarse 0.15 m leaf whose
  per-cell map window passes 32 bits (no cell table: the point list runs
  it, and so does the dense grid through its stencil fallback), through
  the port's ``bind_env`` and
  ``bind_env_multi`` against JAX ``Tracker.bind_env``.  Integers and
  decisions exact, positions within 1e-5 m, velocities within 1e-4 m/s
  (see test_torch_pipeline.py); the two port entry points bit for bit.
  Configuration C overflows ``m_max_dynamic``, so ``compact_points``
  truncates.

The JAX functions run under ``jax.jit``, as the pipeline runs them.
"""

import dataclasses
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.ops import centroid as jcen
from multiple_object_tracking_lidar_tpu.ops import compact as jcomp
from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm
from multiple_object_tracking_lidar_tpu.ops import voxel as jvox
from multiple_object_tracking_lidar_tpu.ops import voxel_pallas as jvp
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu.utils.pgm import MapInfo as JMapInfo
from multiple_object_tracking_lidar_tpu.utils.pgm import OccupancyGrid as JGrid
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import centroid as tcen
from multiple_object_tracking_lidar_tpu_torch.ops import compact as tcomp
from multiple_object_tracking_lidar_tpu_torch.ops import static_mask as tsm
from multiple_object_tracking_lidar_tpu_torch.ops import voxel as tvox
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_pallas as tvp
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import MapInfo as TMapInfo
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import OccupancyGrid as TGrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
LEAF, LEAF_Z = 0.1, 2.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.astype(np.float32).view(np.uint32),
                                      b.astype(np.float32).view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)


def _frame(seed, n):
    """Points around the scene, a quarter in one cell, a tenth on leaf
    boundaries, 10% masked."""
    r = np.random.default_rng(seed)
    pts = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 7, n), r.uniform(-0.5, 2.5, n)],
                   axis=1).astype(np.float32)
    q = n // 4
    pts[:q] = (np.float32([0.35, 1.25, 0.5]) + r.normal(0, 0.02, (q, 3))).astype(np.float32)
    b = slice(q, q + n // 10)
    pts[b, :2] = (np.round(pts[b, :2] / LEAF) * LEAF).astype(np.float32)
    return pts, r.random(n) < 0.9


def _jit(fn, *static):
    return jax.jit(fn, static_argnums=static)


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [5000, 8192])
def test_dense_accumulator_matches_jax_bit_for_bit(n):
    frames = [_frame(s, n) for s in (21, 22)]
    js, ts = JScene(**SCENE), TScene(**SCENE)
    stacked, npts = tvox.voxel_accumulate_stacked(
        _t(np.stack([f[0] for f in frames])), _t(np.stack([f[1] for f in frames])),
        ts, LEAF, LEAF_Z)
    for s, (pts, mask) in enumerate(frames):
        ref = _jit(jvox.voxel_accumulate, 2, 3, 4)(jnp.asarray(pts), jnp.asarray(mask), js,
                                                   LEAF, LEAF_Z)
        got = tvox.voxel_accumulate(_t(pts), _t(mask), ts, LEAF, LEAF_Z)
        _bits(got.numpy(), ref)
        _bits(stacked[s].T.numpy(), ref)
        assert int(npts[s]) == int(mask.sum())
    assert float(np.asarray(ref)[:, 3].max()) > n // 8          # the one dense cell


def test_dense_accumulator_drops_nan_and_sums_in_index_order():
    """Held against a numpy loop: each kept point added to its cell in
    ascending index from +0.0 in f32; NaN rows dropped whatever their
    other coordinates; inf and huge points out of bounds."""
    pts, mask = _frame(23, 3000)
    pts[5] = [np.nan, 1.25, 0.5]
    pts[6] = [0.35, np.nan, 0.5]
    pts[7] = [0.35, 1.25, np.inf]
    pts[8] = [-1e30, 1.25, 0.5]
    got = tvox.voxel_accumulate(_t(pts), _t(mask), TScene(**SCENE), LEAF, LEAF_Z).numpy()
    gx, gy, gz = tvox.grid_shape(TScene(**SCENE), LEAF, LEAF_Z)
    bx, by, bz = (math.floor(SCENE[k] / lf) for k, lf in (("x_min", LEAF), ("y_min", LEAF),
                                                          ("z_min", LEAF_Z)))
    want = np.zeros((gx * gy * gz, 4), np.float32)
    inv = np.float32(1.0 / LEAF), np.float32(1.0 / LEAF), np.float32(1.0 / LEAF_Z)
    for i in range(len(pts)):
        if not mask[i] or not np.isfinite(pts[i]).all():
            continue
        f = [math.floor(np.float32(pts[i, a] * inv[a])) for a in range(3)]
        ix, iy, iz = f[0] - bx, f[1] - by, f[2] - bz
        if not (0 <= ix < gx and 0 <= iy < gy and 0 <= iz < gz):
            continue
        c = ix + gx * (iy + gy * iz)
        want[c, :3] = (want[c, :3] + pts[i]).astype(np.float32)
        want[c, 3] += np.float32(1.0)
    _bits(got, want)


def test_finalize_scan_compact_and_runs_match_jax():
    js, ts = JScene(**SCENE), TScene(**SCENE)
    n, m_max = 8192, 256                       # ~600 occupied cells: finalize truncates
    frames = [_frame(s, n) for s in (31, 32)]
    P = _t(np.stack([f[0] for f in frames]))
    M = _t(np.stack([f[1] for f in frames]))
    scan_s = tvox.voxel_downsample_scan(P, M, ts, LEAF, LEAF_Z, m_max)
    runs_s = tvp.voxel_downsample_runs(P, M, ts, LEAF, LEAF_Z, m_max)
    for s, (pts, mask) in enumerate(frames):
        jp, jm = jnp.asarray(pts), jnp.asarray(mask)
        acc = _jit(jvox.voxel_accumulate, 2, 3, 4)(jp, jm, js, LEAF, LEAF_Z)
        ref = _jit(jvox.voxel_finalize, 1)(acc, m_max)
        got = tvox.voxel_finalize(_t(np.asarray(acc)), m_max)
        for g, r in zip(got, ref):
            _bits(g.numpy(), r)
        assert int(ref[2]) > m_max
        ref_scan = _jit(jvox.voxel_downsample_scan, 2, 3, 4, 5)(jp, jm, js, LEAF, LEAF_Z, m_max)
        for g, g_s, r in zip(tvox.voxel_downsample_scan(_t(pts), _t(mask), ts, LEAF, LEAF_Z, m_max),
                             scan_s, ref_scan):
            _bits(g.numpy(), r)
            _bits(g_s[s].numpy(), r)
        ref_runs = jax.jit(jvp.voxel_downsample_runs, static_argnums=(2, 3, 4, 5),
                           static_argnames="interpret")(jp, jm, js, LEAF, LEAF_Z, m_max,
                                                        interpret=True)
        for g, r in zip(runs_s, ref_runs):
            _bits(g[s].numpy(), r)
        # the dense front end equals the scan (same semantics, same order)
        dense = tvox.voxel_downsample_dense(_t(pts), _t(mask), ts, LEAF, LEAF_Z, m_max)
        assert torch.equal(dense[1], scan_s[1][s]) and int(dense[2]) == int(scan_s[2][s])
    # compact_points, with overflow: keep 300 rows of 1,000 for 256 slots
    r = np.random.default_rng(33)
    data = r.normal(0, 1, (2, 1000, 3)).astype(np.float32)
    keep = np.zeros((2, 1000), bool)
    keep[0, r.permutation(1000)[:300]] = True
    keep[1, r.permutation(1000)[:100]] = True
    got = tcomp.compact_points(_t(data), _t(keep), 256)
    for s in range(2):
        ref = _jit(jcomp.compact_points, 2)(jnp.asarray(data[s]), jnp.asarray(keep[s]), 256)
        for g, rr in zip(got, ref):
            _bits(g[s].numpy(), rr)
    assert int(got[2][0]) == 300 and int(got[1][0].sum()) == 256


def _maps():
    """(name, JAX grid, port grid): the sim map, the sim map turned by
    0.6 rad about its origin, a coarse 0.2 m map with unknown cells."""
    sim = bench_cases.load_sim_grid()
    r = np.random.default_rng(41)
    coarse = r.choice(np.array([0] * 10 + [100, -1], np.int8), size=(40, 30))
    out = []
    for name, data, info in (
        ("sim", sim.data, sim.info),
        ("yaw", sim.data, dataclasses.replace(sim.info, origin_yaw=0.6)),
        ("coarse", coarse, TMapInfo(width=30, height=40, resolution=0.2,
                                    origin_x=-2.5, origin_y=-1.5)),
    ):
        jinfo = JMapInfo(**dataclasses.asdict(info))
        out.append((name, JGrid(data=np.asarray(data), info=jinfo),
                    TGrid(data=np.asarray(data), info=info)))
    return out


@pytest.mark.parametrize("which", ["sim", "yaw", "coarse"])
def test_remove_static_matches_jax(which):
    name, jgrid, tgrid = next(m for m in _maps() if m[0] == which)
    tol = 0 if which == "coarse" else 2          # keep some free cells on the coarse map
    jenv = jsm.build_static_mask(jgrid, tol, 50)
    tenv = tsm.build_static_mask(tgrid, tol, 50)
    r = np.random.default_rng(len(which))
    pts = np.stack([r.uniform(-4, 4, 4000), r.uniform(-3, 11, 4000), r.uniform(0, 1, 4000)],
                   axis=1).astype(np.float32)                  # some outside every map
    mask = r.random(4000) < 0.95
    ref = _jit(jsm.remove_static)(jnp.asarray(pts), jnp.asarray(mask), jenv)
    got = tsm.remove_static(_t(pts), _t(mask), tenv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(mask.sum())
    if which == "yaw":      # no per-cell table: only the point-list lookup applies
        dims = tvox.grid_shape(TScene(**SCENE), LEAF, LEAF_Z)
        assert tsm.build_cell_static_table(tenv, TScene(**SCENE), LEAF, *dims) is None


def test_circumcenter_features_sorted_matches_jax():
    r = np.random.default_rng(51)
    m, c, p = 256, 8, 64
    sizes = np.array([40, 12, 64, 5, 0, 0, 30, 7], np.int32)
    valid = sizes > 0
    starts = (np.cumsum(sizes) - sizes).astype(np.int32)
    sorted_pts = np.zeros((m + p, 3), np.float32)
    for k in range(c):
        blob = r.normal([k * 0.7 - 2, 3.0, 0.4], 0.08, (sizes[k], 3))
        sorted_pts[starts[k]:starts[k] + sizes[k]] = blob
    line = np.linspace(0, 1, 30, dtype=np.float32)                 # a collinear slot
    sorted_pts[starts[6]:starts[6] + 30] = np.stack([1 + 0.5 * line, 2 + line, 0 * line], 1)
    t = np.float32(1.3)
    ref = np.asarray(_jit(jcen.circumcenter_features_sorted, 5)(
        jnp.asarray(sorted_pts), jnp.asarray(starts), jnp.asarray(sizes), jnp.asarray(valid),
        jnp.asarray(t), p))
    got = tcen.circumcenter_features_sorted(
        _t(sorted_pts)[None], _t(starts)[None], _t(sizes)[None], _t(valid)[None],
        torch.tensor([t]), p)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    _bits(got[6], ref[6])                          # collinear: the pick Pi itself
    _bits(got[:, 2:], ref[:, 2:])


# ---------------------------------------------------------------------------
# the slice on tiny caps
# ---------------------------------------------------------------------------
N, N_FRAMES = 8192, 5
TOL_DETS, TOL_VEL = 1e-5, 1e-4
TINY = dict(n_max_points=N, m_max_voxels=1024, m_max_dynamic=256, c_max_clusters=16,
            p_max_cluster=128, k_max_tracks=16)


def _frames(sc):
    frames = []
    for k in range(N_FRAMES):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])
        buf = np.zeros((N, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    return frames


SLICES = {
    # name: (bench_cases function, extra config fields, caps overrides)
    "C-pallas": ("pointlist_case", {}, {}),
    "D-jnp": ("pointlist_jnp_case", {}, {"m_max_dynamic": 512}),
    "E-scan": ("scan_case", {}, {"m_max_dynamic": 512}),
    "F-runs": ("pointlist_runs_case", {}, {"m_max_dynamic": 512}),
    "G-defaults": ("default_case", {}, {"m_max_voxels": 2048, "m_max_dynamic": 512}),
    "onehot-jnp": ("headline_case", {"cluster_backend": "jnp"}, {"m_max_dynamic": 512}),
    "coarse-no-table": ("pointlist_jnp_case", {"voxel_leaf_size": 0.15}, {"m_max_dynamic": 512}),
}


def _jax_config(tcfg):
    """The JAX TrackerConfig with the port config's field values."""
    from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
    from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig

    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["caps"] = JCaps(**dataclasses.asdict(tcfg.caps))
    kw["scene"] = JScene(**dataclasses.asdict(tcfg.scene))
    return JConfig(**kw)


def _check(tag, got, ref):
    v = ref.valid
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f).cpu().numpy()
        if f in ("pos", "vel"):
            tol = TOL_VEL if f == "vel" else TOL_DETS
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_DETS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


@pytest.mark.parametrize("name", list(SLICES))
def test_pointlist_slice_matches_jax(name):
    case, fields, caps_kw = SLICES[name]
    tcfg, tenv, sc = getattr(bench_cases, case)()
    tcfg = tcfg.replace(**fields, caps=dataclasses.replace(tcfg.caps, **{**TINY, **caps_kw}))
    frames = _frames(sc)
    jcfg = _jax_config(tcfg)
    jenv = jsm.build_static_mask(
        __import__("multiple_object_tracking_lidar_tpu.utils.pgm", fromlist=["x"]).load_map_yaml(
            bench_cases.SIM_MAP), jcfg.static_tolarance, jcfg.occupied_threshold)
    jt = JTracker(jcfg)
    jstep = jt.bind_env(jenv, donate_state=False)
    js = jt.init_state()
    jouts = []
    for buf, mask, t in frames:
        js, out = jstep(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
        jouts.append(jax.tree.map(np.asarray, out))

    tt = TTracker(tcfg, device="cpu")
    step = tt.bind_env(tenv)
    st = tt.init_state()
    singles = []
    for k, (buf, mask, t) in enumerate(frames):
        st, out = step(st, TFrame(_t(buf), _t(mask), torch.tensor(t)))
        _check(f"{name} bind_env frame {k}", out, jouts[k])
        singles.append(out)
    assert sum(int(o.valid.sum()) for o in singles) >= 2 * (N_FRAMES - 1)

    multi = tt.bind_env_multi(tenv)
    st = tt.init_state()
    for lo, hi in ((0, 3), (3, N_FRAMES)):
        fr = frames[lo:hi]
        st, outs = multi(st, TFrame(*(_t(np.stack([f[i] for f in fr])) for i in range(3))))
        for i in range(hi - lo):
            got = type(outs)(*(x[i] for x in outs))
            for f, a, b in zip(got._fields, got, singles[lo + i]):       # bit for bit
                assert torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8)), (name, f)
    if name == "C-pallas":              # more dynamic voxels than the 256 slots
        assert max(int(o.n_dynamic) for o in singles) > 256
        assert all(int(o.cc_saturated) == 0 for o in singles)
    if name == "coarse-no-table":       # the dense grid runs this map too, with no cell table
        gcfg = tcfg.replace(cluster_backend="grid", voxel_mode="onehot")
        jg = JTracker(_jax_config(gcfg))
        jgstep = jg.bind_env(jenv, donate_state=False)
        js = jg.init_state()
        tg = TTracker(gcfg, device="cpu")
        assert tg.plan(tenv).table is None and not tg.plan(tenv).k2
        gstep = tg.bind_env(tenv)
        st = tg.init_state()
        for k, (buf, mask, t) in enumerate(frames):
            js, jo = jgstep(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
            st, out = gstep(st, TFrame(_t(buf), _t(mask), torch.tensor(t)))
            _check(f"{name} grid frame {k}", out, jax.tree.map(np.asarray, jo))
