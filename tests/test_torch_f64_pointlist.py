"""``dtype="float64"`` off the dense grid's fast digits -- the point list
(the JAX package's default ``TrackerConfig(dtype="float64")``), the exact,
runs and scan modes -- against the JAX package under the same dtype, on the
CPU (tests/conftest.py turns x64 on).  The JAX functions run under
``jax.jit``, as the pipeline runs them.

Module by module, on f64 points whose low bits lie below f32's (so a route
that rounds them through f32 shows):

- K6f's plain f64 sums (``voxel_accumulate_stacked`` on f64 points) bit for
  bit the JAX f64 scatter-add, and the f64 finalize;
- the exact route under f64: K6f's f64 sums against the JAX f64 one-hot
  contraction (voxel_grid.py:242-254), whose order is XLA's
  ``dot_general``: within 1e-12 relative on the sums, counts exact;
- the scan (f64 torch, the same ops) and the runs' voxel list (K7 in f32,
  the f64 division) bit for bit;
- the runs' dense grid: K7's f32 accumulator finalized in f32, widened,
  then the stencil CC in f64 -- K2's plain version fed f32 sums against
  the JAX route's finalize, static drop and stencil CC;
- K8a's plain f64 adjacency bit for bit the jitted JAX f64
  ``_pairwise_adjacency`` on a lattice whose pairs sit within 1e-13 m of
  the tolerance (the same spelling as f32: the 32-row tree sum, the FMA
  chains; the f64 ``tol * tol``), the jnp CC's labels and sweeps on it, and
  the Pallas CC on f64 points (rounded to f32, as JAX's);
- every (voxel_mode, cluster_backend, voxel_quant) combination that
  ``test_torch_f64.py`` does not already run through ``bind_env`` against
  the JAX ``bind_env`` (integers exact, floats within 1e-12 m and 1e-11
  m/s where the summation order is the same, ``TOL_F64`` on the exact
  route), and the f64 points reaching the routes that sum them.

Integers, labels and flags exact throughout.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.ops import cluster as jcl
from multiple_object_tracking_lidar_tpu.ops import voxel as jvox
from multiple_object_tracking_lidar_tpu.ops import voxel_pallas as jvp
from multiple_object_tracking_lidar_tpu.ops.cluster_pallas import (
    connected_components_pallas as j_cc_pallas,
)
from multiple_object_tracking_lidar_tpu.ops.static_mask import build_static_mask
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import cluster as tcl
from multiple_object_tracking_lidar_tpu_torch.ops import cluster_pallas as tcp
from multiple_object_tracking_lidar_tpu_torch.ops import voxel as tvox
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_pallas as tvp
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import voxel_accumulate_stacked
from multiple_object_tracking_lidar_tpu_torch.tracker import pipeline as tpipe
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import one_intra_op_thread  # noqa: E402, F401  (a fixture)

SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
LEAF, LEAF_Z = 0.1, 2.0
TOL_SAME = (1e-12, 1e-11)     # m, m/s: the same summation order on both sides
TOL_F64 = (1e-9, 1e-8)        # m, m/s: the exact route (XLA's dot order)
EXACT_REL = 1e-12             # the exact route's sums, relative to the cell's |sum| + count


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    """Equal values (NaN where NaN), shapes and float dtypes (JAX's x64
    counts are int64 where the port's are int32)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype or a.dtype.kind in "iub", (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _frame64(seed, n):
    """f64 points around the scene with noise below f32's resolution, a
    quarter in one cell, a tenth on leaf boundaries, 10% masked."""
    r = np.random.default_rng(seed)
    pts = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 7, n), r.uniform(-0.5, 2.5, n)], axis=1)
    q = n // 4
    pts[:q] = np.array([0.35, 1.25, 0.5]) + r.normal(0, 0.02, (q, 3))
    b = slice(q, q + n // 10)
    pts[b, :2] = np.round(pts[b, :2] / LEAF) * LEAF + r.normal(0, 1e-11, (n // 10, 2))
    pts += r.normal(0, 1e-10, pts.shape)
    assert (pts.astype(np.float32).astype(np.float64) != pts).mean() > 0.9
    return pts, r.random(n) < 0.9


def _jit(fn, *static, **kw):
    return jax.jit(fn, static_argnums=static, **kw)


# ---------------------------------------------------------------------------
# voxel front ends
# ---------------------------------------------------------------------------
def test_k6f_plain_f64_sums_and_finalize_match_jax_bit_for_bit():
    """K6f's plain f64 sums (the scatter-add's order) on two stacked f64
    frames, equal to the jitted JAX f64 ``voxel_accumulate``, and the f64
    finalize equal to JAX's."""
    js, ts = JScene(**SCENE), TScene(**SCENE)
    frames = [_frame64(s, 6000) for s in (41, 42)]
    accs, npts = tvox.voxel_accumulate_stacked(_t(np.stack([f[0] for f in frames])),
                                               _t(np.stack([f[1] for f in frames])),
                                               ts, LEAF, LEAF_Z)
    assert accs.dtype == torch.float64
    for s, (pts, mask) in enumerate(frames):
        ref = _jit(jvox.voxel_accumulate, 2, 3, 4)(jnp.asarray(pts), jnp.asarray(mask), js,
                                                   LEAF, LEAF_Z)
        _same(accs[s].T.numpy(), ref)
        assert int(npts[s]) == int(mask.sum())
        jfin = _jit(jvox.voxel_finalize, 1)(ref, 256)
        for g, r in zip(tvox.voxel_finalize(accs[s].T, 256), jfin):
            _same(g.numpy(), r)
    assert float(np.asarray(ref)[:, 3].max()) > 1000           # the one dense cell


def test_exact_route_sums_f64_within_its_tolerance():
    """``voxel_quant="exact"`` under f64: K6f's f64 sums (ascending point
    index) against the JAX f64 one-hot contraction (XLA's ``dot_general``
    order): counts exact, sums within 1e-12 relative; and not K5's digits
    (which would be off by ~1e-7 m per point)."""
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot_cm

    js, ts = JScene(**SCENE), TScene(**SCENE)
    pts, mask = _frame64(43, 4096)
    ref = np.asarray(_jit(lambda p, m: voxel_accumulate_onehot_cm(
        p, m, js, LEAF, LEAF_Z, quant="exact"))(jnp.asarray(pts), jnp.asarray(mask)))
    got, npts = voxel_accumulate_stacked(_t(pts)[None], _t(mask)[None], ts, LEAF, LEAF_Z,
                                         quant="exact")
    got = got[0].numpy()
    assert got.dtype == ref.dtype == np.float64 and int(npts[0]) == int(mask.sum())
    np.testing.assert_array_equal(got[3], ref[3])
    scale = np.abs(ref[:3]) + ref[3]
    assert (np.abs(got[:3] - ref[:3]) <= EXACT_REL * scale).all()
    digits, _ = voxel_accumulate_stacked(_t(pts)[None].float(), _t(mask)[None], ts, LEAF,
                                         LEAF_Z, quant="exact")
    assert np.abs(digits[0].double().numpy()[:3] - ref[:3]).max() > 1e-6


def test_scan_and_runs_voxel_lists_match_jax_in_f64():
    """The scan (f64 sums, the same ops) and the runs' voxel list (K7's f32
    totals over f64 counts) bit for bit the jitted JAX routes on f64
    points, stacked and single-frame."""
    js, ts = JScene(**SCENE), TScene(**SCENE)
    m_max = 256
    frames = [_frame64(s, 8192) for s in (44, 45)]
    P, M = _t(np.stack([f[0] for f in frames])), _t(np.stack([f[1] for f in frames]))
    scan_s = tvox.voxel_downsample_scan(P, M, ts, LEAF, LEAF_Z, m_max)
    runs_s = tvp.voxel_downsample_runs(P, M, ts, LEAF, LEAF_Z, m_max)
    assert scan_s[0].dtype == runs_s[0].dtype == torch.float64
    for s, (pts, mask) in enumerate(frames):
        jp, jm = jnp.asarray(pts), jnp.asarray(mask)
        ref_scan = _jit(jvox.voxel_downsample_scan, 2, 3, 4, 5)(jp, jm, js, LEAF, LEAF_Z, m_max)
        for g, r in zip(scan_s, ref_scan):
            _same(g[s].numpy(), r)
        ref_runs = _jit(jvp.voxel_downsample_runs, 2, 3, 4, 5, static_argnames="interpret")(
            jp, jm, js, LEAF, LEAF_Z, m_max, interpret=True)
        for g, r in zip(runs_s, ref_runs):
            _same(g[s].numpy(), r)
        one = tvox.voxel_downsample_scan(_t(pts), _t(mask), ts, LEAF, LEAF_Z, m_max)
        assert all(torch.equal(a, b[s]) for a, b in zip(one, scan_s))
        # the runs' totals are the f32 points' sums: not the scan's f64 ones
        assert not torch.equal(runs_s[0][s], scan_s[0][s])


def test_runs_dense_grid_finalizes_in_f32_then_widens():
    """``voxel_mode="runs"`` on the dense grid under f64: K7's f32
    accumulator, K2's plain version fed f32 sums (``dtype=torch.float64``)
    against the JAX route (finalize_dense_cm in f32, remove_static_cells,
    the centroid cast to f64, the stencil CC in f64): centroids, dynamic
    cells and labels exact; and different from dividing the f32 sums in
    f64."""
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import (
        connected_components_grid as j_ccg)
    from multiple_object_tracking_lidar_tpu.ops.static_mask import (
        get_cell_static_table, remove_static_cells as j_rsc)
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import finalize_dense_cm as j_fin
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda

    cfg, env, sc = bench_cases.headline_case()
    cfg = cfg.replace(voxel_mode="runs", dtype="float64")
    tt = TTracker(cfg, device="cpu")
    plan = tt.plan(env)
    assert plan.k2
    pts, t = sc.frame_arrays(2)
    sub = pts[::8].astype(np.float64)
    pts, mask = np.zeros((16384, 3)), np.zeros(16384, bool)     # K7 takes N % 8,192 == 0
    pts[: len(sub)] = sub + np.random.default_rng(46).normal(0, 1e-10, sub.shape)
    mask[: len(sub)] = True
    accs, _ = tt.accumulate(_t(pts)[None], _t(mask)[None])
    assert accs.dtype == torch.float32
    dims, tol, leaf = plan.dims, cfg.cluster_tolerance, cfg.voxel_leaf_size
    kw = dict(dims=dims, tol=tol, leaf_xy=leaf, leaf_z=cfg.leaf_z, kwin=plan.table.k)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    cent, dyn, lab, _, sat = grid_cuda.fused_finalize_static_cc_stacked(
        accs, *tb, dtype=torch.float64, **kw)
    jenv = build_static_mask(load_map_yaml(bench_cases.SIM_MAP), cfg.static_tolarance,
                             cfg.occupied_threshold)
    jtab = get_cell_static_table(jenv, _jscene(cfg), leaf, *dims)
    jc, jocc, _ = j_fin(jnp.asarray(accs[0].numpy()))
    jdyn = j_rsc(jc, jocc, jenv, jtab)
    jlab, _, jsat = _jit(lambda c, d: j_ccg(c, d, dims, tol, leaf, cfg.leaf_z, 32, 6, 2))(
        jc.astype(jnp.float64), jdyn)
    assert cent.dtype == torch.float64
    _same(cent[0].numpy(), np.asarray(jc).astype(np.float64))
    _same(dyn[0].numpy(), np.asarray(jdyn))
    _same(lab[0].numpy(), np.asarray(jlab))
    assert int(sat[0]) == int(jsat) == 0 and int((lab[0] < lab.shape[1]).sum()) > 50
    wide = grid_cuda.fused_finalize_static_cc_stacked(accs.double(), *tb, **kw)[0]
    assert not torch.equal(wide, cent)                          # f64 division: other bits


def _jscene(cfg):
    return JScene(**dataclasses.asdict(cfg.scene))


# ---------------------------------------------------------------------------
# the point-list CC
# ---------------------------------------------------------------------------
def _lattice64(m, seed, noise=1e-13):
    """A 64 x 64 lattice at the 0.15 m tolerance's spacing in f64, noise
    far below f32's: d2 of thousands of pairs within an ulp of tol^2."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(64), np.arange(64), indexing="ij"), -1).reshape(-1, 2)[:m]
    pts = np.zeros((m, 3))
    pts[:, :2] = g * 0.15 + np.array([-2.0, 1.0])
    pts[:, 2] = 0.5
    pts += rng.normal(0, noise, pts.shape)
    return pts, rng.random(m) < 0.9


@pytest.mark.parametrize("m", [256, 2048])
def test_k8a_plain_f64_adjacency_matches_jax_bit_for_bit(m):
    """K8a's plain f64 adjacency (the f64 spelling of K8a's double build)
    against the jitted JAX f64 ``_pairwise_adjacency`` on the lattice:
    every pair, boundary pairs included; the f32 route on the same points
    would flip some."""
    pts, mask = _lattice64(m, m)
    ref = np.asarray(_jit(jcl._pairwise_adjacency, 2)(jnp.asarray(pts), jnp.asarray(mask), 0.15))
    got = tcl._pairwise_adjacency(_t(pts), _t(mask), 0.15)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > m                                        # the lattice edges are in
    f32 = tcl._pairwise_adjacency(_t(pts).float(), _t(mask), 0.15).numpy()
    assert (f32 != ref).any()


def test_jnp_and_pallas_cc_under_f64_match_jax():
    """The jnp CC on f64 points (K8a's f64 adjacency, then the sweeps):
    labels and sweeps equal the jitted JAX CC; the Pallas CC on f64 points
    equals the JAX kernel in interpret mode, which rounds them to f32."""
    pts, mask = _lattice64(1024, 7, noise=1e-3)
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    lab, it = _jit(jcl.connected_components, 2, 3, 4)(jp, jm, 0.15, 32, 4)
    got, n_it = tcl.connected_components(_t(pts), _t(mask), 0.15, 32, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lab))
    assert int(n_it) == int(it) and len(np.unique(np.asarray(lab))) > 2
    ref = np.asarray(j_cc_pallas(jp, jm, 0.15, interpret=True))
    got = tcp.connected_components_pallas(_t(pts), _t(mask), 0.15)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_k8a_layout_counts_eight_byte_rows():
    """In double a frame's p, sq and partials take 32 B a row: the frame
    stays in shared memory up to 4,096 rows (8,192 in f32), past which it
    moves to device memory; G's M = 2,048 stays in shared memory."""
    f64 = torch.float64
    assert tcp.max_rows(f64) == 4096 and tcp.max_rows() == 8192
    assert tcp._layout(2048, None, "cpu", f64)[2] is False
    assert tcp._layout(4096, None, "cpu", f64)[2] is False
    assert tcp._layout(4097, None, "cpu", f64)[2] is True
    assert tcp._layout(4097, None, "cpu")[2] is False
    with pytest.raises(ValueError, match="4096"):
        tcp.cc_layout(4097, None, f64)
    for m in (256, 1024, 2048, 4096):
        c, in_smem = tcp.cc_layout(m, None, f64)
        assert tcp.fits_smem(m, c, f64) == in_smem
        assert tcp.fits_smem(m, c) or not in_smem              # f64 needs more room than f32


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
N = 8192
TINY = dict(n_max_points=N, m_max_voxels=1024, m_max_dynamic=512, c_max_clusters=16,
            p_max_cluster=128, k_max_tracks=16)


def _frames64(sc, n_frames):
    """Headline frames cut to N points (every 20th wall return, every 2nd
    object point, the clutter) in f64 with noise below f32's resolution."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(n_frames):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]]).astype(np.float64)
        sub += rng.normal(0, 1e-9, sub.shape)
        buf = np.zeros((N, 3))
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        out.append((buf, mask, np.float64(t)))
    return out


def f64_configs(fields, caps=None):
    """(JAX config, port config, port env, scenario) of configuration D's
    case (the sim map, 0.1 m leaf) at ``TINY`` capacities (or ``caps``)
    under dtype="float64" and ``fields``."""
    tcfg, tenv, sc = bench_cases.pointlist_jnp_case()
    tcfg = tcfg.replace(dtype="float64", **fields,
                        caps=dataclasses.replace(tcfg.caps, **(caps or TINY)))
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["caps"] = JCaps(**dataclasses.asdict(tcfg.caps))
    kw["scene"] = _jscene(tcfg)
    return JConfig(**kw), tcfg, tenv, sc


def matches_jax(fields, n_frames=2, caps=None):
    """``bind_env`` of the port on the CPU against the JAX ``bind_env`` under
    f64 and ``fields``, on ``n_frames`` f64 frames: integers exact, floats
    within ``TOL_SAME`` (``TOL_F64`` on the exact route), every float
    output f64.  Returns the port's outputs."""
    jcfg, tcfg, tenv, sc = f64_configs(fields, caps)
    jenv = build_static_mask(load_map_yaml(bench_cases.SIM_MAP), jcfg.static_tolarance,
                             jcfg.occupied_threshold)
    tol_pos, tol_vel = TOL_F64 if tcfg.voxel_quant == "exact" and tcfg.voxel_mode == "onehot" \
        else TOL_SAME
    jt = JTracker(jcfg)
    jstep, js = jt.bind_env(jenv, donate_state=False), jt.init_state()
    tt = TTracker(tcfg, device="cpu")
    step, st = tt.bind_env(tenv), tt.init_state()
    outs = []
    for k, (buf, mask, t) in enumerate(_frames64(sc, n_frames)):
        js, jo = jstep(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float64(t)))
        jo = jax.tree.map(np.asarray, jo)
        st, to = step(st, TFrame(_t(buf), _t(mask), torch.tensor(t)))
        for f in jo._fields:
            a, b = getattr(jo, f), getattr(to, f).numpy()
            if f in ("pos", "vel", "raw_centroid"):
                assert b.dtype == np.float64, (fields, f)
                sel = jo.valid if f != "raw_centroid" else np.ones(a.shape[:-1], bool)
                np.testing.assert_allclose(b[sel], a[sel], rtol=0,
                                           atol=tol_vel if f == "vel" else tol_pos,
                                           err_msg=f"{fields} frame {k} {f}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{fields} frame {k} {f}")
        outs.append(to)
    assert int(outs[-1].n_clusters) >= 3
    return outs


COMBOS = {   # what test_torch_f64.py does not run: the rest of TrackerConfig's combinations
    "dense-jnp": {"voxel_mode": "dense", "cluster_backend": "jnp"},
    "onehot-fast-jnp": {"voxel_mode": "onehot", "cluster_backend": "jnp"},
    "onehot-exact-jnp": {"voxel_mode": "onehot", "cluster_backend": "jnp",
                         "voxel_quant": "exact"},
    "runs-jnp": {"voxel_mode": "runs", "cluster_backend": "jnp"},
    "onehot-fast-pallas": {"voxel_mode": "onehot", "cluster_backend": "pallas"},
    "onehot-exact-pallas": {"voxel_mode": "onehot", "cluster_backend": "pallas",
                            "voxel_quant": "exact"},
    "scan-pallas": {"voxel_mode": "scan", "cluster_backend": "pallas"},
    "dense-grid": {"voxel_mode": "dense", "cluster_backend": "grid"},
}


@pytest.mark.parametrize("name", list(COMBOS))
def test_f64_combination_matches_jax(name):
    matches_jax(COMBOS[name])


def test_f64_points_reach_the_routes_that_sum_them():
    """``Tracker._frame`` keeps f64 points where the route sums them (the
    JAX package casts every frame to the compute dtype): on the point list's
    scatter sums, the same frames rounded to f32 first give other
    centroids; on the fast digits the points go in f32 (the same bits)."""
    fields = COMBOS["dense-jnp"]
    outs = matches_jax(fields, n_frames=1)
    jcfg, tcfg, tenv, sc = f64_configs(fields)
    assert tpipe.points_dtype(tcfg) == torch.float64
    assert tpipe.points_dtype(tcfg.replace(voxel_mode="onehot")) == torch.float32
    assert tpipe.points_dtype(tcfg.replace(dtype="float32")) == torch.float32
    buf, mask, t = _frames64(sc, 1)[0]
    tt = TTracker(tcfg, device="cpu")
    _, rounded = tt.bind_env(tenv)(tt.init_state(), TFrame(
        _t(buf.astype(np.float32).astype(np.float64)), _t(mask), torch.tensor(t)))
    assert not torch.equal(rounded.raw_centroid, outs[0].raw_centroid)
    fr = tt._frame(TFrame(_t(buf), _t(mask), torch.tensor(t)))
    assert fr.points.dtype == torch.float64 and torch.equal(fr.points, _t(buf))


def test_f64_default_config_runs_multi_and_node_as_bind_env():
    """``TrackerConfig(dtype="float64")`` (G) at small capacities:
    ``bind_env_multi`` (S = 2) and ``bind_env_pipelined`` give
    ``bind_env``'s outputs bit for bit, and ``check_config`` takes every
    f64 combination."""
    jcfg, tcfg, tenv, sc = f64_configs({}, caps=dict(TINY, m_max_voxels=2048))
    from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig

    assert (tcfg.voxel_mode, tcfg.cluster_backend) == (TrackerConfig().voxel_mode,
                                                       TrackerConfig().cluster_backend)
    singles = matches_jax({}, n_frames=2, caps=dict(TINY, m_max_voxels=2048))
    frames = _frames64(sc, 2)
    tt = TTracker(tcfg, device="cpu")
    stacked = TFrame(*(_t(np.stack([f[i] for f in frames])) for i in range(3)))
    for entry in ("bind_env_multi", "bind_env_pipelined"):
        _, o = getattr(tt, entry)(tenv)(tt.init_state(), stacked)
        for k in range(2):
            for f, a, b in zip(o._fields, o, singles[k]):
                assert torch.equal(a[k], b), (entry, k, f)
    for vm in ("dense", "runs", "scan", "onehot"):
        for cb in ("jnp", "pallas", "grid"):
            if cb == "grid" and vm == "scan":
                continue
            tpipe.check_config(tcfg.replace(voxel_mode=vm, cluster_backend=cb))


@pytest.mark.usefixtures("one_intra_op_thread")
def test_f64_pointlist_node_growth_checkpoint_and_stream_match_jax(tmp_path):
    """``TrackerNode`` on the point list (``voxel_mode="dense"``, the jnp
    CC) under f64 with a two-slot bank against the JAX node: the same
    growths, every step's outputs within the tolerances; a checkpoint saved
    mid-way resumes bit for bit; ``StreamingNode`` publishes what the node
    publishes."""
    from test_torch_f64 import REPO, _check, _grid_node_configs, _node_frames

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
    from multiple_object_tracking_lidar_tpu_torch.runtime import checkpoint as tckpt
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode
    from make_torch_golden import node_outputs

    fields = dict(voxel_mode="dense", cluster_backend="jnp")
    jcfg, tcfg = (c.replace(**fields) for c in _grid_node_configs())
    jgrid, jframes = _node_frames("jax")
    tgrid, tframes = _node_frames("torch")
    ref = node_outputs(JNode(jcfg), jgrid, jframes)
    node = TrackerNode(tcfg, device="cpu", keep_outputs=True)
    node.on_map(tgrid)
    growths, path, replies = [], str(tmp_path / "mid.npz"), []
    for k, msg in enumerate(tframes):
        replies.append(node.on_pointcloud(msg))
        growths.append(node.n_growths)
        if k == 3:
            tckpt.save_state(path, node.state, extra=node.checkpoint_extra())
            n_mid = len(node.outputs)
    assert growths == ref["n_growths"].tolist() and growths[-1] >= 1
    assert len(node.outputs) == ref["publish"].shape[0]
    for k, o in enumerate(node.outputs):
        _check(f"point-list node step {k}", o, type(o)(*(ref[f][k] for f in o._fields)))
    st, extra = tckpt.load_state(path, device="cpu")
    assert st.bank.window.dtype == torch.float64
    fresh = TrackerNode(tcfg, device="cpu", keep_outputs=True)
    fresh.on_map(tgrid)
    fresh.resume(st, extra)
    for msg in tframes[4:]:
        fresh.on_pointcloud(msg)
    for a, b in zip(fresh.outputs, node.outputs[n_mid:]):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    # StreamingNode on a bank that does not grow, against the node's replies
    big = tcfg.replace(caps=dataclasses.replace(tcfg.caps, k_max_tracks=16))
    sync = TrackerNode(big, device="cpu")
    sync.on_map(tgrid)
    want = [r for r in (sync.on_pointcloud(m) for m in tframes) if r is not None]
    got = []
    stream = StreamingNode(big, on_outputs=lambda *recs: got.append(recs), depth=3, device="cpu")
    stream.on_map(tgrid)
    for m in tframes:
        stream.submit(m)
    stream.flush()
    assert len(got) == len(want) >= 6
    for (a_obs, _, _), (b_obs, _, _) in zip(got, want):
        assert [o.id for o in a_obs.obstacles] == [o.id for o in b_obs.obstacles]
        for oa, ob in zip(a_obs.obstacles, b_obs.obstacles):
            np.testing.assert_array_equal(oa.position, ob.position)


def test_f64_pointlist_vmap_fleet_matches_jax():
    """``ShardedTracker`` under f64 on the point list (the vmap fleet, as
    JAX's: its kernel fleet is f32 and grid only): B = 2 streams x 2 steps
    on 1 x 1 meshes, the f64 scatter sums (K6f's plain f64 version), every
    output."""
    from test_torch_f64 import _check

    from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker as JSharded
    from multiple_object_tracking_lidar_tpu.parallel.sharding import make_mesh as jmesh
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

    jcfg, tcfg, tenv, sc = f64_configs(COMBOS["dense-jnp"])
    jenv = build_static_mask(load_map_yaml(bench_cases.SIM_MAP), jcfg.static_tolarance,
                             jcfg.occupied_threshold)
    js = JSharded(JTracker(jcfg), jmesh(1, 1))
    ts = ShardedTracker(TTracker(tcfg, device="cpu"), make_mesh(1, 1, device="cpu"))
    assert not js._use_kernel_fleet and not ts._use_kernel_fleet
    jstate, tstate = js.init_state(2), ts.init_state(2)
    step = ts.bind_env(tenv)
    frames = _frames64(sc, 4)
    for k in range(2):
        arr = [np.stack([frames[k][i], frames[k + 2][i]]) for i in range(3)]
        jstate, jo = js.step(jstate, *(jnp.asarray(a) for a in arr), jenv)
        tstate, to = step(tstate, *(_t(a) for a in arr))
        jo = jax.tree.map(np.asarray, jo)
        for b in range(2):
            _check(f"fleet step {k} stream {b}", type(to)(*(x[b] for x in to)),
                   type(jo)(*(x[b] for x in jo)))
