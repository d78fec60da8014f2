"""``dtype="bfloat16"`` and ``"float16"`` on the perception front ends, stage
by stage, against the JAX package's functions under ``jax.jit`` on the CPU:
the scatter sums (``voxel_mode="dense"``) and their finalize, the scan, the
runs' division, the one-hot accumulator's finalize into the point list,
the jnp CC's adjacency, the sorted circumcenter at P = 512, a cell of 300
points (the bf16 count stops at 256) and an f16 sum past 65,504 (inf).

The half route, read from XLA's compiled CPU programs (``tracker/
pipeline.py``'s docstring): the scatter-add rounds every update to the
half dtype; the scan's passes and its division are half ops; the runs stay
f32 (K7) with their counts rounded to the half dtype; the adjacency sums in
f32 and rounds once per reduction.  Every comparison is bit for bit.  The
inputs are the cut headline frames of tests/test_torch_half.py, each
rounded to the half dtype as the pipeline rounds them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)
from test_torch_half import DTYPES, JNP, TORCH, _configs, _eq, _frames, _np, _to_torch

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import voxel as tv
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as tvg
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_pallas as tvp

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.fixture(scope="module")
def cases():
    out = {}
    for dtype in DTYPES:
        jcfg, jenv, tcfg, tenv, sc = _configs(dtype)
        out[dtype] = dict(tcfg=tcfg, tenv=tenv, frames=_frames(sc, n=3),
                          js=JScene(**dataclasses.asdict(tcfg.scene)))
    return out


def _half_points(buf, dtype):
    """(the points rounded to the half dtype and widened, as the port's
    frame holds them; the same as a jnp half array)."""
    p = torch.from_numpy(buf).to(TORCH[dtype])
    return p.float(), jnp.asarray(buf).astype(JNP[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_sums_and_finalize_match_jax(cases, dtype):
    """K6f's half plain version against the JAX scatter-add on the half
    points (every update rounded to the half dtype, in ascending point
    index), and the finalize (a half division) into the point list."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_accumulate, voxel_finalize

    c = cases[dtype]
    cfg = c["tcfg"]
    leaf, lz, m_max = cfg.voxel_leaf_size, cfg.leaf_z, cfg.caps.m_max_voxels
    jf = jax.jit(lambda p, m: (lambda a: (a, *voxel_finalize(a, m_max)))(
        voxel_accumulate(p, m, c["js"], leaf, lz)))
    for buf, mask, _ in c["frames"]:
        p32, ph = _half_points(buf, dtype)
        acc, npts = tv.voxel_accumulate_stacked(p32[None], torch.from_numpy(mask)[None],
                                                cfg.scene, leaf, lz, dtype=TORCH[dtype])
        assert acc.dtype == TORCH[dtype] and int(npts[0]) == int(mask.sum())
        ja, jv, jm, jn = jf(ph, jnp.asarray(mask))
        _eq(acc[0].T, ja, "sums")
        vox, vm, nv = tv.voxel_finalize_cm(acc, m_max)
        _eq(vox[0], jv, "centroids")
        _eq(vm[0], jm)
        _eq(nv[0], jn)
        assert int(nv[0]) > 100


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_matches_jax(cases, dtype):
    """The scan's Hillis-Steele passes and its division in the half dtype,
    on f32 points holding half values (``dtype``) and on half points."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_downsample_scan

    c = cases[dtype]
    cfg = c["tcfg"]
    args = (cfg.voxel_leaf_size, cfg.leaf_z, cfg.caps.m_max_voxels)
    jf = jax.jit(lambda p, m: voxel_downsample_scan(p, m, c["js"], *args))
    for buf, mask, _ in c["frames"][:2]:
        p32, ph = _half_points(buf, dtype)
        ref = jf(ph, jnp.asarray(mask))
        got = tv.voxel_downsample_scan(p32, torch.from_numpy(mask), cfg.scene, *args,
                                       dtype=TORCH[dtype])
        again = tv.voxel_downsample_scan(p32.to(TORCH[dtype]), torch.from_numpy(mask),
                                         cfg.scene, *args)
        assert got[0].dtype == again[0].dtype == TORCH[dtype]
        for g, a, r in zip(got, again, ref):
            _eq(g, r)
            _eq(a, r)


@pytest.mark.parametrize("dtype", DTYPES)
def test_runs_division_matches_jax(cases, dtype):
    """The runs' voxel list: K7's f32 totals of the half points, each run's
    count rounded to the half dtype, the division in f32 (f32 centroids)."""
    from multiple_object_tracking_lidar_tpu.ops.voxel_pallas import voxel_downsample_runs

    c = cases[dtype]
    cfg = c["tcfg"]
    args = (cfg.voxel_leaf_size, cfg.leaf_z, cfg.caps.m_max_voxels)
    jf = jax.jit(lambda p, m: voxel_downsample_runs(p, m, c["js"], *args, interpret=True))
    for buf, mask, _ in c["frames"][:2]:
        p32, ph = _half_points(buf, dtype)
        ref = jf(ph, jnp.asarray(mask))
        got = tvp.voxel_downsample_runs(p32, torch.from_numpy(mask), cfg.scene, *args,
                                        dtype=TORCH[dtype])
        assert ref[0].dtype == jnp.float32 and got[0].dtype == torch.float32
        for g, r in zip(got, ref):
            _eq(g, r)


@pytest.mark.parametrize("dtype", DTYPES)
def test_onehot_point_list_finalize_matches_jax(cases, dtype):
    """The one-hot accumulator's f32 sums rounded to the half dtype, then
    the point list's half finalize (JAX pipeline.py:864-886)."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_finalize
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot_cm
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    c = cases[dtype]
    cfg = c["tcfg"].replace(cluster_backend="jnp")
    m_max = cfg.caps.m_max_voxels
    jf = jax.jit(lambda p, m: voxel_finalize(voxel_accumulate_onehot_cm(
        p, m, c["js"], cfg.voxel_leaf_size, cfg.leaf_z, quant="fast").T, m_max))
    tr = Tracker(cfg, device="cpu")
    for buf, mask, t in c["frames"][:2]:
        fr = tr._frame(Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        accs, _ = tr.accumulate(fr.points[None], fr.mask[None])
        assert accs.dtype == TORCH[dtype]
        got = tv.voxel_finalize_cm(accs, m_max)
        ref = jf(_half_points(buf, dtype)[1], jnp.asarray(mask))
        for g, r in zip(got, ref):
            _eq(g[0], r)


def _dynamic_points(c, dtype, buf, mask):
    """The frame's compacted dynamic voxels in the half dtype (the scatter
    route's), as the CC takes them: ((M, 3), (M,))."""
    from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import remove_static
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import make_plan

    cfg = c["tcfg"].replace(voxel_mode="dense", cluster_backend="jnp")
    p32, _ = _half_points(buf, dtype)
    acc, _ = tv.voxel_accumulate_stacked(p32[None], torch.from_numpy(mask)[None], cfg.scene,
                                         cfg.voxel_leaf_size, cfg.leaf_z, dtype=TORCH[dtype])
    vox, vm, _ = tv.voxel_finalize_cm(acc, cfg.caps.m_max_voxels)
    env = make_plan(cfg, c["tenv"], "cpu").env
    pts, pm, _ = compact_points(vox, remove_static(vox, vm, env), cfg.caps.m_max_dynamic)
    return pts[0], pm[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_pairwise_adjacency_matches_jax(cases, dtype):
    """K8a's half plain version against the JAX ``_pairwise_adjacency``
    jitted on the same half points: the tree column sum in f32 rounded,
    the count rounded, the half centring, sq and the gram as f32 sums
    rounded once, d2 per op."""
    from multiple_object_tracking_lidar_tpu.ops.cluster import _pairwise_adjacency
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import cc_adjacency

    c = cases[dtype]
    tol = c["tcfg"].cluster_tolerance
    jf = jax.jit(lambda p, m: _pairwise_adjacency(p, m, tol))
    edges = 0
    for buf, mask, _ in c["frames"]:
        pts, pm = _dynamic_points(c, dtype, buf, mask)
        assert pts.dtype == TORCH[dtype] and int(pm.sum()) > 50
        got = cc_adjacency(pts, pm, tol)
        ref = jf(jnp.asarray(pts.float().numpy()).astype(JNP[dtype]), jnp.asarray(pm.numpy()))
        _eq(got, ref)
        edges += int(got.sum())
    assert edges > 1000


@pytest.mark.parametrize("dtype", DTYPES)
def test_half_gram_is_not_the_f32_gram_rounded(cases, dtype):
    """The half adjacency joins other pairs than the f32 adjacency of the
    same half points (why configurations C and D part under half): both
    against JAX, on the headline's first frames together."""
    from multiple_object_tracking_lidar_tpu.ops.cluster import _pairwise_adjacency
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import cc_adjacency

    c = cases[dtype]
    tol = c["tcfg"].cluster_tolerance
    jf = jax.jit(lambda p, m: _pairwise_adjacency(p, m, tol))
    differ = 0
    for buf, mask, _ in c["frames"]:
        pts, pm = _dynamic_points(c, dtype, buf, mask)
        half = cc_adjacency(pts, pm, tol)
        f32 = cc_adjacency(pts.float(), pm, tol)
        _eq(f32, jf(jnp.asarray(pts.float().numpy()), jnp.asarray(pm.numpy())))
        differ += int((half != f32).sum())
    assert differ > 0


def test_sorted_circumcenter_at_p_512_matches_jax():
    """K3f's half plain version on the cluster-sorted point list at G's
    P = 512 (clusters of 1-512 members, every member mean past one 32-row
    window) against the JAX ``circumcenter_features_sorted`` jitted: bf16
    bit for bit; in f16 that program jitted alone is not the tracking
    step's -- XLA contracts other f16 products there (tests/test_torch_half.py
    ``test_k3f_half_plain_against_the_jax_table_function``) -- so y, t and
    the picks agree everywhere and x on most slots (the step's own bits
    are held end to end through G's goldens)."""
    from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features_sorted
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_features_sorted as tsorted)

    rng = np.random.default_rng(512)
    p, c = 512, 24
    sizes = rng.integers(1, p + 1, c)
    sizes[:4] = [p, 300, 33, 2]
    m = int(sizes.sum())
    centre = np.repeat(rng.uniform(-20, 20, (c, 3)), sizes, axis=0)
    pts = np.concatenate([centre + rng.normal(0, 0.4, (m, 3)), np.zeros((p, 3))])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    valid = np.ones(c, bool)
    valid[-2:] = False
    for dtype in DTYPES:
        jp = jnp.asarray(pts.astype(np.float32)).astype(JNP[dtype])
        ref = _np(jax.jit(lambda *a: circumcenter_features_sorted(*a, p))(
            jp, jnp.asarray(starts), jnp.asarray(sizes.astype(np.int32)), jnp.asarray(valid),
            jnp.asarray(1.5, JNP[dtype])))
        got = tsorted(_to_torch(jp)[None], torch.from_numpy(starts)[None],
                      torch.from_numpy(sizes)[None], torch.from_numpy(valid)[None],
                      torch.tensor([1.5], dtype=TORCH[dtype]), p)[0]
        assert got.dtype == TORCH[dtype]
        got = _np(got)
        if dtype == "bfloat16":
            _eq(got[valid], ref[valid])
        else:
            _eq(got[valid][:, 1:], ref[valid][:, 1:])
            assert (got[valid][:, 0] == ref[valid][:, 0]).mean() > 0.8


def _one_cell_frame(n, xyz, spread):
    """n points in one 0.5 m cell of a small scene, plus a masked row."""
    rng = np.random.default_rng(n)
    pts = (np.float32(xyz) + rng.uniform(0, spread, (n + 1, 3))).astype(np.float32)
    mask = np.ones(n + 1, bool)
    mask[-1] = False
    return pts, mask


def test_bf16_count_stops_at_256():
    """A cell of 300 points: the JAX bf16 scatter-add's count (ones added in
    bf16) stops at 256, and so do the port's sums, the scan's count and the
    centroid dividing by it; the f16 count is exact."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_accumulate, voxel_downsample_scan

    sc = dict(x_min=0.0, x_max=1.9, y_min=0.0, y_max=1.9, z_min=0.0, z_max=0.9)
    pts, mask = _one_cell_frame(300, (0.55, 0.6, 0.1), 0.4)
    for dtype, want in (("bfloat16", 256.0), ("float16", 300.0)):
        ph = jnp.asarray(pts).astype(JNP[dtype])
        ref = jax.jit(lambda p, m: voxel_accumulate(p, m, JScene(**sc), 0.5, 1.0))(
            ph, jnp.asarray(mask))
        acc, _ = tv.voxel_accumulate_stacked(_to_torch(ph).float()[None],
                                             torch.from_numpy(mask)[None], TScene(**sc), 0.5,
                                             1.0, dtype=TORCH[dtype])
        _eq(acc[0].T, ref)
        assert float(acc[0, 3].max()) == want
        jscan = jax.jit(lambda p, m: voxel_downsample_scan(p, m, JScene(**sc), 0.5, 1.0, 8))(
            ph, jnp.asarray(mask))
        tscan = tv.voxel_downsample_scan(_to_torch(ph), torch.from_numpy(mask), TScene(**sc),
                                         0.5, 1.0, 8)
        for g, r in zip(tscan, jscan):
            _eq(g, r)
    assert tvg.COUNT_SAT == {torch.bfloat16: 256, torch.float16: 2048}


def test_f16_sum_past_65504_is_inf():
    """40 points near x = 2,000 m in one cell: the f16 sum of x passes
    65,504 and is inf in JAX and in the port (its centroid too); y and z
    stay finite, and bf16 keeps a finite sum."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_accumulate, voxel_finalize

    sc = dict(x_min=1998.0, x_max=2001.9, y_min=0.0, y_max=1.9, z_min=0.0, z_max=0.9)
    pts, mask = _one_cell_frame(40, (2000.1, 0.6, 0.1), 0.3)
    for dtype in DTYPES:
        ph = jnp.asarray(pts).astype(JNP[dtype])
        ja = jax.jit(lambda p, m: voxel_accumulate(p, m, JScene(**sc), 0.5, 1.0))(
            ph, jnp.asarray(mask))
        acc, _ = tv.voxel_accumulate_stacked(_to_torch(ph).float()[None],
                                             torch.from_numpy(mask)[None], TScene(**sc), 0.5,
                                             1.0, dtype=TORCH[dtype])
        _eq(acc[0].T, ja)
        jv = jax.jit(lambda a: voxel_finalize(a, 4))(ja)
        tvox = tv.voxel_finalize_cm(acc, 4)
        for g, r in zip(tvox, jv):
            _eq(g[0], r)
        sums = _np(acc[0, :3]).max(axis=1)
        if dtype == "float16":
            assert np.isinf(sums[0]) and np.isfinite(sums[1:]).all()
        else:
            assert np.isfinite(sums).all()
