"""The port's public surface against the JAX package's.

Every name in every JAX ``__all__`` imports from the port's counterpart,
and the public functions the JAX package's own tests call -- the sort
downsample, the dense-grid clustering, both circumcenter signatures, the
one-hot accumulator and its finalize -- give the JAX package's results on
seeded CPU inputs (each JAX function runs under ``jax.jit``, as its
pipeline does): bit for bit, but for the circumcenters' x / y
(``_close_circumcenters``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene

SUBPACKAGES = ["", ".ops", ".io", ".runtime", ".tracker", ".outputs", ".models", ".parallel"]
SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
LEAF, LEAF_Z, TOL = 0.1, 2.0, 0.15


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s.lstrip(".") or "top")
def test_every_jax_export_imports_from_the_port(sub):
    j = importlib.import_module("multiple_object_tracking_lidar_tpu" + sub)
    t = importlib.import_module("multiple_object_tracking_lidar_tpu_torch" + sub)
    assert list(t.__all__) == list(j.__all__)
    for name in j.__all__:
        obj = getattr(t, name)
        if name != "__version__":
            assert obj.__module__.startswith("multiple_object_tracking_lidar_tpu_torch"), name


def test_top_level_imports():
    from multiple_object_tracking_lidar_tpu_torch import Frame, Tracker, TrackerState

    assert Tracker.__name__ == "Tracker" and TrackerState._fields and Frame._fields


def _points(seed, n=800):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.5, 5.5, n),
                    rng.uniform(-0.2, 2.2, n)], axis=1).astype(np.float32)
    return pts, rng.random(n) > 0.1


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if torch.is_tensor(b) else b)


def _close_circumcenters(want, got):
    """The JAX signature runs its jnp ``_one_cluster``; the port runs K3f,
    the port of the JAX pipeline's pair-stats route.  Both pick the same
    (i, j, k) members, and the frame time and z columns are copied; the two
    JAX routes' determinants differ in which products XLA contracts into
    FMAs, so x / y agree to a few f32 ulps (8 ulps of each value at most
    here), not bit for bit."""
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(want[:, 2:], got[:, 2:])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0,
                               atol=8 * np.spacing(np.abs(want[:, :2])).max())


@pytest.mark.parametrize("seed,far", [(0, False), (1, False), (3, True), (4, True)])
def test_voxel_downsample_sort_matches_jax(seed, far):
    """An unbounded scene (no bounds test); ``far``: a raw scan with far
    returns, whose box spans ~1e13 cells at the 0.1 m leaf -- no dense grid
    holds it; the sort keys by run, so its memory is the points' and the
    runs'."""
    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_downsample_sort as jf
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_downsample_sort as tf

    pts, mask = _points(seed, 600)
    if far:
        pts[7] = [9.5e5, -8.25e5, 40.0]
        pts[11] = [-7.0e5, 6.5e5, -30.0]
        pts[13] = pts[12]                     # a repeated point: one run of two
        mask[[7, 11, 12, 13]] = True
        leaf, leaf_z, sizes = 0.1, 0.1, (1024, 64)
    else:
        pts[:, :2] *= 3.0
        leaf, leaf_z, sizes = 0.25, 5.0, (512, 40)
    for m_max in sizes:                      # every cell kept; the first m_max
        want = jax.jit(jf, static_argnums=(2, 3, 4))(
            jnp.asarray(pts), jnp.asarray(mask), leaf, leaf_z, m_max)
        got = tf(torch.from_numpy(pts), torch.from_numpy(mask), leaf, leaf_z, m_max)
        for w, g in zip(want, got):
            _eq(w, g)


def test_voxel_accumulate_onehot_and_finalize_dense_match_jax():
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import finalize_dense as jfin
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot as jacc
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense as tfin
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import (
        voxel_accumulate_onehot as tacc,
    )

    pts, mask = _points(2)
    ja = jax.jit(lambda p, m: jacc(p, m, JScene(**SCENE), LEAF, LEAF_Z))(
        jnp.asarray(pts), jnp.asarray(mask))
    ta = tacc(torch.from_numpy(pts), torch.from_numpy(mask), TScene(**SCENE), LEAF, LEAF_Z)
    _eq(ja, ta)
    for w, g in zip(jax.jit(jfin)(ja), tfin(ta)):
        _eq(w, g)


def test_euclidean_cluster_grid_matches_jax():
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import euclidean_cluster_grid as jf
    from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape, voxel_accumulate
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import finalize_dense
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
        euclidean_cluster_grid as tf,
    )

    pts, mask = _points(3, 700)
    acc = voxel_accumulate(jnp.asarray(pts), jnp.asarray(mask), JScene(**SCENE), LEAF, LEAF_Z)
    cent, occ, _ = finalize_dense(acc)
    dims = grid_shape(JScene(**SCENE), LEAF, LEAF_Z)
    args = (TOL, LEAF, LEAF_Z, 2, 50, 16, 64, 64, 4)
    want = jax.jit(lambda c, o: jf(c, o, dims, *args))(cent.T, occ)
    got = tf(torch.from_numpy(np.array(cent.T)), torch.from_numpy(np.array(occ)), dims, *args)
    assert int(want.n_clusters) >= 3
    for f in want._fields:
        _eq(getattr(want, f), getattr(got, f))


def _table(seed, c=12, p=24):
    """Member tables of clusters of 3 to P points.  Degenerate clusters (a
    pair, collinear members) are left out: there the JAX package's own two
    routes part (its jnp ``_one_cluster`` rounds G's products apart, its
    pair-stats route, which K3f ports, as XLA contracts them), so G == 0
    holds in one and not the other."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-5, 5, (c, 1, 3))
    mpts = (centre + rng.normal(0, 0.3, (c, p, 3))).astype(np.float32)
    size = rng.integers(3, p + 1, c)
    mm = np.arange(p)[None] < size[:, None]
    return mpts, mm


def test_circumcenter_features_table_matches_jax():
    from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features_table as jf
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_features_table as tf,
    )

    mpts, mm = _table(4)
    t = np.float32(3.25)
    want = jax.jit(jf)(jnp.asarray(mpts), jnp.asarray(mm), jnp.asarray(t))
    _close_circumcenters(want, tf(torch.from_numpy(mpts), torch.from_numpy(mm), torch.tensor(t)))


@pytest.mark.parametrize("chunk", [0, 4])
def test_circumcenter_features_matches_jax(chunk):
    from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features as jf
    from multiple_object_tracking_lidar_tpu_torch.ops import circumcenter_features as tf

    mpts, mm = _table(5)
    c, p, _ = mpts.shape
    rng = np.random.default_rng(6)
    perm = rng.permutation(c * p)
    pts = mpts.reshape(-1, 3)[perm]
    members = np.argsort(perm).reshape(c, p).astype(np.int32)   # pts[members] == mpts
    valid = mm.any(1)
    t = np.float32(7.5)
    want = jax.jit(jf, static_argnums=5)(jnp.asarray(pts), jnp.asarray(members),
                                         jnp.asarray(mm), jnp.asarray(valid), jnp.asarray(t),
                                         chunk)
    got = tf(torch.from_numpy(pts), torch.from_numpy(members), torch.from_numpy(mm),
             torch.from_numpy(valid), torch.tensor(t), chunk)
    _close_circumcenters(want, got)
