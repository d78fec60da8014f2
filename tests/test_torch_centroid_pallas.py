"""The port's counterparts of the last TPU kernels against the JAX package,
on the CPU (plain versions; the JAX kernels in interpret mode):

- K10's plain version (``circumcenter_xy_pallas`` of the port) against
  ``circumcenter_xy_pallas(interpret=True)``, the all-in-kernel TPU
  circumcenter, on the cases of tests/test_grid.py:1029-1113 (grid-like
  coordinates, a singleton, a collinear cluster, an empty slot, P = 256
  across slabs) and bench-like (8, 384) slots.  Rows with members agree
  within atol 1e-5 m, the bound the JAX suite holds its own kernel to
  against the jnp table path: the kernel centres with an f32 sum and
  takes the gram on the MXU, where K3's written order rounds an f64 sum
  and takes it elementwise (a few ulp of d2).  A collinear row is Pi
  exactly in the port and in the jnp table path
  (``circumcenter_features_table``), and held to that path: the v1
  kernel's own G misses zero there by the residual of a contracted
  a*b - c*d (XLA's on the CPU, as Mosaic's on the TPU,
  centroid_pallas.py:185-191), which is why the JAX pipeline runs K3's
  route instead.
- ``pair_stats_pallas`` (K3) against the JAX ``pair_stats_pallas``
  (``_kernel_v3``) at ``slab_rows`` 128 and None: firstrow exact, colmax
  within rtol 1e-5 + atol 1e-6 (test_torch_centroid.py's K3 bound, for
  the same reason).
- ``accumulate_from_indices`` (K6's key entry) against
  ``_accumulate_pallas(interpret=True)`` at N = 1,024 and N = 1,100 with
  block 512: counts exact, sums within atol 1e-6 (the MXU adds each 512-
  point block's bf16 parts, then the blocks; K6 adds in ascending point
  index).  The TPU grid sums only the first (N // block) * block points;
  so does the port.
- K1-cm's plain digit sums against ``_accumulate_pallas_v5_stacked_raw``
  given channel-major points: bit for bit.
- K11's plain version against the transpose probes of
  ``scripts/micro_transpose.py`` (direct, and tiled through (16, 128)) in
  interpret mode, on the probes' own (1, 2048) int32 row: bit for bit; and
  against ``np.transpose`` at every width K11's routes tell apart (C = 1,
  a copy; 2-4, the 16-byte row groups; 5, 33 and 128, the tiles), R % 4 =
  0-3 (a ragged last group, misaligned planes and frames), int32 and f32
  words (NaN payloads included): bit for bit.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.ops import centroid_pallas as jcp
from multiple_object_tracking_lidar_tpu.ops import voxel_grid as jvg
from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features_table
from multiple_object_tracking_lidar_tpu.ops.voxel import _quantize, grid_shape
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
from multiple_object_tracking_lidar_tpu_torch.ops import centroid_pallas as tcp
from multiple_object_tracking_lidar_tpu_torch.ops import transpose_cuda
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as tvg
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import accumulate_from_indices

SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
LEAF, LEAF_Z = 0.1, 2.0


def _grid_like(seed, cc, p, sizes=None):
    """Member tables on a 0.1 m lattice (tests/test_grid.py:1029-1113)."""
    r = np.random.default_rng(seed)
    mpts = np.zeros((cc, p, 3), np.float32)
    mm = np.zeros((cc, p), bool)
    for c in range(cc):
        n = int(r.integers(0, p)) if sizes is None else sizes[c]
        mpts[c, :n] = np.round(r.normal(0, 1, (n, 3)) * 10) / 10
        mm[c, :n] = True
    return mpts, mm


def _edges(seed):
    """test_grid.py:1068-1084: random slots, a singleton, a collinear
    cluster (G == 0), an empty slot."""
    cc, p = 8, 64
    mpts, mm = _grid_like(seed, cc, p, sizes=[int(s) for s in
                                             np.random.default_rng(seed).integers(0, p, cc)])
    mpts[cc - 3:], mm[cc - 3:] = 0.0, False
    mpts[cc - 3, 0] = [1.0, 2.0, 0.5]
    mm[cc - 3, 0] = True
    for k in range(5):
        mpts[cc - 2, k] = [0.1 * k, 0.2 * k, 0.0]
    mm[cc - 2, :5] = True
    return mpts, mm


CASES = {
    "grid-like 8x64": lambda: _grid_like(5, 8, 64),
    "singleton, collinear, empty": lambda: _edges(11),
    "P=256 across slabs": lambda: _grid_like(11, 4, 256, sizes=[40, 128, 130, 250]),
    "bench-like 8x384": lambda: _grid_like(23, 8, 384, sizes=[300, 250, 180, 40, 0, 0, 0, 0]),
}


COLLINEAR = {"singleton, collinear, empty": 6}   # case -> its collinear slot


@pytest.mark.parametrize("case", list(CASES))
def test_k10_plain_matches_circumcenter_xy_pallas(case):
    mpts, mm = CASES[case]()
    ref = np.asarray(jcp.circumcenter_xy_pallas(jnp.asarray(mpts), jnp.asarray(mm), interpret=True))
    before = centroid_cuda.circumcenter_xy.launches
    got = tcp.circumcenter_xy_pallas(torch.from_numpy(mpts), torch.from_numpy(mm)).numpy()
    assert centroid_cuda.circumcenter_xy.launches == before      # the CPU route
    ok = mm.any(axis=1)
    line = COLLINEAR.get(case)
    if line is not None:
        ok[line] = False
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-5)
    # the wrapper is its plain version on the CPU, bit for bit
    np.testing.assert_array_equal(
        got, centroid_cuda.circumcenter_xy_plain(torch.from_numpy(mpts), torch.from_numpy(mm)).numpy())
    if line is not None:
        table = np.asarray(circumcenter_features_table(jnp.asarray(mpts), jnp.asarray(mm),
                                                       jnp.float32(0.0)))
        members = mpts[line, mm[line], :2]
        assert (members == got[line]).all(1).any()                  # Pi exactly
        np.testing.assert_array_equal(got[line], table[line, :2])
        np.testing.assert_array_equal(got[5], mpts[5, 0, :2])        # the singleton


def test_k10_features_table_matches_jax():
    mpts, mm = _edges(11)
    ref = np.asarray(jcp.circumcenter_features_table_pallas(
        jnp.asarray(mpts), jnp.asarray(mm), jnp.float32(0.3), interpret=True))
    got = tcp.circumcenter_features_table_pallas(
        torch.from_numpy(mpts), torch.from_numpy(mm), torch.tensor(0.3)).numpy()
    ok = mm.any(axis=1)
    ok[COLLINEAR["singleton, collinear, empty"]] = False
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-5)
    assert (got[:, 2] == 0).all() and (got[:, 3] == np.float32(0.3)).all()
    # the same function as the pipeline's K3 route
    v2 = tcp.circumcenter_features_table_pallas_v2(
        torch.from_numpy(mpts), torch.from_numpy(mm), 0.3).numpy()
    np.testing.assert_array_equal(got, v2)


PAIR_CASES = {
    "bench-like": (8, 384, [300, 250, 180, 40, 0, 0, 0, 0]),
    "gaps + singleton": (8, 384, [0, 0, 7, 0, 1, 50, 0, 0]),
    "P=256 slab edge": (4, 256, [256, 3, 129, 9]),
}


@pytest.mark.parametrize("slab_rows", [128, None])
@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_stats_pallas_matches_jax(case, slab_rows):
    cc, p, sizes = PAIR_CASES[case]
    mpts, mm = _grid_like(23, cc, p, sizes=sizes)
    jcm, jfr = jcp.pair_stats_pallas(jnp.asarray(mpts), jnp.asarray(mm), interpret=True,
                                     slab_rows=slab_rows)
    tcm, tfr = tcp.pair_stats_pallas(torch.from_numpy(mpts), torch.from_numpy(mm),
                                     slab_rows=slab_rows)
    np.testing.assert_array_equal(np.asarray(jfr), tfr.numpy())
    np.testing.assert_allclose(np.asarray(jcm), tcm.numpy(), rtol=1e-5, atol=1e-6)
    dcm, dfr = tcp.pair_stats_pallas_dyn(torch.from_numpy(mpts), torch.from_numpy(mm))
    assert torch.equal(dcm, tcm) and torch.equal(dfr, tfr)


def test_pair_stats_pallas_validates_slab_rows():
    mpts, mm = _grid_like(1, 2, 384, sizes=[10, 0])
    with pytest.raises(ValueError, match="slab_rows"):
        tcp.pair_stats_pallas(torch.from_numpy(mpts), torch.from_numpy(mm), slab_rows=100)


def _indexed_points(rng, n):
    """test_grid.py:64-94: points in and around the scene, the TPU
    caller's quantize into (ix, iyz, in_bounds)."""
    pts = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.5, 5.5, n),
                    rng.uniform(-0.2, 2.2, n)], axis=1).astype(np.float32)
    mask = rng.random(n) > 0.1
    sc = JScene(**SCENE)
    gx, gy, gz = grid_shape(sc, LEAF, LEAF_Z)
    ix, iy, iz = _quantize(jnp.asarray(pts), LEAF, LEAF_Z)
    ix = ix - math.floor(sc.x_min / LEAF)
    iy = iy - math.floor(sc.y_min / LEAF)
    iz = iz - math.floor(sc.z_min / LEAF_Z)
    ok = (jnp.asarray(mask) & (ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gy)
          & (iz >= 0) & (iz < gz))
    ix = jnp.where(ok, ix, -1)
    iyz = jnp.where(ok, iy + gy * iz, -1)
    return pts, np.asarray(ix), np.asarray(iyz), np.asarray(ok), gx, gy * gz


@pytest.mark.parametrize("n", [1024, 1100])
def test_accumulate_from_indices_matches_accumulate_pallas(n):
    pts, ix, iyz, ok, gx, gyz = _indexed_points(np.random.default_rng(42), n)
    ref = np.asarray(jvg._accumulate_pallas(jnp.asarray(pts), jnp.asarray(ix), jnp.asarray(iyz),
                                            jnp.asarray(ok), gx, gyz, block=512, interpret=True))
    before = tvg.accumulate_bf16x3_keys.launches
    got = accumulate_from_indices(*(torch.from_numpy(np.array(a)) for a in (pts, ix, iyz, ok)),
                                  gx, gyz, 512)
    assert tvg.accumulate_bf16x3_keys.launches == before
    assert got.shape == (4, gyz * gx)
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    np.testing.assert_allclose(got[:3].numpy(), ref[:3], rtol=0, atol=1e-6)
    assert int(got[3].sum()) == int(ok[:1024].sum())         # the tail is dropped


def test_accumulate_from_indices_drops_the_tail_and_foreign_keys():
    """The TPU grid's quirk (``grid = n // block``): points past the last
    whole block are never summed, whatever they hold; keys outside the
    grid match no one-hot row and are dropped even when in bounds."""
    pts, ix, iyz, ok, gx, gyz = _indexed_points(np.random.default_rng(7), 1100)
    args = [torch.from_numpy(np.array(a)) for a in (pts, ix, iyz, ok)]
    base = accumulate_from_indices(*args, gx, gyz, 512)
    pts2, ix2, iyz2, ok2 = (a.clone() for a in args)
    pts2[1024:] = 1e3
    ix2[1024:], iyz2[1024:], ok2[1024:] = 0, 0, True
    assert torch.equal(accumulate_from_indices(pts2, ix2, iyz2, ok2, gx, gyz, 512), base)
    ix2[:10], ok2[:10] = gx, True                            # ix past the grid
    iyz2[10:20], ok2[10:20] = gyz, True                      # iyz past the grid
    ok2[20:30], ix2[20:30], iyz2[20:30] = False, 0, 0        # valid cell, not in bounds
    got = accumulate_from_indices(pts2, ix2, iyz2, ok2, gx, gyz, 512)
    keep = torch.ones(1100, dtype=torch.bool)
    keep[:30] = False
    want = accumulate_from_indices(pts2, ix2, iyz2, ok2 & keep, gx, gyz, 512)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="block"):
        accumulate_from_indices(*args, gx, gyz, 2048)


def test_k1_cm_plain_digit_sums_match_v5_raw_channel_major():
    rng = np.random.default_rng(3)
    s, n = 2, 2048
    pts = np.stack([rng.uniform(-2.5, 2.5, (s, n)), rng.uniform(-1.5, 5.5, (s, n)),
                    rng.uniform(-0.2, 2.2, (s, n))], axis=2).astype(np.float32)
    mask = rng.random((s, n)) > 0.1
    pcm = np.ascontiguousarray(pts.transpose(0, 2, 1))
    jraw, jn = jvg._accumulate_pallas_v5_stacked_raw(
        jnp.asarray(pts), jnp.asarray(mask), JScene(**SCENE), LEAF, LEAF_Z, block=1024,
        interpret=True, points_cm=jnp.asarray(pcm))
    before = tvg.accumulate_fast_stacked_cm_raw.launches
    raw, cnt = tvg.accumulate_fast_stacked_cm_raw(torch.from_numpy(pcm), torch.from_numpy(mask),
                                                  TScene(**SCENE), LEAF, LEAF_Z)
    assert tvg.accumulate_fast_stacked_cm_raw.launches == before
    nc = raw.shape[2]
    jraw = np.asarray(jraw).reshape(s, 4, -1)[..., :nc].astype(np.int32)
    np.testing.assert_array_equal(raw.numpy(), jraw)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jn))
    assert int(raw[:, 3].sum()) > 1000
    fused, _ = tvg.accumulate_fast_stacked_cm(torch.from_numpy(pcm), torch.from_numpy(mask),
                                              TScene(**SCENE), LEAF, LEAF_Z)
    rows, _ = tvg.accumulate_fast_stacked(torch.from_numpy(pts), torch.from_numpy(mask),
                                          TScene(**SCENE), LEAF, LEAF_Z)
    assert torch.equal(fused, rows)


def _micro_transpose():
    """The JAX package's probe script, loaded from its file."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "micro_transpose.py")
    spec = importlib.util.spec_from_file_location("micro_transpose", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("probe,rows", [("_kernel_direct", 1), ("_kernel_tiled", 16)])
def test_k11_plain_matches_micro_transpose_probes(probe, rows):
    """(1, B) -> (B, 1) is K11 on (1, 1, B); the tiled probe's (16, 128) ->
    (128, 16) is K11 on (1, 16, 128)."""
    mt = _micro_transpose()
    x = np.random.default_rng(13).integers(0, 128, (1, mt.B)).astype(np.int32)
    ref = pl.pallas_call(getattr(mt, probe), out_shape=jax.ShapeDtypeStruct((mt.B, 1), jnp.int32),
                         interpret=True)(jnp.asarray(x))
    before = transpose_cuda.transpose_words.launches
    got = transpose_cuda.transpose_words(torch.from_numpy(x).reshape(1, rows, -1))
    assert transpose_cuda.transpose_words.launches == before      # the CPU route
    assert got.shape == (1, mt.B // rows, rows) and got.is_contiguous()
    np.testing.assert_array_equal(got.reshape(mt.B, 1).numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("r_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 33, 128])
def test_k11_plain_matches_numpy_transpose(c, r_mod, dtype):
    rng = np.random.default_rng(100 * c + r_mod)
    r = 36 + r_mod
    x = rng.integers(-2**31, 2**31 - 1, (3, r, c), dtype=np.int64).astype(np.int32).view(dtype)
    before = transpose_cuda.transpose_words.launches
    got = transpose_cuda.transpose_words(torch.from_numpy(x))
    assert transpose_cuda.transpose_words.launches == before      # the CPU route
    assert got.shape == (3, c, r) and got.is_contiguous() and got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.ascontiguousarray(np.transpose(x, (0, 2, 1))).view(np.int32))
