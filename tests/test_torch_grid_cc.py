"""K2's plain version (ops/grid_cuda.py) and the cluster table against the
JAX package's dense-grid tail: finalize_dense_cm + remove_static_cells +
connected_components_grid (the jnp route its Pallas kernel is pinned to),
then cluster_table_grid.

Same accumulator in, so everything must match exactly: centroids (the same
IEEE division), dyn (also through the port's own finalize_dense_cm +
remove_static_cells), labels (the min-index fixpoint, whatever the sweep
schedule), and every cluster-table output (integers or copied values).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.io.scenario import Scenario, ScenarioObject
from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm
from multiple_object_tracking_lidar_tpu.ops.cluster_grid import (
    cluster_table_grid as j_table,
    connected_components_grid,
)
from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape
from multiple_object_tracking_lidar_tpu.ops.voxel_grid import (
    finalize_dense_cm,
    voxel_accumulate_onehot_cm,
)
from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda
from multiple_object_tracking_lidar_tpu_torch.ops import static_mask as tsm
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
    cluster_table_grid as t_table,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import (
    finalize_dense_cm as t_finalize,
)
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml as t_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_MAP = os.path.join(REPO, "assets", "sim_map.yaml")
LEAF, LEAF_Z, TOL = 0.1, 2.0, 0.15


def _scene(z_max, y_min=-1.5):
    return dict(x_min=-2.4, x_max=2.5, y_min=y_min, y_max=9.4, z_min=0.0, z_max=z_max)


def _accs(z_max, n_frames=2, seed=3, y_min=-1.5):
    """Channel-major accumulators of scenario frames over the sim map: three
    objects, wall returns, clutter across the z range (a dense band when
    the grid has two slabs)."""
    grid = load_map_yaml(SIM_MAP)
    dense = z_max > 1.0
    sc = Scenario(
        grid=grid,
        objects=[
            ScenarioObject(0.0, 1.0, 0.0, 0.45, points_per_frame=400),
            ScenarioObject(-0.8, 4.0, 0.35, 0.0, points_per_frame=400),
            ScenarioObject(0.9, 6.5, -0.25, 0.25, points_per_frame=400),
        ],
        static_points_per_frame=3000,
        clutter_points=3000 if dense else 150,
        clutter_bounds=(-2.2, 2.3, 6.3, 9.3) if dense else (-2.0, 2.0, -1.0, 9.0),
        clutter_z=(0.0, z_max),
        seed=seed,
    )
    js = JScene(**_scene(z_max, y_min))
    out = []
    for k in range(n_frames):
        pts, _ = sc.frame_arrays(k)
        acc = voxel_accumulate_onehot_cm(
            jnp.asarray(pts), jnp.ones(len(pts), bool), js, LEAF, LEAF_Z, quant="fast"
        )
        out.append(np.asarray(acc, np.float32))
    return np.stack(out)


def _envs(z_max, y_min=-1.5):
    js, ts = JScene(**_scene(z_max, y_min)), TScene(**_scene(z_max, y_min))
    dims = grid_shape(js, LEAF, LEAF_Z)
    jenv = jsm.build_static_mask(load_map_yaml(SIM_MAP), 2, 50)
    tenv = tsm.build_static_mask(t_load(SIM_MAP), 2, 50)
    jtab = jsm.build_cell_static_table(jenv, js, LEAF, *dims)
    ttab = tsm.build_cell_static_table(tenv, ts, LEAF, *dims)
    return dims, jenv, jtab, tenv, ttab


def _run_both(accs, z_max, c_max=16, p_max=64, min_size=5, max_size=300, y_min=-1.5):
    dims, jenv, jtab, tenv, ttab = _envs(z_max, y_min)
    scal = grid_cuda.make_scal(tenv, TOL, "cpu")
    cent, dyn, labels, n_sw, sat = grid_cuda.fused_finalize_static_cc_stacked(
        torch.from_numpy(accs), scal, ttab.base_row, ttab.base_col, ttab.bits,
        dims=dims, tol=TOL, leaf_xy=LEAF, leaf_z=LEAF_Z, kwin=ttab.k,
    )
    tt = t_table(labels, n_sw, cent, dyn, dims[0], min_size, max_size, c_max, p_max)
    for s in range(accs.shape[0]):
        acc = jnp.asarray(accs[s])
        jcent, occ, _ = finalize_dense_cm(acc)
        jdyn = jsm.remove_static_cells(jcent, occ, jenv, jtab)
        jlab, jn, jsat = connected_components_grid(
            jcent, jdyn, dims, TOL, LEAF, LEAF_Z, 32, 2, 2
        )
        assert int(jsat) == 0 and int(sat[s]) == 0
        np.testing.assert_array_equal(np.asarray(jcent), cent[s].numpy())
        np.testing.assert_array_equal(np.asarray(jdyn), dyn[s].numpy())
        tcent, tocc, _ = t_finalize(torch.from_numpy(accs[s]))
        np.testing.assert_array_equal(
            np.asarray(jdyn), tsm.remove_static_cells(tcent, tocc, tenv, ttab).numpy()
        )
        np.testing.assert_array_equal(np.asarray(jlab), labels[s].numpy())
        jt = j_table(jlab, jn, jcent, jdyn, dims[0], min_size, max_size, c_max, p_max)
        for f in ("mpts", "member_mask", "sizes", "cluster_valid", "roots", "n_clusters"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jt, f)), getattr(tt, f)[s].numpy(), err_msg=f
            )
    return dims, cent, dyn, labels, n_sw, tt


@pytest.mark.parametrize("z_max", [1.0, 2.0], ids=["50x110x1", "50x110x2"])
def test_plain_k2_and_cluster_table_match_jnp(z_max):
    accs = _accs(z_max)
    dims, cent, dyn, labels, n_sw, tt = _run_both(accs, z_max)
    assert dims == (50, 110, 1 if z_max == 1.0 else 2)
    assert int(tt.n_clusters.min()) >= 3
    n_off = len(grid_cuda.kernel_offsets(dims, TOL, LEAF, LEAF_Z))
    assert n_off == (24 if z_max == 1.0 else 74)
    assert grid_cuda.fused_cc_fits(dims[0] * dims[1] * dims[2], n_off)


def test_plain_k2_dense_occupancy_and_truncation():
    """Every free-space cell occupied at its centre (one giant component,
    size-filtered away) plus half the cells (many components, some cut at
    P): labels, sizes, order and the truncated member table all match."""
    dims = (50, 110, 1)
    n = dims[0] * dims[1]
    lin = np.arange(n)
    cx = np.float32(-24 + lin % 50) * np.float32(0.1) + np.float32(0.05)
    cy = np.float32(-15 + lin // 50) * np.float32(0.1) + np.float32(0.05)
    full = np.stack([cx, cy, np.full(n, 0.5, np.float32), np.ones(n, np.float32)])
    rng = np.random.default_rng(9)
    half = full * (rng.random(n) < 0.55)
    _run_both(np.stack([full, half]).astype(np.float32), 1.0, c_max=32, p_max=32)


def test_k2_schedule_and_limits():
    """The iteration count is the plain schedule's own (Jacobi sweep + one
    pointer jump per iteration); the cap reports saturation; the shared-
    memory bound of a 16-CTA cluster replaces the TPU's VMEM one (32,768
    cells), and the cluster size follows the cell count."""
    accs = _accs(1.0, n_frames=1)
    dims, jenv, jtab, tenv, ttab = _envs(1.0)
    scal = grid_cuda.make_scal(tenv, TOL, "cpu")
    args = (torch.from_numpy(accs), scal, ttab.base_row, ttab.base_col, ttab.bits)
    kw = dict(dims=dims, tol=TOL, leaf_xy=LEAF, leaf_z=LEAF_Z, kwin=ttab.k)
    _, _, lab, n_sw, sat = grid_cuda.fused_finalize_static_cc_stacked(*args, **kw)
    assert 1 <= int(n_sw[0]) < 10 and int(sat[0]) == 0
    _, _, lab1, n1, sat1 = grid_cuda.fused_finalize_static_cc_stacked(*args, max_sweeps=1, **kw)
    assert int(n1[0]) == 1 and int(sat1[0]) == 1
    assert grid_cuda.cta_cells(24) == 18944 and grid_cuda.cta_cells(74) == 11366
    assert grid_cuda.max_kernel_cells(24) == grid_cuda.max_kernel_cells(146) == 16 * 28416
    assert grid_cuda.fused_cc_fits(32768, 24) and grid_cuda.fused_cc_fits(193536, 146)
    assert not grid_cuda.fused_cc_fits(16 * 28416 + 1, 24)
    assert not grid_cuda.fused_cc_fits(1000, 257)
    assert [grid_cuda.cluster_size(n, o) for n, o in
            ((5500, 24), (32768, 48), (70200, 146), (193536, 146))] == [8, 16, 16, 16]
    assert not grid_cuda.adjacency_in_smem(193536, 146, 16)
    assert grid_cuda.adjacency_in_smem(70200, 146, 16)


@pytest.mark.parametrize("cluster", [2, 4, 16])
def test_plain_k2_cluster_partition_matches_jax(cluster):
    """K2's plain version on a grid that the cluster-size rule spreads over
    ``cluster`` CTAs: the 2-slab grid with its 74 offsets, cut in y to the
    dense clutter band for 2 and 4 CTAs.  Centroids, dyn, labels and the
    cluster table match the JAX package bit for bit.  The kernel runs this
    version's global schedule at every cluster size (one Jacobi sweep over
    all cells, one jump, a cluster-wide vote); test_torch_cuda.py and
    chip_smoke.py hold it to this version at each size."""
    y_min = {2: 7.9, 4: 6.4, 16: -1.5}[cluster]
    accs = _accs(2.0, n_frames=1, seed=11, y_min=y_min)
    dims, cent, dyn, labels, n_sw, tt = _run_both(accs, 2.0, y_min=y_min)
    n = dims[0] * dims[1] * dims[2]
    n_off = len(grid_cuda.kernel_offsets(dims, TOL, LEAF, LEAF_Z))
    assert n_off == 74 and grid_cuda.cluster_size(n, n_off) == cluster
    assert int((labels[0] < n).sum()) > 100 and int(tt.n_clusters[0]) >= 1
