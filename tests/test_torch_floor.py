"""The floor case (``bench_cases.floor_case``: an office or warehouse floor
map rebuilt from its seed, movers placed from the seed, the dense grid at
the JAX default 0.05 m leaf) on the CPU against the JAX package, at a
reduced floor: 6 m x 6 m (131 x 131 x 3 = 51,483 cells, 146 stencil
offsets), 12 movers, C = 16 clusters, a 4-slot bank that the node grows,
both packages under ``grid_cc="jnp"`` (the JAX stencil CC; in the port
K14's plain version, as on the card past K2's cells):

- ``Tracker.bind_env`` over 3 frames in f32 and f64: integers exact,
  positions within 1e-5 m and velocities within 1e-4 m/s (f64: 1e-9 m,
  1e-8 m/s), the JAX package's bounds;
- ``TrackerNode`` over 3 PointCloud2 frames: the bank grown as the JAX
  node grows it, every output and the final bank the JAX node's;
- the floor case at full size: its grid (611 x 611 x 3 = 1,119,963 cells,
  past K1's 232,320 and K2's 454,656) and its movers, built without running
  it.

The full floor runs on the card (chip_smoke.py ``phase_floor``), held to
the goldens of tests/test_torch_golden_floor.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.io.scenario import Scenario as JScenario
from multiple_object_tracking_lidar_tpu.io.scenario import ScenarioObject as JObject
from multiple_object_tracking_lidar_tpu.ops.static_mask import build_static_mask as j_bsm
from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu.utils.pgm import MapInfo as JMapInfo
from multiple_object_tracking_lidar_tpu.utils.pgm import OccupancyGrid as JGrid
from multiple_object_tracking_lidar_tpu_torch import bench_cases as bc
from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import (
    fused_cc_fits,
    kernel_offsets,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import digit_layout, max_cells
from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

SMALL = dict(size_m=6.0, n_objects=12, n_valid=16_000, n_points=16_384, clutter=150, c_max=16,
             k_max=4)
N_FRAMES = 3
TOLS = {"float32": (1e-5, 1e-4), "float64": (1e-9, 1e-8)}


def _small(dtype):
    """(port cfg, port env, port scenario, JAX cfg, JAX env, JAX scenario,
    port grid, JAX grid) of the reduced floor in ``dtype``."""
    tcfg, tenv, sc = bc.floor_case("cpu", **SMALL)
    tcfg = tcfg.replace(grid_cc="jnp", dtype=dtype)
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
          if f.name not in ("caps", "scene")}
    jcfg = JConfig(**kw, caps=JCaps(**dataclasses.asdict(tcfg.caps)),
                   scene=JScene(**dataclasses.asdict(tcfg.scene)))
    grid = bc.floor_map(bc.FLOOR_SEED, SMALL["size_m"])
    jgrid = JGrid(JMapInfo(**dataclasses.asdict(grid.info)), grid.data)
    jenv = j_bsm(jgrid, jcfg.static_tolarance, jcfg.occupied_threshold)
    jsc = JScenario(grid=jgrid, objects=[JObject(**dataclasses.asdict(o)) for o in sc.objects],
                    **{f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)
                       if f.name not in ("grid", "objects")})
    return tcfg, tenv, sc, jcfg, jenv, jsc, grid, jgrid


def _compare(got, ref, tols, fields):
    tol_pos, tol_vel = tols
    v = ref["valid"]
    for f in fields:
        if f in ("pos", "vel"):
            np.testing.assert_allclose(got[f][v], ref[f][v], rtol=0,
                                       atol=tol_vel if f == "vel" else tol_pos, err_msg=f)
        elif f == "raw_centroid":
            np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol_pos, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_small_floor_bind_env_matches_jax(dtype):
    tcfg, tenv, sc, jcfg, jenv, _, _, _ = _small(dtype)
    dims = grid_shape(tcfg.scene, tcfg.voxel_leaf_size, tcfg.leaf_z)
    assert dims == (131, 131, 3)
    assert len(kernel_offsets(dims, tcfg.cluster_tolerance, 0.05, 1.0)) == 146
    tr, jt = Tracker(tcfg, "cpu"), JTracker(jcfg)
    step, jstep = tr.bind_env(tenv), jt.bind_env(jenv, donate_state=False)
    st, js = tr.init_state(), jt.init_state()
    rows, jrows = [], []
    for k in range(N_FRAMES):
        pts, mask, t = bc.padded_frame(sc, k, tcfg.caps.n_max_points)
        st, o = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        js, jo = jstep(js, JFrame(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(t)))
        rows.append(o)
        jrows.append(jo)
    fields = rows[0]._fields
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in fields}
    ref = {f: np.stack([np.asarray(getattr(r, f)) for r in jrows]) for f in fields}
    _compare(got, ref, TOLS[dtype], fields)
    assert (ref["n_clusters"] == 12).all() and ref["overflow"][1:].min() == 8
    assert ref["valid"][1:].sum(1).tolist() == [4] * (N_FRAMES - 1)
    assert got["pos"].dtype == np.dtype(dtype) and (ref["cc_saturated"] == 0).all()


def test_small_floor_node_grows_as_jax():
    """The node's bank grows 4 -> 8 -> 16 as the JAX node's, every output
    and the final bank the JAX node's."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    from make_torch_golden import node_outputs

    tcfg, _, sc, jcfg, _, jsc, grid, jgrid = _small("float32")
    jnode = JNode(jcfg)
    ref = node_outputs(jnode, jgrid, [jsc.frame(k) for k in range(N_FRAMES)])
    node = TrackerNode(tcfg, device="cpu", keep_outputs=True)
    node.on_map(grid)
    growths, ks = [], []
    for k in range(N_FRAMES):
        node.on_pointcloud(sc.frame(k))
        growths.append(node.n_growths)
        ks.append(node.config.caps.k_max_tracks)
    np.testing.assert_array_equal(growths, ref["n_growths"])
    np.testing.assert_array_equal(ks, ref["k_max_tracks"])
    assert ks[-1] == 16 and node.n_growths == jnode.n_growths == 2
    fields = node.outputs[0]._fields
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in fields}
    _compare(got, {f: ref[f] for f in fields}, TOLS["float32"], fields)
    for f in ("alive", "obj_id", "birth_seq"):
        np.testing.assert_array_equal(getattr(node.state.bank, f).numpy(),
                                      np.asarray(getattr(jnode.state.bank, f)), err_msg=f)


def test_full_floor_is_past_every_narrow_bound():
    """The floor at full size, built and not run: 611 x 611 x 3 cells
    (``grid_shape``'s floor indexing of the 30.5 m x 30.5 m x 2 m scene),
    past K1's 232,320-cell layouts (128 cell ranges) and K2's 454,656
    cells, 146 stencil offsets; 150 movers at least 0.9 m apart, C = 256
    past K4's 128 detections."""
    cfg, env, sc = bc.floor_case("cpu")
    dims = grid_shape(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    n = dims[0] * dims[1] * dims[2]
    assert dims == (611, 611, 3) and n == bc.FLOOR_CELLS > max_cells()
    offs = kernel_offsets(dims, cfg.cluster_tolerance, cfg.voxel_leaf_size, cfg.leaf_z)
    assert len(offs) == 146 and not fused_cc_fits(n, len(offs))
    assert digit_layout(n, 1) == (128, 1)
    assert cfg.caps.c_max_clusters == 256 and cfg.caps.k_max_tracks == 64
    xy = np.asarray([[o.x0, o.y0] for o in sc.objects])
    gaps = np.hypot(*(xy[:, None] - xy[None]).transpose(2, 0, 1)) + 9 * np.eye(len(xy))
    assert len(sc.objects) == 150 and gaps.min() >= 0.9
    pts, _ = sc.frame_arrays(0)
    assert pts.shape == (120_000, 3) and cfg.caps.n_max_points == 131_072
    g = bc.floor_map()
    assert g.data.shape == (600, 600) and set(np.unique(g.data)) == {0, 100}
