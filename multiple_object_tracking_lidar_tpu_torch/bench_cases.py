"""The benchmark configuration and headline scene, without JAX.

Copies of ``__graft_entry__._bench_config`` and ``bench.headline_case``
(both import the JAX package), so the port can build the headline workload
where JAX is absent.  tests/test_torch_host.py pins both against their
originals.
"""

from __future__ import annotations

import os

from multiple_object_tracking_lidar_tpu_torch.config import (
    Capacities,
    SceneBounds,
    TrackerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_MAP = os.path.join(REPO, "assets", "sim_map.yaml")


def bench_config() -> TrackerConfig:
    """The benchmarked configuration: dense-grid perception (one-hot voxel
    accumulation + stencil CC), single-digit accumulator, the sim map's
    volume at a 0.1 m leaf, 106,496-point frames."""
    return TrackerConfig(
        voxel_leaf_size=0.1,
        max_cluster_size=300,
        data_length=40,
        voxel_mode="onehot",
        cluster_backend="grid",
        voxel_quant="fast",
        scene=SceneBounds(
            x_min=-2.4, x_max=2.5, y_min=-1.5, y_max=9.4, z_min=0.0, z_max=1.0
        ),
        caps=Capacities(
            n_max_points=106496,
            m_max_voxels=8192,
            m_max_dynamic=1024,
            c_max_clusters=32,
            p_max_cluster=384,
            k_max_tracks=64,
        ),
    )


def load_sim_grid():
    """The bundled fixture map (assets/sim_map.yaml)."""
    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml

    return load_map_yaml(SIM_MAP)


def headline_case(device="cpu"):
    """(cfg, env, scenario): the realistic 100k-point frame mix -- mostly
    static wall returns, three moving objects, sparse free-space clutter."""
    from multiple_object_tracking_lidar_tpu_torch.io.scenario import (
        Scenario,
        ScenarioObject,
    )
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask

    grid = load_sim_grid()
    cfg = bench_config()
    n_valid = 100_000
    env = build_static_mask(grid, cfg.static_tolarance, cfg.occupied_threshold, device=device)
    sc = Scenario(
        grid=grid,
        objects=[
            ScenarioObject(0.0, 1.0, 0.0, 0.45, points_per_frame=1500),
            ScenarioObject(-0.8, 4.0, 0.35, 0.0, points_per_frame=1500),
            ScenarioObject(0.9, 6.5, -0.25, 0.25, points_per_frame=1500),
        ],
        static_points_per_frame=n_valid - 3 * 1500 - 300,
        clutter_points=300,  # sparse: clutter must not bridge object clusters
        seed=123,
    )
    return cfg, env, sc


def padded_frame(sc, k: int, n_pts: int):
    """(points (n_pts, 3) f32, mask (n_pts,) bool, t) of scenario frame k,
    zero-padded as bench.py stages frames."""
    import numpy as np

    pts, t = sc.frame_arrays(k)
    buf = np.zeros((n_pts, 3), np.float32)
    buf[: len(pts)] = pts[:n_pts]
    mask = np.zeros(n_pts, bool)
    mask[: min(len(pts), n_pts)] = True
    return buf, mask, np.float32(t)
