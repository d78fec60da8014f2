"""The benchmark configuration and headline scene, without JAX.

Copies of ``__graft_entry__._bench_config`` and ``bench.headline_case``
(both import the JAX package), so the port can build the headline workload
where JAX is absent.  tests/test_torch_host.py pins both against their
originals.  The other front ends run the same scene with one or two
fields changed: on the dense grid ``exact_case`` (bench.py:518),
``runs_case`` and ``exact_unpadded_case``; on the point list
``pointlist_case`` (C), ``pointlist_jnp_case`` (D), ``scan_case`` (E) and
``pointlist_runs_case`` (F).  ``default_case`` (G) is the JAX package's
``TrackerConfig()`` itself, fed the headline frames; ``growth_case`` the
headline with a two-slot bank, which the node grows.
"""

from __future__ import annotations

import dataclasses
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


def exact_case(device="cpu"):
    """Configuration A: the headline with ``voxel_quant="exact"``, as
    bench.py:518 measures it.  The 0.1 m leaf passes ``_v3_leaf_ok`` and a
    4,096-point block tiles N, so the accumulator is K5 (the TPU's v6)."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(voxel_quant="exact"), env, sc


def runs_case(device="cpu"):
    """Configuration B: the headline with ``voxel_mode="runs"`` (the grid
    backend stays): sort + K7 segment totals + densify."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(voxel_mode="runs"), env, sc


def exact_unpadded_case(device="cpu"):
    """Exact mode on frames of exactly the 100,000 valid points, unpadded:
    no point block tiles N = 100,000, so exact mode takes the bf16x3 sums
    (K6), as the TPU takes its jnp lowering of them.  K6's other route, a
    leaf too coarse for two int8 digits (> ~0.124 m), cannot run on this
    map's dense grid yet: at a 0.15 m leaf the sim map's per-cell static
    window is 6 x 6 = 36 bits, past the 32-bit cell table, and the grid
    path's fallback for such maps is still to be ported (ROADMAP Queue 1
    item 22; the point list runs them)."""
    cfg, env, sc = exact_case(device)
    caps = dataclasses.replace(cfg.caps, n_max_points=100_000)
    return cfg.replace(caps=caps), env, sc


def pointlist_case(device="cpu"):
    """Configuration C, the point-list main path: the headline with
    ``voxel_mode="dense"`` (K6 f32 sums + finalize) and
    ``cluster_backend="pallas"`` (K8)."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(voxel_mode="dense", cluster_backend="pallas"), env, sc


def pointlist_jnp_case(device="cpu"):
    """Configuration D: C with the default CC, ``cluster_backend="jnp"``
    (K8's adjacency, pointer-jump sweeps in plain torch)."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(voxel_mode="dense", cluster_backend="jnp"), env, sc


def scan_case(device="cpu"):
    """Configuration E: the scatter-free front end, ``voxel_mode="scan"``,
    with ``cluster_backend="jnp"``."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(voxel_mode="scan", cluster_backend="jnp"), env, sc


def pointlist_runs_case(device="cpu"):
    """Configuration F: the sorted runs (K7) into the point list,
    ``voxel_mode="runs"`` with ``cluster_backend="pallas"`` (K8)."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(voxel_mode="runs", cluster_backend="pallas"), env, sc


def default_case(device="cpu"):
    """Configuration G: ``TrackerConfig()`` -- the JAX package's defaults
    (0.05 m leaf, the default scene: 96 x 224 x 9 = 193,536 cells,
    N = 131,072, m_max_dynamic 2,048, C = 64, P = 512, K = 64), what its
    ``cli run`` runs without ``--backend grid`` -- on the sim map, fed the
    headline frames padded to ``caps.n_max_points``."""
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask

    _, _, sc = headline_case(device)
    cfg = TrackerConfig()
    env = build_static_mask(load_sim_grid(), cfg.static_tolarance, cfg.occupied_threshold,
                            device=device)
    return cfg, env, sc


def growth_case(device="cpu"):
    """The headline with a two-slot track bank (``k_max_tracks=2``): the
    three moving objects overflow the first frame, and the node's default
    ``grow_bank_on_overflow`` doubles the bank (the JAX node's escape hatch,
    runtime/node.py:131-136)."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(caps=dataclasses.replace(cfg.caps, k_max_tracks=2)), env, sc
