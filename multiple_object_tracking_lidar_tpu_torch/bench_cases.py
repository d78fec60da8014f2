"""The benchmark configuration and headline scene, without JAX.

Copies of ``__graft_entry__._bench_config`` and ``bench.headline_case``
(both import the JAX package), so the port can build the headline workload
where JAX is absent.  tests/test_torch_host.py pins both against their
originals.  The other front ends run the same scene with one or two
fields changed: on the dense grid ``exact_case`` (bench.py:518),
``runs_case`` and ``exact_unpadded_case``; on the point list
``pointlist_case`` (C), ``pointlist_jnp_case`` (D), ``scan_case`` (E) and
``pointlist_runs_case`` (F).  ``default_case`` (G) is the JAX package's
``TrackerConfig()`` itself, fed the headline frames, and
``default_grid_case`` (G-grid) its dense-grid form; ``growth_case`` the
headline with a two-slot bank, which the node grows.  ``hungarian_case`` is
the headline under ``association="hungarian"``; ``dense_case`` a copy of
``bench.dense_case`` (40 objects 0.55 m apart under a 0.5 m gate, where
greedy and Hungarian association disagree) and ``dense_hungarian_case``
that scene under hungarian.

The kernels' own inputs, made from a seed: ``track_scene`` (K4: banks,
detections with duplicates, gaps, overflow), ``k2_grids`` and
``k2_inputs`` (K2 from the headline's 5,500 cells to the default scene's
193,536), ``digit_grids`` (the same grids as scenes, for K1 and K5),
``k3f_edge_tables`` (K3f's half and table builds: gaps, non-finite
non-members, empty slots on a non-finite row 0, d2 ties, f16 overflow).
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


def default_grid_case(device="cpu"):
    """Configuration G-grid: G's config and frames on the dense grid
    (``voxel_mode="onehot"``, ``cluster_backend="grid"``,
    ``voxel_quant="fast"``): K1 and K2 at the default scene's 193,536
    cells."""
    cfg, env, sc = default_case(device)
    return cfg.replace(voxel_mode="onehot", cluster_backend="grid", voxel_quant="fast"), env, sc


def growth_case(device="cpu"):
    """The headline with a two-slot track bank (``k_max_tracks=2``): the
    three moving objects overflow the first frame, and the node's default
    ``grow_bank_on_overflow`` doubles the bank (the JAX node's escape hatch,
    runtime/node.py:131-136)."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(caps=dataclasses.replace(cfg.caps, k_max_tracks=2)), env, sc


def hungarian_case(device="cpu"):
    """The headline config and scene under ``association="hungarian"``:
    the auction (K4's Hungarian build) in place of the greedy scan."""
    cfg, env, sc = headline_case(device)
    return cfg.replace(association="hungarian"), env, sc


def dense_case(device="cpu"):
    """(cfg, env, scenario) of the dense-dynamic workload, a copy of
    ``bench.dense_case`` (bench.py:453-506): 40 moving objects in the south,
    0.55 m apart on an 8 x 5 lattice (under the 0.5 m gate, so greedy's
    first match and the optimal assignment can differ), and a dense band of
    unmapped returns in the north whose blob exceeds ``max_cluster_size``;
    C = 64 clusters, K = 96 slots, both z-slabs (11,000 cells)."""
    import numpy as np

    from multiple_object_tracking_lidar_tpu_torch.io.scenario import (
        Scenario,
        ScenarioObject,
    )
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask

    grid = load_sim_grid()
    cfg = bench_config()
    n_valid = 100_000
    rng = np.random.default_rng(7)
    objs = []
    for i in range(40):
        gx_i, gy_i = i % 8, i // 8
        objs.append(
            ScenarioObject(
                x0=-1.93 + 0.55 * gx_i,
                y0=0.2 + 1.06 * gy_i,
                vx=float(rng.uniform(-0.25, 0.25)),
                vy=float(rng.uniform(-0.25, 0.25)),
                points_per_frame=130,
                radius=0.30,
            )
        )
    n_obj_pts = 40 * 130
    n_clutter = 9000
    sc_dense = Scenario(
        grid=grid,
        objects=objs,
        static_points_per_frame=n_valid - n_obj_pts - n_clutter,
        clutter_points=n_clutter,
        clutter_bounds=(-2.2, 2.3, 6.3, 9.3),  # north band, clear of objects
        clutter_z=(0.0, 2.0),                  # both z-slabs
        seed=321,
    )
    cfg_dense = cfg.replace(
        caps=dataclasses.replace(cfg.caps, c_max_clusters=64, k_max_tracks=96),
        scene=SceneBounds(x_min=-2.4, x_max=2.5, y_min=-1.5, y_max=9.4, z_min=0.0, z_max=2.0),
    )
    env_dense = build_static_mask(grid, cfg_dense.static_tolarance, cfg_dense.occupied_threshold,
                                  device=device)
    return cfg_dense, env_dense, sc_dense


def dense_hungarian_case(device="cpu"):
    """The dense scene under ``association="hungarian"``."""
    cfg, env, sc = dense_case(device)
    return cfg.replace(association="hungarian"), env, sc


FLOOR_SEED = 16
FLOOR_M = 30.0          # the floor's side: 611 x 611 x 3 = 1,119,963 cells at the 0.05 m leaf
FLOOR_CELLS = 1_119_963
FLOOR_RES = 0.05        # the occupancy grid's resolution (m)


def floor_map(seed: int = FLOOR_SEED, size_m: float = FLOOR_M):
    """A synthetic occupancy grid of one office or warehouse floor, from
    ``seed``, numpy only: ``size_m`` square at 0.05 m, origin (0, 0),
    border walls 0.15 m thick, four interior walls 0.1 m thick with a 2 m
    door each, and pillars of 0.4 m; occupied 100, free 0, no unknown
    (int8).  Returns the port's ``OccupancyGrid``."""
    import numpy as np

    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import MapInfo, OccupancyGrid

    n = int(round(size_m / FLOOR_RES))
    data = np.zeros((n, n), np.int8)
    data[:3], data[-3:], data[:, :3], data[:, -3:] = 100, 100, 100, 100
    rng = np.random.default_rng(seed)
    for k in range(4):
        at = int(rng.integers(n // 5, 4 * n // 5))
        door = int(rng.integers(n // 8, n - n // 8 - 40))
        wall = np.ones(n, bool)
        wall[door:door + 40] = False
        if k % 2:
            data[at:at + 2, wall] = 100
        else:
            data[wall, at:at + 2] = 100
    for _ in range(max(1, int(size_m * size_m / 75))):
        r, c = rng.integers(10, n - 18, 2)
        data[r:r + 8, c:c + 8] = 100
    return OccupancyGrid(MapInfo(resolution=FLOOR_RES, width=n, height=n, origin_x=0.0,
                                 origin_y=0.0), data)


def floor_objects(grid, n_objects: int, seed: int):
    """``n_objects`` people-sized movers on the free floor of ``grid``,
    placed from ``seed``: at least 0.9 m apart (0.4 m between their 0.25 m
    disks) and 0.5 m from any occupied cell, walking one way at 0.35-0.45
    m/s (a crowd through a concourse: neighbours keep their distance over
    the frames)."""
    import numpy as np

    from multiple_object_tracking_lidar_tpu_torch.io.scenario import ScenarioObject

    info = grid.info
    occ = np.argwhere(grid.data > 50)
    occ_xy = np.stack([(occ[:, 1] + 0.5) * info.resolution + info.origin_x,
                       (occ[:, 0] + 0.5) * info.resolution + info.origin_y], 1)
    size = (info.width * info.resolution, info.height * info.resolution)
    rng = np.random.default_rng(seed)
    placed: list = []
    while len(placed) < n_objects:
        p = rng.uniform([0.5, 0.5], [size[0] - 0.5, size[1] - 0.5])
        if placed and np.min(np.hypot(*(np.asarray(placed) - p).T)) < 0.9:
            continue
        if np.min(np.hypot(*(occ_xy - p).T)) < 0.5:
            continue
        placed.append(p)
    speed = rng.uniform(0.35, 0.45, n_objects)
    heading = 0.3 + rng.uniform(-0.05, 0.05, n_objects)
    return [ScenarioObject(float(x), float(y), float(v * np.cos(h)), float(v * np.sin(h)))
            for (x, y), v, h in zip(placed, speed, heading)]


def floor_case(device="cpu", size_m: float = FLOOR_M, n_objects: int = 150,
               n_valid: int = 120_000, n_points: int = 131_072, clutter: int = 1_500,
               c_max: int = 256, k_max: int = 64):
    """(cfg, env, scenario) of one floor: ``bench_config()`` at the JAX
    default leaf (0.05 m, z-leaf 1.0 m) over ``floor_map``'s ``size_m``
    floor through ``SceneBounds.from_map`` (margin 0.25 m, z 0-2 m) -- a
    611 x 611 x 3 grid (``grid_shape``'s floor indexing; the scene's own
    ``grid_dims`` says 610 x 610 x 2) of 1,119,963 cells at 30 m, past K1's
    232,320-cell layouts and K2's 454,656 cells, so the digit sums run wide
    and the CC is K14 -- with
    ``n_objects`` movers (``floor_objects``), ``clutter`` sparse free-space
    returns, wall returns up to ``n_valid`` points in frames of
    ``n_points`` (``n_max_points``), ``c_max_clusters = c_max`` (D past 128)
    and ``k_max_tracks = k_max`` (the node grows it)."""
    from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape

    grid = floor_map(FLOOR_SEED, size_m)
    info = grid.info
    cfg = bench_config()
    cfg = cfg.replace(
        voxel_leaf_size=0.05,
        scene=SceneBounds.from_map(info.width, info.height, info.resolution, info.origin_x,
                                   info.origin_y),
        caps=dataclasses.replace(cfg.caps, n_max_points=n_points, c_max_clusters=c_max,
                                 k_max_tracks=k_max),
    )
    if size_m == FLOOR_M:
        gx, gy, gz = grid_shape(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
        assert gx * gy * gz == FLOOR_CELLS, (gx, gy, gz)
    objs = floor_objects(grid, n_objects, FLOOR_SEED + 1)
    sc = Scenario(
        grid=grid,
        objects=objs,
        static_points_per_frame=n_valid - sum(o.points_per_frame for o in objs) - clutter,
        clutter_points=clutter,
        clutter_bounds=(0.0, info.width * info.resolution, 0.0, info.height * info.resolution),
        seed=FLOOR_SEED + 2,
    )
    env = build_static_mask(grid, cfg.static_tolarance, cfg.occupied_threshold, device=device)
    return cfg, env, sc


FLOOR_GOLDEN_M = 16.0   # the goldens' cut floor: 331 x 331 x 3 = 328,683 cells
FLOOR_GOLDEN_FRAMES = 8


def floor_golden_case(device="cpu"):
    """The floor the JAX goldens are made on (tests/golden/torch_floor_*.npz):
    ``floor_case`` at ``FLOOR_GOLDEN_M`` with ``grid_cc="jnp"`` -- still
    past K1's 232,320 cells and on K14 as the full floor, its JAX stencil
    CC's pointer jump ((cells, gy * gz) one-hot products) small enough for
    the JAX package on a CPU."""
    cfg, env, sc = floor_case(device, size_m=FLOOR_GOLDEN_M)
    return cfg.replace(grid_cc="jnp"), env, sc


def floor_map_hash(grid) -> str:
    """The sha256 of a floor map's occupancy bytes and geometry (each floor
    golden stores its map's)."""
    import hashlib

    i = grid.info
    h = hashlib.sha256(repr((i.resolution, i.width, i.height, i.origin_x, i.origin_y)).encode())
    h.update(grid.data.tobytes())
    return h.hexdigest()


# tests/golden/torch_track_wide.npz's cases: (K, D, association, dtype) past
# K4's narrow builds, and their window length
TRACK_WIDE = [(k, d, a, dt) for k, d in ((2048, 32), (64, 256))
              for a in ("greedy", "hungarian") for dt in ("float32", "float64")]
TRACK_WIDE_L = 10


def track_wide_inputs(k: int, d: int, assoc: str, dtype: str):
    """Seeded inputs of a track_wide case: (bank fields, scalars, frames of
    (dets (d, 4), valid (d,), t)), numpy, built as tests/test_torch_faults.py
    builds F1's: some slots alive with a full window, every alive track
    seen in each frame (the last one twice, invalid lanes between where D is
    wide), new objects registering in the lowest free slots; three frames,
    one under hungarian at K > 1,024 (every phase of its auction runs to
    the cap)."""
    import numpy as np

    rng = np.random.default_rng(k * 7 + d)
    L = TRACK_WIDE_L
    dt = np.dtype(dtype)
    live = np.sort(rng.permutation(k)[: min(k // 2, d // 4)])
    xy = rng.uniform(-30, 30, (k, 2))
    window = np.zeros((k, L, 4), dt)
    for j in range(L):
        window[:, j, :2] = xy + 0.03 * j
        window[:, j, 3] = 1.0 - (L - 1 - j) * 0.1
    alive = np.zeros(k, bool)
    alive[live] = True
    birth = np.full(k, 2**30, np.int32)
    birth[live] = rng.permutation(len(live))
    bank = dict(alive=alive, obj_id=np.where(alive, np.arange(k) + 5, -1).astype(np.int32),
                birth_seq=birth, window=window,
                m0=rng.normal(0, 0.05, (k, 2, 2)).astype(dt))
    scal = dict(next_obj_num=np.int32(k + 5), next_birth=np.int32(len(live)),
                spin_counter=np.int32(0), initialized=np.bool_(True))
    frames = []
    for f in range(3):
        t = dt.type(1.1 + 0.1 * f)
        dets = rng.uniform(-30, 30, (d, 4)).astype(dt)
        valid = np.zeros(d, bool)
        lane = 0
        for s in live:
            for _ in range(2 if s == live[-1] else 1):
                if lane >= d:
                    break
                dets[lane] = [window[s, -1, 0] + 0.02 * (f + 1), window[s, -1, 1], 0.0, t]
                valid[lane] = True
                lane += 3 if d > 64 else 1
        for q in range(max(0, min(d - lane, 8))):
            dets[lane] = [40.0 + q, 40.0 + 10.0 * f, 0.0, t]
            valid[lane] = True
            lane += 1
        frames.append((dets, valid, t))
    return bank, scal, frames[:1] if assoc == "hungarian" and k > 1024 else frames


def track_scene(seed, cfg, K, D, B, S, fresh=(), dev="cpu", gated=False):
    """K4's inputs for B banks x S frames: (state, dets (B, S, D, 4), valid
    (B, S, D), t (B, S)).  Each bank starts with half its K slots alive
    (banks in ``fresh`` start empty: a first frame); each frame sees a few
    tracks, one of them three times (chained passes), registers new
    objects far away (past K free slots: overflow), has invalid lanes
    inside the bound and a NaN lane after it; frame 2 comes after a gap of
    6 periods (interpolation backfill) and frame 4 is empty.  With
    ``gated`` (the Hungarian builds' scene) the slots come in pairs 0.35 m
    apart and each seen track's detections fall within the gate of its
    last position, so that the auction has conflicts to resolve."""
    import numpy as np
    import torch

    from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
        init_state,
        map_state,
        stack_states,
    )

    rng = np.random.default_rng(seed)
    L = cfg.data_length
    states, D4, V, T = [], np.zeros((B, S, D, 4), np.float32), np.zeros((B, S, D), bool), []
    for b in range(B):
        st = init_state(K, L, torch.float32, "cpu")
        xy = rng.uniform(-40, 40, (K, 2)).astype(np.float32)
        if gated:
            xy[1::2] = xy[0::2][: K // 2] + np.float32([0.35, 0.0])
        if b not in fresh:
            live = rng.permutation(K)[: K // 2]
            w = np.zeros((K, L, 4), np.float32)
            for j in range(L):
                w[:, j, :2] = xy + np.float32(0.03) * j
                w[:, j, 3] = np.float32(1.0 - (L - 1 - j) * 0.1)
            alive = np.zeros(K, bool)
            alive[live] = True
            birth = np.full(K, 2**30, np.int32)
            birth[live] = rng.permutation(len(live))
            st = st._replace(
                bank=st.bank._replace(
                    alive=torch.from_numpy(alive),
                    obj_id=torch.from_numpy(np.where(alive, np.arange(K) + 5, -1).astype(np.int32)),
                    birth_seq=torch.from_numpy(birth), window=torch.from_numpy(w),
                    m0=torch.from_numpy(rng.normal(0, 0.05, (K, 2, 2)).astype(np.float32))),
                next_obj_num=torch.tensor(K + 5, dtype=torch.int32),
                next_birth=torch.tensor(len(live), dtype=torch.int32),
                initialized=torch.tensor(True))
        states.append(st)
        alive_now = np.flatnonzero(st.bank.alive.numpy())
        t, ts = 1.0, []
        for s in range(S):
            t += 0.7 if s == 2 else 0.1
            ts.append(t)
            D4[b, s] = rng.uniform(-60, 60, (D, 4))
            D4[b, s, D - 1, 0] = np.nan
            if s == 4:
                continue
            lane = 0
            seen = rng.permutation(alive_now)[: min(len(alive_now), D // 4)] if len(alive_now) else []
            for q, k in enumerate(seen):
                for _ in range(3 if q == 0 else 1):
                    if lane >= D - 2:
                        break
                    dy = 0.03 * (L - 1) + rng.normal(0, 0.1) if gated else rng.normal(0, 0.02)
                    D4[b, s, lane] = [xy[k, 0] + 0.03 * (L + s), xy[k, 1] + dy, 0.0, t]
                    V[b, s, lane] = True
                    lane += 2 if q % 3 == 1 else 1        # invalid lanes inside the bound
            n_new = min(D - 2 - lane, 4 if s % 2 else D // 2)
            for q in range(n_new):
                D4[b, s, lane] = [100.0 + 2.0 * q, 100.0 + 5.0 * s + 50.0 * b, 0.0, t]
                V[b, s, lane] = True
                lane += 1
        T.append(ts)
    return (map_state(lambda x: x.to(dev), stack_states(states)), torch.from_numpy(D4).to(dev),
            torch.from_numpy(V).to(dev), torch.tensor(T, dtype=torch.float32, device=dev))


def k2_grids(cfg):
    """(label, dims, leaf, leaf_z) of the grids K2 is checked on: the
    headline's 5,500 cells, the JAX fused CC's bound (32,768), the CLI's
    grid on the sim map (70,200) and the default scene's (193,536)."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape

    g = TrackerConfig()
    return (("headline", grid_shape(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z),
             cfg.voxel_leaf_size, cfg.leaf_z, cfg.cluster_tolerance),
            ("the JAX bound", (128, 256, 1), 0.05, 2.0, 0.15),
            ("CLI grid", (104, 225, 3), 0.05, 1.0, 0.15),
            ("default scene", grid_shape(g.scene, g.voxel_leaf_size, g.leaf_z),
             g.voxel_leaf_size, g.leaf_z, g.cluster_tolerance))


def digit_grids(cfg):
    """(label, scene, leaf_xy, leaf_z, case) of the grids K1 and K5 are
    checked on: ``k2_grids``' dims as scenes whose corner is the headline
    scene's (so the headline frames land in them), the default scene's
    itself; ``case`` names the bench case whose frames feed the grid."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape

    out = []
    for label, dims, leaf, leaf_z, _ in k2_grids(cfg):
        if label == "headline":
            scene, case = cfg.scene, "headline"
        elif label == "default scene":
            scene, case = TrackerConfig().scene, "default"
        else:
            x0, y0, z0 = cfg.scene.x_min, cfg.scene.y_min, cfg.scene.z_min
            scene = SceneBounds(x_min=x0, x_max=x0 + (dims[0] - 0.5) * leaf,
                                y_min=y0, y_max=y0 + (dims[1] - 0.5) * leaf,
                                z_min=z0, z_max=z0 + (dims[2] - 0.5) * leaf_z)
            case = "headline"
        assert grid_shape(scene, leaf, leaf_z) == dims, (label, dims)
        out.append((label, scene, leaf, leaf_z, case))
    return tuple(out)


def k2_inputs(dims, leaf, leaf_z, tol, seed, dev, s_frames=3):
    """K2's inputs on a grid of ``dims`` with a table that keeps every
    occupied cell dynamic (the map transform sends every centroid to pixel
    (0, 0) of a 1 x 1 window whose bit is 0): frame 0 blobs of 30-400
    cells and clutter, frame 1 every cell occupied at its centre (one
    component across every rank), frame 2 each cell with probability 0.55
    (a percolating tangle).  Returns (accs, scal, base_row, base_col,
    bits, kwin)."""
    import numpy as np
    import torch

    gx, gy, gz = dims
    n = gx * gy * gz
    rng = np.random.default_rng(seed)
    lin = np.arange(n)
    ix, iy, iz = lin % gx, (lin // gx) % gy, lin // (gx * gy)
    centre = np.stack([(ix + 0.5) * leaf, (iy + 0.5) * leaf, (iz + 0.5) * leaf_z]).astype(np.float32)
    accs = np.zeros((s_frames, 4, n), np.float32)
    occ = np.zeros(n, bool)
    for _ in range(max(4, n // 2000)):
        cx, cy, cz = rng.integers(0, gx), rng.integers(0, gy), rng.integers(0, gz)
        r = rng.integers(2, 12)
        occ |= ((ix - cx) ** 2 + (iy - cy) ** 2 <= r * r) & (np.abs(iz - cz) <= 1)
    occ |= rng.random(n) < 0.01
    for f, o in enumerate((occ, np.ones(n, bool), rng.random(n) < 0.55)[:s_frames]):
        cnt = np.where(o, rng.integers(1, 9, n), 0).astype(np.float32)
        jitter = rng.normal(0, 0.2, (3, n)).astype(np.float32) * np.float32(leaf)
        accs[f, :3] = (centre + jitter) * cnt
        accs[f, 3] = cnt
    z = torch.zeros(n, dtype=torch.int32, device=dev)
    scal = torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0, tol * tol], dtype=torch.float32, device=dev)
    return torch.from_numpy(accs).to(dev), scal, z, z.clone(), z.clone(), 1


def k3f_edge_tables(seed: int, p: int, c: int = 32):
    """(mpts (C, P, 3) f64, mask (C, P) bool) numpy member tables on the
    edges of K3f's half and table builds (cast them to the dtype under
    test), slot by slot, cycling through: members scattered with gaps in
    lane order; an active slot with a NaN and an inf in non-member lanes
    (its mean, and so every d2, NaN); empty slots whose row 0 holds a NaN
    in x, in y, or an inf; d2 ties (a square's corners, a 0.25 m lattice,
    duplicated members); coordinates 150-400 from the mean (f16's squared
    norms overflow: d2 inf or NaN); a singleton and a pair behind a NaN
    row 0 (the picks fall back to it); then, in the last two slots, a full
    slot and up to 300 members scattered over the lanes (past one 32 x 32
    tile).  Every case fits any P >= 4 and C >= 14."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mp = np.zeros((c, p, 3))
    mm = np.zeros((c, p), bool)

    def gaps(k, n):
        lanes = np.sort(rng.choice(p, min(n, p), replace=False))
        mp[k, lanes] = rng.uniform(-15, 15, 3) + rng.normal(0, 0.6, (len(lanes), 3))
        mm[k, lanes] = True

    def nonfinite(k):
        mp[k] = rng.normal(0, 1, (p, 3))
        mm[k, : min(p, 24)] = True
        mm[k, [1, 3]] = False
        mp[k, 1, 0], mp[k, 3, 1] = np.nan, np.inf

    def empty_row0(k, row0):
        mp[k, 0] = row0
        mp[k, 1:] = rng.normal(0, 1, (p - 1, 3))

    def ties(k, kind):
        if kind == 0:     # a square's corners: both diagonals tie, a lane skipped
            pts = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]]
            lanes = [0, 1, 3, 4] if p > 4 else [0, 1, 2, 3]
        elif kind == 1:   # a 0.25 m lattice
            g = np.stack(np.meshgrid(np.arange(4), np.arange(3), np.arange(2)), -1)
            pts = 0.25 * g.reshape(-1, 3)[: p]
            lanes = list(range(len(pts)))
        else:             # members duplicated: equal rows, equal d2
            base = rng.normal(0, 1, (3, 3))
            pts = np.concatenate([base, base, base[::-1]])[: p]
            lanes = list(range(len(pts)))
        mp[k, lanes] = pts
        mm[k, lanes] = True

    def overflow(k, n):
        lanes = np.sort(rng.choice(p, min(n, p), replace=False))
        sign = np.where(rng.random(len(lanes)) < 0.3, -1.0, 1.0)
        mp[k, lanes] = np.stack([sign * rng.uniform(150, 400, len(lanes)),
                                 rng.uniform(-5, 5, len(lanes)), np.zeros(len(lanes))], 1)
        mm[k, lanes] = True

    def behind_nan_row0(k, lanes):
        mp[k] = rng.normal(0, 1, (p, 3))
        mp[k, 0] = [np.nan, 0.5, 0.5]
        mm[k, lanes] = True

    cases = [lambda k: gaps(k, 40), nonfinite, lambda k: empty_row0(k, [np.nan, 1.0, 2.0]),
             lambda k: empty_row0(k, [1.0, np.nan, 2.0]),
             lambda k: empty_row0(k, [np.inf, 0.0, 0.0]), lambda k: ties(k, 0),
             lambda k: ties(k, 1), lambda k: ties(k, 2), lambda k: overflow(k, 12),
             lambda k: behind_nan_row0(k, [p // 2]), lambda k: behind_nan_row0(k, [2, p - 1]),
             lambda k: overflow(k, 60)]
    for k in range(c - 2):
        cases[k % len(cases)](k)
    mp[c - 2] = rng.uniform(-3, 3, (p, 3))
    mm[c - 2] = True
    gaps(c - 1, 300)
    return mp, mm
