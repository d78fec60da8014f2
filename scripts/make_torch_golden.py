"""Write the JAX package's outputs on the headline scene as golden files
for the PyTorch/CUDA port.

The machine with the GPU has no JAX, so the port is held against these
committed outputs there (chip_smoke.py).  Each golden runs the JAX package
on the CPU over the first 12 frames of ``bench.headline_case()`` (full
headline size: 106,496-point frames, C = 32, P = 384, K = 64) and stores
every FrameOutput field stacked over frames:

- ``slice``: the headline config through ``Tracker.bind_env``
  -> ``tests/golden/torch_slice_headline.npz``;
- ``exact``: ``voxel_quant="exact"`` through ``Tracker.bind_env_multi(
  hoist="on")``, which runs the stacked v6 kernel (interpret mode) -- the
  TPU's program; ``bind_env`` on the CPU would take the bf16x3 jnp
  lowering instead -> ``tests/golden/torch_exact_headline.npz``;
- ``runs``: ``voxel_mode="runs"`` through ``Tracker.bind_env`` (the sort +
  segment-totals kernel in interpret mode)
  -> ``tests/golden/torch_runs_headline.npz``;
- the point-list configurations, each through ``Tracker.bind_env`` (the
  Pallas CC in interpret mode where the backend is "pallas"):
  ``pointlist`` (C: ``voxel_mode="dense"``, ``cluster_backend="pallas"``)
  -> ``torch_pointlist_headline.npz``; ``pointlist_scan`` (E: "scan",
  "jnp") -> ``torch_pointlist_scan_headline.npz``; ``pointlist_runs`` (F:
  "runs", "pallas") -> ``torch_pointlist_runs_headline.npz``; ``default``
  (G: ``TrackerConfig()`` itself on the sim map, the headline frames padded
  to its 131,072 points, 4 frames) -> ``torch_default_headline.npz``.
  Configuration D ("dense", "jnp") shares C's golden: the CC backends give
  the same labels, and neither saturates;
- ``fleet``: the headline config through the JAX kernel fleet,
  ``ShardedTracker(make_mesh(1, 1), kernel_path="on")``, B = 8 streams
  over 3 steps, stream s at step k fed headline frame 3 s + k (the raw
  stacked kernels in interpret mode, one finalize, the stacked fused CC)
  -> ``tests/golden/torch_fleet_headline.npz``, every field stacked as
  (steps, streams, ...);
- ``growth``: the JAX ``TrackerNode`` on the headline config with
  ``k_max_tracks=2`` (its default ``grow_bank_on_overflow`` doubles the
  bank when a frame overflows) over 12 headline PointCloud2 frames: every
  FrameOutput field per frame, plus ``n_growths`` and ``k_max_tracks``
  after each frame -> ``tests/golden/torch_growth_headline.npz``;
- ``ihgp``: the headline config with ``position_filter="ihgp"`` through
  ``Tracker.bind_env`` -> ``tests/golden/torch_ihgp_headline.npz``;
- ``hungarian``: the headline config with ``association="hungarian"``
  through ``Tracker.bind_env`` -> ``tests/golden/torch_hungarian_headline.npz``;
- ``dense_hungarian``: ``bench.dense_case()`` (40 objects 0.55 m apart,
  C = 64, K = 96, both z-slabs) with ``association="hungarian"`` through
  ``Tracker.bind_env``, 8 frames -> ``tests/golden/torch_hungarian_dense.npz``;
- ``f64``: the headline config with ``dtype="float64"`` through
  ``Tracker.bind_env`` (jax_enable_x64 on; the frames as the others, f32
  points and stamps, which both packages cast) ->
  ``tests/golden/torch_f64_headline.npz``;
- ``f64_hungarian_ihgp``: the same under ``association="hungarian"`` and
  ``position_filter="ihgp"`` -> ``tests/golden/torch_f64_hungarian_ihgp_headline.npz``;
- the f64 point list and modes, each ``CASE_FIELDS`` of its f32 case plus
  ``dtype="float64"`` through ``Tracker.bind_env`` (x64 on), 4 frames:
  ``f64_default`` (G: ``TrackerConfig(dtype="float64")``) ->
  ``torch_f64_default_headline.npz``, ``f64_pointlist`` (C),
  ``f64_pointlist_scan`` (E), ``f64_pointlist_runs`` (F), ``f64_exact`` and
  ``f64_runs`` -> ``torch_f64_{pointlist,pointlist_scan,pointlist_runs,
  exact,runs}_headline.npz`` (``f64_exact`` through ``bind_env``: the JAX
  f64 exact route is its one-hot contraction, no TPU program);
- ``cli_f64_default``: the JAX CLI ``run`` with a config file ``dtype:
  float64`` and no ``--backend grid`` (the point list of
  ``TrackerConfig(dtype="float64")``), 8 frames ->
  ``torch_cli_f64_default_headline.json``;
- ``cli``, ``cli_ihgp``, ``cli_hungarian`` and ``cli_f64``: the JAX CLI, ``run --map
  assets/sim_map.yaml --backend grid --bag <16 headline frames> --frames
  16`` (the default ``TrackerConfig()``; ``cli_ihgp`` and
  ``cli_hungarian`` with a config file that sets ``position_filter: ihgp``
  or ``association: hungarian``, ``cli_f64`` one that sets ``dtype:
  float64``, x64 on), on the CPU: its JSON lines, and beside each
  obstacle its unrounded speed (``hypot(vx, vy)`` of the published
  velocity, before the label's rounding) ->
  ``tests/golden/torch_cli{,_ihgp,_hungarian,_f64}_headline.json``.  The bag is the
  headline scenario's ``frame(k)`` PointCloud2 messages, 100,000 points
  each, recorded by ``io/bag.py`` (``cli_bag``);
- ``learning``: the headline config with ``param_fix=False`` and
  ``learn_period=0.2`` (``LEARN_PERIOD``) through the JAX ``TrackerNode``
  over 16 headline PointCloud2 frames: every FrameOutput field per frame
  (the steps ``bind_env_gains`` makes), and per update the frame it
  followed (``update_frame``), the log-parameters after it
  (``log_params``, (updates, 2, 3): x then y) and the node's
  ``nll_history`` entry ((updates, 2): t, mean NLL) ->
  ``tests/golden/torch_learning_headline.npz``;
- ``cli_tune``: the JAX CLI's ``tune --map assets/sim_map.yaml`` at its
  defaults (``TrackerConfig()``, ``--frames 60 --steps 30``): its JSON
  lines -> ``tests/golden/torch_cli_tune.json``;
- ``bf16_learning`` and ``f16_learning``: the ``learning`` golden under
  ``dtype`` bf16 / f16 (the half fields widened to f32) ->
  ``tests/golden/torch_{bf16,f16}_learning_headline.npz``;
  ``cli_bf16_tune`` and ``cli_f16_tune``: ``cli_tune`` with a config file
  setting the dtype -> ``tests/golden/torch_cli_{bf16,f16}_tune.json``;
- ``floor``, ``floor_hungarian`` and ``floor_f64``: the floor case
  (``bench_cases.floor_golden_case``: ``floor_map`` rebuilt from its seed,
  150 movers, C = 256 past K4's 128 detections, K = 64) at the goldens'
  cut floor of 16 m (328,683 cells, the JAX stencil CC), greedy f32, under
  ``association="hungarian"`` and under ``dtype="float64"`` through
  ``Tracker.bind_env``, 8 frames, with the map's hash (``map_hash``) ->
  ``tests/golden/torch_floor{,_hungarian,_f64}_headline.npz``;
- ``track_wide``: the JAX ``track_step`` (jitted) on seeded synthetic frames
  (``bench_cases.track_wide_inputs``) at (K, D) = (2,048, 32) and (64,
  256), greedy and Hungarian, f32 and f64: each case's outputs and final
  bank under its own key prefix -> ``tests/golden/torch_track_wide.npz``;
- ``{bf16,f16}_hungarian``, ``{bf16,f16}_dense_hungarian`` and
  ``{bf16,f16}_fleet``: the ``hungarian``, ``dense_hungarian`` and ``fleet``
  goldens under ``dtype`` bf16 / f16 (the fleet the JAX vmap fleet, B = 8 x
  3 steps; half fields widened to f32) ->
  ``tests/golden/torch_{bf16,f16}_{hungarian_headline,hungarian_dense,
  fleet_headline}.npz``;
- ``bf16`` and ``f16``: the headline under ``dtype="bfloat16"`` /
  ``"float16"`` through ``Tracker.bind_env``, lpf and ihgp (each field under
  ``lpf/`` or ``ihgp/``, the half fields widened to f32: the card's numpy
  reads no bf16), 12 frames -> ``tests/golden/torch_{bf16,f16}_headline.npz``;
  ``cli_bf16`` and ``cli_f16``: the JAX CLI under a config file setting the
  dtype -> ``tests/golden/torch_cli_{bf16,f16}_headline.json``;
- the half perception front ends, each ``CASE_FIELDS`` of its f32 case plus
  ``dtype`` bf16 / f16 through ``Tracker.bind_env`` (stamps in the half
  dtype; the half fields widened to f32), 12 frames:
  ``{bf16,f16}_pointlist`` (C), ``_pointlist_jnp`` (D: under half its
  adjacency is the half gram, which joins other voxels than the Pallas
  CC's f32 one), ``_pointlist_scan`` (E), ``_pointlist_runs`` (F),
  ``_runs`` (B), ``_dense_grid`` ("dense", "grid") and ``_default`` (G:
  ``TrackerConfig(dtype=...)``, 4 frames) ->
  ``tests/golden/torch_{bf16,f16}_<case>_headline.npz``;
  ``cli_bf16_default`` and ``cli_f16_default``: the JAX CLI ``run`` with a
  config file setting the dtype and no ``--backend grid`` (the point list),
  8 frames -> ``tests/golden/torch_cli_{bf16,f16}_default_headline.json``.

tests/test_torch_golden.py recomputes the first frames and checks them
against the files.

    python scripts/make_torch_golden.py [slice] [exact] [runs] [pointlist] ... [growth]  # default: all
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
GOLDENS = {
    "slice": os.path.join(GOLDEN_DIR, "torch_slice_headline.npz"),
    "exact": os.path.join(GOLDEN_DIR, "torch_exact_headline.npz"),
    "runs": os.path.join(GOLDEN_DIR, "torch_runs_headline.npz"),
    "pointlist": os.path.join(GOLDEN_DIR, "torch_pointlist_headline.npz"),
    "pointlist_scan": os.path.join(GOLDEN_DIR, "torch_pointlist_scan_headline.npz"),
    "pointlist_runs": os.path.join(GOLDEN_DIR, "torch_pointlist_runs_headline.npz"),
    "default": os.path.join(GOLDEN_DIR, "torch_default_headline.npz"),
    "fleet": os.path.join(GOLDEN_DIR, "torch_fleet_headline.npz"),
    "growth": os.path.join(GOLDEN_DIR, "torch_growth_headline.npz"),
    "ihgp": os.path.join(GOLDEN_DIR, "torch_ihgp_headline.npz"),
    "cli": os.path.join(GOLDEN_DIR, "torch_cli_headline.json"),
    "cli_ihgp": os.path.join(GOLDEN_DIR, "torch_cli_ihgp_headline.json"),
    "hungarian": os.path.join(GOLDEN_DIR, "torch_hungarian_headline.npz"),
    "dense_hungarian": os.path.join(GOLDEN_DIR, "torch_hungarian_dense.npz"),
    "cli_hungarian": os.path.join(GOLDEN_DIR, "torch_cli_hungarian_headline.json"),
    "f64": os.path.join(GOLDEN_DIR, "torch_f64_headline.npz"),
    "f64_hungarian_ihgp": os.path.join(GOLDEN_DIR, "torch_f64_hungarian_ihgp_headline.npz"),
    "cli_f64": os.path.join(GOLDEN_DIR, "torch_cli_f64_headline.json"),
    **{case: os.path.join(GOLDEN_DIR, f"torch_{case}_headline.npz") for case in (
        "f64_default", "f64_pointlist", "f64_pointlist_scan", "f64_pointlist_runs",
        "f64_exact", "f64_runs")},
    "cli_f64_default": os.path.join(GOLDEN_DIR, "torch_cli_f64_default_headline.json"),
    "learning": os.path.join(GOLDEN_DIR, "torch_learning_headline.npz"),
    "cli_tune": os.path.join(GOLDEN_DIR, "torch_cli_tune.json"),
    **{f"{h}_learning": os.path.join(GOLDEN_DIR, f"torch_{h}_learning_headline.npz")
       for h in ("bf16", "f16")},
    **{f"cli_{h}_tune": os.path.join(GOLDEN_DIR, f"torch_cli_{h}_tune.json")
       for h in ("bf16", "f16")},
    "floor": os.path.join(GOLDEN_DIR, "torch_floor_headline.npz"),
    "floor_hungarian": os.path.join(GOLDEN_DIR, "torch_floor_hungarian_headline.npz"),
    "floor_f64": os.path.join(GOLDEN_DIR, "torch_floor_f64_headline.npz"),
    "track_wide": os.path.join(GOLDEN_DIR, "torch_track_wide.npz"),
    "bf16": os.path.join(GOLDEN_DIR, "torch_bf16_headline.npz"),
    "f16": os.path.join(GOLDEN_DIR, "torch_f16_headline.npz"),
    "cli_bf16": os.path.join(GOLDEN_DIR, "torch_cli_bf16_headline.json"),
    "cli_f16": os.path.join(GOLDEN_DIR, "torch_cli_f16_headline.json"),
    **{f"{h}_{case}": os.path.join(GOLDEN_DIR, f"torch_{h}_{case}_headline.npz")
       for h in ("bf16", "f16") for case in (
           "pointlist", "pointlist_jnp", "pointlist_scan", "pointlist_runs", "runs",
           "dense_grid", "default")},
    **{f"cli_{h}_default": os.path.join(GOLDEN_DIR, f"torch_cli_{h}_default_headline.json")
       for h in ("bf16", "f16")},
    **{f"{h}_{case}": os.path.join(GOLDEN_DIR, f"torch_{h}_{name}.npz")
       for h in ("bf16", "f16") for case, name in (
           ("hungarian", "hungarian_headline"), ("dense_hungarian", "hungarian_dense"),
           ("fleet", "fleet_headline"))},
}
# the half goldens: one file per dtype, a variant per position filter, each
# field stored as "<variant>/<field>", half arrays widened to f32 (exactly:
# the card's numpy has no bf16)
HALF_DTYPES = {"bf16": "bfloat16", "f16": "float16"}
HALF_VARIANTS = {"lpf": {}, "ihgp": {"position_filter": "ihgp"}}
FLOOR_FIELDS = {"floor": {}, "floor_hungarian": {"association": "hungarian"},
                "floor_f64": {"dtype": "float64"}}

CLI_FRAMES = 16
CLI_IHGP_CONFIG = "position_filter: ihgp\n"   # the cli_ihgp config file's text
CLI_CONFIGS = {"cli_ihgp": CLI_IHGP_CONFIG,   # each CLI golden's config file, if any
               "cli_hungarian": "association: hungarian\n",
               "cli_f64": "dtype: float64\n",
               "cli_f64_default": "dtype: float64\n",
               "cli_bf16": "dtype: bfloat16\n",
               "cli_f16": "dtype: float16\n",
               "cli_bf16_default": "dtype: bfloat16\n",
               "cli_f16_default": "dtype: float16\n",
               "cli_bf16_tune": "dtype: bfloat16\n",
               "cli_f16_tune": "dtype: float16\n"}
# the CLI goldens without --backend grid
CLI_POINTLIST = ("cli_f64_default", "cli_bf16_default", "cli_f16_default")
GROWTH_K0 = 2   # the growth golden's initial k_max_tracks
N_FRAMES = 12
# frames (the fleet: steps) per golden where not N_FRAMES
FRAMES = {"default": 4, "fleet": 3, "dense_hungarian": 8, "bf16_dense_hungarian": 8,
          "f16_dense_hungarian": 8, "bf16_fleet": 3, "f16_fleet": 3, "f64_default": 4,
          "f64_pointlist": 4,
          "f64_pointlist_scan": 4, "f64_pointlist_runs": 4, "f64_exact": 4, "f64_runs": 4,
          "cli_f64_default": 8, "learning": 16, "floor": 8, "floor_hungarian": 8,
          "floor_f64": 8, "bf16_default": 4, "f16_default": 4, "cli_bf16_default": 8,
          "cli_f16_default": 8, "bf16_learning": 16, "f16_learning": 16}
LEARN_PERIOD = 0.2   # the learning golden's learn_period (s): an update every 2 frames
TUNE_ARGV = ["tune", "--map", "assets/sim_map.yaml"]   # cli_tune: the JAX defaults
FLEET_STREAMS = 8
# the headline config's fields changed for each case ("pointlist_jnp" is
# configuration D, checked against the "pointlist" golden)
CASE_FIELDS = {
    "slice": {},
    "exact": {"voxel_quant": "exact"},
    "runs": {"voxel_mode": "runs"},
    "pointlist": {"voxel_mode": "dense", "cluster_backend": "pallas"},
    "pointlist_jnp": {"voxel_mode": "dense", "cluster_backend": "jnp"},
    "pointlist_scan": {"voxel_mode": "scan", "cluster_backend": "jnp"},
    "pointlist_runs": {"voxel_mode": "runs", "cluster_backend": "pallas"},
    "ihgp": {"position_filter": "ihgp"},
    "hungarian": {"association": "hungarian"},
    "dense_hungarian": {"association": "hungarian"},
    "f64": {"dtype": "float64"},
    "f64_hungarian_ihgp": {"dtype": "float64", "association": "hungarian",
                           "position_filter": "ihgp"},
    "f64_default": {"dtype": "float64"},     # on TrackerConfig(), as "default"
}
for _case in ("pointlist", "pointlist_scan", "pointlist_runs", "exact", "runs"):
    CASE_FIELDS[f"f64_{_case}"] = {**CASE_FIELDS[_case], "dtype": "float64"}
CASE_FIELDS["dense_grid"] = {"voxel_mode": "dense", "cluster_backend": "grid"}
# the half front ends (on TrackerConfig() for "default", as "default")
for _h, _dt in HALF_DTYPES.items():
    for _case in ("pointlist", "pointlist_jnp", "pointlist_scan", "pointlist_runs", "runs",
                  "dense_grid"):
        CASE_FIELDS[f"{_h}_{_case}"] = {**CASE_FIELDS[_case], "dtype": _dt}
    CASE_FIELDS[f"{_h}_default"] = {"dtype": _dt}
    CASE_FIELDS[f"{_h}_hungarian"] = {"association": "hungarian", "dtype": _dt}
    CASE_FIELDS[f"{_h}_dense_hungarian"] = {"association": "hungarian", "dtype": _dt}


def uses_f64(case: str) -> bool:
    """True iff the golden runs dtype="float64" (JAX then needs x64 on)."""
    return "f64" in case or case == "track_wide"


def n_frames_of(case: str) -> int:
    return FRAMES.get(case, N_FRAMES)


def _frame(sc, k: int, n: int):
    """Headline frame k zero-padded to n points: (points, mask, t)."""
    import numpy as np

    pts, t = sc.frame_arrays(k)
    buf = np.zeros((n, 3), np.float32)
    buf[: len(pts)] = pts[:n]
    mask = np.zeros(n, bool)
    mask[: min(len(pts), n)] = True
    return buf, mask, np.float32(t)


def fleet_outputs(n_steps: int, n_streams: int = FLEET_STREAMS, dtype: str | None = None) -> dict:
    """{field: (n_steps, n_streams, ...) array} of the JAX kernel fleet on
    the headline config; stream s at step k gets headline frame 3 s + k.
    Under a half ``dtype`` the JAX fleet is its vmap form (the kernel fleet
    needs f32) and the half fields are widened to f32."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker

    cfg, env, sc = bench.headline_case()
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    fleet = ShardedTracker(Tracker(cfg), make_mesh(1, 1),
                           kernel_path="on" if dtype is None else "off")
    hd = jnp.dtype(dtype or "float32")
    state = fleet.init_state(n_streams)
    rows = []
    for k in range(n_steps):
        frames = [_frame(sc, 3 * s + k, cfg.caps.n_max_points) for s in range(n_streams)]
        pts, mask, ts = (np.stack([f[i] for f in frames]) for i in range(3))
        state, out = fleet.step(state, jnp.asarray(pts), jnp.asarray(mask),
                                jnp.asarray(ts).astype(hd), env)
        rows.append(jax.tree.map(np.asarray, out))
    stacked = {f: np.stack([getattr(r, f) for r in rows]) for f in rows[0]._fields}
    return {f: a.astype(np.float32) if a.dtype == hd != np.float32 else a
            for f, a in stacked.items()}


def node_outputs(node, grid, frames) -> dict:
    """Give a JAX ``TrackerNode`` the map ``grid``, then the PointCloud2
    ``frames``: {field: (n_frames, ...)} of the FrameOutput of every step
    it took, plus ``n_growths`` and ``k_max_tracks`` after each frame.  The
    steps are recorded where ``Tracker.bind_env`` makes them, so the step a
    bank growth rebinds is recorded too."""
    import jax
    import numpy as np

    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker

    rows, growths, ks = [], [], []
    bind_env, bind_env_gains = Tracker.bind_env, Tracker.bind_env_gains

    def recording(self, env, **kw):
        step = bind_env(self, env, **kw)

        def rec(state, frame):
            state, out = step(state, frame)
            rows.append(jax.tree.map(np.asarray, out))
            return state, out

        return rec

    def recording_gains(self, env, **kw):
        step = bind_env_gains(self, env, **kw)

        def rec(state, frame, gains):
            state, out = step(state, frame, gains)
            rows.append(jax.tree.map(np.asarray, out))
            return state, out

        return rec

    Tracker.bind_env, Tracker.bind_env_gains = recording, recording_gains
    try:
        node.on_map(grid)
        for msg in frames:
            node.on_pointcloud(msg)
            growths.append(node.n_growths)
            ks.append(node.config.caps.k_max_tracks)
    finally:
        Tracker.bind_env, Tracker.bind_env_gains = bind_env, bind_env_gains
    out = {f: np.stack([getattr(r, f) for r in rows]) for f in rows[0]._fields}
    out["n_growths"] = np.asarray(growths, np.int32)
    out["k_max_tracks"] = np.asarray(ks, np.int32)
    return out


def growth_outputs(n_frames: int) -> dict:
    """The ``growth`` golden's arrays over the first n_frames frames."""
    import dataclasses

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode

    cfg, _, sc = bench.headline_case()
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, k_max_tracks=GROWTH_K0))
    return node_outputs(TrackerNode(cfg), sc.grid, [sc.frame(k) for k in range(n_frames)])


def learning_outputs(n_frames: int, dtype: str | None = None) -> dict:
    """The ``learning`` golden's arrays over the first n_frames frames
    (``dtype``: the compute dtype, the half fields widened to f32)."""
    import numpy as np

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode

    cfg, _, sc = bench.headline_case()
    cfg = cfg.replace(param_fix=False, learn_period=LEARN_PERIOD)
    node = TrackerNode(cfg if dtype is None else cfg.replace(dtype=dtype))
    seen, update_frame, log_params = [], [], []
    on_pointcloud = node.on_pointcloud

    def recording(msg):
        n0 = len(node.nll_history)
        res = on_pointcloud(msg)
        seen.append(msg)
        if len(node.nll_history) > n0:
            update_frame.append(len(seen) - 1)
            log_params.append(np.stack([node.log_params["x"], node.log_params["y"]]))
        return res

    node.on_pointcloud = recording
    out = node_outputs(node, sc.grid, [sc.frame(k) for k in range(n_frames)])
    del out["n_growths"], out["k_max_tracks"]
    if dtype is not None:
        import jax.numpy as jnp

        hd = jnp.dtype(dtype)
        out = {f: a.astype(np.float32) if a.dtype == hd else a for f, a in out.items()}
    out["update_frame"] = np.asarray(update_frame, np.int32)
    out["log_params"] = np.asarray(log_params, np.float32)
    out["nll_history"] = np.asarray(node.nll_history, np.float64)
    return out


def tune_outputs(steps: int | None = None, case: str = "cli_tune") -> dict:
    """The JAX CLI's ``tune`` at ``TUNE_ARGV`` (``steps`` cuts ``--steps``;
    ``case``'s config file, if ``CLI_CONFIGS`` has one): {"argv": its
    arguments, the config file as ``<its text>``, "records": its JSON
    lines}."""
    import contextlib
    import io
    import json
    import tempfile

    sys.path.insert(0, REPO)
    from multiple_object_tracking_lidar_tpu.runtime.cli import main as jmain

    argv = TUNE_ARGV + ([] if steps is None else ["--steps", str(steps)])
    out = io.StringIO()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        extra = []
        if case in CLI_CONFIGS:
            extra = ["--config", os.path.join(tmp, "config.yaml")]
            with open(extra[1], "w", encoding="utf-8") as fh:
                fh.write(CLI_CONFIGS[case])
        os.chdir(REPO)
        try:
            with contextlib.redirect_stdout(out):
                assert jmain(argv + extra) == 0
        finally:
            os.chdir(cwd)
    return {"argv": argv + (["--config", f"<{CLI_CONFIGS[case].strip()}>"] if extra else []),
            "records": [json.loads(x) for x in out.getvalue().splitlines()
                        if x.startswith("{")]}


def cli_bag(path: str, n_frames: int = CLI_FRAMES, grid: bool = True) -> list[str]:
    """Record the first n_frames headline PointCloud2 frames to the npz bag
    ``path`` (the port's io/bag.py, a pinned copy of the JAX package's);
    returns the CLI arguments that replay it on the dense grid (on the
    config's own backend where not ``grid``)."""
    sys.path.insert(0, REPO)
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import SIM_MAP, headline_case
    from multiple_object_tracking_lidar_tpu_torch.io.bag import record_bag

    _, _, sc = headline_case()
    record_bag(path, [sc.frame(k) for k in range(n_frames)])
    backend = ["--backend", "grid"] if grid else []
    return ["run", "--map", SIM_MAP, *backend, "--bag", path, "--frames", str(n_frames)]


def cli_outputs(case: str, n_frames: int | None = None) -> dict:
    """The JAX CLI's run on the ``cli_bag`` frames: {"argv": the CLI
    arguments after the bag's, "records": the JSON lines, "speeds": per
    record the unrounded speed of each obstacle}."""
    import contextlib
    import io
    import json
    import tempfile

    import jax
    import numpy as np

    sys.path.insert(0, REPO)
    from multiple_object_tracking_lidar_tpu.runtime import node as jnode
    from multiple_object_tracking_lidar_tpu.runtime.cli import main as jmain

    if uses_f64(case):
        jax.config.update("jax_enable_x64", True)
    n_frames = FRAMES.get(case, CLI_FRAMES) if n_frames is None else n_frames
    grid = case not in CLI_POINTLIST
    speeds = []
    on_pointcloud = jnode.TrackerNode.on_pointcloud

    def recording(self, msg):
        res = on_pointcloud(self, msg)
        if res is not None:
            speeds.append([float(np.hypot(o.velocity[0], o.velocity[1]))
                           for o in res[0].obstacles])
        return res

    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_bag(os.path.join(tmp, "frames.npz"), n_frames, grid)
        extra = []
        if case in CLI_CONFIGS:
            cfg = os.path.join(tmp, "config.yaml")
            with open(cfg, "w", encoding="utf-8") as fh:
                fh.write(CLI_CONFIGS[case])
            extra = ["--config", cfg]
        out = io.StringIO()
        jnode.TrackerNode.on_pointcloud = recording
        try:
            with contextlib.redirect_stdout(out):
                assert jmain(argv + extra) == 0
        finally:
            jnode.TrackerNode.on_pointcloud = on_pointcloud
    records = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    assert len(records) == len(speeds)
    return {"argv": (["--backend", "grid"] if grid else []) + ["--frames", str(n_frames)]
            + (["--config", f"<{CLI_CONFIGS[case].strip()}>"] if extra else []),
            "records": records, "speeds": speeds}


def jax_config_of(tcfg, **fields):
    """The JAX ``TrackerConfig`` with every field of the port's ``tcfg``,
    then ``fields``."""
    import dataclasses

    from multiple_object_tracking_lidar_tpu.config import Capacities, SceneBounds, TrackerConfig

    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
          if f.name not in ("caps", "scene")}
    return TrackerConfig(**kw, caps=Capacities(**dataclasses.asdict(tcfg.caps)),
                         scene=SceneBounds(**dataclasses.asdict(tcfg.scene))).replace(**fields)


def floor_env(jcfg):
    """The JAX MapEnv of the goldens' floor map, and the map's hash."""
    import dataclasses

    from multiple_object_tracking_lidar_tpu.ops.static_mask import build_static_mask
    from multiple_object_tracking_lidar_tpu.utils.pgm import MapInfo, OccupancyGrid
    from multiple_object_tracking_lidar_tpu_torch import bench_cases as bc

    grid = bc.floor_map(bc.FLOOR_SEED, bc.FLOOR_GOLDEN_M)
    jgrid = OccupancyGrid(MapInfo(**dataclasses.asdict(grid.info)), grid.data)
    return (build_static_mask(jgrid, jcfg.static_tolarance, jcfg.occupied_threshold),
            bc.floor_map_hash(grid))


def floor_outputs(case: str, n_frames: int) -> dict:
    """The ``floor*`` goldens' arrays: the JAX ``Tracker.bind_env`` over the
    first n_frames frames of the goldens' floor, and the map's hash."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu.tracker.state import Frame
    from multiple_object_tracking_lidar_tpu_torch import bench_cases as bc

    tcfg, _, sc = bc.floor_golden_case()
    jcfg = jax_config_of(tcfg, **FLOOR_FIELDS[case])
    env, map_hash = floor_env(jcfg)
    tracker = Tracker(jcfg)
    state = tracker.init_state()
    step = tracker.bind_env(env, donate_state=False)
    rows = []
    for k in range(n_frames):
        buf, mask, t = _frame(sc, k, jcfg.caps.n_max_points)
        state, out = step(state, Frame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
        rows.append(jax.tree.map(np.asarray, out))
        print(f"{case} frame {k}", flush=True)
    out = {f: np.stack([getattr(r, f) for r in rows]) for f in rows[0]._fields}
    out["map_hash"] = np.array(map_hash)
    return out


def track_wide_outputs() -> dict:
    """The ``track_wide`` golden: per case ``k{K}_d{D}_{assoc}_{dtype}`` of
    ``bench_cases.TRACK_WIDE``, on ``bench_cases.track_wide_inputs`` (rebuilt
    from their seed where the golden is read), the jitted JAX
    ``track_step``'s outputs per frame (``out_*``) and its final bank's
    integers (``bank_*``); Hungarian at K = 2,048 one frame (every phase of
    its auction runs to the cap)."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from multiple_object_tracking_lidar_tpu.config import Capacities, TrackerConfig
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import (
        Perception,
        Tracker,
        track_step,
    )
    from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank, TrackerState
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import (
        TRACK_WIDE,
        TRACK_WIDE_L,
        track_wide_inputs,
    )

    out = {}
    for k, d, assoc, dtype in TRACK_WIDE:
        key = f"k{k}_d{d}_{assoc}_{dtype}"
        caps = Capacities(n_max_points=1024, m_max_voxels=256, m_max_dynamic=128,
                          c_max_clusters=d, p_max_cluster=32, k_max_tracks=k)
        jcfg = TrackerConfig(data_length=TRACK_WIDE_L, caps=caps, association=assoc,
                             dtype=dtype)
        bank, scal, frames = track_wide_inputs(k, d, assoc, dtype)
        state = TrackerState(bank=TrackBank(**{f: jnp.asarray(v) for f, v in bank.items()}),
                             **{f: jnp.asarray(v) for f, v in scal.items()})
        step = jax.jit(functools.partial(track_step, config=jcfg,
                                         gains_xy=Tracker(jcfg).gains_xy))
        rows = []
        for dets, valid, t in frames:
            z = jnp.int32(0)
            state, o = step(state, Perception(jnp.asarray(dets), jnp.asarray(valid),
                                              jnp.asarray(t), z, z, z,
                                              jnp.int32(valid.sum()), z))
            rows.append(jax.tree.map(np.asarray, o))
        for f in rows[0]._fields:
            out[f"{key}/out_{f}"] = np.stack([getattr(r, f) for r in rows])
        for f in ("alive", "obj_id", "birth_seq"):
            out[f"{key}/bank_{f}"] = np.asarray(getattr(state.bank, f))
        print(f"track_wide {key}: {len(rows)} frames", flush=True)
    return out


def half_outputs(case: str, n_frames: int) -> dict:
    """The headline through the JAX ``bind_env`` under ``dtype`` bf16 or f16
    (``case``), one run per position filter: {"<variant>/<field>": (n_frames,
    ...)}, the half fields widened to f32."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu.tracker.state import Frame

    cfg0, env, sc = bench.headline_case()
    hd = jnp.dtype(HALF_DTYPES[case])
    out = {}
    for variant, fields in HALF_VARIANTS.items():
        cfg = cfg0.replace(dtype=HALF_DTYPES[case], **fields)
        n = cfg.caps.n_max_points
        tracker = Tracker(cfg)
        state = tracker.init_state()
        step = tracker.bind_env(env, donate_state=False)
        rows = []
        for k in range(n_frames):
            buf, mask, t = _frame(sc, k, n)
            state, o = step(state, Frame(jnp.asarray(buf), jnp.asarray(mask), jnp.asarray(t, hd)))
            rows.append(jax.tree.map(np.asarray, o))
        for f in rows[0]._fields:
            a = np.stack([getattr(r, f) for r in rows])
            out[f"{variant}/{f}"] = a.astype(np.float32) if a.dtype == hd else a
        print(f"{case} {variant}: {n_frames} frames", flush=True)
    return out


def golden_outputs(n_frames: int | None = None, case: str = "slice",
                   n_streams: int = FLEET_STREAMS) -> dict:
    """{field: (n_frames, ...) array} of the JAX FrameOutputs of ``case``
    (the fleet: n_frames steps of n_streams streams)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu.tracker.state import Frame

    if uses_f64(case):
        jax.config.update("jax_enable_x64", True)
    if case in ("fleet", "bf16_fleet", "f16_fleet"):
        return fleet_outputs(n_frames_of(case) if n_frames is None else n_frames, n_streams,
                             HALF_DTYPES.get(case.split("_")[0]))
    if case == "growth":
        return growth_outputs(n_frames_of(case) if n_frames is None else n_frames)
    if case in ("learning", "bf16_learning", "f16_learning"):
        return learning_outputs(n_frames_of(case) if n_frames is None else n_frames,
                                HALF_DTYPES.get(case.split("_")[0]))
    if case in FLOOR_FIELDS:
        return floor_outputs(case, n_frames_of(case) if n_frames is None else n_frames)
    if case == "track_wide":
        return track_wide_outputs()
    if case in HALF_DTYPES:
        return half_outputs(case, n_frames_of(case) if n_frames is None else n_frames)
    cfg, env, sc = (bench.dense_case() if case.endswith("dense_hungarian")
                    else bench.headline_case())
    if case in ("default", "f64_default", "bf16_default", "f16_default"):
        from multiple_object_tracking_lidar_tpu.config import TrackerConfig

        # the env: the same sim map, default tolerances
        cfg = TrackerConfig(**CASE_FIELDS.get(case, {}))
    elif case in CASE_FIELDS:
        cfg = cfg.replace(**CASE_FIELDS[case])
    else:
        raise ValueError(f"unknown golden {case!r}")
    n_frames = n_frames_of(case) if n_frames is None else n_frames
    n = cfg.caps.n_max_points
    bufs, masks, ts = (list(x) for x in zip(*(_frame(sc, k, n) for k in range(n_frames))))
    tracker = Tracker(cfg)
    state = tracker.init_state()
    if case == "exact":
        multi = tracker.bind_env_multi(env, donate_state=False, hoist="on")
        _, out = multi(state, Frame(jnp.asarray(np.stack(bufs)), jnp.asarray(np.stack(masks)),
                                    jnp.asarray(np.stack(ts))))
        out = jax.tree.map(np.asarray, out)
        return {f: getattr(out, f) for f in out._fields}
    step = tracker.bind_env(env, donate_state=False)
    # a half config takes its stamps in the half dtype and stores its half
    # fields widened to f32 (exactly: the card's numpy has no bf16)
    hd = jnp.dtype(cfg.dtype) if cfg.dtype in HALF_DTYPES.values() else jnp.dtype(jnp.float32)
    rows = []
    for buf, mask, t in zip(bufs, masks, ts):
        state, out = step(state, Frame(jnp.asarray(buf), jnp.asarray(mask), jnp.asarray(t, hd)))
        rows.append(jax.tree.map(np.asarray, out))
    stacked = {f: np.stack([getattr(r, f) for r in rows]) for f in rows[0]._fields}
    return {f: a.astype(np.float32) if a.dtype == hd != np.float32 else a
            for f, a in stacked.items()}


def main(cases: list[str]) -> None:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for case in cases or list(GOLDENS):
        if case.startswith("cli"):
            import json

            out = tune_outputs(case=case) if case.endswith("tune") else cli_outputs(case)
            with open(GOLDENS[case], "w", encoding="utf-8") as fh:
                json.dump(out, fh, indent=None, separators=(",", ":"))
                fh.write("\n")
            print(f"wrote {GOLDENS[case]}: {os.path.getsize(GOLDENS[case])} bytes")
            continue
        out = golden_outputs(case=case)
        np.savez_compressed(GOLDENS[case], **out)
        print(f"wrote {GOLDENS[case]}: {n_frames_of(case)} frames, "
              f"{os.path.getsize(GOLDENS[case])} bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
