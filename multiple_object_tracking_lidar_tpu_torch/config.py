"""Configuration system.

Mirrors the reference's 15 ROS parameters (ref: src/multiple_object_tracking_lidar.cpp:86-115,
launch/simTracker.launch:12-43) with identical names, defaults and clamping,
plus the framework-level static-shape capacities a TPU design needs.

Quirk compatibility:
  * the reference reads ``static_tolarance`` (sic, cpp:95) while its own launch
    file sets ``static_tolerance`` (launch:20) so the launch value is silently
    ignored.  We accept BOTH spellings; the misspelled one wins if both are
    present (matching the key the reference actually reads).
  * ``static_tolarance`` is clamped to [0, 4] (cpp:96).
  * ``param_fix`` is read but unused by the reference (cpp:114); we keep it and
    wire it to the (optional) hyperparameter-learning mode.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class SceneBounds:
    """Axis-aligned bounds of the working volume.

    The reference's PCL VoxelGrid derives its voxel-index origin from the
    per-frame minimum point; because voxel boundaries sit at absolute
    multiples of the leaf size (floor(p/leaf)), the *partition* is
    data-independent and only the index origin moves.  Fixing bounds up
    front gives us a static dense voxel grid — the TPU-friendly layout.
    Points outside the bounds are dropped (they would be out-of-map and
    removed by the static filter anyway; ref removeStatic indexes the map
    unchecked, cpp:686).
    """

    x_min: float = -2.4
    x_max: float = 2.4
    y_min: float = -1.6
    y_max: float = 9.6
    z_min: float = -2.0
    z_max: float = 6.0

    def grid_dims(self, leaf_xy: float, leaf_z: float) -> tuple[int, int, int]:
        gx = max(1, int(math.ceil((self.x_max - self.x_min) / leaf_xy)))
        gy = max(1, int(math.ceil((self.y_max - self.y_min) / leaf_xy)))
        gz = max(1, int(math.ceil((self.z_max - self.z_min) / leaf_z)))
        return gx, gy, gz

    @staticmethod
    def from_map(
        width: int,
        height: int,
        resolution: float,
        origin_x: float,
        origin_y: float,
        z_min: float = 0.0,
        z_max: float = 2.0,
        margin: float = 0.25,
    ) -> "SceneBounds":
        """Derive the working volume from an occupancy grid's extent.

        Points outside the map are dropped by removeStatic anyway (out-of-map
        is unknown; ref cpp:686 reads unchecked — we define it as drop), so
        bounding the voxel grid by the map + a small margin loses nothing and
        keeps the dense cell grid minimal (grid-mode cost scales with cell
        count).  z defaults to a ground-robot band; widen for airborne use.
        """
        return SceneBounds(
            x_min=origin_x - margin,
            x_max=origin_x + width * resolution + margin,
            y_min=origin_y - margin,
            y_max=origin_y + height * resolution + margin,
            z_min=z_min,
            z_max=z_max,
        )


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Static-shape capacities (TPU: no dynamic shapes under jit)."""

    n_max_points: int = 131072      # raw input points per frame (padded)
    m_max_voxels: int = 8192        # compacted occupied voxels after downsample
    m_max_dynamic: int = 2048       # dynamic points entering clustering
    c_max_clusters: int = 64        # clusters (= detections) per frame
    p_max_cluster: int = 512        # points per cluster for feature extraction
    k_max_tracks: int = 64          # live tracks in the bank
    label_prop_iters: int = 32      # outer label-propagation sweeps (cap)
    pointer_jumps: int = 2          # pointer-jumping rounds per sweep
    grid_sweeps_per_iter: int = 2   # unrolled stencil sweeps per while-loop
    grid_jumps_per_iter: int = 2    # pointer-jump (matmul-gather) rounds/iter
                                    # iteration (cluster_backend="grid"):
                                    # sequential iterations cost ~10 us each
                                    # on TPU, so sweeps are batched per trip


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Full parameter surface of the reference node + framework knobs."""

    # --- reference params (names/defaults: cpp:86-115; launch values in ()) ---
    frequency: float = 10.0              # loop rate; dt_gp = 1/frequency (cpp:159)
    cluster_tolerance: float = 0.15      # Euclidean cluster radius, m (cpp:90)
    min_cluster_size: int = 5            # (cpp:91)
    max_cluster_size: int = 200          # (cpp:92; launch uses 300)
    voxel_leaf_size: float = 0.05        # z-leaf is 20x this (cpp:455)
    static_tolarance: int = 2            # sic; clamped [0,4] (cpp:95-96)
    id_threshold: float = 0.5            # association gate, m (cpp:97)
    lpf_tau: float = 0.01                # position LPF time constant (cpp:104)
    logSigma2_x: float = -5.5            # GP measurement noise (log) (cpp:105)
    logMagnSigma2_x: float = -3.5        # (cpp:106)
    logLengthScale_x: float = 0.75       # (cpp:107)
    logSigma2_y: float = -5.5            # (cpp:109)
    logMagnSigma2_y: float = -3.5        # (cpp:110)
    logLengthScale_y: float = 0.75       # (cpp:111)
    data_length: int = 10                # per-track window length (cpp:113; launch 40)
    param_fix: bool = True               # cpp:114 reads-but-never-uses this; here
                                         # param_fix=False turns ON online hyper-
                                         # parameter learning in the node loop
                                         # (models/learning.learning_step every
                                         # learn_period seconds, gains swapped
                                         # without recompile) — the working form
                                         # of the reference's dead IHGP_nonfixed
                                         # loop (cpp:922-1011)

    # --- reference behavioral constants (hard-coded in the C++) ---
    prune_period: float = 5.0            # track expiry period/staleness, s (cpp:550,564)
    interp_gap_factor: float = 3.0       # gap > 3*dt_gp -> interpolate (cpp:197)
    max_velocity: float = 1.5            # |v| clamp, m/s (cpp:649-654)
    obstacle_radius: float = 0.3         # published radius (cpp:267)
    occupied_threshold: int = 50         # map cell > 50 => occupied (cpp:686)
    color_seed: int = 5323               # srand seed for rviz colors (cpp:75)

    # --- framework knobs (TPU-native) ---
    position_filter: str = "lpf"         # "lpf" (ref default, cpp:638) | "ihgp" (cpp:639, present-but-disabled mode)
    association: str = "greedy"          # "greedy" (reference parity, cpp:177-219) |
                                         # "hungarian" (improved: optimal gated auction assignment)
    assoc_cond_branch: bool = True       # lax.cond fast/slow association (set False
                                         # under shard_map — see ops/assign.py)
    cluster_backend: str = "jnp"         # "jnp" (all-pairs, capped point list) |
                                         # "pallas" (fused VMEM kernel) |
                                         # "grid" (dense-grid stencil CC — no
                                         # m_max_dynamic cap, density-independent
                                         # cost; requires a dense accumulator,
                                         # i.e. voxel_mode "dense" or "onehot")
    voxel_mode: str = "dense"            # "dense" (scatter grid) | "runs" (Pallas
                                         # sorted-runs kernel, deterministic) | "scan"
                                         # (scatter-free sort+segsum; see
                                         # docs/PERFORMANCE.md on the scatter lottery)
                                         # | "onehot" (dense grid via factored
                                         # one-hot MXU matmuls — deterministic,
                                         # sort- and scatter-free)
    grid_cc: str = "auto"                # dense-grid CC engine: "auto" (fused
                                         # Pallas kernel on TPU when the
                                         # per-cell static table applies, jnp
                                         # stencil otherwise) | "pallas" |
                                         # "jnp"
    voxel_quant: str = "fast"            # onehot-accumulator coordinate
                                         # precision.  DEFAULT "fast": one
                                         # int8 digit per axis — 4 MXU streams
                                         # instead of 7 (~1945 vs ~1517
                                         # clouds/s at bench shapes); each
                                         # point quantizes to <= leaf/252
                                         # (~0.4 mm xy at the 0.1 m leaf — an
                                         # order of magnitude below LiDAR
                                         # range noise), counts stay exact
                                         # integers.  "exact": 2 digits/axis,
                                         # centroids match the f32 sum to
                                         # ~1e-6 — opt in when sub-quantum
                                         # centroid reproducibility vs the
                                         # float path matters more than
                                         # throughput.  Both modes are
                                         # bit-deterministic integer sums;
                                         # non-TPU paths ignore this.
    assoc_backend: str = "auto"          # greedy association engine: "auto"
                                         # (VMEM scan kernel on TPU when
                                         # K,D <= 128 and dtype=f32; jnp
                                         # otherwise) | "pallas" | "jnp".
                                         # Decisions are bit-identical; the
                                         # kernel removes the ~9 us/detection
                                         # XLA scan overhead (docs/
                                         # PERFORMANCE.md round 3)
    dtype: str = "float32"               # device compute dtype
    grow_bank_on_overflow: bool = True   # node-level escape hatch: when a frame
                                         # reports overflow (detections dropped
                                         # because every bank slot was alive),
                                         # double k_max_tracks, carry all state,
                                         # and rebind — restoring the reference's
                                         # unbounded-track semantics (STL vectors,
                                         # cpp:510-519) at the cost of one
                                         # recompile per doubling.  The dropped
                                         # detections re-register next frame.
    learn_period: float = 1.0            # seconds between online learning_step
                                         # updates when param_fix=False
    caps: Capacities = dataclasses.field(default_factory=Capacities)
    scene: SceneBounds = dataclasses.field(default_factory=SceneBounds)

    @property
    def dt_gp(self) -> float:
        return 1.0 / self.frequency

    @property
    def leaf_z(self) -> float:
        return 20.0 * self.voxel_leaf_size  # ref: cpp:455

    def __post_init__(self) -> None:
        # static_tolarance bounding, ref cpp:96
        t = max(0, min(4, int(self.static_tolarance)))
        object.__setattr__(self, "static_tolarance", t)
        if self.position_filter not in ("lpf", "ihgp"):
            raise ValueError(f"position_filter must be 'lpf' or 'ihgp', got {self.position_filter!r}")
        if self.association not in ("greedy", "hungarian"):
            raise ValueError(f"association must be 'greedy' or 'hungarian', got {self.association!r}")
        if self.cluster_backend not in ("jnp", "pallas", "grid"):
            raise ValueError(f"unknown cluster_backend {self.cluster_backend!r}")
        if self.voxel_mode not in ("dense", "runs", "scan", "onehot"):
            raise ValueError(f"unknown voxel_mode {self.voxel_mode!r}")
        if self.cluster_backend == "grid" and self.voxel_mode not in (
            "dense", "onehot", "runs"
        ):
            raise ValueError(
                "cluster_backend='grid' consumes the dense accumulator; "
                "use voxel_mode 'dense', 'onehot', or 'runs' (sort+densify)"
            )
        if self.grid_cc not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown grid_cc {self.grid_cc!r}")
        if self.assoc_backend not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown assoc_backend {self.assoc_backend!r}")
        if self.voxel_quant not in ("exact", "fast"):
            raise ValueError(f"unknown voxel_quant {self.voxel_quant!r}")

    def replace(self, **kw: Any) -> "TrackerConfig":
        return dataclasses.replace(self, **kw)


# Aliased / quirk parameter names accepted by the loaders.
_PARAM_ALIASES = {
    "static_tolerance": "static_tolarance",  # correct spelling -> ref key
    "id_thershold": "id_threshold",          # ref's internal (sic) member name
}

_REF_PARAM_TYPES = {
    "frequency": float, "cluster_tolerance": float, "min_cluster_size": int,
    "max_cluster_size": int, "voxel_leaf_size": float, "static_tolarance": int,
    "id_threshold": float, "lpf_tau": float,
    "logSigma2_x": float, "logMagnSigma2_x": float, "logLengthScale_x": float,
    "logSigma2_y": float, "logMagnSigma2_y": float, "logLengthScale_y": float,
    "data_length": int, "param_fix": bool,
    "prune_period": float, "interp_gap_factor": float, "max_velocity": float,
    "obstacle_radius": float, "occupied_threshold": int, "color_seed": int,
    "position_filter": str, "dtype": str, "association": str,
}


def _coerce(key: str, value: Any) -> Any:
    ty = _REF_PARAM_TYPES[key]
    if ty is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if ty in (int, float) and isinstance(value, str):
        # tolerate the launch file's malformed value=-'3.5' (launch:34): strip
        # quotes/spaces, keep a leading minus sign.
        v = value.strip().replace("'", "").replace('"', "")
        return ty(float(v))
    return ty(value)


def config_from_mapping(params: Mapping[str, Any]) -> TrackerConfig:
    """Build a config from a flat {param: value} mapping (ROS-param style)."""
    kw: dict[str, Any] = {}
    caps_kw: dict[str, Any] = {}
    scene_kw: dict[str, Any] = {}
    misspelled_tol_present = False
    for raw_key, value in params.items():
        key = _PARAM_ALIASES.get(raw_key, raw_key)
        if raw_key == "static_tolarance":
            misspelled_tol_present = True
        if key == "static_tolarance" and raw_key == "static_tolerance" and misspelled_tol_present:
            continue  # the (sic) key the reference reads wins
        if key in _REF_PARAM_TYPES:
            kw[key] = _coerce(key, value)
        elif key.startswith("caps."):
            caps_kw[key[5:]] = int(value)
        elif key.startswith("scene."):
            scene_kw[key[6:]] = float(value)
        # unknown params ignored, like ROS param server leftovers
    cfg = TrackerConfig(**kw)
    if caps_kw:
        cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, **caps_kw))
    if scene_kw:
        cfg = cfg.replace(scene=dataclasses.replace(cfg.scene, **scene_kw))
    return cfg


def load_launch_xml(path: str) -> TrackerConfig:
    """Parse a roslaunch-style XML (ref: launch/simTracker.launch) for
    ``<param name='...' value='...'/>`` entries.

    Regex-based on purpose: the reference launch file contains a malformed
    attribute ``value=-'3.5'`` (launch:34) that a strict XML parser rejects;
    we accept it and read the intended value, sign included.
    """
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    # strip XML comments so commented-out params are not picked up
    text = re.sub(r"<!--.*?-->", "", text, flags=re.S)
    params: dict[str, str] = {}
    for m in re.finditer(
        r"<param\s+name=['\"]([^'\"]+)['\"]\s+value=(-?)['\"]([^'\"]*)['\"]", text
    ):
        name, neg, value = m.group(1), m.group(2), m.group(3)
        params[name] = (neg + value) if neg else value
    return config_from_mapping(params)


def load_config(path: str) -> TrackerConfig:
    """Load config from .json, .yaml/.yml, or roslaunch .launch/.xml."""
    if path.endswith((".launch", ".xml")):
        return load_launch_xml(path)
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if path.endswith(".json"):
        data = json.loads(text)
    else:
        data = _parse_simple_yaml(text)
    flat = _flatten(data)
    return config_from_mapping(flat)


def _flatten(d: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _parse_simple_yaml(text: str) -> dict[str, Any]:
    """Dependency-free parser for the small subset of YAML we emit/consume:
    nested ``key: value`` maps with 2-space indentation, scalars only."""
    root: dict[str, Any] = {}
    stack: list[tuple[int, dict[str, Any]]] = [(0, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        while stack and indent < stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if not val:
            child: dict[str, Any] = {}
            parent[key] = child
            stack.append((indent + 2, child))
        else:
            parent[key] = _yaml_scalar(val)
    return root


def _yaml_scalar(v: str) -> Any:
    vl = v.strip().strip("'\"")
    if vl.lower() in ("true", "false"):
        return vl.lower() == "true"
    try:
        return int(vl)
    except ValueError:
        pass
    try:
        return float(vl)
    except ValueError:
        pass
    return vl
