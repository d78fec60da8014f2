"""The per-frame tracking step.

Port of ``multiple_object_tracking_lidar_tpu/tracker/pipeline.py`` in
every compute dtype the JAX ``TrackerConfig`` accepts (f32, f64, bf16 and
f16, each on every configuration), both associations (``greedy``, and
``hungarian``, the optimal gated assignment) and both position filters
(``lpf``, and ``ihgp``, the reference's present-but-disabled mode).  The
reference's callback chain (voxel downsample -> static removal ->
Euclidean clustering -> circumcenter features -> greedy association -> LPF
filtering -> expiry; ref cloudCallback, src/multiple_object_tracking_lidar.cpp:123-233) runs on
one of two perception paths:

- the dense grid (``cluster_backend="grid"``, fed by ``voxel_mode=
  "onehot"`` or ``"runs"``; the configuration the JAX package benchmarks):

    voxel accumulator -> K2 finalize + static drop + grid CC ->
    cluster table -> K3f circumcenter (one launch)

  where the accumulator is K1 (fast digits), K5 (exact digits), K6
  (bf16x3: exact mode at a coarse leaf or when no point block tiles N) or
  the sorted runs with K7.  ``grid_cc`` picks the CC as the JAX package
  does on the TPU: "auto" and "pallas" take K2 where the map has a per-cell
  static table and the grid fits K2 (454,656 cells); otherwise ("jnp", a
  rotated or coarse map, a larger grid) the finalize and the static drop
  (``remove_static_cells`` with a table, the per-point map lookup
  ``remove_static`` without one) run in torch and the stencil CC is K14
  (``ops/cluster_grid.py::connected_components_grid``, ``ops/
  stencil_cc_cuda.py``), and an explicit "pallas" that K2 cannot honour
  raises;
- the point list (``cluster_backend="jnp"`` or ``"pallas"``; the JAX
  package's default ``TrackerConfig()``):

    voxel list (dense: K6 f32 sums + finalize; scan: sort + passes; runs:
    sort + K7; onehot: K1/K5/K6 + finalize) -> remove_static ->
    compact_points -> CC (pallas: K8; jnp: K8's adjacency + pointer-jump
    sweeps) -> cluster postprocess -> K3f circumcenter (one launch)

and then the track step: K4 (``ops/track_cuda.py``), the whole step in
one launch at any bank and detection count (K4 xl past the narrow builds'
1,024 slots and 128 detections).

Under ``dtype="float64"`` the stages follow the JAX package's f64 route:
the quantize, K1 (fast digits, its sums cast), K7 (runs), K8 (the Pallas
CC, on the points rounded to f32) and the map lookups stay f32; the
scatter sums (``voxel_mode="dense"``) and the exact route's sums are K6f's
double build, the jnp CC's adjacency K8a's, the dense grid's CC K2's (fed
K7's f32 sums under ``voxel_mode="runs"``: finalized in f32, then
widened), the circumcenter K3f's and the track step K4's; the scan and
the runs' division run in f64 torch.

Under ``dtype="bfloat16"`` and ``"float16"`` (fixed or learned gains: the
learning step stays f32, ``runtime/node.py``) the stages follow the JAX
half route as XLA's jitted CPU code computes it in ``bind_env``'s programs
(read stage by stage from their HLO and machine code; ``ops/half.py``
spells the rules).
The points are rounded to the half dtype and widened (JAX pipeline.py:846,
:905, :916).  The front ends:

- one-hot: K1 / K5 sum them in f32 (K6 at the exact route's coarse leaf)
  and the sums, counts included, are rounded to the half dtype
  (voxel_grid.py:239: bf16 counts exact to 256, f16 to 2,048; f16 sums
  overflow to inf past 65,504, as in JAX);
- scatter sums (``voxel_mode="dense"``): K6f's half builds, every update
  rounded to the half dtype in ascending point index (XLA's CPU scatter
  adds in f32 and rounds for bf16, natively for f16), the count a half sum
  of ones (stuck at 256 in bf16, 2,048 in f16);
- scan: the passes and the division as half ops (torch; no kernel);
- runs: K7 in f32 (JAX's ``w`` is f32, voxel_pallas.py:128); on the grid
  the accumulator, its finalize and the static drop stay f32 and K2's half
  build fed f32 sums rounds the centroid for its half d^2; on the point
  list the counts are rounded to the half dtype and the division is f32,
  so that list stays f32 through K8 / K8a's f32 builds and K3f's f32
  build, and the detections are cast at the end (pipeline.py:820).

On the point list the finalize divides in half (a half division), the
static drop reads the points widened to f32 (static_mask.py:263), the jnp
CC's adjacency is K8a's half build (the column sum in f32 rounded once,
the count rounded, sq and the gram as f32 sums rounded once -- bf16 sums
exact squares, f16 its rounded squares --, d2 per op), the Pallas CC is K8
on the points widened (cluster_pallas.py:132), and the circumcenter is
K3f's half build on the cluster-sorted list.  On the dense grid K2's half
build (or, without it, the finalize, the static drop and K14's half build)
divides in f32 and rounds, takes the static drop on the centroid widened
to f32 (static_mask.py:241), and the stencil's d^2 in the half dtype; the
cluster table copies half values; K3f's half build is the jnp table route
(``_one_cluster``: member mean, gram d2, line scan, determinant); K4's half
build is the whole step in the half dtype (under every front end); under
``association="hungarian"`` its Hungarian half build computes the gate cost
as ``bind_env``'s program does (f16: fma(dx, dx, dy * dy) rounded once and
the f16 root; bf16: each op rounded) and the auction on half values, every
sum and difference rounded (``ops/hungarian.py``).  Each
elementwise op computes in f32 and rounds once; bf16 contracts no multiply-add, f16 contracts the
first product of an add or a subtraction of two products into one FMA
rounded once, where the step's compiled code does (the circumcenter's e,
f, G and numerators, the cross product, the LPF, the stencil's d^2, a
window velocity's product into its centring, the backfill's jj * dt); a
reduction, dot or einsum of half operands (the member mean -- in windows
of 32 members past 32 --, the squared norms and gram, the smoother's sums)
accumulates exact f32 products in f32 in ascending index and rounds once;
a mean is that sum times f32(1 / n) rounded; a division by a constant
(dt) is the product by its reciprocal (f16: rounded to f16; bf16: the f32
reciprocal, the product rounded), and bf16's velocity mean sums those
products before their rounding.  Both dtypes give the JAX package's bits
end to end (tests/test_torch_half*.py); the runs' point list computes its
f32 circumcenter as JAX's f32 ``_one_cluster`` program does (K3f's f32
table build) before the cast.
No stage in any dtype takes a plain version of a kernel on the card.  Every
kernel lives in ``ops/*_cuda.py`` or ``ops/cluster_pallas.py``.
Perception is stateless, so it runs on S stacked frames at once:
``bind_env`` is S = 1 and ``bind_env_multi`` perceives its S frames in one
pass (each frame's result is the one ``bind_env`` computes -- stacked
frames never mix), then one K4 launch scans their track steps in order.
PyTorch runs eagerly, so frames stay on the device between stages; the
dense-grid paths make no host sync, the jnp CC one per
``ops/cluster.py::CHECK_EVERY`` sweeps.
``perceive_from_acc`` and ``step_from_voxel_acc`` start after the
accumulator, as the fleet's vmap form does (``parallel/sharding.py``).
Other configurations raise ``NotImplementedError`` naming their ROADMAP
item.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a CUDA device they raise rather than fall back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.models.ihgp import (
    smoother_weights_xy,
    stationary_gains,
)
from multiple_object_tracking_lidar_tpu_torch.models.matern32 import matern32_from_log
from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
    circumcenter_features_sorted,
    circumcenter_features_table_stacked,
)
from multiple_object_tracking_lidar_tpu_torch.ops.cluster import euclidean_cluster
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
    cluster_table_grid,
    connected_components_grid,
)
from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points
from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import (
    fused_cc_fits,
    fused_finalize_static_cc_stacked,
    kernel_offsets,
    make_scal,
    max_kernel_cells,
)
from multiple_object_tracking_lidar_tpu_torch.ops.half import HALF
from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import (
    CellStaticTable,
    MapEnv,
    build_cell_static_table,
    remove_static,
    remove_static_cells,
)
from multiple_object_tracking_lidar_tpu_torch.ops.track_cuda import (
    TrackOutputs,
    track_frames,
    track_frames_plain,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import (
    grid_shape,
    voxel_downsample_scan,
    voxel_finalize_cm,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import (
    voxel_accumulate_stacked as scatter_accumulate_stacked,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import (
    finalize_dense_cm,
    voxel_accumulate_stacked,
)
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_pallas import (
    voxel_accumulate_runs_stacked,
    voxel_downsample_runs,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
    Frame,
    FrameOutput,
    TrackerState,
    gains_from_numpy,
    init_state,
    map_state,
)

# The compute dtypes this package runs, each on every configuration
# TrackerConfig accepts (it refuses the combinations the JAX package
# refuses; ``check_config``).
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def points_dtype(config: TrackerConfig) -> torch.dtype:
    """The dtype a frame's points go to the device in: the compute dtype,
    as the JAX package casts them (pipeline.py:846, :905, :916), except on
    the fast digits (``voxel_mode="onehot"``, ``voxel_quant="fast"``),
    which quantize and sum the points rounded to f32 in every dtype
    (voxel_grid.py:187-233), so f32 points give the same bits as f64 ones.
    Under bf16 / f16 the points are rounded to the half dtype first
    (pipeline.py:846) and then widened, exactly, to f32: the accumulators
    (K1, K5, K6) take f32 points, as the JAX one-hot routes widen them."""
    if config.dtype in ("bfloat16", "float16"):
        return torch.float32
    if config.voxel_mode == "onehot" and config.voxel_quant == "fast":
        return torch.float32
    return _DTYPES[config.dtype]


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on.  Raises where the caller did not
    ask for the CPU and no CUDA device exists: the port never falls back to
    its plain versions quietly."""
    dev = torch.device(device)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def check_config(config: TrackerConfig) -> None:
    """NotImplementedError, naming the ROADMAP item, where this package does
    not run ``config``: a compute dtype outside ``_DTYPES``.  Every other
    configuration the JAX package accepts runs here."""
    if config.dtype not in _DTYPES:
        raise NotImplementedError(
            f"dtype={config.dtype!r} is not ported yet: this package runs dtype in "
            f"{tuple(_DTYPES)} (ROADMAP Queue 1: other compute dtypes)"
        )


class Perception(NamedTuple):
    """Stateless per-frame perception result: (C, 4) detections + scalars."""

    dets: torch.Tensor
    det_valid: torch.Tensor
    t: torch.Tensor
    n_points: torch.Tensor
    n_vox: torch.Tensor
    n_dynamic: torch.Tensor
    n_clusters: torch.Tensor
    cc_saturated: torch.Tensor


class GridPlan(NamedTuple):
    """What a bound step holds on the device for one map: the map itself,
    the per-cell static table (None on the point list, which reads the map
    per point, and on a map whose cell window passes 32 bits), whether the
    dense grid's CC is K2, and K2's (6,) scalars (None where K2 does not
    run)."""

    env: MapEnv
    dims: tuple[int, int, int]
    table: CellStaticTable | None
    scal: torch.Tensor | None
    k2: bool = False


def make_plan(config: TrackerConfig, env: MapEnv, device, cell_table: bool = True,
              table: CellStaticTable | None = None) -> GridPlan:
    """The GridPlan of ``config`` on ``env``, moved to ``device``.  The
    dense grid's per-cell table is ``table`` when given, else built from
    the map when ``cell_table`` (None where its window passes 32 bits);
    ``cell_table=False`` plans the route of a map with no table, as the
    JAX fleet's vmap form takes it (its map is a tracer there).  K2 runs
    where ``grid_cc`` is "auto" or "pallas", a table exists and the grid
    fits K2 (pipeline.py:527-549); "pallas" that K2 cannot honour raises
    ValueError; where K2 does not run the stencil CC is K14."""
    cfg = config
    dims = grid_shape(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    env = env._replace(**{f: getattr(env, f).to(device) for f in env._fields if f != "host"})
    if cfg.cluster_backend != "grid":
        return GridPlan(env=env, dims=dims, table=None, scal=None)
    if table is None and cell_table:
        table = build_cell_static_table(env, cfg.scene, cfg.voxel_leaf_size, *dims)
    if table is not None:
        table = CellStaticTable(*(t.to(device) for t in table[:3]), k=table.k)
    n_cells = dims[0] * dims[1] * dims[2]
    n_off = len(kernel_offsets(dims, cfg.cluster_tolerance, cfg.voxel_leaf_size, cfg.leaf_z))
    fits = fused_cc_fits(n_cells, n_off, device)
    if cfg.grid_cc == "pallas" and (table is None or not fits):
        raise ValueError(
            "grid_cc='pallas' needs a concrete map (per-cell static table) and "
            f"<= {max_kernel_cells(n_off, device)} grid cells with {n_off} stencil offsets "
            f"(got {n_cells}: K2 keeps the grid in one cluster's shared memory); "
            "use a coarser leaf or grid_cc='auto' for the stencil fallback"
        )
    k2 = table is not None and fits and cfg.grid_cc in ("auto", "pallas")
    scal = make_scal(env, cfg.cluster_tolerance, device) if k2 else None
    return GridPlan(env=env, dims=dims, table=table, scal=scal, k2=k2)


class Tracker:
    """Binds a TrackerConfig to the step on ``device`` (the card unless
    the caller passes "cpu").  The stationary IHGP gains are computed once
    here on the host in f64 and held as tensors of the compute dtype on the
    device."""

    def __init__(self, config: TrackerConfig, device: torch.device | str = "cuda"):
        check_config(config)
        self.config = config
        self.dtype = _DTYPES[config.dtype]
        self.device = resolve_device(device)
        _, _, gains_np = self.compute_gains(
            config,
            (config.logSigma2_x, config.logMagnSigma2_x, config.logLengthScale_x),
            (config.logSigma2_y, config.logMagnSigma2_y, config.logLengthScale_y),
        )
        self.gains_xy = gains_from_numpy(gains_np, self.device, self.dtype)

    @staticmethod
    def compute_gains(config: TrackerConfig, log_x, log_y):
        """Host-f64 stationary gains + smoother weights per axis, stacked on
        a leading {x, y} axis as numpy of the compute dtype (the JAX
        Tracker.compute_gains).  Under bf16 / f16 the numpy leaves stay f64
        (numpy has no bf16 without ml_dtypes, which the card's machine
        lacks): ``gains_from_numpy`` rounds them once to the half dtype, as
        JAX's cast from f64 does."""
        dtype = np.dtype(config.dtype if config.dtype in ("float32", "float64") else "float64")
        gx = stationary_gains(matern32_from_log(*log_x), config.dt_gp)
        gy = stationary_gains(matern32_from_log(*log_y), config.dt_gp)
        ax, ay = gx.as_arrays(dtype), gy.as_arrays(dtype)
        gains_xy = {k: np.stack([ax[k], ay[k]]) for k in ax}
        gains_xy["W_vel"] = smoother_weights_xy(gx, gy, config.data_length - 1, dtype)
        gains_xy["W_pos"] = smoother_weights_xy(gx, gy, config.data_length, dtype)
        return gx, gy, gains_xy

    def init_state(self, batch: int | None = None) -> TrackerState:
        """A fresh state; ``batch`` stacks that many (a fleet's streams)."""
        return init_state(
            self.config.caps.k_max_tracks, self.config.data_length, self.dtype,
            self.device, batch=batch,
        )

    def plan(self, env: MapEnv, cell_table: bool = True) -> GridPlan:
        """The map on the device and, for the dense grid, its per-cell
        static table (where the map has one) and the CC route
        (``make_plan``)."""
        return make_plan(self.config, env, self.device, cell_table=cell_table)

    def _frame(self, frame: Frame) -> Frame:
        """The frame on the device: points in ``points_dtype`` (the compute
        dtype, f32 on the fast digits), t in the compute dtype (a caller's
        f64 stamp is not rounded through f32 first)."""
        dev = self.device
        points = torch.as_tensor(frame.points, device=dev)
        if self.dtype in HALF:
            points = points.to(self.dtype)
        return Frame(
            points=points.to(points_dtype(self.config)),
            mask=torch.as_tensor(frame.mask, device=dev),
            t=torch.as_tensor(frame.t, device=dev).to(self.dtype),
        )

    def step(self, state: TrackerState, frame: Frame, env: MapEnv):
        return self.bind_env(env)(state, frame)

    def accumulate(self, points: torch.Tensor, mask: torch.Tensor):
        """The config's dense voxel accumulator on S stacked frames:
        ((S, 4, n_cells) of the compute dtype, (S,) i32 mask-nonzero
        counts) -- the sorted runs (K7), the scatter sums (K6 f32 mode,
        ``voxel_mode="dense"``) or the one-hot route of ``voxel_quant`` (K1,
        K5 or K6).  Under f64 the scatter sums and the exact route's are
        K6f's double build on the f64 points, K1's f32 sums are cast, as
        the JAX package casts its f32 finalize (voxel_grid.py:231), and the
        runs' accumulator stays f32, as JAX's does (voxel_pallas.py:
        158-243; the dense grid finalizes it in f32)."""
        cfg = self.config
        args = (points, mask, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
        if cfg.voxel_mode == "runs":
            return voxel_accumulate_runs_stacked(*args)
        if cfg.voxel_mode == "dense":
            return scatter_accumulate_stacked(*args, dtype=self.dtype)
        accs, npts = voxel_accumulate_stacked(*args, quant=cfg.voxel_quant)
        return accs.to(self.dtype), npts

    def perceive(self, frames: Frame, plan: GridPlan) -> Perception:
        """Stateless perception of S stacked frames (points (S, N, 3)):
        a Perception whose fields carry a leading S axis."""
        cfg = self.config
        if cfg.cluster_backend == "grid" or cfg.voxel_mode not in ("scan", "runs"):
            accs, npts = self.accumulate(frames.points, frames.mask)
            return perceive_from_acc_stacked(accs, frames.t, npts, plan, config=cfg)
        npts = (frames.mask.reshape(frames.mask.shape[0], -1) != 0).sum(dim=1).to(torch.int32)
        down = voxel_downsample_runs if cfg.voxel_mode == "runs" else voxel_downsample_scan
        vox, vox_mask, n_vox = down(
            frames.points, frames.mask, cfg.scene,
            cfg.voxel_leaf_size, cfg.leaf_z, cfg.caps.m_max_voxels,
            dtype=self.dtype if self.dtype in HALF else None,
        )
        return _perceive_from_vox(vox, vox_mask, n_vox, frames.t, npts, plan.env, config=cfg)

    def bind_env(self, env: MapEnv, donate_state: bool = True):
        """Specialize the step on a fixed map (re-bind on map updates).
        Returns ``step(state, frame) -> (state, output)``: the stacked
        perception at S = 1, then one K4 launch.  ``donate_state`` is the
        JAX signature's; it is accepted and ignored (eager torch donates
        nothing: K4 writes the new state to fresh tensors)."""
        gstep = self.bind_env_gains(env, donate_state)
        gains = self.gains_xy
        return lambda state, frame: gstep(state, frame, gains)

    def bind_env_gains(self, env: MapEnv, donate_state: bool = True):
        """Like bind_env, with the IHGP gains an argument: ``step(state,
        frame, gains_xy) -> (state, output)`` (JAX pipeline.py:154-169).
        Online hyperparameter learning (``param_fix=False``) swaps updated
        gains in per call; ``gains_xy`` is the nesting ``gains_from_numpy``
        makes of ``compute_gains``' dict, on this tracker's device in its
        dtype (K4 reads the smoother weights from it, ops/track_cuda.py).
        ``donate_state`` is accepted and ignored, as in ``bind_env``."""
        plan = self.plan(env)
        cfg = self.config

        def step(state: TrackerState, frame: Frame, gains_xy: dict):
            frame = self._frame(frame)
            p = self.perceive(Frame(frame.points[None], frame.mask[None], frame.t[None]), plan)
            return track_step(state, _row(p, 0), config=cfg, gains_xy=gains_xy)

        return step

    def bind_env_multi(self, env: MapEnv, donate_state: bool = True, hoist: str = "auto"):
        """Like bind_env, for a batch of consecutive frames of one stream
        stacked on a leading axis: ``multi_step(state, frames) -> (state,
        outputs)``, outputs stacked per frame.  Perception runs once on all
        S frames (one accumulator call, stacked K2 or K8, one K3f launch),
        then the S track steps in one K4 launch (``track_batch`` at 1 x S),
        which scans them in order.  Every frame's result is the one
        ``bind_env`` computes: the stacked stages treat the frames
        independently.

        ``donate_state`` is accepted and ignored, as in ``bind_env``.
        ``hoist`` is validated as the JAX package validates it
        (pipeline.py:204-243): an unknown value raises; "on" and "batch"
        need ``voxel_mode="onehot"``, ``cluster_backend="grid"`` and f32;
        "batch" also needs a per-cell static table, ``grid_cc`` "auto" or
        "pallas" and a grid within the JAX fused CC's 32,768 cells
        (``hoist_batch_fits``), so the same configs raise in both packages.
        Every value runs the same stacked program here: the JAX package
        hoists only its accumulator ("on") or its whole perception
        ("batch") out of a per-frame scan, and its results are the same
        bits either way."""
        plan = self.plan(env)
        check_hoist(self.config, plan, hoist)
        cfg, gains = self.config, self.gains_xy

        def multi(state: TrackerState, frames: Frame):
            frames = self._frame(frames)
            p = self.perceive(frames, plan)
            st, o = track_batch(
                map_state(lambda x: x[None], state), p.dets[None], p.det_valid[None],
                p.t[None], config=cfg, gains_xy=gains,
            )
            return map_state(lambda x: x[0], st), _frame_output(TrackOutputs(*(f[0] for f in o)), p)

        return multi

    def bind_env_pipelined(self, env: MapEnv, donate_state: bool = True):
        """The JAX package's highest-throughput shape (pipeline.py:362-422):
        the stateless perception batched over the frame axis, then the
        track steps scanned in order.  ``bind_env_multi`` is that program
        on every config here (one stacked perception, one K4 launch for
        the S steps), so this returns it: ``run(state, frames_stacked) ->
        (state, outputs_stacked)``.  ``donate_state`` is accepted and
        ignored, as in ``bind_env``."""
        return self.bind_env_multi(env, donate_state=donate_state)


JAX_MAX_KERNEL_CELLS = 32768  # the JAX fused CC's bound (ops/grid_pallas.py:49-54)


def hoist_batch_fits(n_cells: int) -> bool:
    """The JAX package's ``fused_cc_fits`` (ops/grid_pallas.py:52-54),
    which ``hoist="batch"`` is validated against in both packages."""
    return n_cells <= JAX_MAX_KERNEL_CELLS


def check_hoist(config: TrackerConfig, plan: GridPlan, hoist: str) -> None:
    """Raise ValueError where the JAX ``bind_env_multi`` refuses ``hoist``
    (pipeline.py:204-243)."""
    cfg = config
    if hoist not in ("auto", "on", "batch", "off"):
        raise ValueError(f"unknown hoist {hoist!r}")
    kernel_cfg = (cfg.voxel_mode == "onehot" and cfg.cluster_backend == "grid"
                  and cfg.dtype == "float32")
    if hoist in ("on", "batch") and not kernel_cfg:
        raise ValueError(
            f"hoist={hoist!r} needs voxel_mode='onehot', cluster_backend='grid', "
            f"dtype=float32 (got {cfg.voxel_mode!r}/{cfg.cluster_backend!r}/{cfg.dtype!r})"
        )
    n_cells = plan.dims[0] * plan.dims[1] * plan.dims[2]
    if hoist == "batch" and not (
        plan.table is not None and hoist_batch_fits(n_cells) and cfg.grid_cc in ("auto", "pallas")
    ):
        raise ValueError(
            "hoist='batch' needs a concrete map (per-cell static table) "
            "and a grid small enough for the fused-CC kernel"
        )


def _row(p: Perception, s: int) -> Perception:
    """Frame s of a stacked Perception."""
    return Perception(*(f[s] for f in p))


def _perceive_batch_from_dense_acc(
    accs: torch.Tensor, t, npts, plan: GridPlan, *, config: TrackerConfig
) -> Perception:
    """Dense-grid perception of S frames (accs (S, 4, n_cells)): stacked K2
    (finalize + static drop + CC) or, where the plan says K2 does not run,
    the finalize, the static drop and the stencil CC in plain torch; then
    the batched cluster table, one K3f launch for the S * C slots: the
    circumcenter.  f32 ``accs`` under f64 (the runs' accumulator) are
    finalized in f32 and the centroids widened (JAX pipeline.py:591, :600):
    K2's build fed f32 sums."""
    caps = config.caps
    dtype = _DTYPES[config.dtype]
    tol, leaf, leaf_z = config.cluster_tolerance, config.voxel_leaf_size, config.leaf_z
    if plan.k2:
        cent, dyn, labels, n_sw, cc_sat = fused_finalize_static_cc_stacked(
            accs, plan.scal, plan.table.base_row, plan.table.base_col,
            plan.table.bits, dims=plan.dims, tol=tol, leaf_xy=leaf,
            leaf_z=leaf_z, kwin=plan.table.k, dtype=dtype,
        )
    else:
        cent, occ, _ = finalize_dense_cm(accs)
        if plan.table is not None:
            dyn = remove_static_cells(cent, occ, plan.env, plan.table)
        else:
            dyn = remove_static(cent.transpose(-1, -2), occ, plan.env)
        cent = cent.to(dtype)
        labels, n_sw, cc_sat = connected_components_grid(
            cent, dyn, plan.dims, tol, leaf, leaf_z, caps.label_prop_iters,
            caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter,
        )
    ctab = cluster_table_grid(
        labels, n_sw, cent, dyn, plan.dims[0], config.min_cluster_size,
        config.max_cluster_size, caps.c_max_clusters, caps.p_max_cluster,
    )
    dets = circumcenter_features_table_stacked(ctab.mpts, ctab.member_mask, t)
    return Perception(
        dets=dets, det_valid=ctab.cluster_valid, t=t, n_points=npts,
        n_vox=(accs[:, 3] > 0).sum(dim=1), n_dynamic=dyn.sum(dim=1),
        n_clusters=ctab.n_clusters, cc_saturated=cc_sat,
    )


def perceive_from_acc_stacked(
    accs: torch.Tensor, t, n_points, plan: GridPlan, *, config: TrackerConfig
) -> Perception:
    """Perception after voxel accumulation, of S frames (accs (S, 4,
    n_cells) channel-major): the dense grid's tail, or on the point list
    the finalize to ``m_max_voxels`` centroids and the point-list tail."""
    if config.cluster_backend == "grid":
        return _perceive_batch_from_dense_acc(accs, t, n_points, plan, config=config)
    vox, vox_mask, n_vox = voxel_finalize_cm(accs, config.caps.m_max_voxels)
    return _perceive_from_vox(vox, vox_mask, n_vox, t, n_points, plan.env, config=config)


def perceive_from_acc(
    acc: torch.Tensor, t, n_points, env: MapEnv, *, config: TrackerConfig,
    table: CellStaticTable | None = None,
) -> Perception:
    """One frame's perception from its (n_cells, 4) accumulator, the JAX
    package's row-major layout (pipeline.py:453).  The dense grid uses
    ``table``, or the map's own when none is given."""
    plan = make_plan(config, env, acc.device, table=table)
    p = perceive_from_acc_stacked(
        acc.T[None], torch.as_tensor(t)[None], torch.as_tensor(n_points)[None], plan,
        config=config,
    )
    return _row(p, 0)


def step_from_voxel_acc(
    state: TrackerState, acc: torch.Tensor, t, n_points, env: MapEnv, *,
    config: TrackerConfig, gains_xy: dict,
) -> tuple[TrackerState, FrameOutput]:
    """Everything after voxel accumulation (pipeline.py:925), for a
    deployment that sums partial accumulators over point shards first."""
    p = perceive_from_acc(acc, t, n_points, env, config=config)
    return track_step(state, p, config=config, gains_xy=gains_xy)


def _perceive_from_vox(
    vox: torch.Tensor,        # (S, m_max_voxels, 3)
    vox_mask: torch.Tensor,   # (S, m_max_voxels)
    n_vox: torch.Tensor,      # (S,)
    t: torch.Tensor,          # (S,)
    n_points: torch.Tensor,   # (S,)
    env: MapEnv,
    *,
    config: TrackerConfig,
) -> Perception:
    """Point-list perception tail of S frames: static removal (one map
    gather per voxel), order-preserving compaction to m_max_dynamic rows,
    Euclidean clustering, circumcenter features."""
    caps = config.caps
    dyn_mask = remove_static(vox, vox_mask, env)
    pts, pts_mask, n_dyn = compact_points(vox, dyn_mask, caps.m_max_dynamic)
    clusters = euclidean_cluster(
        pts, pts_mask, config.cluster_tolerance, config.min_cluster_size,
        config.max_cluster_size, caps.c_max_clusters, caps.p_max_cluster,
        caps.label_prop_iters, caps.pointer_jumps, backend=config.cluster_backend,
    )
    # the runs' f32 list under a half dtype: JAX's f32 _one_cluster, then the cast
    dtype = _DTYPES[config.dtype]
    dets = circumcenter_features_sorted(
        clusters.sorted_pts, clusters.starts, clusters.sizes, clusters.cluster_valid,
        t, caps.p_max_cluster, table=dtype in HALF and vox.dtype == torch.float32,
    ).to(dtype)
    return Perception(
        dets=dets,
        det_valid=clusters.cluster_valid,
        t=t,
        n_points=n_points,
        n_vox=n_vox,
        n_dynamic=n_dyn,
        n_clusters=clusters.n_clusters,
        # the only saturation signal of the all-pairs CC is reaching the
        # sweep cap; the pallas backend reports -1 and never flags
        cc_saturated=(clusters.n_iters >= caps.label_prop_iters).to(torch.int32),
    )


def track_batch(
    state: TrackerState, dets: torch.Tensor, det_valid: torch.Tensor, t: torch.Tensor, *,
    config: TrackerConfig, gains_xy: dict,
) -> tuple[TrackerState, TrackOutputs]:
    """The track step of B banks over S frames each (state fields with a
    leading (B,) axis; dets (B, S, D, 4), det_valid (B, S, D), t (B, S)):
    K4 in one launch (``ops/track_cuda.py::track_frames``) on the card, at
    any bank and detection count and under either ``assoc_backend``, or its
    plain version frame by frame on the CPU.  Every route makes the same
    decisions."""
    route = track_route(config, state.bank.alive.shape[-1], dets.shape[-2], dets.device)
    run = track_frames if route == "kernel" else track_frames_plain
    return run(state, dets, det_valid, t, config=config, gains_xy=gains_xy)


def track_route(config: TrackerConfig, k: int, d: int, device=None) -> str:
    """The track step's route for a bank of ``k`` slots and ``d`` detection
    slots: "kernel" (K4, or K4 xl past its narrow builds' bounds) on the
    card (``device`` None or CUDA), "plain" (``track_frames_plain``) on the
    CPU.
    ``assoc_backend`` picks the greedy engine in the JAX package (its
    Pallas scan or its jnp scan, pipeline.py:984-990), whose decisions it
    documents as identical (config.py:179-186); the card runs K4 under
    both, as it does for a Hungarian step."""
    del config, k, d
    return "plain" if device is not None and torch.device(device).type == "cpu" else "kernel"


def _frame_output(o: TrackOutputs, p: Perception) -> FrameOutput:
    return FrameOutput(
        publish=o.publish, valid=o.valid, obj_id=o.obj_id, pos=o.pos, vel=o.vel,
        raw_centroid=p.dets, new_track=o.new_track, n_points=p.n_points,
        n_voxels=p.n_vox, n_dynamic=p.n_dynamic, n_clusters=p.n_clusters,
        n_alive=o.n_alive, overflow=o.overflow, dup_saturated=o.dup_saturated,
        cc_saturated=p.cc_saturated, assoc_saturated=o.assoc_saturated,
    )


def track_step(
    state: TrackerState, p: Perception, *, config: TrackerConfig, gains_xy: dict
) -> tuple[TrackerState, FrameOutput]:
    """Stateful tracking back-end of one frame: association, lifecycle,
    filtering, expiry (port of the JAX track_step, greedy or Hungarian
    association, LPF or IHGP positions) -- ``track_batch`` at one bank and
    one frame."""
    st, o = track_batch(
        map_state(lambda x: x[None], state), p.dets[None, None], p.det_valid[None, None],
        torch.as_tensor(p.t).reshape(1, 1), config=config, gains_xy=gains_xy,
    )
    return map_state(lambda x: x[0], st), _frame_output(TrackOutputs(*(f[0, 0] for f in o)), p)
