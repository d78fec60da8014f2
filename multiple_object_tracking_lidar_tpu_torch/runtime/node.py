"""Host runtime shell -- the port's equivalent of the ROS node.

Minimal port of ``multiple_object_tracking_lidar_tpu/runtime/node.py``
(ref: src/multiple_object_tracking_lidar_node.cpp:4-33, cloudCallback
cpp:123-233): a map callback that binds the step, a point-cloud callback
that decodes one PointCloud2, steps the tracker on the device and builds
the reference's three outputs, and per-frame stats.  The time_init epoch
fixups (cpp:132-139), the "no map yet" gate (cpp:128-131) and the glibc
colour registry are host code, as in the JAX node.  The node runs on the
card unless the caller passes ``device="cpu"``; without a CUDA device it
raises.

Bank growth (``grow_bank_on_overflow``, the default): a frame that drops
detections because every bank slot was alive doubles ``k_max_tracks``,
pads the bank and rebinds, as the JAX node does (node.py:131-136,
:233-284); the dropped detections re-register on their next sighting.
``checkpoint_extra`` and ``resume`` pair with ``runtime/checkpoint.py``; a
grown bank resumes grown.

``keep_outputs=True`` keeps a host copy of every frame's ``FrameOutput``
in ``outputs`` (off by default: the JAX node keeps only ``stats``);
``run(frames, realtime=True)`` paces a replay at ``config.frequency``.

Online hyperparameter learning (``param_fix=False``, the working form of
the reference's dead IHGP_nonfixed loop, cpp:922-1011; JAX node.py:71-86,
:286-318): the node steps through ``Tracker.bind_env_gains`` with its
current gains, and every ``learn_period`` seconds copies the bank's windows
to the host once, forms each alive track's mean-centred velocity window per
axis as the JAX node's numpy does in the compute dtype (f32 out:
``models/learning.py::velocity_windows``), runs one learning step for both
axes in one K13 launch (``models/learning.py::learning_step_stacked``; the
plain version on the CPU), and swaps in the gains ``Tracker.compute_gains``
derives on the host in f64.  The log-parameters stay f32 whatever the
tracker's dtype, and are not checkpointed (the JAX node saves only the
epoch).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import (
    PointCloud2,
    decode_pointcloud2_named,
)
from multiple_object_tracking_lidar_tpu_torch.models.learning import (
    learning_step_stacked,
    velocity_windows,
)
from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import MapEnv, build_static_mask
from multiple_object_tracking_lidar_tpu_torch.outputs.messages import build_outputs
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
    Frame,
    FrameOutput,
    TrackBank,
    TrackerState,
    gains_from_numpy,
    grow_bank,
    host_numpy,
)
from multiple_object_tracking_lidar_tpu_torch.utils.colors import GlibcRand
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import OccupancyGrid


@dataclasses.dataclass
class FrameStats:
    t: float
    wall_ms: float
    n_points: int
    n_voxels: int
    n_dynamic: int
    n_clusters: int
    n_alive: int
    overflow: int
    nan_velocity: bool = False
    dup_saturated: int = 0
    cc_saturated: int = 0
    assoc_saturated: int = 0


class TrackerNode:
    def __init__(
        self,
        config: TrackerConfig,
        device: torch.device | str = "cuda",
        on_obstacles: Callable | None = None,
        on_markers: Callable | None = None,
        on_pose: Callable | None = None,
        keep_outputs: bool = False,
        use_native: bool = True,
    ):
        self.config = config
        self.tracker = Tracker(config, device)
        # the PointCloud2 decoder the caller chose (``decode_pointcloud2``'s
        # use_native) and the name of the one that ran last
        self.use_native = use_native
        self.decoder: str | None = None
        self.state = self.tracker.init_state()
        self.env: MapEnv | None = None
        self.time_init: float = time.time()  # cpp:74 -- now() at init
        self._first_frame = True
        self._rand = GlibcRand(config.color_seed)  # cpp:75
        self.colors: dict[int, tuple[float, float, float, float]] = {}
        self._known_ids = 0
        self.on_obstacles = on_obstacles
        self.on_markers = on_markers
        self.on_pose = on_pose
        self.stats: list[FrameStats] = []
        # host copies of every frame's FrameOutput, kept only when asked
        # (a node left running would grow without bound; the JAX node keeps
        # only ``stats``)
        self.keep_outputs = keep_outputs
        self.outputs: list[FrameOutput] = []
        self.n_growths = 0                      # bank doublings on overflow
        # online hyperparameter learning (param_fix=False; JAX node.py:71-86)
        self.learning = not config.param_fix
        self.log_params = {
            "x": np.asarray(
                [config.logSigma2_x, config.logMagnSigma2_x, config.logLengthScale_x],
                np.float32,
            ),
            "y": np.asarray(
                [config.logSigma2_y, config.logMagnSigma2_y, config.logLengthScale_y],
                np.float32,
            ),
        }
        self.nll_history: list[tuple[float, float]] = []  # (t, mean NLL x+y)
        self._gains = self.tracker.gains_xy
        self._last_learn_t: float | None = None

    # -- map callback (cpp:235-251) -----------------------------------------
    def on_map(self, grid: OccupancyGrid) -> None:
        self.env = build_static_mask(
            grid, self.config.static_tolarance, self.config.occupied_threshold,
            device=self.tracker.device,
        )
        self._bind()

    def _bind(self) -> None:
        """Bind the step to the map: with the gains an argument when
        learning (JAX node.py:96-99)."""
        if self.learning:
            self._bound_gstep = self.tracker.bind_env_gains(self.env)
        else:
            self._bound_step = self.tracker.bind_env(self.env)

    # -- pointcloud callback (cpp:123-233) ----------------------------------
    def on_pointcloud(self, msg: PointCloud2):
        if self.env is None:
            return None  # map not initialized: skip (cpp:128-131)

        stamp = msg.stamp
        if self._first_frame:
            # the reference's epoch fixups (cpp:132-139), until the first
            # non-empty frame registers tracks
            if stamp < 1.0e9:
                self.time_init = 0.0
            if stamp - self.time_init < 0:
                self.time_init = stamp
        t = stamp - self.time_init

        t0 = time.perf_counter()
        pts, mask, self.decoder = decode_pointcloud2_named(
            msg, self.config.caps.n_max_points, use_native=self.use_native
        )
        dev = self.tracker.device
        frame = Frame(
            points=torch.from_numpy(pts).to(dev),
            mask=torch.from_numpy(mask).to(dev),
            # the stamp in f32 whatever the compute dtype, as the JAX node
            # rounds it (np.float32); an f64 step casts it up
            t=torch.tensor(t, dtype=torch.float32, device=dev),
        )
        if self.learning:
            self.state, out = self._bound_gstep(self.state, frame, self._gains)
        else:
            self.state, out = self._bound_step(self.state, frame)
        out = FrameOutput(*(host_numpy(f) for f in out))
        wall_ms = 1e3 * (time.perf_counter() - t0)
        if self.keep_outputs:
            self.outputs.append(out)

        if int(out.overflow) > 0 and self.config.grow_bank_on_overflow:
            self._grow_bank()
        if self.learning:
            self._maybe_learn(t)

        # NaN watchdog (the reference only logs, cpp:643-646)
        nan_vel = bool(np.isnan(out.vel[out.valid]).any()) if out.valid.any() else False
        if nan_vel:
            logging.getLogger(__name__).error(
                "NaN detected in GP velocity output at t=%.3f (ref cpp:645)", t
            )
        self.stats.append(
            FrameStats(
                t=t,
                wall_ms=wall_ms,
                n_points=int(out.n_points),
                n_voxels=int(out.n_voxels),
                n_dynamic=int(out.n_dynamic),
                n_clusters=int(out.n_clusters),
                n_alive=int(out.n_alive),
                overflow=int(out.overflow),
                nan_velocity=nan_vel,
                dup_saturated=int(out.dup_saturated),
                cc_saturated=int(out.cc_saturated),
                assoc_saturated=int(out.assoc_saturated),
            )
        )
        self._first_frame = self._first_frame and not bool(self.state.initialized)
        self._refresh_colors(int(self.state.next_obj_num))

        if not bool(out.publish):
            return None
        sel = [i for i in range(len(out.valid)) if out.valid[i]]
        obstacles, markers, pose = build_outputs(
            stamp=stamp,
            frame_id=msg.frame_id,
            ids=[int(out.obj_id[i]) for i in sel],
            positions=out.pos[sel],
            velocities=out.vel[sel],
            colors=self.colors,
            obstacle_radius=self.config.obstacle_radius,
        )
        if self.on_obstacles:
            self.on_obstacles(obstacles)
        if self.on_markers:
            self.on_markers(markers)
        if self.on_pose:
            self.on_pose(pose)
        return obstacles, markers, pose

    # -- checkpoint/resume (runtime/checkpoint.py) ---------------------------
    def checkpoint_extra(self) -> dict:
        """Host-side state that save_state's ``extra`` must carry for an
        exact resume (colours regenerate from next_obj_num and the seed, so
        only the epoch is saved)."""
        return {"time_init": self.time_init}

    def resume(self, state: TrackerState, meta: dict | None = None) -> None:
        """Adopt a checkpointed state (``load_state``): k_max_tracks adapts
        to the checkpoint's bank size (a grown bank resumes grown); the
        window length must match the config."""
        l_ckpt = state.bank.window.shape[1]
        if l_ckpt != self.config.data_length:
            raise ValueError(
                f"checkpoint data_length {l_ckpt} != config {self.config.data_length}"
            )
        k_ckpt = state.bank.alive.shape[0]
        if k_ckpt != self.config.caps.k_max_tracks:
            self._rebind(k_ckpt)
        self.state = TrackerState(
            bank=TrackBank(*(f.to(self.tracker.device) for f in state.bank)),
            **{f: getattr(state, f).to(self.tracker.device)
               for f in TrackerState._fields if f != "bank"},
        )
        if meta:
            self.time_init = float(meta.get("time_init", self.time_init))
        self._first_frame = not bool(self.state.initialized)
        self._refresh_colors(int(self.state.next_obj_num))

    def _rebind(self, k_max: int) -> None:
        """A Tracker at ``k_max`` track slots, rebound to the map.  The bound
        step holds no K-sized buffer: K4 and the track back end take K from
        the state."""
        self.config = self.config.replace(
            caps=dataclasses.replace(self.config.caps, k_max_tracks=k_max)
        )
        self.tracker = Tracker(self.config, self.tracker.device)
        if self.env is not None:
            self._bind()

    def _grow_bank(self) -> None:
        """Double k_max_tracks, pad the bank (``grow_bank``), rebind; when
        learning, the gains derived anew from the learned log-parameters
        (JAX node.py:268-276)."""
        k_old = self.config.caps.k_max_tracks
        k_new = 2 * k_old
        self._rebind(k_new)
        self.state = grow_bank(self.state, k_new)
        if self.learning:
            self._set_gains()
        self.n_growths += 1
        logging.getLogger(__name__).warning(
            "track bank overflow: grew k_max_tracks %d -> %d", k_old, k_new
        )

    def _set_gains(self) -> None:
        """The gains of the learned log-parameters: host f64
        (``Tracker.compute_gains``), then on the tracker's device in its
        dtype."""
        _, _, gains = Tracker.compute_gains(
            self.config, tuple(self.log_params["x"]), tuple(self.log_params["y"])
        )
        self._gains = gains_from_numpy(gains, self.tracker.device, self.tracker.dtype)

    def _maybe_learn(self, t: float) -> None:
        """Online hyperparameter learning (JAX node.py:286-318): every
        learn_period seconds, one learning step per axis on the alive
        tracks' mean-centred finite-difference velocity windows -- both
        axes in one K13 launch -- then freshly derived gains swapped into
        the running step."""
        if self._last_learn_t is not None and t - self._last_learn_t < self.config.learn_period:
            return
        alive = self.state.bank.alive.cpu().numpy()
        if not alive.any():
            return
        self._last_learn_t = t
        w = self.state.bank.window.cpu()[torch.from_numpy(alive)]   # (B, L, 4)
        ys = [velocity_windows(w[..., col], self.config.dt_gp) for col in (0, 1)]
        dev = self.tracker.device
        lp = np.stack([self.log_params["x"], self.log_params["y"]])
        new, nll = learning_step_stacked(
            torch.from_numpy(lp).to(dev),
            torch.from_numpy(np.stack(ys)).to(dev),
            torch.ones((2, len(w)), dtype=torch.bool, device=dev),
            self.config.dt_gp,
        )
        new, nll = new.cpu().numpy(), nll.cpu().numpy()
        self.log_params["x"], self.log_params["y"] = new[0], new[1]
        self.nll_history.append((t, float(np.mean([float(nll[0]), float(nll[1])]))))
        self._set_gains()

    def _refresh_colors(self, n_ids: int) -> None:
        while self._known_ids < n_ids:
            r = np.float32(self._rand.rand()) / np.float32(2147483647)
            g = np.float32(self._rand.rand()) / np.float32(2147483647)
            b = np.float32(self._rand.rand()) / np.float32(2147483647)
            self.colors[self._known_ids] = (float(r), float(g), float(b), 0.8)
            self._known_ids += 1

    # -- fixed-rate replay loop (spinNode, cpp:117-121) ----------------------
    def run(self, frames, realtime: bool = False):
        """Drive the node from any iterable of PointCloud2 frames (a "bag");
        with ``realtime``, each frame's callback is padded with a sleep to
        one period of ``config.frequency``, as the JAX node paces a replay
        (runtime/node.py:328-339)."""
        results = []
        period = 1.0 / self.config.frequency
        for msg in frames:
            t0 = time.perf_counter()
            results.append(self.on_pointcloud(msg))
            if realtime:
                leftover = period - (time.perf_counter() - t0)
                if leftover > 0:
                    time.sleep(leftover)
        return results
