"""Live streaming runtime: asynchronous dispatch ring + TCP transport.

Port of ``multiple_object_tracking_lidar_tpu/runtime/stream.py``.  The
reference consumes a live sensor topic at 10 Hz in a synchronous callback
(ref cloudCallback, src/multiple_object_tracking_lidar.cpp:123-233);
``TrackerNode.on_pointcloud`` mirrors that shape and reads every frame's
outputs back before it returns.  This module adds the ingest path that
reads them later:

  * ``StreamingNode`` -- decode and dispatch each frame, start the copy of
    its small outputs to pinned host buffers (``.to("cpu",
    non_blocking=True)``) and record a CUDA event behind them; a frame's
    outputs are read only when ``depth`` newer frames are in flight, or at
    ``flush()``, by waiting on its event.  The state chain is the sync
    node's; only when results are read back changes.  (``track_step``
    still reads one value per frame on the host, so the ring overlaps the
    output copies and the host's decode, not whole steps.)
  * ``serve()`` -- a length-prefixed TCP endpoint (``io/wire.py`` framing):
    PointCloud2 frames in, typed ObstacleArray/MarkerArray/pose records
    out (the reference's 2-subs/3-pubs surface, cpp:61-72, minus ROS).

A map must arrive before frames, exactly like the reference (cpp:128-131):
either call ``on_map`` up front or send a ``{"type": "map", ...}`` message.
"""

from __future__ import annotations

import collections
import socket
import threading
import time
from typing import Callable

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.io import wire
from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import PointCloud2, decode_pointcloud2_named
from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import MapEnv, build_static_mask
from multiple_object_tracking_lidar_tpu_torch.outputs.messages import build_outputs
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, FrameOutput, host_numpy
from multiple_object_tracking_lidar_tpu_torch.utils.colors import GlibcRand
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import MapInfo, OccupancyGrid


class StreamingNode:
    """Async-dispatch tracking node: ``submit()`` returns once the step and
    its output copies are queued on the device; outputs surface through the
    callback ``depth`` frames later (or at ``flush()``).  Runs on the card
    unless ``device="cpu"``."""

    def __init__(
        self,
        config: TrackerConfig,
        on_outputs: Callable | None = None,
        depth: int = 2,
        device: torch.device | str = "cuda",
        use_native: bool = True,
    ):
        self.config = config
        self.tracker = Tracker(config, device)
        # the PointCloud2 decoder the caller chose and the one that ran last
        self.use_native = use_native
        self.decoder: str | None = None
        self.state = self.tracker.init_state()
        self.on_outputs = on_outputs
        self.depth = max(1, int(depth))
        self.env: MapEnv | None = None
        self.time_init = time.time()
        self._first_frame = True
        self._rand = GlibcRand(config.color_seed)
        self.colors: dict[int, tuple[float, float, float, float]] = {}
        self._known_ids = 0
        self._pending: collections.deque = collections.deque()
        self.frames_in = 0
        self.frames_out = 0
        self.decode_ms: list[float] = []
        self.dispatch_ms: list[float] = []
        self.drain_ms: list[float] = []

    # -- map ingestion (cpp:235-251) -----------------------------------------
    def on_map(self, grid: OccupancyGrid) -> None:
        dev = self.tracker.device
        self.env = build_static_mask(
            grid, self.config.static_tolarance, self.config.occupied_threshold, device=dev
        )
        self._bound_step = self.tracker.bind_env(self.env)
        # prewarm: the kernel build and one throwaway step now, so the first
        # live frame is not a stall (the map gates frames anyway)
        n = self.config.caps.n_max_points
        dummy = Frame(
            points=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            mask=torch.zeros((n,), dtype=torch.bool, device=dev),
            t=torch.zeros((), dtype=torch.float32, device=dev),
        )
        _, out = self._bound_step(self.tracker.init_state(), dummy)
        bool(out.publish)

    # -- hot path ------------------------------------------------------------
    def submit(self, msg: PointCloud2) -> None:
        """Decode + dispatch; does not wait for the device."""
        if self.env is None:
            return
        stamp = msg.stamp
        if self._first_frame:
            # epoch fixups (cpp:132-139).  The sync TrackerNode re-applies
            # these until the first non-empty frame; here they run once --
            # equivalent for monotone stamp streams (both fixups are no-ops
            # on every later frame once applied), and the async ring cannot
            # know emptiness at submit time.
            if stamp < 1.0e9:
                self.time_init = 0.0
            if stamp - self.time_init < 0:
                self.time_init = stamp
            self._first_frame = False
        t = stamp - self.time_init

        t0 = time.perf_counter()
        pts, mask, self.decoder = decode_pointcloud2_named(
            msg, self.config.caps.n_max_points, use_native=self.use_native
        )
        t1 = time.perf_counter()
        dev = self.tracker.device
        frame = Frame(
            points=torch.from_numpy(pts).to(dev),
            mask=torch.from_numpy(mask).to(dev),
            # the stamp in f32 whatever the compute dtype, as the JAX node
            # rounds it (np.float32); an f64 step casts it up
            t=torch.tensor(t, dtype=torch.float32, device=dev),
        )
        self.state, out = self._bound_step(self.state, frame)
        # start the small outputs' device-to-host copies now, into pinned
        # buffers, and mark their end: the drain then waits only for them
        host = FrameOutput(*(f.to("cpu", non_blocking=True) for f in out))
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        t2 = time.perf_counter()
        self.decode_ms.append(1e3 * (t1 - t0))
        self.dispatch_ms.append(1e3 * (t2 - t1))
        self.frames_in += 1
        self._pending.append((stamp, msg.frame_id, host, event))
        while len(self._pending) > self.depth:
            self._drain_one()

    def flush(self) -> None:
        while self._pending:
            self._drain_one()

    def _drain_one(self) -> None:
        stamp, frame_id, out, event = self._pending.popleft()
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()          # waits only until THIS frame's copies land
        out = FrameOutput(*(host_numpy(f) for f in out))
        self.drain_ms.append(1e3 * (time.perf_counter() - t0))
        self.frames_out += 1
        if not bool(out.publish):
            return
        sel = [i for i in range(len(out.valid)) if out.valid[i]]
        ids = [int(out.obj_id[i]) for i in sel]
        if ids:
            self._refresh_colors(max(ids) + 1)
        obstacles, markers, pose = build_outputs(
            stamp=stamp,
            frame_id=frame_id,
            ids=ids,
            positions=out.pos[sel],
            velocities=out.vel[sel],
            colors=self.colors,
            obstacle_radius=self.config.obstacle_radius,
        )
        if self.on_outputs:
            self.on_outputs(obstacles, markers, pose)

    def _refresh_colors(self, n_ids: int) -> None:
        while self._known_ids < n_ids:
            r = np.float32(self._rand.rand()) / np.float32(2147483647)
            g = np.float32(self._rand.rand()) / np.float32(2147483647)
            b = np.float32(self._rand.rand()) / np.float32(2147483647)
            self.colors[self._known_ids] = (float(r), float(g), float(b), 0.8)
            self._known_ids += 1

    def summary(self) -> dict:
        def pct(xs, q):
            return round(float(np.percentile(xs, q)), 3) if xs else None

        return {
            "frames": self.frames_out,
            "decoder": self.decoder,
            "decode_ms_p50": pct(self.decode_ms, 50),
            "dispatch_ms_p50": pct(self.dispatch_ms, 50),
            "dispatch_ms_p99": pct(self.dispatch_ms, 99),
            "drain_ms_p50": pct(self.drain_ms, 50),
            "drain_ms_p99": pct(self.drain_ms, 99),
        }


def serve(
    node: StreamingNode,
    host: str = "127.0.0.1",
    port: int = 18323,
    max_frames: int | None = None,
    ready: threading.Event | None = None,
) -> dict:
    """Serve one client connection: frames in, output records out.  Returns
    the node's latency summary when the client disconnects (or after
    ``max_frames``)."""
    srv = socket.create_server((host, port))
    try:
        if ready is not None:
            ready.set()
        conn, _ = srv.accept()
        with conn:
            rfile = conn.makefile("rb")
            wfile = conn.makefile("wb")
            wlock = threading.Lock()

            def on_outputs(obstacles, markers, pose):
                with wlock:
                    wire.write_record(wfile, obstacles)
                    wire.write_record(wfile, markers)
                    wire.write_record(wfile, pose)
                    wfile.flush()

            node.on_outputs = on_outputs
            n = 0
            while max_frames is None or n < max_frames:
                msg = wire.read_message(rfile)
                if msg is None:
                    break
                if isinstance(msg, PointCloud2):
                    node.submit(msg)
                    n += 1
                elif isinstance(msg, tuple) and msg[0] == "map":
                    d = msg[1]
                    grid = OccupancyGrid(
                        data=np.asarray(d["data"], dtype=np.int8),
                        info=MapInfo(**d["info"]),
                    )
                    node.on_map(grid)
            node.flush()
            summary = node.summary()
            with wlock:
                wire.write_json(wfile, "summary", summary)
                wfile.flush()
            return summary
    finally:
        srv.close()
