"""One device serving several LiDAR streams: host multiplexing.

Port of ``multiple_object_tracking_lidar_tpu/runtime/fleet.py``.  N
independent streams share one bound step (``Tracker.bind_env``); each
stream owns a TrackerState and frames dispatch round robin (or on arrival)
on one device, in arrival order on its current stream, as the JAX package
dispatches them on one queue.  ``parallel.sharding.ShardedTracker`` is the
form that batches the streams of one step.

Warm-up: the constructor steps every stream once with an example frame (by
default an empty one: no detections, so no state change, ref
cpp:146-150), so that the kernel build and the allocator's first requests
fall before the first real frame, then starts every stream afresh.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import MapEnv
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, FrameOutput, TrackerState


class MultiplexedTracker:
    """``step(stream_id, frame)`` over ``n_streams`` independent streams,
    one bound step."""

    def __init__(
        self,
        tracker: Tracker,
        env: MapEnv,
        n_streams: int,
        warm: bool = True,
        example_frame: Frame | None = None,
    ):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.tracker = tracker
        self._step = tracker.bind_env(env)
        self._states: list[TrackerState] = [tracker.init_state() for _ in range(n_streams)]
        if warm:
            if example_frame is None:
                n = tracker.config.caps.n_max_points
                dev = tracker.device
                example_frame = Frame(
                    points=torch.zeros((n, 3), dtype=torch.float32, device=dev),
                    mask=torch.zeros((n,), dtype=torch.bool, device=dev),
                    t=torch.zeros((), dtype=torch.float32, device=dev),
                )
            for s in range(n_streams):
                self._states[s], out = self._step(self._states[s], example_frame)
            bool(out.publish)  # wait for the warm-up to finish
            self._states = [tracker.init_state() for _ in range(n_streams)]

    @property
    def n_streams(self) -> int:
        return len(self._states)

    def step(self, stream_id: int, frame: Frame) -> FrameOutput:
        """Track one frame of one stream; other streams are untouched."""
        self._states[stream_id], out = self._step(self._states[stream_id], frame)
        return out

    def reset_stream(self, stream_id: int) -> None:
        """Forget a stream's tracks (e.g. sensor reconnect)."""
        self._states[stream_id] = self.tracker.init_state()

    def state(self, stream_id: int) -> TrackerState:
        return self._states[stream_id]
