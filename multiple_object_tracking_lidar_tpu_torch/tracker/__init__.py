"""See the package docstring: this subpackage mirrors its JAX counterpart
(the same exports as ``multiple_object_tracking_lidar_tpu/tracker/__init__.py``)."""

from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackerState, TrackBank, Frame, FrameOutput
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

__all__ = ["TrackerState", "TrackBank", "Frame", "FrameOutput", "Tracker"]
