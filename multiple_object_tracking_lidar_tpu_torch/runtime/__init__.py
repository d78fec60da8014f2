"""See the package docstring: this subpackage mirrors its JAX counterpart
(the same exports as ``multiple_object_tracking_lidar_tpu/runtime/__init__.py``)."""

from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.runtime.checkpoint import save_state, load_state

__all__ = ["TrackerNode", "save_state", "load_state"]
