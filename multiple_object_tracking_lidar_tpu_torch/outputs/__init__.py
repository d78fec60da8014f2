"""See the package docstring: this subpackage mirrors its JAX counterpart
(the same exports as ``multiple_object_tracking_lidar_tpu/outputs/__init__.py``)."""

from multiple_object_tracking_lidar_tpu_torch.outputs.messages import (
    Obstacle,
    ObstacleArray,
    MarkerArray,
    TextMarker,
    PoseMarkerCloud,
    build_outputs,
)

__all__ = [
    "Obstacle",
    "ObstacleArray",
    "MarkerArray",
    "TextMarker",
    "PoseMarkerCloud",
    "build_outputs",
]
