"""See the package docstring: this subpackage mirrors its JAX counterpart
(the same exports as ``multiple_object_tracking_lidar_tpu/io/__init__.py``)."""

from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import (
    PointCloud2,
    PointField,
    decode_pointcloud2,
    make_pointcloud2,
)
from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject

__all__ = [
    "PointCloud2",
    "PointField",
    "decode_pointcloud2",
    "make_pointcloud2",
    "Scenario",
    "ScenarioObject",
]
