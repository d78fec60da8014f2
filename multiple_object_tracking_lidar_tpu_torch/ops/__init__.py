"""See the package docstring: this subpackage mirrors its JAX counterpart
(the same exports as ``multiple_object_tracking_lidar_tpu/ops/__init__.py``)."""

from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_downsample_dense, voxel_downsample_sort
from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask, remove_static
from multiple_object_tracking_lidar_tpu_torch.ops.cluster import euclidean_cluster
from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features
from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points

__all__ = [
    "voxel_downsample_dense",
    "voxel_downsample_sort",
    "build_static_mask",
    "remove_static",
    "euclidean_cluster",
    "circumcenter_features",
    "compact_points",
]
