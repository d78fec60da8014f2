"""See the package docstring: this subpackage mirrors its JAX counterpart
(the same exports as ``multiple_object_tracking_lidar_tpu/models/__init__.py``)."""

from multiple_object_tracking_lidar_tpu_torch.models.matern32 import Matern32SSM, matern32_ssm
from multiple_object_tracking_lidar_tpu_torch.models.ihgp import (
    IHGPGains,
    dare_fixed_point,
    stationary_gains,
    ihgp_filter_smoother,
    ihgp_batch,
)
from multiple_object_tracking_lidar_tpu_torch.models.lpf import lpf_pos

__all__ = [
    "Matern32SSM",
    "matern32_ssm",
    "IHGPGains",
    "dare_fixed_point",
    "stationary_gains",
    "ihgp_filter_smoother",
    "ihgp_batch",
    "lpf_pos",
]
