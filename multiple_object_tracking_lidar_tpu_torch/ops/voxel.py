"""Voxel-grid geometry (PCL VoxelGrid semantics): the dense grid's shape and
the f32 voxel index of a point.  Port of the two helpers of
``multiple_object_tracking_lidar_tpu.ops.voxel`` that the dense-grid path
uses; the scatter/sort point-list variants are not ported yet (ROADMAP)."""

from __future__ import annotations

import math

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds


def grid_shape(scene: SceneBounds, leaf_xy: float, leaf_z: float) -> tuple[int, int, int]:
    """Static dense-grid dims covering the scene with floor(p/leaf) indexing."""
    gx = int(math.floor(scene.x_max / leaf_xy) - math.floor(scene.x_min / leaf_xy)) + 1
    gy = int(math.floor(scene.y_max / leaf_xy) - math.floor(scene.y_min / leaf_xy)) + 1
    gz = int(math.floor(scene.z_max / leaf_z) - math.floor(scene.z_min / leaf_z)) + 1
    return gx, gy, gz


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float: the value JAX
    gives ``jnp.float32(x)`` (f64 constant cast to f32, never ``1.0f/leaf``
    computed in f32)."""
    return float(np.float32(x))


def _quantize(points: torch.Tensor, leaf_xy: float, leaf_z: float):
    """Per-axis int32 voxel indices floor(p * f32(1/leaf)): f32
    multiply-by-inverse + floor, as PCL computes them, whatever the compute
    dtype.  The int cast of a NaN or out-of-range value is implementation-
    defined: callers bounds-test the float floor first (K1 does)."""
    p32 = points.to(torch.float32)
    ix = torch.floor(p32[..., 0] * f32(1.0 / leaf_xy)).to(torch.int32)
    iy = torch.floor(p32[..., 1] * f32(1.0 / leaf_xy)).to(torch.int32)
    iz = torch.floor(p32[..., 2] * f32(1.0 / leaf_z)).to(torch.int32)
    return ix, iy, iz
