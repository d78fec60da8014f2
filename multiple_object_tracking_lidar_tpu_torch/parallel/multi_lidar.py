"""Multi-LiDAR merge: several sensors' clouds moved into one frame.

Port of ``multiple_object_tracking_lidar_tpu/parallel/multi_lidar.py`` (the
reference's open TODO, README.md:70: its node subscribes to one
already-merged topic).  Each sensor's padded point tensor is moved by its
rigid extrinsics and the sensors are concatenated into the single padded
frame the tracker consumes.  ``merge_lidar_frames_sharded`` is the form for
sensors that arrive on different ranks: each rank moves its own sensor's
points and one ``all_gather_into_tensor`` over a process group forms the
merged frame on every rank.

The products stay in f32: the rotation is an elementwise multiply and a sum
over the three inputs, never a matmul, so TF32 cannot enter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def rigid_transform(translation, yaw: float, pitch: float = 0.0, roll: float = 0.0) -> np.ndarray:
    """Build a (4, 4) sensor-to-vehicle transform from translation + ZYX Euler."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1.0]])
    ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    rx = np.array([[1.0, 0, 0], [0, cx, -sx], [0, sx, cx]])
    T = np.eye(4)
    T[:3, :3] = rz @ ry @ rx
    T[:3, 3] = np.asarray(translation, dtype=np.float64)
    return T


def _move(points: torch.Tensor, rot: torch.Tensor, trn: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points -> rot @ p + trn, rot (..., 3, 3), trn (..., 3)."""
    moved = (rot[..., None, :, :] * points[..., :, None, :]).sum(dim=-1)
    return moved + trn[..., None, :]


def merge_lidar_frames(
    points: torch.Tensor,      # (S, N, 3) per-sensor padded points
    masks: torch.Tensor,       # (S, N)
    transforms: torch.Tensor,  # (S, 4, 4) sensor -> common frame
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform each sensor's cloud into the common frame and concatenate:
    ((S * N, 3) points, (S * N,) mask), a regular padded frame."""
    tf = transforms.to(points.dtype)
    moved = _move(points, tf[:, :3, :3], tf[:, :3, 3])
    s, n, _ = moved.shape
    return moved.reshape(s * n, 3), masks.reshape(s * n)


def merge_lidar_frames_sharded(
    points: torch.Tensor,      # (N_local, 3) this rank's sensor
    mask: torch.Tensor,        # (N_local,)
    transform: torch.Tensor,   # (4, 4)
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each rank moves its own sensor's points, then one all-gather over
    ``group`` (the default group when None) forms the merged frame, sensors
    in rank order, on every rank."""
    tf = transform.to(points.dtype)
    moved = _move(points, tf[:3, :3], tf[:3, 3]).contiguous()
    world = dist.get_world_size(group)
    merged = moved.new_empty((world * moved.shape[0], 3))
    dist.all_gather_into_tensor(merged, moved, group=group)
    m = mask.to(torch.uint8).contiguous()
    merged_mask = m.new_empty((world * m.shape[0],))
    dist.all_gather_into_tensor(merged_mask, m, group=group)
    return merged, merged_mask.to(torch.bool)
