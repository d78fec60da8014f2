"""Frame recording/replay — the framework's "rosbag".

The reference was validated against a rosbag that is not in its repo
(README.md:37 references bag/gazebo_sim_01.bag).  This module provides the
equivalent affordance natively: record any frame source (live decode or
synthetic Scenario) into a single .npz, replay it deterministically, and
share it as a parity fixture between implementations.

Format (npz):
  points_{k}: (N_k, 3) float32   per frame (ragged)
  stamps:     (F,) float64
  frame_id:   str

Copy of ``multiple_object_tracking_lidar_tpu.io.bag`` (the JAX package
cannot be imported without JAX); tests/test_torch_host.py pins it against
the original.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import (
    PointCloud2,
    decode_pointcloud2,
    make_pointcloud2,
)


def record_bag(path: str, frames: Iterable[PointCloud2]) -> int:
    """Write PointCloud2 frames to an npz bag; returns the frame count."""
    arrays: dict[str, np.ndarray] = {}
    stamps = []
    frame_id = "map"
    n = 0
    for msg in frames:
        pts, mask = decode_pointcloud2(msg, n_max=msg.n_points or 1)
        arrays[f"points_{n}"] = pts[mask]
        stamps.append(msg.stamp)
        frame_id = msg.frame_id
        n += 1
    arrays["stamps"] = np.asarray(stamps, np.float64)
    arrays["frame_id"] = np.frombuffer(frame_id.encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return n


def replay_bag(path: str) -> Iterator[PointCloud2]:
    """Yield PointCloud2 frames from an npz bag."""
    with np.load(path) as z:
        stamps = z["stamps"]
        frame_id = bytes(z["frame_id"].tobytes()).decode() or "map"
        for k in range(len(stamps)):
            yield make_pointcloud2(
                z[f"points_{k}"], stamp=float(stamps[k]), frame_id=frame_id
            )


def bag_info(path: str) -> dict:
    with np.load(path) as z:
        stamps = z["stamps"]
        n_pts = [int(z[f"points_{k}"].shape[0]) for k in range(len(stamps))]
    return {
        "frames": len(stamps),
        "t0": float(stamps[0]) if len(stamps) else 0.0,
        "t1": float(stamps[-1]) if len(stamps) else 0.0,
        "points_min": min(n_pts) if n_pts else 0,
        "points_max": max(n_pts) if n_pts else 0,
    }
