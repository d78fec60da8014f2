"""Synthetic scenario generation.

The reference was validated by replaying a gazebo rosbag that is not part of
its repo (ref: README.md:31-46 references bag/gazebo_sim_01.bag).  This module
is the stand-in: it synthesizes LiDAR-like PointCloud2 frames over the bundled
``map/sim_01`` occupancy grid — wall returns on occupied cells (which the
static filter must remove) plus moving disk objects (which must be clustered
and tracked).  Deterministic given a seed, so tests and benchmarks replay the
exact same "bag".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np

from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import PointCloud2, make_pointcloud2
from multiple_object_tracking_lidar_tpu_torch.utils.pgm import OccupancyGrid


@dataclasses.dataclass
class ScenarioObject:
    """A moving disk of LiDAR returns (a person/robot-sized obstacle)."""

    x0: float
    y0: float
    vx: float
    vy: float
    radius: float = 0.25
    points_per_frame: int = 120
    z_height: float = 0.3
    # piecewise-linear patrol: reverse direction every `turn_every` seconds
    turn_every: float = 1e9

    def position(self, t: float) -> tuple[float, float]:
        if self.turn_every >= 1e8:
            return self.x0 + self.vx * t, self.y0 + self.vy * t
        # triangle-wave patrol between start and the turn point
        period = 2.0 * self.turn_every
        tau = t % period
        leg = tau if tau < self.turn_every else (period - tau)
        return self.x0 + self.vx * leg, self.y0 + self.vy * leg

    def velocity(self, t: float) -> tuple[float, float]:
        if self.turn_every >= 1e8:
            return self.vx, self.vy
        tau = t % (2.0 * self.turn_every)
        s = 1.0 if tau < self.turn_every else -1.0
        return s * self.vx, s * self.vy


@dataclasses.dataclass
class Scenario:
    """Frame source: yields PointCloud2 messages at a fixed rate."""

    grid: OccupancyGrid | None
    objects: list[ScenarioObject]
    frequency: float = 10.0
    static_points_per_frame: int = 4000
    noise_sigma: float = 0.01
    seed: int = 0
    t0: float = 0.0
    frame_id: str = "map"
    # optional uniform clutter to stress point capacity (e.g. 100k-pt bench)
    clutter_points: int = 0
    clutter_bounds: tuple[float, float, float, float] = (-2.0, 2.0, -1.0, 9.0)
    clutter_z: tuple[float, float] = (0.0, 1.0)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        if self.grid is not None:
            occ = np.argwhere(self.grid.data > 50)  # (row, col) of occupied cells
            info = self.grid.info
            # cell centers in map frame (origin yaw assumed 0 for sim_01)
            self._occ_xy = np.stack(
                [
                    info.origin_x + (occ[:, 1] + 0.5) * info.resolution,
                    info.origin_y + (occ[:, 0] + 0.5) * info.resolution,
                ],
                axis=1,
            ).astype(np.float32)
        else:
            self._occ_xy = np.zeros((0, 2), dtype=np.float32)

    def frame_arrays(self, k: int) -> tuple[np.ndarray, float]:
        """Raw (N, 3) float32 points + timestamp for frame index k."""
        t = k / self.frequency
        rng = np.random.default_rng((self.seed, k))
        parts: list[np.ndarray] = []

        if self._occ_xy.shape[0] and self.static_points_per_frame:
            idx = rng.integers(0, self._occ_xy.shape[0], self.static_points_per_frame)
            base = self._occ_xy[idx]
            pts = np.concatenate(
                [
                    base + rng.normal(0, self.noise_sigma, base.shape).astype(np.float32),
                    rng.uniform(0.05, 0.5, (base.shape[0], 1)).astype(np.float32),
                ],
                axis=1,
            )
            parts.append(pts)

        for obj in self.objects:
            cx, cy = obj.position(t)
            ang = rng.uniform(0, 2 * math.pi, obj.points_per_frame)
            rad = obj.radius * np.sqrt(rng.uniform(0.25, 1.0, obj.points_per_frame))
            pts = np.stack(
                [
                    cx + rad * np.cos(ang),
                    cy + rad * np.sin(ang),
                    rng.uniform(0.05, obj.z_height, obj.points_per_frame),
                ],
                axis=1,
            ).astype(np.float32)
            pts[:, :2] += rng.normal(0, self.noise_sigma, (obj.points_per_frame, 2)).astype(
                np.float32
            )
            parts.append(pts)

        if self.clutter_points:
            x0, x1, y0, y1 = self.clutter_bounds
            pts = np.stack(
                [
                    rng.uniform(x0, x1, self.clutter_points),
                    rng.uniform(y0, y1, self.clutter_points),
                    rng.uniform(*self.clutter_z, self.clutter_points),
                ],
                axis=1,
            ).astype(np.float32)
            parts.append(pts)

        xyz = (
            np.concatenate(parts, axis=0)
            if parts
            else np.zeros((0, 3), dtype=np.float32)
        )
        return xyz, self.t0 + t

    def frame(self, k: int) -> PointCloud2:
        xyz, stamp = self.frame_arrays(k)
        return make_pointcloud2(xyz, stamp=stamp, frame_id=self.frame_id, extra_padding=4)

    def frames(self, n: int) -> Iterator[PointCloud2]:
        for k in range(n):
            yield self.frame(k)

    def ground_truth(self, k: int) -> list[dict]:
        """Object poses/velocities at frame k, for accuracy metrics."""
        t = k / self.frequency
        out = []
        for obj in self.objects:
            x, y = obj.position(t)
            vx, vy = obj.velocity(t)
            out.append({"x": x, "y": y, "vx": vx, "vy": vy})
        return out


def sim01_scenario(
    map_dir: str, n_objects: int = 2, yaml_name: str = "sim_map.yaml", **kw
) -> Scenario:
    """The canonical test scenario over the bundled fixture map (the
    regenerable stand-in for the reference's sim_01 scene)."""
    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml
    import os

    grid = load_map_yaml(os.path.join(map_dir, yaml_name))
    objs = [
        ScenarioObject(x0=0.0, y0=1.0, vx=0.0, vy=0.45, turn_every=8.0),
        ScenarioObject(x0=-0.8, y0=4.0, vx=0.35, vy=0.0, turn_every=6.0),
        ScenarioObject(x0=0.9, y0=6.5, vx=-0.25, vy=0.25, turn_every=7.0),
    ][:n_objects]
    return Scenario(grid=grid, objects=objs, **kw)
