"""Output message surface — typed equivalents of the reference's ROS topics.

Mirrors field-for-field what the reference publishes:

* ``ObstacleArray`` <-> costmap_converter/ObstacleArrayMsg on
  ``move_base/TebLocalPlannerROS/obstacles`` (ref publishObstacles,
  src/multiple_object_tracking_lidar.cpp:253-295): per-track id, radius 0.3,
  twist.linear = velocity, covariance diag [.1, .1, 1e9, 1e9, 1e9, .1],
  1-point polygon = position.  (The reference re-publishes the growing array
  INSIDE its fill loop, cpp:293 — i+1 sends per frame; we normalize to one,
  as SURVEY C18 flags.)

* ``MarkerArray`` <-> visualization_msgs/MarkerArray on ``tracker_viz``
  (publishMarkers cpp:297-421): TEXT_VIEW_FACING speed labels, id = 2*objID+1,
  scale.z = 0.22, white, text = speed to 2 significant digits (std::ostringstream
  << setprecision(2), cpp:373-377).

* ``PoseMarkerCloud`` <-> sensor_msgs/PointCloud on ``pose_marker``
  (cpp:300-321): positions + intensity channel = 255 * color.g with the
  per-track color drawn from glibc rand() seeded 5323 (cpp:75, 537-542) —
  reproduced exactly by utils.colors.

Everything here is a plain dataclass tree; serialization to JSON (or a live
rosbridge shim) is the runtime's concern.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# covariance constants, cpp:279-284
_COV = (0.1, 0.1, 1e9, 1e9, 1e9, 0.1)


@dataclasses.dataclass
class Obstacle:
    id: int
    radius: float            # 0.3 (cpp:267)
    position: tuple[float, float, float]
    velocity: tuple[float, float, float]
    covariance_diag: tuple[float, ...] = _COV


@dataclasses.dataclass
class ObstacleArray:
    stamp: float
    frame_id: str
    obstacles: list[Obstacle]


@dataclasses.dataclass
class TextMarker:
    id: int                   # 2*objID + 1 (cpp:356)
    position: tuple[float, float, float]
    text: str                 # speed, 2 significant digits (cpp:373-377)
    scale_z: float = 0.22
    color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass
class MarkerArray:
    frame_id: str
    markers: list[TextMarker]


@dataclasses.dataclass
class PoseMarkerCloud:
    frame_id: str
    points: list[tuple[float, float, float]]
    intensity: list[float]    # 255 * color.g per track (cpp:317)


def _speed_text(vx: float, vy: float) -> str:
    """round(speed*100)/100 then 2 *significant* digits, exactly like
    std::ostringstream << std::setprecision(2) (cpp:373-377)."""
    speed = round(np.hypot(vx, vy) * 100.0) / 100.0
    return f"{speed:.2g}"


def build_outputs(
    stamp: float,
    frame_id: str,
    ids: list[int],
    positions: np.ndarray,     # (D, 2)
    velocities: np.ndarray,    # (D, 2)
    colors: dict[int, tuple[float, float, float, float]],
    obstacle_radius: float = 0.3,
) -> tuple[ObstacleArray, MarkerArray, PoseMarkerCloud]:
    """Assemble the full per-frame output surface from device results."""
    obstacles = []
    markers = []
    pose_pts = []
    pose_int = []
    for i, oid in enumerate(ids):
        px, py = float(positions[i][0]), float(positions[i][1])
        vx, vy = float(velocities[i][0]), float(velocities[i][1])
        obstacles.append(
            Obstacle(
                id=int(oid),
                radius=obstacle_radius,
                position=(px, py, 0.0),
                velocity=(vx, vy, 0.0),
            )
        )
        markers.append(
            TextMarker(id=2 * int(oid) + 1, position=(px, py, 0.0), text=_speed_text(vx, vy))
        )
        pose_pts.append((px, py, 0.0))
        color = colors.get(int(oid), (0.0, 0.0, 0.0, 0.8))
        pose_int.append(255.0 * color[1])

    return (
        ObstacleArray(stamp=stamp, frame_id=frame_id, obstacles=obstacles),
        MarkerArray(frame_id=frame_id, markers=markers),
        PoseMarkerCloud(frame_id=frame_id, points=pose_pts, intensity=pose_int),
    )
