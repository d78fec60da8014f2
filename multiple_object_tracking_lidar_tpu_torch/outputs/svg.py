"""Dependency-free SVG trajectory rendering — the RViz-config equivalent.

The reference's observable contract is its RViz display set (ref:
rviz/tracker_config.rviz — map, input cloud, speed markers, pose cloud;
SURVEY C23).  This renders the same contract to a standalone SVG: occupancy
map underlay, per-track trajectories in the track's registration color
(glibc srand(5323) parity), current positions, and 2-significant-digit speed
labels — viewable anywhere, no ROS.

Copy of ``multiple_object_tracking_lidar_tpu.outputs.svg`` (the JAX
package cannot be imported without JAX); tests/test_torch_host.py pins it
against the original.
"""

from __future__ import annotations

import numpy as np

from multiple_object_tracking_lidar_tpu_torch.utils.pgm import OccupancyGrid


def render_svg(
    grid: OccupancyGrid | None,
    tracks: dict[int, list[tuple[float, float]]],
    colors: dict[int, tuple[float, float, float, float]],
    speeds: dict[int, float] | None = None,
    scale: float = 60.0,
) -> str:
    """tracks: obj_id -> [(x, y), ...] trajectory in map frame."""
    if grid is not None:
        info = grid.info
        x0, y0 = info.origin_x, info.origin_y
        w_m = info.width * info.resolution
        h_m = info.height * info.resolution
    else:
        xs = [p[0] for t in tracks.values() for p in t] or [0.0]
        ys = [p[1] for t in tracks.values() for p in t] or [0.0]
        x0, y0 = min(xs) - 1, min(ys) - 1
        w_m, h_m = max(xs) - x0 + 2, max(ys) - y0 + 2

    W, H = int(w_m * scale), int(h_m * scale)

    def sx(x: float) -> float:
        return (x - x0) * scale

    def sy(y: float) -> float:
        return H - (y - y0) * scale  # y up

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" '
        f'viewBox="0 0 {W} {H}">',
        f'<rect width="{W}" height="{H}" fill="#fafafa"/>',
    ]

    if grid is not None:
        # occupied cells as rects (sparse; maps are small)
        occ = np.argwhere(grid.data > 50)
        res = grid.info.resolution
        cell = res * scale
        for r, c in occ:
            cx = sx(x0 + c * res)
            cy = sy(y0 + (r + 1) * res)
            parts.append(
                f'<rect x="{cx:.1f}" y="{cy:.1f}" width="{cell:.2f}" '
                f'height="{cell:.2f}" fill="#444"/>'
            )

    for oid, traj in sorted(tracks.items()):
        r, g, b, a = colors.get(oid, (0.2, 0.2, 0.8, 0.8))
        col = f"rgb({int(255*r)},{int(255*g)},{int(255*b)})"
        if len(traj) > 1:
            pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in traj)
            parts.append(
                f'<polyline points="{pts}" fill="none" stroke="{col}" '
                f'stroke-width="2" stroke-opacity="{a}"/>'
            )
        x, y = traj[-1]
        parts.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="5" fill="{col}"/>')
        label = f"id {oid}"
        if speeds and oid in speeds:
            label += f": {speeds[oid]:.2g} m/s"  # setprecision(2) semantics
        parts.append(
            f'<text x="{sx(x)+8:.1f}" y="{sy(y)-8:.1f}" font-size="13" '
            f'font-family="sans-serif" fill="#222">{label}</text>'
        )

    parts.append("</svg>")
    return "\n".join(parts)
