"""PGM occupancy-map loading with ROS map_server semantics.

The reference consumes a nav_msgs/OccupancyGrid produced by map_server from
``map/sim_01.{yaml,pgm}`` (ref: map/sim_01.yaml, mapCallback cpp:235-251).
We load the same assets directly: trinary conversion
  p = (255 - v) / 255           (negate=0)
  p > occupied_thresh -> 100;  p < free_thresh -> 0;  else -1 (unknown)
Row 0 of the OccupancyGrid is the *bottom* row of the image (map_server
flips the image vertically).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class MapInfo:
    """Mirror of nav_msgs/MapMetaData fields the reference uses."""

    resolution: float
    width: int
    height: int
    origin_x: float
    origin_y: float
    origin_yaw: float = 0.0  # reference extracts yaw from the origin quaternion (cpp:676)


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    info: MapInfo
    data: np.ndarray  # (height, width) int8, row-major like map_copy (cpp:241-248)


def load_pgm(path: str) -> np.ndarray:
    """Minimal binary (P5) / ascii (P2) PGM reader -> (H, W) uint8."""
    with open(path, "rb") as f:
        raw = f.read()

    # tokenize header, skipping comments
    tokens: list[bytes] = []
    i = 0
    while len(tokens) < 4:
        while i < len(raw) and raw[i : i + 1].isspace():
            i += 1
        if raw[i : i + 1] == b"#":
            while i < len(raw) and raw[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(raw) and not raw[j : j + 1].isspace():
            j += 1
        tokens.append(raw[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P5":
        i += 1  # single whitespace after maxval
        img = np.frombuffer(raw, dtype=np.uint8, count=w * h, offset=i)
        return img.reshape(h, w).copy()
    if magic == b"P2":
        vals = np.fromstring(raw[i:], dtype=int, sep=" ")  # pragma: no cover
        return vals[: w * h].astype(np.uint8).reshape(h, w)
    raise ValueError(f"unsupported PGM magic {magic!r}")


def load_map_yaml(yaml_path: str) -> OccupancyGrid:
    """Load a map_server-style map YAML + PGM into an OccupancyGrid."""
    meta: dict[str, str] = {}
    with open(yaml_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, _, v = line.partition(":")
            meta[k.strip()] = v.strip()

    image = meta["image"]
    if not os.path.isabs(image):
        image = os.path.join(os.path.dirname(yaml_path), image)
    resolution = float(meta["resolution"])
    origin = [float(x) for x in meta["origin"].strip("[]").split(",")]
    negate = int(meta.get("negate", "0"))
    occ_th = float(meta.get("occupied_thresh", "0.65"))
    free_th = float(meta.get("free_thresh", "0.196"))

    img = load_pgm(image).astype(np.float64)
    # map_server trinary conversion
    p = img / 255.0 if negate else (255.0 - img) / 255.0
    grid = np.full(img.shape, -1, dtype=np.int8)
    grid[p > occ_th] = 100
    grid[p < free_th] = 0
    # OccupancyGrid row 0 = bottom image row
    grid = grid[::-1, :].copy()

    h, w = grid.shape
    info = MapInfo(
        resolution=resolution,
        width=w,
        height=h,
        origin_x=origin[0],
        origin_y=origin[1],
        origin_yaw=origin[2] if len(origin) > 2 else 0.0,
    )
    return OccupancyGrid(info=info, data=grid)
