"""Static-point removal against an occupancy-grid map.

Port of ``multiple_object_tracking_lidar_tpu/ops/static_mask.py`` (ref
removeStatic, src/multiple_object_tracking_lidar.cpp:664-706): the map is
dilated once on the host (``build_static_mask``).  The per-frame test is an
f32 rotate into map coordinates and truncation toward zero (C float
arithmetic), then a map lookup: on the dense grid, each scene cell's small
window of the map packed into drop bits (``build_cell_static_table``,
``remove_static_cells``); on the point list, one gather into the dilated
map per point (``remove_static``), which works for every map, including
those whose cell window passes 32 bits.  The builders are numpy, as in the
JAX package, and produce tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.utils.pgm import OccupancyGrid


class MapEnv(NamedTuple):
    """Map constants consumed by the step (same fields as the JAX MapEnv),
    plus ``host``: the f64 values the table builder reads, kept beside the
    f32 tensors as the JAX package keeps its host mirror."""

    dilated: torch.Tensor         # (H, W) bool — True = drop points here
    origin_x: torch.Tensor        # f32 scalars
    origin_y: torch.Tensor
    cos_nyaw: torch.Tensor        # cos(-yaw), sin(-yaw) of the map origin
    sin_nyaw: torch.Tensor
    inv_resolution: torch.Tensor
    host: tuple | None = None     # (dilated np, ox, oy, cos, sin, inv_res) f64


def build_static_mask(
    grid: OccupancyGrid,
    tolarance: int,
    occupied_threshold: int = 50,
    device: torch.device | str = "cpu",
) -> MapEnv:
    """Precompute the dilated static mask for a map (host, once per map)."""
    data = np.asarray(grid.data)
    occ = (data > occupied_threshold) | (data == -1)

    t = int(tolarance)
    if t > 0:
        # (2t+1)^2 max-pool dilation; out-of-map neighbors treated as edge
        padded = np.pad(occ, t, mode="edge")
        h, w = occ.shape
        dil = np.zeros_like(occ)
        for di in range(2 * t + 1):
            for dj in range(2 * t + 1):
                dil |= padded[di : di + h, dj : dj + w]
        occ = dil

    yaw = grid.info.origin_yaw
    host = (
        np.asarray(occ),
        float(grid.info.origin_x),
        float(grid.info.origin_y),
        float(math.cos(-yaw)),
        float(math.sin(-yaw)),
        float(1.0 / grid.info.resolution),
    )
    scal = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return MapEnv(
        dilated=torch.as_tensor(occ, device=device),
        origin_x=scal(host[1]),
        origin_y=scal(host[2]),
        cos_nyaw=scal(host[3]),
        sin_nyaw=scal(host[4]),
        inv_resolution=scal(host[5]),
        host=host,
    )


def host_env_view(env: MapEnv):
    """(dilated_np, ox, oy, cos, sin, inv_res): the f64 host values when the
    env was built here, else its (f32) tensor values."""
    if env.host is not None:
        return env.host
    return (
        env.dilated.cpu().numpy(),
        float(env.origin_x),
        float(env.origin_y),
        float(env.cos_nyaw),
        float(env.sin_nyaw),
        float(env.inv_resolution),
    )


class CellStaticTable(NamedTuple):
    """Per-scene-grid-cell drop-bit window (dense-grid path only): a cell's
    centroid can only land in a small window of map pixels, so the lookup
    is a bit extraction."""

    base_row: torch.Tensor   # (n_cells,) i32 — window origin per cell
    base_col: torch.Tensor   # (n_cells,) i32
    bits: torch.Tensor       # (n_cells,) i32 — bit (qr*k+qc) set = DROP
    k: int                   # window edge length (k*k <= 32)


def build_cell_static_table(
    env: MapEnv,
    scene,
    leaf_xy: float,
    gx: int,
    gy: int,
    gz: int,
) -> CellStaticTable | None:
    """Host precompute of the per-cell drop-bit windows, on the env's
    device.  Returns None when a window exceeds 32 bits."""
    dil, ox, oy, cos, sin, inv_res = host_env_view(env)
    h, w = dil.shape
    # window edge: map-space span of one cell (+1 pixel straddle, +2 f32 fuzz)
    span = leaf_xy * (abs(cos) + abs(sin)) * inv_res
    k = int(np.ceil(span)) + 3
    if k * k > 32:
        return None

    bx = math.floor(scene.x_min / leaf_xy)
    by = math.floor(scene.y_min / leaf_xy)
    x0 = (bx + np.arange(gx, dtype=np.float64)) * leaf_xy      # cell min-x
    y0 = (by + np.arange(gy, dtype=np.float64)) * leaf_xy
    cx = np.broadcast_to(x0[None, :], (gy, gx))
    cy = np.broadcast_to(y0[:, None], (gy, gx))
    # map-space bbox over the 4 cell corners (centroid ranges over the cell)
    cols, rows = [], []
    for dx2 in (0.0, leaf_xy):
        for dy2 in (0.0, leaf_xy):
            xm = cx + dx2 - ox
            ym = cy + dy2 - oy
            cols.append((cos * xm - sin * ym) * inv_res)
            rows.append((sin * xm + cos * ym) * inv_res)
    col_min = np.trunc(np.minimum.reduce(cols)).astype(np.int64)
    row_min = np.trunc(np.minimum.reduce(rows)).astype(np.int64)
    base_col = (col_min - 1).astype(np.int32)                  # f32 fuzz margin
    base_row = (row_min - 1).astype(np.int32)

    bits = np.zeros((gy, gx), np.int32)
    for qr in range(k):
        for qc in range(k):
            rr = base_row.astype(np.int64) + qr
            cc = base_col.astype(np.int64) + qc
            oob = (rr < 0) | (rr >= h) | (cc < 0) | (cc >= w)
            val = dil[np.clip(rr, 0, h - 1), np.clip(cc, 0, w - 1)] | oob
            bits |= val.astype(np.int32) << (qr * k + qc)

    tile = (gz, 1, 1)
    dev = env.dilated.device
    as_t = lambda a: torch.as_tensor(np.tile(a[None], tile).reshape(-1), device=dev)  # noqa: E731
    return CellStaticTable(
        base_row=as_t(base_row), base_col=as_t(base_col), bits=as_t(bits), k=k
    )


def remove_static_cells(
    cent: torch.Tensor, occ: torch.Tensor, env: MapEnv, table: CellStaticTable
) -> torch.Tensor:
    """Dense-grid static filter: the reference's f32 row/col math (cpp:674-
    678, C float arithmetic + truncation toward zero), then the cell's
    precomputed drop bit.  ``cent`` is channel-major (..., 3, n_cells)."""
    x_map = cent[..., 0, :].to(torch.float32) - env.origin_x
    y_map = cent[..., 1, :].to(torch.float32) - env.origin_y
    col = ((env.cos_nyaw * x_map - env.sin_nyaw * y_map) * env.inv_resolution).to(torch.int32)
    row = ((env.sin_nyaw * x_map + env.cos_nyaw * y_map) * env.inv_resolution).to(torch.int32)
    k = table.k
    qr = row - table.base_row
    qc = col - table.base_col
    in_win = (qr >= 0) & (qr < k) & (qc >= 0) & (qc < k)
    bit = (table.bits >> torch.clamp(qr * k + qc, 0, k * k - 1)) & 1
    drop = torch.where(in_win, bit, 1)  # out-of-window cannot happen; drop safe
    return occ & (drop == 0)


def remove_static(points: torch.Tensor, mask: torch.Tensor, env: MapEnv) -> torch.Tensor:
    """Point-list static filter: the keep-mask (True = dynamic point to
    keep) of points (..., M, 3).  The f32 rotate and truncation of
    ``remove_static_cells``, then ``dilated[row, col]``; points whose
    (row, col) fall outside the map are dropped.  JAX reads the map through
    a one-hot bilinear form (a TPU idiom); on 0/1 values the gather gives
    the same bits."""
    h, w = env.dilated.shape
    x_map = points[..., 0].to(torch.float32) - env.origin_x
    y_map = points[..., 1].to(torch.float32) - env.origin_y
    col = ((env.cos_nyaw * x_map - env.sin_nyaw * y_map) * env.inv_resolution).to(torch.int32)
    row = ((env.sin_nyaw * x_map + env.cos_nyaw * y_map) * env.inv_resolution).to(torch.int32)
    in_bounds = (row >= 0) & (row < h) & (col >= 0) & (col < w)
    flat = torch.clamp(row, 0, h - 1).to(torch.int64) * w + torch.clamp(col, 0, w - 1)
    is_static = env.dilated.reshape(-1)[flat]
    return mask & in_bounds & ~is_static
