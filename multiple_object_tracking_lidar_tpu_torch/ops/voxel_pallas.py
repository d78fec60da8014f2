"""The sorted-runs voxel front ends (``voxel_mode="runs"``): port of
``multiple_object_tracking_lidar_tpu/ops/voxel_pallas.py::
voxel_accumulate_runs_cm`` (the dense accumulator, ``cluster_backend=
"grid"``) and ``voxel_downsample_runs`` (the compacted voxel list of the
point-list backends).

Sort the points by cell key (stable, as ``lax.sort``: the order within a
run fixes the f32 sum), take the segmented prefix totals with K7
(``ops/segsum_cuda.py``), and write each run's total and count into its
cell.  JAX densifies with a bf16x3 one-hot matmul over the compacted runs;
each cell receives exactly one run and the three bf16 parts of a run total
add back to it exactly, so writing the totals with ``index_put_`` (unique
indices, no float atomics) gives the same bits.

Under ``dtype="float64"`` K7 stays f32, on the points rounded to f32, as
the JAX route casts them (``segment_totals_raster``, voxel_pallas.py:
350-352): the dense accumulator is f32 (the dense grid finalizes it in f32
and widens the centroids), and the voxel list divides the f32 totals by
f64 counts (voxel_pallas.py:152-153), in f64.

Under ``dtype="bfloat16"`` and ``"float16"`` K7 stays f32 too, on the
points rounded to the half dtype and widened: JAX's ``w`` is f32
(voxel_pallas.py:128), so ``points * w`` promotes to f32.  The voxel list
rounds each run's count to the half dtype (:152) and divides the f32 totals
by it in f32 (f32 / half promotes to f32), so its centroids are f32, and so
is the point list after it, until the detections' cast (pipeline.py:820).

Dropped points -- masked, out of bounds or NaN -- take the key ``n_cells``
and sort to the end.  JAX casts ``floor(NaN)`` to int32 before its bounds
test, so whether it drops a NaN point is implementation-defined; the port
drops NaN explicitly (as K1 and K5 do) and gives dropped rows the value
+0.0, so that no NaN or inf reaches K7's multiply-by-0 terms (ROADMAP
Queue 3).
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
from multiple_object_tracking_lidar_tpu_torch.ops.segsum_cuda import segment_totals
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
    kept_cells,
    kernel_params,
)


def _sorted_runs(points, mask, scene, leaf_xy, leaf_z):
    """Stable sort of S frames by cell key and K7's segment totals, which
    read the values through the sort's permutation: (k, ks (S, N) sorted
    keys, (tx, ty, tz) run prefixes, ok, lin)."""
    k = kernel_params(scene, leaf_xy, leaf_z)
    nc = k["n_cells"]
    p = points.to(torch.float32)
    ok, lin, _ = kept_cells(p, mask, k)
    keys = torch.where(ok, lin, nc).to(torch.int32)
    vals = torch.where(ok[..., None], p, 0.0)
    ks, perm = torch.sort(keys, dim=1, stable=True)
    tots = segment_totals(ks, vals[..., 0], vals[..., 1], vals[..., 2], perm=perm)
    return k, ks, tots, ok, lin


def voxel_accumulate_runs_stacked(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """((S, 4, n_cells) f32 [sum_x, sum_y, sum_z, count], (S,) i32
    mask-nonzero count) of S independent frames: one sort, one K7 call."""
    k, ks, (tx, ty, tz), ok, lin = _sorted_runs(points, mask, scene, leaf_xy, leaf_z)
    nc = k["n_cells"]
    s = points.shape[0]
    dev = points.device

    # the last row of each run holds its total; dropped rows go to a dump cell
    is_last = torch.ones_like(ks, dtype=torch.bool)
    is_last[:, :-1] = ks[:, 1:] != ks[:, :-1]
    frame = torch.arange(s, device=dev)[:, None]
    dump = s * nc
    tgt = torch.where(is_last & (ks < nc), frame * nc + ks, dump).reshape(-1)
    acc = torch.zeros((dump + 1, 4), dtype=torch.float32, device=dev)
    acc[:, :3].index_put_((tgt,), torch.stack([tx, ty, tz], dim=-1).reshape(-1, 3))
    cell = torch.where(ok, frame * nc + lin, dump).reshape(-1)
    # an integer histogram without bincount, which reads min and max on the host
    cnt = torch.zeros(dump + 1, dtype=torch.int64, device=dev).index_add_(0, cell, torch.ones_like(cell))
    acc[:, 3] = cnt.to(torch.float32)
    out = acc[:dump].reshape(s, nc, 4).permute(0, 2, 1).contiguous()
    npts = (mask.reshape(s, -1) != 0).sum(dim=1).to(torch.int32)
    return out, npts


def voxel_accumulate_runs_cm(points, mask, scene, leaf_xy, leaf_z) -> torch.Tensor:
    """(4, n_cells) accumulator of one (N, 3) frame."""
    n = points.shape[0]
    acc, _ = voxel_accumulate_runs_stacked(
        points.reshape(1, n, 3), mask.reshape(1, n), scene, leaf_xy, leaf_z
    )
    return acc[0]


def voxel_downsample_runs(points, mask, scene: SceneBounds, leaf_xy: float, leaf_z: float,
                          m_max: int, dtype: torch.dtype | None = None):
    """Voxel centroids of S frames (S, N, 3) through the sorted runs:
    ((S, m_max, 3), (S, m_max), (S,)), or the single-frame shapes for one
    (N, 3) frame.  The run ends come out of a second sort (of their row
    index; other rows go to the back), the totals of those rows are
    gathered, and each count is the distance between two run ends.  The
    totals are f32 (K7); the counts and the centroids are in the points'
    dtype, f32 or f64.  A half ``dtype`` (f32 points holding half values)
    rounds the counts to it and divides in f32: f32 centroids."""
    single = points.dim() == 2
    if single:
        points, mask = points[None], mask[None]
    k, ks, (tx, ty, tz), _, _ = _sorted_runs(points, mask, scene, leaf_xy, leaf_z)
    s, n = ks.shape
    dev = ks.device
    is_last = torch.ones_like(ks, dtype=torch.bool)
    is_last[:, :-1] = ks[:, 1:] != ks[:, :-1]
    is_last &= ks < k["n_cells"]
    n_vox = is_last.sum(dim=1).to(torch.int32)
    rowi = torch.arange(n, device=dev)
    src = torch.sort(torch.where(is_last, rowi, n), dim=1).values[:, :m_max]
    out_mask = src < n
    srcc = torch.clamp(src, 0, n - 1)
    rows = torch.stack([torch.gather(c, 1, srcc) for c in (tx, ty, tz)], dim=-1)
    prev = torch.cat([torch.full((s, 1), -1, dtype=src.dtype, device=dev), src[:, :-1]], dim=1)
    dt = torch.float64 if points.dtype == torch.float64 else torch.float32
    counts = torch.where(out_mask, src - prev, 1)
    counts = (counts.to(dtype) if dtype in (torch.bfloat16, torch.float16) else counts).to(dt)
    out = rows.to(dt) / torch.clamp(counts[..., None], min=1.0)
    out = torch.where(out_mask[..., None], out, 0.0)
    res = (out, out_mask, n_vox)
    return tuple(r[0] for r in res) if single else res
