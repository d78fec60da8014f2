"""Voxel-grid downsampling (PCL VoxelGrid semantics, ref
src/multiple_object_tracking_lidar.cpp:452-456): the dense grid's shape,
the f32 voxel index of a point, and the point-list front ends.

Port of ``multiple_object_tracking_lidar_tpu/ops/voxel.py``.  A point's
cell is floor(p * f32(1/leaf)) per axis; a voxel is the centroid of its
cell's points; voxels come out in ascending linear cell index (x fastest).

- ``voxel_accumulate`` (``voxel_mode="dense"``): the (n_cells, 4)
  [sum_xyz, count] accumulator.  JAX scatter-adds the points, and XLA's CPU
  code applies the updates one at a time in ascending point index; the port
  sums each cell from +0.0 in that order with K6's f32 mode
  (``ops/voxel_grid_cuda.py``), never with float atomics.
- ``voxel_finalize``: centroids, cumsum-compacted to m_max rows.
- ``voxel_downsample_scan`` (``voxel_mode="scan"``): a stable sort by cell,
  17 segmented Hillis-Steele passes, a cumsum and a searchsorted -- plain
  torch, the same ops as JAX, so the same bits, in f32 or f64 (no TPU
  kernel; the card runs them in torch too).

Every front end takes S stacked frames, (S, N, 3), or one (N, 3) frame.
A dropped point -- masked, out of bounds or NaN -- is tested on the float
floor before any cast.  JAX's ``_quantize`` casts floor(NaN) to int32
first, which XLA's CPU code turns into cell 0 of the axis, so JAX may KEEP
a NaN point and poison that cell (ROADMAP Queue 3); the port drops it, and
its dropped rows carry +0.0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points


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


def in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` as a value of ``dtype`` (f32 or f64), as a Python float: the
    value JAX gives a Python constant meeting an array of that dtype."""
    return f32(x) if dtype == torch.float32 else float(x)


def true_div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` by IEEE division on every device.  PyTorch's CUDA divide by
    a Python scalar multiplies by the scalar's rounded reciprocal instead
    (off by an ulp for ~14% of f32 values); a 0-dim tensor on x's device
    takes the true division, as the CPU and the kernels do."""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


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


def _squeeze(points, mask):
    """(S, N, 3) / (S, N) views of stacked or single-frame inputs, and
    whether the input was a single frame."""
    single = points.dim() == 2
    if single:
        points, mask = points[None], mask[None]
    return points, mask.reshape(points.shape[:2]), single


def voxel_accumulate_stacked(
    points: torch.Tensor, mask: torch.Tensor, scene: SceneBounds, leaf_xy: float, leaf_z: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """((S, 4, n_cells) channel-major [sum_x, sum_y, sum_z, count] of the
    points' dtype, (S,) i32 mask-nonzero counts): one K6 f32-mode call for
    S frames.  f64 points sum in f64 (the JAX f64 scatter-add), K6f's
    double build on the card (``accumulate_f32_stacked``)."""
    # imported here: voxel_grid_cuda imports this module
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
        accumulate_f32_stacked,
    )

    points, mask, _ = _squeeze(points, mask)
    if points.dtype != torch.float64:
        points = points.to(torch.float32)
    return accumulate_f32_stacked(points.contiguous(), mask, scene, leaf_xy, leaf_z)


def voxel_accumulate(
    points: torch.Tensor, mask: torch.Tensor, scene: SceneBounds, leaf_xy: float, leaf_z: float
) -> torch.Tensor:
    """The (n_cells, 4) [sum_xyz, count] accumulator of one (N, 3) frame,
    in the JAX package's row-major layout."""
    acc, _ = voxel_accumulate_stacked(points, mask, scene, leaf_xy, leaf_z)
    return acc[0].T


def voxel_finalize_cm(
    acc: torch.Tensor, m_max: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(S, 4, n_cells) accumulators -> ((S, m_max, 3) centroids, (S, m_max)
    mask, (S,) occupied-cell counts): centroid = sum / max(count, 1), the
    occupied cells packed in ascending cell index, the rest dropped."""
    cent = acc[:, :3] / torch.clamp(acc[:, 3:4], min=1.0)           # (S, 3, nc)
    return compact_points(cent.permute(0, 2, 1), acc[:, 3] > 0, m_max)


def voxel_finalize(acc: torch.Tensor, m_max: int):
    """The JAX package's signature: one (n_cells, 4) accumulator ->
    ((m_max, 3) centroids, (m_max,) mask, occupied-cell count)."""
    out, out_mask, n_vox = voxel_finalize_cm(acc.T[None], m_max)
    return out[0], out_mask[0], n_vox[0]


def voxel_downsample_dense(points, mask, scene: SceneBounds, leaf_xy: float, leaf_z: float,
                           m_max: int):
    """Dense-grid voxel centroid downsample (accumulate + finalize), stacked
    or single-frame."""
    acc, _ = voxel_accumulate_stacked(points, mask, scene, leaf_xy, leaf_z)
    out = voxel_finalize_cm(acc, m_max)
    return tuple(o[0] for o in out) if points.dim() == 2 else out


def voxel_downsample_scan(points, mask, scene: SceneBounds, leaf_xy: float, leaf_z: float,
                          m_max: int):
    """Scatter-free voxel centroid downsample, the dense path's semantics
    and order: co-sort (key, x, y, z, w) by cell (stable), segmented
    Hillis-Steele prefix sums ``v + where(same, shifted, 0.0)`` (the last
    row of each run holds its total), then gather-only compaction through
    a cumsum and a searchsorted.  ((S, m_max, 3), (S, m_max), (S,)), or the
    single-frame shapes for an (N, 3) input.  The cells come from the
    points rounded to f32; the sums are in the points' dtype (f32 or f64,
    ``w`` in ``points.dtype`` as JAX's: ops/voxel.py:166)."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
        kept_cells,
        kernel_params,
    )

    pts, msk, single = _squeeze(points, mask)
    k = kernel_params(scene, leaf_xy, leaf_z)
    nc = k["n_cells"]
    p = pts.to(torch.float32)
    ok, lin, _ = kept_cells(p, msk, k)
    keys = torch.where(ok, lin, nc)
    v = pts if pts.dtype == torch.float64 else p
    w = ok.to(v.dtype)
    vals = torch.cat([torch.where(ok[..., None], v, 0.0), w[..., None]], dim=-1)
    ks, perm = torch.sort(keys, dim=1, stable=True)
    vals = torch.gather(vals, 1, perm[..., None].expand(-1, -1, 4))

    s, n = ks.shape
    sh = 1
    while sh < n:
        same = torch.zeros_like(ks, dtype=torch.bool)
        same[:, sh:] = ks[:, sh:] == ks[:, :-sh]
        shifted = torch.zeros_like(vals)
        shifted[:, sh:] = vals[:, :-sh]
        vals = vals + torch.where(same[..., None], shifted, 0.0)
        sh *= 2

    is_last = torch.ones_like(ks, dtype=torch.bool)
    is_last[:, :-1] = ks[:, 1:] != ks[:, :-1]
    is_last &= ks < nc
    c = torch.cumsum(is_last.to(torch.int64), dim=1)
    n_vox = c[:, -1]
    j = torch.arange(m_max, device=ks.device)
    src = torch.clamp(torch.searchsorted(c, (j + 1).expand(s, -1).contiguous()), 0, n - 1)
    rows = torch.gather(vals, 1, src[..., None].expand(-1, -1, 4))
    out_mask = j[None, :] < n_vox[:, None]
    out = rows[..., :3] / torch.clamp(rows[..., 3:4], min=1.0)
    out = torch.where(out_mask[..., None], out, 0.0)
    res = (out, out_mask, n_vox.to(torch.int32))
    return tuple(r[0] for r in res) if single else res
