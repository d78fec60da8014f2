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
    """``x`` as a value of ``dtype`` (f32, f64, bf16 or f16), as a Python
    float: the value JAX gives a Python constant meeting an array of that
    dtype (f16 rounded once from f64, as numpy converts; bf16 from the f32
    value, as ml_dtypes and torch convert)."""
    if dtype == torch.float64:
        return float(x)
    if dtype == torch.float16:
        return float(np.float16(x))
    if dtype == torch.bfloat16:
        # round to nearest even from the f32 value (no torch op: a scalar read
        # back from a tensor would count as a host sync in a trace)
        bits = int(np.float32(x).view(np.uint32))
        if (bits & 0x7F800000) != 0x7F800000:       # finite: round the low 16 bits
            bits += 0x7FFF + ((bits >> 16) & 1)
        return float(np.uint32(bits & 0xFFFF0000).view(np.float32))
    return f32(x)


def true_div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` by IEEE division on every device.  PyTorch's CUDA divide by
    a Python scalar multiplies by the scalar's rounded reciprocal instead
    (off by an ulp for ~14% of f32 values); a 0-dim tensor on x's device
    takes the true division, as the CPU and the kernels do.  In the half
    dtypes the JAX package's division by a constant is a product: XLA folds
    ``x / c`` into ``x * (1 / c)``, the reciprocal rounded to f16 in f16,
    in bf16 an f32 product by the f32 reciprocal (``recip_f32``) rounded
    once; and so does this (not in f32 and f64)."""
    if x.dtype == torch.float16:
        return x * torch.tensor(in_dtype(1.0 / in_dtype(v, x.dtype), x.dtype),
                                dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        return (x.float() * recip_f32(v, x.dtype)).to(x.dtype)
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def recip_f32(v: float, dtype: torch.dtype) -> float:
    """1 / v as XLA folds it for ``x / v`` on a bf16 ``x``: the f32
    quotient of 1 by v rounded to the dtype (bf16 division runs in f32)."""
    return float(np.float32(1.0) / np.float32(in_dtype(v, dtype)))


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
    points: torch.Tensor, mask: torch.Tensor, scene: SceneBounds, leaf_xy: float, leaf_z: float,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """((S, 4, n_cells) channel-major [sum_x, sum_y, sum_z, count] of the
    points' dtype, (S,) i32 mask-nonzero counts): one K6 f32-mode call for
    S frames.  f64 points sum in f64 (the JAX f64 scatter-add), K6f's
    double build on the card (``accumulate_f32_stacked``); bf16 / f16
    points sum in their dtype, each add rounded to it and the count
    saturating (the JAX half scatter-add: ops/voxel.py:55-97), K6f's half
    builds on the points widened to f32 -- and so do f32 points holding
    half values under a half ``dtype``."""
    # imported here: voxel_grid_cuda imports this module
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
        accumulate_f32_stacked,
    )

    points, mask, _ = _squeeze(points, mask)
    half = dtype if dtype in (torch.bfloat16, torch.float16) else None
    if points.dtype in (torch.bfloat16, torch.float16):
        half = points.dtype
    if points.dtype != torch.float64:
        points = points.to(torch.float32)
    return accumulate_f32_stacked(points.contiguous(), mask, scene, leaf_xy, leaf_z, dtype=half)


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
    occupied cells packed in ascending cell index, the rest dropped.  In
    the accumulator's dtype: a half division is the f32 quotient rounded
    once, as XLA's CPU code divides bf16 (f16: its native division, the
    same correctly rounded value)."""
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
                          m_max: int, dtype: torch.dtype | None = None):
    """Scatter-free voxel centroid downsample, the dense path's semantics
    and order: co-sort (key, x, y, z, w) by cell (stable), segmented
    Hillis-Steele prefix sums ``v + where(same, shifted, 0.0)`` (the last
    row of each run holds its total), then gather-only compaction through
    a cumsum and a searchsorted.  ((S, m_max, 3), (S, m_max), (S,)), or the
    single-frame shapes for an (N, 3) input.  The cells come from the
    points rounded to f32; the sums are in the points' dtype (f32, f64,
    bf16 or f16: ``w`` in ``points.dtype`` as JAX's, ops/voxel.py:166), or
    in ``dtype`` where given (the half dtype of f32 points that hold half
    values): each pass's add and the final division rounded to it, as
    XLA's CPU code rounds them under bf16 / f16 (no kernel: the JAX scan
    is jnp)."""
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
    v = pts.to(dtype) if dtype is not None else (pts if pts.dtype != torch.float32 else p)
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


def voxel_downsample_sort(
    points: torch.Tensor, mask: torch.Tensor, leaf_xy: float, leaf_z: float, m_max: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel centroid downsample for unbounded scenes (JAX ops/voxel.py:
    197-241): one (N, 3) frame -> ((m_max, 3) centroids ordered by (iz, iy,
    ix) ascending, (m_max,) mask, the occupied-cell count), the first m_max
    cells kept.

    As the JAX function: the quantized points lexsorted (primary iz, then
    iy, then ix, masked-off rows last; here three stable sorts, least
    significant key first), the runs of one cell numbered in sorted order,
    each of the first m_max runs summed in sorted row order.  The sums of
    the permuted points go through K6f's key entry keyed by run
    (``voxel_grid_cuda.accumulate_sums_keys``: a run's rows add from +0.0
    in ascending sorted position, the scatter-add's order; never float
    atomics).  Memory O(N + m_max), whatever the points' extent."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
        accumulate_sums_keys,
    )

    n, dev = points.shape[0], points.device
    p32 = points.to(torch.float32)
    v = points if points.dtype == torch.float64 else p32
    ok = mask.reshape(-1) != 0
    if n == 0:
        return (torch.zeros((m_max, 3), dtype=v.dtype, device=dev),
                torch.zeros(m_max, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    ix, iy, iz = _quantize(p32, leaf_xy, leaf_z)
    izk = torch.where(ok, iz, 2**30)
    perm = torch.arange(n, device=dev)
    for key in (ix, iy, izk):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    ixs, iys, izs, ms = ix[perm], iy[perm], iz[perm], ok[perm]
    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = (ixs[1:] != ixs[:-1]) | (iys[1:] != iys[:-1]) | (izs[1:] != izs[:-1])
    new_seg &= ms
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    bins = torch.where(ms & (seg < m_max), seg, -1)
    acc = accumulate_sums_keys(v[perm][None], bins[None], m_max)[0]       # (4, m_max)
    counts = acc[3]
    out = (acc[:3] / torch.clamp(counts, min=1.0)).T.contiguous()
    return out, counts > 0, new_seg.sum().to(torch.int32)
