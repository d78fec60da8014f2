"""Dense channel-major voxel accumulation (PCL VoxelGrid binning, ref
src/multiple_object_tracking_lidar.cpp:452-456): every valid point's
(x, y, z, 1) summed into its dense grid cell, as (4, n_cells)
[sum_x, sum_y, sum_z, count].

Port of the one-hot routes of ``multiple_object_tracking_lidar_tpu/ops/
voxel_grid.py``, with its TPU dispatch (voxel_grid.py:117-164):

- ``quant="fast"``: one int8 digit per axis, K1, for every N (the TPU's v5
  and its i32 twin v4 give the same integers; K1 sums in int32 with no
  2^24 bound), one launch per call at any grid size (past ``max_cells``,
  232,320 cells, the wide layout: more cell ranges, each CTA reading every
  point of its frame);
- ``quant="exact"``: two balanced int8 digits per axis, K5, when a point
  block tiles N (``_pick_block``) and the leaf fits the digit pair
  (``_v3_leaf_ok``) -- the TPU's v6 / v3, at any grid size as K1.
  Otherwise the bf16x3 sums, K6:
  the TPU's v2 kernel when the leaf is too coarse, and its jnp lowering of
  the same sums when no block tiles N.

Under ``dtype="float64"`` (f64 points) the fast route is unchanged (K1 on
the points rounded to f32; the caller casts its sums), and the exact route
is not K5's digits: the JAX package takes an f64 one-hot contraction
there (voxel_grid.py:242-254, on the TPU too, since ``use_pallas`` is
false for f64), whose sums are the f64 coordinates of each cell's points
in XLA's ``dot_general`` order.  The port takes K6f's double build
(``accumulate_f32_stacked``): the same sums in ascending point index, so
they agree to a few ulps, not bit for bit.

Under ``dtype="bfloat16"`` / ``"float16"`` every route stays f32 (K1, K5,
K6 on the points rounded to the half dtype and widened) and the caller
rounds the sums, counts included, to the half dtype, as the JAX one-hot
routes round their f32 sums (voxel_grid.py:239).

``accumulate_from_indices`` is the port of ``_accumulate_pallas``, the
TPU's first one-hot accumulator, whose caller quantizes; no tracking path
runs it.

The kernels live in ``ops/voxel_grid_cuda.py``.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
    FXP_XY,
    FXP_Z,
    _npts,
    accumulate_bf16x3_keys,
    accumulate_bf16x3_stacked,
    accumulate_exact_stacked,
    accumulate_exact_stacked_raw,
    accumulate_f32_stacked,
    accumulate_fast_stacked,
    accumulate_fast_stacked_raw,
    exact_digit_sums,
    fast_digit_sums,
)


def _pick_block(n: int) -> int | None:
    """The TPU's point block that tiles N exactly (voxel_grid.py:281)."""
    for b in (4096, 2048, 1024, 512):
        if n % b == 0:
            return b
    return None


def _v3_leaf_ok(leaf_xy: float, leaf_z: float) -> bool:
    """True iff two balanced int8 digits hold the quantized cell-relative
    offset: |fq| <= 127 * 256 = 32512 at the 2^19 / 2^14 scales
    (voxel_grid.py:471), i.e. leaf_xy <= ~0.124 m, leaf_z <= ~3.97 m."""
    return (
        leaf_xy / 2.0 * (1 << FXP_XY) <= 32512.0
        and leaf_z / 2.0 * (1 << FXP_Z) <= 32512.0
    )


def exact_route(n: int, leaf_xy: float, leaf_z: float) -> str:
    """The kernel exact mode takes for N points per frame: "K5" (two-digit
    histogram) or "K6" (bf16x3 sums)."""
    return "K5" if _pick_block(n) is not None and _v3_leaf_ok(leaf_xy, leaf_z) else "K6"


def digit_sums_stacked(points, mask, scene, leaf_xy, leaf_z, quant: str = "fast"):
    """((S, C, n_cells) int32 digit sums, (S,) i32 mask-nonzero counts): K1's
    (``quant="fast"``, C = 4) or K5's (``"exact"``, C = 7) histogram alone
    on CUDA tensors, at any grid size; on CPU tensors ``fast_digit_sums`` /
    ``exact_digit_sums`` (int64 ``index_add_``, exact in any order: the
    same integers), counted in ``.plain_routes``.  The kernel fleet
    all-reduces these and finalizes once."""
    if points.device.type != "cpu":
        raw = accumulate_fast_stacked_raw if quant == "fast" else accumulate_exact_stacked_raw
        return raw(points, mask, scene, leaf_xy, leaf_z)
    digit_sums_stacked.plain_routes += 1
    sums = fast_digit_sums if quant == "fast" else exact_digit_sums
    return sums(points, mask, scene, leaf_xy, leaf_z), _npts(mask, points.shape[0])


digit_sums_stacked.plain_routes = 0


def voxel_accumulate_stacked(
    points: torch.Tensor,   # (S, N, 3)
    mask: torch.Tensor,     # (S, N) nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    quant: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """((S, 4, n_cells) f32 accumulators, (S,) i32 mask-nonzero counts) of
    S stacked frames in one kernel call; each frame's result is the one a
    single-frame call gives.  f64 points on the exact route sum in f64
    (K6f's double build: the JAX f64 contraction's sums up to its
    order)."""
    if quant not in ("fast", "exact"):
        raise ValueError(f"unknown voxel_quant {quant!r}")
    if quant == "exact" and points.dtype == torch.float64:
        return accumulate_f32_stacked(points.contiguous(), mask, scene, leaf_xy, leaf_z)
    points = points.to(torch.float32).contiguous()
    if quant == "exact" and exact_route(points.shape[1], leaf_xy, leaf_z) == "K6":
        return accumulate_bf16x3_stacked(points, mask, scene, leaf_xy, leaf_z)
    acc_fn = accumulate_fast_stacked if quant == "fast" else accumulate_exact_stacked
    return acc_fn(points, mask, scene, leaf_xy, leaf_z)


def voxel_accumulate_onehot_cm(
    points: torch.Tensor,
    mask: torch.Tensor,
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    quant: str = "exact",
    with_npts: bool = False,
):
    """(4, n_cells) f32 accumulator of one (N, 3) frame, plus the scalar
    mask-nonzero point count when ``with_npts``."""
    n = points.shape[0]
    acc, npts = voxel_accumulate_stacked(
        points.reshape(1, n, 3), mask.reshape(1, n), scene, leaf_xy, leaf_z, quant
    )
    return (acc[0], npts[0]) if with_npts else acc[0]


def voxel_accumulate_onehot(
    points: torch.Tensor,
    mask: torch.Tensor,
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    use_pallas: bool | None = None,
    block: int | None = None,
) -> torch.Tensor:
    """The (n_cells, 4) [sum_x, sum_y, sum_z, count] accumulator of one
    (N, 3) frame by the exact digits (JAX voxel_grid.py:56-73): K5 on CUDA
    tensors.  ``use_pallas`` and ``block`` pick the JAX package's TPU
    kernel and its block; every choice gives the same bits, so both are
    accepted and unused here."""
    del use_pallas, block
    return voxel_accumulate_onehot_cm(points, mask, scene, leaf_xy, leaf_z).T


def finalize_dense(acc: torch.Tensor):
    """(n_cells, 4) accumulator -> ((n_cells, 3) centroids, occupancy,
    occupied count) (JAX voxel_grid.py:2066-2073)."""
    cent, occ, n = finalize_dense_cm(acc.T)
    return cent.T, occ, n


def finalize_dense_cm(acc_cm: torch.Tensor):
    """(..., 4, n_cells) accumulator -> ((..., 3, n_cells) centroids,
    (..., n_cells) occupancy, (...) occupied count).  No compaction: the
    cell index is the point index (ascending lin = PCL's output order)."""
    cnt = acc_cm[..., 3, :]
    occ = cnt > 0
    cent = acc_cm[..., :3, :] / torch.clamp(cnt[..., None, :], min=1.0)
    return cent, occ, occ.sum(dim=-1)


def accumulate_from_indices(
    points: torch.Tensor,     # (N, 3)
    ix: torch.Tensor,         # (N,) int: x cell index
    iyz: torch.Tensor,        # (N,) int: iy + gy * iz
    in_bounds: torch.Tensor,  # (N,) bool
    gx: int,
    gyz: int,
    block: int,
) -> torch.Tensor:
    """(4, gyz * gx) f32 [sum_x, sum_y, sum_z, count] of the points given
    with their grid indices: the bf16x3 sums, combined as (S1 + S2) + S3,
    of every point in bounds whose ix lies in [0, gx) and iyz in [0, gyz)
    (K6's key entry).  Port of ``voxel_grid.py::_accumulate_pallas``
    (:2020).  As the TPU grid (``grid = n // block``, :2043) it sums only
    the first ``(N // block) * block`` points: a tail shorter than a block
    is dropped."""
    n = points.shape[0]
    if block < 1 or n < block:
        raise ValueError(f"block={block} must be in [1, N={n}]")
    m = (n // block) * block
    out = accumulate_bf16x3_keys(
        points[None, :m].to(torch.float32), ix[None, :m], iyz[None, :m], in_bounds[None, :m],
        gx, gyz,
    )
    return out[0]
