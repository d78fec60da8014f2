"""Dense channel-major voxel accumulation (PCL VoxelGrid binning, ref
src/multiple_object_tracking_lidar.cpp:452-456): every valid point's
(x, y, z, 1) summed into its dense grid cell, as (4, n_cells)
[sum_x, sum_y, sum_z, count].

Port of the ``quant="fast"`` route of
``multiple_object_tracking_lidar_tpu/ops/voxel_grid.py``: one int8 digit
per axis of the point's offset from its cell centre, summed exactly in
int32 by K1 (``ops/voxel_grid_cuda.py``).  The two-digit ``"exact"`` mode
is a later slice (ROADMAP).
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid_cuda import (
    accumulate_fast_stacked,
)


def voxel_accumulate_onehot_cm(
    points: torch.Tensor,
    mask: torch.Tensor,
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    quant: str = "fast",
    with_npts: bool = False,
):
    """(4, n_cells) f32 accumulator of one (N, 3) frame, plus the scalar
    mask-nonzero point count when ``with_npts``."""
    if quant != "fast":
        raise NotImplementedError(
            f"voxel_quant={quant!r}: only 'fast' is ported (exact mode is a "
            "later slice, ROADMAP Queue 1)"
        )
    n = points.shape[0]
    acc, npts = accumulate_fast_stacked(
        points.to(torch.float32).reshape(1, n, 3).contiguous(),
        mask.reshape(1, n),
        scene,
        leaf_xy,
        leaf_z,
    )
    return (acc[0], npts[0]) if with_npts else acc[0]


def finalize_dense_cm(acc_cm: torch.Tensor):
    """(4, n_cells) accumulator -> ((3, n_cells) centroids, (n_cells,)
    occupancy, occupied count).  No compaction: the cell index is the point
    index (ascending lin = PCL's output order)."""
    occ = acc_cm[3] > 0
    cent = acc_cm[:3] / torch.clamp(acc_cm[3][None, :], min=1.0)
    return cent, occ, occ.sum()
