"""The entry points of the JAX package's ``ops/centroid_pallas.py``, under
their JAX names, on this package's kernels.

No tracking path of either package calls them: the pipeline's circumcenter
runs ``ops/centroid_cuda.py::circumcenter_features`` (K3f, the whole
feature in one launch), as the JAX pipeline runs
``circumcenter_features_table_pallas_v2``.  They are here so that every
TPU kernel of that module has its counterpart, found by the same name:

- ``circumcenter_xy_pallas`` (centroid_pallas.py:124, the all-in-kernel
  ``_kernel`` -> ``_one``) -> K10, ``csrc/circumcenter.cu``;
- ``circumcenter_features_table_pallas`` (:478) -> K10 plus [x, y, 0, t];
- ``pair_stats_pallas`` (:374, the unrolled ``_kernel_v3``) -> K3.  The JAX
  tests pin ``_kernel_v3`` bit for bit to ``_kernel_v5_dyn``, which K3
  replaces, and its output bits do not depend on ``slab_rows`` (:385-388),
  so K3 computes its function for every ``slab_rows``;
- ``pair_stats_pallas_dyn`` (:415): K3's own entry;
  ``circumcenter_features_table_pallas_v2`` (:456): the pipeline's route,
  K3f (the pair stats it replaces and the selection after them).

Each runs its kernel on CUDA tensors and the kernel's plain version on CPU
tensors.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
from multiple_object_tracking_lidar_tpu_torch.ops.centroid_cuda import (
    circumcenter_xy,
    pair_stats,
)


def circumcenter_xy_pallas(mpts: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """(C, 2) circumcenter xy per cluster slot (K10); a slot without
    members gives its row 0's xy."""
    return circumcenter_xy(mpts.to(torch.float32), member_mask)


def circumcenter_features_table_pallas(
    mpts: torch.Tensor, member_mask: torch.Tensor, t: torch.Tensor | float
) -> torch.Tensor:
    """(C, 4) [x, y, 0, t] detections from the member table (K10)."""
    c = mpts.shape[0]
    xy = circumcenter_xy_pallas(mpts, member_mask)
    zeros = torch.zeros((c, 1), dtype=torch.float32, device=mpts.device)
    tcol = torch.as_tensor(t, dtype=torch.float32, device=mpts.device).reshape(-1, 1).expand(c, 1)
    return torch.cat([xy, zeros, tcol], dim=1).to(mpts.dtype)


def pair_stats_pallas(
    mpts: torch.Tensor, member_mask: torch.Tensor, slab_rows: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """((C, P) colmax f32, (C, P) firstrow i32) farthest-pair statistics
    (K3).  ``slab_rows``, the TPU kernel's rows per d2 block, must divide P;
    the result does not depend on it."""
    p = mpts.shape[1]
    if slab_rows is not None and (slab_rows <= 0 or p % slab_rows != 0):
        raise ValueError(f"slab_rows={slab_rows} must divide P={p}")
    return pair_stats(mpts.to(torch.float32), member_mask)


def pair_stats_pallas_dyn(
    mpts: torch.Tensor, member_mask: torch.Tensor, slab_rows: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same statistics by the TPU's dynamic-loop kernel's name (K3)."""
    return pair_stats_pallas(mpts, member_mask, slab_rows)


def circumcenter_features_table_pallas_v2(
    mpts: torch.Tensor, member_mask: torch.Tensor, t: torch.Tensor | float
) -> torch.Tensor:
    """(C, 4) [x, y, 0, t] detections by the pipeline's route (K3f)."""
    return centroid_cuda.circumcenter_features(
        mpts.to(torch.float32), member_mask, torch.as_tensor(t, dtype=torch.float32)
    ).to(mpts.dtype)
