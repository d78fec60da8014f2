"""K3: farthest-pair column statistics per cluster slot; K10: the whole
circumcenter feature per slot.

Replaces the Pallas kernel ``multiple_object_tracking_lidar_tpu/ops/
centroid_pallas.py::pair_stats_pallas_dyn`` (reached through
``circumcenter_features_table_pallas_v2``).  CUDA source:
``csrc/centroid.cu``, whose header says what bounds it on the H100 (the
launch: a few active slots of P^2/2 pair terms) and how its design answers
that (one CTA per slot; empty slots return their init values at once).

``pair_stats`` launches the kernel for CUDA tensors and runs
``pair_stats_plain`` for CPU tensors; ``.launches`` counts kernel launches.
Both return ``(colmax (C, P) f32, firstrow (C, P) i32)``:
``colmax[j] = max_i d2m[i, j]`` (d2m = -1 off member pairs i < j) and
``firstrow[j]`` the smallest row reaching it; (-1, P) for a slot without
members.  The selection, line scan and determinant run in eager PyTorch
(``ops/centroid.py::circumcenter_features_table_cuda``).

K10 replaces ``centroid_pallas.py::circumcenter_xy_pallas``, the TPU's
all-in-kernel circumcenter, which no tracking path of the JAX package runs
(``ops/centroid_pallas.py`` of this package holds its entry points).  CUDA
source: ``csrc/circumcenter.cu``, whose header says what bounds it and how
its design answers that.  ``circumcenter_xy`` launches it for CUDA tensors
and runs ``circumcenter_xy_plain`` -- K3's plain version followed by
``circumcenter_from_pair_stats``, the same function -- for CPU tensors;
both return (C, 2) f32 [x, y], bit for bit the same.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch import _build


def pair_stats_plain(mpts: torch.Tensor, member_mask: torch.Tensor):
    """Plain PyTorch version of K3: the same centring (f64 sum of the member
    coordinates rounded to f32, over the f32 count), the same d2 expression
    order, elementwise (no matmul, so no reordered gram)."""
    c, p, _ = mpts.shape
    dev = mpts.device
    mp = mpts.to(torch.float32)
    mm = member_mask.to(torch.bool)
    cnt = mm.sum(dim=1)
    mean = (
        torch.where(mm[..., None], mp, 0.0).to(torch.float64).sum(dim=1).to(torch.float32)
        / torch.clamp(cnt, min=1).to(torch.float32)[:, None]
    )                                                          # (C, 3)
    pc = torch.where(mm[..., None], mp - mean[:, None, :], 0.0)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    sq = (x * x + y * y) + z * z                              # (C, P)
    gram = (
        x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :]
    ) + z[:, :, None] * z[:, None, :]                         # (C, P, P) [i, j]
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * gram
    ar = torch.arange(p, device=dev)
    pair_ok = mm[:, :, None] & mm[:, None, :] & (ar[:, None] < ar[None, :])[None]
    d2m = torch.where(pair_ok, d2, -1.0)
    colmax = d2m.max(dim=1).values                            # (C, P)
    rows = ar[None, :, None].expand(c, p, p)
    firstrow = torch.where(d2m == colmax[:, None, :], rows, p).min(dim=1).values
    active = (cnt > 0)[:, None]
    colmax = torch.where(active, colmax, -1.0)
    firstrow = torch.where(active, firstrow, p).to(torch.int32)
    return colmax, firstrow


def _check_table(mpts: torch.Tensor, member_mask: torch.Tensor):
    """(C, P) of a CUDA member table, or ValueError."""
    if mpts.dim() != 3 or mpts.shape[2] != 3 or mpts.dtype != torch.float32:
        raise ValueError(f"mpts must be (C, P, 3) float32, got {tuple(mpts.shape)} {mpts.dtype}")
    c, p, _ = mpts.shape
    if member_mask.shape != (c, p) or member_mask.device != mpts.device:
        raise ValueError(f"member_mask must be ({c}, {p}) on {mpts.device}")
    return c, p


def pair_stats(mpts: torch.Tensor, member_mask: torch.Tensor):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if mpts.device.type == "cpu":
        return pair_stats_plain(mpts, member_mask)
    c, p = _check_table(mpts, member_mask)
    dev = mpts.device
    mpts = mpts.contiguous()
    mm8 = member_mask.to(torch.uint8).contiguous()
    colmax = torch.empty((c, p), dtype=torch.float32, device=dev)
    firstrow = torch.empty((c, p), dtype=torch.int32, device=dev)
    lib = _build.load()
    err = lib.motl_pair_stats(
        mpts.data_ptr(), mm8.data_ptr(), c, p, colmax.data_ptr(),
        firstrow.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "motl_pair_stats")
    pair_stats.launches += 1
    return colmax, firstrow


pair_stats.launches = 0


def circumcenter_xy_plain(mpts: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10: K3's plain pair stats, then the eager
    selection, line scan and determinant."""
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_from_pair_stats,
    )

    cm, fr = pair_stats_plain(mpts, member_mask)
    t0 = torch.zeros((), dtype=torch.float32, device=mpts.device)
    return circumcenter_from_pair_stats(cm, fr, mpts.to(torch.float32), member_mask, t0)[:, :2]


def circumcenter_xy(mpts: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """K10 on CUDA tensors, its plain version on CPU tensors: (C, 2) f32."""
    if mpts.device.type == "cpu":
        return circumcenter_xy_plain(mpts, member_mask)
    c, p = _check_table(mpts, member_mask)
    dev = mpts.device
    mpts = mpts.contiguous()
    mm8 = member_mask.to(torch.uint8).contiguous()
    out = torch.empty((c, 2), dtype=torch.float32, device=dev)
    err = _build.load().motl_circumcenter(
        mpts.data_ptr(), mm8.data_ptr(), c, p, out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "motl_circumcenter")
    circumcenter_xy.launches += 1
    return out


circumcenter_xy.launches = 0
