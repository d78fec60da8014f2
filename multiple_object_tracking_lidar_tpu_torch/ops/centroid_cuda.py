"""K3: farthest-pair column statistics per cluster slot.

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


def pair_stats(mpts: torch.Tensor, member_mask: torch.Tensor):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if mpts.device.type == "cpu":
        return pair_stats_plain(mpts, member_mask)
    if mpts.dim() != 3 or mpts.shape[2] != 3 or mpts.dtype != torch.float32:
        raise ValueError(f"mpts must be (C, P, 3) float32, got {tuple(mpts.shape)} {mpts.dtype}")
    c, p, _ = mpts.shape
    if member_mask.shape != (c, p) or member_mask.device != mpts.device:
        raise ValueError(f"member_mask must be ({c}, {p}) on {mpts.device}")
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
