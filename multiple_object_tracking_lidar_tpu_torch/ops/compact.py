"""Order-preserving stream compaction under static shapes.

Port of ``multiple_object_tracking_lidar_tpu/ops/compact.py``: pack the
kept rows to the front of a fixed-size output, relative order kept -- a
cumsum and a scatter into unique slots, no sort, no host sync.
"""

from __future__ import annotations

import torch


def compact_points(
    data: torch.Tensor, keep: torch.Tensor, out_size: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the rows of ``data`` (..., n, d) where ``keep`` (..., n) into
    (..., out_size, d).  Returns (packed, packed_mask, n_kept); rows past
    out_size are dropped, and n_kept counts them all, so a caller can report
    the truncation.  Leading dims batch independent frames."""
    lead = keep.shape[:-1]
    n = keep.shape[-1]
    d = data.shape[-1]
    keep = keep.reshape(-1, n)
    data = data.reshape(-1, n, d)
    b = keep.shape[0]
    dev = keep.device
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1        # target slot per kept row
    n_kept = torch.clamp(pos[:, -1] + 1, min=0) if n > 0 else torch.zeros(b, dtype=torch.int64, device=dev)
    slot = torch.where(keep & (pos < out_size), pos, out_size)  # the rest: a dump slot
    dest = (torch.arange(b, device=dev)[:, None] * (out_size + 1) + slot).reshape(-1)
    out = torch.zeros((b * (out_size + 1), d), dtype=data.dtype, device=dev)
    out.index_put_((dest,), data.reshape(-1, d))
    out_mask = torch.zeros(b * (out_size + 1), dtype=torch.bool, device=dev)
    out_mask.index_put_((dest,), keep.reshape(-1))
    out = out.reshape(b, out_size + 1, d)[:, :out_size]
    out_mask = out_mask.reshape(b, out_size + 1)[:, :out_size]
    return (out.reshape(lead + (out_size, d)), out_mask.reshape(lead + (out_size,)),
            n_kept.to(torch.int32).reshape(lead))
