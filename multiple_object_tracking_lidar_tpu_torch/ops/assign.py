"""Data association + track lifecycle: greedy order-faithful decisions,
closed-form window updates.

Port of the greedy path of ``multiple_object_tracking_lidar_tpu/ops/
assign.py`` (ref: src/multiple_object_tracking_lidar.cpp:163-232,
507-619).  Each detection, in cluster order, claims the FIRST registered
track (registration order) whose last position is within ``id_threshold``
(strict <, 2-D); a miss registers a new track whose window is filled with
the detection.  The reference's quirks stay: greedy first match, no claimed
set, a track registered earlier in the frame can be matched later in it.
This is the plain route of the track step (``ops/track_cuda.py::
track_step_plain``): the decisions run in K4's plain version
(``ops/assign_cuda.py::assoc_scan_plain``, device-agnostic torch that
reads each detection's decision on the host), and the (K, L, 4) windows
and GP carries are then rebuilt in closed form here.  On the card within
K4's bounds the kernel (``csrc/assign.cu``) does both in one launch.
Deviation kept from the JAX package: a registration that finds every slot
alive is dropped and counted in ``overflow``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.assign_cuda import assoc_scan_plain
from multiple_object_tracking_lidar_tpu_torch.ops.half import madd
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype, true_div
from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackBank


class AssocResult(NamedTuple):
    bank: TrackBank
    next_obj_num: torch.Tensor
    next_birth: torch.Tensor
    det_slot: torch.Tensor     # (D,) bank slot per detection (defined where det_ok)
    det_id: torch.Tensor       # (D,) published obj id per detection (-1 dropped)
    det_new: torch.Tensor      # (D,) registered a new track
    det_ok: torch.Tensor       # (D,) detection produced/updated a track
    overflow: torch.Tensor     # scalar int32
    assoc_saturated: torch.Tensor  # scalar int32, always 0 for greedy


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k, i, :] = table[k, idx[k, i], :] -- an exact gather."""
    return torch.gather(table, 1, idx[..., None].expand(*idx.shape, table.shape[2]))


def _interp_backfill(w: torch.Tensor, det: torch.Tensor, dt_gp: float) -> torch.Tensor:
    """Batched fill_with_linear_interpolation (cpp:593-619): w (K, L, 4),
    det (K, 4).  new[k] = w[k + lost] for k < L - lost, else
    interp[k - (L - lost)] = last + (j+1) * d_total / lost, z total 0."""
    L = w.shape[1]
    dt32 = in_dtype(dt_gp, w.dtype)
    last = w[:, L - 1]
    gap = det[:, 3] - last[:, 3]
    lost = torch.round(true_div(gap, dt32)).to(torch.int64) - 1
    lost_c = torch.clamp(lost, min=1)   # guard division; caller gates lost >= 1
    ks = torch.arange(L, device=w.device)[None, :]
    src = ks + lost[:, None]
    shifted = _take_rows(w, torch.clamp(src, 0, L - 1))
    jj = (ks - L + lost_c[:, None] + 1).to(w.dtype)
    d_total = det - last
    step_xyz = d_total[:, :3] / lost_c.to(w.dtype)[:, None]
    keep_xy = torch.tensor([1.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    interp = torch.cat(
        [
            last[:, None, :3] + jj[..., None] * step_xyz[:, None, :] * keep_xy,
            (madd(jj, dt32, last[:, None, 3].expand_as(jj)) if w.dtype == torch.float16
             else last[:, None, 3] + jj * dt32)[..., None],   # f16: XLA's contracted FMA
        ],
        dim=2,
    )
    return torch.where((src < L)[..., None], shifted, interp)


def apply_window_updates(bank: TrackBank, dets, slots, oks, news, interps, dt_gp):
    """Closed-form application of the per-detection decisions to the
    (K, L, 4) windows and GP carries: interpolation backfill, full fill,
    pushes."""
    K, L = bank.window.shape[0], bank.window.shape[1]
    D = dets.shape[0]
    dev = dets.device
    dtype = bank.window.dtype
    slots = slots.to(torch.int64)
    idxK = torch.arange(K, device=dev)

    # per-slot detection table in arrival order
    onehot = (slots[:, None] == idxK[None, :]) & oks[:, None]            # (D, K)
    ordinal = torch.gather(torch.cumsum(onehot.to(torch.int64), 0) - 1, 1, slots[:, None])[:, 0]
    mult = onehot.sum(0)                                                 # (K,)
    row = torch.where(oks, slots, K)
    table = torch.zeros((K + 1, D, 4), dtype=dtype, device=dev)
    table[row, torch.clamp(ordinal, 0, D - 1)] = torch.where(oks[:, None], dets.to(dtype), 0.0)
    table = table[:K]

    # which slots' FIRST detection registered / interpolated
    first_row = torch.where(oks & (ordinal == 0), slots, K)
    first_reg = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    first_reg[first_row] = news
    first_interp = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    first_interp[first_row] = interps
    first_reg, first_interp = first_reg[:K], first_interp[:K]

    d1 = table[:, 0, :]                                                  # (K, 4)
    interp_w = _interp_backfill(bank.window, d1, dt_gp)
    base = torch.where(first_interp[:, None, None], interp_w, bank.window)
    base = torch.where(first_reg[:, None, None], d1[:, None, :].expand(K, L, 4), base)

    # pushes: all assigned dets except d1 when it registered (the fill IS d1)
    n_push = torch.where(first_reg, mult - 1, mult)                      # (K,)
    offset = first_reg.to(torch.int64)
    ks = torch.arange(L, device=dev)[None, :]
    src = ks + n_push[:, None]                                           # (K, L)
    from_base = _take_rows(base, torch.clamp(src, 0, L - 1))
    push_idx = torch.clamp(ks - (L - n_push[:, None]) + offset[:, None], 0, D - 1)
    from_push = _take_rows(table, push_idx)
    window = torch.where((src < L)[..., None], from_base, from_push)
    window = torch.where((mult > 0)[:, None, None], window, bank.window)

    # reset the GP carry of newly registered tracks (ctor zeroes m, cpp:45)
    reg_mask = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    reg_mask[torch.where(news, slots, K)] = news
    m0 = torch.where(reg_mask[:K, None, None], torch.zeros_like(bank.m0), bank.m0)
    return window, m0


def associate_and_update(
    bank: TrackBank,
    next_obj_num: torch.Tensor,
    next_birth: torch.Tensor,
    dets: torch.Tensor,        # (D, 4) [x, y, 0, t]
    det_valid: torch.Tensor,   # (D,)
    id_threshold: float,
    dt_gp: float,
    interp_gap_factor: float = 3.0,
    allow_match: torch.Tensor | bool = True,
) -> AssocResult:
    """``allow_match=False`` is the first-frame path (cpp:153-156): every
    centroid registers, no gating against the bank."""
    L = bank.window.shape[1]
    dev = dets.device
    last = bank.window[:, L - 1, :]
    af0 = torch.stack([last[:, 0], last[:, 1], last[:, 3]], dim=1)
    ai0 = torch.stack(
        [bank.alive.to(torch.int32), bank.obj_id.to(torch.int32), bank.birth_seq.to(torch.int32)],
        dim=1,
    )
    allow = torch.as_tensor(allow_match, device=dev).to(torch.bool)
    (alive, obj_id, birth_seq, nobj, nbirth, ovf, slots, ids, news, oks, interps) = assoc_scan_plain(
        af0, ai0, dets.to(af0.dtype), det_valid, allow,
        next_obj_num, next_birth,
        thr=id_threshold, dt_gp=dt_gp, interp_gap_factor=interp_gap_factor,
    )
    window, m0 = apply_window_updates(bank, dets, slots, oks, news, interps, dt_gp)
    return AssocResult(
        bank=TrackBank(alive=alive, obj_id=obj_id, birth_seq=birth_seq, window=window, m0=m0),
        next_obj_num=nobj,
        next_birth=nbirth,
        det_slot=slots,
        det_id=ids,
        det_new=news,
        det_ok=oks,
        overflow=ovf,
        assoc_saturated=torch.zeros((), dtype=torch.int32, device=dev),
    )
