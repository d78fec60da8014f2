"""K4's decision scan alone: the order-faithful greedy association.

The TPU kernel ``multiple_object_tracking_lidar_tpu/ops/assign_pallas.py::
assoc_scan_pallas`` makes only these decisions; on the card they are the
first stage of the whole track step (``ops/track_cuda.py``, one launch per
call), and ``assoc_scan`` launches that stage alone, from the same device
function (``csrc/assign.cu::decide``), so that the decisions can be held
against their plain version by themselves.  The tracking paths do not
launch it: they launch the whole step.  The TPU kernel holds K <= 128 and
the JAX package takes its jnp scan past that (assign.py:168-178).  K4's
narrow builds, and this scan alone, hold a bank grown to ``MAX_LANES`` =
1,024 slots, the largest CTA, and ``MAX_DETS`` = 128 detections (the scan
raises past them); past them the track step launches K4 xl
(``ops/track_cuda.py``).

``assoc_scan`` launches the kernel for CUDA tensors and runs
``assoc_scan_plain`` for CPU tensors; ``.launches`` counts kernel
launches.  Both return the JAX kernel's tuple: (alive (K,), obj_id (K,),
birth_seq (K,), next_obj_num, next_birth, overflow, slots (D,), ids (D,),
news (D,), oks (D,), interps (D,)).  Detections past the last valid one
keep the defaults (slot 0, id -1, flags off); ``slots`` is defined only
where ``oks`` (assign_pallas.py:159-169).
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype, true_div

_BIG = 2**30
MAX_LANES = 1024   # track slots of K4's narrow builds: one lane each, one CTA
MAX_DETS = 128     # detections of K4's narrow builds: the shared detection buffer


def _consts(thr, dt_gp, interp_gap_factor, dtype=torch.float32):
    # JAX compares values against these Python floats in their dtype (weak type)
    return (in_dtype(thr, dtype), in_dtype(interp_gap_factor * dt_gp, dtype),
            in_dtype(dt_gp, dtype))


def assoc_scan_plain(
    af0, ai0, dets, det_valid, allow, next_obj_num, next_birth,
    *, thr, dt_gp, interp_gap_factor,
):
    """Plain PyTorch version of K4: the same sequential scan, one detection
    per Python iteration (D is at most a few dozen), in the detections'
    dtype (f32, or f64: K4's double build; bf16 / f16: its half builds,
    each op rounded to the half dtype)."""
    k, d = af0.shape[0], dets.shape[0]
    dev = af0.device
    dt = dets.dtype if dets.dtype in (torch.float64, torch.bfloat16, torch.float16) \
        else torch.float32
    thr32, gapthr, dt32 = _consts(thr, dt_gp, interp_gap_factor, dt)
    af = af0.to(dt).clone()
    ai = ai0.to(torch.int32).clone()
    dets = dets.to(dt)
    dv = det_valid.to(torch.bool)
    outs = torch.zeros((5, d), dtype=torch.int32, device=dev)
    outs[1] = -1
    allow_b = bool(allow)
    nobj, nbirth, ovf = int(next_obj_num), int(next_birth), 0
    valid_at = torch.nonzero(dv).flatten()
    bound = int(valid_at[-1]) + 1 if valid_at.numel() else 0
    for j in range(bound):
        det = dets[j]
        valid = bool(dv[j])
        alive = ai[:, 0] > 0
        dx = det[0] - af[:, 0]
        dy = det[1] - af[:, 1]
        dist = torch.sqrt(dx * dx + dy * dy)
        gate = alive & (dist < thr32) & allow_b
        am = bool(gate.any())
        bank_full = bool(alive.all())
        if am:
            bsel = torch.where(gate, ai[:, 2], _BIG)
            slot = int(torch.nonzero(gate & (bsel == bsel.min()))[0])
        elif not bank_full:
            slot = int(torch.nonzero(~alive)[0])
        else:
            slot = -1
        t_slot = af[slot, 2] if slot >= 0 else torch.zeros((), dtype=dt, device=dev)
        id_slot = int(ai[slot, 1]) if slot >= 0 else 0
        gap = det[3] - t_slot
        do_interp = am and bool(
            (gap > gapthr) & (torch.round(true_div(gap, dt32)) - 1.0 >= 1.0)
        )
        reg = valid and not am and not bank_full
        matched = valid and am
        write = matched or reg
        if write:
            af[slot] = torch.stack([det[0], det[1], det[3]])
        if reg:
            ai[slot] = torch.tensor([1, nobj, nbirth], dtype=torch.int32, device=dev)
        outs[:, j] = torch.tensor(
            [max(slot, 0), id_slot if matched else (nobj if reg else -1),
             int(reg), int(write), int(do_interp and write)],
            dtype=torch.int32, device=dev,
        )
        nobj += int(reg)
        nbirth += int(reg)
        ovf += int(valid and not am and bank_full)
    scalar = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return (
        ai[:, 0] > 0, ai[:, 1], ai[:, 2], scalar(nobj), scalar(nbirth), scalar(ovf),
        outs[0], outs[1], outs[2] > 0, outs[3] > 0, outs[4] > 0,
    )


def assoc_scan(
    af0: torch.Tensor,        # (K, 3) f32 [last_x, last_y, last_t]
    ai0: torch.Tensor,        # (K, 3) i32 [alive, obj_id, birth_seq]
    dets: torch.Tensor,       # (D, 4) f32
    det_valid: torch.Tensor,  # (D,) bool
    allow: torch.Tensor,      # scalar bool -- frame-level gate allow
    next_obj_num: torch.Tensor,
    next_birth: torch.Tensor,
    *,
    thr: float,
    dt_gp: float,
    interp_gap_factor: float,
):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if af0.device.type == "cpu":
        return assoc_scan_plain(
            af0, ai0, dets, det_valid, allow, next_obj_num, next_birth,
            thr=thr, dt_gp=dt_gp, interp_gap_factor=interp_gap_factor,
        )
    k, d = af0.shape[0], dets.shape[0]
    dev = af0.device
    if not 1 <= k <= MAX_LANES or d > MAX_DETS:
        raise ValueError(
            f"K4 holds 1 <= K <= {MAX_LANES} track slots (one CTA, one lane per "
            f"slot) and D <= {MAX_DETS} detections (got K={k}, D={d})"
        )
    if af0.shape != (k, 3) or af0.dtype != torch.float32:
        raise ValueError(f"af0 must be ({k}, 3) float32")
    if ai0.shape != (k, 3) or ai0.dtype != torch.int32:
        raise ValueError(f"ai0 must be ({k}, 3) int32")
    if dets.shape != (d, 4) or dets.dtype != torch.float32:
        raise ValueError(f"dets must be ({d}, 4) float32")
    for t in (ai0, dets, det_valid, allow, next_obj_num, next_birth):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}")
    thr32, gapthr, dt32 = _consts(thr, dt_gp, interp_gap_factor)
    af0 = af0.contiguous()
    ai0 = ai0.contiguous()
    dets = dets.contiguous()
    dv8 = det_valid.to(torch.uint8).contiguous()
    allow_i = allow.to(torch.int32).reshape(1)
    cnt_in = torch.stack([next_obj_num.reshape(()), next_birth.reshape(())]).to(torch.int32)
    ai_out = torch.empty((k, 3), dtype=torch.int32, device=dev)
    outs = torch.empty((5, d), dtype=torch.int32, device=dev)
    cnt_out = torch.empty((3,), dtype=torch.int32, device=dev)
    lib = _build.load()
    err = lib.motl_assoc_scan(
        af0.data_ptr(), ai0.data_ptr(), dets.data_ptr(), dv8.data_ptr(),
        allow_i.data_ptr(), cnt_in.data_ptr(), k, d, thr32, gapthr, dt32,
        ai_out.data_ptr(), outs.data_ptr(), cnt_out.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, "motl_assoc_scan")
    assoc_scan.launches += 1
    return (
        ai_out[:, 0] > 0, ai_out[:, 1], ai_out[:, 2],
        cnt_out[0], cnt_out[1], cnt_out[2],
        outs[0], outs[1], outs[2] > 0, outs[3] > 0, outs[4] > 0,
    )


assoc_scan.launches = 0
