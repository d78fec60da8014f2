"""K4: the whole track step -- association (greedy, or under
``association="hungarian"`` the eps-scaling auction and its registrations),
window updates, the chained IHGP velocity passes, LPF positions (or under
``position_filter="ihgp"`` an IHGP position pass chained before each
velocity pass), expiry -- in one launch.

Replaces the Pallas kernel ``multiple_object_tracking_lidar_tpu/ops/
assign_pallas.py::assoc_scan_pallas`` and, around it, the rest of the JAX
``track_step`` (tracker/pipeline.py:942-1100), which XLA compiles into one
program with it.  CUDA source: ``csrc/assign.cu``, whose header says what
bounds it on the H100 (latency: a sequential scan over the detections,
then a few hundred flops per updated track) and how its design answers
that (one CTA per track bank, one lane per slot, the S frames of a call
scanned in order inside the CTA; no host sync).  Its narrow builds hold
K <= 1,024 slots and D <= 128 detections (``kernel_fits``); past them the
wrapper launches K4 xl, the same step with several slots per lane and the
per-slot summaries, the decisions and the auction's tables sized at run
time (``motl_track_step_xl``), bit for bit the same results.

``track_frames`` takes B banks (a leading stream axis on the state) and S
frames per bank: (B, S, D, 4) detections, (B, S, D) valid flags, (B, S)
stamps.  ``bind_env`` launches it at 1 x 1, ``bind_env_multi`` at 1 x S
and the fleet at B x 1 (``tracker/pipeline.py::track_batch``).  It
launches the kernel for CUDA tensors at any K and D and runs
``track_frames_plain`` for CPU tensors; ``.launches_by`` counts kernel
launches by C entry (``motl_track_step``, ``_f64`` -- the double builds of
``dtype="float64"`` -- ``_xl``, ``_xl_f64``) and ``.launches`` those of
``motl_track_step``.  Both return (the state after the S frames,
``TrackOutputs`` stacked (B, S, ...)).

``track_step_plain`` is the plain version of one bank and one frame: the
decisions (``assign_cuda.assoc_scan_plain``, or under hungarian
``ops/hungarian.py::hungarian_associate_and_update_plain``, as JAX
tracker/pipeline.py:965-990 picks them), the closed-form window
updates (``ops/assign.py``), and the filter with every f32 reduction
spelled as an ascending loop started from its first term -- the order the
kernel sums in, so the two agree bit for bit.  It is the CPU route.  It
reads the duplicate-pass count on the host once per frame
(``track_step_plain.host_syncs``), and under hungarian the auction's
convergence once per ``ops/hungarian.py::CHECK_EVERY`` iterations; the
kernel never does.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.models.lpf import lpf_coefficients, lpf_pos
from multiple_object_tracking_lidar_tpu_torch.ops.assign import associate_and_update
from multiple_object_tracking_lidar_tpu_torch.ops.assign_cuda import MAX_DETS, MAX_LANES, _consts
from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
    EPS,
    MAX_ITERS,
    hungarian_associate_and_update_plain,
)
from multiple_object_tracking_lidar_tpu_torch.ops.hungarian_cuda import auction_params
from multiple_object_tracking_lidar_tpu_torch.ops.half import is_half, madd, mean_f32, sum_f32
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype, recip_f32, true_div
from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
    TrackBank,
    TrackerState,
    map_state,
    stack_states,
)


class TrackOutputs(NamedTuple):
    """The FrameOutput fields the track step computes (the others pass
    perception through)."""

    publish: torch.Tensor         # bool
    valid: torch.Tensor           # (D,) bool
    obj_id: torch.Tensor          # (D,) int32
    pos: torch.Tensor             # (D, 2) f32
    vel: torch.Tensor             # (D, 2) f32
    new_track: torch.Tensor       # (D,) bool
    n_alive: torch.Tensor         # int32
    overflow: torch.Tensor        # int32
    dup_saturated: torch.Tensor   # int32, 0: every multiplicity runs exactly
    assoc_saturated: torch.Tensor  # int32: the auction's saturated phases, 0 for greedy


def kernel_fits(k: int, d: int) -> bool:
    """True iff K4's narrow builds hold a bank of ``k`` slots and ``d``
    detection slots (one lane per slot, the shared detection buffer); past
    them ``track_frames`` launches K4 xl."""
    return 1 <= k <= MAX_LANES and 1 <= d <= MAX_DETS


@functools.lru_cache(maxsize=64)
def xl_scratch_bytes(k: int, d: int, L: int, f64: bool, ihgp: bool, hungarian: bool) -> int:
    """K4 xl's device-memory scratch per bank (``csrc/assign.cu::xl_layout``)."""
    out = (ctypes.c_longlong * 2)()
    _build.check(_build.load().motl_track_step_xl_scratch(
        k, d, L, int(f64), int(ihgp), int(hungarian), out), "motl_track_step_xl_scratch")
    return int(out[0])


def _asc_sum(terms):
    """Ascending f32 sum, started from the first term (the kernel's order)."""
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


def _wsum(pairs, dtype):
    """An einsum's sum of products over its contracted index, ascending: in
    the dtype for f32 / f64 (the kernel's order); for bf16 / f16 the
    products and the sum in f32, rounded once, as XLA's CPU dot of half
    operands (ops/half.py)."""
    if is_half(dtype):
        return sum_f32(pairs, dtype)
    return _asc_sum([a * b for a, b in pairs])


def smoother_parts(window: torch.Tensor, w_vel: dict, dt_gp: float):
    """The pass-independent parts of the velocity smoother on a (K, L, 4)
    window: (vmean (K, 2), ey (K, 2) = sum_l y_l Wy[:, -1, l], my (K, 2, 2)
    = sum_l y_l My[:, :, l]), y the mean-centred window velocities
    (cpp:887-898) -- each sum ascending in l (in f32 for the half dtypes,
    the mean that sum times f32(1 / n); in bf16 the mean sums the
    velocities' f32 products before their rounding, and in f16 the
    centring contracts the velocity's product, as XLA's fusions do)."""
    dt = window.dtype
    diff = window[:, 1:, :2] - window[:, :-1, :2]
    vels = true_div(diff, in_dtype(dt_gp, dt))                                  # (K, L-1, 2)
    n = vels.shape[1]
    if dt == torch.bfloat16:
        # XLA keeps the bf16 velocities' f32 products unrounded in the mean's sum
        v32 = diff.float() * recip_f32(dt_gp, dt)
        vmean = mean_f32([v32[:, l] for l in range(n)], dt)
    elif is_half(dt):
        vmean = mean_f32([vels[:, l] for l in range(n)], dt)
    else:
        vmean = true_div(_asc_sum([vels[:, l] for l in range(n)]), float(n))
    if dt == torch.float16:
        # XLA's f16 code contracts the velocity's product into the centring
        y = madd(diff, in_dtype(1.0 / in_dtype(dt_gp, dt), dt), -vmean[:, None, :])
    else:
        y = vels - vmean[:, None, :]
    wy, my_w = w_vel["Wy"][:, -1, :], w_vel["My"]                      # (2, L-1), (2, 2, L-1)
    ey = _wsum([(y[:, l], wy[:, l]) for l in range(n)], dt)
    my = _wsum([(y[:, l, :, None], my_w[:, :, l]) for l in range(n)], dt)
    return vmean, ey, my


def position_parts(window: torch.Tensor, w_pos: dict):
    """The pass-independent parts of the IHGP position smoother on a (K, L,
    4) window: (pmean (K, 2), the last row's xy; ey (K, 2) = sum_l y_l
    Wy[:, -1, l]; my (K, 2, 2) = sum_l y_l My[:, :, l]), y the window's xy
    less pmean (cpp:835-869) -- each sum ascending in l."""
    dt = window.dtype
    pmean = window[:, -1, :2]
    y = window[:, :, :2] - pmean[:, None, :]                            # (K, L, 2)
    n = y.shape[1]
    wy, my_w = w_pos["Wy"][:, -1, :], w_pos["My"]                      # (2, L), (2, 2, L)
    ey = _wsum([(y[:, l], wy[:, l]) for l in range(n)], dt)
    my = _wsum([(y[:, l, :, None], my_w[:, :, l]) for l in range(n)], dt)
    return pmean, ey, my


def smoother_pass(m: torch.Tensor, ey, my, w: dict):
    """One closed-form smoother pass from the carry m (K, 2, 2) with the
    y-parts given: (eft_last (K, 2), next carry (K, 2, 2)) -- the JAX
    ``ihgp_apply_weights``."""
    dt = m.dtype
    wm, mm = w["Wm"][:, -1, :], w["Mm"]                                # (2, 2), (2, 2, 2)
    em = _wsum([(m[:, :, 0], wm[:, 0]), (m[:, :, 1], wm[:, 1])], dt)
    m_next = my + _wsum([(m[:, :, None, 0], mm[:, :, 0]), (m[:, :, None, 1], mm[:, :, 1])], dt)
    return ey + em, m_next


def velocity_pass(m: torch.Tensor, vmean, ey, my, w_vel: dict, vmax: float):
    """One IHGP velocity pass from the carry m (K, 2, 2): (clamped velocity
    (K, 2), next carry (K, 2, 2)), then the NaN-preserving clamp
    (cpp:649-654)."""
    eft, m_next = smoother_pass(m, ey, my, w_vel)
    vel = eft + vmean
    vel = torch.where(vel > vmax, vmax, torch.where(vel < -vmax, -vmax, vel))
    return vel, m_next


def position_pass(m: torch.Tensor, pmean, ey_pos, my_pos, w_pos: dict):
    """One IHGP position pass from the carry m (K, 2, 2), the reference's
    present-but-disabled mode (``position_filter="ihgp"``): (position (K,
    2), the carry the velocity pass then starts from)."""
    eft, m_mid = smoother_pass(m, ey_pos, my_pos, w_pos)
    return eft + pmean, m_mid


def track_step_plain(
    state: TrackerState, dets: torch.Tensor, det_valid: torch.Tensor, t: torch.Tensor, *,
    config, gains_xy: dict,
) -> tuple[TrackerState, TrackOutputs]:
    """Plain PyTorch version of K4 on one bank and one frame: dets (D, 4),
    det_valid (D,), t scalar (port of the JAX track_step, greedy or
    Hungarian association; LPF positions, or under ``position_filter=
    "ihgp"`` an IHGP position pass before each velocity pass, the velocity
    pass chained on its carry, JAX pipeline.py:1015-1022)."""
    L = config.data_length
    dt_gp = config.dt_gp
    any_det = det_valid.any()
    was_init = state.initialized
    steady = was_init & any_det   # publish/filter/expire this frame (cpp:163+)

    associate = (hungarian_associate_and_update_plain if config.association == "hungarian"
                 else associate_and_update)
    assoc = associate(
        state.bank, state.next_obj_num, state.next_birth, dets, det_valid,
        config.id_threshold, dt_gp, config.interp_gap_factor,
        allow_match=was_init,  # first frame registers without gating (cpp:153-156)
    )
    bank = assoc.bank
    k_max = bank.alive.shape[0]
    w_vel = gains_xy["W_vel"]
    vmean, ey, my = smoother_parts(bank.window, w_vel, dt_gp)
    ihgp = config.position_filter == "ihgp"
    if ihgp:
        w_pos = gains_xy["W_pos"]
        pmean, ey_pos, my_pos = position_parts(bank.window, w_pos)
    else:
        pos = lpf_pos(bank.window, config.lpf_tau, dt_gp)              # (cpp:638, 824-833)
    dt = bank.window.dtype
    vmax = in_dtype(config.max_velocity, dt)

    # The reference runs callIHGP once PER matched detection (cpp:629-659):
    # a track matched d times this frame runs d chained passes and each
    # duplicate publishes the output of its own pass.
    det_active = assoc.det_ok & steady
    slot = assoc.det_slot.to(torch.int64)
    onehot = (slot[:, None] == torch.arange(k_max, device=dets.device)[None, :]) & det_active[:, None]
    mult = onehot.sum(0)                                               # (K,)
    ordinal = torch.gather(torch.cumsum(onehot.to(torch.int64), 0) - 1, 1, slot[:, None])[:, 0]
    max_mult = int(mult.max())  # the one host sync per frame
    track_step_plain.host_syncs += 1

    m = bank.m0
    m_fin = bank.m0
    pos_det = dets[:, :2] * 0  # as the JAX init: NaN-preserving
    vel_det = dets[:, :2] * 0
    for q in range(max_mult):
        if ihgp:
            pos, m = position_pass(m, pmean, ey_pos, my_pos, w_pos)
        vel, m_next = velocity_pass(m, vmean, ey, my, w_vel, vmax)
        selp = (ordinal == q)[:, None]
        pos_det = torch.where(selp, pos[slot], pos_det)
        vel_det = torch.where(selp, vel[slot], vel_det)
        m_fin = torch.where((mult == q + 1)[:, None, None], m_next, m_fin)
        m = m_next

    # ---- expiry (cpp:545-584)
    spin = state.spin_counter + steady.to(torch.int32)
    do_prune = spin > int(config.prune_period * config.frequency)
    stale = (t.to(dt) - bank.window[:, L - 1, 3]) > in_dtype(config.prune_period, dt)
    prune = do_prune & steady
    alive = torch.where(prune, bank.alive & ~stale, bank.alive)
    spin = torch.where(prune, torch.zeros_like(spin), spin)

    new_state = TrackerState(
        bank=bank._replace(alive=alive, m0=m_fin),
        next_obj_num=assoc.next_obj_num,
        next_birth=assoc.next_birth,
        spin_counter=spin,
        initialized=was_init | any_det,
    )
    out = TrackOutputs(
        publish=steady,
        valid=assoc.det_ok & steady,
        obj_id=assoc.det_id,
        pos=pos_det,
        vel=vel_det,
        new_track=assoc.det_new,
        n_alive=alive.sum().to(torch.int32),
        overflow=assoc.overflow,
        dup_saturated=(mult < 0).sum().to(torch.int32),
        assoc_saturated=assoc.assoc_saturated,
    )
    return new_state, out


track_step_plain.host_syncs = 0


def track_frames_plain(state, dets, det_valid, t, *, config, gains_xy):
    """Plain version of ``track_frames``: ``track_step_plain`` bank by bank,
    frame by frame."""
    n_b, n_s = det_valid.shape[:2]
    states, rows = [], []
    for bi in range(n_b):
        st = map_state(lambda x: x[bi], state)
        outs = []
        for si in range(n_s):
            st, o = track_step_plain(st, dets[bi, si], det_valid[bi, si], t[bi, si],
                                     config=config, gains_xy=gains_xy)
            outs.append(o)
        states.append(st)
        rows.append(TrackOutputs(*(torch.stack(f) for f in zip(*outs))))
    return stack_states(states), TrackOutputs(*(torch.stack(f) for f in zip(*rows)))


_SUFFIX = {torch.float32: "", torch.float64: "_f64", torch.bfloat16: "_bf16",
           torch.float16: "_f16"}


def track_frames(
    state: TrackerState,      # every field with a leading (B,) bank axis
    dets: torch.Tensor,       # (B, S, D, 4) f32
    det_valid: torch.Tensor,  # (B, S, D) bool
    t: torch.Tensor,          # (B, S) f32
    *,
    config,
    gains_xy: dict,
) -> tuple[TrackerState, TrackOutputs]:
    """K4 on CUDA tensors, ``track_frames_plain`` on CPU tensors.  f64
    tensors (dets, t, the bank's window and m0, the gains) launch the
    double build (``motl_track_step_f64``), one launch too; bf16 / f16 ones
    (greedy or Hungarian association) the half builds
    (``motl_track_step_bf16`` / ``_f16``), which read and write the half
    tensors themselves; a bank past the
    narrow builds' ``kernel_fits`` launches K4 xl (``motl_track_step_xl``,
    ``_xl_f64``, ``_xl_bf16``, ``_xl_f16``)."""
    if dets.device.type == "cpu":
        return track_frames_plain(state, dets, det_valid, t, config=config, gains_xy=gains_xy)
    bank = state.bank
    n_b, n_s, d = det_valid.shape
    k, L = bank.window.shape[1], bank.window.shape[2]
    dev = dets.device
    dt = dets.dtype
    if k < 1 or d < 1:
        raise ValueError(f"K4 needs K >= 1 track slots and D >= 1 detections (got {k}, {d})")
    if (dets.shape != (n_b, n_s, d, 4) or dt not in _SUFFIX or t.shape != (n_b, n_s)):
        raise ValueError(f"dets must be ({n_b}, {n_s}, {d}, 4) float32, float64, bfloat16 "
                         f"or float16 and t ({n_b}, {n_s})")
    if bank.window.shape != (n_b, k, L, 4) or bank.window.dtype != dt or L < 2:
        raise ValueError(f"window must be ({n_b}, {k}, L >= 2, 4) {dt}")
    w, wp = gains_xy["W_vel"], gains_xy["W_pos"]
    if any(x.dtype != dt for x in (bank.m0, *w.values(), *wp.values())):
        raise ValueError(f"m0 and the smoother weights must be {dt}, as the detections")
    thr32, gapthr, dt32 = _consts(config.id_threshold, config.dt_gp, config.interp_gap_factor, dt)
    hungarian = config.association == "hungarian"
    # the auction's parameters as JAX's hungarian_associate_and_update sets
    # them: its eps, max_cost the gate, auction_assign's cap and scale, in
    # the compute dtype (the half builds take them as f32 holding half values)
    au, n_phases = (auction_params(d, EPS, config.id_threshold, dtype=dt) if hungarian
                    else (None, 0))
    i32 = dict(dtype=torch.int32, device=dev)
    u8 = dict(dtype=torch.bool, device=dev)
    new = TrackerState(
        bank=TrackBank(
            alive=torch.empty((n_b, k), **u8), obj_id=torch.empty((n_b, k), **i32),
            birth_seq=torch.empty((n_b, k), **i32),
            window=torch.empty((n_b, k, L, 4), dtype=dt, device=dev),
            m0=torch.empty((n_b, k, 2, 2), dtype=dt, device=dev),
        ),
        next_obj_num=torch.empty((n_b,), **i32), next_birth=torch.empty((n_b,), **i32),
        spin_counter=torch.empty((n_b,), **i32), initialized=torch.empty((n_b,), **u8),
    )
    publish = torch.empty((n_b, n_s), **u8)
    valid = torch.empty((n_b, n_s, d), **u8)
    new_track = torch.empty((n_b, n_s, d), **u8)
    obj_id = torch.empty((n_b, n_s, d), **i32)
    pos = torch.empty((n_b, n_s, d, 2), dtype=dt, device=dev)
    vel = torch.empty((n_b, n_s, d, 2), dtype=dt, device=dev)
    counts = torch.empty((n_b, n_s, 4), **i32)
    # inputs made contiguous first and held until the launch: a temporary
    # freed before it could hand its memory to the next one
    ins = [x.contiguous() for x in (
        dets, det_valid.to(torch.bool), t.to(dt), bank.alive, bank.obj_id,
        bank.birth_seq, bank.window, bank.m0, state.next_obj_num, state.next_birth,
        state.spin_counter, state.initialized, w["Wy"], w["Wm"], w["My"], w["Mm"],
        wp["Wy"], wp["Wm"], wp["My"], wp["Mm"])]
    nb = new.bank
    xl = not kernel_fits(k, d)
    entry = "motl_track_step" + ("_xl" if xl else "") + _SUFFIX[dt]
    ihgp = config.position_filter == "ihgp"
    scratch = (torch.empty((n_b * xl_scratch_bytes(k, d, L, dt == torch.float64, ihgp,
                                                   hungarian),), dtype=torch.uint8, device=dev)
               if xl else None)
    err = getattr(_build.load(), entry)(
        *(x.data_ptr() for x in ins), int(ihgp),
        int(hungarian), ctypes.addressof(au) if hungarian else None, n_phases, MAX_ITERS,
        n_b, n_s, k, d, L,
        thr32, gapthr, dt32, in_dtype(config.max_velocity, dt),
        *lpf_coefficients(config.lpf_tau, config.dt_gp, dt),
        in_dtype(config.prune_period, dt), int(config.prune_period * config.frequency),
        nb.alive.data_ptr(), nb.obj_id.data_ptr(), nb.birth_seq.data_ptr(),
        nb.window.data_ptr(), nb.m0.data_ptr(), new.next_obj_num.data_ptr(),
        new.next_birth.data_ptr(), new.spin_counter.data_ptr(), new.initialized.data_ptr(),
        publish.data_ptr(), valid.data_ptr(), obj_id.data_ptr(), pos.data_ptr(),
        vel.data_ptr(), new_track.data_ptr(), counts.data_ptr(),
        *((scratch.data_ptr(),) if xl else ()), _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    _build.count(track_frames, entry, "motl_track_step")
    return new, TrackOutputs(
        publish=publish, valid=valid, obj_id=obj_id, pos=pos, vel=vel, new_track=new_track,
        n_alive=counts[..., 0], overflow=counts[..., 1], dup_saturated=counts[..., 2],
        assoc_saturated=counts[..., 3],
    )


track_frames.launches = 0                   # motl_track_step's
track_frames.launches_by = collections.Counter()   # by C entry
