"""Tracker state as tensor NamedTuples, plus the carry-across functions.

Port of ``multiple_object_tracking_lidar_tpu/tracker/state.py``: the same
fields, layouts, dtypes and sentinels (``birth_seq = 2**30`` and
``obj_id = -1`` for free slots), so the two packages compare like with
like.  The carry-across functions move a JAX-side state, map env, cell
static table or gains dict -- given as numpy arrays -- into this package's
tensors on a device, and back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Frame(NamedTuple):
    """Input contract: a fixed-size padded point tensor."""

    points: torch.Tensor   # (N_max, 3) float32 (stacked: (S, N_max, 3))
    mask: torch.Tensor     # (N_max,) bool
    t: torch.Tensor        # scalar float32 -- stamp - time_init


class TrackBank(NamedTuple):
    alive: torch.Tensor      # (K,) bool
    obj_id: torch.Tensor     # (K,) int32 -- published id (monotone)
    birth_seq: torch.Tensor  # (K,) int32 -- registration order key
    window: torch.Tensor     # (K, L, 4) float32 -- x, y, z, t
    m0: torch.Tensor         # (K, 2, 2) float32 -- carried IHGP state per axis


class TrackerState(NamedTuple):
    bank: TrackBank
    next_obj_num: torch.Tensor   # scalar int32
    next_birth: torch.Tensor     # scalar int32
    spin_counter: torch.Tensor   # scalar int32
    initialized: torch.Tensor    # scalar bool


class FrameOutput(NamedTuple):
    """Per-frame result, fixed shapes (C_max detection slots)."""

    publish: torch.Tensor
    valid: torch.Tensor
    obj_id: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    raw_centroid: torch.Tensor
    new_track: torch.Tensor
    n_points: torch.Tensor
    n_voxels: torch.Tensor
    n_dynamic: torch.Tensor
    n_clusters: torch.Tensor
    n_alive: torch.Tensor
    overflow: torch.Tensor
    dup_saturated: torch.Tensor
    cc_saturated: torch.Tensor
    assoc_saturated: torch.Tensor


def init_state(
    k_max: int, data_length: int, dtype=torch.float32, device="cpu",
    batch: int | None = None,
) -> TrackerState:
    """A fresh state; with ``batch``, ``batch`` of them stacked on a leading
    axis (a fleet's streams, as the JAX ShardedTracker.init_state)."""
    lead = () if batch is None else (batch,)
    i32 = dict(dtype=torch.int32, device=device)
    bank = TrackBank(
        alive=torch.zeros(lead + (k_max,), dtype=torch.bool, device=device),
        obj_id=torch.full(lead + (k_max,), -1, **i32),
        birth_seq=torch.full(lead + (k_max,), 2**30, **i32),
        window=torch.zeros(lead + (k_max, data_length, 4), dtype=dtype, device=device),
        m0=torch.zeros(lead + (k_max, 2, 2), dtype=dtype, device=device),
    )
    return TrackerState(
        bank=bank,
        next_obj_num=torch.zeros(lead, **i32),
        next_birth=torch.zeros(lead, **i32),
        spin_counter=torch.zeros(lead, **i32),
        initialized=torch.zeros(lead, dtype=torch.bool, device=device),
    )


_GROW_FILL = {"alive": False, "obj_id": -1, "birth_seq": 2**30, "window": 0, "m0": 0}


def grow_bank(state: TrackerState, k_new: int) -> TrackerState:
    """``state`` with every TrackBank field padded to ``k_new`` rows on its
    device, with the free-slot values of ``init_state`` (the JAX node's
    ``_grow_bank`` fills, runtime/node.py:251-262); the scalars carry over
    unchanged."""
    b = state.bank
    k_old = b.alive.shape[0]
    if k_new < k_old:
        raise ValueError(f"cannot shrink the bank from {k_old} to {k_new} slots")

    def pad(f):
        a = getattr(b, f)
        ext = torch.full((k_new - k_old,) + tuple(a.shape[1:]), _GROW_FILL[f],
                         dtype=a.dtype, device=a.device)
        return torch.cat([a, ext], dim=0)

    return state._replace(bank=TrackBank(**{f: pad(f) for f in TrackBank._fields}))


def map_state(fn, state: TrackerState) -> TrackerState:
    """``fn`` applied to every tensor of a TrackerState (``lambda x: x[s]``:
    stream s of a stacked state, as views)."""
    return TrackerState(
        bank=TrackBank(*(fn(f) for f in state.bank)),
        **{f: fn(getattr(state, f)) for f in TrackerState._fields if f != "bank"},
    )


def stack_states(states: list[TrackerState]) -> TrackerState:
    """Per-stream states stacked on a leading axis."""
    return TrackerState(
        bank=TrackBank(*(torch.stack(f) for f in zip(*(st.bank for st in states)))),
        **{f: torch.stack([getattr(st, f) for st in states])
           for f in TrackerState._fields if f != "bank"},
    )


# --- carry-across: JAX-side values as numpy <-> this package's tensors ------

_STATE_DTYPES = {
    "alive": torch.bool, "obj_id": torch.int32, "birth_seq": torch.int32,
    "window": torch.float32, "m0": torch.float32, "next_obj_num": torch.int32,
    "next_birth": torch.int32, "spin_counter": torch.int32,
    "initialized": torch.bool,
}


_HALF_NP = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _t(a, dtype, device) -> torch.Tensor:
    a = np.array(a)  # a copy: never aliases
    if dtype == torch.float16 and a.dtype == np.float64:
        # numpy rounds f64 to f16 once, as JAX's cast does; torch's cast goes
        # through f32 (twice rounded)
        a = a.astype(np.float16)
    if a.dtype.name in _HALF_NP:
        # a JAX half array (ml_dtypes' bfloat16 has no torch twin in numpy):
        # its bits, reinterpreted
        t = torch.from_numpy(a.view(np.int16)).view(_HALF_NP[a.dtype.name])
        return t.to(device).to(dtype)
    return torch.as_tensor(a, device=device).to(dtype)


def _float_t(a, device) -> torch.Tensor:
    """A float leaf in its compute dtype: f64, bf16 and f16 stay, the rest
    f32."""
    a = np.array(a)
    keep = {"float64": torch.float64, **_HALF_NP}
    return _t(a, keep.get(a.dtype.name, torch.float32), device)


def state_from_numpy(state, device="cpu") -> TrackerState:
    """A JAX TrackerState (any NamedTuple with its fields, leaves as numpy
    arrays) -> this package's TrackerState on ``device``.  Leaves keep
    their shapes, so a fleet's batched state (a leading stream axis)
    carries across as a stacked state."""
    b = state.bank
    bank = TrackBank(**{
        f: _float_t(getattr(b, f), device) if _STATE_DTYPES[f].is_floating_point
        else _t(getattr(b, f), _STATE_DTYPES[f], device)
        for f in TrackBank._fields})
    return TrackerState(
        bank=bank,
        **{
            f: _t(getattr(state, f), _STATE_DTYPES[f], device)
            for f in TrackerState._fields
            if f != "bank"
        },
    )


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bf16 / f16 widened to f32 (exactly:
    numpy has no bf16 without ml_dtypes)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()


def state_to_numpy(state: TrackerState) -> dict:
    """The inverse: {field: numpy} with the bank's fields nested under
    "bank", the shape the JAX TrackerState's constructor takes (a half
    state's floats widened to f32)."""
    return {
        "bank": {f: host_numpy(getattr(state.bank, f)) for f in TrackBank._fields},
        **{f: host_numpy(getattr(state, f)) for f in TrackerState._fields if f != "bank"},
    }


def env_from_numpy(env, device="cpu"):
    """A JAX MapEnv (numpy leaves) -> this package's MapEnv on ``device``.
    It carries no f64 host mirror, so table builds read its f32 values, as
    the JAX package does for an env it did not build itself."""
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import MapEnv

    return MapEnv(
        dilated=_t(env.dilated, torch.bool, device),
        **{
            f: _t(getattr(env, f), torch.float32, device)
            for f in ("origin_x", "origin_y", "cos_nyaw", "sin_nyaw", "inv_resolution")
        },
    )


def env_to_numpy(env) -> dict:
    return {
        f: getattr(env, f).cpu().numpy()
        for f in ("dilated", "origin_x", "origin_y", "cos_nyaw", "sin_nyaw", "inv_resolution")
    }


def table_from_numpy(table, device="cpu"):
    """A JAX CellStaticTable (numpy leaves, int k) -> this package's."""
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import CellStaticTable

    return CellStaticTable(
        base_row=_t(table.base_row, torch.int32, device),
        base_col=_t(table.base_col, torch.int32, device),
        bits=_t(table.bits, torch.int32, device),
        k=int(table.k),
    )


def table_to_numpy(table) -> dict:
    return {
        "base_row": table.base_row.cpu().numpy(),
        "base_col": table.base_col.cpu().numpy(),
        "bits": table.bits.cpu().numpy(),
        "k": int(table.k),
    }


def gains_from_numpy(gains_xy: dict, device="cpu", dtype=torch.float32) -> dict:
    """The JAX Tracker.gains_xy dict (numpy leaves; the smoother weights
    W_vel / W_pos are nested dicts) -> the same nesting of tensors of the
    compute dtype (f32 or f64)."""
    return {
        k: gains_from_numpy(v, device, dtype) if isinstance(v, dict) else _t(v, dtype, device)
        for k, v in gains_xy.items()
    }


def gains_to_numpy(gains_xy: dict) -> dict:
    return {
        k: gains_to_numpy(v) if isinstance(v, dict) else v.cpu().numpy()
        for k, v in gains_xy.items()
    }
