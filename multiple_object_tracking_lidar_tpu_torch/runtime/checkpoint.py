"""Checkpoint/resume for TrackerState.

Port of ``multiple_object_tracking_lidar_tpu/runtime/checkpoint.py``, in its
file format exactly: one npz holding the nine state fields under the JAX
names, plus a ``__meta__`` entry, the JSON of ``extra`` as uint8 bytes.  A
checkpoint written by either package loads in the other.  The reference has
no checkpoint story -- a restart loses the whole track bank; restoring one
resumes tracking mid-stream with identical ids, windows and GP carries.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import resolve_device
from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
    TrackBank,
    TrackerState,
    host_numpy,
    state_from_numpy,
)

_HALF = {torch.bfloat16: "bfloat16", torch.float16: "float16"}

_FIELDS = [
    "alive", "obj_id", "birth_seq", "window", "m0",
    "next_obj_num", "next_birth", "spin_counter", "initialized",
]


def save_state(path: str, state: TrackerState, extra: dict | None = None) -> None:
    """A bf16 / f16 state's window and carry are written widened to f32,
    and the dtype's name under ``__half__`` (numpy has no bf16 without
    ml_dtypes); ``load_state`` rounds them back, exactly."""
    arrays = {f: host_numpy(getattr(state.bank, f)) for f in TrackBank._fields}
    arrays.update({f: host_numpy(getattr(state, f))
                   for f in TrackerState._fields if f != "bank"})
    arrays["__meta__"] = np.frombuffer(json.dumps(extra or {}).encode(), dtype=np.uint8)
    dt = state.bank.window.dtype
    if dt in _HALF:
        arrays["__half__"] = np.frombuffer(_HALF[dt].encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, device: torch.device | str = "cuda") -> tuple[TrackerState, dict]:
    """(state with its tensors on ``device``, the ``extra`` dict).  A JAX
    bf16 checkpoint holds its window and carry as ml_dtypes' bf16, which
    numpy without ml_dtypes reads as 2-byte voids (``|V2``): their bits are
    read as bf16 (the JAX package's own ``load_state`` refuses them)."""
    with np.load(path) as z:
        d = {k: z[k] for k in _FIELDS}
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")
        half = bytes(z["__half__"].tobytes()).decode() if "__half__" in z else None
    for f, a in d.items():
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            d[f] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float().numpy()
            half = "bfloat16"
    state = TrackerState(bank=TrackBank(**{f: d[f] for f in TrackBank._fields}),
                         **{f: d[f] for f in TrackerState._fields if f != "bank"})
    state = state_from_numpy(state, resolve_device(device))
    if half is not None:
        dt = {v: k for k, v in _HALF.items()}[half]
        state = state._replace(bank=state.bank._replace(window=state.bank.window.to(dt),
                                                        m0=state.bank.m0.to(dt)))
    return state, meta
