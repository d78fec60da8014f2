"""First-order low-pass position filter (ref: LPF_pos,
src/multiple_object_tracking_lidar.cpp:824-833; call site :638):

    pos = tau/(tau+dt) * w[L-2] + dt/(tau+dt) * w[L-1]

PyTorch port of ``multiple_object_tracking_lidar_tpu/models/lpf.py``, one
vectorized expression over the whole track bank.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.voxel import f32


def lpf_coefficients(lpf_tau: float, dt_gp: float) -> tuple[float, float]:
    """(tau / (tau + dt), dt / (tau + dt)) as f32 values, as JAX applies
    Python floats to f32 arrays."""
    return f32(lpf_tau / (lpf_tau + dt_gp)), f32(dt_gp / (lpf_tau + dt_gp))


def lpf_pos(windows: torch.Tensor, lpf_tau: float, dt_gp: float) -> torch.Tensor:
    """windows (K, L, C), x,y leading -> (K, 2) filtered x,y positions."""
    a, b = lpf_coefficients(lpf_tau, dt_gp)
    return a * windows[:, -2, :2] + b * windows[:, -1, :2]
