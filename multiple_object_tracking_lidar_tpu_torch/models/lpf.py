"""First-order low-pass position filter (ref: LPF_pos,
src/multiple_object_tracking_lidar.cpp:824-833; call site :638):

    pos = tau/(tau+dt) * w[L-2] + dt/(tau+dt) * w[L-1]

PyTorch port of ``multiple_object_tracking_lidar_tpu/models/lpf.py``, one
vectorized expression over the whole track bank.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype


def lpf_coefficients(lpf_tau: float, dt_gp: float,
                     dtype: torch.dtype = torch.float32) -> tuple[float, float]:
    """(tau / (tau + dt), dt / (tau + dt)) as values of ``dtype`` (f32 or
    f64), as JAX applies Python floats to arrays of that dtype."""
    return (in_dtype(lpf_tau / (lpf_tau + dt_gp), dtype),
            in_dtype(dt_gp / (lpf_tau + dt_gp), dtype))


def lpf_pos(windows: torch.Tensor, lpf_tau: float, dt_gp: float) -> torch.Tensor:
    """windows (K, L, C), x,y leading -> (K, 2) filtered x,y positions."""
    a, b = lpf_coefficients(lpf_tau, dt_gp, windows.dtype)
    return a * windows[:, -2, :2] + b * windows[:, -1, :2]
