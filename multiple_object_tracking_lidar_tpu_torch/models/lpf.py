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
    """(tau / (tau + dt), dt / (tau + dt)) as values of ``dtype`` (f32,
    f64, bf16 or f16), as JAX applies Python floats to arrays of that
    dtype."""
    return (in_dtype(lpf_tau / (lpf_tau + dt_gp), dtype),
            in_dtype(dt_gp / (lpf_tau + dt_gp), dtype))


def lpf_pos(windows: torch.Tensor, lpf_tau: float, dt_gp: float) -> torch.Tensor:
    """windows (K, L, C), x,y leading -> (K, 2) filtered x,y positions.
    In f16 XLA's CPU code contracts the first product onto the second
    (one f32 FMA, rounded once: ops/half.py::madd); f32, f64 and bf16
    round each op."""
    a, b = lpf_coefficients(lpf_tau, dt_gp, windows.dtype)
    if windows.dtype == torch.float16:
        from multiple_object_tracking_lidar_tpu_torch.ops.half import madd

        return madd(windows[:, -2, :2], a, b * windows[:, -1, :2])
    return a * windows[:, -2, :2] + b * windows[:, -1, :2]
