"""Matérn ν=3/2 state-space (SDE) model.

Kernel-to-SDE conversion exactly as the reference computes it
(ref: src/ihgp/Matern32model.cpp:15-46):

    λ = √3 / ℓ
    F    = [[0, 1], [−λ², −2λ]]
    Pinf = diag(σ_m², σ_m² λ²)
    H    = [1, 0]
    R    = σ_n²

plus analytic derivatives w.r.t. (σ_n², σ_m², ℓ) in that parameter order
(cpp:25-45).  Pure functions over plain floats/NumPy — these run once at
config time on host in float64; the per-frame device code only consumes the
resulting stationary gains (see models/ihgp.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Matern32SSM:
    F: np.ndarray          # (2, 2)
    Pinf: np.ndarray       # (2, 2)
    H: np.ndarray          # (1, 2)
    R: float
    dF: np.ndarray         # (3, 2, 2), params ordered (sigma2, magnSigma2, lengthScale)
    dPinf: np.ndarray      # (3, 2, 2)
    dR: np.ndarray         # (3,)
    sigma2: float
    magn_sigma2: float
    length_scale: float


def matern32_ssm(sigma2: float, magn_sigma2: float, length_scale: float) -> Matern32SSM:
    lam = np.sqrt(3.0) / length_scale

    F = np.array([[0.0, 1.0], [-lam * lam, -2.0 * lam]])
    Pinf = np.diag([magn_sigma2, magn_sigma2 * lam * lam])
    H = np.array([[1.0, 0.0]])
    R = float(sigma2)

    ls = length_scale
    dF = np.zeros((3, 2, 2))
    dF[2] = np.array([[0.0, 0.0], [6.0 / ls**3, 2.0 * lam / ls]])

    dPinf = np.zeros((3, 2, 2))
    dPinf[1] = np.array([[1.0, 0.0], [0.0, 3.0 / ls**2]])
    dPinf[2] = np.array([[0.0, 0.0], [0.0, -6.0 * magn_sigma2 / ls**3]])

    dR = np.array([1.0, 0.0, 0.0])

    return Matern32SSM(
        F=F, Pinf=Pinf, H=H, R=R, dF=dF, dPinf=dPinf, dR=dR,
        sigma2=float(sigma2), magn_sigma2=float(magn_sigma2), length_scale=float(length_scale),
    )


def matern32_from_log(log_sigma2: float, log_magn_sigma2: float, log_length_scale: float) -> Matern32SSM:
    """Hyperparameters arrive in log scale (ref: cpp:522-530)."""
    return matern32_ssm(
        np.exp(log_sigma2), np.exp(log_magn_sigma2), np.exp(log_length_scale)
    )
