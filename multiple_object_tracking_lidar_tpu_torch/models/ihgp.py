"""Infinite-Horizon Gaussian Process smoother (Solin et al., NeurIPS 2018):
the host-f64 gain builders and the per-frame closed-form apply.

The builders (``dare_fixed_point``, ``IHGPGains``, ``stationary_gains``,
``smoother_weights``, ``smoother_weights_xy``) are copies of
``multiple_object_tracking_lidar_tpu/models/ihgp.py`` (numpy + scipy, run
once on the host in f64; the JAX package cannot be imported without JAX).
The per-frame apply of the weights is the track step's
(``ops/track_cuda.py``: ``smoother_parts``, ``position_parts``,
``smoother_pass`` and K4).

The scan forms (``ihgp_filter_smoother``, ``ihgp_batch``; JAX ihgp.py:181-230)
are plain torch on no path, public API as in the JAX package.  The
learning-mode recursion ``ihgp_nll_grad`` (JAX ihgp.py:312-342) is the
window stage of the learning step (``models/learning.py``): its plain
version, and K13's order of operations on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.linalg import expm as _expm

from multiple_object_tracking_lidar_tpu_torch.models.f32_math import log_f32
from multiple_object_tracking_lidar_tpu_torch.models.matern32 import Matern32SSM
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma32

# The reference's truncated pi constant (cpp:135) — kept for bit-parity of NLL.
REF_PI = 3.141592654

DARE_EPS = 1e-10   # cpp:9
DARE_MAXIT = 100   # cpp:10


def dare_fixed_point(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: float) -> np.ndarray:
    """Fixed-point DARE solver, same iteration as the reference (cpp:213-252).

    NB like the reference: only valid for scalar R (and possibly zero B).
    Host-side float64.
    """
    dim = A.shape[0]
    X = np.eye(dim)
    for _ in range(DARE_MAXIT):
        X_prev = X
        if abs(R) < 1e-15:
            K = np.zeros((dim, B.shape[0]))
        else:
            K = A @ (X @ B.T / ((B @ X @ B.T)[0, 0] + R))
        X = (A - K @ B) @ X @ (A - K @ B).T + K * R @ K.T + Q
        if np.linalg.norm(X - X_prev, "fro") < DARE_EPS:
            break
    return X


@dataclasses.dataclass(frozen=True)
class IHGPGains:
    """Stationary quantities; all host-side float64 NumPy.

    Derivative arrays (for the learning mode) are stacked over the parameter
    axis (sigma2, magnSigma2, lengthScale), matching the reference's dF order.
    """

    A: np.ndarray        # (2,2) discrete transition, expm(F dt)    (cpp:15)
    Q: np.ndarray        # (2,2) process noise                      (cpp:16)
    S: float             # innovation variance                      (cpp:27)
    K: np.ndarray        # (2,) stationary Kalman gain              (cpp:30)
    PF: np.ndarray       # (2,2) stationary filtered covariance     (cpp:33)
    HA: np.ndarray       # (2,) (H A)^T                             (cpp:36)
    AKHA: np.ndarray     # (2,2) A - K H A                          (cpp:37)
    G: np.ndarray        # (2,2) stationary RTS smoother gain       (cpp:168-170)
    # learning-mode derivatives (cpp:63-92)
    dS: np.ndarray       # (3,)
    dK: np.ndarray       # (3,2)
    dAKHA: np.ndarray    # (3,2,2)
    HdA: np.ndarray      # (3,2)

    def as_arrays(self, dtype=np.float32) -> dict:
        """The per-frame constants (no derivative tensors) as host numpy in
        ``dtype`` -- the values the JAX package's ``as_jax`` gives."""
        return {
            "A": np.asarray(self.A, dtype),
            "K": np.asarray(self.K, dtype),
            "HA": np.asarray(self.HA, dtype),
            "AKHA": np.asarray(self.AKHA, dtype),
            "G": np.asarray(self.G, dtype),
            "S": np.asarray(self.S, dtype),
        }

    def as_arrays_learning(self, dtype=np.float32) -> dict:
        """``as_arrays`` plus the derivative tensors dS, dK, dAKHA and HdA
        (the JAX package's ``as_jax_learning``, ihgp.py:106-114)."""
        d = self.as_arrays(dtype)
        d.update(
            dS=np.asarray(self.dS, dtype),
            dK=np.asarray(self.dK, dtype),
            dAKHA=np.asarray(self.dAKHA, dtype),
            HdA=np.asarray(self.HdA, dtype),
        )
        return d


def stationary_gains(ssm: Matern32SSM, dt: float) -> IHGPGains:
    """All stationary filter/smoother quantities for one axis.

    Mirrors the reference constructor (cpp:12-97) + the smoother-gain solve
    from getEft (cpp:166-170), in float64 on host.
    """
    F, Pinf, H, R = ssm.F, ssm.Pinf, ssm.H, ssm.R
    dim = F.shape[0]

    A = _expm(F * dt)                       # cpp:15
    Q = Pinf - A @ Pinf @ A.T               # cpp:16

    PP = dare_fixed_point(A, H, Q, R)       # cpp:23
    S = float((H @ PP @ H.T)[0, 0] + R)     # cpp:27
    K = (PP @ H.T / S)[:, 0]                # cpp:30
    PF = PP - np.outer(K, H @ PP)           # cpp:33
    HA = (H @ A)[0, :]                      # cpp:36
    AKHA = A - np.outer(K, H @ A)           # cpp:37

    # Smoother gain G = solve(A PF A^T + Q, A PF)^T  (cpp:166-170)
    PPs = A @ PF @ A.T + Q
    G = np.linalg.solve(PPs, A @ PF).T

    # Derivatives via Van Loan block expm + DARE (cpp:49-92)
    nparam = ssm.dF.shape[0]
    AK = A @ K[:, None]                     # (2,1)
    dS = np.zeros(nparam)
    dK = np.zeros((nparam, dim))
    dAKHA = np.zeros((nparam, dim, dim))
    HdA = np.zeros((nparam, dim))
    for j in range(nparam):
        FF = np.zeros((2 * dim, 2 * dim))
        FF[:dim, :dim] = F
        FF[dim:, dim:] = F
        FF[dim:, :dim] = ssm.dF[j]
        AA = _expm(FF * dt)
        dA = AA[dim:, :dim]
        dQ = ssm.dPinf[j] - dA @ Pinf @ A.T - A @ ssm.dPinf[j] @ A.T - A @ Pinf @ dA.T
        dQ = 0.5 * (dQ + dQ.T)
        C = (
            dA @ PP @ A.T
            + A @ PP @ dA.T
            - dA @ PP @ H.T @ AK.T
            - AK @ H @ PP @ dA.T
            + AK * ssm.dR[j] @ AK.T
            + dQ
        )
        C = 0.5 * (C + C.T)
        dPP = dare_fixed_point(A - AK @ H, np.zeros((dim, dim)), C, 0.0)
        dS[j] = (H @ dPP @ H.T)[0, 0] + ssm.dR[j]
        dK[j] = (dPP @ H.T / S - PP @ H.T * (((H @ dPP @ H.T)[0, 0] + ssm.dR[j]) / S / S))[:, 0]
        dAKHA[j] = dA - np.outer(dK[j], H @ A) - np.outer(K, H @ dA)
        HdA[j] = (H @ dA)[0, :]

    return IHGPGains(
        A=A, Q=Q, S=S, K=K, PF=PF, HA=HA, AKHA=AKHA, G=G,
        dS=dS, dK=dK, dAKHA=dAKHA, HdA=HdA,
    )


def smoother_weights(gains: IHGPGains, length: int) -> dict:
    """Collapse the stationary forward filter + backward RTS smoother over a
    fixed-length window into precomputed linear maps (host, float64).

    The per-frame computation the reference performs with per-sample loops
    (update() x L then getEft(), cpp:132-196) is linear in (y, m0) with
    CONSTANT matrices — a stationary Kalman smoother is an LTI system.  So:

        eft      = Wy  @ y + Wm  @ m0        (smoothed mean per position)
        m_carry  = My  @ y + Mm  @ m0        (smoothed head state -> next m0)

    On device the velocity estimate needs only eft[-1]: one dot product per
    track per axis, a single MXU dispatch for the whole bank — replacing
    2 x L sequential 2x2 scan steps.  Exact same math, zero recurrences.

    Returns {"Wy": (L, L), "Wm": (L, 2), "My": (2, L), "Mm": (2, 2)}.
    """
    A, AKHA, K, G = gains.A, gains.AKHA, gains.K, gains.G

    # forward filter: m_t = AKHA m_{t-1} + K y_t; propagate Jacobians
    J = np.zeros((length, 2, length))   # dMF[t]/dy
    B = np.zeros((length, 2, 2))        # dMF[t]/dm0
    Jp = np.zeros((2, length))
    Bp = np.eye(2)
    for t in range(length):
        Jp = AKHA @ Jp
        Jp[:, t] += K
        Bp = AKHA @ Bp
        J[t] = Jp
        B[t] = Bp

    # backward smoother: m_s[k] = MF[k] + G (m_s[k+1] - A MF[k])
    Js = J[-1].copy()
    Bs = B[-1].copy()
    Wy = np.zeros((length, length))
    Wm = np.zeros((length, 2))
    Wy[-1] = Js[0]
    Wm[-1] = Bs[0]
    for k in range(length - 2, -1, -1):
        Js = J[k] + G @ (Js - A @ J[k])
        Bs = B[k] + G @ (Bs - A @ B[k])
        Wy[k] = Js[0]
        Wm[k] = Bs[0]

    return {"Wy": Wy, "Wm": Wm, "My": Js, "Mm": Bs}


def smoother_weights_xy(
    gains_x: IHGPGains, gains_y: IHGPGains, length: int, dtype=np.float32
) -> dict:
    """Per-axis weights stacked on a leading {x, y} axis, as host numpy."""
    wx = smoother_weights(gains_x, length)
    wy = smoother_weights(gains_y, length)
    return {
        k: np.stack([np.asarray(wx[k], dtype), np.asarray(wy[k], dtype)])
        for k in wx
    }


# ---------------------------------------------------------------------------
# Scan forms (JAX ihgp.py:181-230): plain torch, on no path
# ---------------------------------------------------------------------------

def _gain_tensors(gains: dict, keys, like: torch.Tensor) -> list:
    return [torch.as_tensor(gains[k], dtype=like.dtype, device=like.device) for k in keys]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M @ v for (..., 2, 2) M and (..., 2) v, each row's sum in ascending
    k."""
    return M[..., 0] * v[..., 0:1] + M[..., 1] * v[..., 1:2]


def ihgp_filter_smoother(y, m0, gains: dict, device: torch.device | str = "cuda"):
    """Forward filter + backward smoother over one window of one scalar
    series (JAX ihgp.py:181-212; ref cpp:132-196): y (L,) mean-centred
    observations, m0 (2,) the carried filter state, ``gains`` the
    ``as_arrays`` constants -> (eft (L,) the smoothed mean at every window
    position, m_carry (2,) the smoothed state at position 0, next frame's
    m0).  Leading axes of y and m0 broadcast against the gains'.  Runs on
    ``device`` (the card unless the caller asks for the CPU)."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import resolve_device

    dev = resolve_device(device)
    y = torch.as_tensor(y, device=dev)
    m = torch.as_tensor(m0, dtype=y.dtype, device=dev)
    AKHA, K, A, G = _gain_tensors(gains, ("AKHA", "K", "A", "G"), y)
    mf = []
    for k in range(y.shape[-1]):
        m = _mv(AKHA, m) + K * y[..., k:k + 1]            # cpp:157
        mf.append(m)
    m_last = mf[-1]
    m = m_last
    eft = [m_last[..., 0]]
    for k in range(y.shape[-1] - 2, -1, -1):
        m = mf[k] + _mv(G, m - _mv(A, mf[k]))             # cpp:187
        eft.append(m[..., 0])
    return torch.stack(eft[::-1], -1), m


def ihgp_batch(y, m0, gains_xy: dict, device: torch.device | str = "cuda"):
    """Filter + smooth the whole track bank (JAX ihgp.py:215-230): y (K, 2,
    L) mean-centred series per track per axis {x, y}, m0 (K, 2, 2) carried
    states, ``gains_xy`` leaves with a leading {x, y} axis of 2 -> (eft
    (K, 2, L), m_carry (K, 2, 2))."""
    return ihgp_filter_smoother(y, m0, gains_xy, device=device)


# ---------------------------------------------------------------------------
# Learning mode: marginal likelihood + gradient recursions (cpp:132-162)
# ---------------------------------------------------------------------------

def ihgp_nll_grad(y: torch.Tensor, m0: torch.Tensor, gains: dict):
    """Negative log marginal likelihood and its gradient w.r.t. (sigma2,
    magnSigma2, lengthScale) over one window (JAX ihgp.py:312-342; the
    reference's edata / gdata recursions, cpp:141-154, dm from zero per
    window).  y (..., L), m0 (..., 2); the gains' leaves (the
    ``as_arrays_learning`` set as tensors, or K13's stage-1 values) carry
    leading axes that broadcast against y's.  Returns (edata (...), gdata
    (..., 3)).

    Every product and sum is spelled in K13's order (``csrc/learning.cu``,
    stage 2): each 2-term dot in ascending k, ``0.5 * v * v / S`` as
    ((0.5 v) v) / S, the constants 0.5 log(2 REF_PI) and 0.5 log(S) taken
    once."""
    AKHA, K, HA, S = gains["AKHA"], gains["K"], gains["HA"], gains["S"]
    dS, dK, dAKHA, HdA = gains["dS"], gains["dK"], gains["dAKHA"], gains["HdA"]
    hl2pi = 0.5 * log_f32(torch.full((), 2 * REF_PI, dtype=y.dtype, device=y.device))
    hlS = 0.5 * log_f32(S)
    Sj = S[..., None]
    SS = Sj * Sj      # x / S / S is x / (S * S) to XLA's algebraic simplifier
    m = m0
    dm = torch.zeros((*m0.shape[:-1], dS.shape[-1], 2), dtype=y.dtype, device=y.device)
    edata = torch.zeros(m0.shape[:-1], dtype=y.dtype, device=y.device)
    gdata = torch.zeros((*m0.shape[:-1], dS.shape[-1]), dtype=y.dtype, device=y.device)
    for k in range(y.shape[-1]):
        yk = y[..., k]
        m_0, m_1 = m[..., 0], m[..., 1]
        v = yk - fma32(HA[..., 1], m_1, HA[..., 0] * m_0)                   # HA @ m
        vv = 0.5 * v * v
        edata = edata + vv / S + hl2pi + hlS
        hm = fma32(HdA[..., 1], m_1[..., None], HdA[..., 0] * m_0[..., None])   # HdA @ m
        dmh = fma32(dm[..., 1], HA[..., None, 1], dm[..., 0] * HA[..., None, 0])  # dm @ HA
        dv = -hm - dmh
        gdata = gdata + v[..., None] * dv / Sj - vv[..., None] * dS / SS + 0.5 * dS / Sj
        dam = fma32(dAKHA[..., 1], m_1[..., None, None], dAKHA[..., 0] * m_0[..., None, None])
        dma = fma32(dm[..., :, None, 1], AKHA[..., None, :, 1],
                    dm[..., :, None, 0] * AKHA[..., None, :, 0])                # dm @ AKHA^T
        dm = fma32(dK, yk[..., None, None], dam + dma)
        am = fma32(AKHA[..., 1], m_1[..., None], AKHA[..., 0] * m_0[..., None])   # AKHA @ m
        m = fma32(K, yk[..., None], am)
    return edata, gdata
