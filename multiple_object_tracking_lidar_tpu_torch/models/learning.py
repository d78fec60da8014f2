"""IHGP hyperparameter learning: one SGD step on (logMagnSigma2,
logLengthScale) over a batch of velocity windows.

Port of ``multiple_object_tracking_lidar_tpu/models/learning.py`` (the
reference's dead ``IHGP_nonfixed`` loop, src/multiple_object_tracking_lidar.cpp:
922-1011, made to work).  The JAX package computes the step as one jitted
jnp program (learning.py:121-147): the stationary gains and their
derivatives on the device -- ``expm(F dt)``, a 100-trip DARE, three Van
Loan 4 x 4 ``expm``s and three 100-trip Lyapunov recursions -- then the
NLL-gradient recursion over every window (``models/ihgp.py::ihgp_nll_grad``),
a masked mean and the update.  It has no TPU kernel.

On the card the step is K13 (``ops/learning_cuda.py``, ``csrc/learning.cu``),
one launch per call for A stacked problems: ``learning_step`` and
``learning_step_stacked`` launch it for CUDA tensors and run
``learning_step_plain`` for CPU tensors.  The plain version spells K13's
order of operations: every matrix product's sum over k in ascending k
(``_mm``), the LU solve's pivots and eliminations as K13 takes them, the
window recursion of ``ihgp_nll_grad`` and the masked sums in K13's fixed
order (``masked_sums``).  No path on the card runs it.

The step is f32 whatever the tracker's dtype, as the JAX package runs it
(its node casts the windows to f32 and keeps the log-parameters in f32,
runtime/node.py:74-83, :302-305; the CLI's tune, cli.py:197-199).  The
windows themselves are the compute dtype's: ``velocity_windows`` forms
them on the host as the JAX package's numpy does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.models.f32_math import exp_f32, log_f32
from multiple_object_tracking_lidar_tpu_torch.models.ihgp import ihgp_nll_grad
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma32

DARE_ITERS = 100  # fixed trip count on device (ref caps at 100, cpp:10)

# jax/_src/scipy/linalg.py::_calc_P_Q, float32 branch
EXPM_MAXNORM = 3.925724783138660
EXPM_CONDS = (4.258730016922831e-001, 1.880152677804762e+000)
EXPM_MAX_SQUARINGS = 16
PADE = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
}
SUM_CHUNK = 32    # the masked sums' fixed order (masked_sums; csrc/learning.cu::kChunk)


def _c(x, like: torch.Tensor) -> torch.Tensor:
    """A constant as a 0-d f32 tensor on ``like``'s device.  Division takes
    it as a tensor: on the card ``x / python_float`` multiplies by the
    reciprocal."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes (leading axes broadcast) as XLA's CPU
    dot computes it, and K13's ``mm``: each entry's first product rounded,
    then each next product fused onto the sum (``fma32``) in ascending k."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = fma32(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=like.device).expand(*like.shape[:-2], n, n)


def _h(like: torch.Tensor) -> torch.Tensor:
    """The measurement row H = [[1, 0]], shaped to broadcast with ``like``."""
    return torch.tensor([[1.0, 0.0]], dtype=torch.float32, device=like.device)


def matern32_torch(log_params: torch.Tensor) -> dict:
    """log_params (..., 3) = (logSigma2, logMagnSigma2, logLengthScale) ->
    the Matern-3/2 state-space tensors with those leading axes (JAX
    learning.py:31-45; ref Matern32model.cpp:15-46).  ``ls**3`` is
    ``ls * (ls * ls)``, as jax.lax.integer_pow multiplies."""
    p = exp_f32(log_params)
    sigma2, magn, ls = p[..., 0], p[..., 1], p[..., 2]
    lam = torch.sqrt(_c(3.0, p)) / ls
    ls2 = ls * ls
    ls3 = ls * ls2
    z = torch.zeros_like(ls)
    one = torch.ones_like(ls)
    F = torch.stack([torch.stack([z, one], -1),
                     torch.stack([-lam * lam, -2.0 * lam], -1)], -2)
    Pinf = torch.stack([torch.stack([magn, z], -1),
                        torch.stack([z, magn * lam * lam], -1)], -2)
    zm = torch.zeros_like(F)
    dF = torch.stack([zm, zm, torch.stack([torch.stack([z, z], -1),
                                           torch.stack([_c(6.0, p) / ls3, 2.0 * lam / ls],
                                                       -1)], -2)], -3)
    dPinf = torch.stack([
        zm,
        torch.stack([torch.stack([one, z], -1), torch.stack([z, _c(3.0, p) / ls2], -1)], -2),
        torch.stack([torch.stack([z, z], -1), torch.stack([z, -6.0 * magn / ls3], -1)], -2),
    ], -3)
    dR = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=p.device).expand(
        *p.shape[:-1], 3)
    return {"F": F, "Pinf": Pinf, "R": sigma2, "dF": dF, "dPinf": dPinf, "dR": dR}


def _poly(coefs, mats) -> torch.Tensor:
    """sum_i coefs[i] * mats[i] as XLA's CPU code contracts it: the first
    product fused onto the second (rounded), or, where the first
    coefficient is 1 (the multiply simplified away), the second product
    fused onto the first matrix; each later product fused onto the sum."""
    if coefs[0] == 1.0:
        acc = fma32(_c(coefs[1], mats[1]), mats[1], mats[0])
    else:
        acc = fma32(_c(coefs[0], mats[0]), mats[0], coefs[1] * mats[1])
    for c, m in zip(coefs[2:], mats[2:]):
        acc = fma32(_c(c, m), m, acc)
    return acc


def _pade(A: torch.Tensor, order: int):
    """(U, V) of the Pade approximant of ``order`` (jax _pade3/_pade5/_pade7)."""
    b = PADE[order]
    ident = _eye(A.shape[-1], A)
    A2 = _mm(A, A)
    if order == 3:
        return _mm(A, _poly((b[3], b[1]), (A2, ident))), _poly((b[2], b[0]), (A2, ident))
    A4 = _mm(A2, A2)
    if order == 5:
        return (_mm(A, _poly((b[5], b[3], b[1]), (A4, A2, ident))),
                _poly((b[4], b[2], b[0]), (A4, A2, ident)))
    A6 = _mm(A4, A2)
    return (_mm(A, _poly((b[7], b[5], b[3], b[1]), (A6, A4, A2, ident))),
            _poly((b[6], b[4], b[2], b[0]), (A6, A4, A2, ident)))


def _fdot(x, y, reverse: bool = False) -> torch.Tensor:
    """sum_k x[k] * y[k] over lists of tensors: the first product rounded,
    each next one fused onto the sum (``reverse``: from the last term)."""
    if reverse:
        x, y = x[::-1], y[::-1]
    acc = x[0] * y[0]
    for a, b in zip(x[1:], y[1:]):
        acc = fma32(a, b, acc)
    return acc


def lu_solve(Q: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Q^-1 P for (..., n, n) f32 Q as ``jnp.linalg.solve`` takes it on the
    CPU (LAPACK getrf then two trsm, of the OpenBLAS that jaxlib calls):
    the left-looking getf2, column j's U entries a_ij - dot(L[i, :i],
    u[:i, j]) (the dot from its last term) and its lower entries a_ij -
    dot(L[i, :j], u[:j, j]) (from its first), the pivot the first row of
    largest |entry|, the multipliers scaled by the pivot's reciprocal; then
    the forward substitution b_i = fma(-l_ik, y_k, b_i) in ascending k and
    the back substitution x_k = b_k * (1 / u_kk), b_i = fma(-x_k, u_ik, b_i)
    from the last column.  K13's ``lu_solve`` takes the same steps.  No
    host sync: the pivot rows are gathered by index."""
    n = Q.shape[-1]
    cols = [[Q[..., i, j] for i in range(n)] for j in range(n)]   # cols[j][i]
    rhs = [P[..., i, :] for i in range(n)]
    L = [[None] * n for _ in range(n)]                             # L[i][k], k < i
    Ucol = [[None] * n for _ in range(n)]                          # Ucol[j][i], i <= j
    for j in range(n):
        c = cols[j]
        u = [c[0]] + [None] * (n - 1)
        for i in range(1, j):
            u[i] = c[i] - _fdot([L[i][k] for k in range(i)], u[:i], reverse=True)
        low = [c[i] if j == 0 else c[i] - _fdot([L[i][k] for k in range(j)], u[:j])
               for i in range(j, n)]
        # the pivot among rows j..n-1, then the swap of rows j and p in
        # every column (L's, the rest of Q's) and in the right-hand side
        p = torch.full(low[0].shape, j, dtype=torch.int64, device=Q.device)
        best = low[0].abs()
        for i in range(j + 1, n):
            a = low[i - j].abs()
            gt = a > best
            p = torch.where(gt, i, p)
            best = torch.where(gt, a, best)

        def swap(vals, start):
            """vals[i - start] for rows i = start.. with rows j and p swapped."""
            out = list(vals)
            for i in range(j + 1, n):
                hit = p == i
                hj = hit[..., None] if vals[0].dim() > hit.dim() else hit
                out[i - start] = torch.where(hj, vals[j - start], vals[i - start])
                out[j - start] = torch.where(hj, vals[i - start], out[j - start])
            return out

        low = swap(low, j)
        for k in range(j):
            col = swap([L[i][k] for i in range(j, n)], j)
            for i in range(j, n):
                L[i][k] = col[i - j]
        for jj in range(j + 1, n):
            cols[jj] = cols[jj][:j] + swap(cols[jj][j:], j)
        rhs = rhs[:j] + swap(rhs[j:], j)
        u[j] = low[0]
        inv = 1.0 / u[j]
        for i in range(j + 1, n):
            L[i][j] = low[i - j] * inv
        Ucol[j] = u
    # forward substitution (unit lower), then back substitution
    b = list(rhs)
    for k in range(n):
        for i in range(k + 1, n):
            b[i] = fma32(-L[i][k][..., None], b[k], b[i])
    x = [None] * n
    for k in range(n - 1, -1, -1):
        x[k] = b[k] * (1.0 / Ucol[k][k])[..., None]
        for i in range(k):
            b[i] = fma32(-x[k], Ucol[k][i][..., None], b[i])
    return torch.stack(x, -2)


def expm_f32(A: torch.Tensor) -> torch.Tensor:
    """expm of (..., n, n) f32 matrices by JAX's own f32 algorithm
    (jax/_src/scipy/linalg.py::expm and _calc_P_Q; torch.linalg.matrix_exp
    is another algorithm): the 1-norm (largest column sum), n_squarings =
    max(0, floor(log2(norm / 3.925724783138660))) with log2 as log(x) /
    log(2), NaN past 16 squarings, the Pade order 3, 5 or 7 by digitize of
    the norm against 0.4258730016922831 and 1.880152677804762, P = U + V, Q
    = V - U, Q \\ P by LU with partial pivoting, then n_squarings
    squarings.  The Pade order and the squarings are chosen per matrix
    with ``torch.where`` (all three orders are computed)."""
    s = A[..., 0, :].abs()
    for i in range(1, A.shape[-1]):
        s = s + A[..., i, :].abs()
    norm = s.amax(-1)
    lg = log_f32(norm / _c(EXPM_MAXNORM, A)) / log_f32(_c(2.0, A))
    nsq = torch.clamp_min(torch.floor(lg), 0.0)
    # 2 ** nsq exactly, as its f32 bits (nsq in [0, 16] where it is used)
    n_int = torch.nan_to_num(nsq, nan=0.0).clamp(0, EXPM_MAX_SQUARINGS).to(torch.int32)
    scale = ((n_int + 127) << 23).view(torch.float32)
    As = A / scale[..., None, None]
    idx = (norm >= _c(EXPM_CONDS[0], A)).to(torch.int32) + (norm >= _c(EXPM_CONDS[1], A)).to(
        torch.int32)
    (u3, v3), (u5, v5), (u7, v7) = (_pade(As, o) for o in (3, 5, 7))
    i3 = (idx == 0)[..., None, None]
    i5 = (idx == 1)[..., None, None]
    U = torch.where(i3, u3, torch.where(i5, u5, u7))
    V = torch.where(i3, v3, torch.where(i5, v5, v7))
    R = lu_solve(V - U, U + V)
    for i in range(EXPM_MAX_SQUARINGS):
        R = torch.where((i < nsq)[..., None, None], _mm(R, R), R)
    bad = ~(nsq <= EXPM_MAX_SQUARINGS)
    return torch.where(bad[..., None, None], torch.full_like(R, math.nan), R)


def _outer_fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, sign: float = 1.0):
    """c + sign * a b^T for column a (..., n, 1) and row b (..., 1, m): an
    outer product (a dot over a contracting axis of 1) is a multiply to
    XLA, and its CPU code fuses the multiply into the add."""
    return fma32(-a if sign < 0 else a, b, c)


def _dare_meas(A, H, Q, R):
    """Kalman DARE with scalar R > 0, a fixed 100-trip loop (JAX
    learning.py:48-57; ref InfiniteHorizonGP.cpp:213-252):
    X <- AKB X AKB^T + (K R) K^T + Q, the outer product fused."""
    X = _eye(2, A)
    Ht = _t(H)
    Rm = R[..., None, None]
    for _ in range(DARE_ITERS):
        s = _mm(_mm(H, X), Ht) + Rm
        K = _mm(A, _mm(X, Ht) / s)
        AKB = _outer_fma(K, H, A, -1.0)
        X = _outer_fma(K * Rm, _t(K), _mm(_mm(AKB, X), _t(AKB))) + Q
    return X


def _dare_lyap(A, C):
    """The derivative DARE as a discrete Lyapunov recursion (B = 0, R = 0;
    JAX learning.py:60-67)."""
    X = _eye(2, A)
    for _ in range(DARE_ITERS):
        X = _mm(_mm(A, X), _t(A)) + C
    return X


def stationary_gains_torch(log_params: torch.Tensor, dt: float) -> dict:
    """The stationary gains and their derivatives for (..., 3) f32
    log-parameters (JAX learning.py:70-118, ``stationary_gains_jax``): A, K,
    HA, AKHA, G and S with the leading axes, and dS (..., 3), dK (..., 3,
    2), dAKHA (..., 3, 2, 2), HdA (..., 3, 2) over the hyperparameters
    (sigma2, magnSigma2, lengthScale).  Dots as ``_mm``, outer products
    fused into the sums they feed (``_outer_fma``), ``a - b * c`` fused and
    ``x / S / S`` as ``x / (S * S)``, as XLA's CPU code computes them.  K13 computes the same values but G
    (the smoother gain, which the learning step does not read)."""
    ssm = matern32_torch(log_params)
    F, Pinf, R = ssm["F"], ssm["Pinf"], ssm["R"]
    H = _h(F)
    Ht = _t(H)
    dtc = _c(dt, F)
    A = expm_f32(F * dtc)
    Q = Pinf - _mm(_mm(A, Pinf), _t(A))
    PP = _dare_meas(A, H, Q, R)
    S = _mm(_mm(H, PP), Ht) + R[..., None, None]          # (..., 1, 1)
    PPH = _mm(PP, Ht)                                     # (..., 2, 1)
    K = PPH / S
    PF = _outer_fma(K, _mm(H, PP), PP, -1.0)
    HA = _mm(H, A)                                        # (..., 1, 2)
    AKHA = _outer_fma(K, HA, A, -1.0)
    PPs = _mm(_mm(A, PF), _t(A)) + Q
    G = _t(lu_solve(PPs, _mm(A, PF)))
    AK = _mm(A, K)                                        # (..., 2, 1)

    # the three hyperparameters on an axis of their own (-3)
    e = lambda x: x.unsqueeze(-3)  # noqa: E731
    dF, dPinf, dR = ssm["dF"], ssm["dPinf"], ssm["dR"][..., None, None]
    FF = torch.cat([torch.cat([e(F).expand(dF.shape), torch.zeros_like(dF)], -1),
                    torch.cat([dF, e(F).expand(dF.shape)], -1)], -2)
    AA = expm_f32(FF * dtc)
    dA = AA[..., 2:, :2]
    eA, ePinf, ePP, eAK, eS = e(A), e(Pinf), e(PP), e(AK), e(S)
    dQ = (dPinf - _mm(_mm(dA, ePinf), _t(eA)) - _mm(_mm(eA, dPinf), _t(eA))
          - _mm(_mm(eA, ePinf), _t(dA)))
    dQ = 0.5 * (dQ + _t(dQ))
    C = _mm(_mm(dA, ePP), _t(eA)) + _mm(_mm(eA, ePP), _t(dA))
    C = _outer_fma(_mm(_mm(dA, ePP), Ht), _t(eAK), C, -1.0)
    C = C - _mm(_mm(_mm(eAK, H), ePP), _t(dA))
    C = _outer_fma(eAK * dR, _t(eAK), C) + dQ
    C = 0.5 * (C + _t(C))
    dPP = _dare_lyap(_outer_fma(eAK, H, eA, -1.0), C)
    dS = _mm(_mm(H, dPP), Ht) + dR                        # (..., 3, 1, 1)
    # (dS / S) / S is dS / (S * S) to XLA's algebraic simplifier
    dK = fma32(-e(PPH), dS / (eS * eS), _mm(dPP, Ht) / eS)  # (..., 3, 2, 1)
    HdA = _mm(H, dA)                                      # (..., 3, 1, 2)
    dAKHA = _outer_fma(e(K), HdA, _outer_fma(dK, e(HA), dA, -1.0), -1.0)
    return {
        "A": A, "K": K[..., 0], "HA": HA[..., 0, :], "AKHA": AKHA, "G": G,
        "S": S[..., 0, 0], "dS": dS[..., 0, 0], "dK": dK[..., 0], "dAKHA": dAKHA,
        "HdA": HdA[..., 0, :],
    }


def masked_sums(vals: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over windows of vals (A, B, V) * w (A, B) in K13's fixed order:
    each chunk of ``SUM_CHUNK`` consecutive windows summed in turn from +0,
    then the chunk sums in turn from +0.  Up to ``SUM_CHUNK`` windows that
    is the sequential order in which XLA's CPU code reduces (the JAX
    step's sums bit for bit); past it XLA vectorizes its reduction, and the
    sums differ from its in the last bits.  Returns (A, V)."""
    a, b, v = vals.shape
    n_chunks = -(-b // SUM_CHUNK)
    x = torch.zeros((a, n_chunks * SUM_CHUNK, v), dtype=vals.dtype, device=vals.device)
    x[:, :b] = vals * w[..., None]
    x = x.reshape(a, n_chunks, SUM_CHUNK, v)
    chunk = torch.zeros((a, n_chunks, v), dtype=vals.dtype, device=vals.device)
    for i in range(SUM_CHUNK):
        chunk = chunk + x[:, :, i]
    total = torch.zeros((a, v), dtype=vals.dtype, device=vals.device)
    for c in range(n_chunks):
        total = total + chunk[:, c]
    return total


def learning_step_plain(
    log_params: torch.Tensor,   # (A, 3) f32
    y: torch.Tensor,            # (A, B, T) f32 mean-centred windows
    mask: torch.Tensor,         # (A, B) which windows count
    dt: float,
    lr_magn: float = 0.1,
    lr_ls: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K13's plain version on A stacked problems: (new log-parameters (A,
    3), mean NLL (A,)), the NLL at the input parameters.  The JAX step
    (learning.py:121-147): the gains, ``ihgp_nll_grad`` from m0 = 0 over
    every window, the masked sums over max(sum w, 1), the chain rule
    theta * grad, SGD on entries 1 and 2 only (sigma2 frozen, cpp:951),
    the clamp to [-10, 10] (cpp:961-966) and every non-finite entry reset
    to 0 (exp(0) = 1, cpp:978-989)."""
    g = stationary_gains_torch(log_params, dt)
    gains = {k: g[k][:, None] for k in ("AKHA", "K", "HA", "S", "dS", "dK", "dAKHA", "HdA")}
    m0 = torch.zeros((*y.shape[:-1], 2), dtype=y.dtype, device=y.device)
    nlls, grads = ihgp_nll_grad(y, m0, gains)              # (A, B), (A, B, 3)
    w = mask.to(y.dtype)
    sums = masked_sums(torch.cat([nlls[..., None], grads], -1), w)
    denom = torch.clamp_min(w.sum(-1), 1.0)
    nll = sums[:, 0] / denom
    grad = sums[:, 1:] / denom[:, None]
    glog = exp_f32(log_params) * grad
    # lp + (-lr) * glog: XLA's CPU code fuses the multiply into the add
    new = torch.stack([log_params[:, 0],
                       fma32(_c(-lr_magn, glog), glog[:, 1], log_params[:, 1]),
                       fma32(_c(-lr_ls, glog), glog[:, 2], log_params[:, 2])], -1)
    new = torch.clamp(new, -10.0, 10.0)
    new = torch.where(torch.isfinite(new), new, torch.zeros_like(new))
    return new, nll


def velocity_windows(window: torch.Tensor, dt: float) -> np.ndarray:
    """The mean-centred finite-difference velocity windows the JAX node
    (runtime/node.py:301-306) and the JAX ``tune`` (cli.py:186-196) hand to
    ``learning_step``: ``window`` (B, L) is one axis of the bank's window
    rows in the compute dtype, the result the f32 (B, L - 1) ``y``.

    The JAX package computes ``v = (w[:, 1:] - w[:, :-1]) / dt`` and ``v -
    v.mean(axis=1)`` in numpy on the host; this spells each of numpy's
    roundings in that dtype explicitly, so the card's numpy (which has no
    bf16) and its promotion rules play no part.  Only the f32 mean is
    numpy's own: its pairwise order is the JAX package's, and a row's mean
    along axis 1 is the 1-D mean ``tune`` takes of it.

    - f32 / f64: numpy in the window's dtype, then f32;
    - bf16: the difference rounded to bf16; the quotient ``f32(d) /
      f32(dt)`` (numpy promotes a bf16 array divided by a Python float to
      f32); the f32 mean and centring;
    - f16: the difference rounded to f16; the quotient ``f16(f32(d) /
      f32(f16(dt)))`` (numpy keeps f16 and divides through f32); the mean
      the f32 mean of the widened quotients rounded to f16 (numpy's
      ``_mean`` rule for f16); the centring rounded to f16, then widened.

    A half sum, difference or quotient computed in f32 and rounded once is
    the correctly rounded half result (24 >= 2 p + 2 bits for bf16's p = 8
    and f16's p = 11), as numpy and ml_dtypes compute them."""
    w = window.detach().cpu()
    if w.dtype == torch.bfloat16:
        d = (w[:, 1:].float() - w[:, :-1].float()).bfloat16()
        v = d.float().numpy() / np.float32(dt)
        return v - v.mean(axis=1, keepdims=True)
    if w.dtype == torch.float16:
        d = (w[:, 1:].float() - w[:, :-1].float()).half()
        q = torch.from_numpy(d.float().numpy() / np.float32(np.float16(dt))).half().float()
        m = torch.from_numpy(q.numpy().mean(axis=1, keepdims=True)).half().float()
        return (q - m).half().float().numpy()
    w = w.numpy()
    v = (w[:, 1:] - w[:, :-1]) / dt
    return (v - v.mean(axis=1, keepdims=True)).astype(np.float32)


def learning_step_stacked(log_params, y, mask, dt: float, lr_magn: float = 0.1,
                          lr_ls: float = 0.01):
    """One SGD step on A stacked problems (log_params (A, 3), y (A, B, T),
    mask (A, B)) -> ((A, 3), (A,)): K13, one launch, for CUDA tensors;
    ``learning_step_plain`` for CPU tensors.  The node learns x and y in
    one launch through it."""
    if log_params.device.type == "cpu":
        return learning_step_plain(log_params, y, mask, dt, lr_magn, lr_ls)
    from multiple_object_tracking_lidar_tpu_torch.ops.learning_cuda import learning_step_cuda

    return learning_step_cuda(log_params, y, mask, dt, lr_magn, lr_ls)


def learning_step(log_params, y, mask, dt: float, lr_magn: float = 0.1, lr_ls: float = 0.01):
    """The JAX signature (learning.py:121-147): log_params (3,)
    [logSigma2, logMagnSigma2, logLengthScale], y (B, T) mean-centred
    windows of one axis, mask (B,) -> (new log_params (3,), mean NLL ()).
    K13 on CUDA tensors, the plain version on CPU tensors."""
    new, nll = learning_step_stacked(log_params[None], y[None], mask[None], dt, lr_magn, lr_ls)
    return new[0], nll[0]

