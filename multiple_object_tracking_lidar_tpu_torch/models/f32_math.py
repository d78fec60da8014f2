"""The f32 ``exp`` and ``log`` of the learning step, as XLA's CPU backend
computes ``jnp.exp`` and ``jnp.log`` (the Cephes polynomials it emits,
every multiply-add fused) and as K13 computes them (``csrc/learning.cu``:
``exp_f32``, ``log_f32``, the same steps with ``__fmaf_rn``).

XLA's CPU functions are not the correctly rounded ones: ``jnp.exp`` differs
from a correctly rounded f32 exp in about one input in ten, ``jnp.log`` in
one in twenty.  Spelled out here, the learning step's transcendentals are
the JAX package's bit for bit (on 3,000,000 logs of positive normal
inputs and 2,000,000 exps of inputs in [-104, 88.37], the XLA of jax
0.9.0; past 88.37, where exp(x) > 2**127, XLA's last bit may differ),
and K13 and its plain version agree bit for bit on the card, where
PyTorch's ``torch.exp`` / ``torch.log`` and CUDA's ``expf`` / ``logf`` need
not.  Results below the smallest normal f32 are flushed to zero, and
inputs there read as zero, as XLA's CPU code runs (flush-to-zero).

``fma32`` is the correctly rounded f32 fused multiply-add from f64 ops
(``ops/cluster_pallas.py``).
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma32

FLT_MIN = 1.17549435e-38          # the smallest normal f32

EXP_LOG2EF = 1.44269504088896341
EXP_C1 = 0.693359375
EXP_C2 = -2.12194440e-4
EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
         1.6666665459e-1, 5.0000001201e-1)
EXP_LO, EXP_HI = -104.0, 89.0     # the input clamp (exp(-104) flushes, exp(89) = inf)

LOG_SQRTHF = 0.707106781186547524
LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
         1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
         3.3333331174e-1)
LOG_Q1, LOG_Q2 = -2.12194440e-4, 0.693359375


def _k(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2 ** n as f32 bits, for int32 n in [-126, 127]."""
    return ((n + 127) << 23).view(torch.float32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 exp: n = floor(x log2(e) + 1/2), r = x - n ln 2 in two parts,
    e^r by the degree-5 polynomial, times 2 ** n (split in two factors so
    that n = 128 and the small n stay exact)."""
    k = lambda v: _k(v, x)  # noqa: E731
    xc = torch.clamp(x, EXP_LO, EXP_HI)
    fx = torch.floor(fma32(xc, k(EXP_LOG2EF), k(0.5)))
    r = fma32(k(-EXP_C1), fx, xc)
    r = fma32(k(-EXP_C2), fx, r)
    z = r * r
    y = fma32(r, k(EXP_P[0]), k(EXP_P[1]))
    for p in EXP_P[2:]:
        y = fma32(y, r, k(p))
    y = fma32(y, z, r)
    y = y + 1.0
    n = torch.nan_to_num(fx, nan=0.0).to(torch.int32).clamp(-127, 128)
    hi = n > 0
    y = y * _pow2(torch.where(hi, n - 1, n + 1)) * torch.where(hi, k(2.0), k(0.5))
    y = torch.where(y < FLT_MIN, torch.zeros_like(y), y)
    return torch.where(torch.isnan(x), x, y)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 log: x = m 2**e with m in [sqrt(1/2), sqrt(2)), log(1 + (m - 1))
    by the degree-8 polynomial, plus e ln 2 in two parts.  0 and subnormal
    inputs give -inf, negative ones NaN, +inf itself."""
    k = lambda v: _k(v, x)  # noqa: E731
    bits = torch.clamp_min(x, FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 126).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)    # in [0.5, 1)
    small = m < LOG_SQRTHF
    tmp = torch.where(small, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - small.to(torch.float32)
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    y = fma32(m, k(LOG_P[0]), k(LOG_P[1]))
    y1 = fma32(m, k(LOG_P[3]), k(LOG_P[4]))
    y2 = fma32(m, k(LOG_P[6]), k(LOG_P[7]))
    y = fma32(y, m, k(LOG_P[2]))
    y1 = fma32(y1, m, k(LOG_P[5]))
    y2 = fma32(y2, m, k(LOG_P[8]))
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, LOG_Q1 * e)
    m = fma32(k(-0.5), x2, m)
    m = m + y
    m = fma32(k(LOG_Q2), e, m)
    m = torch.where(x == float("inf"), x, m)
    m = torch.where((x >= 0) & (x < FLT_MIN), torch.full_like(m, -float("inf")), m)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(m, float("nan")), m)
