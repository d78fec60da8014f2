"""How XLA's jitted CPU code computes in bf16 and f16, spelled in torch.

The JAX package runs ``dtype="bfloat16"`` and ``"float16"`` on its jnp
routes; the plain versions of the port's half builds compute what XLA's
CPU code computes there (``tracker/pipeline.py``'s docstring maps each
stage):

- an elementwise op widens its half operands to f32, computes in f32 and
  rounds the result to the half dtype -- which torch's CPU half ops do;
- bf16 contracts nothing; f16 contracts a multiply feeding an add into one
  FMA rounded once to f16 (``madd``), at the sites XLA's compiled code
  contracts (read from it: LLVM contracts the first product of an add or
  a subtraction of two products);
- a reduction, a dot or an einsum of half operands accumulates in f32 in
  ascending index and rounds once (``sum_f32``); a mean is that f32 sum
  times f32(1 / n), rounded once (``mean_f32``).

The CUDA half builds spell the same rules with ``csrc/fp_rn.cuh``'s
``fp::h*`` functions.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.voxel import f32

HALF = (torch.bfloat16, torch.float16)


def is_half(dtype: torch.dtype) -> bool:
    return dtype in HALF


def madd(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c at a site XLA contracts: in f16 one FMA rounded once to
    f16 (the host's native f16 FMA, ``__hfma`` on the card; emulated here
    in f64, where the product of two f16 values is exact); in bf16 the
    product rounded, then the sum."""
    dt = c.dtype
    if dt == torch.float16:
        b = b.double() if torch.is_tensor(b) else torch.tensor(b, dtype=torch.float64)
        return (a.double() * b + c.double()).to(dt)
    return a * b + c


def sum_f32(terms, dtype: torch.dtype) -> torch.Tensor:
    """The f32 sum of half ``terms`` in their order, rounded once to
    ``dtype``.  A term given as a pair (a, b) is the product a * b of the
    widened factors (exact in f32 for half factors), as XLA's dot of half
    operands multiplies them: never rounded to the half dtype first."""
    def f(x):
        return x[0].float() * x[1].float() if isinstance(x, tuple) else x.float()

    acc = f(terms[0])
    for x in terms[1:]:
        acc = acc + f(x)
    return acc.to(dtype)


def sum_f32_windows(terms, dtype: torch.dtype, window: int = 32) -> torch.Tensor:
    """An XLA CPU reduction of more than ``window`` half terms: split into
    windows of ``window`` terms (its reduce-window), each summed in f32 in
    order, then the windows' sums added in order, rounded once."""
    if len(terms) <= window:
        return sum_f32(terms, dtype)
    parts = [sum_f32(terms[i:i + window], torch.float32)
             for i in range(0, len(terms), window)]
    return sum_f32(parts, dtype)


def mean_f32(terms, dtype: torch.dtype) -> torch.Tensor:
    """``jnp.mean`` of half values: the f32 sum times f32(1 / n), rounded
    once."""
    acc = terms[0].float()
    for x in terms[1:]:
        acc = acc + x.float()
    return (acc * f32(1.0 / len(terms))).to(dtype)
