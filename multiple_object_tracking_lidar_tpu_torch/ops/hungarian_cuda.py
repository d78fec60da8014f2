"""K12: the Hungarian auction alone, on given cost matrices.

The JAX package's ``association="hungarian"`` solves each frame's gated
assignment with ``ops/hungarian.py::auction_assign`` (:34), a jnp Jacobi
auction with eps scaling inside bounded ``while_loop``s; it has no TPU
kernel.  On the card the auction is one device function
(``csrc/auction.cuh::auction_warp``, whose header says what bounds it and
how its design answers that: one warp, per-column state in shared memory,
one bid for all the dummy rows, the column summaries kept per lane and
recomputed where a price or an owner changed, the iterations with no real
row unassigned applied by one lane, packed-key ``atomicMax`` winners).  K4's
Hungarian builds run it as the decision stage of the track step
(``ops/track_cuda.py``); ``auction_assign`` launches it alone
(``csrc/auction.cu``, one 32-thread CTA per problem) so that it can be
held against ``ops/hungarian.py::auction_assign_plain`` by itself,
including a ``max_iters`` small enough to saturate.  No tracking path
launches it, as no tracking path launches the greedy scan alone
(``ops/assign_cuda.py``).

``auction_assign`` launches the kernel for CUDA tensors and runs
``auction_assign_plain`` for CPU tensors, in f32 or, for bf16 / f16 costs
(``dtype="bfloat16"`` / ``"float16"``), the half builds
(``motl_auction_assign_bf16`` / ``_f16``: the auction on half values, each
sum and difference rounded to the half dtype); ``.launches_by`` counts
kernel launches by C entry and ``.launches`` those of the f32 build.  It takes (D, K) or B stacked (B, D, K) problems and returns
(assigned (D,) / (B, D) int32, saturated () / (B,) int32) and, with
``return_iters``, the iterations each phase ran ((n_phases,) / (B,
n_phases) int32); with ``return_split`` also those of them with no real
row unassigned (the device function's dummy-only iterations, which
``scripts/micro_torch_auction.py`` times apart), the same shape.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
    MAX_ITERS,
    SCALE,
    auction_assign_plain,
    auction_negs,
    auction_schedule,
)

MAX_ROWS = 128      # real rows (detections), as K4
MAX_COLS = 1024     # real columns (track slots), as K4
MAX_PHASES = 16     # csrc/auction.cuh::kMaxPhases


def auction_params(d: int, eps: float, max_cost: float, scale: float = SCALE,
                   dtype: torch.dtype = torch.float32):
    """(host array [neg, neg_half, neg_pen, neg_pen2, eps_0, ...] of f32, or
    of f64 for K4's double builds, n_phases): the kernels' auction
    parameters for ``d`` real rows, values of ``dtype`` (the half builds
    take the bf16 / f16 values as f32, exactly)."""
    neg_pen, neg_pen2, eps_ps = auction_schedule(d, eps, max_cost, scale, dtype)
    if len(eps_ps) > MAX_PHASES:
        raise ValueError(f"{len(eps_ps)} eps phases; the kernels hold at most {MAX_PHASES}")
    vals = [*auction_negs(dtype), neg_pen, neg_pen2, *eps_ps]
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    return (ctype * len(vals))(*vals), len(eps_ps)


def auction_assign(
    cost: torch.Tensor,       # (D, K) or (B, D, K) f32, bf16 or f16
    feasible: torch.Tensor,   # the same shape, bool
    eps: float,
    max_cost: float,
    max_iters: int = MAX_ITERS,
    scale: float = SCALE,
    return_iters: bool = False,
    return_split: bool = False,
):
    """K12 on CUDA tensors, ``auction_assign_plain`` (problem by problem)
    on CPU tensors."""
    single = cost.dim() == 2
    if single:
        cost, feasible = cost[None], feasible[None]
    if cost.device.type == "cpu":
        outs = [auction_assign_plain(c, f, eps, max_cost, max_iters, scale, return_split=True)
                if return_split else
                auction_assign_plain(c, f, eps, max_cost, max_iters, scale, return_iters=True)
                for c, f in zip(cost, feasible)]
        assigned = torch.stack([o[0] for o in outs])
        saturated = torch.stack([o[1] for o in outs])
        iters = torch.tensor([o[2] for o in outs], dtype=torch.int32)
        fast = torch.tensor([o[3] for o in outs], dtype=torch.int32) if return_split else None
    else:
        assigned, saturated, iters, fast = _launch(cost, feasible, eps, max_cost, max_iters,
                                                   scale)
    out = (assigned, saturated, iters, fast)
    if single:
        out = tuple(None if x is None else x[0] for x in out)
    if return_split:
        return out
    return out[:3] if return_iters else out[:2]


def _launch(cost, feasible, eps, max_cost, max_iters, scale):
    n_b, d, k = cost.shape
    dev = cost.device
    if not (1 <= d <= MAX_ROWS and 1 <= k <= MAX_COLS):
        raise ValueError(f"K12 holds 1 <= D <= {MAX_ROWS} rows and 1 <= K <= {MAX_COLS} "
                         f"columns (got D={d}, K={k})")
    if cost.dtype not in _ENTRY or feasible.shape != cost.shape or feasible.device != dev:
        raise ValueError(f"cost must be float32, bfloat16 or float16 and feasible "
                         f"{tuple(cost.shape)} on {dev}")
    params, n_phases = auction_params(d, eps, max_cost, scale, dtype=cost.dtype)
    cost = cost.contiguous()
    feas = _build.byte_mask(feasible)
    assigned = torch.empty((n_b, d), dtype=torch.int32, device=dev)
    saturated = torch.empty((n_b,), dtype=torch.int32, device=dev)
    iters = torch.empty((n_b, n_phases), dtype=torch.int32, device=dev)
    fast = torch.empty((n_b, n_phases), dtype=torch.int32, device=dev)
    entry = _ENTRY[cost.dtype]
    err = getattr(_build.load(), entry)(
        cost.data_ptr(), feas.data_ptr(), ctypes.addressof(params), n_phases, int(max_iters),
        n_b, d, k, assigned.data_ptr(), saturated.data_ptr(), iters.data_ptr(), fast.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    _build.count(auction_assign, entry, "motl_auction_assign")
    return assigned, saturated, iters, fast


_ENTRY = {torch.float32: "motl_auction_assign", torch.bfloat16: "motl_auction_assign_bf16",
          torch.float16: "motl_auction_assign_f16"}
auction_assign.launches = 0                          # motl_auction_assign's
auction_assign.launches_by = collections.Counter()   # by C entry
