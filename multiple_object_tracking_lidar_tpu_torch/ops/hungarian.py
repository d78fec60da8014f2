"""Optimal gated assignment, ``association="hungarian"``: the plain versions.

Port of ``multiple_object_tracking_lidar_tpu/ops/hungarian.py``.  The JAX
package solves the gated min-cost bipartite assignment with a Jacobi
auction (Bertsekas) under eps scaling, over a square (D + K) x (D + K)
value matrix: D real rows (detections) and K dummy rows against K real
columns (track slots) and D virtual columns.  A real row sees ``-cost``
where the pair is feasible, ``_NEG`` where it is not, and ``-penalty`` on
every virtual column (it may stay unmatched); a dummy row sees
``-penalty2`` everywhere, so every phase ends with every column owned and
the carried prices stay dual-feasible.  Each phase resets the owners,
keeps the prices and bids until no row is unassigned or ``max_iters``
iterations have run; ``saturated`` counts the phases cut at the cap.

``auction_assign_plain`` is that algorithm step for step in torch: the
argmax with its first-index ties, the second maximum with the best column
masked to ``_NEG``, the ``second <= _NEG / 2`` rule, the bid
``(price[best] + (best - second)) + eps_p`` in that order, each column's
first-index winner.  It reads the convergence test on the host once per
``CHECK_EVERY`` iterations (those run past convergence place no bid), and
on CUDA tensors replays such a chunk as one CUDA graph of the same kernels;
it serves the CPU, the tests and the card's checks.  On the card the
auction runs inside K4 (the track step, ``csrc/assign.cu``) and alone as
K12 (``ops/hungarian_cuda.py``), from one device function
(``csrc/auction.cuh``), and both are held bit for bit to this version.

``hungarian_associate_and_update_plain`` is the JAX function of the same
name: the auction on the gate's costs, then the unmatched valid detections
registered in detection order into the free slots by rank, the
interpolation flags, the bank's metadata and the closed-form window
updates of ``ops/assign.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multiple_object_tracking_lidar_tpu_torch.ops.assign import (
    AssocResult,
    apply_window_updates,
)
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma, fma32, fma64
from multiple_object_tracking_lidar_tpu_torch.ops.half import is_half
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import f32, in_dtype, true_div
from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackBank

_NEG = -3e38
NEG32 = f32(_NEG)            # jnp.where(..., _NEG) in an f32 array
NEG_HALF32 = f32(_NEG / 2)   # the weak-typed _NEG / 2 compared with f32 values
EPS = 1e-3                   # hungarian_associate_and_update's default eps
MAX_ITERS = 3000             # auction_assign's per-phase cap
SCALE = 8.0                  # auction_assign's eps scaling factor
CHECK_EVERY = 32             # iterations between the plain auction's host reads


def auction_schedule(d: int, eps: float, max_cost: float, scale: float = SCALE,
                     dtype: torch.dtype = torch.float32):
    """(-penalty, -penalty2, [eps_p per phase]) for ``d`` real rows, each
    computed in Python f64 and rounded once to ``dtype`` (f32 or f64), as
    ``jnp.full`` and ``jnp.asarray(eps_p, dtype)`` round them (JAX
    hungarian.py:64-69, :120-127)."""
    penalty = d * max_cost + 1.0
    penalty2 = 2.0 * penalty
    eps0 = max(max_cost / 2.0, eps)
    n_phases = max(1, int(math.ceil(math.log(max(eps0 / eps, 2.0), scale))) + 1)
    eps_ps = [in_dtype(max(eps, eps0 / (scale**p)), dtype) for p in range(n_phases)]
    return in_dtype(-penalty, dtype), in_dtype(-penalty2, dtype), eps_ps


def auction_negs(dtype: torch.dtype = torch.float32) -> tuple[float, float]:
    """(_NEG, _NEG / 2) as values of ``dtype``: what ``jnp.where(...,
    _NEG)`` writes into an array of that dtype, and what its values are
    compared with.  Finite in f32, f64 and bf16; both overflow to -inf in
    f16, as numpy's cast of the weak-typed constant does in JAX (then an
    infeasible pair's value is -inf and ``second <= _NEG / 2`` holds only
    for -inf)."""
    with np.errstate(over="ignore"):
        return in_dtype(_NEG, dtype), in_dtype(_NEG / 2, dtype)


def _chunk_graph(iterate, reps: int, state: tuple):
    """``reps`` calls of ``iterate`` (in place on the CUDA tensors of
    ``state``, no host read) captured as one CUDA graph, after a warm-up
    call on a side stream; ``state`` is left as it was."""
    saved = [t.clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        iterate()
    torch.cuda.current_stream().wait_stream(side)
    for t, v in zip(state, saved):
        t.copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            iterate()
    return graph


def auction_assign_plain(
    cost: torch.Tensor,       # (D, K) assignment costs: f32, f64, bf16 or f16
    feasible: torch.Tensor,   # (D, K) bool allowed pairs
    eps: float,
    max_cost: float,
    max_iters: int = MAX_ITERS,
    scale: float = SCALE,
    return_iters: bool = False,
    return_split: bool = False,
):
    """Eps-scaling Jacobi auction in the costs' dtype (f32, f64, bf16 or
    f16; a half sum or difference computed in f32 and rounded once, as
    XLA's CPU code does in both half dtypes): ((D,)
    int32 column per row or -1, int32 saturated phase count), and with
    ``return_iters`` the iterations each phase ran (a list); with
    ``return_split`` also the iterations each phase ran with no real row
    unassigned (a list: the kernels' dummy-only iterations)."""
    d, k = cost.shape
    dev, dt = cost.device, cost.dtype
    neg_pen, neg_pen2, eps_ps = auction_schedule(d, eps, max_cost, scale, dt)
    neg_v, neg_half = auction_negs(dt)
    n = d + k
    value = torch.full((n, n), neg_pen2, dtype=dt, device=dev)
    value[:d, :k] = torch.where(feasible, -cost, neg_v)
    value[:d, k:] = neg_pen
    rows = torch.arange(n, device=dev)
    neg = torch.tensor(neg_v, dtype=dt, device=dev)
    # the auction's state, updated in place (a CUDA graph replays on it)
    price = torch.zeros(n, dtype=dt, device=dev)
    owner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    unassigned = torch.ones(n, dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    fast = torch.zeros((), dtype=torch.int64, device=dev)
    eps_t = torch.zeros((), dtype=dt, device=dev)

    def iterate():
        """One Jacobi iteration, in place and with no host read: ``it``
        (and ``fast``) count it if a row (no real row) was unassigned."""
        pending = unassigned.any()
        it.add_(pending)
        if return_split:
            fast.add_(pending & ~unassigned[:d].any())
        net = value - price[None, :]
        best_k = torch.argmax(net, dim=1)     # the first maximum
        best_v = net.amax(dim=1)
        net2 = net.clone()
        net2[rows, best_k] = neg
        second_v = net2.amax(dim=1)
        second_v = torch.where(second_v <= neg_half, best_v, second_v)
        bid = price[best_k] + (best_v - second_v) + eps_t
        col_bid = torch.where(unassigned[:, None] & (best_k[:, None] == rows[None, :]),
                              bid[:, None], neg)
        top_bid = col_bid.amax(dim=0)
        winner = torch.argmax(col_bid, dim=0).to(torch.int32)
        took = top_bid > neg_half
        price.copy_(torch.where(took, top_bid, price))
        owner.copy_(torch.where(took, winner, owner))
        assigned_row = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        assigned_row.index_fill_(0, torch.where(owner >= 0, owner, n).to(torch.int64), True)
        unassigned.copy_(~assigned_row[:n])

    graph = None
    saturated, iters, dummy_only = 0, [], []
    for eps_p in eps_ps:
        eps_t.fill_(eps_p)
        owner.fill_(-1)
        unassigned.fill_(True)
        it.zero_()
        fast.zero_()
        ran = 0
        # the host reads the convergence once per CHECK_EVERY iterations: an
        # iteration with no row unassigned places no bid and changes nothing,
        # so those run past convergence are no-ops, and ``it`` counts only
        # the iterations that ran with a row unassigned.  On the card a full
        # chunk is one CUDA graph of the same kernels (the iterations'
        # launches, not their arithmetic, are the plain auction's time)
        while ran < max_iters and bool(unassigned.any()):
            chunk = min(CHECK_EVERY, max_iters - ran)
            if dev.type == "cuda" and chunk == CHECK_EVERY:
                if graph is None:
                    graph = _chunk_graph(iterate, CHECK_EVERY,
                                         (price, owner, unassigned, it, fast))
                graph.replay()
            else:
                for _ in range(chunk):
                    iterate()
            ran += chunk
        saturated += int(int(it) >= max_iters and bool(unassigned.any()))
        iters.append(int(it))
        dummy_only.append(int(fast))
    real = owner[:k].to(torch.int64)
    keep = (real >= 0) & (real < d)
    assigned = torch.full((d + 1,), -1, dtype=torch.int32, device=dev)
    assigned[torch.where(keep, real, d)] = torch.arange(k, dtype=torch.int32, device=dev)
    assigned[d] = -1
    out = (assigned[:d], torch.tensor(saturated, dtype=torch.int32, device=dev))
    if return_split:
        return (*out, iters, dummy_only)
    return (*out, iters) if return_iters else out


def gate_costs(bank: TrackBank, dets: torch.Tensor, det_valid: torch.Tensor,
               id_threshold: float, allow_match):
    """(cost (D, K), feasible (D, K)): the distance from each detection to
    each slot's last position and the gate (JAX hungarian.py:160-170).
    ``jax.jit`` on the CPU contracts ``dx * dx + dy * dy`` into
    fma(dx, dx, dy * dy) (tests/test_torch_hungarian.py pins it), so the
    cost is spelled that way here and in K4.  The square root is IEEE's,
    taken in f64 and rounded once to f32 (correctly rounded: 53 >= 2 * 24
    + 2 bits): PyTorch's f32 ``sqrt`` on the CPU is off by an ulp for
    ~0.6% of inputs, and a bid moves with every bit of its cost.  In f64
    (K4's double build) the same: ``fma64`` and the f64 root.  In bf16 and
    f16 ``bind_env``'s program computes the cost in the half dtype: f16
    contracts it as f32 does, fma(dx, dx, dy * dy) rounded once to f16
    (``vfmadd231sh``), then the native f16 root; bf16 rounds the squares,
    the sum and the f32 root each to bf16.  Both are ``cluster_pallas.fma``
    and the root taken in f64 and rounded once (correctly rounded: 53 >=
    2 * 11 + 2 bits)."""
    L = bank.window.shape[1]
    last = bank.window[:, L - 1, :]
    dx = dets[:, 0:1] - last[None, :, 0]
    dy = dets[:, 1:2] - last[None, :, 1]
    if dx.dtype == torch.float64:
        cost = torch.sqrt(fma64(dx, dx, dy * dy))
    elif is_half(dx.dtype):
        cost = torch.sqrt(fma(dx, dx, dy * dy).to(torch.float64)).to(dx.dtype)
    else:
        cost = torch.sqrt(fma32(dx, dx, dy * dy).to(torch.float64)).to(torch.float32)
    allow = torch.as_tensor(allow_match, device=dets.device).to(torch.bool)
    feasible = (det_valid[:, None] & bank.alive[None, :]
                & (cost < in_dtype(id_threshold, cost.dtype)) & allow)
    return cost, feasible


def hungarian_associate_and_update_plain(
    bank: TrackBank,
    next_obj_num: torch.Tensor,
    next_birth: torch.Tensor,
    dets: torch.Tensor,        # (D, 4) f32
    det_valid: torch.Tensor,   # (D,)
    id_threshold: float,
    dt_gp: float,
    interp_gap_factor: float = 3.0,
    allow_match: torch.Tensor | bool = True,
    eps: float = EPS,
) -> AssocResult:
    """Globally optimal gated matching, then the same lifecycle as the
    greedy associator (JAX hungarian.py:139-221): one detection per track,
    no duplicate ids."""
    K = bank.alive.shape[0]
    L = bank.window.shape[1]
    dev = dets.device
    det_valid = det_valid.to(torch.bool)
    cost, feasible = gate_costs(bank, dets, det_valid, id_threshold, allow_match)
    assigned, saturated = auction_assign_plain(cost, feasible, eps, max_cost=id_threshold)

    matched = assigned >= 0
    want_new = det_valid & ~matched
    free = ~bank.alive
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    n_free = free.sum()
    new_rank = torch.cumsum(want_new.to(torch.int32), 0) - 1
    register = want_new & (new_rank < n_free)
    overflow = (want_new & ~register).sum().to(torch.int32)
    ar_k = torch.arange(K, dtype=torch.int32, device=dev)
    free_slot_by_rank = torch.zeros(K + 1, dtype=torch.int32, device=dev)
    free_slot_by_rank[torch.where(free, free_rank, K).to(torch.int64)] = ar_k
    reg_slot = free_slot_by_rank[torch.clamp(new_rank, 0, K - 1).to(torch.int64)]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    slots = torch.where(matched, assigned, torch.where(register, reg_slot, zero)).to(torch.int32)
    oks = matched | register
    slots64 = slots.to(torch.int64)

    last = bank.window[:, L - 1, :]
    gap = dets[:, 3] - last[slots64, 3]
    dt = gap.dtype
    interps = (matched & (gap > in_dtype(interp_gap_factor * dt_gp, dt))
               & (torch.round(true_div(gap, in_dtype(dt_gp, dt))) - 1.0 >= 1.0))

    new_ids = (next_obj_num + new_rank).to(torch.int32)
    det_id = torch.where(matched, bank.obj_id[slots64],
                         torch.where(register, new_ids, -1)).to(torch.int32)

    reg_row = torch.where(register, slots64, K)

    def scatter(field, vals):
        buf = torch.cat([field, field[:1]])
        buf[reg_row] = vals.to(field.dtype)
        return buf[:K]

    alive = scatter(bank.alive, torch.ones_like(register))
    obj_id = scatter(bank.obj_id, new_ids)
    birth_seq = scatter(bank.birth_seq, next_birth + new_rank)
    n_reg = register.sum().to(torch.int32)
    window, m0 = apply_window_updates(bank, dets, slots, oks, register, interps, dt_gp)
    return AssocResult(
        bank=TrackBank(alive=alive, obj_id=obj_id, birth_seq=birth_seq, window=window, m0=m0),
        next_obj_num=(next_obj_num + n_reg).to(torch.int32),
        next_birth=(next_birth + n_reg).to(torch.int32),
        det_slot=slots,
        det_id=det_id,
        det_new=register,
        det_ok=oks,
        overflow=overflow,
        assoc_saturated=saturated,
    )
