"""K3: farthest-pair column statistics per cluster slot; K10 and K3f: the
whole circumcenter feature per slot.

K3 replaces the Pallas kernel ``multiple_object_tracking_lidar_tpu/ops/
centroid_pallas.py::pair_stats_pallas_dyn``.  CUDA source:
``csrc/centroid.cu`` with the scan it shares with K10 and K3f,
``csrc/pair_scan.cuh``, whose headers say what bounds them on the H100
(the launch: a few active slots of n^2/2 pair terms) and how the design
answers that (one CTA per slot, members compacted by a prefix sum, the
column scan split over a warp's lanes; empty slots return at once).
``pair_stats`` launches it for CUDA tensors and runs ``pair_stats_plain``
for CPU tensors; ``.launches`` counts kernel launches.  Both return
``(colmax (C, P) f32, firstrow (C, P) i32)``: ``colmax[j]`` the largest
d2 over member rows i < j by the serial rule (ascending rows, strict '>'
from -1, so a NaN never wins) and ``firstrow[j]`` the first row reaching
it; (-1, 0) for a column without a pair, (-1, P) for a slot without
members.  No tracking path launches K3: they run K3f.

K3f (``circumcenter_features``) is the tracking paths' circumcenter: the
(C, 4) [x, y, 0, t] detections in one launch, bit for bit
``circumcenter_features_plain`` -- K3's plain version followed by
``ops/centroid.py::circumcenter_from_pair_stats``, the function the JAX
pipeline computes as ``circumcenter_features_table_pallas_v2`` (the
Pallas pair stats and jnp selection it replaces).  K10
(``circumcenter_xy``) replaces ``centroid_pallas.py::
circumcenter_xy_pallas``, the TPU's all-in-kernel circumcenter, which no
tracking path runs (``ops/centroid_pallas.py`` of this package holds its
entry points); it is the same kernel body writing (C, 2) [x, y]
(``csrc/circumcenter.cu``).  Each launches for CUDA tensors and runs its
plain version for CPU tensors, bit for bit the same.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype


def column_max_plain(d2: torch.Tensor, pair_ok: torch.Tensor):
    """K3's column statistics of a (C, P, P) [row, column] d2 and pair
    mask, by the serial rule: a pair enters only where d2 > -1 (the rule's
    first update from -1), so a NaN never wins; colmax the largest, firstrow
    the first row reaching it, (-1, row 0) where no pair wins."""
    p = d2.shape[1]
    d2m = torch.where(pair_ok & (d2 > -1.0), d2, -1.0)
    colmax = d2m.max(dim=1).values                            # (C, P)
    rows = torch.arange(p, device=d2.device)[None, :, None].expand_as(d2)
    firstrow = torch.where(d2m == colmax[:, None, :], rows, p).min(dim=1).values
    return colmax, firstrow


def _member_mean(mp: torch.Tensor, mm: torch.Tensor) -> torch.Tensor:
    """(C, 3) mean of each slot's members, as K3 / K3f centre them: f32
    members summed in f64 (exact here: ``pair_scan.cuh``) and rounded to
    f32, over the f32 count; f64 members (the double build) summed in f64
    one lane after another in ascending lane order, over the f64 count."""
    cnt = torch.clamp(mm.sum(dim=1), min=1).to(mp.dtype)[:, None]
    vals = torch.where(mm[..., None], mp, 0.0)
    if mp.dtype == torch.float32:
        return vals.to(torch.float64).sum(dim=1).to(torch.float32) / cnt
    acc = torch.zeros_like(vals[:, 0])
    for lane in range(vals.shape[1]):
        acc = acc + vals[:, lane]
    return acc / cnt


def pair_stats_plain(mpts: torch.Tensor, member_mask: torch.Tensor):
    """Plain PyTorch version of K3 (and of K3f's scan, in f32 or, for f64
    members, its double build): the same centring (``_member_mean``), the
    same d2 expression order, elementwise (no matmul, so no reordered
    gram), then ``column_max_plain``."""
    c, p, _ = mpts.shape
    dev = mpts.device
    mp = mpts if mpts.dtype == torch.float64 else mpts.to(torch.float32)
    mm = member_mask.to(torch.bool)
    cnt = mm.sum(dim=1)
    mean = _member_mean(mp, mm)                                # (C, 3)
    pc = torch.where(mm[..., None], mp - mean[:, None, :], 0.0)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    sq = (x * x + y * y) + z * z                              # (C, P)
    gram = (
        x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :]
    ) + z[:, :, None] * z[:, None, :]                         # (C, P, P) [i, j]
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * gram
    ar = torch.arange(p, device=dev)
    pair_ok = mm[:, :, None] & mm[:, None, :] & (ar[:, None] < ar[None, :])[None]
    colmax, firstrow = column_max_plain(d2, pair_ok)
    active = (cnt > 0)[:, None]
    colmax = torch.where(active, colmax, -1.0)
    firstrow = torch.where(active, firstrow, p).to(torch.int32)
    return colmax, firstrow


def _check_table(mpts: torch.Tensor, member_mask: torch.Tensor, dtypes=(torch.float32,)):
    """(C, P) of a CUDA member table, or ValueError."""
    if mpts.dim() != 3 or mpts.shape[2] != 3 or mpts.dtype not in dtypes:
        raise ValueError(f"mpts must be (C, P, 3) {' or '.join(str(d) for d in dtypes)}, "
                         f"got {tuple(mpts.shape)} {mpts.dtype}")
    c, p, _ = mpts.shape
    if member_mask.shape != (c, p) or member_mask.device != mpts.device:
        raise ValueError(f"member_mask must be ({c}, {p}) on {mpts.device}")
    return c, p


def pair_stats(mpts: torch.Tensor, member_mask: torch.Tensor):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if mpts.device.type == "cpu":
        return pair_stats_plain(mpts, member_mask)
    c, p = _check_table(mpts, member_mask)
    dev = mpts.device
    mpts = mpts.contiguous()
    mm8 = _build.byte_mask(member_mask)
    colmax = torch.empty((c, p), dtype=torch.float32, device=dev)
    firstrow = torch.empty((c, p), dtype=torch.int32, device=dev)
    lib = _build.load()
    err = lib.motl_pair_stats(
        mpts.data_ptr(), mm8.data_ptr(), c, p, colmax.data_ptr(),
        firstrow.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "motl_pair_stats")
    pair_stats.launches += 1
    return colmax, firstrow


pair_stats.launches = 0


def _slot_times(t, c: int, like: torch.Tensor) -> torch.Tensor:
    """t as a flat tensor of ``like``'s dtype on its device: one time per
    slot (C,), one per frame (S,) for S stacked frames of C / S slots each,
    or one for all; ValueError where its length does not divide C."""
    tt = torch.as_tensor(t, dtype=like.dtype, device=like.device).reshape(-1)
    if tt.numel() < 1 or c % tt.numel():
        raise ValueError(f"t must have a length dividing C={c}, got {tt.numel()}")
    return tt


def circumcenter_features_plain(mpts: torch.Tensor, member_mask: torch.Tensor,
                                t) -> torch.Tensor:
    """Plain PyTorch version of K3f: K3's plain pair stats, then the eager
    selection, line scan and determinant; (C, 4) [x, y, 0, t]."""
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_from_pair_stats,
    )

    c = mpts.shape[0]
    tt = _slot_times(t, c, mpts)
    cm, fr = pair_stats_plain(mpts, member_mask)
    return circumcenter_from_pair_stats(cm, fr, mpts, member_mask,
                                        tt.repeat_interleave(c // tt.numel()))


def _take1(mpts: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(mpts, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]


def circumcenter_features_half_plain(mpts: torch.Tensor, member_mask: torch.Tensor,
                                     t, frame_slots: int | None = None,
                                     cy_alt: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3f's half builds and of its f32 table
    build: the JAX package's jnp ``_one_cluster`` per slot (centroid.py:
    30-84; the route its half dtypes take, and its point list's f32 route)
    in bf16, f16 or f32, as XLA's CPU code computes it in ``bind_env``'s
    programs (ops/half.py): the member mean in windows of 32 members, the
    windows' sums added in order, divided by the count; d2 = (sq_i + sq_j) -
    2 gram; the first maximum in row-major (i, j) order, the line scan and
    the determinant per op -- under f16 and f32 the line's cross product,
    e, f, G and the two numerators each one FMA rounded once (the first
    product of each sum or difference: ``cluster_pallas.fma``).  The half
    dtypes sum the squared norms and the gram as exact products in f32,
    rounded once; f32 takes them as XLA's loops do, fma(z, z', fma(y, y',
    x * x')).  f32's norm sqrt(ex^2 + ey^2) is contracted, fma(ex, ex, ey^2),
    only on the slots the fused loop runs in its scalar epilogue: XLA's
    8-wide vector body takes the first 8 * floor((C - 1) / 8) slots of each
    frame's C (``frame_slots``; 24 of the headline's 32) without an FMA,
    the rest one at a time with it (read from the program's machine code).
    ``cy_alt``: cy as the JAX fleet's f16 program on a mesh of several
    devices computes it, from its own e and f contracted on their second
    product (``mesh_program``)."""
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma, fma32
    from multiple_object_tracking_lidar_tpu_torch.ops.half import sum_f32, sum_f32_windows

    c, p, _ = mpts.shape
    dt = mpts.dtype
    tt = _slot_times(t, c, mpts)
    mm = member_mask.to(torch.bool)
    cnt = torch.clamp(mm.sum(dim=1), min=1).to(dt)
    prod = mpts * mm[..., None].to(dt)
    tot = sum_f32_windows([prod[:, q] for q in range(p)], dt)             # (C, 3)
    cen = torch.where(mm.any(dim=1)[:, None], tot / cnt[:, None], torch.zeros_like(tot))
    pc = torch.where(mm[..., None], mpts - cen[:, None, :], torch.zeros_like(mpts))
    if dt == torch.float32:
        def dot3(u, v):
            return fma32(u[..., 2], v[..., 2], fma32(u[..., 1], v[..., 1], u[..., 0] * v[..., 0]))

        sq = dot3(pc, pc)                                                    # (C, P)
        gram = dot3(pc[:, :, None, :], pc[:, None, :, :])
    else:
        sq = sum_f32([(pc[..., a], pc[..., a]) for a in range(3)], dt)    # (C, P)
        gram = sum_f32([(pc[:, :, None, a], pc[:, None, :, a]) for a in range(3)], dt)
    s = sq[:, :, None] + sq[:, None, :]
    # f16: XLA contracts the doubling into the difference, fma(-2, gram, s),
    # so a 2 gram past 65,504 is not inf; f32's and bf16's 2 gram is exact
    d2 = fma(torch.full_like(gram, -2.0), gram, s) if dt == torch.float16 else s - 2.0 * gram
    iu = torch.arange(p, device=mpts.device)
    pair = mm[:, :, None] & mm[:, None, :] & (iu[:, None] < iu[None, :])
    d2m = torch.where(pair, d2, torch.full_like(d2, -1.0))
    row_max = d2m.max(dim=2).values
    row_arg = _first_max(d2m, 2)
    i_star = _first_max(row_max, 1)
    j_star = torch.gather(row_arg, 1, i_star[:, None])[:, 0]
    pi, pj = _take1(mpts, i_star), _take1(mpts, j_star)
    pix, piy, pjx, pjy = pi[:, 0:1], pi[:, 1:2], pj[:, 0:1], pj[:, 1:2]
    xs, ys = mpts[..., 0], mpts[..., 1]
    ex, ey = pjx - pix, pjy - piy
    cross = torch.abs(fma(ex.expand_as(ys), ys - piy, -(ey * (xs - pix))))
    if dt == torch.float32:
        per = frame_slots or c
        tail = (torch.arange(c, device=mpts.device) % per >= 8 * ((per - 1) // 8))[:, None]
        sq_xy = torch.where(tail, fma32(ex, ex, ey * ey), ex * ex + ey * ey)
        norm = torch.sqrt(sq_xy.double()).float()      # correctly rounded, as vsqrtss
    else:
        norm = torch.sqrt(ex * ex + ey * ey)
    line_d = cross / torch.clamp(norm, min=in_dtype(1e-30, dt))
    eq_i = (mpts == pi[:, None, :]).all(dim=2)
    eq_j = (mpts == pj[:, None, :]).all(dim=2)
    k_mask = mm & ~eq_i & ~eq_j
    k_star = _first_max(torch.where(k_mask, line_d, torch.full_like(line_d, -1.0)), 1)
    pk = _take1(mpts, k_star)
    pix, piy, pjx, pjy, pkx, pky = pi[:, 0], pi[:, 1], pj[:, 0], pj[:, 1], pk[:, 0], pk[:, 1]
    a, b, cc, d = pjx - pix, pjy - piy, pkx - pix, pky - piy
    e = fma(a, pix + pjx, b * (piy + pjy))
    f = fma(cc, pix + pkx, d * (piy + pky))
    g = 2.0 * fma(a, pky - pjy, -(b * (pkx - pjx)))
    collinear = g == 0.0
    g_safe = torch.where(collinear, torch.ones_like(g), g)
    cx = torch.where(collinear, pix, fma(d, e, -(b * f)) / g_safe)
    if cy_alt:
        e, f = fma(b, piy + pjy, a * (pix + pjx)), fma(d, piy + pky, cc * (pix + pkx))
    cy = torch.where(collinear, piy, fma(a, f, -(cc * e)) / g_safe)
    tcol = tt.repeat_interleave(c // tt.numel())
    return torch.stack([cx, cy, torch.zeros_like(cx), tcol], dim=1)


def _first_max(v: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.argmax``: the first index of the maximum along ``dim``, a NaN
    counting as the maximum."""
    n = v.shape[dim]
    nan = torch.isnan(v)
    hit = torch.where(nan.any(dim=dim, keepdim=True), nan,
                      v == v.max(dim=dim, keepdim=True).values)
    idx = torch.arange(n, device=v.device).reshape([-1 if q == dim % v.dim() else 1
                                                    for q in range(v.dim())])
    return torch.where(hit, idx, n).min(dim=dim).values


def half_smem_bytes(p: int) -> int:
    """Shared memory of one slot of K3f's half and table builds
    (``csrc/circumcenter.cu::half_smem_bytes``): the compacted members as
    float4 in whole 32-row tiles, three per-axis arrays padded by a word per
    32 lanes, the compaction's rank and lane."""
    tiles = (p + 31) // 32
    return 16 * 32 * tiles + 12 * (p + tiles) + 8 * p


# The H100's shared memory per block (227 KB opt-in) less 1 KB for the
# kernel's static scratch: the largest P the half and table builds take.
HALF_SMEM_LIMIT = 227 * 1024 - 1024
HALF_P_MAX = max(p for p in range(1, HALF_SMEM_LIMIT // 36 + 1)
                 if half_smem_bytes(p) <= HALF_SMEM_LIMIT)


_MESH_PROGRAM = contextvars.ContextVar("mesh_program", default=False)


@contextlib.contextmanager
def mesh_program(on: bool = True):
    """Inside it the half builds spell cy as XLA compiles the JAX fleet on a
    mesh of more than one device (``ShardedTracker`` enters it there): that
    program contracts cy's own copies of e and f on their second product,
    where ``bind_env``'s and the one-device fleet's contract the first
    (read from the programs' machine code; f16 only -- bf16 contracts
    nothing)."""
    token = _MESH_PROGRAM.set(bool(on))
    try:
        yield
    finally:
        _MESH_PROGRAM.reset(token)


def circumcenter_features(mpts: torch.Tensor, member_mask: torch.Tensor, t,
                          table: bool = False) -> torch.Tensor:
    """K3f on CUDA tensors, its plain version on CPU tensors: (C, 4)
    [x, y, 0, t] detections of the member table mpts (C, P, 3), mask
    (C, P), t (C,) per slot (or (S,) per frame of S stacked frames, or a
    scalar), in mpts' dtype: f32, or f64 (the double build,
    ``motl_circumcenter_features_f64``), or bf16 / f16 (the half builds,
    ``motl_circumcenter_features_bf16`` / ``_f16``, the JAX jnp route's
    arithmetic: ``circumcenter_features_half_plain``).  ``table`` takes f32
    tables through that jnp route too (``motl_circumcenter_features_table``,
    the half builds' body on f32 values: the JAX point list's f32
    ``_one_cluster``, which the runs' point list casts to the half dtype),
    t then per frame.  One launch; t is read on the device.  The half and
    table builds hold a slot in shared memory: P past ``HALF_P_MAX``
    raises."""
    half = mpts.dtype in (torch.bfloat16, torch.float16)
    if table and mpts.dtype != torch.float32:
        raise ValueError(f"the f32 table build takes float32 tables (got {mpts.dtype})")
    c = mpts.shape[0]
    cy_alt = half and _MESH_PROGRAM.get()
    if mpts.device.type == "cpu":
        if half or table:
            return circumcenter_features_half_plain(
                mpts, member_mask, t, c // max(1, torch.as_tensor(t).numel()), cy_alt)
        return circumcenter_features_plain(mpts, member_mask, t)
    c, p = _check_table(mpts, member_mask,
                        (torch.float32, torch.float64, torch.bfloat16, torch.float16))
    if (half or table) and p > HALF_P_MAX:
        raise ValueError(f"K3f's half and table builds take P <= HALF_P_MAX = {HALF_P_MAX} "
                         f"members a slot (shared memory), got P={p}")
    dev = mpts.device
    mpts = mpts.contiguous()
    mm8 = _build.byte_mask(member_mask)
    tt = _slot_times(t, c, mpts).contiguous()
    out = torch.empty((c, 4), dtype=mpts.dtype, device=dev)
    entry = {torch.float64: "motl_circumcenter_features_f64",
             torch.bfloat16: "motl_circumcenter_features_bf16",
             torch.float16: "motl_circumcenter_features_f16"}.get(
                 mpts.dtype, "motl_circumcenter_features_table" if table
                 else "motl_circumcenter_features")
    err = getattr(_build.load(), entry)(
        mpts.data_ptr(), mm8.data_ptr(), tt.data_ptr(), c, p, c // tt.numel(),
        *((int(cy_alt),) if half else ()), out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    _build.count(circumcenter_features, entry, "motl_circumcenter_features")
    return out


circumcenter_features.launches = 0                   # the f32 build's
circumcenter_features.launches_by = collections.Counter()   # by C entry


def circumcenter_xy_plain(mpts: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10: K3f's plain version without [0, t]."""
    return circumcenter_features_plain(mpts.to(torch.float32), member_mask, 0.0)[:, :2]


def circumcenter_xy(mpts: torch.Tensor, member_mask: torch.Tensor) -> torch.Tensor:
    """K10 on CUDA tensors, its plain version on CPU tensors: (C, 2) f32."""
    if mpts.device.type == "cpu":
        return circumcenter_xy_plain(mpts, member_mask)
    c, p = _check_table(mpts, member_mask)
    dev = mpts.device
    mpts = mpts.contiguous()
    mm8 = _build.byte_mask(member_mask)
    out = torch.empty((c, 2), dtype=torch.float32, device=dev)
    err = _build.load().motl_circumcenter(
        mpts.data_ptr(), mm8.data_ptr(), c, p, out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "motl_circumcenter")
    circumcenter_xy.launches += 1
    return out


circumcenter_xy.launches = 0
