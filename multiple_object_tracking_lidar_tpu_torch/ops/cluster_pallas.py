"""K8: all-pairs fixed-radius connected components over the point list.

Replaces the Pallas kernel ``multiple_object_tracking_lidar_tpu/ops/
cluster_pallas.py::connected_components_pallas`` (``cluster_backend=
"pallas"``).  CUDA source: ``csrc/cluster_cc.cu``, whose header says what
bounds it on the H100 (the serial sweeps, each reading the whole M x M
adjacency) and how its design answers that: one launch per call, one
thread-block cluster per frame (``cc_layout``), each CTA building its rows'
adjacency bits in its own shared memory and the sweeps exchanging labels
over distributed shared memory, with an early exit.

The float ops are those XLA's CPU code gives the interpret-mode kernel:
the centre is a tree-ordered column sum (windows of 32 rows), and the
squared norms and the gram are FMA chains, ``fma(p2, q2, fma(p1, q1,
p0 * q0))``; d2 = (sq_i + sq_j) - 2 * gram.  The plain version computes
each FMA exactly from f64 ops (``fma32``), so the adjacency -- and so the
labels, cut-short sweeps included -- is the interpret-mode kernel's.

Past ``MAX_ROWS`` = 8,192 rows, where a frame's p and sq alone fill a CTA's
shared memory, both entries run the same kernel body with the frame in
device memory (``_layout``): each CTA's p and sq, the adjacency words and
K8's labels in device-memory scratches, up to ``MAX_DEVICE_ROWS``.

Under ``dtype="float64"`` the jnp CC's adjacency is K8a's double build
(``motl_cc_adjacency_f64``, counted in ``cc_adjacency.launches_by``): the
JAX f64 ``_pairwise_adjacency`` under ``jax.jit`` spells its ops as the f32
program does (the 32-row tree sum, the FMA chains; ``fma64`` in the plain
version) and tests d2 against the f64 ``tol * tol``.  Its frame of 32-byte
rows stays in shared memory up to ``MAX_ROWS_F64`` = 4,096 rows.  K8 has
no double build: the JAX Pallas CC casts the points to f32, and
``connected_components_pallas`` does too.

Under ``dtype="bfloat16"`` and ``"float16"`` the jnp CC's adjacency is
K8a's half builds (``motl_cc_adjacency_bf16`` / ``_f16``, counted in
``cc_adjacency.launches_by``): the JAX half ``_pairwise_adjacency`` as
XLA's jitted CPU code computes it in ``bind_env``'s programs
(``cc_adjacency_half_plain``; the kernel reads the half rows and keeps the
f32 build's frame bounds).  K8 stays f32 under half, as the JAX Pallas CC
casts the points to f32.

- ``connected_components_pallas``: labels (min point index per component,
  M for invalid rows); K8 on CUDA tensors, ``..._plain`` on CPU tensors.
- ``cc_adjacency``: K8's adjacency stage alone (K8a, the same kernel body
  without the sweeps), as a bool (M, M) matrix; the jnp backend
  (``ops/cluster.py``) sweeps it, so both backends see the same d2 bits on
  the card.

Both take one frame, (M, 3), or S stacked frames, (S, M, 3), read bool or
uint8 masks and each frame's contiguous rows where they lie (no launch but
the kernel's), and count their launches in ``.launches``.
"""

from __future__ import annotations

import collections
import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.half import HALF
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype

BLOCK = 256         # cluster_pallas.py::_BLOCK: M % 256 == 0 for M > 256
TREE_WINDOW = 32    # XLA's CPU tree-reduction window
INVALID_SQ = 3e38   # squared norm of an invalid row: d2 > tol2 against all
MAX_ROWS = 8192     # the frame in shared memory: p and sq of 8,192 rows fill 128 KB of a CTA
MAX_ROWS_F64 = 4096  # the same in double (32 B a row)
MAX_DEVICE_ROWS = 65536  # the frame in device memory: K8a's bool (M, M) is then 4 GiB a frame
ROWS_PER_CTA = 64   # cc_layout: rows per CTA before the cluster grows (micro_torch_cc_segsum.py --sweep)
SMEM_BYTES = 232448  # what one H100 block may use (227 KB)
STATIC_SMEM = 2048   # the kernel's static shared arrays, rounded up


def check_rows(m: int) -> None:
    """The Pallas wrapper's shape rule, K8's alone (the jnp CC, whose
    adjacency K8a computes, takes any M)."""
    block = min(BLOCK, m)
    if m % block != 0:
        raise ValueError(f"M must be a multiple of {block}, got {m}")


def tol2_of(tol: float, dtype: torch.dtype) -> float:
    """The ``d2 <= tol2`` bound in ``dtype``, ``jnp.asarray(tol * tol,
    p.dtype)``: tol * tol computed in f64, rounded to f32 for f32."""
    return in_dtype(float(tol) * float(tol), dtype)


def max_rows(dtype: torch.dtype = torch.float32) -> int:
    """Rows whose frame a CTA holds in shared memory: ``MAX_ROWS``, or
    ``MAX_ROWS_F64`` for the double build."""
    return MAX_ROWS_F64 if dtype == torch.float64 else MAX_ROWS


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 fma(a, b, c) of f32 tensors, from f64 ops:
    a * b is exact in f64; the sum is rounded to odd (its rounding error,
    from TwoSum, decides the last bit), and rounding that to f32 is then
    exact (53 >= 24 + 2 bits)."""
    x = a.to(torch.float64) * b.to(torch.float64)
    y = c.to(torch.float64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    away = (err > 0) == (s > 0)                # one ulp up in magnitude
    bits = torch.where((err != 0) & even, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)


_SPLIT = 134217729.0   # 2^27 + 1: Veltkamp's splitter for a 53-bit significand


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e): s = a + b rounded, e its exact error (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """s (a rounded f64 sum) rounded to odd instead, given its exact error
    err: where inexact and its last bit even, one ulp toward the exact
    value (Boldo and Melquiond, "Emulation of FMA and correctly rounded
    sums: proved algorithms using rounding to odd", IEEE TC 2008)."""
    bits = s.view(torch.int64)
    even = (bits & 1) == 0
    away = (err > 0) == (s > 0)                # one ulp up in magnitude
    bits = torch.where((err != 0) & even, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64)


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f64 fma(a, b, c) of f64 tensors (PyTorch has no
    wider type): a * b = uh + ul exactly by Veltkamp's split and Dekker's
    product, c + uh = th + tl by TwoSum, then RN(th + RO(tl + ul)) -- the
    emulated FMA of Boldo and Melquiond, exact barring over- and underflow.
    K2, K3f and K4's double builds take ``__fma_rn`` where this stands."""
    a, b, c = (x.to(torch.float64) for x in (a, b, c))
    uh = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    ul = ((ah * bh - uh) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, uh)
    v, ve = _two_sum(tl, ul)
    return th + _round_odd(v, ve)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) in the tensors' dtype, as XLA's jitted CPU code computes
    the multiply-add it contracts: correctly rounded in f32 and f64
    (``fma32``, ``fma64``); in f16 the FMA rounded once to f16 (XLA's
    native f16 FMA; emulated in f64, where the
    product of two f16 values is exact); in bf16 no contraction at all --
    XLA rounds the product to bf16, then the sum (ops/half.py)."""
    if a.dtype == torch.float64:
        return fma64(a, b, c)
    if a.dtype == torch.float16:
        return (a.double() * b.double() + c.double()).to(torch.float16)
    if a.dtype == torch.bfloat16:
        return a * b + c
    return fma32(a, b, c)


def _tree_colsum(v: torch.Tensor) -> torch.Tensor:
    """(S, n, 3) -> (S, 3): XLA's CPU column sum, windows of 32 rows summed
    in order from +0.0 while more than 32 rows remain, then the rest in
    order."""
    while v.shape[1] > TREE_WINDOW:
        n = v.shape[1]
        nb = -(-n // TREE_WINDOW)
        pad = torch.zeros((v.shape[0], nb * TREE_WINDOW - n, 3), dtype=v.dtype, device=v.device)
        w = torch.cat([v, pad], dim=1).reshape(v.shape[0], nb, TREE_WINDOW, 3)
        a = torch.zeros_like(w[:, :, 0])
        for i in range(TREE_WINDOW):
            a = a + w[:, :, i]
        v = a
    a = torch.zeros_like(v[:, 0])
    for i in range(v.shape[1]):
        a = a + v[:, i]
    return a


def centred_rows(pts: torch.Tensor, mask: torch.Tensor):
    """(S, M, 3) f32 or f64, (S, M) bool -> (p (S, M, 3), sq (S, M)) of
    the points' dtype: K8's prep."""
    mf = mask.to(pts.dtype)
    cnt = torch.clamp(mf.sum(dim=1), min=1.0)
    c = _tree_colsum(pts * mf[..., None]) / cnt[:, None]
    p = (pts - c[:, None, :]) * mf[..., None]
    p0, p1, p2 = p.unbind(-1)
    sq = fma(p2, p2, fma(p1, p1, p0 * p0))
    return p, torch.where(mask, sq, INVALID_SQ)


def cc_adjacency_half_plain(pts: torch.Tensor, mask: torch.Tensor, tol: float) -> torch.Tensor:
    """(S, M, M) bool: the JAX half ``_pairwise_adjacency`` (ops/cluster.py:
    51-69) on bf16 / f16 rows, as XLA's CPU code computes it in the
    tracking step's compiled programs (K8a's half builds): the column sum
    of the rows times their 0/1 mask in f32 (the 32-row tree; the products
    are exact), rounded, divided by the count rounded to the dtype; p =
    (pts - c) rounded, 0 on invalid rows; sq the f32 sum of the squares
    (bf16: the exact products -- XLA drops their rounding; f16: each
    product rounded to f16) rounded once; the gram the f32 sum of the exact
    products in ascending order, rounded once; d2 = ((sq_i + sq_j) - 2
    gram), each op rounded; d2 <= tol * tol rounded to the dtype.  Invalid
    rows are adjacent to nothing."""
    dt = pts.dtype
    cnt = torch.clamp(mask.sum(dim=1), min=1).to(dt)
    tot = _tree_colsum(pts.float() * mask[..., None].float()).to(dt)
    c = tot / cnt[:, None]
    p = torch.where(mask[..., None], pts - c[:, None, :], torch.zeros((), dtype=dt))
    pf = p.float()
    sqs = (p * p).float() if dt == torch.float16 else pf * pf
    sq = ((sqs[..., 0] + sqs[..., 1]) + sqs[..., 2]).to(dt)
    pi, pj = pf[:, :, None, :], pf[:, None, :, :]
    g = ((pi[..., 0] * pj[..., 0] + pi[..., 1] * pj[..., 1]) + pi[..., 2] * pj[..., 2]).to(dt)
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * g
    return (d2 <= tol2_of(tol, dt)) & mask[:, :, None] & mask[:, None, :]


def cc_adjacency_plain(pts: torch.Tensor, mask: torch.Tensor, tol: float) -> torch.Tensor:
    """(S, M, M) bool: d2 <= tol2 with K8's float ops, in the points'
    dtype (f32, or f64 as K8a's double build; self pairs included; invalid
    rows adjacent to nothing)."""
    p, sq = centred_rows(pts, mask)
    pi, pj = p[:, :, None, :], p[:, None, :, :]
    g = fma(pi[..., 2], pj[..., 2], fma(pi[..., 1], pj[..., 1], pi[..., 0] * pj[..., 0]))
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * g
    return d2 <= tol2_of(tol, pts.dtype)


def jacobi_sweeps(adj: torch.Tensor, mask: torch.Tensor, n_sweeps: int):
    """The kernel's sweeps on a bool (S, M, M) adjacency: every row takes
    min(old, min of its neighbours' old labels), until nothing changed or
    after n_sweeps.  Returns (labels (S, M) int32, sweeps run)."""
    s, m = mask.shape
    lab = torch.where(mask, torch.arange(m, device=mask.device), m)
    it = 0
    while it < n_sweeps:
        nmin = torch.where(adj, lab[:, None, :], m).amin(dim=-1)
        new = torch.minimum(lab, nmin)
        it += 1
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break
    return lab.to(torch.int32), it


def _stack(pts, mask, keep_f64: bool = False):
    """(S, M, 3) points in f32 (f64 kept where ``keep_f64``), (S, M) bool
    mask, whether the input was one frame."""
    single = pts.dim() == 2
    if single:
        pts, mask = pts[None], mask[None]
    if not (keep_f64 and pts.dtype == torch.float64):
        pts = pts.to(torch.float32)
    return pts, mask.reshape(pts.shape[:2]) != 0, single


def connected_components_pallas_plain(pts, mask, tol: float, n_sweeps: int = 64,
                                      with_sweeps: bool = False):
    """Plain PyTorch version of K8: the same adjacency, the same sweeps."""
    p, m, single = _stack(pts, mask)
    check_rows(p.shape[1])
    labels, it = jacobi_sweeps(cc_adjacency_plain(p, m, tol), m, n_sweeps)
    labels = labels[0] if single else labels
    return (labels, it) if with_sweeps else labels


def cc_layout(m: int, device=None, dtype: torch.dtype = torch.float32) -> tuple[int, bool]:
    """(C, bits in shared memory) for frames of M rows: the fewest CTAs per
    frame, a power of two up to the card's cluster (``grid_cuda.max_cluster``,
    K2's query of the card), that
    give each CTA at most ``ROWS_PER_CTA`` rows and hold its rows' adjacency
    words in shared memory beside the frame's p and sq; where even the
    largest cluster cannot, the largest, with the words in a device-memory
    scratch.  Raises past ``max_rows(dtype)`` (8,192 rows, 4,096 in
    double), where p and sq alone fill a CTA's shared memory (``_layout``
    then puts the frame in device memory)."""
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import max_cluster

    top_rows = max_rows(dtype)
    if not 1 <= m <= top_rows:
        raise ValueError(f"K8 takes 1 to {top_rows} rows per frame in {dtype}, got M = {m}")
    top = max_cluster(device)
    c = 1
    while c < top and (-(-m // c) > ROWS_PER_CTA or not fits_smem(m, c, dtype)):
        c *= 2
    return c, fits_smem(m, c, dtype)


def fits_smem(m: int, c: int, dtype: torch.dtype = torch.float32) -> bool:
    """True iff a CTA of a C-CTA cluster holds its rows' adjacency words
    (ceil(M / C) rows of ceil(M / 32) + 1 u32, rounded to 8 bytes in
    double) beside the frame's p, sq and tree partials (4 M + 6 ceil(M /
    32) values of the points' dtype; or its two label buffers, which reuse
    them)."""
    nw = -(-m // 32)
    item = 8 if dtype == torch.float64 else 4
    region = max(item * (4 * m + 6 * nw), 8 * m)
    words = (nw + 1) * -(-m // c)
    if item == 8:
        words += words % 2
    return region + 4 * words <= SMEM_BYTES - STATIC_SMEM


def _frames(p: torch.Tensor):
    """(p, its frame stride in values): (S, M, 3) f32, f64, bf16 or f16
    rows, each frame's (M, 3) contiguous, as compact_points' views are; else
    a copy (other dtypes to f32)."""
    if p.dtype not in (torch.float32, torch.float64, *HALF):
        p = p.to(torch.float32)
    if p.stride(-1) != 1 or p.stride(-2) != 3:
        p = p.contiguous()
    return p, p.stride(0)


def _mask_frames(mask: torch.Tensor):
    """(mask as bytes, its frame stride): a bool or uint8 (S, M) read where
    it lies when each frame's row is contiguous (no launch)."""
    if mask.dtype not in (torch.bool, torch.uint8) or mask.stride(-1) != 1:
        mask = _build.byte_mask(mask)
    return mask, mask.stride(0)


def _layout(m: int, cluster: int | None, device,
            dtype: torch.dtype = torch.float32) -> tuple[int, bool, bool]:
    """(CTAs per frame, adjacency bits in shared memory, frame in device
    memory) for frames of M rows in ``dtype``: ``cc_layout``'s (or the
    ``cluster`` asked for) up to ``max_rows(dtype)``; past it the largest
    cluster (or the one asked for) with the frame and the bits in device
    memory.  Raises past ``MAX_DEVICE_ROWS``."""
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import max_cluster

    if not 1 <= m <= MAX_DEVICE_ROWS:
        raise ValueError(f"K8 takes 1 to {MAX_DEVICE_ROWS} rows per frame, got M = {m}")
    top = max_cluster(device)
    device_frame = m > max_rows(dtype)
    if cluster is None:
        return (top, False, True) if device_frame else (*cc_layout(m, device, dtype), False)
    if cluster not in (1, 2, 4, 8, 16) or cluster > top:
        raise ValueError(f"cluster must be a power of two up to {top}")
    return cluster, not device_frame and fits_smem(m, cluster, dtype), device_frame


def _launch(entry, pts, mask, tol, cluster, extra, outs):
    """One launch of a K8 entry on S frames: the layout, the inputs read
    where they lie, the adjacency scratch when it leaves shared memory, and
    the frame's scratch (each CTA's p, sq and partials, then K8's labels)
    when the frame does, in the points' dtype (f32, or f64 for K8a's double
    build)."""
    p = pts[None] if pts.dim() == 2 else pts
    s, m = p.shape[:2]
    mk = mask.reshape(s, m)
    p, pfs = _frames(p)
    work = torch.float32 if p.dtype in HALF else p.dtype     # the half builds stage f32
    cluster, in_smem, device_frame = _layout(m, cluster, p.device, work)
    mk, mfs = _mask_frames(mk)
    bits = frame = None
    if not in_smem:
        bits = torch.empty(s * cluster * (-(-m // 32) + 1) * -(-m // cluster), dtype=torch.int32,
                           device=p.device)
    if device_frame:
        frame = torch.empty(s * cluster * (4 * m + 6 * -(-m // 32)) + s * 2 * m,
                            dtype=work, device=p.device)
    err = getattr(_build.load(), entry)(
        p.data_ptr(), pfs, mk.data_ptr(), mfs, s, m, tol2_of(tol, p.dtype), *extra, cluster,
        *(None if b is None else b.data_ptr() for b in (bits, frame)),
        *(o.data_ptr() for o in outs), _build.stream_ptr(p.device),
    )
    _build.check(err, entry)


_ADJ_ENTRY = {torch.float64: "motl_cc_adjacency_f64", torch.bfloat16: "motl_cc_adjacency_bf16",
              torch.float16: "motl_cc_adjacency_f16"}


def cc_adjacency(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                 cluster: int | None = None) -> torch.Tensor:
    """K8's adjacency stage (K8a) on CUDA tensors, its plain version on CPU
    tensors: bool (M, M), or (S, M, M) for stacked frames.  f64 points take
    the double build (``.launches_by["motl_cc_adjacency_f64"]``), bf16 and
    f16 points the half builds (``motl_cc_adjacency_bf16`` / ``_f16``:
    ``cc_adjacency_half_plain``), any other dtype f32.  ``cluster``
    overrides ``cc_layout``'s CTAs per frame (for checks and sweeps)."""
    if pts.device.type == "cpu":
        if pts.dtype in HALF:
            single = pts.dim() == 2
            p = pts[None] if single else pts
            adj = cc_adjacency_half_plain(p, mask.reshape(p.shape[:2]) != 0, tol)
            return adj[0] if single else adj
        p, m, single = _stack(pts, mask, keep_f64=True)
        adj = cc_adjacency_plain(p, m, tol)
        return adj[0] if single else adj
    s, n = (1,) + pts.shape[:1] if pts.dim() == 2 else pts.shape[:2]
    adj = torch.empty((s, n, n), dtype=torch.bool, device=pts.device)
    entry = _ADJ_ENTRY.get(pts.dtype, "motl_cc_adjacency")
    _launch(entry, pts, mask, tol, cluster, (), (adj,))
    _build.count(cc_adjacency, entry, "motl_cc_adjacency")
    return adj[0] if pts.dim() == 2 else adj


cc_adjacency.launches = 0                   # the f32 build's
cc_adjacency.launches_by = collections.Counter()   # by C entry


def connected_components_pallas(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                                n_sweeps: int = 64, with_sweeps: bool = False,
                                cluster: int | None = None):
    """Labels (M,) or (S, M) int32: the min point index of each component
    after at most ``n_sweeps`` Jacobi sweeps, M for invalid rows.  K8 on
    CUDA tensors (one launch), its plain version on CPU tensors.
    ``with_sweeps`` also returns the sweeps run (the largest over frames; a
    host read).  ``cluster`` overrides ``cc_layout``'s CTAs per frame.
    f64, bf16 and f16 points are taken to f32 first, as the JAX Pallas CC
    casts them (cluster_pallas.py:132): K8 has no double or half build."""
    if pts.device.type == "cpu":
        return connected_components_pallas_plain(pts, mask, tol, n_sweeps, with_sweeps)
    if pts.dtype != torch.float32:
        pts = pts.to(torch.float32)
    s, n = (1,) + pts.shape[:1] if pts.dim() == 2 else pts.shape[:2]
    check_rows(n)
    labels = torch.empty((s, n), dtype=torch.int32, device=pts.device)
    sweeps = torch.empty((s,), dtype=torch.int32, device=pts.device)
    _launch("motl_cc_labels", pts, mask, tol, cluster, (int(n_sweeps),), (labels, sweeps))
    connected_components_pallas.launches += 1
    labels = labels[0] if pts.dim() == 2 else labels
    return (labels, int(sweeps.max())) if with_sweeps else labels


connected_components_pallas.launches = 0
