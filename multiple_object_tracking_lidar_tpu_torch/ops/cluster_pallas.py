"""K8: all-pairs fixed-radius connected components over the point list.

Replaces the Pallas kernel ``multiple_object_tracking_lidar_tpu/ops/
cluster_pallas.py::connected_components_pallas`` (``cluster_backend=
"pallas"``).  CUDA source: ``csrc/cluster_cc.cu``, whose header says what
bounds it on the H100 (the serial sweeps, each reading the whole M x M
adjacency) and how its design answers that (the adjacency, fixed across
sweeps, is built once as a bitmask by M * M / 32 threads; one CTA per frame
sweeps it from L2 with labels in shared memory and an early exit).

The float ops are those XLA's CPU code gives the interpret-mode kernel:
the centre is a tree-ordered column sum (windows of 32 rows), and the
squared norms and the gram are FMA chains, ``fma(p2, q2, fma(p1, q1,
p0 * q0))``; d2 = (sq_i + sq_j) - 2 * gram.  The plain version computes
each FMA exactly from f64 ops (``fma32``), so the adjacency -- and so the
labels, cut-short sweeps included -- is the interpret-mode kernel's.

- ``connected_components_pallas``: labels (min point index per component,
  M for invalid rows); K8 on CUDA tensors, ``..._plain`` on CPU tensors.
- ``cc_adjacency``: K8's adjacency stage alone, as a bool (M, M) matrix;
  the jnp backend (``ops/cluster.py``) sweeps it, so both backends see the
  same d2 bits on the card.

Both take one frame, (M, 3), or S stacked frames, (S, M, 3), and count
their launches in ``.launches``.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import f32

BLOCK = 256         # cluster_pallas.py::_BLOCK: M % 256 == 0 for M > 256
TREE_WINDOW = 32    # XLA's CPU tree-reduction window
INVALID_SQ = 3e38   # squared norm of an invalid row: d2 > tol2 against all


def check_rows(m: int) -> None:
    """The Pallas wrapper's shape rule."""
    block = min(BLOCK, m)
    if m % block != 0:
        raise ValueError(f"M must be a multiple of {block}, got {m}")


def tol2_f32(tol: float) -> float:
    """f32(tol * tol computed in f64), as the kernel's ``d2 <= tol2``."""
    return f32(float(tol) * float(tol))


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
    """(S, M, 3) f32, (S, M) bool -> (p (S, M, 3), sq (S, M)): K8's prep."""
    mf = mask.to(torch.float32)
    cnt = torch.clamp(mf.sum(dim=1), min=1.0)
    c = _tree_colsum(pts * mf[..., None]) / cnt[:, None]
    p = (pts - c[:, None, :]) * mf[..., None]
    p0, p1, p2 = p.unbind(-1)
    sq = fma32(p2, p2, fma32(p1, p1, p0 * p0))
    return p, torch.where(mask, sq, INVALID_SQ)


def cc_adjacency_plain(pts: torch.Tensor, mask: torch.Tensor, tol: float) -> torch.Tensor:
    """(S, M, M) bool: d2 <= tol2 with K8's float ops (self pairs
    included; invalid rows adjacent to nothing)."""
    p, sq = centred_rows(pts, mask)
    pi, pj = p[:, :, None, :], p[:, None, :, :]
    g = fma32(pi[..., 2], pj[..., 2], fma32(pi[..., 1], pj[..., 1], pi[..., 0] * pj[..., 0]))
    d2 = (sq[:, :, None] + sq[:, None, :]) - 2.0 * g
    return d2 <= tol2_f32(tol)


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


def _stack(pts, mask):
    single = pts.dim() == 2
    if single:
        pts, mask = pts[None], mask[None]
    return pts.to(torch.float32), mask.reshape(pts.shape[:2]) != 0, single


def connected_components_pallas_plain(pts, mask, tol: float, n_sweeps: int = 64,
                                      with_sweeps: bool = False):
    """Plain PyTorch version of K8: the same adjacency, the same sweeps."""
    p, m, single = _stack(pts, mask)
    check_rows(p.shape[1])
    labels, it = jacobi_sweeps(cc_adjacency_plain(p, m, tol), m, n_sweeps)
    labels = labels[0] if single else labels
    return (labels, it) if with_sweeps else labels


def _launch(entry, p, m, tol, extra, outs):
    s, n = m.shape
    dev = p.device
    pc = p.contiguous()
    m8 = m.to(torch.uint8).contiguous()
    prow = torch.empty((s, n, 3), dtype=torch.float32, device=dev)
    sq = torch.empty((s, n), dtype=torch.float32, device=dev)
    bits = torch.empty((s, -(-n // 32), n), dtype=torch.int32, device=dev)
    err = getattr(_build.load(), entry)(
        pc.data_ptr(), m8.data_ptr(), s, n, tol2_f32(tol), *extra, prow.data_ptr(),
        sq.data_ptr(), bits.data_ptr(), *(o.data_ptr() for o in outs),
        _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    return bits


def unpack_bits(bits: torch.Tensor, m: int) -> torch.Tensor:
    """K8's (S, ceil(M / 32), M) words -> bool (S, M, M): bit b of word
    [s, w, i] is the pair (i, 32 w + b)."""
    s, nw, _ = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int32)
    b = (bits.permute(0, 2, 1)[..., None] >> shifts) & 1        # (S, M, W, 32)
    return b.reshape(s, m, nw * 32)[..., :m].to(torch.bool)


def cc_adjacency(pts: torch.Tensor, mask: torch.Tensor, tol: float) -> torch.Tensor:
    """K8's adjacency stage on CUDA tensors, its plain version on CPU
    tensors: bool (M, M), or (S, M, M) for stacked frames."""
    p, m, single = _stack(pts, mask)
    if p.device.type == "cpu":
        adj = cc_adjacency_plain(p, m, tol)
    else:
        bits = _launch("motl_cc_adjacency", p, m, tol, (), ())
        cc_adjacency.launches += 1
        adj = unpack_bits(bits, m.shape[1])
    return adj[0] if single else adj


cc_adjacency.launches = 0


def connected_components_pallas(pts: torch.Tensor, mask: torch.Tensor, tol: float,
                                n_sweeps: int = 64, with_sweeps: bool = False):
    """Labels (M,) or (S, M) int32: the min point index of each component
    after at most ``n_sweeps`` Jacobi sweeps, M for invalid rows.  K8 on
    CUDA tensors, its plain version on CPU tensors.  ``with_sweeps`` also
    returns the sweeps run (the largest over frames)."""
    if pts.device.type == "cpu":
        return connected_components_pallas_plain(pts, mask, tol, n_sweeps, with_sweeps)
    p, m, single = _stack(pts, mask)
    s, n = m.shape
    check_rows(n)
    labels = torch.empty((s, n), dtype=torch.int32, device=p.device)
    sweeps = torch.empty((s,), dtype=torch.int32, device=p.device)
    _launch("motl_cc_labels", p, m, tol, (int(n_sweeps),), (labels, sweeps))
    connected_components_pallas.launches += 1
    labels = labels[0] if single else labels
    return (labels, int(sweeps.max())) if with_sweeps else labels


connected_components_pallas.launches = 0
