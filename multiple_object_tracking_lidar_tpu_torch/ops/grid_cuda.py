"""K2: fused voxel finalize + per-cell static drop + dense-grid CC.

Replaces the Pallas kernels ``multiple_object_tracking_lidar_tpu/ops/
grid_pallas.py::fused_finalize_static_cc`` and
``fused_finalize_static_cc_stacked`` (one CUDA kernel, one CTA per frame;
the single-frame call is S = 1).  CUDA source: ``csrc/grid_cc.cu``, whose
header says what bounds it on the H100 (shared memory: labels and the
packed adjacency words stay resident, 4 * (2 + n_words) bytes per cell)
and how its design answers that.

Labels are the minimum flat cell index per component (``n_cells`` for
cells that are not dynamic) -- the fixpoint every sweep schedule reaches,
so they equal the JAX kernel's and its jnp stencil twin's.  Each iteration
is one Jacobi min-label sweep plus one pointer jump; the plain PyTorch
version runs the same schedule, so it reports the same iteration count
(``n_sweeps``) and ``saturated`` flag as the kernel.

``fused_finalize_static_cc_stacked`` launches the kernel for CUDA tensors
and runs the plain version for CPU tensors; ``.launches`` counts kernel
launches.
"""

from __future__ import annotations

import functools

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
    _stencil_offsets,
    neighbor_index,
)

SMEM_BYTES = 232448       # what one H100 block may use (227 KB)
_STATIC_SMEM = 4096       # the kernel's static shared arrays, rounded up
MAX_OFFSETS = 128         # 4 packed adjacency words per cell


def kernel_offsets(dims, tol: float, leaf_xy: float, leaf_z: float):
    """The stencil offsets (dz, dy, dx) that fit the grid, as the JAX
    kernel filters them (grid_pallas.py:324-328)."""
    gx, gy, gz = dims
    return tuple(
        o
        for o in _stencil_offsets(tol, leaf_xy, leaf_z)
        if abs(o[0]) < gz and abs(o[1]) < gy and abs(o[2]) < gx
    )


def max_kernel_cells(n_offsets: int) -> int:
    """Largest grid K2 holds in one CTA's shared memory: two int32 label
    buffers plus ceil(n_offsets / 32) adjacency words per cell.  This
    replaces the TPU's VMEM-derived MAX_KERNEL_CELLS = 32768: 19,029 cells
    with <= 32 offsets (the 0.1 m headline grid has 5,500 and 24), 11,417
    with 74 (a 2-slab grid)."""
    n_words = (n_offsets + 31) // 32
    return (SMEM_BYTES - _STATIC_SMEM) // (4 * (2 + n_words))


def fused_cc_fits(n_cells: int, n_offsets: int) -> bool:
    return n_offsets <= MAX_OFFSETS and n_cells <= max_kernel_cells(n_offsets)


def make_scal(env, tol: float, device) -> torch.Tensor:
    """(6,) f32 [origin_x, origin_y, cos, sin, inv_res, tol^2] on device."""
    vals = [env.origin_x, env.origin_y, env.cos_nyaw, env.sin_nyaw, env.inv_resolution]
    scal = torch.stack([v.to(torch.float32).reshape(()) for v in vals] +
                       [torch.tensor(tol * tol, dtype=torch.float32, device=vals[0].device)])
    return scal.to(device)


@functools.lru_cache(maxsize=16)
def _device_offsets(offsets: tuple, device: str) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int32, device=device).reshape(-1, 3)


def fused_finalize_static_cc_stacked_plain(
    accs, scal, base_row, base_col, bits, *, dims, offsets, kwin, max_sweeps
):
    """Plain PyTorch version of K2, same arithmetic order and schedule."""
    gx, gy, gz = dims
    n = gx * gy * gz
    s = accs.shape[0]
    dev = accs.device
    accs = accs.to(torch.float32)
    cnt = accs[:, 3]
    cent = accs[:, :3] / torch.clamp(cnt, min=1.0)[:, None, :]
    ox, oy, cosv, sinv, invr, tol2 = (scal[q] for q in range(6))
    xm = cent[:, 0] - ox
    ym = cent[:, 1] - oy
    col = ((cosv * xm - sinv * ym) * invr).to(torch.int32)
    row = ((sinv * xm + cosv * ym) * invr).to(torch.int32)
    qr = row - base_row
    qc = col - base_col
    in_win = (qr >= 0) & (qr < kwin) & (qc >= 0) & (qc < kwin)
    bit = (bits >> torch.clamp(qr * kwin + qc, 0, kwin * kwin - 1)) & 1
    dyn = (cnt > 0.0) & (torch.where(in_win, bit, 1) == 0)

    nb = neighbor_index(dims, offsets, dev)                              # (O, n)
    valid_nb = nb < n
    nb_c = torch.clamp(nb, max=n - 1)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    labels = torch.empty((s, n), dtype=torch.int32, device=dev)
    n_sw = torch.empty((s,), dtype=torch.int32, device=dev)
    sat = torch.empty((s,), dtype=torch.int32, device=dev)
    sentinel = torch.tensor(n, dtype=torch.int32, device=dev)
    for f in range(s):
        c = cent[f]
        d = [c[a][None, :] - c[a][nb_c] for a in range(3)]           # (O, n)
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        adj = dyn[f][None, :] & valid_nb & dyn[f][nb_c] & (d2 <= tol2)
        lab = torch.where(dyn[f], idx, sentinel)
        it, changed = 0, True
        while changed and it < max_sweeps:
            cand = torch.where(adj, lab[nb_c], sentinel)
            b = torch.minimum(lab, cand.min(dim=0).values) if len(offsets) else lab
            b_pad = torch.cat([b, sentinel.reshape(1)])
            new = b_pad[b.long()]                                    # pointer jump
            changed = bool((new != lab).any())
            lab = new
            it += 1
        labels[f] = lab
        n_sw[f] = it
        sat[f] = int(changed and it >= max_sweeps)
    return cent, dyn, labels, n_sw, sat


def fused_finalize_static_cc_stacked(
    accs_cm: torch.Tensor,   # (S, 4, n_cells) f32 channel-major accumulators
    scal: torch.Tensor,      # (6,) f32 (make_scal)
    base_row: torch.Tensor,  # (n_cells,) i32
    base_col: torch.Tensor,
    bits: torch.Tensor,
    *,
    dims: tuple[int, int, int],
    tol: float,
    leaf_xy: float,
    leaf_z: float,
    kwin: int,
    max_sweeps: int | None = None,
):
    """Returns (cent (S, 3, n) f32, dyn (S, n) bool, labels (S, n) i32,
    n_sweeps (S,) i32, saturated (S,) i32).  ``max_sweeps=None`` caps the
    iterations at the grid-diameter bound 2 (gx + gy + gz)."""
    gx, gy, gz = dims
    n = gx * gy * gz
    if max_sweeps is None:
        max_sweeps = 2 * (gx + gy + gz)
    offsets = kernel_offsets(dims, tol, leaf_xy, leaf_z)
    if accs_cm.device.type == "cpu":
        return fused_finalize_static_cc_stacked_plain(
            accs_cm, scal, base_row, base_col, bits,
            dims=dims, offsets=offsets, kwin=kwin, max_sweeps=max_sweeps,
        )
    s = accs_cm.shape[0]
    dev = accs_cm.device
    if accs_cm.shape != (s, 4, n) or accs_cm.dtype != torch.float32:
        raise ValueError(f"accs must be (S, 4, {n}) float32, got {tuple(accs_cm.shape)} {accs_cm.dtype}")
    for name, t in (("base_row", base_row), ("base_col", base_col), ("bits", bits)):
        if t.shape != (n,) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be ({n},) int32 on {dev}")
    if scal.shape != (6,) or scal.dtype != torch.float32 or scal.device != dev:
        raise ValueError(f"scal must be (6,) float32 on {dev}")
    if not fused_cc_fits(n, len(offsets)):
        raise ValueError(
            f"{n} grid cells with {len(offsets)} stencil offsets exceed K2's "
            f"shared-memory residency ({max_kernel_cells(len(offsets))} cells); "
            "a multi-CTA global-memory variant is still to be ported (ROADMAP)"
        )
    accs_cm = accs_cm.contiguous()
    offs = _device_offsets(offsets, str(dev))
    cent = torch.empty((s, 3, n), dtype=torch.float32, device=dev)
    dyn = torch.empty((s, n), dtype=torch.bool, device=dev)
    labels = torch.empty((s, n), dtype=torch.int32, device=dev)
    nsw = torch.empty((s, 2), dtype=torch.int32, device=dev)
    lib = _build.load()
    err = lib.motl_grid_cc(
        accs_cm.data_ptr(), base_row.contiguous().data_ptr(),
        base_col.contiguous().data_ptr(), bits.contiguous().data_ptr(),
        offs.data_ptr(), len(offsets), scal.data_ptr(), s, gx, gy, gz, kwin,
        max_sweeps, cent.data_ptr(), dyn.data_ptr(), labels.data_ptr(),
        nsw.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, "motl_grid_cc")
    fused_finalize_static_cc_stacked.launches += 1
    return cent, dyn, labels, nsw[:, 0], nsw[:, 1]


fused_finalize_static_cc_stacked.launches = 0


def fused_finalize_static_cc(acc_cm, scal, base_row, base_col, bits, **kw):
    """Single-frame form: (cent (3, n), dyn (n,), labels (n,), n_sweeps,
    saturated) -- the stacked kernel with S = 1."""
    out = fused_finalize_static_cc_stacked(
        acc_cm[None], scal, base_row, base_col, bits, **kw
    )
    return tuple(o[0] for o in out)
