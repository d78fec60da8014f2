"""K2: fused voxel finalize + per-cell static drop + dense-grid CC.

Replaces the Pallas kernels ``multiple_object_tracking_lidar_tpu/ops/
grid_pallas.py::fused_finalize_static_cc`` and
``fused_finalize_static_cc_stacked`` (one CUDA kernel, one thread-block
cluster of 1-16 CTAs per frame; the single-frame call is S = 1).  CUDA
source: ``csrc/grid_cc.cu``, whose header says what bounds it on the H100
(latency, and shared memory: labels and the packed adjacency words stay
resident, 4 * (2 + n_words) bytes per cell, split over the cluster's
CTAs) and how its design answers that.  ``cluster_size`` picks the CTAs
per frame from the cell count.

Labels are the minimum flat cell index per component (``n_cells`` for
cells that are not dynamic) -- the fixpoint every sweep schedule reaches,
so they equal the JAX kernel's and its jnp stencil twin's.  Each iteration
is one Jacobi min-label sweep plus one pointer jump; the plain PyTorch
version runs the same schedule, so it reports the same iteration count
(``n_sweeps``) and ``saturated`` flag as the kernel.

``fused_finalize_static_cc_stacked`` launches the kernel for CUDA tensors
and runs the plain version for CPU tensors; ``.launches`` counts the f32
build's launches and ``.launches_by`` every build's by C entry: its double
build (``dtype="float64"``: the f64 accumulator, centroids and d^2,
``motl_grid_cc_f64``) and the double build fed f32 sums
(``voxel_mode="runs"`` under f64: K7's f32 accumulator finalized in f32,
the centroid widened, then the f64 d^2; ``motl_grid_cc_f64_f32sums``),
the half builds (``motl_grid_cc_bf16`` / ``_f16``) and the half builds fed
f32 sums (``voxel_mode="runs"`` under bf16 / f16: K7's f32 accumulator
finalized in f32, the static drop on that centroid, the centroid rounded
for the half d^2; ``motl_grid_cc_bf16_f32sums`` / ``_f16_f32sums``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
    _stencil_offsets,
    neighbor_index,
)
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype

SMEM_BYTES = 232448       # what one H100 block may use (227 KB)
_STATIC_SMEM = 5120       # the kernel's static shared arrays, rounded up
MAX_OFFSETS = 256         # 8 packed adjacency words per cell
MAX_CLUSTER = 16          # CTAs per frame: the H100's non-portable cluster size
# Cluster size rule (``cluster_size``): the fewest CTAs whose ranges fit
# their shared memory and hold at most this many cells each.  On an H100
# (700 W), scripts/micro_torch_grid_cc.py timed the headline's 5,500 cells
# at 87.9, 57.7, 44.7, 33.6 and 58.6 us per S = 8 launch for 1, 2, 4, 8 and
# 16 CTAs per frame: the sweeps' latency falls with the cells per CTA down
# to ~700, and 16 x 8 CTAs no longer run at once.
CELLS_PER_CTA = 1024
# cells one CTA holds with only its two label buffers in shared memory
LABEL_CELLS = (SMEM_BYTES - _STATIC_SMEM) // 8


def kernel_offsets(dims, tol: float, leaf_xy: float, leaf_z: float):
    """The stencil offsets (dz, dy, dx) that fit the grid, as the JAX
    kernel filters them (grid_pallas.py:324-328)."""
    gx, gy, gz = dims
    return tuple(
        o
        for o in _stencil_offsets(tol, leaf_xy, leaf_z)
        if abs(o[0]) < gz and abs(o[1]) < gy and abs(o[2]) < gx
    )


def cta_cells(n_offsets: int) -> int:
    """Cells one CTA holds in shared memory: two int32 label buffers plus
    ceil(n_offsets / 32) adjacency words per cell -- 18,944 with <= 32
    offsets (the 0.1 m headline grid has 5,500 cells and 24 offsets),
    8,118 with 146 (a 0.05 m leaf over three z slabs)."""
    n_words = (n_offsets + 31) // 32
    return (SMEM_BYTES - _STATIC_SMEM) // (4 * (2 + n_words))


@functools.lru_cache(maxsize=8)
def _device_max_cluster(index: int) -> int:
    out = ctypes.c_int(0)
    _build.check(_build.load().motl_grid_cc_max_cluster(SMEM_BYTES - _STATIC_SMEM,
                                                        ctypes.addressof(out)),
                 "motl_grid_cc_max_cluster")
    return out.value


def max_cluster(device=None) -> int:
    """The most CTAs a frame's cluster may take: on a CUDA device, what
    ``cudaOccupancyMaxActiveClusters`` grants at a full CTA's shared memory
    (16 on the H100, with the non-portable size allowed); elsewhere the
    H100's 16."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return MAX_CLUSTER
    return _device_max_cluster(dev.index if dev.index is not None else torch.cuda.current_device())


def max_kernel_cells(n_offsets: int, device=None) -> int:
    """Largest grid K2 holds: a full cluster of CTAs, each with its range's
    labels in shared memory (its adjacency words too where they fit, else
    in a global scratch) -- 454,656 cells at 16 CTAs, whatever the
    offsets.  This replaces the TPU's VMEM-derived MAX_KERNEL_CELLS =
    32768."""
    return max_cluster(device) * LABEL_CELLS


def fused_cc_fits(n_cells: int, n_offsets: int, device=None) -> bool:
    return n_offsets <= MAX_OFFSETS and n_cells <= max_kernel_cells(n_offsets, device)


def cluster_size(n_cells: int, n_offsets: int, device=None) -> int:
    """CTAs per frame for a grid of ``n_cells``: the smallest power of two
    whose ranges of ceil(n_cells / C) cells fit one CTA's shared memory,
    adjacency words included, and hold at most ``CELLS_PER_CTA`` cells;
    where no cluster holds the adjacency words, the largest (its labels in
    shared memory, the words in a global scratch: ``adjacency_in_smem``)."""
    top = max_cluster(device)
    per = min(cta_cells(n_offsets), CELLS_PER_CTA)
    c = 1
    while c < top and -(-n_cells // c) > per:
        c *= 2
    return c


def adjacency_in_smem(n_cells: int, n_offsets: int, cluster: int) -> bool:
    """True iff a CTA's range of ceil(n_cells / cluster) cells keeps its
    adjacency words in shared memory beside its labels."""
    return -(-n_cells // cluster) <= cta_cells(n_offsets)


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
    accs, scal, base_row, base_col, bits, *, dims, offsets, kwin, max_sweeps, tol=None,
    dtype=None,
):
    """Plain PyTorch version of K2, same arithmetic order and schedule:
    each iteration is one Jacobi sweep over every cell from the labels of
    the last iteration, then one pointer jump, then the vote.  The kernel
    runs this global schedule at every cluster size (its ranks read each
    other's labels through distributed shared memory), so one plain
    version stands for them all.  An f64 ``accs`` is the double build's:
    the centroids in f64, the map transform on them rounded to f32, and
    d^2 = fma(dz, dz, fma(dx, dx, dy * dy)) against the f64 ``tol * tol``
    (``tol`` required), as the JAX package's f64 route computes them.
    ``dtype=torch.float64`` on f32 ``accs`` is the build fed f32 sums: the
    centroids finalized in f32, then widened, the rest as the double
    build's; a half ``dtype`` on f32 ``accs`` the half build fed f32 sums
    (the half runs grid): the f32 finalize, the static drop on the f32
    centroid, the centroid rounded to the half dtype for the half d^2."""
    gx, gy, gz = dims
    n = gx * gy * gz
    s = accs.shape[0]
    dev = accs.device
    out_dtype = dtype or accs.dtype
    f64 = out_dtype == torch.float64
    # the half builds: the JAX half route's finalize (an f32 division of
    # the half sums, rounded), its stencil d^2 in the half dtype (ops/
    # cluster_pallas.py::fma) against tol * tol rounded to it
    half = out_dtype in (torch.bfloat16, torch.float16)
    f32_sums = accs.dtype == torch.float32
    if accs.dtype != torch.float64:
        accs = accs.to(torch.float32)
    cnt = accs[:, 3]
    c_acc = accs[:, :3] / torch.clamp(cnt, min=1.0)[:, None, :]     # the finalize, in f32 or f64
    cent = c_acc.to(out_dtype)
    ox, oy, cosv, sinv, invr, tol2 = (scal[q] for q in range(6))
    if f64 or half:
        tol2 = torch.tensor(in_dtype(float(tol) * float(tol), out_dtype), dtype=out_dtype,
                            device=dev)
    # the static drop reads the finalized centroid: f32 sums' f32 one, else
    # the output's, rounded to f32
    c_map = c_acc if f32_sums else cent.to(torch.float32)
    xm = c_map[:, 0] - ox
    ym = c_map[:, 1] - oy
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
        adj = dyn[f][None, :] & valid_nb & dyn[f][nb_c]                  # (O, n)
        if f64 or half:     # the emulated FMAs on the pairs of dynamic cells alone
            pair = adj.nonzero(as_tuple=True)
            d = [c[a][pair[1]] - c[a][nb_c[pair]] for a in range(3)]
            adj[pair] = fma(d[2], d[2], fma(d[0], d[0], d[1] * d[1])) <= tol2
        else:
            d = [c[a][None, :] - c[a][nb_c] for a in range(3)]
            adj &= ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) <= tol2
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


# (accumulator dtype, centroid dtype) -> the C entry
_BUILDS = {(torch.float32, torch.float32): "motl_grid_cc",
           (torch.float64, torch.float64): "motl_grid_cc_f64",
           (torch.float32, torch.float64): "motl_grid_cc_f64_f32sums",
           (torch.float32, torch.bfloat16): "motl_grid_cc_bf16_f32sums",
           (torch.float32, torch.float16): "motl_grid_cc_f16_f32sums",
           (torch.bfloat16, torch.bfloat16): "motl_grid_cc_bf16",
           (torch.float16, torch.float16): "motl_grid_cc_f16"}


def fused_finalize_static_cc_stacked(
    accs_cm: torch.Tensor,   # (S, 4, n_cells) f32, f64, bf16 or f16 channel-major sums
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
    cluster: int | None = None,
    dtype: torch.dtype | None = None,
):
    """Returns (cent (S, 3, n) of ``dtype`` (by default the accumulators'),
    dyn (S, n) bool, labels (S, n) i32, n_sweeps (S,) i32, saturated (S,)
    i32).  An f64 accumulator launches the double build
    (``motl_grid_cc_f64``, one launch too), a bf16 / f16 one the half
    build (``motl_grid_cc_bf16`` / ``_f16``: the JAX half route's finalize,
    static drop and stencil CC); an f32 one with
    ``dtype=torch.float64`` the double build fed f32 sums
    (``motl_grid_cc_f64_f32sums``), and with a half ``dtype`` the half
    build fed f32 sums (``motl_grid_cc_bf16_f32sums`` / ``_f16_f32sums``:
    the half runs grid).  ``max_sweeps=None`` caps the
    iterations at the grid-diameter bound 2 (gx + gy + gz); ``cluster=None`` takes ``cluster_size``'s CTAs
    per frame (any size gives the same results; the plain version on a CPU
    tensor has no CTAs and ignores it)."""
    gx, gy, gz = dims
    n = gx * gy * gz
    if max_sweeps is None:
        max_sweeps = 2 * (gx + gy + gz)
    offsets = kernel_offsets(dims, tol, leaf_xy, leaf_z)
    dev = accs_cm.device
    if accs_cm.device.type == "cpu":
        return fused_finalize_static_cc_stacked_plain(
            accs_cm, scal, base_row, base_col, bits,
            dims=dims, offsets=offsets, kwin=kwin, max_sweeps=max_sweeps, tol=tol, dtype=dtype,
        )
    if cluster is None:
        cluster = cluster_size(n, len(offsets), dev)
    s = accs_cm.shape[0]
    dt = dtype or accs_cm.dtype
    if (accs_cm.shape != (s, 4, n) or (accs_cm.dtype, dt) not in _BUILDS):
        raise ValueError(f"accs must be (S, 4, {n}) float32, float64, bfloat16 or float16 and "
                         f"dtype the same (or float64, bfloat16, float16 on float32 sums), got "
                         f"{tuple(accs_cm.shape)} {accs_cm.dtype} -> {dt}")
    for name, t in (("base_row", base_row), ("base_col", base_col), ("bits", bits)):
        if t.shape != (n,) or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be ({n},) int32 on {dev}")
    if scal.shape != (6,) or scal.dtype != torch.float32 or scal.device != dev:
        raise ValueError(f"scal must be (6,) float32 on {dev}")
    if cluster not in (1, 2, 4, 8, 16) or cluster > max_cluster(dev):
        raise ValueError(f"cluster must be a power of two <= {max_cluster(dev)}, got {cluster}")
    rng = -(-n // cluster)
    if len(offsets) > MAX_OFFSETS or rng > LABEL_CELLS:
        raise ValueError(
            f"{n} grid cells with {len(offsets)} stencil offsets exceed K2's "
            f"shared-memory residency ({LABEL_CELLS} cells' labels per CTA, "
            f"{cluster} CTAs; at most {max_kernel_cells(len(offsets), dev)} cells "
            f"and {MAX_OFFSETS} offsets)"
        )
    accs_cm = accs_cm.contiguous()
    offs = _device_offsets(offsets, str(dev))
    cent = torch.empty((s, 3, n), dtype=dt, device=dev)
    dyn = torch.empty((s, n), dtype=torch.bool, device=dev)
    labels = torch.empty((s, n), dtype=torch.int32, device=dev)
    nsw = torch.empty((s, 2), dtype=torch.int32, device=dev)
    ins = [t.contiguous() for t in (base_row, base_col, bits)]
    n_words = (len(offsets) + 31) // 32
    scratch = (None if adjacency_in_smem(n, len(offsets), cluster) else
               torch.empty((s * cluster * n_words * rng,), dtype=torch.int32, device=dev))
    lib = _build.load()
    entry = _BUILDS[accs_cm.dtype, dt]
    tol2 = ((in_dtype(float(tol) * float(tol), dt),)
            if dt in (torch.float64, torch.bfloat16, torch.float16) else ())
    err = getattr(lib, entry)(
        accs_cm.data_ptr(), *(t.data_ptr() for t in ins),
        offs.data_ptr(), len(offsets), scal.data_ptr(), *tol2, s, gx, gy, gz, kwin,
        max_sweeps, cluster, None if scratch is None else scratch.data_ptr(),
        cent.data_ptr(), dyn.data_ptr(), labels.data_ptr(), nsw.data_ptr(),
        _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    _build.count(fused_finalize_static_cc_stacked, entry, "motl_grid_cc")
    return cent, dyn, labels, nsw[:, 0], nsw[:, 1]


fused_finalize_static_cc_stacked.launches = 0                   # the f32 build's
fused_finalize_static_cc_stacked.launches_by = collections.Counter()   # by C entry


def fused_finalize_static_cc(acc_cm, scal, base_row, base_col, bits, **kw):
    """Single-frame form: (cent (3, n), dyn (n,), labels (n,), n_sweeps,
    saturated) -- the stacked kernel with S = 1."""
    out = fused_finalize_static_cc_stacked(
        acc_cm[None], scal, base_row, base_col, bits, **kw
    )
    return tuple(o[0] for o in out)
