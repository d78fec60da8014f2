"""K14: the dense grid's stencil connected components on the card.

The JAX package's ``ops/cluster_grid.py::connected_components_grid`` (:60)
is jnp inside its jitted step (no TPU kernel: its fused Pallas CC, K2's
counterpart, stops at 32,768 cells).  The port runs it where K2 does not:
``grid_cc="jnp"``, a map with no per-cell static table (the vmap fleet),
and every grid past K2's 454,656 cells (a 30 m floor at the 0.05 m leaf
is 1,119,963).  CUDA source: ``csrc/stencil_cc.cu``, whose header says
what bounds it (latency: barrier-separated passes over a frame's few
thousand dynamic cells) and how its design answers that (one thread-block
cluster of ``cluster_size`` CTAs per frame: the flags read in 16-byte
chunks and the dynamic cells listed across the cluster, one warp per
cell's adjacency words, the Jacobi passes split over the CTAs with a
cluster barrier between them and the frame's loop ending on a vote in
distributed shared memory: one launch, no host sync).  Built for f32 and
f64 centroids.

``stencil_cc`` launches the kernel for CUDA tensors and runs
``stencil_cc_plain`` for CPU tensors; ``.launches_by`` counts launches by
C entry (``motl_stencil_cc``, ``motl_stencil_cc_f64``) and ``.launches``
those of the f32 build.  ``stencil_cc_plain`` is the same schedule in
torch: ``max_iters`` trips, each frame's own loop kept by an active mask,
as under ``jax.vmap``; the neighbour reads one offset at a time from the
labels padded and sliced (the JAX package's pad-and-slice), 32 offsets at
a time, the adjacency packed into int32 bit words once
(``adjacency_words_plain``), so no (offsets, cells) table is held.
It reads nothing back to the host on a CUDA device; on the CPU, where a
read syncs nothing, it stops once no frame is active (the remaining trips
change nothing).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma
from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import _device_offsets, kernel_offsets
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype

MAX_OFFSETS = 256   # csrc/stencil_cc.cu::kMaxOffsets
MAX_CLUSTER = 16    # CTAs per frame: the H100's non-portable cluster size
# Cluster size rule (``cluster_size``): the fewest CTAs (a power of two,
# at most the card's) that hold at most this many cells each.  Steps 2-3
# scale with the dynamic cells, which the host does not know without a
# sync, so the cell count stands for them: the floor's 1,119,963 cells
# take 16 CTAs, the headline's 5,500 one.
CELLS_PER_CTA = 16384


@functools.lru_cache(maxsize=8)
def _device_max_cluster(index: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_build.load().motl_stencil_cc_max_cluster(ctypes.addressof(out)),
                     "motl_stencil_cc_max_cluster")
    return out.value


def cluster_size(n_cells: int, device=None) -> int:
    """CTAs per frame for a grid of ``n_cells``: the smallest power of two
    whose shares hold at most ``CELLS_PER_CTA`` cells, at most what the
    card grants (``cudaOccupancyMaxActiveClusters``; elsewhere the H100's
    16)."""
    dev = torch.device(device) if device is not None else None
    top = MAX_CLUSTER
    if dev is not None and dev.type == "cuda":
        top = _device_max_cluster(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
    c = 1
    while c < top and -(-n_cells // c) > CELLS_PER_CTA:
        c *= 2
    return c


def _pad_shift(offsets, dims):
    """(pad, shifted) of the JAX package's pad-and-slice: ``pad(a, fill)``
    pads a (..., gz, gy, gx) array by the offsets' reach, ``shifted(ap,
    dz, dy, dx)`` slices the padded array at one offset."""
    gx, gy, gz = dims
    rz, ry, rx = (max((abs(o[a]) for o in offsets), default=0) for a in range(3))

    def pad(a, fill):
        return F.pad(a, (rx, rx, ry, ry, rz, rz), value=fill)

    def shifted(a, dz, dy, dx):
        return a[..., rz + dz:rz + dz + gz, ry + dy:ry + dy + gy, rx + dx:rx + dx + gx]

    return pad, shifted


def adjacency_words_plain(cent, dyn, dims, offsets, tol2):
    """Each cell's adjacency bits, (b, ceil(O / 32), n) int32: bit o % 32
    of word o // 32 set where the cell and its neighbour at offset o are
    dynamic and within tol (d = c_i - c_j, the kernel's FMA spelling), 32
    offsets at a time."""
    gx, gy, gz = dims
    b = dyn.shape[0]
    pad, shifted = _pad_shift(offsets, dims)
    c3 = cent.reshape(b, 3, gz, gy, gx)
    d3 = dyn.reshape(b, gz, gy, gx)
    cp, dp = pad(c3, 0.0), pad(d3.to(torch.uint8), 0).bool()
    words = []
    for i in range(0, len(offsets), 32):
        group = offsets[i:i + 32]
        d = c3[None] - torch.stack([shifted(cp, *off) for off in group])
        d2 = fma(d[:, :, 2], d[:, :, 2], fma(d[:, :, 0], d[:, :, 0], d[:, :, 1] * d[:, :, 1]))
        adj = d3[None] & torch.stack([shifted(dp, *off) for off in group]) & (d2 <= tol2)
        shift = torch.arange(len(group), device=dyn.device).reshape(-1, 1, 1, 1, 1)
        word = (adj.to(torch.int64) << shift).sum(0)
        words.append(torch.where(word >= 2**31, word - 2**32, word).to(torch.int32))
    if not words:
        return torch.zeros((b, 0, gx * gy * gz), dtype=torch.int32, device=dyn.device)
    return torch.stack(words, 1).reshape(b, len(words), -1)


def stencil_cc_plain(cent, dyn, dims, offsets, tol2, max_iters, sweeps_per_iter,
                     jumps_per_iter):
    """Plain PyTorch version of K14 on (b, 3, n) centroids and (b, n) flags,
    ``offsets`` the (dz, dy, dx) that fit the grid, ``tol2`` tol^2 in the
    centroids' dtype: (labels (b, n) int32, n_sweeps (b,) int32, saturated
    (b,) int32)."""
    gx, gy, gz = dims
    n = gx * gy * gz
    b = dyn.shape[0]
    dev = dyn.device
    pad, shifted = _pad_shift(offsets, dims)

    groups = [offsets[i:i + 32] for i in range(0, len(offsets), 32)]
    words = [w.reshape(b, gz, gy, gx)
             for w in adjacency_words_plain(cent, dyn, dims, offsets, tol2).unbind(1)]

    def sweep(lab):
        lp = pad(lab.reshape(b, gz, gy, gx), n)
        new = lab.reshape(b, gz, gy, gx)
        for word, group in zip(words, groups):
            shift = torch.arange(len(group), device=dev).reshape(-1, 1, 1, 1, 1)
            bit = ((word[None] >> shift) & 1).bool()
            nb = torch.stack([shifted(lp, *off) for off in group])
            new = torch.minimum(new, torch.where(bit, nb, n).amin(dim=0))
        return new.reshape(b, n)

    sentinel = torch.full((b, 1), n, dtype=torch.int32, device=dev)

    def jump(lab):
        return torch.gather(torch.cat([lab, sentinel], 1), 1, lab.to(torch.int64))

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    labels = torch.where(dyn, idx, n).to(torch.int32)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    changed = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        active = changed   # and it < max_iters, which holds inside the loop
        if dev.type == "cpu" and not bool(active.any()):
            break
        new = labels
        for _ in range(sweeps_per_iter):
            new = sweep(new)
        for _ in range(jumps_per_iter):
            new = jump(new)
        changed = torch.where(active, (new != labels).any(dim=1), changed)
        labels = torch.where(active[:, None], new, labels)
        it = it + active.to(torch.int32)
    saturated = (changed & (it >= max_iters)).to(torch.int32)
    return labels, it * sweeps_per_iter, saturated


_ENTRIES = {torch.float32: "motl_stencil_cc", torch.float64: "motl_stencil_cc_f64",
            torch.bfloat16: "motl_stencil_cc_bf16", torch.float16: "motl_stencil_cc_f16"}


def stencil_cc(cent, dyn, dims, tol, leaf_xy, leaf_z, max_iters, sweeps_per_iter,
               jumps_per_iter, cluster=None):
    """K14 on CUDA tensors, ``stencil_cc_plain`` on CPU tensors: (labels
    (b, n) int32, n_sweeps (b,) int32, saturated (b,) int32) of (b, 3, n)
    f32, f64, bf16 or f16 centroids and (b, n) dynamic flags.  f64
    centroids launch the double build (``motl_stencil_cc_f64``), bf16 / f16
    ones the half builds (``motl_stencil_cc_bf16`` / ``_f16``: d^2 in the
    half dtype, as XLA's CPU code computes the JAX stencil there), one
    launch each.
    ``cluster`` (1, 2, 4, 8 or 16 CTAs per frame) overrides
    ``cluster_size``'s; every size gives the same outputs."""
    gx, gy, gz = dims
    n = gx * gy * gz
    offsets = kernel_offsets(dims, tol, leaf_xy, leaf_z)
    dt = cent.dtype
    tol2 = in_dtype(tol * tol, dt)
    if cent.device.type == "cpu":
        return stencil_cc_plain(cent, dyn, dims, offsets, tol2, max_iters, sweeps_per_iter,
                                jumps_per_iter)
    b = dyn.shape[0]
    dev = cent.device
    if cent.shape != (b, 3, n) or dt not in _ENTRIES or dyn.shape != (b, n):
        raise ValueError(f"cent must be ({b}, 3, {n}) float32, float64, bfloat16 or float16 "
                         f"and dyn ({b}, {n}), got {tuple(cent.shape)} {dt}, {tuple(dyn.shape)}")
    if len(offsets) > MAX_OFFSETS or dyn.device != dev:
        raise ValueError(f"K14 holds at most {MAX_OFFSETS} stencil offsets (got {len(offsets)}) "
                         f"and dyn on {dev}")
    cent = cent.contiguous()
    dv = _build.byte_mask(dyn)
    offs = _device_offsets(offsets, str(dev)) if offsets else None
    labels = torch.empty((b, n), dtype=torch.int32, device=dev)
    nsw = torch.empty((b, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty((b * n * (2 + (len(offsets) + 31) // 32),), dtype=torch.int32,
                          device=dev)
    if cluster is None:
        cluster = cluster_size(n, dev)
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"K14 takes clusters of 1, 2, 4, 8 or 16 CTAs, got {cluster}")
    entry = _ENTRIES[dt]
    err = getattr(_build.load(), entry)(
        cent.data_ptr(), dv.data_ptr(), b, gx, gy, gz,
        None if offs is None else offs.data_ptr(), len(offsets), tol2, int(max_iters),
        int(sweeps_per_iter), int(jumps_per_iter), int(cluster), labels.data_ptr(),
        nsw.data_ptr(), scratch.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    _build.count(stencil_cc, entry, "motl_stencil_cc")
    return labels, nsw[:, 0], nsw[:, 1]


stencil_cc.launches = 0                   # motl_stencil_cc's
stencil_cc.launches_by = collections.Counter()   # by C entry
