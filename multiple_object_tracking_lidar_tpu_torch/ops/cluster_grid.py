"""Euclidean clustering on the dense voxel grid: the stencil and the
cluster table.

Port of ``multiple_object_tracking_lidar_tpu/ops/cluster_grid.py``.  The
labels come from K2 (``ops/grid_cuda.py``) or, where K2 does not run
(``grid_cc="jnp"``, a map with no per-cell static table, a grid past K2's
shared memory), from ``connected_components_grid``: the JAX package's
stencil CC with its schedule -- ``sweeps_per_iter`` Jacobi sweeps and
``jumps_per_iter`` pointer jumps per iteration, at most ``max_iters``
iterations -- so its sweep count and ``saturated`` flag are JAX's too; on
the card K14 (``ops/stencil_cc_cuda.py``), on the CPU its plain version.
``cluster_table_grid`` turns labels into PCL's cluster order
and the dense (C, P, 3) member table.  The JAX package builds that table
from one-hot matmuls (an MXU idiom); here an integer ``index_add_``
histogram (not ``bincount``, which reads its input's min and max on the
host), ``topk`` on the same unique packed key, ``gather`` and
``index_put_`` do it, with no host sync.  Every output
is an integer or a copied value, so it matches the JAX package bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch



def _stencil_offsets(tol: float, leaf_xy: float, leaf_z: float) -> list[tuple[int, int, int]]:
    """All (dz, dy, dx) cell offsets that can hold a centroid within tol."""
    rx = int(math.floor(tol / leaf_xy)) + 1
    rz = int(math.floor(tol / leaf_z)) + 1
    out = []
    for dz in range(-rz, rz + 1):
        for dy in range(-rx, rx + 1):
            for dx in range(-rx, rx + 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                # prune offsets whose MINIMUM possible centroid distance
                # already exceeds tol: cells d apart have gap >= (|d|-1)*leaf
                min_d2 = (
                    (max(abs(dx) - 1, 0) * leaf_xy) ** 2
                    + (max(abs(dy) - 1, 0) * leaf_xy) ** 2
                    + (max(abs(dz) - 1, 0) * leaf_z) ** 2
                )
                if min_d2 <= tol * tol:
                    out.append((dz, dy, dx))
    return out


def neighbor_index(dims, offsets, device) -> torch.Tensor:
    """(n_off, n) flat neighbour index per stencil offset (dz, dy, dx), n
    where the neighbour lies outside the grid."""
    gx, gy, gz = dims
    n = gx * gy * gz
    i = torch.arange(n, device=device)
    x, y, z = i % gx, (i // gx) % gy, i // (gx * gy)
    rows = []
    for dz, dy, dx in offsets:
        ok = ((x + dx >= 0) & (x + dx < gx) & (y + dy >= 0) & (y + dy < gy)
              & (z + dz >= 0) & (z + dz < gz))
        rows.append(torch.where(ok, i + dx + gx * (dy + gy * dz), n))
    return torch.stack(rows) if rows else torch.empty((0, n), dtype=torch.int64, device=device)


def connected_components_grid(
    cent: torch.Tensor,       # (..., 3, n_cells) channel-major centroids
    dyn: torch.Tensor,        # (..., n_cells) cell holds a dynamic point
    dims: tuple[int, int, int],
    tol: float,
    leaf_xy: float,
    leaf_z: float,
    max_iters: int = 32,
    sweeps_per_iter: int = 6,
    jumps_per_iter: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Min-label connected components of the radius graph on the dense
    grid (cluster_grid.py:60-178): K14 on CUDA tensors, its plain version
    on CPU tensors (``ops/stencil_cc_cuda.py``).  Returns (labels (..., n)
    int32: the min flat cell index of each component, n for cells that are
    not dynamic; n_sweeps (...) int32 = iterations * sweeps_per_iter;
    saturated (...) int32: the loop stopped at ``max_iters`` while labels
    still changed).

    Neighbour j of cell i is adjacent when both are dynamic and d2 <= tol^2
    (in the centroids' dtype, f32 or f64), where d2 is what XLA's CPU code
    computes for the JAX expression ``sum((c - c_j) ** 2)``: the FMA chain
    fma(dz, dz, fma(dx, dx, dy * dy)), each correctly rounded.  A neighbour
    outside the grid is never dynamic, as the JAX pad-and-slice has it.
    Leading dims batch frames; each frame stops where its own loop would,
    as under ``jax.vmap``.  Neither route syncs the host:
    ``.host_syncs`` stays 0."""
    # imported here: K14's module imports ops/grid_cuda.py, which imports this one
    from multiple_object_tracking_lidar_tpu_torch.ops.stencil_cc_cuda import stencil_cc

    lead = dyn.shape[:-1]
    n = dims[0] * dims[1] * dims[2]
    labels, n_sweeps, saturated = stencil_cc(
        cent.reshape(-1, 3, n), dyn.reshape(-1, n), dims, tol, leaf_xy, leaf_z, max_iters,
        sweeps_per_iter, jumps_per_iter)
    return labels.reshape(lead + (n,)), n_sweeps.reshape(lead), saturated.reshape(lead)


connected_components_grid.host_syncs = 0


class ClusterTable(NamedTuple):
    """Dense per-slot cluster output (same fields as the JAX package)."""

    mpts: torch.Tensor          # (..., C, P, 3) member points (cell centroids)
    member_mask: torch.Tensor   # (..., C, P)
    sizes: torch.Tensor         # (..., C)
    cluster_valid: torch.Tensor # (..., C)
    roots: torch.Tensor         # (..., C) root cell index per slot
    n_clusters: torch.Tensor    # (...,) size-valid components found
    n_iters: torch.Tensor       # (...,) CC iterations used


def cluster_table_grid(
    labels: torch.Tensor,   # (..., n_cells) min-cell-index labels (n = invalid)
    n_iters: torch.Tensor,
    cent: torch.Tensor,     # (..., 3, n_cells) channel-major
    dyn: torch.Tensor,      # (..., n_cells)
    gx: int,
    min_size: int,
    max_size: int,
    c_max: int,
    p_max: int,
) -> ClusterTable:
    """Size filter -> (size desc, root index asc) order -> (C, P, 3) member
    table, members in ascending cell index.  Leading dims batch frames."""
    lead = labels.shape[:-1]
    n = labels.shape[-1]
    labels = labels.reshape(-1, n).to(torch.int64)
    dyn = dyn.reshape(-1, n)
    cent = cent.reshape(-1, 3, n)
    b = labels.shape[0]
    dev = labels.device
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)[:, None]

    valid = dyn & (labels < n)
    lab = torch.where(valid, labels, n)
    # component sizes: per-frame histogram of the labels (slot n = invalid)
    flat = (rows * (n + 1) + lab).reshape(-1)
    counts = torch.zeros(b * (n + 1), dtype=torch.int64, device=dev).index_add_(
        0, flat, torch.ones_like(flat)).reshape(b, n + 1)
    size_of = torch.gather(counts, 1, lab)
    keep = valid & (size_of >= min_size) & (size_of <= max_size)
    is_root = keep & (labels == idx)
    n_clusters = is_root.sum(dim=1).to(torch.int32)

    # rank roots by (size desc, index asc): one unique packed key, so the
    # top-k order has no ties among roots (torch.topk leaves tie order open)
    pw = 1 << (n - 1).bit_length()
    if max_size * pw + n >= 2**31:
        raise ValueError(
            f"rank key overflow: max_cluster_size={max_size} with "
            f"{n} grid cells exceeds int32 packing"
        )
    keys = torch.where(is_root, size_of * pw - idx, -1)
    topv, topi = torch.topk(keys, c_max, dim=1, largest=True, sorted=True)
    cluster_valid = topv >= 0
    roots = torch.where(cluster_valid, topi, 0)
    sizes = torch.where(cluster_valid, torch.div(topv + pw - 1, pw, rounding_mode="floor"), 0)

    # slot (rank) of each root, then of each member via its label
    slot_of = torch.full((b, n + 1), c_max, dtype=torch.int64, device=dev)
    ranks = torch.arange(c_max, device=dev).expand(b, c_max)
    slot_of.scatter_(1, torch.where(cluster_valid, roots, n), torch.where(cluster_valid, ranks, c_max))
    slot_of[:, n].fill_(c_max)   # (a Python scalar assigned by index reads a host tensor)
    point_rank = torch.gather(slot_of, 1, lab)
    member = keep & (point_rank < c_max)
    point_rank = torch.where(member, point_rank, c_max)

    # intra-cluster position: members counted in ascending cell index, one
    # running count per slot over a (frames, C+1, n) one-hot scanned along
    # its last, contiguous axis
    slot_ids = torch.arange(c_max + 1, device=dev)[None, :, None]
    onehot = (point_rank[:, None, :] == slot_ids).to(torch.int32)
    run = torch.cumsum(onehot, dim=2, dtype=torch.int32)
    pos = torch.gather(run, 1, point_rank[:, None, :])[:, 0].to(torch.int64) - 1
    put = member & (pos < p_max)

    # scatter members into their (slot, position); everything else lands in
    # one dump row past the table (no nonzero(): it would sync the host)
    rows_cp = b * c_max * p_max
    dest = torch.where(put, (rows * c_max + point_rank) * p_max + pos, rows_cp)
    dest = dest.reshape(-1)
    flat_pts = torch.zeros((rows_cp + 1, 3), dtype=cent.dtype, device=dev)
    flat_pts.index_put_((dest,), cent.permute(0, 2, 1).reshape(-1, 3))
    flat_mask = torch.zeros((rows_cp + 1,), dtype=torch.bool, device=dev)
    flat_mask.index_put_((dest,), put.reshape(-1))
    mpts = flat_pts[:rows_cp].reshape(b, c_max, p_max, 3)
    member_mask = flat_mask[:rows_cp].reshape(b, c_max, p_max)

    def out(t):
        return t.reshape(tuple(lead) + tuple(t.shape[1:]))

    return ClusterTable(
        mpts=out(mpts),
        member_mask=out(member_mask & cluster_valid[..., None]),
        sizes=out(sizes.to(torch.int32)),
        cluster_valid=out(cluster_valid),
        roots=out(roots.to(torch.int32)),
        n_clusters=out(n_clusters),
        n_iters=n_iters,
    )


def euclidean_cluster_grid(
    cent: torch.Tensor,       # (3, n_cells) channel-major
    dyn: torch.Tensor,        # (n_cells,)
    dims: tuple[int, int, int],
    tol: float,
    leaf_xy: float,
    leaf_z: float,
    min_size: int,
    max_size: int,
    c_max: int,
    p_max: int,
    max_iters: int = 32,
    sweeps_per_iter: int = 6,
    jumps_per_iter: int = 2,
):
    """PCL-semantics clustering on the dense grid of one frame (JAX
    cluster_grid.py:380-403): the stencil CC (K14 on CUDA tensors), then the
    point list's size filter, ordering and member layout
    (``ops/cluster.py::cluster_postprocess``) over the cells."""
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster import Clusters, cluster_postprocess

    labels, n_iters, _ = connected_components_grid(
        cent, dyn, dims, tol, leaf_xy, leaf_z, max_iters, sweeps_per_iter, jumps_per_iter,
    )
    c = cluster_postprocess(
        labels[None], n_iters[None], cent.T[None], dyn[None], min_size, max_size, c_max, p_max,
    )
    return Clusters(*(f[0] for f in c))
