"""Euclidean clustering over the capped point list (PCL EuclideanCluster-
Extraction semantics, ref src/multiple_object_tracking_lidar.cpp:471-488):
the connected components of the "distance <= tolerance" graph, size-
filtered, largest first.

Port of ``multiple_object_tracking_lidar_tpu/ops/cluster.py``.  Two CC
backends, as in the JAX package:

- ``"jnp"``: min-label propagation with pointer jumps over the (M, M)
  adjacency, at most ``max_iters`` sweeps.  Plain torch; the adjacency is
  K8's first stage on the card (``ops/cluster_pallas.py::cc_adjacency``),
  so both backends test the same d2 bits (under bf16 / f16 its half
  builds, the JAX half adjacency).  Its sweep count ``n_iters`` is
  an output (the pipeline's ``cc_saturated``), so it is JAX's exactly: the
  sweep at which nothing changed, or ``max_iters``.  A converged sweep
  changes nothing, so frames of a batch run on together and the host checks
  convergence once every ``CHECK_EVERY`` sweeps (one host sync per check).
- ``"pallas"``: K8 (``connected_components_pallas``); ``n_iters`` = -1.

``cluster_postprocess`` orders the size-valid components (size descending,
root index ascending, stable argsorts as ``jnp.argsort``) and lays out the
member table and the cluster-contiguous points.  Every function takes one
frame or S stacked frames on a leading axis; stacked frames are
independent, so a batch gives each frame's single-frame result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import (
    cc_adjacency,
    connected_components_pallas,
)

CHECK_EVERY = 4  # jnp-backend sweeps between two host convergence checks


class Clusters(NamedTuple):
    labels: torch.Tensor         # (M,) root point index per point; M = invalid
    counts: torch.Tensor         # (M,) component size per root (0 elsewhere)
    keep: torch.Tensor           # (M,) point belongs to a size-valid cluster
    roots: torch.Tensor          # (C,) root index per cluster, ordered
    cluster_valid: torch.Tensor  # (C,)
    sizes: torch.Tensor          # (C,) points per cluster
    members: torch.Tensor        # (C, P) point indices
    member_mask: torch.Tensor    # (C, P)
    sorted_pts: torch.Tensor     # (M + P, 3) points in (cluster, index) order
    starts: torch.Tensor         # (C,) row offsets into sorted_pts
    n_clusters: torch.Tensor     # scalar
    n_iters: torch.Tensor        # scalar -- label-propagation sweeps used


def _stack(pts, mask):
    single = pts.dim() == 2
    if single:
        pts, mask = pts[None], mask[None]
    return pts, mask.reshape(pts.shape[:2]) != 0, single


def _pairwise_adjacency(pts: torch.Tensor, mask: torch.Tensor, tol: float) -> torch.Tensor:
    """(..., M, M) bool adjacency: d2 <= tol^2, both rows valid."""
    mask = mask != 0
    return cc_adjacency(pts, mask, tol) & mask[..., :, None] & mask[..., None, :]


def connected_components(
    pts: torch.Tensor,
    mask: torch.Tensor,
    tol: float,
    max_iters: int = 32,
    pointer_jumps: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-label connected components of the radius graph (the "jnp"
    backend).  Returns (labels int32, n_iters int32): labels[i] = min point
    index in i's component, M for invalid points."""
    pts, mask, single = _stack(pts, mask)
    s, m = mask.shape
    dev = mask.device
    adj = _pairwise_adjacency(pts, mask, tol)
    labels = torch.where(mask, torch.arange(m, device=dev), m)
    sentinel = torch.full((s, 1), m, dtype=labels.dtype, device=dev)
    n_iters = torch.full((s,), max_iters, dtype=torch.int32, device=dev)
    done = torch.zeros(s, dtype=torch.bool, device=dev)
    for it in range(1, max_iters + 1):
        # min neighbour label (the adjacency includes self)
        nmin = torch.where(adj, labels[:, None, :], m).amin(dim=-1)
        new = torch.minimum(labels, nmin)
        for _ in range(pointer_jumps):  # chase representatives
            new = torch.where(mask, torch.gather(torch.cat([new, sentinel], 1), 1, new), m)
        converged = (new == labels).all(dim=1)
        n_iters = torch.where(converged & ~done, it, n_iters)
        done = done | converged
        labels = new
        if it % CHECK_EVERY == 0:
            connected_components.host_syncs += 1
            if bool(done.all()):
                break
    labels = labels.to(torch.int32)
    return (labels[0], n_iters[0]) if single else (labels, n_iters)


connected_components.host_syncs = 0


def euclidean_cluster(
    pts: torch.Tensor,
    mask: torch.Tensor,
    tol: float,
    min_size: int,
    max_size: int,
    c_max: int,
    p_max: int,
    max_iters: int = 32,
    pointer_jumps: int = 4,
    backend: str = "jnp",
) -> Clusters:
    """Components -> size filter -> ordering -> member table, with the CC
    of ``backend`` ("jnp" or "pallas")."""
    pts, mask, single = _stack(pts, mask)
    if backend == "pallas":
        labels = connected_components_pallas(pts, mask, tol, n_sweeps=8 * max_iters)
        n_iters = torch.full((pts.shape[0],), -1, dtype=torch.int32, device=pts.device)
    elif backend == "jnp":
        labels, n_iters = connected_components(pts, mask, tol, max_iters, pointer_jumps)
    else:
        raise ValueError(f"unknown point-list cluster backend {backend!r}")
    out = cluster_postprocess(labels, n_iters, pts, mask, min_size, max_size, c_max, p_max)
    return Clusters(*(f[0] for f in out)) if single else out


def cluster_postprocess(
    labels: torch.Tensor,
    n_iters: torch.Tensor,
    pts: torch.Tensor,
    mask: torch.Tensor,
    min_size: int,
    max_size: int,
    c_max: int,
    p_max: int,
) -> Clusters:
    """Size filter -> (size desc, root index asc) order -> member table ->
    contiguous per-cluster point layout, for labels (S, M) over pts
    (S, M, 3).  Integer outputs and copied points: bit for bit the JAX
    package's."""
    s, m = labels.shape
    dev = labels.device
    lab = labels.to(torch.int64)
    mask = mask != 0
    idx = torch.arange(m, device=dev)
    counts = torch.zeros((s, m + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, lab, mask.to(torch.int64))
    counts = counts[:, :m]
    size_of = torch.gather(counts, 1, torch.clamp(lab, max=m - 1))
    keep = mask & (size_of >= min_size) & (size_of <= max_size)

    is_root = keep & (lab == idx)
    order_key = torch.where(is_root, -counts * (m + 1) + idx, 2**30)
    order = torch.argsort(order_key, dim=1, stable=True)
    roots = order[:, :c_max]
    cluster_valid = torch.gather(is_root, 1, roots)
    sizes = torch.where(cluster_valid, torch.gather(counts, 1, roots), 0)
    n_clusters = is_root.sum(dim=1)

    # rank of each root's cluster, then of each point through its label;
    # invalid slots all write the dump entry m, which no kept point reads
    ranks = torch.arange(c_max, device=dev).expand(s, c_max)
    rank_of_root = torch.full((s, m + 1), c_max, dtype=torch.int64, device=dev)
    rank_of_root.scatter_(1, torch.where(cluster_valid, roots, m), ranks)
    point_rank = torch.where(keep, torch.gather(rank_of_root, 1, torch.clamp(lab, max=m)), c_max)

    perm = torch.argsort(point_rank * m + idx, dim=1, stable=True)
    starts = torch.cumsum(sizes, dim=1) - sizes
    gather_idx = starts[:, :, None] + torch.arange(p_max, device=dev)
    member_mask = (torch.arange(p_max, device=dev) < sizes[:, :, None]) & cluster_valid[:, :, None]
    picked = torch.gather(perm, 1, torch.clamp(gather_idx, 0, m - 1).reshape(s, -1))
    members = torch.where(member_mask, picked.reshape(s, c_max, p_max), 0)
    sorted_pts = torch.cat(
        [torch.gather(pts, 1, perm[..., None].expand(-1, -1, 3)),
         torch.zeros((s, p_max, 3), dtype=pts.dtype, device=dev)], dim=1)
    i32 = torch.int32
    return Clusters(
        labels=labels.to(i32), counts=counts.to(i32), keep=keep, roots=roots.to(i32),
        cluster_valid=cluster_valid, sizes=sizes.to(i32), members=members.to(i32),
        member_mask=member_mask, sorted_pts=sorted_pts, starts=starts.to(i32),
        n_clusters=n_clusters.to(i32), n_iters=n_iters.to(i32),
    )
