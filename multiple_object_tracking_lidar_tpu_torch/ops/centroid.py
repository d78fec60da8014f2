"""Per-cluster "centroid" feature: circumcenter of the farthest-pair arc.

Reference behavior (ref: getCentroid, src/multiple_object_tracking_lidar.cpp:
708-822): (1) the farthest member pair (Pi, Pj) by 3-D distance, first
strict maximum in (i, j) order; (2) the member farthest from the PiPj line
in XY, skipping points value-equal to Pi or Pj; (3) the circumcenter of
(Pi, Pj, Pk) by the determinant formula, Pi when collinear (G == 0); z = 0
and the frame time in the intensity slot.

Port of ``multiple_object_tracking_lidar_tpu/ops/centroid.py::
circumcenter_from_pair_stats`` and of the JAX pipeline's
``circumcenter_features_table_pallas_v2``.  On CUDA tensors the whole
feature is one launch, K3f (``ops/centroid_cuda.py::
circumcenter_features``); its plain version, which CPU tensors take, is K3's
plain pair stats followed by ``circumcenter_from_pair_stats`` below, one
separately rounded op at a time, so no FMA contraction can break the
G == 0 test.  Both the dense member table (the grid path) and the
cluster-sorted point list (``circumcenter_features_sorted``) go that way;
the JAX point-list path runs ``_one_cluster``, whose picks the JAX package
documents as those of the pair-stats route (centroid.py:152-157).  Under
bf16 / f16 K3f's half builds are ``_one_cluster`` itself, as XLA's CPU
code computes it (``centroid_cuda.circumcenter_features_half_plain``): on
the dense grid's table and on the sorted list alike (P up to G's 512).  The
runs' point list under bf16 / f16 stays f32 to the circumcenter and casts
after it, as JAX does: its f32 ``_one_cluster`` is K3f's f32 table build
(the half builds' body on f32 values, ``table=True``), not the pair-stats
route, so that the cast rounds the JAX package's f32 values.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda


def _first_min_index(v: torch.Tensor, hit: torch.Tensor, fill: int) -> torch.Tensor:
    """Smallest lane index where ``hit``, ``fill`` where none (explicit, so
    the tie order never depends on an argmax implementation)."""
    lane = torch.arange(v.shape[-1], device=v.device)
    return torch.where(hit, lane, fill).min(dim=-1).values


def _take(mpts: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """mpts[c, i[c], :] -- an exact row copy."""
    return torch.gather(mpts, 1, i.reshape(-1, 1, 1).expand(-1, 1, 3))[:, 0, :]


def circumcenter_from_pair_stats(
    cm: torch.Tensor,           # (C, P) colmax
    fr: torch.Tensor,           # (C, P) firstrow
    mpts: torch.Tensor,         # (C, P, 3)
    member_mask: torch.Tensor,  # (C, P)
    t: torch.Tensor,            # scalar, or (C,) per slot
) -> torch.Tensor:
    """(C, 4) [x, y, 0, t] detections from the pair stats.  i* = min
    firstrow over the columns reaching the global max, j* = the first such
    column whose firstrow is i*; empty/singleton slots resolve to 0.  The
    line scan takes the first lane of the largest distance among the
    members not equal to Pi or Pj, a NaN distance never winning; lane 0
    where none qualifies."""
    c, p = cm.shape
    dtype = mpts.dtype
    fr = fr.to(torch.int64)
    gmax = cm.max(dim=1, keepdim=True).values
    have = gmax > -0.5
    hit = (cm == gmax) & have
    i_star = torch.where(have[:, 0], torch.where(hit, fr, p).min(dim=1).values, 0)
    lane = torch.arange(p, device=cm.device)[None, :]
    j_star = torch.where(
        have[:, 0],
        torch.where(hit & (fr == i_star[:, None]), lane, p).min(dim=1).values,
        0,
    )
    pi = _take(mpts, i_star)
    pj = _take(mpts, j_star)

    xs, ys, zs = mpts[:, :, 0], mpts[:, :, 1], mpts[:, :, 2]
    pix, piy, piz = pi[:, 0:1], pi[:, 1:2], pi[:, 2:3]
    pjx, pjy, pjz = pj[:, 0:1], pj[:, 1:2], pj[:, 2:3]
    ex = pjx - pix
    ey = pjy - piy
    cross = torch.abs(ex * (ys - piy) - ey * (xs - pix))
    norm = torch.sqrt(ex * ex + ey * ey)
    line_d = cross / torch.clamp(norm, min=1e-30)
    eq_i = (xs == pix) & (ys == piy) & (zs == piz)
    eq_j = (xs == pjx) & (ys == pjy) & (zs == pjz)
    k_mask = member_mask & ~eq_i & ~eq_j
    ld = torch.where(k_mask & ~torch.isnan(line_d), line_d, -1.0)
    k_star = _first_min_index(ld, ld == ld.max(dim=1, keepdim=True).values, p)
    pk = _take(mpts, k_star)
    pkx, pky = pk[:, 0:1], pk[:, 1:2]

    a = pjx - pix
    b = pjy - piy
    cc = pkx - pix
    d = pky - piy
    e = a * (pix + pjx) + b * (piy + pjy)
    f = cc * (pix + pkx) + d * (piy + pky)
    g = 2.0 * (a * (pky - pjy) - b * (pkx - pjx))
    collinear = g == 0.0
    g_safe = torch.where(collinear, torch.ones_like(g), g)
    cx = torch.where(collinear, pix, (d * e - b * f) / g_safe)
    cy = torch.where(collinear, piy, (a * f - cc * e) / g_safe)
    zeros = torch.zeros((c, 1), dtype=dtype, device=mpts.device)
    tcol = torch.as_tensor(t, dtype=dtype, device=mpts.device).reshape(-1, 1).expand(c, 1)
    return torch.cat([cx, cy, zeros, tcol], dim=1)


def circumcenter_features_table_stacked(
    mpts: torch.Tensor, member_mask: torch.Tensor, t: torch.Tensor, table: bool = False
) -> torch.Tensor:
    """(S, C, 4) detections of S frames' member tables (S, C, P, 3), t
    (S,): one K3f launch for the S * C slots; each slot's result is the one
    a single-frame call gives.  ``table``: f32 tables through the JAX jnp
    route (``centroid_cuda.circumcenter_features``)."""
    s, c, p, _ = mpts.shape
    dets = centroid_cuda.circumcenter_features(
        mpts.reshape(s * c, p, 3), member_mask.reshape(s * c, p), torch.as_tensor(t).reshape(-1),
        table=table)
    return dets.reshape(s, c, 4)


def circumcenter_features_table(
    mpts: torch.Tensor, member_mask: torch.Tensor, t
) -> torch.Tensor:
    """(C, 4) detections of one frame's member table (C, P, 3) (JAX
    centroid.py:121-135): one K3f launch."""
    t = torch.as_tensor(t, device=mpts.device).reshape(1)
    return circumcenter_features_table_stacked(mpts[None], member_mask[None], t)[0]


def circumcenter_features(
    pts: torch.Tensor,
    members: torch.Tensor,
    member_mask: torch.Tensor,
    cluster_valid: torch.Tensor,
    t,
    chunk: int = 0,
) -> torch.Tensor:
    """(C, 4) [x, y, 0, t] detections of clusters given as member indices
    (JAX centroid.py:87-118): pts (M, 3), members / member_mask (C, P),
    cluster_valid (C,) (rows where it is False are garbage, as in JAX).
    The member points are gathered, then K3f runs on the table.
    ``chunk`` only splits the JAX program into a sequential map; every
    value gives the same result, so it is accepted and unused here."""
    del cluster_valid, chunk
    mpts = pts[members.to(torch.int64)]
    return circumcenter_features_table(mpts, member_mask, t)


def circumcenter_features_sorted(
    sorted_pts: torch.Tensor,     # (S, M + P, 3) cluster-contiguous points
    starts: torch.Tensor,         # (S, C)
    sizes: torch.Tensor,          # (S, C)
    cluster_valid: torch.Tensor,  # (S, C)
    t: torch.Tensor,              # (S,)
    p_max: int,
    table: bool = False,
) -> torch.Tensor:
    """(S, C, 4) detections of S frames from the cluster-sorted point list
    (``ops/cluster.py::cluster_postprocess``): slot c's members are rows
    ``starts[c] + arange(P)`` (every start is <= M, so JAX's dynamic_slice
    never clamps), masked to ``sizes[c]``.  ``table``: an f32 list through
    the JAX jnp route (``_one_cluster``), as the runs' point list takes it
    under a half dtype before its cast."""
    s, c = starts.shape
    lane = torch.arange(p_max, device=sorted_pts.device)
    rows = (starts.to(torch.int64)[:, :, None] + lane).reshape(s, -1)
    mpts = torch.gather(sorted_pts, 1, rows[..., None].expand(-1, -1, 3)).reshape(s, c, p_max, 3)
    mm = (lane < sizes[:, :, None]) & cluster_valid[:, :, None]
    return circumcenter_features_table_stacked(mpts, mm, t, table=table)
