"""Times K8 (the point-list connected components, ``ops/cluster_pallas.py``),
K7 (the segmented run totals of ``voxel_mode="runs"``) and K9 (the
four-channel segmented totals, ``ops/segsum_cuda.py``) on the GPU, per
call:

- K8 (``connected_components_pallas``) and its adjacency stage alone, K8a
  (``cc_adjacency``, the bool (S, M, M) matrix the jnp CC sweeps), on the
  compacted dynamic voxels of the headline frames under configuration C
  (M = 1,024) and of the default scene's frames under G (M = 2,048), as the
  pipeline's ``compact_points`` hands them over, at S = 1 and S = 8;
- K7 at the headline N = 106,496, S = 1 and S = 8: "rows" on key-sorted,
  already gathered coordinates (``segment_totals(ks, xs, ys, zs)``), and
  "gather" from the sort's permutation and the unsorted (S, N, 3) values,
  as ``ops/voxel_pallas.py::_sorted_runs`` calls it (a checkout whose K7
  takes no permutation gathers with ``torch.gather`` first, as its
  ``_sorted_runs`` does);
- K9 (``segment_totals_rows``) at S = 1 and S = 8 on the same sorted rows
  as one (S, N, 4) array: the gathered x, y, z and a ones column, the
  rows ``voxel_pallas.py::segment_totals_pallas`` sums.

Per call: the device time from a ``torch.profiler`` trace (every kernel,
copy and memset the call launches, summed), the device operations, and the
wrapper's time by CUDA events (host checks, ctypes and launches included).
Each result is held bit for bit against its plain version first.  Prints
the card's name and power limit beside every time.

    python scripts/micro_torch_cc_segsum.py [--reps 50] [--repo DIR] [--sweep]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/), so two versions can be measured in turns in one
call.  ``--sweep`` (this checkout's kernels) times K8 and K8a at every
cluster size (1-16 CTAs per frame), each held bit for bit against the
plain version: the measurements ``cc_layout`` rests on.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from micro_torch_digits import card, cuda_ms, device_profile  # noqa: E402


def frames(case, s, device):
    """(config, points (s, N, 3), mask (s, N)) of a bench case's frames."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame

    cfg, _, sc = getattr(bench_cases, case)()
    rows = [padded_frame(sc, k, cfg.caps.n_max_points) for k in range(s)]
    pts = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
    mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
    return cfg, pts, mask


def point_lists(case, s, device):
    """(points (s, M, 3), mask (s, M), tol, n_sweeps): the compacted dynamic
    voxels the pipeline hands its CC (strided views, as compact_points
    returns them)."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import (
        build_static_mask, remove_static)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_downsample_dense

    cfg, P, M = frames(case, s, device)
    env = build_static_mask(load_sim_grid(), cfg.static_tolarance, cfg.occupied_threshold,
                            device=device)
    vox, vmask, _ = voxel_downsample_dense(P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z,
                                           cfg.caps.m_max_voxels)
    pts, msk, _ = compact_points(vox, remove_static(vox, vmask, env), cfg.caps.m_max_dynamic)
    return pts, msk, cfg.cluster_tolerance, 8 * cfg.caps.label_prop_iters


def sorted_inputs(s, device):
    """(ks (s, N) sorted keys, perm (s, N) int64, vals (s, N, 3)) of the
    headline frames under runs mode, as ``_sorted_runs`` makes them."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    cfg, P, M = frames("runs_case", s, device)
    k = vg.kernel_params(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    ok, lin, _ = vg.kept_cells(P, M, k)
    keys = torch.where(ok, lin, k["n_cells"]).to(torch.int32)
    vals = torch.where(ok[..., None], P, 0.0)
    ks, perm = torch.sort(keys, dim=1, stable=True)
    return ks, perm, vals


def same(a, b) -> bool:
    """Bit for bit, tensors or tuples of them."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def entries(device, s):
    """{(entry, shape): (call, plain result)}."""
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster_pallas as cp
    from multiple_object_tracking_lidar_tpu_torch.ops import segsum_cuda as sg

    out = {}
    for case, m in (("pointlist_case", 1024), ("default_case", 2048)):
        pts, msk, tol, sweeps = point_lists(case, s, device)
        n_run = cp.connected_components_pallas(pts, msk, tol, sweeps, with_sweeps=True)[1]
        shape = f"S={s} M={m} ({int(msk.sum())} valid rows, {n_run} sweeps)"
        out[("K8", shape)] = (lambda p=pts, k=msk, t=tol, n=sweeps: cp.connected_components_pallas(p, k, t, n),
                              cp.connected_components_pallas_plain(pts, msk, tol, sweeps))
        out[("K8a", shape)] = (lambda p=pts, k=msk, t=tol: cp.cc_adjacency(p, k, t),
                               cp.cc_adjacency_plain(pts, msk, tol))
    ks, perm, vals = sorted_inputs(s, device)
    rows = [torch.gather(vals[..., c], 1, perm).contiguous() for c in range(3)]
    plain = sg.segment_totals_plain(ks, *rows)
    shape = f"S={s} N={ks.shape[1]}"
    out[("K7 rows", shape)] = (lambda: sg.segment_totals(ks, *rows), plain)
    if "perm" in inspect.signature(sg.segment_totals).parameters:
        def gathered():
            return sg.segment_totals(ks, vals[..., 0], vals[..., 1], vals[..., 2], perm=perm)
    else:
        def gathered():
            return sg.segment_totals(
                ks, *(torch.gather(vals[..., c], 1, perm).contiguous() for c in range(3)))
    out[("K7 gather", shape)] = (gathered, plain)
    v4 = torch.stack(rows + [torch.ones_like(rows[0])], dim=-1).contiguous()
    out[("K9", shape)] = (lambda: sg.segment_totals_rows(ks, v4),
                          sg.segment_totals_rows_plain(ks, v4))
    return out


def run(device="cuda", reps: int = 50, log=print) -> dict:
    """{(entry, shape): (device us, device ops, wrapper ms)}; raises unless
    every result equals its plain version."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_cc_segsum: needs a CUDA device")
    smi = card()
    result = {}
    for s in (1, 8):
        for (name, shape), (fk, want) in entries(device, s).items():
            if not same(fk(), want):
                raise SystemExit(f"micro_torch_cc_segsum: {name} at {shape} differs from its "
                                 "plain version")
            w = min(cuda_ms(fk, reps), cuda_ms(fk, reps))
            d, ops = device_profile(fk, reps)
            result[(name, shape)] = (d, ops, w)
            log(f"[cc/segsum] {smi}: {name} {shape}: device {d:.2f} us/call in {ops:.1f} ops, "
                f"wrapper {w:.4f} ms/call")
    return result


def sweep(device="cuda", reps: int = 20, log=print) -> None:
    """K8 and K8a at every cluster size that holds the frame, on both
    point lists at S = 1 and S = 8: device us per call, each held bit for
    bit against the plain version first; the rule's size marked."""
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster_pallas as cp
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import max_cluster

    smi = card()
    dev = torch.device(device)
    for s in (1, 8):
        for case in ("pointlist_case", "default_case"):
            pts, msk, tol, sweeps = point_lists(case, s, device)
            m = pts.shape[1]
            want = cp.connected_components_pallas_plain(pts, msk, tol, sweeps)
            want_a = cp.cc_adjacency_plain(pts, msk, tol)
            rule = cp.cc_layout(m, dev)[0]
            row = []
            for c in (1, 2, 4, 8, 16):
                if c > max_cluster(dev) or not cp.fits_smem(m, c):
                    continue
                fk = lambda: cp.connected_components_pallas(pts, msk, tol, sweeps, cluster=c)  # noqa: E731
                fa = lambda: cp.cc_adjacency(pts, msk, tol, cluster=c)  # noqa: E731
                if not (same(fk(), want) and same(fa(), want_a)):
                    raise SystemExit(f"micro_torch_cc_segsum: K8 at cluster {c} differs from its "
                                     f"plain version (S={s} M={m})")
                mark = "*" if c == rule else " "
                row.append(f"{c:2d}{mark} K8 {device_profile(fk, reps)[0]:8.2f} "
                           f"K8a {device_profile(fa, reps)[0]:8.2f}")
            log(f"[cc sweep] {smi}: S={s} M={m} ({int(msk.sum())} valid rows): device us/call "
                "by cluster size (* the rule's) " + "; ".join(row))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    if args.sweep:
        sweep(reps=min(args.reps, 20))
    else:
        run(reps=args.reps)


if __name__ == "__main__":
    main()
