"""Times K2 (the fused finalize + static drop + grid CC) on the GPU by
cluster size: its device time per launch from a ``torch.profiler`` trace
and the wrapper's time per call by CUDA events (host checks, ctypes and
launch included), so that host and device time separate.

- The headline's 5,500-cell grid on 8 and on 1 headline frames (K1's
  accumulators, the sim map's per-cell table), at clusters of 1, 2, 4, 8
  and 16 CTAs per frame: the measurement behind ``ops/grid_cuda.py::
  cluster_size``.
- ``bench_cases.k2_grids``' larger grids (32,768, 70,200 and 193,536
  cells) on ``k2_inputs``' three frames, at the cluster the rule picks
  and at every other size that holds the grid.

Each result is held bit for bit against the cluster of 1 (or the rule's)
on the same inputs.  Prints the card's name and power limit beside every
time.

``--case k14`` times K14 (``ops/stencil_cc_cuda.py``, the stencil CC past
K2) on the 30 m floor's grid (1,119,963 cells, 146 offsets) at S = 1 and
8 against the frames' dynamic-cell count: the floor scene's own frames
(K1, the finalize and the per-cell static drop, as the floor path computes
them) and synthetic frames of 1-10 thousand to ~60 thousand dynamic cells
(blobs of cells, centroids jittered inside them), each held bit for bit
against ``stencil_cc_plain`` at S = 1; with ``--repo DIR`` another
checkout's K14 in turns.

``--case headline`` times only the call the tracking path makes on the
headline grid (the wrapper's own cluster choice, S = 8 and S = 1), so that
``--repo DIR`` can time the K2 of another checkout (e.g. a parent commit
unpacked under build/) in turns with this one.  ``--case stencil`` times
K2 against the route it replaces on the large grids, the finalize plus the
stencil CC in plain torch (``ops/cluster_grid.py::
connected_components_grid``, one host sync per iteration), on the same
inputs, and compares their labels.

    python scripts/micro_torch_grid_cc.py [--case sizes|headline|stencil|k14] [--reps 100]
                                          [--repo DIR]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_us(fn, reps: int) -> float:
    """Mean device time of K2's kernel per launch while fn runs ``reps``
    times, us, from the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "grid_cc_kernel" in e.key]
    if not rows:
        raise SystemExit("micro_torch_grid_cc: no K2 kernel in the trace")
    return sum(e.self_device_time_total for e in rows) / sum(e.count for e in rows)


def wrapper_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
               for x, y in zip(a, b))


def sweep(label, args, kw, sizes, rule, reps, smi, log) -> dict:
    """{cluster: (device us, wrapper ms)} of K2 on ``args`` at each size."""
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda

    ref = grid_cuda.fused_finalize_static_cc_stacked(*args, cluster=sizes[0], **kw)
    out = {}
    for c in sizes:
        fn = (lambda c=c: grid_cuda.fused_finalize_static_cc_stacked(*args, cluster=c, **kw))
        if not _bits(fn(), ref):
            raise SystemExit(f"micro_torch_grid_cc: cluster {c} differs from {sizes[0]} ({label})")
        out[c] = (device_us(fn, reps), wrapper_ms(fn, reps))
        log(f"[grid_cc] {smi}: K2 {label}, cluster {c}{' (the rule)' if c == rule else ''}: "
            f"device {out[c][0]:.2f} us per launch (torch.profiler, {reps} launches), "
            f"wrapper {out[c][1]:.4f} ms per call (CUDA events); iterations "
            f"{ref[3].tolist()}")
    return out


def headline_inputs(device):
    """(config, K2's positional args on 8 headline frames, its keywords,
    dims): K1's accumulators and the sim map's per-cell table."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    cfg, env, sc = bench_cases.headline_case(device=device)
    plan = Tracker(cfg, device).plan(env)
    rows = [bench_cases.padded_frame(sc, k, cfg.caps.n_max_points) for k in range(8)]
    P = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
    M = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
    acc, _ = voxel_grid_cuda.accumulate_fast_stacked(P, M, cfg.scene, cfg.voxel_leaf_size,
                                                      cfg.leaf_z)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
              leaf_z=cfg.leaf_z, kwin=plan.table.k)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    return cfg, (acc,) + tb, kw, plan.dims


def run_headline(device="cuda", reps: int = 100, log=print) -> dict:
    """{S: (device us, wrapper ms)} of the K2 call the headline's tracking
    path makes (the wrapper's defaults), on the port imported."""
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda

    smi = card()
    _, args, kw, dims = headline_inputs(device)
    out = {}
    for s in (8, 1):
        a = (args[0][:s].contiguous(),) + args[1:]
        fn = (lambda a=a: grid_cuda.fused_finalize_static_cc_stacked(*a, **kw))
        out[s] = (device_us(fn, reps), wrapper_ms(fn, reps))
        log(f"[grid_cc turns] {smi}: K2 of {os.path.dirname(grid_cuda.__file__)}, headline "
            f"{dims[0] * dims[1] * dims[2]} cells, S={s}: device {out[s][0]:.2f} us per launch "
            f"(torch.profiler, {reps} launches), wrapper {out[s][1]:.4f} ms per call "
            f"(CUDA events); iterations {fn()[3].tolist()}")
    return out


def run_stencil(device="cuda", reps: int = 10, log=print) -> dict:
    """{label: (K2 ms, stencil ms)} per call on ``k2_grids``' grids past
    the headline: K2 at its rule's cluster size against the finalize and
    the stencil CC that ``make_plan`` sent these grids to before K2 held
    them (every occupied cell dynamic, as ``k2_inputs``' table keeps it, so
    the static drop is left out), both timed by CUDA events around whole
    calls, host syncs included."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import (
        connected_components_grid)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense_cm

    smi = card()
    cfg, _, _ = bench_cases.headline_case(device=device)
    caps = TrackerConfig().caps
    out = {}
    for label, dims, leaf, leaf_z, tol in bench_cases.k2_grids(cfg)[2:]:
        n = dims[0] * dims[1] * dims[2]
        n_off = len(grid_cuda.kernel_offsets(dims, tol, leaf, leaf_z))
        args = bench_cases.k2_inputs(dims, leaf, leaf_z, tol, n, device)
        kw = dict(dims=dims, tol=tol, leaf_xy=leaf, leaf_z=leaf_z, kwin=args[5])
        k2 = (lambda: grid_cuda.fused_finalize_static_cc_stacked(*args[:5], **kw))

        def stencil():
            cent, occ, _ = finalize_dense_cm(args[0])
            return cent, occ, *connected_components_grid(
                cent, occ, dims, tol, leaf, leaf_z, caps.label_prop_iters,
                caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)

        got_k2, got_st = k2(), stencil()
        same = [bool(torch.equal(got_k2[2][f], got_st[2][f])) for f in range(args[0].shape[0])]
        out[label] = (wrapper_ms(k2, reps), wrapper_ms(stencil, reps))
        log(f"[grid_cc stencil] {smi}: {label} {n} cells, {n_off} offsets, S=3 (blobs, full, "
            f"55%): K2 {out[label][0]:.4f} ms per call (cluster "
            f"{grid_cuda.cluster_size(n, n_off, device)}, iterations {got_k2[3].tolist()}), "
            f"finalize + stencil CC {out[label][1]:.4f} ms per call (iterations "
            f"{got_st[3].tolist()}, saturated {got_st[4].tolist()}); labels equal per frame "
            f"{same} (CUDA events, {reps} calls each)")
    return out


def device_us_of(fn, reps: int, name: str) -> float:
    """Mean device time per launch of the kernels whose name holds
    ``name`` while fn runs ``reps`` times, us, from the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name in e.key]
    if not rows:
        raise SystemExit(f"micro_torch_grid_cc: no {name} in the trace")
    return sum(e.self_device_time_total for e in rows) / sum(e.count for e in rows)


def floor_frames(device, n_frames: int = 8):
    """(cent (S, 3, n) f32, dyn (S, n), dims, config) of the floor scene's
    first frames, as the floor path computes them."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import (
        remove_static, remove_static_cells)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense_cm
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    cfg, env, sc = bench_cases.floor_case(device)
    rows = [bench_cases.padded_frame(sc, k, cfg.caps.n_max_points) for k in range(n_frames)]
    P = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
    M = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    plan = Tracker(cfg, device).plan(env)
    acc, _ = vg.accumulate_fast_stacked(P, M, *kw)
    cent, occ, _ = finalize_dense_cm(acc)
    dyn = (remove_static_cells(cent, occ, plan.env, plan.table) if plan.table is not None
           else remove_static(cent.transpose(-1, -2), occ, plan.env))
    return cent, dyn, grid_shape(*kw), cfg


def blob_frames(dims, n_blobs: int, s: int, seed: int, leaf: float, leaf_z: float, device):
    """(cent (S, 3, n) f32, dyn (S, n)) on ``dims``: ``n_blobs`` square
    blobs of radius 2-8 cells per frame, 60% of their cells dynamic over
    every z slab, centroids jittered inside their cells."""
    gx, gy, gz = dims
    n = gx * gy * gz
    rng = np.random.default_rng(seed)
    lin = np.arange(n)
    ix, iy, iz = lin % gx, (lin // gx) % gy, lin // (gx * gy)
    cents, dyns = [], []
    for _ in range(s):
        cents.append(np.stack([(ix + rng.uniform(0.1, 0.9, n)) * leaf,
                               (iy + rng.uniform(0.1, 0.9, n)) * leaf,
                               (iz + rng.uniform(0.1, 0.9, n)) * leaf_z]).astype(np.float32))
        d3 = np.zeros((gz, gy, gx), bool)
        for _ in range(n_blobs):
            cx, cy, r = rng.integers(0, gx), rng.integers(0, gy), int(rng.integers(2, 9))
            ys, xs = slice(max(0, cy - r), cy + r + 1), slice(max(0, cx - r), cx + r + 1)
            d3[:, ys, xs] |= rng.random(d3[:, ys, xs].shape) < 0.6
        dyns.append(d3.reshape(-1))
    return (torch.from_numpy(np.stack(cents)).to(device),
            torch.from_numpy(np.stack(dyns)).to(device))


def run_k14(device="cuda", reps: int = 20, log=print) -> dict:
    """{(label, S): device us} of K14 on the floor's grid."""
    from multiple_object_tracking_lidar_tpu_torch.ops import stencil_cc_cuda as k14
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import kernel_offsets
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype

    smi = card()
    cent, dyn, dims, cfg = floor_frames(device)
    caps, tol = cfg.caps, cfg.cluster_tolerance
    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    sched = (caps.label_prop_iters, caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
    offs = kernel_offsets(dims, tol, leaf, leaf_z)
    sets = [("floor scene", cent, dyn)]
    for nb in (8, 30, 120, 400):
        c, d = blob_frames(dims, nb, 8, nb, leaf, leaf_z, device)
        sets.append((f"{nb} blobs", c, d))
    out = {}
    for label, c, d in sets:
        ref = k14.stencil_cc_plain(c[:1], d[:1], dims, offs, in_dtype(tol * tol, c.dtype), *sched)
        got = k14.stencil_cc(c[:1], d[:1], dims, tol, leaf, leaf_z, *sched)
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        for s in (1, 8):
            fn = (lambda c=c, d=d, s=s: k14.stencil_cc(c[:s], d[:s], dims, tol, leaf, leaf_z,
                                                       *sched))
            out[(label, s)] = device_us_of(fn, reps, "stencil_cc_kernel")
            nd = d[:s].sum(1).tolist()
            log(f"[k14] {smi}: K14 of {os.path.dirname(k14.__file__)}, floor {dims} "
                f"({len(offs)} offsets), {label}, S={s}: device {out[(label, s)]:.2f} us per "
                f"launch (torch.profiler, {reps} launches); dynamic cells {nd}; iterations "
                f"{(fn()[1] // sched[1]).tolist()}; S=1 bit for bit the plain version: {same}")
    return out


def run(device="cuda", reps: int = 100, log=print) -> dict:
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda

    smi = card()
    cfg, args, kw, dims = headline_inputs(device)
    acc, tb = args[0], args[1:]
    n = dims[0] * dims[1] * dims[2]
    n_off = len(grid_cuda.kernel_offsets(dims, cfg.cluster_tolerance, cfg.voxel_leaf_size,
                                         cfg.leaf_z))
    top = grid_cuda.max_cluster(device)
    sizes = [c for c in (1, 2, 4, 8, 16) if c <= top]
    rule = grid_cuda.cluster_size(n, n_off, device)
    out = {}
    for s in (8, 1):
        out[("headline", s)] = sweep(f"headline {n} cells, {n_off} offsets, S={s}",
                                     (acc[:s].contiguous(),) + tb, kw, sizes, rule, reps, smi, log)
    for label, dims, leaf, leaf_z, tol in bench_cases.k2_grids(cfg)[1:]:
        n = dims[0] * dims[1] * dims[2]
        n_off = len(grid_cuda.kernel_offsets(dims, tol, leaf, leaf_z))
        args = bench_cases.k2_inputs(dims, leaf, leaf_z, tol, n, device)
        kw2 = dict(dims=dims, tol=tol, leaf_xy=leaf, leaf_z=leaf_z, kwin=args[5])
        rule = grid_cuda.cluster_size(n, n_off, device)
        fit = [c for c in sizes if -(-n // c) <= grid_cuda.LABEL_CELLS]
        out[label] = sweep(f"{label} {n} cells, {n_off} offsets, S=3 (blobs, full, 55%)",
                           args[:5], kw2, fit, rule, max(reps // 4, 5), smi, log)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--case", choices=["sizes", "headline", "stencil", "k14"], default="sizes")
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_grid_cc: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(a.repo))
    {"sizes": run, "headline": run_headline,
     "stencil": lambda reps: run_stencil(reps=max(reps // 10, 3)),
     "k14": lambda reps: run_k14(reps=max(reps // 5, 5))}[a.case](reps=a.reps)


if __name__ == "__main__":
    main()
