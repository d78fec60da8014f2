"""Where the time goes in the PyTorch/CUDA port, on one GPU:
``torch.profiler`` over ``Tracker.bind_env_multi`` (S = 8) and
``Tracker.bind_env`` on the headline scene, in each configuration named
(``bench_cases.<case>_case``: the dense grid's headline, exact, runs,
exact_unpadded; the point list's pointlist (C), pointlist_jnp (D), scan
(E), pointlist_runs (F), default (G); and default_grid, G-grid: G's
config and frames on the dense grid, ``voxel_mode="onehot"``,
``cluster_backend="grid"``, ``voxel_quant="fast"``, built here from
``default_case`` so an older checkout runs it too).  ``--case fleet`` profiles the
kernel fleet instead (``parallel.ShardedTracker`` on a one-rank NCCL mesh,
B = 8 headline streams, stream s at step k fed headline frame 3 s + k)
beside the headline's ``bind_env_multi`` on the same clouds.

    python scripts/profile_torch_slice.py [--case headline exact runs] [--frames 32] [--out DIR]
                                          [--repo DIR]

Prints, per entry point, the wall time per frame without the profiler,
then under it the device-busy time per frame (the union of kernel
intervals in the trace), the device idle share, the device operations per
frame, the host syncs per frame (reads of a device value on the host:
``aten::_local_scalar_dense`` in the trace), and the kernels and host ops
that take the most time.  With --out, writes a Chrome trace per entry
point there (~20 MB each).  ``--repo DIR`` profiles the port of another
checkout (e.g. a parent commit unpacked under build/), so two versions can
be measured in turns in one call.  Needs a GPU (exits 1 without one).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy_us(prof) -> float:
    """Union of device kernel/memcpy intervals in the trace, in us."""
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.elapsed_us() > 0:
            spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for Chrome traces")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is profiled")
    ap.add_argument("--case", nargs="+", default=["headline"],
                    choices=["headline", "exact", "runs", "exact_unpadded", "pointlist",
                             "pointlist_jnp", "scan", "pointlist_runs", "default",
                             "default_grid", "fleet"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    for case in args.case:
        name = {"fleet": "headline", "default_grid": "default"}.get(case, case)
        cfg, env, sc = getattr(bench_cases, f"{name}_case")(device=dev)
        if case == "default_grid":
            cfg = cfg.replace(voxel_mode="onehot", cluster_backend="grid", voxel_quant="fast")
        profile_case(case, cfg, env, sc, dev, smi, args)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


def profile_case(case, cfg, env, sc, dev, smi, args) -> None:
    from torch.profiler import ProfilerActivity, profile

    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    tracker = Tracker(cfg, dev)
    b, n_steps = 8, args.frames // 8
    order = ([3 * s + k for k in range(n_steps) for s in range(b)] if case == "fleet"
             else range(args.frames))
    rows = [padded_frame(sc, k, cfg.caps.n_max_points) for k in order]
    P = torch.from_numpy(np.stack([r[0] for r in rows])).to(dev)
    M = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    T = torch.from_numpy(np.asarray([r[2] for r in rows], np.float32)).to(dev)
    single = tracker.bind_env(env)
    multi = tracker.bind_env_multi(env)

    def run_multi():
        st = tracker.init_state()
        for d in range(args.frames // 8):
            sl = slice(8 * d, 8 * d + 8)
            st, _ = multi(st, Frame(P[sl], M[sl], T[sl]))

    def run_single():
        st = tracker.init_state()
        for k in range(args.frames):
            st, _ = single(st, Frame(P[k], M[k], T[k]))

    entries = ((f"{case} bind_env_multi", run_multi), (f"{case} bind_env", run_single))
    if case == "fleet":
        from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

        fleet = ShardedTracker(tracker, make_mesh(1, 1, device=dev), kernel_path="on")
        step = fleet.bind_env(env)
        Pf, Mf, Tf = (a.reshape((n_steps, b) + a.shape[1:]) for a in (P, M, T))

        def run_fleet():
            st = fleet.init_state(b)
            for k in range(n_steps):
                st, _ = step(st, Pf[k], Mf[k], Tf[k])

        entries = ((f"fleet B={b}", run_fleet), ("fleet's clouds, bind_env_multi", run_multi))
    for name, fn in entries:
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0) / args.frames)
        print(f"[{name}] {smi}: {np.median(walls):.4f} ms/frame median of 5 runs of "
              f"{args.frames} frames without the profiler (min {min(walls):.4f}, max {max(walls):.4f})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        busy = _busy_us(prof)
        n = args.frames
        n_ops = sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.events())
        n_sync = sum(ev.name == "aten::_local_scalar_dense" for ev in prof.events())
        print(f"[{name}] {smi}: wall {wall_us / n:.1f} us/frame under the profiler, device busy "
              f"{busy / n:.1f} us/frame, idle share {1 - busy / wall_us:.3f}, "
              f"{n_ops / n:.2f} device ops/frame, {n_sync / n:.3f} host syncs/frame")
        ka = prof.key_averages()
        dev_rows = sorted(
            (e for e in ka if getattr(e, "self_device_time_total", 0) > 0),
            key=lambda e: -e.self_device_time_total)
        for e in dev_rows[:14]:
            print(f"[{name}]   device {e.self_device_time_total / n:9.2f} us/frame  "
                  f"x{e.count / n:6.2f}/frame  {e.key[:90]}")
        host_rows = sorted(ka, key=lambda e: -e.self_cpu_time_total)
        for e in host_rows[:10]:
            print(f"[{name}]   host   {e.self_cpu_time_total / n:9.2f} us/frame  "
                  f"x{e.count / n:6.2f}/frame  {e.key[:90]}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.out, f"{name.replace(' ', '_')}.json"))


if __name__ == "__main__":
    sys.exit(main())
