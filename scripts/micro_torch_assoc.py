"""Times K4 on the GPU: its device time per launch from a
``torch.profiler`` trace, and the wrapper's time per call by CUDA events
(host checks, ctypes and launch included).

- The whole track step (``ops/track_cuda.py::track_frames``) at K = 64
  (the headline's) and 1,024 slots, launched 1 x 1 (``bind_env``), 1 x 8
  (``bind_env_multi`` at S = 8) and 8 x 1 (the fleet at B = 8), on
  ``bench_cases.track_scene``'s banks and detections (D = 32; 128 at
  K = 1,024).
- The decision scan alone (``ops/assign_cuda.py::assoc_scan``) at bank
  sizes K = 64, 128, 256 and 1,024 with D = 32 detections, 4 or all 32
  valid.

Each result is held bit for bit against its plain version.  Prints the
card's name and power limit beside every time.

    python scripts/micro_torch_assoc.py [--reps 200] [--repo DIR]
        [--position-filter lpf [ihgp]] [--track-only]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/), so two versions can be measured in turns in one
call; ``--position-filter`` times the whole track step under each
position filter given (``ihgp``: a position pass chained before each
velocity pass); ``--track-only`` leaves the decision scan out.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 32
KW = dict(thr=0.5, dt_gp=0.1, interp_gap_factor=3.0)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def operands(k: int, n_valid: int, device) -> tuple:
    """A half-alive bank of k slots and D detections, n_valid of them
    valid, the first four near alive tracks."""
    g = np.random.default_rng(k)
    af0 = torch.from_numpy(g.uniform(-4, 4, (k, 3)).astype(np.float32))
    ai0 = torch.stack([(torch.arange(k) % 2).int(), torch.arange(k).int(),
                       torch.from_numpy(g.permutation(k)).int()], 1).int()
    dets = torch.from_numpy(g.uniform(-4, 4, (D, 4)).astype(np.float32))
    dets[:4, :2] = af0[1:8:2, :2] + 0.1
    dets[:, 3] = 0.6
    dv = torch.arange(D) < n_valid
    return tuple(t.to(device) for t in (af0, ai0, dets, dv)) + (
        torch.tensor(True, device=device),
        torch.tensor(k, dtype=torch.int32, device=device),
        torch.tensor(k, dtype=torch.int32, device=device))


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.reshape(-1), b.reshape(-1).to(a.dtype)
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def device_us(fn, kernel: str, reps: int) -> float:
    """Mean device time per launch of the kernel named ``kernel`` while fn
    runs ``reps`` times, us, from the trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
    if not rows:
        raise SystemExit(f"micro_torch_assoc: no {kernel} in the trace")
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


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return _bits(a, b)
    return all(_same(x, y) for x, y in zip(a, b))


def run_track(device="cuda", reps: int = 200, log=print, position_filter: str = "lpf") -> dict:
    """{(K, B, S): (device us per launch, wrapper ms per call)} of the whole
    track step under ``position_filter``; raises unless K4 equals its plain
    version."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    smi = card()
    cfg = bench_cases.bench_config()
    if position_filter != "lpf":
        cfg = cfg.replace(position_filter=position_filter)
    gains = Tracker(cfg, device).gains_xy
    out = {}
    for k in (64, 1024):
        for b, s in ((1, 1), (1, 8), (8, 1)):
            d = 32 if k == 64 else 128
            args = bench_cases.track_scene(k + 10 * b + s, cfg, k, d, b, s, (), device)
            kw = dict(config=cfg, gains_xy=gains)
            if not _same(track_cuda.track_frames(*args, **kw),
                         track_cuda.track_frames_plain(*args, **kw)):
                raise SystemExit(f"micro_torch_assoc: K4 differs from its plain version at K={k}")
            fn = (lambda a=args, w=kw: track_cuda.track_frames(*a, **w))
            out[(k, b, s)] = (device_us(fn, "track_step_kernel", reps), wrapper_ms(fn, reps))
            log(f"[assoc] {smi}: K4 track step {position_filter} K={k} {b} x {s} frames D={d} "
                f"({int(args[2].sum())} valid detections): device {out[(k, b, s)][0]:.3f} us "
                f"per launch (torch.profiler, {reps} launches), wrapper "
                f"{out[(k, b, s)][1]:.4f} ms per call (CUDA events)")
    return out


def run(device="cuda", reps: int = 200, log=print, position_filters=("lpf",),
        track_only: bool = False) -> dict:
    """{(K, valid detections): (device us per launch, wrapper ms per call)}
    of the decision scan alone, after ``run_track``'s under each position
    filter; raises unless K4 equals its plain version on every input."""
    from multiple_object_tracking_lidar_tpu_torch.ops import assign_cuda

    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_assoc: needs a CUDA device")
    for pf in position_filters:
        run_track(device, reps, log, pf)
    if track_only:
        return {}
    smi = card()
    out = {}
    for k in (64, 128, 256, 1024):
        for n_valid in (4, D):
            args = operands(k, n_valid, device)
            got = assign_cuda.assoc_scan(*args, **KW)
            want = assign_cuda.assoc_scan_plain(*args, **KW)
            ok = want[9]
            if not all(_bits(a[ok] if i == 6 else a, b[ok] if i == 6 else b)
                       for i, (a, b) in enumerate(zip(got, want))):
                raise SystemExit(f"micro_torch_assoc: K4 differs from its plain version at K={k}")
            fn = (lambda a=args: assign_cuda.assoc_scan(*a, **KW))
            out[(k, n_valid)] = (device_us(fn, "assoc_scan_kernel", reps), wrapper_ms(fn, reps))
            log(f"[assoc] {smi}: K4 scan K={k} D={D}, {n_valid} valid: device "
                f"{out[(k, n_valid)][0]:.3f} us per launch (torch.profiler, {reps} launches), "
                f"wrapper {out[(k, n_valid)][1]:.4f} ms per call (CUDA events)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--position-filter", nargs="+", default=["lpf"], choices=["lpf", "ihgp"])
    ap.add_argument("--track-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    run(reps=args.reps, position_filters=args.position_filter, track_only=args.track_only)


if __name__ == "__main__":
    main()
