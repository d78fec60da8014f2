"""Times the Hungarian auction on the GPU: K4's Hungarian build (the whole
track step under ``association="hungarian"``) and K12 (the auction alone),
each by its device time per launch from a ``torch.profiler`` trace (the
mean over the launches the trace recorded: the profiler drops some events)
and its wrapper's time per call by CUDA events.

- K4 hungarian on ``bench_cases.track_scene``'s gated banks (tracks in
  pairs 0.35 m apart, detections within the gate): K = 64, D = 32 launched
  1 x 1 and 1 x 8, and K = 1,024, D = 128 at 1 x 1.
- K12 on the same 1 x 1 frames' gate costs (``ops/hungarian.py::
  gate_costs``), and its iterations per phase.

Each result is held bit for bit against its plain version once.  Prints the
card's name and power limit beside every time.

    python scripts/micro_torch_auction.py [--reps 20] [--repo DIR]

``--repo DIR`` times the port of another checkout (a version unpacked
under build/), so two versions can be measured in turns in one call.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def device_us(fn, reps: int) -> tuple[float, float]:
    """(device us per launch, launches recorded per call) of fn, one launch
    per call, from a torch.profiler trace of ``reps`` calls after a
    warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return float("nan"), 0.0
    return sum(e.time_range.elapsed_us() for e in evs) / len(evs), len(evs) / reps


def same_bits(a, b) -> bool:
    """Every tensor of two (nested) tuples bit for bit, NaN as one pattern."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            a, b = (torch.where(torch.isnan(x), torch.nan, x).view(torch.int32) for x in (a, b))
        return torch.equal(a, b)
    return all(same_bits(x, y) for x, y in zip(a, b))


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda, track_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import EPS, gate_costs
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state

    dev = torch.device("cuda", 0)
    smi = card()
    cfg = bench_cases.hungarian_case(device=dev)[0]
    gains = Tracker(cfg, dev).gains_xy
    kw = dict(config=cfg, gains_xy=gains)
    tag = os.path.relpath(os.path.abspath(args.repo), REPO) or "."
    for k, d, s in ((64, 32, 1), (64, 32, 8), (1024, 128, 1)):
        scene = track_scene(5, cfg, k, d, 1, s, (), dev, gated=True)
        got = track_cuda.track_frames(*scene, **kw)
        same = same_bits(got, track_cuda.track_frames_plain(*scene, **kw))
        us, rec = device_us(lambda: track_cuda.track_frames(*scene, **kw), args.reps)
        ms = event_ms(lambda: track_cuda.track_frames(*scene, **kw), max(2, args.reps // 4))
        print(f"[{tag}] {smi}: K4 hungarian K={k} D={d} 1 x {s}: device {us:.2f} us per launch "
              f"({rec:.2f} recorded per call), wrapper {ms:.4f} ms per call (CUDA events); "
              f"bit for bit the plain version: {same}; assoc_saturated "
              f"{got[1].assoc_saturated.tolist()}", flush=True)
        if s == 1:
            st0 = map_state(lambda x: x[0], scene[0])
            C, F = gate_costs(st0.bank, scene[1][0, 0], scene[2][0, 0], cfg.id_threshold, True)
            a, sat, it = hungarian_cuda.auction_assign(C, F, EPS, cfg.id_threshold,
                                                       return_iters=True)
            us, rec = device_us(lambda: hungarian_cuda.auction_assign(C, F, EPS, cfg.id_threshold),
                                args.reps)
            print(f"[{tag}] {smi}: K12 D={d} K={k} (that frame's gate costs): device {us:.2f} "
                  f"us per launch ({rec:.2f} recorded per call); iterations per phase "
                  f"{it.tolist()} ({int(it.sum())} in all, {1e3 * us / max(int(it.sum()), 1):.1f} "
                  f"ns each); saturated {int(sat)}", flush=True)


if __name__ == "__main__":
    main()
