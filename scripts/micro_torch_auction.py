"""Times the Hungarian auction on the GPU: K4's Hungarian build (the whole
track step under ``association="hungarian"``) and K12 (the auction alone),
each by its device time per launch from a ``torch.profiler`` trace (the
mean over the launches the trace recorded: the profiler drops some events)
and its wrapper's time per call by CUDA events.

- K4 hungarian on ``bench_cases.track_scene``'s gated banks (tracks in
  pairs 0.35 m apart, detections within the gate): K = 64, D = 32 launched
  1 x 1 and 1 x 8, and K = 1,024, D = 128 at 1 x 1; with ``--xl`` also K4
  xl hungarian at K = 2,048, D = 32, 1 x 1 (its f32 lpf build), and the
  f64 build of K4 hungarian at K = 64, D = 32, 1 x 1.
- K12 on the same 1 x 1 frames' gate costs (``ops/hungarian.py::
  gate_costs``), and its iterations per phase; where the port counts them
  (``auction_assign(..., return_split=True)``), each phase's iterations
  split into dummy-only (no real row unassigned) and with real bids.
- K12 on the headline's and the dense scene's own problems
  (``tests/golden/torch_auction_problems.npz``) and on synthetic (32, 64)
  problems from sparse to dense gates; from all the (32, 64) problems a
  least-squares fit of device time = a * dummy-only + b * general
  iterations + c gives ns per iteration of each kind.

Each result is held bit for bit against its plain version once.  Prints the
card's name and power limit beside every time.

    python scripts/micro_torch_auction.py [--reps 20] [--repo DIR] [--xl]

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


def k12_row(hungarian_cuda, C, F, eps, thr, reps, split):
    """(device us per launch, iterations per phase, dummy-only per phase or
    None) of K12 on one (D, K) problem."""
    if split:
        _, _, it, fast = hungarian_cuda.auction_assign(C, F, eps, thr, return_split=True)
        fast = fast.tolist()
    else:
        _, _, it = hungarian_cuda.auction_assign(C, F, eps, thr, return_iters=True)
        fast = None
    us, _ = device_us(lambda: hungarian_cuda.auction_assign(C, F, eps, thr), reps)
    return us, it.tolist(), fast


def main() -> None:
    import inspect

    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--xl", action="store_true", help="also K4 xl hungarian and the f64 build")
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
    split = "return_split" in inspect.signature(hungarian_cuda.auction_assign).parameters
    cfg = bench_cases.hungarian_case(device=dev)[0]
    gains = Tracker(cfg, dev).gains_xy
    kw = dict(config=cfg, gains_xy=gains)
    tag = os.path.relpath(os.path.abspath(args.repo), REPO) or "."
    shapes = [(64, 32, 1, cfg), (64, 32, 8, cfg), (1024, 128, 1, cfg)]
    if args.xl:
        shapes += [(64, 32, 1, cfg.replace(dtype="float64")), (2048, 32, 1, cfg)]
    fit = []   # (dummy-only, general, us) of (32, 64) problems
    for k, d, s, c in shapes:
        kwc = dict(config=c, gains_xy=Tracker(c, dev).gains_xy)
        seed = 2048 * 16 + 32 + 1 if k == 2048 else 5
        scene = track_scene(seed, c, k, d, 1, s, (), dev, gated=True)
        if c.dtype == "float64":
            st, dets, valid, t = scene
            bank = st.bank._replace(window=st.bank.window.double(), m0=st.bank.m0.double())
            scene = (st._replace(bank=bank), dets.double(), valid, t.double())
        got = track_cuda.track_frames(*scene, **kwc)
        same = same_bits(got, track_cuda.track_frames_plain(*scene, **kwc))
        reps = max(2, args.reps // 10) if k == 2048 else args.reps
        us, rec = device_us(lambda: track_cuda.track_frames(*scene, **kwc), reps)
        ms = event_ms(lambda: track_cuda.track_frames(*scene, **kwc), max(2, reps // 4))
        print(f"[{tag}] {smi}: K4 hungarian{' xl' if k > 1024 else ''} {c.dtype} K={k} D={d} "
              f"1 x {s}: device {us:.2f} us per launch ({rec:.2f} recorded per call), wrapper "
              f"{ms:.4f} ms per call (CUDA events); bit for bit the plain version: {same}; "
              f"assoc_saturated {got[1].assoc_saturated.tolist()}", flush=True)
        if s == 1 and c.dtype == "float32" and k <= 1024:
            st0 = map_state(lambda x: x[0], scene[0])
            C, F = gate_costs(st0.bank, scene[1][0, 0], scene[2][0, 0], c.id_threshold, True)
            us, it, fast = k12_row(hungarian_cuda, C, F, EPS, c.id_threshold, args.reps, split)
            n_it = max(sum(it), 1)
            print(f"[{tag}] {smi}: K12 D={d} K={k} (that frame's gate costs): device {us:.2f} "
                  f"us per launch; iterations per phase {it} ({sum(it)} in all, "
                  f"{1e3 * us / n_it:.1f} ns each); dummy-only per phase {fast}", flush=True)
            if (d, k) == (32, 64) and fast is not None:
                fit.append((sum(fast), sum(it) - sum(fast), us))
    probs = os.path.join(REPO, "tests", "golden", "torch_auction_problems.npz")
    z = np.load(probs)
    rng = np.random.default_rng(17)
    cases = [(f"{scene} frame {f}", z[f"{scene}_cost"][f], z[f"{scene}_feas"][f])
             for scene in ("headline", "dense") for f in range(z[f"{scene}_cost"].shape[0])]
    for density in (0.02, 0.05, 0.2, 0.6, 1.0):
        cost = rng.uniform(0, 0.6, (32, 64)).astype(np.float32)
        cases.append((f"synthetic (32, 64), gate density {density}", cost,
                      (cost < 0.5) & (rng.uniform(size=cost.shape) < density)))
    for label, cost, feas in cases:
        C, F = torch.from_numpy(cost).to(dev), torch.from_numpy(feas).to(dev)
        us, it, fast = k12_row(hungarian_cuda, C, F, EPS, 0.5, args.reps, split)
        print(f"[{tag}] {smi}: K12 {label} (D={cost.shape[0]}, K={cost.shape[1]}, "
              f"{int(feas.sum())} feasible): device {us:.2f} us per launch; iterations per "
              f"phase {it}, dummy-only per phase {fast}; {1e3 * us / max(sum(it), 1):.1f} ns "
              "per iteration", flush=True)
        if cost.shape == (32, 64) and fast is not None:
            fit.append((sum(fast), sum(it) - sum(fast), us))
    if len(fit) >= 3:
        A = np.asarray([[f, g, 1.0] for f, g, _ in fit])
        sol, *_ = np.linalg.lstsq(A, np.asarray([u for _, _, u in fit]), rcond=None)
        print(f"[{tag}] {smi}: K12 at (D, K) = (32, 64), {len(fit)} problems: device us = "
              f"{1e3 * sol[0]:.1f} ns x dummy-only + {1e3 * sol[1]:.1f} ns x general iterations "
              f"+ {sol[2]:.2f} us (least squares)", flush=True)


if __name__ == "__main__":
    main()
