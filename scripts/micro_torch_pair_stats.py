"""Times the port's ``pair_stats_pallas`` (K3) on the GPU at the shapes of
the JAX package's ``scripts/micro_pair_stats.py``: S = 8 frames of a C = 32,
P = 384 member table, 4 active slots of 180-340 members each, seed 7;
then the tracking paths' circumcenter route.

Three K3 variants, held bit for bit against each other:

- one call per frame, ``slab_rows=None`` (the JAX script's scan shape);
- one call per frame, ``slab_rows=128`` (the TPU kernel's row slabs; K3's
  result does not depend on it);
- one flattened call over the S * C slots.

Times by CUDA events, the variants in turns (a, b, c, c, b, a; the min of
each pair), each beside the card's name and power limit.

The route (``ops/centroid.py::circumcenter_features_table_stacked``, the
(S, C, 4) detections of S stacked member tables: K3f in one launch) at
S = 1 and 8, C = 32 (P = 384, the headline's table) and C = 64 (P = 512,
configuration G's), 4 active slots of 47-89% of P members per frame: its
device time per call from a ``torch.profiler`` trace (every kernel, copy
and memset summed), its device operations per call and its wrapper time by
CUDA events, after holding it bit for bit against K3's pair stats followed
by the eager ``circumcenter_from_pair_stats``; and K3's own device time
per launch on the same S * C slots.

    python scripts/micro_torch_pair_stats.py [--reps 200] [--repo DIR]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/): there the route may be K3 plus the eager tail, so
the two are measured in turns in one call.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, C, P = 8, 32, 384


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_operands(device, s=S, c=C, p=P):
    r = np.random.default_rng(7)
    mpts = np.zeros((s, c, p, 3), np.float32)
    mm = np.zeros((s, c, p), bool)
    lo, hi = (180, 340) if p == P else (int(0.47 * p), int(0.89 * p))
    for f in range(s):
        for k in range(4):  # headline frames have 3-4 active slots
            n = int(r.integers(lo, hi))
            mpts[f, k, :n] = r.normal(0, 1, (n, 3)).astype(np.float32)
            mm[f, k, :n] = True
    return torch.from_numpy(mpts).to(device), torch.from_numpy(mm).to(device)


def variants(mpts, mm) -> dict:
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid_pallas import pair_stats_pallas

    def per_frame(slab_rows):
        def fn():
            outs = [pair_stats_pallas(mpts[f], mm[f], slab_rows=slab_rows) for f in range(S)]
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
        return fn

    def flat():
        cm, fr = pair_stats_pallas(mpts.reshape(S * C, P, 3), mm.reshape(S * C, P))
        return cm.reshape(S, C, P), fr.reshape(S, C, P)

    return {"per frame, slab_rows=None": per_frame(None),
            "per frame, slab_rows=128": per_frame(128),
            f"flattened {S * C} slots": flat}


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def run(device="cuda", reps: int = 200, log=print) -> dict:
    """{variant: ms per S = 8 frames}; raises unless every variant gives
    the first one's bits."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_pair_stats: needs a CUDA device")
    smi = card()
    mpts, mm = make_operands(device)
    fns = variants(mpts, mm)
    ref = None
    for name, fn in fns.items():
        cm, fr = fn()
        torch.cuda.synchronize()
        if ref is None:
            ref = (cm, fr)
        elif not (torch.equal(cm.view(torch.int32), ref[0].view(torch.int32))
                  and torch.equal(fr, ref[1])):
            raise SystemExit(f"micro_torch_pair_stats: {name} differs from the first variant")
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cuda_ms(fns[n], reps))
    result = {n: min(t) for n, t in times.items()}
    for n in names:
        log(f"[pair_stats] {smi}: {n}: {times[n][0]:.4f}/{times[n][1]:.4f} ms per "
            f"S={S} frames (C={C}, P={P}, 4 active slots; min {result[n]:.4f})")
    log(f"[pair_stats] {smi}: all {len(names)} variants bit for bit equal")
    return result


def device_profile(fn, reps: int) -> tuple[float, float, float]:
    """(device us per call, device ops per call, us per call of its
    longest kernel) of fn from a torch.profiler trace of ``reps`` calls
    after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
            n_ops += 1
    return sum(per.values()), n_ops / reps, max(per.values())


def run_route(device="cuda", reps: int = 200, log=print) -> dict:
    """{(S, C): (device us, device ops, wrapper ms) per call of the
    tracking paths' circumcenter route, and K3's own device us per launch
    on the same slots}; raises unless the route equals K3's pair stats
    followed by the eager selection, bit for bit."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_pair_stats: needs a CUDA device")
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_features_table_stacked, circumcenter_from_pair_stats)
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid_cuda import pair_stats

    smi = card()
    result = {}
    for c, p in ((32, 384), (64, 512)):
        mp8, mm8 = make_operands(device, 8, c, p)
        for s in (1, 8):
            mpts, mm = mp8[:s].contiguous(), mm8[:s].contiguous()
            t = torch.arange(s, dtype=torch.float32, device=device) * 0.1 + 0.05
            got = circumcenter_features_table_stacked(mpts, mm, t)
            flat, fmm = mpts.reshape(s * c, p, 3), mm.reshape(s * c, p)
            ref = circumcenter_from_pair_stats(*pair_stats(flat, fmm), flat, fmm,
                                               t.repeat_interleave(c))
            torch.cuda.synchronize()
            if not torch.equal(got.reshape(s * c, 4).cpu().view(torch.int32),
                               ref.cpu().view(torch.int32)):
                raise SystemExit(f"micro_torch_pair_stats: the route differs from K3 + the "
                                 f"eager selection at S={s} C={c}")
            fn = lambda: circumcenter_features_table_stacked(mpts, mm, t)  # noqa: E731
            wrapper = min(cuda_ms(fn, reps), cuda_ms(fn, reps))
            dev_us, ops, _ = device_profile(fn, reps)
            k3_us = device_profile(lambda: pair_stats(flat, fmm), reps)[2]
            result[(s, c)] = (dev_us, ops, wrapper, k3_us)
            log(f"[circumcenter route] {smi}: S={s} C={c} P={p} (4 active slots per frame): "
                f"device {dev_us:.2f} us/call in {ops:.1f} ops, wrapper {wrapper:.4f} ms/call; "
                f"K3 alone {k3_us:.2f} us/launch on the device; bit for bit K3 + the eager "
                f"selection")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    run(reps=args.reps)
    run_route(reps=args.reps)


if __name__ == "__main__":
    main()
