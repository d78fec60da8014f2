"""Times the port's ``pair_stats_pallas`` (K3) on the GPU at the shapes of
the JAX package's ``scripts/micro_pair_stats.py``: S = 8 frames of a C = 32,
P = 384 member table, 4 active slots of 180-340 members each, seed 7.

Three variants, all on K3, held bit for bit against each other:

- one call per frame, ``slab_rows=None`` (the JAX script's scan shape);
- one call per frame, ``slab_rows=128`` (the TPU kernel's row slabs; K3's
  result does not depend on it);
- one flattened call over the S * C slots.

Times by CUDA events, the variants in turns (a, b, c, c, b, a; the min of
each pair), each beside the card's name and power limit.

    python scripts/micro_torch_pair_stats.py [--reps 200]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiple_object_tracking_lidar_tpu_torch.ops.centroid_pallas import (  # noqa: E402
    pair_stats_pallas,
)

S, C, P = 8, 32, 384


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_operands(device):
    r = np.random.default_rng(7)
    mpts = np.zeros((S, C, P, 3), np.float32)
    mm = np.zeros((S, C, P), bool)
    for f in range(S):
        for c in range(4):  # headline frames have 3-4 active slots
            n = int(r.integers(180, 340))
            mpts[f, c, :n] = r.normal(0, 1, (n, 3)).astype(np.float32)
            mm[f, c, :n] = True
    return torch.from_numpy(mpts).to(device), torch.from_numpy(mm).to(device)


def variants(mpts, mm) -> dict:
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    run(reps=ap.parse_args().reps)


if __name__ == "__main__":
    main()
