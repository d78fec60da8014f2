"""K4's half builds beside its f32 build on the same values, by shape.

For each shape (one bank, one frame, lpf) the scene of
``bench_cases.track_scene`` is rounded to bf16 / f16
(``chip_smoke.half_track_inputs``) and the f32 build runs those values
widened (``chip_smoke.widen_track_inputs``, the half gains widened too):
device us per launch in turns (f32, half, half, f32; ``torch.profiler``
between marker kernels, ``chip_smoke.one_op_profile``).  K = 64 at D = 1,
8, 32 and 128, then D = 32 at K = 32, 256 and 1,024; the f32 build also
on the scene's own f32 values.  Prints the card's name and power limit.

    python3 scripts/micro_torch_k4_half.py [--reps 20]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import chip_smoke as C
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = headline_case()[0]

    def us(fn):
        t, ops, _ = C.one_op_profile(fn, args.reps)
        return t * ops

    shapes = [(64, d) for d in (1, 8, 32, 128)] + [(k, 32) for k in (32, 256, 1024)]
    for tag, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        hcfg = cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[tag])
        gh = Tracker(hcfg, dev).gains_xy
        g32 = {a: ({w: x.float() for w, x in g.items()} if isinstance(g, dict) else g.float())
               for a, g in gh.items()}
        gf = Tracker(cfg, dev).gains_xy
        for k, d in shapes:
            scene = track_scene(1960 + k + d, cfg, k, d, 1, 1, (), dev)
            hins = C.half_track_inputs(scene, dt)
            wins = C.widen_track_inputs(hins)

            def f32(w=wins):
                return track_cuda.track_frames(*w, config=cfg, gains_xy=g32)

            def half(h=hins):
                return track_cuda.track_frames(*h, config=hcfg, gains_xy=gh)

            def own(s=scene):
                return track_cuda.track_frames(*s, config=cfg, gains_xy=gf)

            a, b = us(f32), us(half)
            b2, a2 = us(half), us(f32)
            o = us(own)
            print(f"{smi}: K4 {tag} K={k} D={d} 1 x 1 lpf, device us per launch (f32 on the "
                  f"half values, {tag}, {tag}, f32 on the half values) {a:.2f}, {b:.2f}, "
                  f"{b2:.2f}, {a2:.2f}: {tag} / f32 {min(b, b2) / min(a, a2):.2f}x; f32 on the "
                  f"scene's own values {o:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
