"""Writes tests/golden/torch_auction_problems.npz: the auction problems the
headline and the dense scene pose under ``association="hungarian"``, one
per frame -- the gate's (cost, feasible) of the bank before the frame and
the frame's detections (``ops/hungarian.py::gate_costs``), as the track
step builds them -- for tests/test_torch_auction_schedule.py.

The port's plain route on the CPU, which the tests hold bit for bit to the
JAX package on these scenes (tests/test_torch_golden_hungarian.py), steps
the tracker: 8 headline frames and 4 dense frames, ~20 s on one thread.

    python scripts/make_torch_auction_problems.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "golden", "torch_auction_problems.npz")


def scene_problems(case, n_frames: int):
    """((n, D, K) f32 costs, (n, D, K) bool feasible, the gate) of a
    scene's first n_frames frames."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import gate_costs
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    dev = torch.device("cpu")
    cfg, env, sc = case(device=dev)
    tracker = Tracker(cfg, dev)
    plan, step, st = tracker.plan(env), tracker.bind_env(env), tracker.init_state()
    costs, feas = [], []
    for k in range(n_frames):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        P, M = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
        T = torch.tensor([t], dtype=torch.float32)
        p = tracker.perceive(Frame(P, M, T), plan)
        c, f = gate_costs(st.bank, p.dets[0], p.det_valid[0], cfg.id_threshold, st.initialized)
        costs.append(c.numpy())
        feas.append(f.numpy())
        st, _ = step(st, Frame(P[0], M[0], T[0]))
    return np.stack(costs), np.stack(feas), cfg.id_threshold


def main() -> None:
    sys.path.insert(0, REPO)
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    torch.set_num_threads(1)
    out = {}
    for name, case, n in (("headline", bench_cases.hungarian_case, 8),
                          ("dense", bench_cases.dense_hungarian_case, 4)):
        c, f, thr = scene_problems(case, n)
        out.update({f"{name}_cost": c, f"{name}_feas": f, f"{name}_thr": np.float64(thr)})
        print(f"{name}: {c.shape}, {int(f.sum())} feasible pairs")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
