"""Count, per frame, the dynamic voxels and the jnp CC's sweeps of
configurations D and G (``bench_cases.pointlist_jnp_case``,
``default_case``) under f32, bf16 and f16 over the first 8 headline
frames: the counts behind the point list's device ops and host syncs per
frame under a half dtype (``chip_smoke.py::phase_half_pointlist``).

Counts, not times: the port's path on ``--device`` (the CPU by default;
"cuda" on the card gives the same counts).

    python scripts/count_half_cc_sweeps.py [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multiple_object_tracking_lidar_tpu_torch import bench_cases  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.ops import cluster  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sweeps = []
    orig = cluster.connected_components

    def counting(*a, **k):
        labels, n_iters = orig(*a, **k)
        sweeps.append(int(n_iters.max()))
        return labels, n_iters

    counting.host_syncs = 0   # connected_components counts its syncs on this name
    cluster.connected_components = counting
    try:
        for name, case in (("D", bench_cases.pointlist_jnp_case),
                           ("G", bench_cases.default_case)):
            for dtype in ("float32", "bfloat16", "float16"):
                cfg, env, sc = case(device=args.device)
                tracker = Tracker(cfg.replace(dtype=dtype), args.device)
                step, st = tracker.bind_env(env), tracker.init_state()
                sweeps.clear()
                dynamic = []
                for k in range(8):
                    pts, mask, t = bench_cases.padded_frame(sc, k, cfg.caps.n_max_points)
                    st, o = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask),
                                           torch.tensor(t)))
                    dynamic.append(int(o.n_dynamic))
                print(f"{name} {dtype}: dynamic voxels {dynamic}; CC sweeps {sweeps}", flush=True)
    finally:
        cluster.connected_components = orig


if __name__ == "__main__":
    main()
