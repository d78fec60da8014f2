"""Write the JAX package's outputs on the headline scene as a golden file
for the PyTorch/CUDA port.

The machine with the GPU has no JAX, so the port is held against these
committed outputs there (chip_smoke.py).  Runs the JAX ``Tracker.bind_env``
on the CPU over the first 12 frames of ``bench.headline_case()`` (full
headline size: 106,496-point frames, C = 32, P = 384, K = 64) and stores
every FrameOutput field stacked over frames in
``tests/golden/torch_slice_headline.npz``.  tests/test_torch_golden.py
recomputes the first frames and checks them against the file.

    python scripts/make_torch_golden.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_slice_headline.npz")
N_FRAMES = 12


def golden_outputs(n_frames: int = N_FRAMES) -> dict:
    """{field: (n_frames, ...) array} of the JAX FrameOutputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu.tracker.state import Frame

    cfg, env, sc = bench.headline_case()
    n = cfg.caps.n_max_points
    tracker = Tracker(cfg)
    step = tracker.bind_env(env, donate_state=False)
    state = tracker.init_state()
    rows = []
    for k in range(n_frames):
        pts, t = sc.frame_arrays(k)
        buf = np.zeros((n, 3), np.float32)
        buf[: len(pts)] = pts[:n]
        mask = np.zeros(n, bool)
        mask[: min(len(pts), n)] = True
        state, out = step(
            state, Frame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t))
        )
        rows.append(jax.tree.map(np.asarray, out))
    return {f: np.stack([getattr(r, f) for r in rows]) for f in rows[0]._fields}


def main() -> None:
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    out = golden_outputs()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: {N_FRAMES} frames, {os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    main()
