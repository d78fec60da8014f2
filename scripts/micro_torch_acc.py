"""Times the port's fast-digit accumulator in both point layouts on the GPU,
at headline shapes: S = 8 headline frames of 106,496 points, the 0.1 m
leaf's 5,500-cell grid (``bench_cases.headline_case``).

The port's counterpart of the JAX package's accumulator probes
(``scripts/micro_acc_v5.py``, ``micro_acc_v7.py``, ``micro_transpose.py``),
which compute K1's function in TPU operand layouts: row-major (S, N, 3)
against channel-major (S, 3, N), and the transpose that channel-major
reading makes unnecessary.  Variants, all held bit for bit against K1:

- ``K1``: ``accumulate_fast_stacked`` on (S, N, 3) rows;
- ``K1-cm``: ``accumulate_fast_stacked_cm`` on (S, 3, N) planes;
- ``transpose``: K11 (``transpose_words``), the (S, N, 3) -> (S, 3, N)
  conversion alone, held against the plain transpose;
- ``transpose + K1-cm``: what a caller holding rows pays for K1-cm;
- ``K1 raw + fin`` and ``K1-cm raw + fin``: each histogram alone, then
  ``finalize_fast_stacked``;
- ``probe (1, B) -> (B, 1)`` and ``probe (16, 128) -> (128, 16)``: K11 on
  ``micro_transpose.py``'s own (1, 2048) int32 row, direct and tiled,
  held against the plain transpose.

Times by CUDA events, the variants in turns (forward, then backward; the
min of each pair), each beside the card's name and power limit.

    python scripts/micro_torch_acc.py [--reps 100]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multiple_object_tracking_lidar_tpu_torch.bench_cases import (  # noqa: E402
    headline_case,
    padded_frame,
)
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.ops.transpose_cuda import (  # noqa: E402
    transpose_words,
    transpose_words_plain,
)

S = 8
B = 2048   # micro_transpose.py's row


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_operands(device):
    """(points (S, N, 3), the same channel-major (S, 3, N) by K11, mask
    (S, N), the accumulator's (scene, leaf_xy, leaf_z))."""
    cfg, _, sc = headline_case()
    rows = [padded_frame(sc, k, cfg.caps.n_max_points) for k in range(S)]
    pts = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
    mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
    return pts, transpose_words(pts), mask, (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)


def variants(pts, pts_cm, mask, kw, row) -> dict:
    """{name: (fn, the plain result it must equal, or None for K1's)}; each
    fn returns (sums, counts), or the transposed words for K11 alone."""
    return {
        "K1": (lambda: vg.accumulate_fast_stacked(pts, mask, *kw), None),
        "K1-cm": (lambda: vg.accumulate_fast_stacked_cm(pts_cm, mask, *kw), None),
        "transpose": (lambda: (transpose_words(pts),), (transpose_words_plain(pts),)),
        "transpose + K1-cm": (lambda: vg.accumulate_fast_stacked_cm(
            transpose_words(pts), mask, *kw), None),
        "K1 raw + fin": (lambda: _raw_fin(vg.accumulate_fast_stacked_raw(pts, mask, *kw), kw),
                         None),
        "K1-cm raw + fin": (lambda: _raw_fin(vg.accumulate_fast_stacked_cm_raw(
            pts_cm, mask, *kw), kw), None),
        "probe (1, B) -> (B, 1)": (lambda: (transpose_words(row.reshape(1, 1, B)),),
                                   (transpose_words_plain(row.reshape(1, 1, B)),)),
        "probe (16, 128) -> (128, 16)": (lambda: (transpose_words(row.reshape(1, 16, 128)),),
                                         (transpose_words_plain(row.reshape(1, 16, 128)),)),
    }


def _raw_fin(raw, kw):
    return vg.finalize_fast_stacked(raw[0], *kw), raw[1]


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


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def run(device="cuda", reps: int = 100, log=print) -> dict:
    """{variant: ms per call}; raises unless every variant gives K1's sums
    and counts bit for bit, and K11 the plain transpose's words."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_acc: needs a CUDA device")
    smi = card()
    pts, pts_cm, mask, kw = make_operands(device)
    row = torch.from_numpy(np.random.default_rng(0).integers(0, 128, B).astype(np.int32)).to(device)
    fns = variants(pts, pts_cm, mask, kw, row)
    ref = fns["K1"][0]()
    for name, (fn, plain) in fns.items():
        out = fn()
        torch.cuda.synchronize()
        want = ref if plain is None else plain
        if not (len(out) == len(want) and all(_bits(a, b) for a, b in zip(out, want))):
            raise SystemExit(f"micro_torch_acc: {name} differs from "
                             f"{'K1' if plain is None else 'the plain transpose'}")
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cuda_ms(fns[n][0], reps))
    result = {n: min(t) for n, t in times.items()}
    for n in names:
        what = f"(1, {B}) int32" if n.startswith("probe") else f"S={S} x {pts.shape[1]} points"
        log(f"[acc] {smi}: {n}: {times[n][0]:.4f}/{times[n][1]:.4f} ms per {what} "
            f"(min {result[n]:.4f})")
    log(f"[acc] {smi}: every variant bit for bit K1's sums and counts; K11 the plain "
        "transpose's words")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    run(reps=ap.parse_args().reps)


if __name__ == "__main__":
    main()
