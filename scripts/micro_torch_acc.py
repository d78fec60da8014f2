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
min of each pair), each beside the card's name and power limit.  Then K11
alone, at S = 1 and S = 8 headline frames and at the probes, beside the
library's copy, ``torch.permute(x, (0, 2, 1)).contiguous()``: the device
time per call from a ``torch.profiler`` trace (every kernel, copy and
memset of the call, summed), the device operations, the wrapper's time by
CUDA events over back-to-back calls (the larger of host and device time
per call), and the host's time per call (the host clock around the same
calls, before the synchronise), and at S = 8 the host time of each piece
of K11's wrapper.

    python scripts/micro_torch_acc.py [--reps 100] [--repo DIR]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/), so two versions can be measured in turns in one
call.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from micro_torch_digits import card, cuda_ms, device_profile  # noqa: E402

S = 8
B = 2048   # micro_transpose.py's row


def make_operands(device):
    """(points (S, N, 3), the same channel-major (S, 3, N) by K11, mask
    (S, N), the accumulator's (scene, leaf_xy, leaf_z))."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.ops.transpose_cuda import transpose_words

    cfg, _, sc = headline_case()
    rows = [padded_frame(sc, k, cfg.caps.n_max_points) for k in range(S)]
    pts = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
    mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
    return pts, transpose_words(pts), mask, (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)


def variants(pts, pts_cm, mask, kw, row) -> dict:
    """{name: (fn, the plain result it must equal, or None for K1's)}; each
    fn returns (sums, counts), or the transposed words for K11 alone."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg
    from multiple_object_tracking_lidar_tpu_torch.ops.transpose_cuda import (
        transpose_words, transpose_words_plain)

    def raw_fin(raw):
        return vg.finalize_fast_stacked(raw[0], *kw), raw[1]

    return {
        "K1": (lambda: vg.accumulate_fast_stacked(pts, mask, *kw), None),
        "K1-cm": (lambda: vg.accumulate_fast_stacked_cm(pts_cm, mask, *kw), None),
        "transpose": (lambda: (transpose_words(pts),), (transpose_words_plain(pts),)),
        "transpose + K1-cm": (lambda: vg.accumulate_fast_stacked_cm(
            transpose_words(pts), mask, *kw), None),
        "K1 raw + fin": (lambda: raw_fin(vg.accumulate_fast_stacked_raw(pts, mask, *kw)), None),
        "K1-cm raw + fin": (lambda: raw_fin(vg.accumulate_fast_stacked_cm_raw(
            pts_cm, mask, *kw)), None),
        "probe (1, B) -> (B, 1)": (lambda: (transpose_words(row.reshape(1, 1, B)),),
                                   (transpose_words_plain(row.reshape(1, 1, B)),)),
        "probe (16, 128) -> (128, 16)": (lambda: (transpose_words(row.reshape(1, 16, 128)),),
                                         (transpose_words_plain(row.reshape(1, 16, 128)),)),
    }


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def host_ms(fn, reps: int) -> float:
    """Host ms per call: the host clock around ``reps`` back-to-back calls,
    read before the synchronise (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def transpose_detail(pts, row, reps: int, log, smi) -> dict:
    """K11 and the library's copy at S = 1 and S = 8 headline frames and at
    the probes: {(entry, shape): (device us, device ops, event ms, host
    ms)}, each K11 result first held bit for bit against the copy."""
    from multiple_object_tracking_lidar_tpu_torch.ops.transpose_cuda import transpose_words

    shapes = {f"S=1 x {pts.shape[1]} points": pts[:1].contiguous(),
              f"S={S} x {pts.shape[1]} points": pts,
              f"probe (1, 1, {B}) int32": row.reshape(1, 1, B),
              "probe (1, 16, 128) int32": row.reshape(1, 16, 128)}
    out = {}
    for shape, x in shapes.items():
        calls = {"K11": lambda x=x: transpose_words(x),
                 "permute().contiguous()": lambda x=x: torch.permute(x, (0, 2, 1)).contiguous()}
        if not _bits(calls["K11"](), calls["permute().contiguous()"]()):
            raise SystemExit(f"micro_torch_acc: K11 differs from the library's copy at {shape}")
        for name, fn in calls.items():
            d, ops = device_profile(fn, reps)
            ev = min(cuda_ms(fn, reps), cuda_ms(fn, reps))
            h = min(host_ms(fn, reps), host_ms(fn, reps))
            out[(name, shape)] = (d, ops, ev, h)
            log(f"[acc] {smi}: {name} {shape}: device {d:.2f} us/call in {ops:.1f} ops, "
                f"events {ev:.4f} ms/call, host {h:.4f} ms/call")
    host_breakdown(pts, reps, log, smi)
    return out


def host_breakdown(x, reps: int, log, smi) -> None:
    """Host us per call of the pieces of K11's wrapper at x's shape: the
    library lookup, the stream lookup, the output's allocation and the
    ctypes call that launches the kernel (arguments prepared)."""
    from multiple_object_tracking_lidar_tpu_torch import _build

    s, r, c = x.shape
    out = torch.empty((s, c, r), dtype=x.dtype, device=x.device)
    lib, st = _build.load(), _build.stream_ptr(x.device)
    xp, op = x.data_ptr(), out.data_ptr()
    pieces = {
        "load()": _build.load,
        "stream_ptr()": lambda: _build.stream_ptr(x.device),
        "torch.empty": lambda: torch.empty((s, c, r), dtype=x.dtype, device=x.device),
        "ctypes launch": lambda: lib.motl_transpose32(xp, op, s, r, c, st),
    }
    row = ", ".join(f"{k} {1e3 * min(host_ms(f, reps), host_ms(f, reps)):.2f}"
                    for k, f in pieces.items())
    log(f"[acc] {smi}: K11's wrapper at {tuple(x.shape)}, host us per call: {row}")


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
    transpose_detail(pts, row, reps, log, smi)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    run(reps=args.reps)


if __name__ == "__main__":
    main()
