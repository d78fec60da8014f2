"""Times K1 and K5, the digit histograms (``ops/voxel_grid_cuda.py``), on the
GPU: fused (``ops/voxel_grid.py::voxel_accumulate_stacked``) and raw
(``digit_sums_stacked``, the kernel fleet's entry), each through the
dispatcher, so a checkout whose kernels stop at a smaller grid is timed on
the route it takes there.  Grids (``grids``): the headline's 5,500 cells
(N = 106,496), the CLI's 70,200 (the headline frames) and the default
scene's 193,536 (configuration G's frames, N = 131,072), each at S = 1 and
S = 8 stacked frames.  Per call: the device
time from a ``torch.profiler`` trace (every kernel, copy and memset the
call launches, summed), the device operations, and the wrapper's time by
CUDA events (host checks, ctypes and launches included).  Beside them the
library yardstick, one ``Tensor.index_add_`` of the (S N, C) int32 digits
into an (S n_cells + 1, C) int32 table on precomputed targets (the
quantize left out; the table zeroed once, outside the timed calls).  Each
result is held bit for bit against its plain version first.  Prints the
card's name and power limit beside every time.

    python scripts/micro_torch_digits.py [--reps 50] [--repo DIR] [--sweep]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/), so two versions can be measured in turns in one
call.  ``--sweep`` (this checkout's kernels) times every layout (cell
ranges x point chunks) of K1 and K5 on each grid, each held bit for bit
against the plain version: the measurements the layout rule rests on.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# About one torch.profiler trace in a hundred on the H100 loses device
# events at its start or at its end: a few, a block of a hundred markers,
# or every event of the trace.  The losses come in runs of up to five
# consecutive traces, under every CUPTI setting PyTorch reads
# (``scripts/probe_torch_trace_loss.py``).  So each profiled run sits
# between MARKS marker kernels (``torch.cuda._sleep``'s spin_kernel, ~10 us
# each) that the counts leave out, and a trace is whole when it kept more
# markers than one block: a loss at either end then stopped short of the
# run.  A trace that is not whole is taken again after a pause that grows
# with each try (RETRY_PAUSE_S seconds times the try), to outlast a run of
# losses.
MARKS = 128
MARK_CYCLES = 20_000
TRIES = 8
RETRY_PAUSE_S = 0.5
retaken = 0   # traces taken again in this process, for the caller's log


def whole_trace(run, tries: int = TRIES, with_stack: bool = False):
    """(every event, the run's device events without the markers, whole)
    of a torch.profiler trace of ``run()`` between marker kernels.  A trace
    that is not whole is taken again, up to ``tries`` times in all, after a
    pause of ``RETRY_PAUSE_S`` times the try; the last one comes back with
    whole False."""
    global retaken
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            retaken += 1
            time.sleep(RETRY_PAUSE_S * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_stack=with_stack) as prof:
            for _ in range(MARKS):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            for _ in range(MARKS):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        evs = prof.events()
        dev = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
        ops = [e for e in dev if "spin_kernel" not in e.name]
        whole = len(dev) - len(ops) > MARKS
        if whole:
            break
    return evs, ops, whole


def device_profile(fn, reps: int):
    """(device us per call, device ops per call) of fn from a whole
    torch.profiler trace (``whole_trace``) of ``reps`` calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    _, ops, _ = whole_trace(run)
    return sum(e.time_range.elapsed_us() for e in ops) / reps, len(ops) / reps


def grids():
    """(label, scene, leaf_xy, leaf_z, case) of the timed grids, built here
    from what every checkout's ``bench_cases`` has: the headline's, the
    CLI's 104 x 225 x 3 at a 0.05 m leaf (its corner the headline scene's)
    and the default scene's (``TrackerConfig()``)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds, TrackerConfig

    cfg, g = bench_cases.headline_case()[0], TrackerConfig()
    sc = cfg.scene
    cli = SceneBounds(x_min=sc.x_min, x_max=sc.x_min + 103.5 * 0.05, y_min=sc.y_min,
                      y_max=sc.y_min + 224.5 * 0.05, z_min=sc.z_min, z_max=sc.z_min + 2.5)
    return (("headline", sc, cfg.voxel_leaf_size, cfg.leaf_z, "headline"),
            ("CLI grid", cli, 0.05, 1.0, "headline"),
            ("default scene", g.scene, g.voxel_leaf_size, g.leaf_z, "default"))


def shapes(device):
    """{name: (points, mask, (scene, leaf_xy, leaf_z))} on the card."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame

    out = {}
    for label, scene, leaf, leaf_z, case in grids():
        ccfg, _, sc = getattr(bench_cases, f"{case}_case")()
        rows = [padded_frame(sc, k, ccfg.caps.n_max_points) for k in range(8)]
        pts = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
        mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
        for s in (1, 8):
            out[f"{label} S={s}"] = (pts[:s].contiguous(), mask[:s].contiguous(),
                                     (scene, leaf, leaf_z))
    return out


def digit_rows(vg, pts, mask, kw, quant):
    """The library call's operands: (S N,) int64 targets (frame * n_cells +
    cell, S n_cells for a dropped point), (S N, C) int32 digits, and the
    zeroed (S n_cells + 1, C) int32 table."""
    k = vg.kernel_params(*kw, quant=quant)
    s, nc = pts.shape[0], k["n_cells"]
    ok, lin, (fx, fy, fz) = vg.kept_cells(pts, mask, k)
    chans = []
    for c, fl, leaf, half, sq in ((0, fx, "leaf_xy", "half_xy", "sq_xy"),
                                  (1, fy, "leaf_xy", "half_xy", "sq_xy"),
                                  (2, fz, "leaf_z", "half_z", "sq_z")):
        q = torch.round(vg._frac_scaled(pts[..., c], fl, k[leaf], k[half], k[sq], ok))
        if quant == "fast":
            chans.append(torch.clamp(q, -127, 127).to(torch.int32))
        else:
            chans.extend(d.to(torch.int32) for d in vg.split_exact_digits(q.to(torch.int64)))
    chans.append(ok.to(torch.int32))
    digits = torch.stack(chans, dim=-1).reshape(-1, len(chans)).contiguous()
    frame = torch.arange(s, device=pts.device)[:, None]
    tgt = torch.where(ok, frame * nc + lin, s * nc).reshape(-1)
    table = torch.zeros((s * nc + 1, len(chans)), dtype=torch.int32, device=pts.device)
    return tgt, digits, table


def entries(vg, vgd, pts, mask, kw):
    """{entry: (call through the dispatcher, plain call)}."""
    npts = (mask != 0).sum(1).to(torch.int32)
    return {
        "K1": (lambda: vgd.voxel_accumulate_stacked(pts, mask, *kw, quant="fast"),
               lambda: vg.accumulate_fast_stacked_plain(pts.cpu(), mask.cpu(), *kw)),
        "K1 raw": (lambda: vgd.digit_sums_stacked(pts, mask, *kw, "fast"),
                   lambda: (vg.fast_digit_sums(pts.cpu(), mask.cpu(), *kw), npts.cpu())),
        "K5": (lambda: vgd.voxel_accumulate_stacked(pts, mask, *kw, quant="exact"),
               lambda: vg.accumulate_exact_stacked_plain(pts.cpu(), mask.cpu(), *kw)),
        "K5 raw": (lambda: vgd.digit_sums_stacked(pts, mask, *kw, "exact"),
                   lambda: (vg.exact_digit_sums(pts.cpu(), mask.cpu(), *kw), npts.cpu())),
    }


def same(a, b) -> bool:
    return all(torch.equal(x.cpu().view(torch.int32), y.cpu().view(torch.int32))
               for x, y in zip(a, b))


def run(device="cuda", reps: int = 50, log=print) -> dict:
    """{(shape, entry): (device us, device ops, wrapper ms, the library
    call's device us, its wrapper ms)}, each call through the dispatcher;
    raises unless every result equals its plain version."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_digits: needs a CUDA device")
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid as vgd
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    smi = card()
    result = {}
    for name, (pts, mask, kw) in shapes(device).items():
        nc = vg.kernel_params(*kw)["n_cells"]
        for ename, (fk, fp) in entries(vg, vgd, pts, mask, kw).items():
            if not same(fk(), fp()):
                raise SystemExit(f"micro_torch_digits: {ename} differs from its plain version "
                                 f"at {name}")
            w = min(cuda_ms(fk, reps), cuda_ms(fk, reps))
            d, ops = device_profile(fk, reps)
            tgt, digits, table = digit_rows(vg, pts, mask, kw, "fast" if "K1" in ename else "exact")
            lib = lambda: table.index_add_(0, tgt, digits)  # noqa: E731
            w_l = min(cuda_ms(lib, reps), cuda_ms(lib, reps))
            d_l, _ = device_profile(lib, reps)
            result[(name, ename)] = (d, ops, w, d_l, w_l)
            log(f"[digits] {smi}: {ename} {name} N={pts.shape[1]} cells={nc}: device {d:.2f} "
                f"us/call in {ops:.1f} ops, wrapper {w:.4f} ms/call; index_add_ of the "
                f"{digits.shape[1]} int32 digits: device {d_l:.2f} us, {w_l:.4f} ms/call")
    return result


def sweep(device="cuda", reps: int = 20, log=print) -> None:
    """K1 and K5, fused and raw, on each grid at every layout (cell ranges
    x point chunks, from the fewest ranges that fit to four times as many):
    device us per call, each held bit for bit against the plain version
    first; the rule's layout (``digit_layout``) marked."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    smi = card()
    dev = torch.device(device)
    top = vg.max_cluster(dev)
    for name, (pts, mask, kw) in shapes(device).items():
        nc = vg.kernel_params(*kw)["n_cells"]
        cpu = (pts.cpu(), mask.cpu(), *kw)
        npts = (mask != 0).sum(1).to(torch.int32).cpu()
        plain = {"K1": vg.accumulate_fast_stacked_plain(*cpu),
                 "K1 raw": (vg.fast_digit_sums(*cpu), npts),
                 "K5": vg.accumulate_exact_stacked_plain(*cpu),
                 "K5 raw": (vg.exact_digit_sums(*cpu), npts)}
        fns = {"K1": vg.accumulate_fast_stacked, "K1 raw": vg.accumulate_fast_stacked_raw,
               "K5": vg.accumulate_exact_stacked, "K5 raw": vg.accumulate_exact_stacked_raw}
        s = pts.shape[0]
        rules = {"K1": vg.digit_layout(nc, s, 1, dev), "K5": vg.digit_layout(nc, s, 3, dev)}
        r0 = rules["K1"][0]
        for ranges in (r0, 2 * r0, 4 * r0):
            for chunks in (1, 2, 4, 8, 16):
                if ranges > top or chunks > top:
                    continue
                row = []
                for ename, fn in fns.items():
                    call = lambda: fn(pts, mask, *kw, ranges=ranges, chunks=chunks)  # noqa: E731
                    if not same(call(), plain[ename]):
                        raise SystemExit(f"micro_torch_digits: {ename} {ranges} x {chunks} "
                                         f"differs from its plain version at {name}")
                    rule = "*" if rules[ename[:2]] == (ranges, chunks) else " "
                    row.append(f"{ename}{rule} {device_profile(call, reps)[0]:8.2f}")
                log(f"[digits sweep] {smi}: {name} cells={nc} ranges {ranges:2d} chunks "
                    f"{chunks:2d}: device us/call (* the rule's layout) " + ", ".join(row))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    if args.sweep:
        sweep(reps=min(args.reps, 20))
    else:
        run(reps=args.reps)


if __name__ == "__main__":
    main()
