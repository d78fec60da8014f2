"""Times K6 in its f32 mode ("K6f", the point-list dense accumulator of
``voxel_mode="dense"``, ``ops/voxel_grid_cuda.py::accumulate_f32_stacked``)
on the GPU beside ``torch.index_add``, one PyTorch call computing the same
sums with float atomics (the yardstick; the port never calls it):

- the headline (0.1 m leaf, 5,500 cells, N = 106,496 points per frame);
- configuration G's grid (``TrackerConfig()``: 0.05 m leaf, 193,536 cells,
  N = 131,072);

each at S = 1 and S = 8 stacked frames of the headline scene.  Per shape:
the device time per call from a ``torch.profiler`` trace (every kernel,
copy and memset the call launches, summed), the device operations per
call, the wrapper's time per call by CUDA events (host checks, ctypes and
launches included), and the same for ``index_add``.  Each K6f result is
held bit for bit against its plain version first.  Prints the card's name
and power limit beside every time.

    python scripts/micro_torch_sorted_sums.py [--reps 50] [--repo DIR] [--breakdown]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/), so two versions can be measured in turns in one
call; ``--breakdown`` lists the device time of each kernel.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

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


def device_profile(fn, reps: int):
    """(device us per call, device ops per call, {kernel: us per call}) of
    fn from a torch.profiler trace of ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    per = {}
    for e in evs:
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return sum(per.values()), len(evs) / reps, per


def shapes(device):
    """{name: (points, mask, (scene, leaf_xy, leaf_z))} on the card."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame

    out = {}
    for tag, case in (("headline", bench_cases.headline_case), ("G", bench_cases.default_case)):
        cfg, _, sc = case()
        rows = [padded_frame(sc, k, cfg.caps.n_max_points) for k in range(8)]
        pts = torch.from_numpy(np.stack([r[0] for r in rows])).to(device)
        mask = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
        kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
        for s in (1, 8):
            out[f"{tag} S={s}"] = (pts[:s].contiguous(), mask[:s].contiguous(), kw)
    return out


def index_add_call(vg, pts, mask, kw):
    """``torch.index_add`` of (x, y, z, 1) over the kept points' (frame,
    cell) rows, its operands made once outside the timed call."""
    k = vg.kernel_params(*kw)
    s, nc = pts.shape[0], k["n_cells"]
    ok, lin, _ = vg.kept_cells(pts, mask, k)
    frame = torch.arange(s, device=pts.device)[:, None]
    tgt = torch.where(ok, frame * nc + lin, s * nc).reshape(-1)
    vals = torch.cat([torch.where(ok[..., None], pts, 0.0), ok[..., None].float()], -1)
    vals = vals.reshape(-1, 4)
    base = torch.zeros((s * nc + 1, 4), dtype=torch.float32, device=pts.device)
    return lambda: torch.index_add(base, 0, tgt, vals)


def run(device="cuda", reps: int = 50, breakdown: bool = False, log=print) -> dict:
    """{shape: (K6f device us, K6f ops, K6f wrapper ms, index_add device
    us, index_add wrapper ms)}; raises unless K6f equals its plain version."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_sorted_sums: needs a CUDA device")
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    smi = card()
    result = {}
    for name, (pts, mask, kw) in shapes(device).items():
        k_out = vg.accumulate_f32_stacked(pts, mask, *kw)
        p_out = vg.accumulate_f32_stacked_plain(pts, mask, *kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))
                   for a, b in zip(k_out[:1], p_out[:1])) or not torch.equal(
                       k_out[1].cpu(), p_out[1].cpu()):
            raise SystemExit(f"micro_torch_sorted_sums: K6f differs from its plain version "
                             f"at {name}")
        k6f = lambda: vg.accumulate_f32_stacked(pts, mask, *kw)  # noqa: E731
        lib = index_add_call(vg, pts, mask, kw)
        w_k = min(cuda_ms(k6f, reps), cuda_ms(k6f, reps))
        w_l = min(cuda_ms(lib, reps), cuda_ms(lib, reps))
        d_k, ops_k, per = device_profile(k6f, reps)
        d_l, ops_l, _ = device_profile(lib, reps)
        result[name] = (d_k, ops_k, w_k, d_l, w_l)
        log(f"[K6f] {smi}: {name} N={pts.shape[1]} cells={vg.kernel_params(*kw)['n_cells']}: "
            f"device {d_k:.2f} us/call in {ops_k:.1f} ops, wrapper {w_k:.4f} ms/call; "
            f"index_add device {d_l:.2f} us/call in {ops_l:.1f} ops, wrapper {w_l:.4f} ms/call")
        if breakdown:
            for kname, us in sorted(per.items(), key=lambda kv: -kv[1]):
                log(f"[K6f]   {us:9.2f} us/call  {kname[:100]}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    run(reps=args.reps, breakdown=args.breakdown)


if __name__ == "__main__":
    main()
