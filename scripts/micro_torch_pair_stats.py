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

    python scripts/micro_torch_pair_stats.py [--reps 200] [--repo DIR] [--half]

``--repo DIR`` times the port of another checkout (a parent commit
unpacked under build/): there the route may be K3 plus the eager tail, so
the two are measured in turns in one call.

``--half`` times K3f's half builds (bf16, f16) and its f32 table build
instead (``circumcenter_features(..., table=True)``), each held bit for bit
against ``circumcenter_features_half_plain`` first, each beside K3f's f32
build on the same values (the half values widened), in turns (f32, bf16,
f16, table, table, f16, bf16, f32; device us per call from a
``torch.profiler`` trace between marker kernels, taken again when it lost
events, the min of each pair): on the headline's own
half member tables (S = 8 x C = 32, P = 384, K1 -> K2 -> the cluster table
in the half dtype), on the tables above at S = 1 and 8 for (C, P) = (32,
384) and (64, 512), and on 8 cluster-sorted lists gathered into tables (C
= 64, P = 512 and C = 32, P = 384: 1-P members a slot, the last two slots
empty).  Then the registers and spills of each build from the compiler's
``-Xptxas -v`` report.  Run it once per checkout, in turns (parent, this,
this, parent):

    for r in build/parent . . build/parent; do
        python scripts/micro_torch_pair_stats.py --half --repo $r; done
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


HALF = {"bf16": torch.bfloat16, "f16": torch.float16}


def headline_half_tables(device, dt):
    """The headline's 8 frames through K1 (the points rounded to ``dt``,
    widened), K2 and the cluster table in ``dt``, as the half dense-grid
    path builds them: (S * C, P, 3) members, (S * C, P) mask, (S,) stamps,
    all in ``dt``."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda, voxel_grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    cfg, env, sc = headline_case(device=device)
    caps = cfg.caps
    rows = [padded_frame(sc, k, caps.n_max_points) for k in range(8)]
    pts = torch.from_numpy(np.stack([r[0] for r in rows])).to(device).to(dt).float()
    msk = torch.from_numpy(np.stack([r[1] for r in rows])).to(device)
    ts = torch.tensor([float(r[2]) for r in rows], device=device).to(dt)
    hcfg = cfg.replace(dtype={torch.bfloat16: "bfloat16", torch.float16: "float16"}[dt])
    plan = Tracker(hcfg, device).plan(env)
    acc32, _ = voxel_grid_cuda.accumulate_fast_stacked(pts, msk, cfg.scene, cfg.voxel_leaf_size,
                                                       cfg.leaf_z)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    cent, dyn, labels, n_sw, _ = grid_cuda.fused_finalize_static_cc_stacked(
        acc32.to(dt), *tb, dims=plan.dims, tol=cfg.cluster_tolerance,
        leaf_xy=cfg.voxel_leaf_size, leaf_z=cfg.leaf_z, kwin=plan.table.k)
    tab = cluster_table_grid(labels, n_sw, cent, dyn, plan.dims[0], cfg.min_cluster_size,
                             cfg.max_cluster_size, caps.c_max_clusters, caps.p_max_cluster)
    p = caps.p_max_cluster
    return tab.mpts.reshape(-1, p, 3).contiguous(), tab.member_mask.reshape(-1, p), ts


def sorted_list_tables(device, s, c, p, seed):
    """S cluster-sorted f32 point lists (``chip_smoke.py::half_sorted_lists``:
    C clusters of 1-P members, the last two slots empty) gathered into (S *
    C, P, 3) tables and their masks as ``ops/centroid.py::
    circumcenter_features_sorted`` gathers them (``sorted_list_table``)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    lists = chip_smoke.half_sorted_lists(np.random.default_rng(seed), s, c, p, torch.float32,
                                         device)
    return chip_smoke.sorted_list_table(lists, p)


def build_resources(pattern: str = "circumcenter_half_kernel") -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} of the loaded library's kernels whose name holds ``pattern``,
    from the compiler's ``-Xptxas -v`` report (kept beside the library)."""
    import re

    from multiple_object_tracking_lidar_tpu_torch import _build

    info = _build.build_info()
    text = info["log"]
    if not text and os.path.exists(info["path"] + ".log"):
        with open(info["path"] + ".log", encoding="utf-8") as f:
            text = f.read()
    out, name, spill = {}, None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1) if pattern in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def whole_device_us(fn, reps: int) -> float:
    """Device us per call of fn from a trace between marker kernels, taken
    again when it lost events at an end (``micro_torch_digits.whole_trace``,
    this repo's copy)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from micro_torch_digits import device_profile as whole_profile

    return whole_profile(fn, reps)[0]


HALF_TARGET = 1.5   # the half builds on the headline's tables: at most this x the f32 build


def run_half(device="cuda", reps: int = 200, log=print) -> dict:
    """{(operands, build): device us per call} of K3f's f32 build, its half
    builds and its table build, in turns; raises unless each half / table
    build equals its plain version bit for bit.  On the headline's tables
    the half build's ratio to the f32 build is logged against HALF_TARGET,
    met or missed."""
    if not torch.cuda.is_available():
        raise SystemExit("micro_torch_pair_stats: needs a CUDA device")
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid_cuda import (
        circumcenter_features, circumcenter_features_half_plain)

    smi = card()
    cases = []   # (label, {build: (mpts, mask, t)}, frame slots)
    for h, dt in HALF.items():
        mp, mm, ts = headline_half_tables(device, dt)
        cases.append((f"the headline's {h} member tables S=8 x C=32, P=384",
                      {"f32": (mp.float(), mm, ts.float()), h: (mp, mm, ts)}, 32))
    for c, p in ((32, 384), (64, 512)):
        mp8, mm8 = make_operands(device, 8, c, p)
        for s in (1, 8):
            mp = mp8[:s].reshape(s * c, p, 3)
            mm = mm8[:s].reshape(s * c, p)
            t = torch.arange(s, dtype=torch.float32, device=device) * 0.1 + 100.0
            builds = {"f32": (mp, mm, t), "table": (mp, mm, t)}
            for h, dt in HALF.items():
                builds[h] = (mp.to(dt), mm, t.to(dt))
            cases.append((f"{s * 4} active slots, S={s} x C={c}, P={p}", builds, c))
    for c, p, names in ((64, 512, ("bf16", "f16")), (32, 384, ("table",))):
        mp, mm = sorted_list_tables(device, 8, c, p, 2300 + p)
        t = torch.arange(8, dtype=torch.float32, device=device) * 0.1 + 100.0
        builds = {"f32": (mp, mm, t)}
        for h in names:
            builds[h] = (mp, mm, t) if h == "table" else (mp.to(HALF[h]), mm, t.to(HALF[h]))
        if "table" not in names:   # the f32 build on the half values widened
            builds["f32"] = (builds[names[0]][0].float(), mm, t)
        cases.append((f"8 sorted lists S=8 x C={c}, P={p}", builds, c))

    result = {}
    for label, builds, per in cases:
        def call(b, builds=builds):
            mp, mm, t = builds[b]
            return lambda: circumcenter_features(mp, mm, t, table=b == "table")

        for b, (mp, mm, t) in builds.items():
            if b == "f32":
                continue
            got = call(b)()
            want = circumcenter_features_half_plain(mp, mm, t, per)
            torch.cuda.synchronize()
            gw, ww = got.float().cpu(), want.float().cpu()
            if not torch.equal(gw.view(torch.int32), ww.view(torch.int32)):
                raise SystemExit(f"micro_torch_pair_stats: K3f {b} differs from its plain "
                                 f"version on {label}")
        order = list(builds)
        times = {b: [] for b in order}
        for b in order + order[::-1]:
            times[b].append(whole_device_us(call(b), reps))
        for b in order:
            result[(label, b)] = min(times[b])
        ratios = {b: result[(label, b)] / result[(label, "f32")] for b in order if b != "f32"}
        verdict = ("; target <= %sx %s" % (HALF_TARGET, "met" if max(ratios.values())
                                           <= HALF_TARGET else "missed")
                   if label.startswith("the headline's") else "")
        log(f"[K3f half] {smi}: {label}: device us per call in turns "
            + ", ".join(f"{b} {times[b][0]:.2f}/{times[b][1]:.2f}" for b in order)
            + "; " + ", ".join(f"{b} / f32 {r:.2f}x" for b, r in ratios.items()) + verdict
            + "; the half and table builds bit for bit their plain versions")
    for name, (regs, st, ld) in sorted(build_resources().items()):
        build = ("table" if "TableF32" in name else "bf16" if "BF16" in name
                 else "f16" if "F16" in name else name)
        log(f"[K3f half] {build} ({name}): {regs} registers, spill stores {st} bytes, "
            f"spill loads {ld} bytes")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--repo", default=REPO, help="checkout whose port is timed")
    ap.add_argument("--half", action="store_true",
                    help="K3f's half and table builds beside its f32 build")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    print(f"port from {os.path.dirname(bench_cases.__file__)}", flush=True)
    if args.half:
        run_half(reps=args.reps)
        return
    run(reps=args.reps)
    run_route(reps=args.reps)


if __name__ == "__main__":
    main()
