"""Memory-safety probe of the half builds (bf16 / f16) on the card.

Three checks, each on the headline's shapes (S = 8 frames of K1 sums):

1. Guarded outputs.  Every CUDA tensor a wrapper allocates with
   ``torch.empty`` / ``torch.zeros`` (its outputs and scratch) is placed
   between two 64 KiB guard bands filled with 0xA5, and every input is
   snapshotted; after the launch the guards and inputs must be unchanged.
   Run for K2, K14, K3f, K4 and K4 xl in bf16 and f16 (and their f32
   builds beside them), and for K6f's key entry (f32, f64).  It needs no
   memory checker: it sees a write past either end of a buffer the wrapper
   allocated, or into an input, and not a stray write elsewhere.
2. Stress.  K2's half build and K2's half plain version (on CUDA tensors)
   in turns, ``--reps`` times each per dtype, every round bit for bit;
   K14's and K3f's half plain versions likewise.  A device-side assert
   ends the process (the CUDA context is lost): the round is printed
   first.
3. NaN payloads.  K3f's half build against its plain version run on the
   card and on the CPU, on ``chip_smoke.k3f_tables``' edge cases (a NaN
   member among them): every lane whose bits differ, with both values.

    python3 scripts/probe_torch_half_bounds.py [--reps 100]

Exits non-zero if a guard, an input or a comparison fails.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

GUARD = 1 << 16
FILL = 0xA5
FAILED = []


@contextlib.contextmanager
def guarded():
    """``torch.empty`` / ``torch.zeros`` on CUDA return views into
    guard-banded buffers while the block runs; yields the list of
    (buffer, start, nbytes, what) to check."""
    real_empty, real_zeros = torch.empty, torch.zeros
    bufs = []

    def make(zero, *size, dtype=None, device=None, **kw):
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type != "cuda" or kw.get("out") is not None:
            fn = real_zeros if zero else real_empty
            return fn(*size, dtype=dtype, device=device, **kw)
        shape = tuple(size[0]) if len(size) == 1 and not isinstance(size[0], int) else size
        dtype = dtype or torch.get_default_dtype()
        es = real_empty((), dtype=dtype).element_size()
        nb = math.prod(shape) * es
        raw = real_empty((2 * GUARD + nb,), dtype=torch.uint8, device=dev)
        raw.fill_(FILL)
        body = raw[GUARD:GUARD + nb]
        if zero:
            body.zero_()
        bufs.append((raw, nb, f"{'zeros' if zero else 'empty'}{shape} {dtype}"))
        return body.view(dtype).view(shape)

    torch.empty = lambda *a, **k: make(False, *a, **k)
    torch.zeros = lambda *a, **k: make(True, *a, **k)
    try:
        yield bufs
    finally:
        torch.empty, torch.zeros = real_empty, real_zeros


def check_call(tag, fn, inputs):
    """Run fn() with guarded allocations; fail on a touched guard byte or a
    changed input."""
    snaps = [x.clone() for x in inputs]
    with guarded() as bufs:
        out = fn()
        torch.cuda.synchronize()
    bad = []
    for raw, nb, what in bufs:
        lo = raw[:GUARD].cpu().numpy()
        hi = raw[GUARD + nb:].cpu().numpy()
        for side, g in (("before", lo), ("after", hi)):
            hit = np.nonzero(g != FILL)[0]
            if hit.size:
                bad.append(f"{what}: {hit.size} guard bytes {side} written "
                           f"(offsets {hit[:4].tolist()})")
    for i, (a, b) in enumerate(zip(snaps, inputs)):
        if lanes(a, b)[1]:
            bad.append(f"input {i} {tuple(b.shape)} {b.dtype} changed")
    print(f"[guards] {tag}: {len(bufs)} guarded allocations, "
          f"{'clean' if not bad else 'FAILED ' + '; '.join(bad)}", flush=True)
    if bad:
        FAILED.append(tag)
    return out


_UINT = {2: np.uint16, 4: np.uint32, 8: np.uint64}


def bits(t):
    """A tensor's elements as unsigned integers of their width (floats by
    their bits)."""
    a = t.detach().cpu().contiguous().numpy() if t.dtype not in (
        torch.bfloat16, torch.float16) else t.detach().cpu().contiguous().view(torch.int16).numpy()
    return a.view(_UINT[a.dtype.itemsize]) if a.dtype.kind in "fi" and a.dtype.itemsize > 1 else a


def lanes(a, b, limit=6):
    """The lanes whose bits differ: ([(index, bits a, bits b)], count)."""
    ba, bb = bits(a), bits(b)
    idx = np.argwhere(ba != bb)
    return [(tuple(int(q) for q in i), hex(int(ba[tuple(i)])), hex(int(bb[tuple(i)])))
            for i in idx[:limit]], len(idx)


def same(tag, got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        diff, n = lanes(g, w.to(g.device))
        if n:
            print(f"[stress] {tag}: output {k} differs in {n} lanes, e.g. {diff}", flush=True)
            FAILED.append(tag)
            return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()

    import chip_smoke as C
    from multiple_object_tracking_lidar_tpu_torch import _build
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, grid_cuda, stencil_cc_cuda, track_cuda, voxel_grid_cuda)
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid
    from multiple_object_tracking_lidar_tpu_torch.ops.stencil_cc_cuda import stencil_cc_plain
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.load()
    cfg, env, sc = headline_case(device=dev)
    leaf, leaf_z, tol, caps = cfg.voxel_leaf_size, cfg.leaf_z, cfg.cluster_tolerance, cfg.caps
    pts, msk, ts = C.headline_frames(sc, caps.n_max_points, range(8))
    M8 = torch.from_numpy(msk).to(dev)
    for tag, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        hcfg = cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[tag])
        tracker = Tracker(hcfg, dev)
        plan = tracker.plan(env)
        P8 = torch.from_numpy(pts).to(dev).to(dt).float()
        T8 = torch.from_numpy(ts).to(dev).to(dt)
        acc32, _ = voxel_grid_cuda.accumulate_fast_stacked(P8, M8, cfg.scene, leaf, leaf_z)
        acc = acc32.to(dt)
        tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
        kw2 = dict(dims=plan.dims, tol=tol, leaf_xy=leaf, leaf_z=leaf_z, kwin=plan.table.k)
        offsets = grid_cuda.kernel_offsets(plan.dims, tol, leaf, leaf_z)

        def k2(a):
            return grid_cuda.fused_finalize_static_cc_stacked(a, *tb, **kw2)

        def k2_plain(a):
            return grid_cuda.fused_finalize_static_cc_stacked_plain(
                a, *tb, dims=plan.dims, offsets=offsets, kwin=plan.table.k,
                max_sweeps=2 * sum(plan.dims), tol=tol)

        # 1. guards
        for label, a in (("S=8", acc), ("S=1", acc[3:4].contiguous())):
            check_call(f"K2 {tag} {label}", lambda a=a: k2(a), [a, *tb])
            check_call(f"K2 f32 {label}", lambda a=a: k2(a.float()), [a, *tb])
        cent, dyn, labels, n_sw, _ = k2(acc)
        cc_args = (plan.dims, tol, leaf, leaf_z, caps.label_prop_iters,
                   caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
        check_call(f"K14 {tag}", lambda: stencil_cc_cuda.stencil_cc(cent, dyn, *cc_args),
                   [cent, dyn])
        check_call("K14 f32", lambda: stencil_cc_cuda.stencil_cc(cent.float(), dyn, *cc_args),
                   [cent, dyn])
        ctab = cluster_table_grid(labels, n_sw, cent, dyn, plan.dims[0], cfg.min_cluster_size,
                                  cfg.max_cluster_size, caps.c_max_clusters, caps.p_max_cluster)
        mp = ctab.mpts.reshape(-1, caps.p_max_cluster, 3).contiguous()
        mm = ctab.member_mask.reshape(-1, caps.p_max_cluster).contiguous()
        mp_e, mm_e = C.k3f_tables(np.random.default_rng(1901), 8, 32, caps.p_max_cluster, dev)
        mp_e = mp_e.to(dt)
        for label, p_, m_ in (("headline", mp, mm), ("edge cases", mp_e, mm_e)):
            check_call(f"K3f {tag} {label}",
                       lambda p_=p_, m_=m_: centroid_cuda.circumcenter_features(p_, m_, T8),
                       [p_, m_, T8])
            check_call(f"K3f f32 {label}",
                       lambda p_=p_, m_=m_: centroid_cuda.circumcenter_features(
                           p_.float(), m_, T8.float()), [p_, m_, T8])
        gains = tracker.gains_xy
        g32 = Tracker(cfg, dev).gains_xy
        K, D = caps.k_max_tracks, caps.c_max_clusters
        for pf in ("lpf", "ihgp"):
            c = hcfg.replace(position_filter=pf)
            c32 = cfg.replace(position_filter=pf)
            for k, d, b, s in ((K, D, 1, 1), (K, D, 1, 8), (K, D, 8, 1), (1024, 128, 1, 1),
                               (2048, 128, 1, 1)):
                ins = C.half_track_inputs(track_scene(1900 + k + s + b, cfg, k, d, b, s,
                                                      (0,) if s > 1 or b > 1 else (), dev), dt)
                st, dets, valid, t = ins
                flat = [dets, valid, t, *st.bank, st.next_obj_num, st.next_birth,
                        st.spin_counter, st.initialized]
                check_call(f"K4 {tag} {pf} K={k} {b} x {s}",
                           lambda ins=ins, c=c: track_cuda.track_frames(*ins, config=c,
                                                                        gains_xy=gains), flat)
                w32 = C.widen_track_inputs(ins)
                check_call(f"K4 f32 {pf} K={k} {b} x {s}",
                           lambda w=w32, c=c32: track_cuda.track_frames(*w, config=c,
                                                                        gains_xy=g32),
                           [w32[1], w32[3], *w32[0].bank])

        # 2. stress: kernel and plain version on the card in turns
        for r in range(args.reps):
            got = k2(acc)
            try:
                want = k2_plain(acc)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"[stress] K2 {tag} plain on the card, round {r}: {e}", flush=True)
                return 2
            if not same(f"K2 {tag} round {r}", got, want):
                break
        print(f"[stress] K2 {tag}: kernel and plain version on the card in turns, "
              f"{args.reps} rounds: {'bit for bit' if not FAILED else FAILED}", flush=True)
        offs14 = stencil_cc_cuda.kernel_offsets(plan.dims, tol, leaf, leaf_z)
        tol2 = in_dtype(tol * tol, dt)
        for r in range(max(1, args.reps // 4)):
            got = stencil_cc_cuda.stencil_cc(cent, dyn, *cc_args)
            want = stencil_cc_plain(cent, dyn, plan.dims, offs14, tol2, *cc_args[4:])
            torch.cuda.synchronize()
            if not same(f"K14 {tag} round {r}", got, want):
                break
            got = centroid_cuda.circumcenter_features(mp, mm, T8)
            want = centroid_cuda.circumcenter_features_half_plain(mp, mm, T8)
            torch.cuda.synchronize()
            if not same(f"K3f {tag} round {r}", (got,), (want,)):
                break
        print(f"[stress] K14 / K3f {tag}: {max(1, args.reps // 4)} rounds against the plain "
              f"versions on the card done", flush=True)

        # 3. K3f's edge cases: the lanes where the bits differ
        got = centroid_cuda.circumcenter_features(mp_e, mm_e, T8)
        for where, (p_, m_, t_) in (("the card", (mp_e, mm_e, T8)),
                                    ("the CPU", (mp_e.cpu(), mm_e.cpu(), T8.cpu()))):
            want = centroid_cuda.circumcenter_features_half_plain(p_, m_, t_)
            diff, n = lanes(got, want)
            vals = [(i, float(got[i]), float(want.to(dev)[i])) for i, _, _ in diff]
            print(f"[nan] K3f {tag} edge cases vs the plain version on {where}: {n} lanes "
                  f"differ (slot, field; kernel bits, plain bits) {diff}; values {vals}",
                  flush=True)

    # K6f's key entry: guards, and against its plain version
    g = torch.Generator(device="cpu").manual_seed(7)
    n, m = 106496, 8192
    for dt in (torch.float32, torch.float64):
        p = (torch.randn((1, n, 3), generator=g) * 20).to(dt).to(dev)
        bins = torch.randint(-1, m, (1, n), generator=g).to(dev)
        got = check_call(f"K6f keys {dt}",
                         lambda p=p, bins=bins: voxel_grid_cuda.accumulate_sums_keys(p, bins, m),
                         [p, bins])
        want = voxel_grid_cuda.accumulate_sums_keys_plain(p, bins, m)
        same(f"K6f keys {dt}", (got,), (want,))
    print(f"[probe] {smi}: {'FAILED ' + str(FAILED) if FAILED else 'every check clean'}",
          flush=True)
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
