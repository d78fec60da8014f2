"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``multiple_object_tracking_lidar_tpu_torch``) and nothing
of JAX, in five phases, one or more lines each:

1. the card (``nvidia-smi`` name and power limit); no CUDA -> exit 1;
2. the kernel build from ``csrc/*.cu`` (one nvcc per source, in parallel);
3. each kernel (K1-K13, K3f, K6 in its bf16x3 and f32 modes and its key
   entry, K1's and K5's histograms and finalizes alone, K1-cm fused and
   raw) against its plain PyTorch version on the card, at the shapes its
   path gives it, on scenario and adversarial inputs (K10 also on 0.1 m
   lattice knife edges at C = 32, P = 384 and configuration G's C = 64,
   P = 512; K3f, with K3 and K10, on S = 8 stacked tables of both sizes --
   lattice, collinear, empty, 1- and 2-member, all-equal and NaN-member
   slots -- and against K3's stats with the eager selection after them;
   K6's three entries at the headline's and G's grids on a frame in one
   cell, an all-dropped frame, NaN points and keys at n_cells - 1); K2,
   one thread-block cluster per frame, also on the grids of
   ``bench_cases.k2_grids`` (32,768, 70,200 and 193,536 cells) and, on the
   headline's, at every cluster size; K4, the whole track step, at K = 64
   and 1,024 launched 1 x 1, 1 x 8 and 8 x 1 with up to D = 128 detections
   (first frames, duplicates, gaps, overflow), and its decision scan alone
   at K = 64, 256 and 1,024; K1, K5, their raw entries and K1-cm on the
   grids of ``bench_cases.digit_grids`` (the headline's at every layout of
   cell ranges x point chunks, 32,768, 70,200 and 193,536 cells at the
   rule's), each with an adversarial frame and the 99%-in-one-cell frames
   -- all bit for bit; a grid of exactly ``max_cells`` and one row past it
   (the wide layout) bit for bit; K8 and K8a (one thread-block cluster per frame) on C's
   and G's point lists and at M = 8,192, past the shared-memory layout
   (the adjacency words in device memory), K7 on sorted rows and through
   the permutation of the runs front end's own sort, K9 on the headline's
   sorted rows and on one block of a ragged T = N (1,001 and 7 rows, inf
   and -0.0 in the rows the cyclic roll wraps onto), K11 through each of
   its routes (the points' C = 3, also at R % 4 != 0 and from a misaligned
   frame base; C = 1; C = 5; the probes); K4 under ``position_filter=
   "ihgp"`` at K = 64 and 1,024, 1 x 1, 1 x 8 and 8 x 1 (its positions not
   LPF's, its decisions LPF's); K2, K3f and K4 (greedy and Hungarian,
   lpf and ihgp, K = 64 and 1,024) built for double (``dtype="float64"``);
   K6f, K8a and K2 fed f32 sums built for double: K6f f64 on the headline's
   8 f64 frames (one adversarial) and G's grid, 2 + passes launches per
   call, K8a f64 at M = 1,024 and 2,048, S = 1 and 8 (a 1e-13 m boundary
   lattice) and at M = 6,144 (its f64 frame in device memory), K2 on the
   runs' f32 sums, one op per call each;
   F7: K8a at a ragged M = 1,000, the jnp CC
   through it against the CPU, K8 refusing M = 1,000 as the JAX Pallas
   wrapper does, and K8 and K8a at M = 8,448 (the frame in device memory)
   against their plain versions and, through both CC backends, the CPU;
   K12 (the Hungarian auction alone) on dense, sparse and near-tie problems
   up to D = 128, K = 1,024 (several per launch), ``max_iters=1`` saturating,
   and on the headline and dense scenes' own problems (iterations per phase
   logged), and K4's Hungarian builds on the dense scene's own frames (K =
   96, D = 64) and at K = 64 and 1,024, 1 x 1, 1 x S and B x 1, under lpf
   and ihgp, on a gated scene (tracks in pairs 0.35 m apart) -- bit for bit
   their plain versions; K13 (the IHGP learning step) at the shapes of
   ``K13_SHAPES`` (the headline node's update, tune's 60 windows, 1,024 and
   4,096 windows, one window, half the mask off, logLengthScale at -10 --
   the NaN reset -- and +10, one window past a CTA's 32, nine CTAs a
   problem), bit for bit its plain version, one op per call; K4 xl -- K4 past its 1,024 slots and 128 detections -- (greedy and
   Hungarian, lpf and ihgp, f32 and f64) at (K, D) = (2,048, 32), (4,096,
   64), (64, 256) and (1,024, 512), K1 and K5 wide (and K1's raw entry) at
   the floor's 1,119,963 cells and at 2 x ``max_cells``, S = 1 and 8, and
   K14 (the stencil CC) on the floor frames' own cells in f32 and f64,
   converged and at ``max_iters = 1``, each bit for bit its plain version,
   one op per call;
4. the paths, each with every kernel's launch counter reset before and
   read after: the headline (fast digits) -- ``TrackerNode.on_pointcloud``
   answers 12 headline PointCloud2 frames and ``Tracker.bind_env_multi``
   runs 4 dispatches of S = 8, held against the JAX golden
   (tests/golden/torch_slice_headline.npz) and the port's plain path on
   the CPU, with one K4 launch per frame and per call, the circumcenter
   in K3f and no tracking path launching K3; then exact mode
   (K5) and runs mode (K7), each through ``TrackerNode`` (12 frames) and
   ``bind_env_multi`` (2 x S = 8), held against their JAX goldens
   (torch_{exact,runs}_headline.npz); exact mode on unpadded 100,000-point
   frames (K6), held against the exact golden; then the point-list
   configurations C (dense + K8), D (dense + jnp CC), E (scan + jnp CC)
   and F (runs + K8), each through ``TrackerNode`` (12 frames) and
   ``bind_env_multi`` (2 x S = 8), and G (the JAX package's
   ``TrackerConfig()``) through ``TrackerNode`` (4 frames), held against
   torch_{pointlist,pointlist_scan,pointlist_runs,default}_headline.npz (D
   shares C's); then the fleet on a one-rank NCCL mesh: the kernel fleet
   (``ShardedTracker``, B = 8 headline streams x 3 steps, stream s at step
   k fed headline frame 3 s + k, one K4 launch per step) against the JAX
   fleet golden (torch_fleet_headline.npz) and bit for bit against each
   stream's own ``bind_env``; the vmap fleet on C the same way against C's
   ``bind_env``; ``MultiplexedTracker`` (2 streams) and ``StreamingNode``
   on 12 headline frames against the slice golden; then the slice-5 entry
   points (``ops/centroid_pallas.py``'s ``circumcenter_features_table_
   pallas`` (K10) and ``pair_stats_pallas`` (K3), ``ops/voxel_grid.py::
   accumulate_from_indices`` (K6 keys), ``scripts/micro_torch_pair_stats.py``
   and ``scripts/micro_torch_acc.py`` (K1, K1-cm, raw + fin, K11)), each held
   against the same function by another route; then bank growth:
   ``TrackerNode`` with a two-slot bank over 12 headline frames against the
   JAX growth golden (torch_growth_headline.npz), a checkpoint after frame
   5 resumed bit for bit, and the same checkpoint padded to 256 slots (K4
   past the TPU kernel's 128) within the golden's tolerances; and G-grid
   (G's config and frames on the dense grid: K1 and K2 at 193,536 cells)
   through ``bind_env`` and ``bind_env_multi`` against the port's own
   ``bind_env`` on the CPU; the CLI (``runtime/cli.py``) in-process, ``run
   --backend grid`` on 16 headline frames recorded with the port's bag
   writers, against the JAX CLI's goldens (tests/golden/
   torch_cli{,_ihgp}_headline.json) under ``lpf`` and ``ihgp``, its SVG,
   the ROS1 bag's replay, a checkpoint resumed; the headline under
   ``ihgp`` through ``TrackerNode``, ``bind_env_multi`` and the kernel
   fleet against torch_ihgp_headline.npz; the headline and the dense scene
   (``bench.dense_case``: 40 objects 0.55 m apart, C = 64, K = 96) under
   ``association="hungarian"`` through ``TrackerNode``, ``bind_env_multi``
   and the kernel fleet (B = 8) against torch_hungarian_{headline,dense}.npz
   (every lane within TOL_DETS / TOL_VEL), and the CLI with a
   config file ``association: hungarian`` against
   torch_cli_hungarian_headline.json, each launching K4's Hungarian build
   ("K4 hungarian"); the headline under ``dtype="float64"`` (greedy + lpf,
   and hungarian + ihgp) through ``bind_env``, ``TrackerNode``,
   ``bind_env_multi`` and the CLI (a config file ``dtype: float64``)
   against torch_f64{,_hungarian_ihgp}_headline.npz and
   torch_cli_f64_headline.json within 1e-9 m / 1e-8 m/s, each launching K1
   and the double builds of K2, K3f and K4 and no f32 build of them;
   ``dtype="float64"`` off the fast digits against
   torch_f64_{default,pointlist,pointlist_scan,pointlist_runs,exact,runs}
   _headline.npz within 1e-9 m / 1e-8 m/s: G (``TrackerConfig(dtype=
   "float64")``) through ``bind_env``, ``TrackerNode``, ``bind_env_multi``
   (S = 8) and the CLI on its default backend (a config file ``dtype:
   float64``, torch_cli_f64_default_headline.json), C, E, F, exact and runs
   through ``bind_env``, each launching its double builds (K6f, K8a, K2 --
   fed f32 sums under runs --, K3f, K4; K7 and K8 in f32 where the JAX
   route is f32) and no f32 build of K2, K3f, K4, K6f or K8a; the headline
   ``TrackerNode`` with ``param_fix=False`` (online learning, an update every
   0.2 s) over 16 frames against torch_learning_headline.npz (the frames,
   the frames of the updates, the log-parameters and the NLL), one K13
   launch per update and one K4 per frame, and the CLI's ``tune`` at its
   defaults against torch_cli_tune.json, one K13 launch per step; no plain
   learning step on the card; then the floor case (``bench_cases.
   floor_case``): at the goldens' 16 m floor through ``bind_env`` in f32,
   Hungarian and f64 against torch_floor{,_hungarian,_f64}_headline.npz,
   torch_track_wide.npz through K4 xl, and the full 30 m floor (1,119,963
   cells, C = 256) through ``bind_env``, ``bind_env_multi``, ``TrackerNode``
   (growing its bank) and the vmap fleet (B = 2) in f32, Hungarian and f64,
   the grown bank padded to 2,048 slots, each launching K1 (wide), K14, K3f
   and K4 xl.  No path may take the plain digit sums (nor, on the floor,
   any plain route);
5. timings with CUDA events, beside the card's name and power limit:
   ``bind_env`` and ``bind_env_multi`` per path, host syncs and device ops
   per frame of each (``torch.profiler``; the headline must make no host
   sync), K1 and K5 per call at 5,500, 70,200 and 193,536 cells
   (``scripts/micro_torch_digits.py``: one device operation each, fused or
   raw, beside ``Tensor.index_add_`` of their digits), K8, K8a and K7 per
   call (``scripts/micro_torch_cc_segsum.py``: one device operation each,
   K7 also through the sort's permutation; K9 too), the fleet's
   clouds/s and device ops per cloud beside ``bind_env_multi``, and each
   kernel against its plain version, with its
   bound (the larger of its bytes over 3.35 TB/s and its operations over
   67 TFLOP/s) and, where one PyTorch call computes the same function,
   that call's time (K6f also at configuration G's grid, S = 8, beside
   ``torch.index_add`` there; K7, K9 and K11 also with their own and their
   library call's device time from ``torch.profiler``); then the headline
   under ``lpf`` and ``ihgp`` in turns (ms/frame, device ops per frame,
   K4's device us per call at 1 x 1 and 1 x 8) and ``bind_env_pipelined``
   beside ``bind_env_multi``; the headline under ``greedy`` and
   ``hungarian`` in turns (the same readings; hungarian must make no host
   sync), K4 hungarian also at K = 1,024, and K4 hungarian and K12 against
   their plain versions with their bounds; the f32 and f64 headlines in
   turns (the same readings; neither may make a host sync), and K2, K3f
   and K4's double builds against their plain versions and, in turns,
   their f32 builds, with their bounds (fp64 at 34 TFLOP/s); K6f, K8a and
   K2 fed f32 sums built for double beside their f32 builds in turns, with
   their bounds, and G in f32 and f64 in turns (ms/frame, device ops and
   host syncs per frame); K13 and its plain version in turns at the
   headline node's shape (the plain version's device ops per call), K13's
   device time at every shape of ``K13_SHAPES`` beside its chain bound, and
   the headline node's wall ms per frame p50 / p99 on update frames and
   the others with learning on and off in turns, each update split into
   the window copy, K13, the host gains and the swap.  Every one-op reading
   (``one_op_profile``) comes from a trace between marker kernels, taken
   again, up to eight times with a growing pause, when it lost events at
   an end (``micro_torch_digits.whole_trace``; the run logs how many were
   taken again), and K4's, K4 hungarian's, K12's and F7's fail at other than one op per
   call (``require_one_op``); the narrow K4 at the headline against its
   PR 11-13 range, K4 xl, K4 xl hungarian (with its auction's iterations),
   K1 / K5 wide and K14 against their plain versions with their bounds,
   and the floor's ms/frame, device ops, host syncs and idle share per
   frame (greedy and Hungarian; the bank padded to 2,048).

Half precision and the host surface: K2, K14, K3f, K4 and K4 xl built
for bf16 and f16 against their plain versions on the card, bit for bit,
and K6f's key entry (``voxel_downsample_sort``'s run sums, f32 / f64)
likewise (``phase_kernels_slice19``, ``phase_k6f_keys``); the half headline
through every entry point against torch_{bf16,f16}_headline.npz and the
CLI goldens (``phase_half``); the native decoder, the node by piece and
the rosbridge loopback (``phase_host_slice19``); each half build beside
its f32 build on the same values widened (``phase_timings_slice19``); the
learning node and ``tune`` under bf16 and f16 against
torch_{bf16,f16}_learning_headline.npz and torch_cli_{bf16,f16}_tune.json
bit for bit, one K13 launch per update and per step, the update timed by
piece (``phase_half_learning``).  K3f's redesigned half and table builds
(compacted members, the mean in 32-lane windows, the pair stage in tiles
over the warps) bit for bit their plain version on the headline's half
tables, G's and F's sorted lists, ``bench_cases.k3f_edge_tables`` (P =
100, 384, 1,100) and ``k3f_tables`` (P = 384, 512), with cy as on a
multi-device mesh, P past ``HALF_P_MAX`` raising
(``phase_kernels_slice23``); each beside the f32 build in turns, and the
half headline and G end to end in dtype turns (``phase_timings_slice23``).

Any failed phase raises (exit 1).  The line before the last is the kernel
report (JSON); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "torch_slice_headline.npz")
GOLDEN_EXACT = os.path.join(HERE, "tests", "golden", "torch_exact_headline.npz")
GOLDEN_RUNS = os.path.join(HERE, "tests", "golden", "torch_runs_headline.npz")
GOLDEN_PL = {g: os.path.join(HERE, "tests", "golden", f"torch_{g}_headline.npz")
             for g in ("pointlist", "pointlist_scan", "pointlist_runs", "default")}
GOLDEN_FLEET = os.path.join(HERE, "tests", "golden", "torch_fleet_headline.npz")
GOLDEN_GROWTH = os.path.join(HERE, "tests", "golden", "torch_growth_headline.npz")
GOLDEN_IHGP = os.path.join(HERE, "tests", "golden", "torch_ihgp_headline.npz")
GOLDEN_CLI = os.path.join(HERE, "tests", "golden", "torch_cli_headline.json")
GOLDEN_CLI_IHGP = os.path.join(HERE, "tests", "golden", "torch_cli_ihgp_headline.json")
GOLDEN_CLI_HUNGARIAN = os.path.join(HERE, "tests", "golden",
                                    "torch_cli_hungarian_headline.json")
GOLDEN_HUNGARIAN = {"hungarian": os.path.join(HERE, "tests", "golden",
                                              "torch_hungarian_headline.npz"),
                    "dense_hungarian": os.path.join(HERE, "tests", "golden",
                                                    "torch_hungarian_dense.npz")}
GOLDEN_LEARNING = os.path.join(HERE, "tests", "golden", "torch_learning_headline.npz")
GOLDEN_TUNE = os.path.join(HERE, "tests", "golden", "torch_cli_tune.json")
GOLDEN_HALF_LEARNING = {
    h: os.path.join(HERE, "tests", "golden", f"torch_{h}_learning_headline.npz")
    for h in ("bf16", "f16")}
GOLDEN_HALF_TUNE = {h: os.path.join(HERE, "tests", "golden", f"torch_cli_{h}_tune.json")
                    for h in ("bf16", "f16")}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM: HBM3 rate (NVIDIA's datasheet)
F32_OPS_PER_S = 67e12         # H100 SXM: f32 outside the tensor cores; int32 ops too
PKG = "multiple_object_tracking_lidar_tpu_torch"

# Tolerances against the JAX golden, with their reasons.  Integers, labels
# and decisions are exact.
TOL_DETS = 1e-5  # m: raw_centroid / pos.  XLA on the CPU may contract the
#   finalize's cnt*(c+half)+s*2^-k into an FMA (1 ulp), and the JAX pair
#   scan centres members with an f32 sum where K3 rounds an f64 one: a few
#   ulp at |x| <= 10 m (~1e-6 seen), the picks themselves identical
TOL_VEL = 1e-4   # m/s: velocities are window differences / dt (x10) fed
#   through 39-term smoother sums taken in another order
# Against the port's own plain path on the CPU: the same elementwise IEEE
# ops, but vmean and the smoother einsum reduce in another order on the card
TOL_CPU_VEL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def once_ms(fn) -> float:
    """ms of one call of fn on the current stream, by CUDA events (no
    warm-up: for plain versions that take seconds a call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn on the current stream, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def equal(a, b) -> bool:
    """Bitwise equality for floats (NaN == NaN), plain equality otherwise."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.view(np.uint32 if a.dtype == np.float32 else np.uint64),
                              b.astype(a.dtype).view(np.uint32 if a.dtype == np.float32 else np.uint64))
    return np.array_equal(a, b)


def npy(t):
    """A tensor as numpy; bf16 / f16 widened to f32 (exactly: bits compare
    as the half values' bits do)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()


def max_err(a, b) -> float:
    """Max |a - b|, where equal values (infinities and NaN pairs included)
    count as 0."""
    with np.errstate(invalid="ignore"):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        return float(np.max(np.where(equal_mask(a, b), 0.0, np.abs(a - b)), initial=0.0))


def equal_mask(a, b):
    """Elementwise: equal values, NaN pairs included."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a == b) | (np.isnan(a) & np.isnan(b))


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------
def phase_card():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build():
    from multiple_object_tracking_lidar_tpu_torch import _build

    t0 = time.perf_counter()
    info = _build.build_info()
    secs = time.perf_counter() - t0
    usage = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    log(f"[2 build] {os.path.relpath(info['path'], HERE)} from "
        f"{len(_build.sources())} sources in {secs:.1f} s (nvcc {info['seconds']})")
    for ln in usage:
        log(f"[2 build]   {ln}")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions on the card
# ---------------------------------------------------------------------------
def headline_frames(sc, n_pts, ks):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame

    rows = [padded_frame(sc, k, n_pts) for k in ks]
    pts = np.stack([r[0] for r in rows])
    mask = np.stack([r[1] for r in rows])
    t = np.asarray([r[2] for r in rows], np.float32)
    return pts, mask, t


def adversarial_points(cfg, rng, n):
    """Points on leaf boundaries, NaN and out-of-bounds points, masked
    points, and a dense blob, inside the headline scene."""
    sc = cfg.scene
    leaf = cfg.voxel_leaf_size
    pts = np.stack([rng.uniform(sc.x_min - 0.5, sc.x_max + 0.5, n),
                    rng.uniform(sc.y_min - 0.5, sc.y_max + 0.5, n),
                    rng.uniform(sc.z_min - 0.3, sc.z_max + 0.3, n)], 1).astype(np.float32)
    q = n // 8
    pts[:q, :2] = (np.round(pts[:q, :2] / leaf) * leaf).astype(np.float32)  # on boundaries
    pts[q:q + 50, 0] = np.nan
    pts[q + 50:q + 100, 2] = np.inf
    pts[q + 100:q + 150] = [-999.0, 999.0, 0.5]
    blob = slice(2 * q, 3 * q)                                          # one cell
    pts[blob] = (np.asarray([0.05, 2.05, 0.5], np.float32)
                 + rng.normal(0, 0.01, (q, 3)).astype(np.float32))
    mask = rng.random(n) < 0.9
    return pts, mask


def phase_kernels(dev, report):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda, grid_cuda, voxel_grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    cfg, _, sc = headline_case()
    caps = cfg.caps
    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    rng = np.random.default_rng(2024)
    n = caps.n_max_points

    # ---- K1 -----------------------------------------------------------------
    pts, mask, _ = headline_frames(sc, n, range(8))
    apts, amask = adversarial_points(cfg, rng, n)
    pts[7], mask[7] = apts, amask
    P = torch.from_numpy(pts).to(dev)
    M = torch.from_numpy(mask).to(dev)
    acc_k, np_k = voxel_grid_cuda.accumulate_fast_stacked(P, M, cfg.scene, leaf, leaf_z)
    acc_p, np_p = voxel_grid_cuda.accumulate_fast_stacked_plain(P, M, cfg.scene, leaf, leaf_z)
    torch.cuda.synchronize()
    ok = equal(npy(acc_k), npy(acc_p)) and equal(npy(np_k), npy(np_p))
    err = max_err(npy(acc_k), npy(acc_p))
    log(f"[3 K1 voxel_grid] S=8 N={n} cells={acc_k.shape[2]} (frame 7 adversarial: "
        f"NaN/inf/out-of-bounds/leaf-boundary/masked/one-cell blob): "
        f"bit-exact={ok} max_abs_err={err} npts={npy(np_k).tolist()}")
    if not ok:
        fail("K1 disagrees with its plain version (bit-exact expected)")
    report["K1"] = {"max_abs_err": err}

    # ---- K2 -----------------------------------------------------------------
    tracker = Tracker(cfg, dev)
    env = headline_case(device=dev)[1]
    plan = tracker.plan(env)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=leaf, leaf_z=leaf_z,
              kwin=plan.table.k)
    accs = acc_k.clone()
    # adversarial frame 7: every cell occupied at its centre (one giant
    # component over the free space) ; frame 6: half the cells, random
    nc = accs.shape[2]
    k1 = voxel_grid_cuda.kernel_params(cfg.scene, leaf, leaf_z)
    lin = torch.arange(nc, device=dev)
    cx = (k1["bx"] + lin % k1["gx"]).float() * k1["leaf_xy"] + k1["half_xy"]
    cy = (k1["by"] + (lin // k1["gx"]) % k1["gy"]).float() * k1["leaf_xy"] + k1["half_xy"]
    cz = torch.full_like(cx, 0.5)
    accs[7] = torch.stack([cx, cy, cz, torch.ones_like(cx)])
    half = torch.from_numpy(rng.random(nc) < 0.5).to(dev)
    accs[6] = accs[7] * half
    outs_k = grid_cuda.fused_finalize_static_cc_stacked(
        accs, plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits, **kw)
    outs_p = grid_cuda.fused_finalize_static_cc_stacked_plain(
        accs, plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits,
        dims=plan.dims, offsets=grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance, leaf, leaf_z),
        kwin=plan.table.k, max_sweeps=2 * sum(plan.dims))
    torch.cuda.synchronize()
    names = ("cent", "dyn", "labels", "n_sweeps", "saturated")
    ok = all(equal(npy(a), npy(b)) for a, b in zip(outs_k, outs_p))
    n_comp = [int((outs_k[2][f] == torch.arange(nc, device=dev)).sum()) for f in range(8)]
    log(f"[3 K2 grid_cc] S=8 cells={nc} offsets={len(grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance, leaf, leaf_z))} "
        f"(frame 6: half the cells occupied, frame 7: all): bit-exact={ok} "
        f"iterations={npy(outs_k[3]).tolist()} saturated={npy(outs_k[4]).tolist()} "
        f"components={n_comp} dyn={npy(outs_k[1].sum(1)).tolist()}")
    if not ok:
        bad = [nm for nm, a, b in zip(names, outs_k, outs_p) if not equal(npy(a), npy(b))]
        fail(f"K2 disagrees with its plain version in {bad}")
    report["K2"] = {"max_abs_err": max_err(npy(outs_k[0]), npy(outs_p[0]))}

    # ---- K3 -----------------------------------------------------------------
    cent, dyn, labels, nsw, _ = outs_k
    ctab = cluster_table_grid(labels[:6], nsw[:6], cent[:6], dyn[:6], plan.dims[0],
                              cfg.min_cluster_size, cfg.max_cluster_size,
                              caps.c_max_clusters, caps.p_max_cluster)
    mp = ctab.mpts[0].clone()
    mm = ctab.member_mask[0].clone()
    c_max, p_max = mp.shape[0], mp.shape[1]
    # adversarial slots: a collinear cluster, duplicated points, a full slot
    # of P random members, an active slot after an empty one
    line = torch.linspace(0, 1, 40, device=dev)
    mp[10, :40] = torch.stack([1.0 + 0.3 * line, 2.0 + 0.6 * line, torch.zeros_like(line)], 1)
    mm[10, :40] = True
    mp[11, :30] = torch.from_numpy(rng.normal(0, 0.1, (30, 3)).astype(np.float32)).to(dev)
    mp[11, 30:60] = mp[11, :30]
    mm[11, :60] = True
    mp[12] = torch.from_numpy(rng.uniform(-1, 1, (p_max, 3)).astype(np.float32)).to(dev)
    mm[12] = True
    mp[20, :5] = torch.from_numpy(rng.normal(3, 0.05, (5, 3)).astype(np.float32)).to(dev)
    mm[20, :5] = True
    cm_k, fr_k = centroid_cuda.pair_stats(mp, mm)
    cm_p, fr_p = centroid_cuda.pair_stats_plain(mp, mm)
    torch.cuda.synchronize()
    ok = equal(npy(cm_k), npy(cm_p)) and equal(npy(fr_k), npy(fr_p))
    log(f"[3 K3 pair_stats] C={c_max} P={p_max} active={int(mm.any(1).sum())} (collinear, "
        f"duplicates, full slot, gap): bit-exact={ok} max_abs_err={max_err(npy(cm_k), npy(cm_p))}")
    if not ok:
        fail("K3 disagrees with its plain version (bit-exact expected)")
    report["K3"] = {"max_abs_err": max_err(npy(cm_k), npy(cm_p))}

    check_k2_sizes(dev, cfg, report)

    # ---- K4: the decision scan alone, then the whole track step --------------
    report["K4 scan"] = {"max_abs_err": check_k4(dev, cfg, rng, caps.k_max_tracks,
                                                 caps.c_max_clusters)}
    check_track(dev, cfg, tracker.gains_xy, caps.k_max_tracks,
                ((1, 1, caps.c_max_clusters, ()), (1, 8, caps.c_max_clusters, (0,)),
                 (8, 1, caps.c_max_clusters, (0,)), (1, 8, 128, ())), report, "K4")
    return cfg, sc, (pts, mask), (mp, mm)


def check_k4(dev, cfg, rng, K, D) -> float:
    """K4 against its plain version on a K-slot bank and D detection slots:
    a first frame, conflicting detections with interpolation gaps, a full
    bank.  Decisions exact; returns the max abs error."""
    from multiple_object_tracking_lidar_tpu_torch.ops import assign_cuda

    cases = []
    # (a) first frame: no gating, everything registers
    af0 = torch.zeros((K, 3), device=dev)
    ai0 = torch.stack([torch.zeros(K, dtype=torch.int32), torch.full((K,), -1, dtype=torch.int32),
                       torch.full((K,), 2**30, dtype=torch.int32)], 1).to(dev)
    dets = torch.from_numpy(rng.uniform(-2, 2, (D, 4)).astype(np.float32)).to(dev)
    dets[:, 3] = 0.1
    dv = torch.zeros(D, dtype=torch.bool, device=dev)
    dv[:5] = True
    dv[7] = True
    cases.append(("first frame", af0, ai0, dets, dv, False, 0, 0))
    # (b) conflicting detections: several near one track, one near a track
    # registered earlier in the same frame, invalid lanes inside the bound
    af1 = torch.from_numpy(rng.uniform(-2, 2, (K, 3)).astype(np.float32)).to(dev)
    af1[:, 2] = 0.0
    alive = (torch.arange(K, device=dev) % 3 != 0).int()
    births = torch.randperm(K, generator=torch.Generator().manual_seed(1)).int().to(dev)
    ai1 = torch.stack([alive, torch.arange(K, device=dev).int() + 100, births], 1).int()
    d2 = dets.clone()
    d2[:, 3] = 0.5  # a gap of 5 frames: interpolation
    d2[0, :2] = af1[1, :2] + 0.1
    d2[1, :2] = af1[1, :2] - 0.1
    d2[2, :2] = torch.tensor([9.0, 9.0], device=dev)
    d2[3, :2] = torch.tensor([9.2, 9.1], device=dev)
    dv2 = torch.ones(D, dtype=torch.bool, device=dev)
    dv2[4] = False
    dv2[D - 1] = False
    cases.append(("conflicts", af1, ai1, d2, dv2, True, 300, 500))
    # (c) a full bank: unmatched detections overflow
    ai2 = ai1.clone()
    ai2[:, 0] = 1
    cases.append(("full bank", af1, ai2, d2, dv2, True, 300, 500))
    ok, err4 = True, 0.0
    for name, a_f, a_i, dts, dvv, allow, nobj, nbirth in cases:
        args = (a_f, a_i, dts, dvv, torch.tensor(allow, device=dev),
                torch.tensor(nobj, dtype=torch.int32, device=dev),
                torch.tensor(nbirth, dtype=torch.int32, device=dev))
        kw4 = dict(thr=cfg.id_threshold, dt_gp=cfg.dt_gp, interp_gap_factor=cfg.interp_gap_factor)
        rk = assign_cuda.assoc_scan(*args, **kw4)
        rp = assign_cuda.assoc_scan_plain(*args, **kw4)
        torch.cuda.synchronize()
        oks = npy(rk[9])
        same = all(equal(npy(x), npy(y)) for i, (x, y) in enumerate(zip(rk, rp)) if i != 6)
        same = same and equal(npy(rk[6])[oks], npy(rp[6])[oks])
        err4 = max([err4, max_err(npy(rk[6])[oks], npy(rp[6])[oks])]
                   + [max_err(npy(x), npy(y)) for i, (x, y) in enumerate(zip(rk, rp)) if i != 6])
        log(f"[3 K4 scan] K={K} D={D} {name}: exact={same} registered={int(npy(rk[8]).sum())} "
            f"ok={int(oks.sum())} interp={int(npy(rk[10]).sum())} overflow={int(rk[5])}")
        ok = ok and same
    if not ok:
        fail(f"K4's decision scan at K={K} disagrees with its plain version (exact expected)")
    return err4


def check_track(dev, cfg, gains, K, cases, report, name, gated=False):
    """K4 (the whole track step) against its plain version on the card,
    bit for bit in every state and output field: ``cases`` of (B, S, D,
    fresh banks), on ``track_scene``'s frames (``gated``: its Hungarian
    scene).  Returns the max abs error."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene

    err = 0.0
    for i, (B, S, D, fresh) in enumerate(cases):
        inputs = track_scene(1000 * K + i, cfg, K, D, B, S, fresh, dev, gated)
        label = f"K={K} {B} x {S} frames, D={D}" + (
            f" (first frame in banks {list(fresh)})" if fresh else "")
        err = max(err, check_track_inputs(cfg, gains, inputs, report, name, label))
    return err


def check_track_inputs(cfg, gains, inputs, report, name, label):
    """``check_track`` on given inputs (state with a leading (B,) axis,
    dets (B, S, D, 4), valid (B, S, D), t (B, S)): K4 against its plain
    version, bit for bit; the max abs error, also kept in report[name]."""
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    st, dets, valid, t = inputs
    B, S = valid.shape[:2]
    ks, ko = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)
    ps, po = track_cuda.track_frames_plain(st, dets, valid, t, config=cfg, gains_xy=gains)
    torch.cuda.synchronize()
    pairs = list(zip(ko, po)) + list(zip(ks.bank, ps.bank)) + list(zip(ks[1:], ps[1:]))
    ok = all(equal(npy(a), npy(b)) for a, b in pairs)
    err = max(max_err(npy(a), npy(b)) for a, b in pairs)
    vv = npy(ko.valid)
    ids = npy(ko.obj_id)
    dups = sum(len(ids[b, s][vv[b, s]]) - len(set(ids[b, s][vv[b, s]].tolist()))
               for b in range(B) for s in range(S))
    log(f"[3 {name} track step] {label}: bit-exact={ok} max_abs_err={err} "
        f"valid={int(vv.sum())} duplicates={dups} registered={int(npy(ko.new_track).sum())} "
        f"overflow={int(npy(ko.overflow).sum())} "
        f"assoc_saturated={int(npy(ko.assoc_saturated).sum())} "
        f"n_alive={npy(ko.n_alive)[:, -1].tolist()}")
    if not ok:
        bad = [f for f, a, b in zip(track_cuda.TrackOutputs._fields, ko, po)
               if not equal(npy(a), npy(b))]
        fail(f"{name} ({label}) disagrees with its plain version: {bad}")
    report.setdefault(name, {"max_abs_err": 0.0})
    report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    return err


def check_k2_sizes(dev, cfg, report):
    """K2 against its plain version on the card at every grid of
    ``k2_grids``, at the cluster size its rule picks and, on the headline
    grid, at every cluster size: bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import k2_grids, k2_inputs
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda

    err = 0.0
    for label, dims, leaf, leaf_z, tol in k2_grids(cfg):
        n = dims[0] * dims[1] * dims[2]
        offsets = grid_cuda.kernel_offsets(dims, tol, leaf, leaf_z)
        accs, scal, br, bc, bits, kwin = k2_inputs(dims, leaf, leaf_z, tol, n, dev)
        kw = dict(dims=dims, tol=tol, leaf_xy=leaf, leaf_z=leaf_z, kwin=kwin)
        rule = grid_cuda.cluster_size(n, len(offsets), dev)
        sizes = [c for c in (1, 2, 4, 8, 16) if c <= grid_cuda.max_cluster(dev)
                 and -(-n // c) <= grid_cuda.cta_cells(len(offsets))]
        plain = grid_cuda.fused_finalize_static_cc_stacked_plain(
            accs, scal, br, bc, bits, dims=dims, offsets=offsets, kwin=kwin,
            max_sweeps=2 * sum(dims))
        for c in (sizes if label == "headline" else [rule]):
            got = grid_cuda.fused_finalize_static_cc_stacked(accs, scal, br, bc, bits, cluster=c, **kw)
            torch.cuda.synchronize()
            ok = all(equal(npy(a), npy(b)) for a, b in zip(got, plain))
            e = max_err(npy(got[0]), npy(plain[0]))
            err = max(err, e)
            comps = [int((got[2][f] == torch.arange(n, device=dev)).sum()) for f in range(3)]
            log(f"[3 K2 grid_cc] {label}: {dims[0]} x {dims[1]} x {dims[2]} = {n} cells, "
                f"{len(offsets)} offsets, cluster {c} of {rule} by rule: bit-exact={ok} "
                f"iterations={npy(got[3]).tolist()} saturated={npy(got[4]).tolist()} "
                f"components={comps} dyn={npy(got[1].sum(1)).tolist()}")
            if not ok:
                fail(f"K2 at {n} cells, cluster {c}, disagrees with its plain version")
    report["K2"]["max_abs_err"] = max(report["K2"]["max_abs_err"], err)


def blob_frame(cfg, rng, n):
    """n points, 99% of them in one cell at the top of the digit range
    (digit sums in the tens of millions), the rest uniform, a few NaN, inf
    and masked points."""
    sc = cfg.scene
    pts = np.stack([rng.uniform(sc.x_min, sc.x_max, n), rng.uniform(sc.y_min, sc.y_max, n),
                    rng.uniform(sc.z_min, sc.z_max, n)], 1).astype(np.float32)
    blob = int(0.99 * n)
    pts[:blob] = [0.0999, 2.0999, 0.9]
    pts[blob:blob + 5, 0] = np.nan
    pts[blob + 5:blob + 10, 2] = np.inf
    mask = rng.random(n) < 0.97
    mask[:blob] = True
    return pts[None], mask[None]


def sorted_rows(P, M, cfg):
    """The runs path's sorted keys and the co-sorted coordinates, gathered."""
    ks, perm, vals = sorted_perm(P, M, cfg)
    return ks, [torch.gather(vals[..., c], 1, perm).contiguous() for c in range(3)]


def sorted_perm(P, M, cfg):
    """The runs path's K7 inputs as ``_sorted_runs`` hands them over: the
    sorted keys, the sort's permutation and the unsorted (S, N, 3) values."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    k = vg.kernel_params(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    ok, lin, _ = vg.kept_cells(P, M, k)
    keys = torch.where(ok, lin, k["n_cells"]).to(torch.int32)
    vals = torch.where(ok[..., None], P, 0.0)
    ks, perm = torch.sort(keys, dim=1, stable=True)
    return ks, perm, vals


def check_pair(report, name, what, fk, fp):
    """Kernel call fk against plain call fp on the card: bit for bit (for
    K8, labels exact)."""
    k_out, p_out = fk(), fp()
    torch.cuda.synchronize()
    ok = all(equal(npy(a), npy(b)) for a, b in zip(k_out, p_out))
    err = max(max_err(npy(a), npy(b)) for a, b in zip(k_out, p_out))
    log(f"[3 {name}] {what}: bit-exact={ok} max_abs_err={err}")
    if not ok:
        fail(f"{name} disagrees with its plain version ({what}; bit-exact expected)")
    entry = report.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return k_out


def phase_kernels_more(dev, report, cfg, k1_inputs):
    """K5, K6 and K7 (and K1 past the TPU's f32 bound) on the card."""
    from multiple_object_tracking_lidar_tpu_torch.ops import segsum_cuda, voxel_grid_cuda as vg

    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    rng = np.random.default_rng(77)
    P = torch.from_numpy(k1_inputs[0]).to(dev)
    M = torch.from_numpy(k1_inputs[1]).to(dev)
    n = P.shape[1]
    adv = "frame 7 adversarial: NaN/inf/out-of-bounds/leaf-boundary/masked/one-cell blob"

    bp, bm = blob_frame(cfg, rng, 133_120)
    BP, BM = torch.from_numpy(bp).to(dev), torch.from_numpy(bm).to(dev)
    kw = (cfg.scene, leaf, leaf_z)
    check_pair(report, "K1", "S=1 N=133120 (N*127 >= 2^24, the TPU's v4 regime), 99% in one cell",
               lambda: vg.accumulate_fast_stacked(BP, BM, *kw),
               lambda: vg.accumulate_fast_stacked_plain(BP, BM, *kw))

    check_pair(report, "K5", f"S=8 N={n} cells={vg.kernel_params(*kw)['n_cells']} ({adv})",
               lambda: vg.accumulate_exact_stacked(P, M, *kw),
               lambda: vg.accumulate_exact_stacked_plain(P, M, *kw))
    bp, bm = blob_frame(cfg, rng, 131_072)
    BP, BM = torch.from_numpy(bp).to(dev), torch.from_numpy(bm).to(dev)
    out = check_pair(report, "K5", "S=1 N=131072 (N*128 >= 2^24, the TPU's v3 regime), 99% in one cell",
                     lambda: vg.accumulate_exact_stacked(BP, BM, *kw),
                     lambda: vg.accumulate_exact_stacked_plain(BP, BM, *kw))
    log(f"[3 K5]   blob cell count {float(out[0][0, 3].max())}")

    P1, M1 = P[:, :100_000].contiguous(), M[:, :100_000].contiguous()
    check_pair(report, "K6", f"S=8 N=100000, the unpadded exact route ({adv})",
               lambda: vg.accumulate_bf16x3_stacked(P1, M1, *kw),
               lambda: vg.accumulate_bf16x3_stacked_plain(P1, M1, *kw))
    kw15 = (cfg.scene, 0.15, 3.0)
    check_pair(report, "K6", f"S=2 N={n} leaf 0.15 m (too coarse for two digits), "
               f"cells={vg.kernel_params(*kw15)['n_cells']}",
               lambda: vg.accumulate_bf16x3_stacked(P[:2], M[:2], *kw15),
               lambda: vg.accumulate_bf16x3_stacked_plain(P[:2], M[:2], *kw15))

    ks, vals = sorted_rows(P, M, cfg)
    ks[6] = 5                                        # frame 6: one run over all 13 blocks
    ks[5, 8100:8300] = ks[5, 8100]                   # frame 5: a run across the block edge
    ks[5] = torch.cummax(ks[5], 0).values
    vals[0][7, 9000] = float("inf")                  # frame 7: inf and signed zeros
    vals[1][7, 8191] = float("-inf")
    vals[2][7, ::7] = -0.0
    check_pair(report, "K7", f"S=8 N={n} sorted headline rows (frame 5: a run across the "
               "8192-row edge; 6: one run; 7: inf and -0.0)",
               lambda: segsum_cuda.segment_totals(ks, *vals),
               lambda: segsum_cuda.segment_totals_plain(ks, *vals))
    ks, perm, v3 = sorted_perm(P, M, cfg)
    v3[7, perm[7, 9000]] = float("inf")              # frame 7: inf and signed zeros, sorted
    v3[7, perm[7, ::7], 2] = -0.0                    # into place through the permutation
    chans = [v3[..., c] for c in range(3)]
    check_pair(report, "K7", f"S=8 N={n} through the permutation of the runs front end's own "
               "sort (the channels of one (S, N, 3) tensor; frame 7: inf and -0.0)",
               lambda: segsum_cuda.segment_totals(ks, *chans, perm=perm),
               lambda: segsum_cuda.segment_totals_plain(ks, *chans, perm=perm))


def phase_kernels_fleet(dev, report, cfg, k1_inputs):
    """K1's and K5's histograms alone (``*_stacked_raw``) and finalizes
    alone (``finalize_*_stacked``), the kernel fleet's entries, against
    their plain versions, and raw + finalize against the fused kernel: at
    S = 8 headline frames (frame 7 adversarial) and on a blob frame past
    the TPU's f32 bound."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    P = torch.from_numpy(k1_inputs[0]).to(dev)
    M = torch.from_numpy(k1_inputs[1]).to(dev)
    bp, bm = blob_frame(cfg, np.random.default_rng(91), 133_120)
    BP, BM = torch.from_numpy(bp).to(dev), torch.from_numpy(bm).to(dev)
    adv = "frame 7 adversarial: NaN/inf/out-of-bounds/leaf-boundary/masked/one-cell blob"
    kinds = (
        ("K1", vg.accumulate_fast_stacked_raw, vg.finalize_fast_stacked,
         vg.accumulate_fast_stacked, vg.fast_digit_sums),
        ("K5", vg.accumulate_exact_stacked_raw, vg.finalize_exact_stacked,
         vg.accumulate_exact_stacked, vg.exact_digit_sums),
    )
    for name, raw_fn, fin_fn, fused, plain_raw in kinds:
        for what, PP, MM in ((f"S=8 N={P.shape[1]} ({adv})", P, M),
                             ("S=1 N=133120, 99% in one cell", BP, BM)):
            raw = check_pair(report, f"{name} raw", what,
                             lambda: raw_fn(PP, MM, *kw),
                             lambda: (plain_raw(PP, MM, *kw), (MM != 0).sum(1).to(torch.int32)))
            check_pair(report, f"{name} fin", f"{what}: finalize of those sums",
                       lambda: (fin_fn(raw[0], *kw),),
                       lambda: (fin_fn(raw[0].cpu(), *kw).to(dev),))
            check_pair(report, f"{name} fin", f"{what}: raw + finalize against the fused {name}",
                       lambda: (fin_fn(raw[0], *kw), raw[1]),
                       lambda: fused(PP, MM, *kw))


def phase_kernels_pointlist(dev, report, cfg, k1_inputs):
    """K6's f32 mode, K8 and K9 on the card, against their plain versions."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        cluster_pallas, segsum_cuda, voxel_grid_cuda as vg)

    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    P = torch.from_numpy(k1_inputs[0]).to(dev)
    M = torch.from_numpy(k1_inputs[1]).to(dev)
    n = P.shape[1]
    kw = (cfg.scene, leaf, leaf_z)
    adv = "frame 7 adversarial: NaN/inf/out-of-bounds/leaf-boundary/masked/one-cell blob"
    check_pair(report, "K6f", f"S=8 N={n} cells={vg.kernel_params(*kw)['n_cells']} ({adv})",
               lambda: vg.accumulate_f32_stacked(P, M, *kw),
               lambda: vg.accumulate_f32_stacked_plain(P, M, *kw))
    gcfg, _, gsc = bench_cases.default_case()
    gn = gcfg.caps.n_max_points
    gp, gm, _ = headline_frames(gsc, gn, range(2))
    GP, GM = torch.from_numpy(gp).to(dev), torch.from_numpy(gm).to(dev)
    gkw = (gcfg.scene, gcfg.voxel_leaf_size, gcfg.leaf_z)
    check_pair(report, "K6f G", f"S=2 N={gn} at configuration G's grid, "
               f"cells={vg.kernel_params(*gkw)['n_cells']}, "
               f"{vg.sorted_sums_plan(2, gn, vg.kernel_params(*gkw)['n_cells'])['passes']} passes",
               lambda: vg.accumulate_f32_stacked(GP, GM, *gkw),
               lambda: vg.accumulate_f32_stacked_plain(GP, GM, *gkw))

    # K8 at the point list C gives it: 8 headline frames compacted to
    # M = 1,024 dynamic voxels; frame 6 a reversed 300-point chain (longer
    # than n_sweeps = 256: cut short), frame 7 a lattice at the tolerance's
    # spacing (thousands of pairs an ulp or two from tol2), frame 5 empty
    pcfg = bench_cases.pointlist_case()[0]
    caps = pcfg.caps
    pts, msk = pointlist_rows(dev, pcfg, P, M)
    pts[6] = 50.0
    pts[6, :300, 0] = torch.arange(299, -1, -1, device=dev, dtype=torch.float32) * 0.1
    msk[6] = False
    msk[6, :300] = True
    lat = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij"), -1)
    pts[7] = 0.5
    pts[7, :, :2] = lat.reshape(-1, 2).to(dev).float() * 0.15 - 2.0
    pts[7] += torch.from_numpy(np.random.default_rng(8).normal(0, 1e-6, (caps.m_max_dynamic, 3))
                               .astype(np.float32)).to(dev)
    msk[7] = True
    msk[5] = False
    tol, sweeps = pcfg.cluster_tolerance, 8 * caps.label_prop_iters
    out = check_pair(report, "K8", f"S=8 M={caps.m_max_dynamic} headline point lists (5: empty; "
                     f"6: a 300-point chain cut at n_sweeps={sweeps}; 7: a boundary lattice)",
                     lambda: (cluster_pallas.connected_components_pallas(pts, msk, tol, sweeps),),
                     lambda: (cluster_pallas.connected_components_pallas_plain(pts, msk, tol, sweeps),))
    lab = out[0]
    comps = [int(((lab[f] == torch.arange(lab.shape[1], device=dev)) & msk[f]).sum()) for f in range(8)]
    log(f"[3 K8]   components per frame {comps}")
    check_pair(report, "K8a", "the adjacency stage alone, same inputs (bool M x M)",
               lambda: (cluster_pallas.cc_adjacency(pts, msk, tol),),
               lambda: (cluster_pallas.cc_adjacency_plain(pts, msk, tol),))
    gpts, gmsk = pointlist_rows(dev, gcfg, GP, GM)
    check_pair(report, "K8", f"S=2 M={gcfg.caps.m_max_dynamic} configuration G's point lists",
               lambda: (cluster_pallas.connected_components_pallas(gpts, gmsk, tol, sweeps),),
               lambda: (cluster_pallas.connected_components_pallas_plain(gpts, gmsk, tol, sweeps),))
    check_pair(report, "K8a", f"S=2 M={gcfg.caps.m_max_dynamic} configuration G's point lists",
               lambda: (cluster_pallas.cc_adjacency(gpts, gmsk, tol),),
               lambda: (cluster_pallas.cc_adjacency_plain(gpts, gmsk, tol),))
    # past the shared-memory layout: M = 8,192 rows of both point lists
    # stacked with blobs, the adjacency words in device memory
    big = cluster_pallas.MAX_ROWS
    layout = cluster_pallas.cc_layout(big, dev)
    if layout[1]:
        fail(f"cc_layout({big}) keeps the adjacency in shared memory: {layout}")
    rng = np.random.default_rng(81)
    bp = torch.from_numpy(rng.normal(0, 0.8, (2, big, 3)).astype(np.float32)).to(dev)
    bp[..., 2] *= 0.1
    bm = torch.from_numpy(rng.random((2, big)) < 0.7).to(dev)
    bp[0, :pts.shape[1]] = pts[0]
    bm[0, :pts.shape[1]] = msk[0]
    bp[1, :gpts.shape[1]] = gpts[0]
    bm[1, :gpts.shape[1]] = gmsk[0]
    check_pair(report, "K8", f"S=2 M={big} past the shared-memory layout ({layout[0]} CTAs per "
               "frame, the adjacency words in device memory)",
               lambda: (cluster_pallas.connected_components_pallas(bp, bm, tol, sweeps),),
               lambda: (cluster_pallas.connected_components_pallas_plain(bp, bm, tol, sweeps),))
    check_pair(report, "K8a", f"S=2 M={big} past the shared-memory layout",
               lambda: (cluster_pallas.cc_adjacency(bp, bm, tol),),
               lambda: (cluster_pallas.cc_adjacency_plain(bp, bm, tol),))

    ks, vals = sorted_rows(P, M, cfg)
    ks[5, 2000:2100] = ks[5, 2000]                   # frame 5: a run across the 2048-row edge
    ks[5] = torch.cummax(ks[5], 0).values
    ks[6] = 5                                        # frame 6: one run over every block
    v4 = torch.stack(vals + [torch.ones_like(vals[0])], dim=-1).contiguous()
    v4[7, 2047, 0] = float("inf")                    # frame 7: inf at a block's last row
    v4[7, ::5, 2] = -0.0
    check_pair(report, "K9", f"S=8 N={n} sorted headline rows x 4 channels (5: a run across "
               "the 2048-row edge; 6: one run; 7: inf and -0.0)",
               lambda: (segsum_cuda.segment_totals_rows(ks, v4),),
               lambda: (segsum_cuda.segment_totals_rows_plain(ks, v4),))
    # one block of a ragged T = N (the TPU kernel's N < 2048): the first N
    # sorted rows of each frame, inf and -0.0 where the cyclic roll wraps
    for t in (1001, 7):
        kt, vt = ks[:, :t].contiguous(), v4[:, :t].clone()
        kt[0] = kt[0, 0]                              # frame 0: one run
        vt[:, t - 1, 3] = float("inf")                # inf * 0 -> NaN into row 0
        vt[:, t - 3:, 1] = -0.0
        vt[:, :4, 2] = -0.0
        check_pair(report, "K9", f"S=8 N={t}: one block of a ragged T = {t} (inf and -0.0 in "
                   "the rows the roll wraps onto)",
                   lambda: (segsum_cuda.segment_totals_rows(kt, vt),),
                   lambda: (segsum_cuda.segment_totals_rows_plain(kt, vt),))


def knife_edge_table(rng, c, p, dev):
    """A (C, P) member table for K10: clusters on a 0.1 m lattice (equal
    distances: ties in both argmax scans), a singleton, a collinear
    lattice cluster (G == 0), a full slot, duplicated points, and empty
    slots between and after the active ones."""
    mp = np.zeros((c, p, 3), np.float32)
    mm = np.zeros((c, p), bool)
    for k in range(0, c // 2, 2):                       # odd slots stay empty
        n = int(rng.integers(2, p))
        mp[k, :n] = np.round(rng.normal(0, 1, (n, 3)) * 10) / 10
        mm[k, :n] = True
    mp[1, 0] = [1.0, 2.0, 0.5]                          # singleton
    mm[1, 0] = True
    line = np.arange(12, dtype=np.float32)
    mp[3, :12] = np.stack([0.1 * line, 0.2 * line, 0 * line], 1)   # collinear
    mm[3, :12] = True
    mp[5] = np.round(rng.uniform(-1, 1, (p, 3)) * 10) / 10          # full slot
    mm[5] = True
    mp[7, :20] = np.round(rng.normal(3, 0.3, (20, 3)) * 10) / 10    # duplicates
    mp[7, 20:40] = mp[7, :20]
    mm[7, :40] = True
    return torch.from_numpy(mp).to(dev), torch.from_numpy(mm).to(dev)


def phase_kernels_slice5(dev, report, cfg, k1_inputs, table):
    """K10, K6's key entry, K1-cm, K4 on grown banks and K11 against their
    plain versions on the card, bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, transpose_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_from_pair_stats)

    rng = np.random.default_rng(55)
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    mp, mm = table
    gcaps = bench_cases.default_case()[0].caps
    for what, tp, tm in (
            (f"C={mp.shape[0]} P={mp.shape[1]} headline table ({int(mm.any(1).sum())} active: "
             "collinear, duplicates, full slot, gap)", mp, mm),
            ("C=32 P=384 knife edges on a 0.1 m lattice (ties, singleton, collinear, "
             "full slot, duplicates, empty slots)", *knife_edge_table(rng, 32, 384, dev)),
            (f"C={gcaps.c_max_clusters} P={gcaps.p_max_cluster} (configuration G's table) knife "
             "edges", *knife_edge_table(rng, gcaps.c_max_clusters, gcaps.p_max_cluster, dev))):
        check_pair(report, "K10", what, lambda: (centroid_cuda.circumcenter_xy(tp, tm),),
                   lambda: (centroid_cuda.circumcenter_xy_plain(tp, tm),))
        eager = lambda: circumcenter_from_pair_stats(  # noqa: E731
            *centroid_cuda.pair_stats(tp, tm), tp, tm, torch.tensor(0.0, device=dev))
        check_pair(report, "K10", f"{what}: against K3's stats and the eager selection",
                   lambda: (centroid_cuda.circumcenter_xy(tp, tm),), lambda: (eager()[:, :2],))
        check_pair(report, "K3f", f"{what}: against K3's stats and the eager selection",
                   lambda: (centroid_cuda.circumcenter_features(tp, tm, 0.0),), lambda: (eager(),))

    P = torch.from_numpy(k1_inputs[0]).to(dev)
    M = torch.from_numpy(k1_inputs[1]).to(dev)
    k1p = vg.kernel_params(*kw)
    gx, gyz = k1p["gx"], k1p["gy"] * k1p["gz"]
    ok, lin, _ = vg.kept_cells(P, M, k1p)
    ix, iyz = (lin % gx).to(torch.int32), (lin // gx).to(torch.int32)
    check_pair(report, "K6 keys", f"S=8 N={P.shape[1]} keys from the headline frames' cells "
               f"(gx={gx}, gyz={gyz}) against K6's quantizing entry",
               lambda: (vg.accumulate_bf16x3_keys(P, ix, iyz, ok, gx, gyz),),
               lambda: (vg.accumulate_bf16x3_stacked(P, M, *kw)[0],))
    ix[:, :500] = gx                                   # out of range, in bounds
    iyz[:, 500:1000] = -3
    iyz[:, 1000:1500] = gyz
    ok[:, 1500:3000] = False                           # valid cells, not in bounds
    ok[:, 3000:3100] = True                            # in bounds, cell of the dropped
    check_pair(report, "K6 keys", f"S=8 N={P.shape[1]} adversarial keys (ix = gx, iyz < 0, "
               "iyz = gyz, in_bounds false on valid cells)",
               lambda: (vg.accumulate_bf16x3_keys(P, ix, iyz, ok, gx, gyz),),
               lambda: (vg.accumulate_bf16x3_keys_plain(P, ix, iyz, ok, gx, gyz),))

    Pcm = P.transpose(1, 2).contiguous()
    adv = "frame 7 adversarial: NaN/inf/out-of-bounds/leaf-boundary/masked/one-cell blob"
    check_pair(report, "K1-cm", f"S=8 N={P.shape[1]} channel-major ({adv})",
               lambda: vg.accumulate_fast_stacked_cm(Pcm, M, *kw),
               lambda: vg.accumulate_fast_stacked_cm_plain(Pcm, M, *kw))
    check_pair(report, "K1-cm", "against K1 on the (S, N, 3) rows",
               lambda: vg.accumulate_fast_stacked_cm(Pcm, M, *kw),
               lambda: vg.accumulate_fast_stacked(P, M, *kw))
    raw = check_pair(report, "K1-cm raw", f"S=8 N={P.shape[1]} channel-major ({adv})",
                     lambda: vg.accumulate_fast_stacked_cm_raw(Pcm, M, *kw),
                     lambda: (vg.fast_digit_sums(P, M, *kw), (M != 0).sum(1).to(torch.int32)))
    check_pair(report, "K1-cm raw", "raw + K1 fin against the fused K1-cm",
               lambda: (vg.finalize_fast_stacked(raw[0], *kw), raw[1]),
               lambda: vg.accumulate_fast_stacked_cm(Pcm, M, *kw))

    report["K4 scan"]["max_abs_err"] = max(
        [report["K4 scan"]["max_abs_err"]]
        + [check_k4(dev, cfg, rng, k, cfg.caps.c_max_clusters) for k in (256, 1024)])
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    check_track(dev, cfg, Tracker(cfg, dev).gains_xy, 1024,
                ((1, 1, 128, ()), (1, 8, 128, (0,)), (8, 1, cfg.caps.c_max_clusters, ())),
                report, "K4 wide")

    words = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, 2048, dtype=np.int64)
                             .astype(np.int32)).to(dev)
    for what, x in ((f"S=8 N={P.shape[1]} headline points (S, N, 3) -> (S, 3, N) ({adv})", P),
                    ("micro_transpose.py's (1, 2048) int32 row -> (2048, 1)",
                     words.reshape(1, 1, 2048)),
                    ("its tiled probe, (16, 128) -> (128, 16)", words.reshape(1, 16, 128)),
                    ("partial tiles both ways, (3, 70, 27) f32 words", words[:1890].view(
                        torch.float32).reshape(1, 70, 27).expand(3, 70, 27).contiguous()),
                    (f"S=8 R={P.shape[1] - 1} points (R % 4 = 3: a ragged last group, "
                     "misaligned planes and frame bases)", P[:, 1:].contiguous()),
                    ("S=2 R=5000 points from a frame base 4 bytes past 16-byte alignment",
                     P.reshape(-1)[1:1 + 30_000].view(2, 5000, 3)),
                    ("C=1: (4, 3001, 1) int32 words, a copy",
                     torch.arange(12004, device=dev, dtype=torch.int32).view(4, 3001, 1) * 7919),
                    ("C=5: (3, 1001, 5) f32 words, 32 x 32 tiles",
                     P.reshape(-1)[:15015].view(3, 1001, 5))):
        check_pair(report, "K11", what, lambda: (transpose_cuda.transpose_words(x),),
                   lambda: (transpose_cuda.transpose_words_plain(x),))


def k3f_tables(rng, s, c, p, dev):
    """S stacked (C, P) member tables, flattened to (S * C, P): a 0.1 m
    lattice cluster (ties in both scans), an exactly collinear one
    (G == 0), a singleton, two members, all-equal members, a NaN member, a
    full slot, and empty slots after them."""
    mp = np.zeros((s, c, p, 3), np.float32)
    mm = np.zeros((s, c, p), bool)
    for f in range(s):
        n = int(rng.integers(2, p))
        mp[f, 0, :n] = np.round(rng.normal(0, 1, (n, 3)) * 10) / 10
        mm[f, 0, :n] = True
        mp[f, 1, :9] = np.stack([0.25 * np.arange(9), 0.5 * np.arange(9), np.zeros(9)], 1)
        mm[f, 1, :9] = True
        mp[f, 2, 3], mm[f, 2, 3] = [1.0, 2.0, 0.5], True
        mp[f, 3, :2], mm[f, 3, :2] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], True
        mp[f, 4, :12], mm[f, 4, :12] = [3.0, -1.0, 0.25], True
        mp[f, 5, :40] = rng.normal(0, 1, (40, 3))
        mm[f, 5, :40] = True
        mp[f, 5, 21, 1] = np.nan
        mp[f, 6] = rng.uniform(-2, 2, (p, 3))
        mm[f, 6] = True
    return (torch.from_numpy(mp).reshape(s * c, p, 3).to(dev),
            torch.from_numpy(mm).reshape(s * c, p).to(dev))


def phase_kernels_slice7(dev, report):
    """K3f (with K3 and K10 on its tables) and K6's three entries on the
    edge cases of their redesign, against their plain versions, bit for
    bit; K3f also against K3's stats with the eager selection after them,
    the route it replaces."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda, voxel_grid_cuda as vg
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_from_pair_stats

    rng = np.random.default_rng(707)
    for s, c, p in ((8, 32, 384), (8, 64, 512)):
        mp, mm = k3f_tables(rng, s, c, p, dev)
        t = torch.arange(s, dtype=torch.float32, device=dev) * 0.1 + 0.05
        what = (f"S={s} x C={c} P={p} stacked (lattice, collinear, empty, 1- and 2-member, "
                "all-equal, NaN-member, full slots), one t per frame")
        check_pair(report, "K3f", what,
                   lambda: (centroid_cuda.circumcenter_features(mp, mm, t),),
                   lambda: (centroid_cuda.circumcenter_features_plain(mp, mm, t),))
        check_pair(report, "K3f", f"{what}: against K3's stats and the eager selection",
                   lambda: (centroid_cuda.circumcenter_features(mp, mm, t),),
                   lambda: (circumcenter_from_pair_stats(*centroid_cuda.pair_stats(mp, mm), mp,
                                                         mm, t.repeat_interleave(c)),))
        check_pair(report, "K3", what, lambda: centroid_cuda.pair_stats(mp, mm),
                   lambda: centroid_cuda.pair_stats_plain(mp, mm))
        check_pair(report, "K10", what, lambda: (centroid_cuda.circumcenter_xy(mp, mm),),
                   lambda: (centroid_cuda.circumcenter_xy_plain(mp, mm),))

    for tag, case, k6f in (("the headline's grid", bench_cases.headline_case, "K6f"),
                           ("configuration G's grid", bench_cases.default_case, "K6f G")):
        cfg, _, sc = case()
        n = cfg.caps.n_max_points
        pts, mask, _ = headline_frames(sc, n, range(3))
        P, M = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        P[0, ::9, 0] = float("nan")
        P[1] = torch.tensor([0.05, 2.05, 0.5], device=dev)
        M[2] = False
        kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
        k = vg.kernel_params(*kw)
        what = (f"S=3 N={n} cells={k['n_cells']} at {tag} (frame 0: NaN points; 1: every "
                "point in one cell; 2: all dropped)")
        check_pair(report, "K6", what, lambda: vg.accumulate_bf16x3_stacked(P, M, *kw),
                   lambda: vg.accumulate_bf16x3_stacked_plain(P, M, *kw))
        out = check_pair(report, k6f, what, lambda: vg.accumulate_f32_stacked(P, M, *kw),
                         lambda: vg.accumulate_f32_stacked_plain(P, M, *kw))
        if int(out[0][1, 3].max()) != int(M[1].sum()) or bool((out[0][2] != 0).any()):
            fail(f"K6f at {tag}: the one-cell frame or the all-dropped frame lost points")
        gx, gyz = k["gx"], k["gy"] * k["gz"]
        ok, lin, _ = vg.kept_cells(P, torch.ones_like(M), k)
        ix, iyz = (lin % gx).to(torch.int32), (lin // gx).to(torch.int32)
        ix[:, :64], iyz[:, :64], ok[:, :64] = gx - 1, gyz - 1, True
        ok[2] = False
        check_pair(report, "K6 keys", f"{what}, keys at n_cells - 1",
                   lambda: (vg.accumulate_bf16x3_keys(P, ix, iyz, ok, gx, gyz),),
                   lambda: (vg.accumulate_bf16x3_keys_plain(P, ix, iyz, ok, gx, gyz),))


def digit_entries(vg):
    """{entry: (kernel wrapper, plain call, channel-major)} of K1, K5, their
    raw entries and K1-cm: the plain calls take (S, N, 3) points."""
    def npts(M):
        return (M != 0).sum(1).to(torch.int32)
    return {
        "K1": (vg.accumulate_fast_stacked, vg.accumulate_fast_stacked_plain, False),
        "K1 raw": (vg.accumulate_fast_stacked_raw,
                   lambda P, M, *kw: (vg.fast_digit_sums(P, M, *kw), npts(M)), False),
        "K1-cm": (vg.accumulate_fast_stacked_cm, vg.accumulate_fast_stacked_plain, True),
        "K1-cm raw": (vg.accumulate_fast_stacked_cm_raw,
                      lambda P, M, *kw: (vg.fast_digit_sums(P, M, *kw), npts(M)), True),
        "K5": (vg.accumulate_exact_stacked, vg.accumulate_exact_stacked_plain, False),
        "K5 raw": (vg.accumulate_exact_stacked_raw,
                   lambda P, M, *kw: (vg.exact_digit_sums(P, M, *kw), npts(M)), False),
    }


def phase_kernels_slice8(dev, report, cfg, k1_inputs):
    """K1, K5, their raw entries and K1-cm against their plain versions, bit
    for bit, on the grids of ``bench_cases.digit_grids``: the headline's
    5,500 cells (8 frames, frame 7 adversarial) at every layout (cell ranges
    x point chunks) that holds it, 32,768, 70,200 and 193,536 cells (two of
    the path's frames and an adversarial one) at the rule's layout; each
    grid also on the 99%-in-one-cell frames at N = 133,120 and 131,072, and
    raw + finalize against the fused kernel.  Then a grid of exactly
    ``max_cells`` runs, and one a row longer raises."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    rng = np.random.default_rng(808)
    top = vg.max_cluster(dev)
    entries = digit_entries(vg)
    fins = {"K1": vg.finalize_fast_stacked, "K5": vg.finalize_exact_stacked}
    for label, scene, leaf, leaf_z, case in bench_cases.digit_grids(cfg):
        gcfg = cfg.replace(scene=scene, voxel_leaf_size=leaf)
        kw = (scene, leaf, leaf_z)
        nc = vg.kernel_params(*kw)["n_cells"]
        if label == "headline":
            pts, mask = k1_inputs
        else:
            ccfg, _, sc = getattr(bench_cases, f"{case}_case")()
            n = ccfg.caps.n_max_points
            pts, mask, _ = headline_frames(sc, n, range(2))
            apts, amask = adversarial_points(gcfg, rng, n)
            pts, mask = np.concatenate([pts, apts[None]]), np.concatenate([mask, amask[None]])
        sets = [(f"S={pts.shape[0]} N={pts.shape[1]} (frame {pts.shape[0] - 1} adversarial)",
                 pts, mask)]
        for nb in (133_120, 131_072):
            sets.append((f"S=1 N={nb}, 99% in one cell", *blob_frame(gcfg, rng, nb)))
        layouts = ([(r, c) for r in (1, 2, 4, 8, 16) for c in (1, 2, 4, 8, 16)
                    if r <= top and c <= top and vg._span(nc, r) <= vg.CTA_CELLS]
                   if label == "headline" else [None])
        for what, p_np, m_np in sets:
            P, M = torch.from_numpy(p_np).to(dev), torch.from_numpy(m_np).to(dev)
            Pcm = P.transpose(1, 2).contiguous()
            for name, (fk, fp, cm) in entries.items():
                want = fp(P, M, *kw)
                torch.cuda.synchronize()
                for lay in layouts:
                    lk = {} if lay is None else {"ranges": lay[0], "chunks": lay[1]}
                    got = fk(Pcm if cm else P, M, *kw, **lk)
                    torch.cuda.synchronize()
                    ok = all(equal(npy(a), npy(b)) for a, b in zip(got, want))
                    err = max(max_err(npy(a), npy(b)) for a, b in zip(got, want))
                    entry = report.setdefault(name, {"max_abs_err": 0.0})
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
                    if not ok:
                        fail(f"{name} at {label} ({nc} cells), {what}, layout {lay}: differs "
                             "from its plain version (bit-exact expected)")
            for k in ("K1", "K5"):
                raw = entries[f"{k} raw"][0](P, M, *kw)
                if not all(equal(npy(a), npy(b)) for a, b in zip(
                        (fins[k](raw[0], *kw), raw[1]), entries[k][0](P, M, *kw))):
                    fail(f"{k} raw + fin differs from the fused {k} at {label}, {what}")
            lay_note = (f"every layout ({len(layouts)}: ranges x chunks)" if label == "headline"
                        else f"the rule's layouts K1 {vg.digit_layout(nc, P.shape[0], 1, dev)}, "
                             f"K5 {vg.digit_layout(nc, P.shape[0], 3, dev)}")
            log(f"[3 K1/K5 slice 8] {label}: {nc} cells, {what}, {lay_note}: K1, K1 raw, K1-cm, "
                "K1-cm raw, K5, K5 raw bit-exact=True; raw + fin = fused")

    # the edge of PR 8's layouts: 14,520 x 16 cells take 16 ranges, one row
    # more the wide layout (32 ranges), every entry bit for bit its plain version
    P, M = (torch.from_numpy(a[:2]).to(dev) for a in k1_inputs)
    x0, y0 = cfg.scene.x_min, cfg.scene.y_min
    for gx, fits in ((vg.CTA_CELLS * top // 16, True), (vg.CTA_CELLS * top // 16 + 1, False)):
        scene = SceneBounds(x_min=x0, x_max=x0 + (gx - 0.5) * 0.05, y_min=y0,
                            y_max=y0 + 15.5 * 0.05, z_min=0.0, z_max=0.5)
        kw = (scene, 0.05, 1.0)
        nc = vg.kernel_params(*kw)["n_cells"]
        if fits:
            check_pair(report, "K1", f"S=2 at exactly max_cells = {nc} cells",
                       lambda: vg.accumulate_fast_stacked(P, M, *kw),
                       lambda: vg.accumulate_fast_stacked_plain(P, M, *kw))
            continue
        for name, (fk, fp, cm) in entries.items():
            check_pair(report, "K1 wide" if name.startswith("K1") else "K5 wide",
                       f"{name} at {nc} cells (max_cells {vg.max_cells(dev)} + 16), S=2, layout "
                       f"{vg.digit_layout(nc, 2, 3 if name.startswith('K5') else 1, dev)}",
                       lambda fk=fk, cm=cm: fk(P.transpose(1, 2).contiguous() if cm else P, M,
                                               *kw),
                       lambda fp=fp: fp(P, M, *kw))


def pointlist_rows(dev, cfg, P, M):
    """The compacted dynamic voxels the point list feeds its CC: (S, M, 3)
    points and (S, M) mask of the frames P, M under ``cfg``."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import (
        build_static_mask, remove_static)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_downsample_dense

    env = build_static_mask(load_sim_grid(), cfg.static_tolarance, cfg.occupied_threshold,
                            device=dev)
    vox, vmask, _ = voxel_downsample_dense(P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z,
                                           cfg.caps.m_max_voxels)
    pts, msk, _ = compact_points(vox, remove_static(vox, vmask, env), cfg.caps.m_max_dynamic)
    return pts.contiguous(), msk.contiguous()


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------
def kernel_wrappers():
    """{kernel: its wrapper, whose ``.launches`` counts its launches}."""
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        assign_cuda, centroid_cuda, cluster_pallas, grid_cuda, hungarian_cuda, learning_cuda,
        segsum_cuda, stencil_cc_cuda, track_cuda, transpose_cuda, voxel_grid_cuda)

    vg = voxel_grid_cuda
    return {
        "K1": vg.accumulate_fast_stacked,
        "K1 raw": vg.accumulate_fast_stacked_raw,
        "K1 fin": vg.finalize_fast_stacked,
        "K1-cm": vg.accumulate_fast_stacked_cm,
        "K1-cm raw": vg.accumulate_fast_stacked_cm_raw,
        "K2": grid_cuda.fused_finalize_static_cc_stacked,
        "K3": centroid_cuda.pair_stats,
        "K3f": centroid_cuda.circumcenter_features,
        "K4": track_cuda.track_frames,
        "K4 scan": assign_cuda.assoc_scan,
        "K5": vg.accumulate_exact_stacked,
        "K5 raw": vg.accumulate_exact_stacked_raw,
        "K5 fin": vg.finalize_exact_stacked,
        "K6": vg.accumulate_bf16x3_stacked,
        "K6 keys": vg.accumulate_bf16x3_keys,
        "K6f": vg.accumulate_f32_stacked,
        "K7": segsum_cuda.segment_totals,
        "K8": cluster_pallas.connected_components_pallas,
        "K8a": cluster_pallas.cc_adjacency,
        "K9": segsum_cuda.segment_totals_rows,
        "K10": centroid_cuda.circumcenter_xy,
        "K11": transpose_cuda.transpose_words,
        "K12": hungarian_cuda.auction_assign,
        "K13": learning_cuda.learning_step_cuda,
        "K14": stencil_cc_cuda.stencil_cc,
        "K6f keys": vg.accumulate_sums_keys,
    }


PLAIN_SUMS = "plain digit sums"   # not a kernel: the digit sums' CPU route


def entry_builds():
    """{build: (its wrapper, its C entry)} for the builds a wrapper counts
    in ``.launches_by`` beside its f32 build (``.launches``): K2, K3f, K4,
    K6f, K8a and K14 built for double (``dtype="float64"``), K2's double
    build fed f32 sums, K4 xl in f32 and f64, K2, K14, K3f, K4 and K4 xl
    built for bf16 and f16, K6f, K8a and K2 fed f32 sums built for them,
    K3f's f32 table build and K12's half builds."""
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, cluster_pallas, grid_cuda, hungarian_cuda, stencil_cc_cuda, track_cuda,
        voxel_grid_cuda)

    k2, k4 = grid_cuda.fused_finalize_static_cc_stacked, track_cuda.track_frames
    return {"K2 f64": (k2, "motl_grid_cc_f64"),
            "K3f f64": (centroid_cuda.circumcenter_features, "motl_circumcenter_features_f64"),
            "K4 f64": (k4, "motl_track_step_f64"),
            "K6f f64": (voxel_grid_cuda.accumulate_f32_stacked, "motl_voxel_sums_f64"),
            "K8a f64": (cluster_pallas.cc_adjacency, "motl_cc_adjacency_f64"),
            "K2 f64 f32-sums": (k2, "motl_grid_cc_f64_f32sums"),
            "K4 xl": (k4, "motl_track_step_xl"),
            "K4 xl f64": (k4, "motl_track_step_xl_f64"),
            "K14 f64": (stencil_cc_cuda.stencil_cc, "motl_stencil_cc_f64"),
            "K6f keys f64": (voxel_grid_cuda.accumulate_sums_keys, "motl_voxel_sums_keys_f64"),
            **{f"{k} {h}": (w, f"{e}_{h}") for h in ("bf16", "f16") for k, w, e in (
                ("K2", k2, "motl_grid_cc"),
                ("K14", stencil_cc_cuda.stencil_cc, "motl_stencil_cc"),
                ("K3f", centroid_cuda.circumcenter_features, "motl_circumcenter_features"),
                ("K4", k4, "motl_track_step"),
                ("K4 xl", k4, "motl_track_step_xl"))},
            **{f"{k} {h}": (w, e.format(h=h)) for h in ("bf16", "f16") for k, w, e in (
                ("K6f", voxel_grid_cuda.accumulate_f32_stacked, "motl_voxel_sums_{h}"),
                ("K8a", cluster_pallas.cc_adjacency, "motl_cc_adjacency_{h}"))},
            **{f"K2 {h} f32-sums": (k2, f"motl_grid_cc_{h}_f32sums") for h in ("bf16", "f16")},
            "K3f table": (centroid_cuda.circumcenter_features, "motl_circumcenter_features_table"),
            **{f"K12 {h}": (hungarian_cuda.auction_assign, f"motl_auction_assign_{h}")
               for h in ("bf16", "f16")}}


def reset_counts():
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid

    for w in kernel_wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_by"):
            w.launches_by.clear()
    voxel_grid.digit_sums_stacked.plain_routes = 0


def read_counts():
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid

    counts = {k: w.launches for k, w in kernel_wrappers().items()}
    counts.update({k: w.launches_by[e] for k, (w, e) in entry_builds().items()})
    counts[PLAIN_SUMS] = voxel_grid.digit_sums_stacked.plain_routes
    return counts


DEVICE_TIMED = ("K7", "K9", "K11")     # phase 5 also reads their device time
FAST_PATH = ("K1", "K2", "K3f", "K4")   # the kernels each path must launch
TAIL = ("K2", "K3f", "K4")
FLEET_PATH = ("K1 raw", "K1 fin", "K2", "K3f", "K4")
FLEET_C_PATH = ("K6f", "K8", "K3f", "K4")


def k4_report_as(position_filter, association="greedy"):
    """A Hungarian path's K4 launches count in the report as K4 hungarian's
    (its double build's as K4 hungarian f64's), an ihgp path's as K4
    ihgp's."""
    if association == "hungarian":
        return {"K4": "K4 hungarian", "K4 f64": "K4 hungarian f64"}
    return {"K4": "K4 ihgp"} if position_filter == "ihgp" else None


def require(tag, counts, need, report, report_as=None):
    """Fail unless every kernel of ``need`` launched in this path's run,
    unless a tracking path (one that needs K3f) launched no K3, and unless
    the path took no plain digit sums (the CPU's route); add the run's kernel counts to the report, under
    the names ``report_as`` maps them to."""
    missing = [k for k in need if counts[k] <= 0]
    if missing:
        fail(f"{missing} not launched on the {tag} path: {counts}")
    if "K3f" in need and counts["K3"]:
        fail(f"the {tag} path launched K3 {counts['K3']} times (its circumcenter is K3f)")
    if counts[PLAIN_SUMS]:
        fail(f"the {tag} path took the plain digit sums {counts[PLAIN_SUMS]} times "
             "(the CPU's route)")
    for k, c in counts.items():
        if k == PLAIN_SUMS:
            continue
        k = (report_as or {}).get(k, k)
        report.setdefault(k, {"max_abs_err": 0.0})
        report[k]["launches"] = report[k].get("launches", 0) + c


def compare(tag, got: dict, ref: dict, tol_dets, tol_vel):
    """Integers, booleans and decisions exact; floats within tolerance;
    pos / vel compared where ``valid`` (other lanes carry no contract:
    they follow det_slot, which is defined only where det_ok)."""
    errs = {}
    for f, r in ref.items():
        g = got[f]
        if f in ("pos", "vel", "raw_centroid"):
            sel = ref["valid"] if f != "raw_centroid" else np.ones(r.shape[:-1], bool)
            tol = tol_vel if f == "vel" else tol_dets
            e = max_err(g[sel], r[sel])
            errs[f] = e
            if e > tol:
                fail(f"{tag}: {f} max abs err {e}")
        elif not np.array_equal(np.asarray(g), np.asarray(r)):
            fail(f"{tag}: {f} differs: {np.asarray(g).tolist()} vs {np.asarray(r).tolist()}")
    return errs


def phase_slice(dev, cfg, sc, report):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    golden = dict(np.load(GOLDEN))
    n_gold = golden["publish"].shape[0]
    n = cfg.caps.n_max_points

    # the port's plain path on the CPU, same frames
    t_cpu = Tracker(cfg, "cpu")
    env_cpu = headline_case()[1]
    step_cpu = t_cpu.bind_env(env_cpu)
    st = t_cpu.init_state()
    cpu_rows = []
    pts, mask, ts = headline_frames(sc, n, range(n_gold))
    for k in range(n_gold):
        st, o = step_cpu(st, Frame(torch.from_numpy(pts[k]), torch.from_numpy(mask[k]),
                                   torch.tensor(ts[k])))
        cpu_rows.append([npy(x) for x in o])
    fields = golden.keys()
    cpu = {f: np.stack([r[i] for r in cpu_rows]) for i, f in enumerate(fields)}
    e = compare("CPU plain path vs JAX golden", cpu, golden, TOL_DETS, TOL_VEL)
    log(f"[4 slice] port plain path on the CPU, {n_gold} frames vs JAX golden: match, max abs err {e}")

    # TrackerNode: one PointCloud2 at a time
    node = TrackerNode(cfg, dev, keep_outputs=True)
    node.on_map(load_sim_grid())
    reset_counts()
    replies = [node.on_pointcloud(sc.frame(k)) for k in range(n_gold)]
    torch.cuda.synchronize()
    node_counts = read_counts()
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in fields}
    e_gold = compare("TrackerNode vs JAX golden", got, golden, TOL_DETS, TOL_VEL)
    e_cpu = compare("TrackerNode vs CPU plain path", got, cpu, TOL_DETS, TOL_CPU_VEL)
    n_pub = sum(r is not None for r in replies)
    log(f"[4 slice] TrackerNode.on_pointcloud x{n_gold}: {n_pub} published, ids "
        f"{sorted({o.id for r in replies if r for o in r[0].obstacles})}, "
        f"launches {node_counts}; vs JAX golden max abs err {e_gold}; vs CPU {e_cpu}")
    require("TrackerNode", node_counts, FAST_PATH, report)
    if node_counts["K4"] != n_gold:
        fail(f"TrackerNode: {node_counts['K4']} K4 launches for {n_gold} frames (one per frame)")

    # bind_env_multi: 4 dispatches of S = 8
    tracker = Tracker(cfg, dev)
    env = headline_case(device=dev)[1]
    multi = tracker.bind_env_multi(env)
    S, n_disp = 8, 4
    pts, mask, ts = headline_frames(sc, n, range(S * n_disp))
    P = torch.from_numpy(pts).to(dev)
    M = torch.from_numpy(mask).to(dev)
    T = torch.from_numpy(ts).to(dev)
    state = tracker.init_state()
    reset_counts()
    outs = []
    for d in range(n_disp):
        sl = slice(d * S, (d + 1) * S)
        state, o = multi(state, Frame(P[sl], M[sl], T[sl]))
        outs.append([npy(x) for x in o])
    torch.cuda.synchronize()
    multi_counts = read_counts()
    allm = {f: np.concatenate([r[i] for r in outs]) for i, f in enumerate(fields)}
    first = {f: v[:n_gold] for f, v in allm.items()}
    e_gold = compare("bind_env_multi vs JAX golden", first, golden, TOL_DETS, TOL_VEL)
    e_cpu = compare("bind_env_multi vs CPU plain path", first, cpu, TOL_DETS, TOL_CPU_VEL)
    e_node = compare("bind_env_multi vs TrackerNode", first, got, 0.0, 0.0)
    fin = {f: np.isfinite(v[allm["valid"]]).all() for f, v in allm.items() if f in ("pos", "vel")}
    log(f"[4 slice] bind_env_multi {n_disp}x S={S}: {S * n_disp} frames, launches {multi_counts}, "
        f"finite {fin}, n_alive {allm['n_alive'].tolist()}; first {n_gold} vs JAX golden max abs "
        f"err {e_gold}; vs CPU {e_cpu}; vs TrackerNode {e_node}")
    require("bind_env_multi", multi_counts, FAST_PATH, report)
    if multi_counts["K4"] != n_disp:
        fail(f"bind_env_multi: {multi_counts['K4']} K4 launches for {n_disp} calls (one per call)")
    if not all(fin.values()):
        fail("non-finite pos/vel on valid lanes")
    return tracker, env, (P, M, T)


def phase_modes(dev, report):
    """Exact mode (K5), runs mode (K7) and exact mode on unpadded frames
    (K6), each through TrackerNode and bind_env_multi against its golden."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    paths = (("A exact", bench_cases.exact_case, GOLDEN_EXACT, "K5", 12, 2),
             ("B runs", bench_cases.runs_case, GOLDEN_RUNS, "K7", 12, 2),
             ("exact unpadded", bench_cases.exact_unpadded_case, GOLDEN_EXACT, "K6", 4, 1))
    for tag, case, gold_path, kern, n_node, n_disp in paths:
        golden = dict(np.load(gold_path))
        fields = golden.keys()
        cfg, env, sc = case(device=dev)
        node = TrackerNode(cfg, dev, keep_outputs=True)
        node.on_map(load_sim_grid())
        reset_counts()
        replies = [node.on_pointcloud(sc.frame(k)) for k in range(n_node)]
        torch.cuda.synchronize()
        counts = read_counts()
        got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in fields}
        ref = {f: v[:n_node] for f, v in golden.items()}
        e = compare(f"{tag} TrackerNode vs JAX golden", got, ref, TOL_DETS, TOL_VEL)
        n_pub = sum(r is not None for r in replies)
        log(f"[4 {tag}] TrackerNode.on_pointcloud x{n_node} (N={cfg.caps.n_max_points}): "
            f"{n_pub} published, launches {counts}; vs JAX golden max abs err {e}")
        require(f"{tag} TrackerNode", counts, (kern,) + TAIL, report)

        tracker = Tracker(cfg, dev)
        multi = tracker.bind_env_multi(env)
        S = 8 if n_disp > 1 else 4
        pts, mask, ts = headline_frames(sc, cfg.caps.n_max_points, range(S * n_disp))
        P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, mask, ts))
        state = tracker.init_state()
        reset_counts()
        outs = []
        for d in range(n_disp):
            sl = slice(d * S, (d + 1) * S)
            state, o = multi(state, Frame(P[sl], M[sl], T[sl]))
            outs.append([npy(x) for x in o])
        torch.cuda.synchronize()
        counts = read_counts()
        allm = {f: np.concatenate([r[i] for r in outs]) for i, f in enumerate(fields)}
        n_cmp = min(len(allm["publish"]), len(golden["publish"]))
        first = {f: v[:n_cmp] for f, v in allm.items()}
        e = compare(f"{tag} bind_env_multi vs JAX golden", first,
                    {f: v[:n_cmp] for f, v in golden.items()}, TOL_DETS, TOL_VEL)
        fin = all(np.isfinite(v[allm["valid"]]).all() for f, v in allm.items() if f in ("pos", "vel"))
        log(f"[4 {tag}] bind_env_multi {n_disp}x S={S}: launches {counts}, finite {fin}, "
            f"first {n_cmp} vs JAX golden max abs err {e}")
        require(f"{tag} bind_env_multi", counts, (kern,) + TAIL, report)
        if not fin:
            fail(f"{tag}: non-finite pos/vel on valid lanes")


def phase_g_grid(dev, report):
    """G-grid (``bench_cases.default_grid_case``: configuration G's config
    and frames on the dense grid, K1 and K2 at 193,536 cells) through
    ``bind_env`` (8 frames) and ``bind_env_multi`` (one dispatch of S = 8),
    each against the port's own ``bind_env`` on the CPU over the same
    frames (integers and decisions exact, positions TOL_DETS, velocities
    TOL_CPU_VEL), with K1, K2, K3f and K4 launched and no plain digit sums."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cfg, env, sc = bench_cases.default_grid_case(device=dev)
    n_fr = 8
    pts, mask, ts = headline_frames(sc, cfg.caps.n_max_points, range(n_fr))
    t_cpu = Tracker(cfg, "cpu")
    step = t_cpu.bind_env(bench_cases.default_grid_case()[1])
    st = t_cpu.init_state()
    rows = []
    for k in range(n_fr):
        st, o = step(st, Frame(torch.from_numpy(pts[k]), torch.from_numpy(mask[k]),
                               torch.tensor(ts[k])))
        rows.append(o)
    fields = rows[0]._fields
    cpu = {f: np.stack([npy(getattr(o, f)) for o in rows]) for f in fields}
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, mask, ts))
    tracker = Tracker(cfg, dev)
    one = tracker.bind_env(env)
    st = tracker.init_state()
    reset_counts()
    outs = []
    for k in range(n_fr):
        st, o = one(st, Frame(P[k], M[k], T[k]))
        outs.append(o)
    torch.cuda.synchronize()
    counts = read_counts()
    got = {f: np.stack([npy(getattr(o, f)) for o in outs]) for f in fields}
    e1 = compare("G-grid bind_env vs the CPU bind_env", got, cpu, TOL_DETS, TOL_CPU_VEL)
    require("G-grid bind_env", counts, FAST_PATH, report)
    log(f"[4 G-grid] bind_env x{n_fr} (193,536 cells, N={cfg.caps.n_max_points}): n_clusters "
        f"{got['n_clusters'].tolist()}, launches {counts}; vs the port's CPU bind_env max abs "
        f"err {e1}")
    reset_counts()
    _, o = tracker.bind_env_multi(env)(tracker.init_state(), Frame(P, M, T))
    torch.cuda.synchronize()
    counts = read_counts()
    got = {f: npy(getattr(o, f)) for f in fields}
    e8 = compare("G-grid bind_env_multi vs the CPU bind_env", got, cpu, TOL_DETS, TOL_CPU_VEL)
    require("G-grid bind_env_multi", counts, FAST_PATH, report)
    log(f"[4 G-grid] bind_env_multi S={n_fr}: launches {counts}; vs the port's CPU bind_env "
        f"max abs err {e8}")


def run_node(dev, tag, cfg, sc, golden, n_node, need, report, counts_out=None,
             tols=(TOL_DETS, TOL_VEL)):
    """TrackerNode over n_node PointCloud2 frames against the golden within
    ``tols`` (the run's launch counts into ``counts_out`` where given)."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    fields = golden.keys()
    node = TrackerNode(cfg, dev, keep_outputs=True)
    node.on_map(load_sim_grid())
    reset_counts()
    replies = [node.on_pointcloud(sc.frame(k)) for k in range(n_node)]
    torch.cuda.synchronize()
    counts = read_counts()
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in fields}
    ref = {f: v[:n_node] for f, v in golden.items()}
    e = compare(f"{tag} TrackerNode vs JAX golden", got, ref, *tols)
    n_pub = sum(r is not None for r in replies)
    log(f"[4 {tag}] TrackerNode.on_pointcloud x{n_node} (N={cfg.caps.n_max_points}): "
        f"{n_pub} published, n_dynamic {got['n_dynamic'].tolist()}, launches {counts}; "
        f"vs JAX golden max abs err {e}")
    require(f"{tag} TrackerNode", counts, need, report,
            k4_report_as(cfg.position_filter, cfg.association))
    if counts_out is not None:
        counts_out.update(counts)
    return got


def run_multi(dev, tag, cfg, env, sc, golden, n_disp, s_frames, need, report,
              tols=(TOL_DETS, TOL_VEL)):
    """bind_env_multi over n_disp dispatches of S frames against the
    golden within ``tols``; returns the outputs stacked over frames."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    fields = golden.keys()
    tracker = Tracker(cfg, dev)
    multi = tracker.bind_env_multi(env)
    pts, mask, ts = headline_frames(sc, cfg.caps.n_max_points, range(s_frames * n_disp))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, mask, ts))
    state = tracker.init_state()
    reset_counts()
    outs = []
    for d in range(n_disp):
        sl = slice(d * s_frames, (d + 1) * s_frames)
        state, o = multi(state, Frame(P[sl], M[sl], T[sl]))
        outs.append([npy(x) for x in o])
    torch.cuda.synchronize()
    counts = read_counts()
    allm = {f: np.concatenate([r[i] for r in outs]) for i, f in enumerate(fields)}
    n_cmp = min(len(allm["publish"]), len(golden["publish"]))
    e = compare(f"{tag} bind_env_multi vs JAX golden", {f: v[:n_cmp] for f, v in allm.items()},
                {f: v[:n_cmp] for f, v in golden.items()}, *tols)
    fin = all(np.isfinite(v[allm["valid"]]).all() for f, v in allm.items() if f in ("pos", "vel"))
    log(f"[4 {tag}] bind_env_multi {n_disp}x S={s_frames}: launches {counts}, finite {fin}, "
        f"first {n_cmp} vs JAX golden max abs err {e}")
    require(f"{tag} bind_env_multi", counts, need, report,
            k4_report_as(cfg.position_filter, cfg.association))
    if not fin:
        fail(f"{tag}: non-finite pos/vel on valid lanes")
    return allm


def phase_pointlist(dev, report):
    """The point-list configurations C-G against their JAX goldens."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    paths = (("C pointlist", bench_cases.pointlist_case, "pointlist", ("K6f", "K8", "K3f", "K4")),
             ("D pointlist jnp", bench_cases.pointlist_jnp_case, "pointlist",
              ("K6f", "K8a", "K3f", "K4")),
             ("E scan", bench_cases.scan_case, "pointlist_scan", ("K8a", "K3f", "K4")),
             ("F runs", bench_cases.pointlist_runs_case, "pointlist_runs",
              ("K7", "K8", "K3f", "K4")))
    for tag, case, gold, need in paths:
        golden = dict(np.load(GOLDEN_PL[gold]))
        cfg, env, sc = case(device=dev)
        got = run_node(dev, tag, cfg, sc, golden, 12, need, report)
        allm = run_multi(dev, tag, cfg, env, sc, golden, 2, 8, need, report)
        e = compare(f"{tag} bind_env_multi vs TrackerNode", {f: v[:12] for f, v in allm.items()},
                    got, 0.0, 0.0)
        log(f"[4 {tag}] bind_env_multi vs TrackerNode, first 12 frames: max abs err {e}")
    golden = dict(np.load(GOLDEN_PL["default"]))
    cfg, env, sc = bench_cases.default_case(device=dev)
    g_counts = {}
    run_node(dev, "G defaults", cfg, sc, golden, 4, ("K6f", "K8a", "K3f", "K4"), report,
             g_counts)
    report.setdefault("K6f G", {"max_abs_err": 0.0})["launches"] = g_counts["K6f"]


def fleet_frames(dev, sc, n, b, n_steps):
    """(points (steps, B, n, 3), mask (steps, B, n), t (steps, B)) on the
    card: stream s at step k gets headline frame 3 s + k."""
    pts, mask, ts = headline_frames(sc, n, [3 * s + k for k in range(n_steps) for s in range(b)])
    return tuple(torch.from_numpy(a.reshape((n_steps, b) + a.shape[1:])).to(dev)
                 for a in (pts, mask, ts))


def run_fleet(tag, fleet, env, frames, need, report):
    """One ShardedTracker over frames (steps, B, ...), counters reset
    before and read after; its outputs as {field: (steps, B, ...)}."""
    P, M, T = frames
    step = fleet.bind_env(env)
    state = fleet.init_state(P.shape[1])
    reset_counts()
    outs = []
    for k in range(P.shape[0]):
        state, o = step(state, P[k], M[k], T[k])
        outs.append(o)
    torch.cuda.synchronize()
    counts = read_counts()
    fcfg = fleet.tracker.config
    require(tag, counts, need, report, k4_report_as(fcfg.position_filter, fcfg.association))
    if counts["K4"] != P.shape[0]:
        fail(f"{tag}: {counts['K4']} K4 launches for {P.shape[0]} steps (one per step)")
    return {f: np.stack([npy(getattr(o, f)) for o in outs]) for f in outs[0]._fields}, counts


def per_stream_bind_env(tag, tracker, env, frames, got):
    """Each stream's own bind_env on the card, bit for bit against the
    fleet's outputs ``got``."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    P, M, T = frames
    one = tracker.bind_env(env)
    for s in range(P.shape[1]):
        st = tracker.init_state()
        for k in range(P.shape[0]):
            st, o = one(st, Frame(P[k, s], M[k, s], T[k, s]))
            bad = [f for f in o._fields if not equal(npy(getattr(o, f)), got[f][k, s])]
            if bad:
                fail(f"{tag}: stream {s} step {k} differs from its bind_env in {bad}")


def phase_fleet(dev, report):
    """The fleet on a one-rank NCCL mesh: the kernel fleet at B = 8
    headline streams, the vmap fleet on C, MultiplexedTracker and
    StreamingNode, each against its golden and the port's own bind_env."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.runtime.fleet import MultiplexedTracker
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    B, n_steps = 8, 3
    mesh = make_mesh(1, 1, device=dev)
    gold_fleet = dict(np.load(GOLDEN_FLEET))
    gold = dict(np.load(GOLDEN))
    cfg, env, sc = bench_cases.headline_case(device=dev)
    frames = fleet_frames(dev, sc, cfg.caps.n_max_points, B, n_steps)

    tracker = Tracker(cfg, dev)
    fleet = ShardedTracker(tracker, mesh, kernel_path="on")
    got, counts = run_fleet("kernel fleet", fleet, env, frames, FLEET_PATH, report)
    e_gold = compare("kernel fleet vs JAX fleet golden", got, gold_fleet, TOL_DETS, TOL_VEL)
    per_stream_bind_env("kernel fleet", tracker, env, frames, got)
    e_s0 = compare("kernel fleet stream 0 vs slice golden frames 0-2",
                   {f: v[:, 0] for f, v in got.items()}, {f: v[:n_steps] for f, v in gold.items()},
                   TOL_DETS, TOL_VEL)
    log(f"[4 fleet] kernel fleet B={B} x {n_steps} steps on a 1 x 1 NCCL mesh: launches {counts}, "
        f"n_clusters {got['n_clusters'].tolist()}, valid {got['valid'].sum(2).tolist()}; vs JAX "
        f"fleet golden max abs err {e_gold}; bit for bit each stream's bind_env; stream 0 vs slice "
        f"golden {e_s0}")

    acfg, aenv, _ = bench_cases.exact_case(device=dev)
    atracker = Tracker(acfg, dev)
    got, counts = run_fleet("kernel fleet A exact", ShardedTracker(atracker, mesh, kernel_path="on"),
                            aenv, frames, ("K5 raw", "K5 fin", "K2", "K3f", "K4"), report)
    per_stream_bind_env("kernel fleet A exact", atracker, aenv, frames, got)
    e_a = compare("kernel fleet A exact stream 0 vs exact golden frames 0-2",
                  {f: v[:, 0] for f, v in got.items()},
                  {f: v[:n_steps] for f, v in dict(np.load(GOLDEN_EXACT)).items()},
                  TOL_DETS, TOL_VEL)
    log(f"[4 fleet] kernel fleet, exact mode (A), B={B} x {n_steps} steps: launches {counts}; "
        f"bit for bit each stream's bind_env; stream 0 vs exact golden {e_a}")

    ccfg, cenv, _ = bench_cases.pointlist_case(device=dev)
    ctracker = Tracker(ccfg, dev)
    vfleet = ShardedTracker(ctracker, mesh)
    if vfleet._use_kernel_fleet:
        fail("configuration C took the kernel fleet")
    got, counts = run_fleet("vmap fleet C", vfleet, cenv, frames, FLEET_C_PATH, report)
    per_stream_bind_env("vmap fleet C", ctracker, cenv, frames, got)
    e_c = compare("vmap fleet C stream 0 vs C golden frames 0-2",
                  {f: v[:, 0] for f, v in got.items()},
                  {f: v[:n_steps] for f, v in dict(np.load(GOLDEN_PL["pointlist"])).items()},
                  TOL_DETS, TOL_VEL)
    log(f"[4 fleet] vmap fleet C B={B} x {n_steps} steps: launches {counts}, n_dynamic "
        f"{got['n_dynamic'].tolist()}; bit for bit each stream's bind_env; stream 0 vs C golden {e_c}")

    n_fr = 12
    pts, mask, ts = headline_frames(sc, cfg.caps.n_max_points, range(n_fr))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, mask, ts))
    mux = MultiplexedTracker(tracker, env, 2)
    reset_counts()
    rows = [[], []]
    for k in range(n_fr):
        for s in range(2):
            rows[s].append(mux.step(s, Frame(P[k], M[k], T[k])))
    torch.cuda.synchronize()
    counts = read_counts()
    require("MultiplexedTracker", counts, FAST_PATH, report)
    errs = []
    for s in range(2):
        g = {f: np.stack([npy(getattr(o, f)) for o in rows[s]]) for f in rows[s][0]._fields}
        errs.append(compare(f"MultiplexedTracker stream {s} vs slice golden", g, gold, TOL_DETS, TOL_VEL))
    log(f"[4 fleet] MultiplexedTracker 2 streams x {n_fr} frames, round robin: launches {counts}; "
        f"vs slice golden max abs err {errs}")

    recs = []
    node = StreamingNode(cfg, on_outputs=lambda *r: recs.append(r), depth=3, device=dev)
    node.on_map(load_sim_grid())
    reset_counts()
    for k in range(n_fr):
        node.submit(sc.frame(k))
    node.flush()
    torch.cuda.synchronize()
    counts = read_counts()
    require("StreamingNode", counts, FAST_PATH, report)
    published = [k for k in range(n_fr) if gold["publish"][k]]
    if len(recs) != len(published):
        fail(f"StreamingNode published {len(recs)} frames, the golden {len(published)}")
    e_pos = e_vel = 0.0
    for (obstacles, _, _), k in zip(recs, published):
        v = gold["valid"][k]
        if [o.id for o in obstacles.obstacles] != gold["obj_id"][k][v].tolist():
            fail(f"StreamingNode frame {k}: ids differ from the golden")
        e_pos = max(e_pos, max_err([o.position[:2] for o in obstacles.obstacles], gold["pos"][k][v]))
        e_vel = max(e_vel, max_err([o.velocity[:2] for o in obstacles.obstacles], gold["vel"][k][v]))
    if e_pos > TOL_DETS or e_vel > TOL_VEL:
        fail(f"StreamingNode vs slice golden: pos err {e_pos}, vel err {e_vel}")
    log(f"[4 fleet] StreamingNode depth 3 x {n_fr} PointCloud2 frames: {len(recs)} published, "
        f"launches {counts}, summary {node.summary()}; vs slice golden pos err {e_pos}, vel err {e_vel}")
    return fleet, env, frames


def phase_entry_points(dev, report, cfg, sc, table):
    """This slice's entry points with every launch counter reset before and
    read after: ``ops/centroid_pallas.py`` (K10's table and xy, K3 by the
    JAX names), ``ops/voxel_grid.py::accumulate_from_indices`` (K6's key
    entry) on a headline frame, and the two micro-benchmark scripts (K3;
    K1, K1-cm, their histograms and K1's finalize), each holding its
    results against the same function by another route."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_acc
    import micro_torch_pair_stats

    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_pallas
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import (
        circumcenter_from_pair_stats)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import accumulate_from_indices

    mp, mm = table
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    pts, mask, _ = headline_frames(sc, cfg.caps.n_max_points, [0])
    P0, M0 = torch.from_numpy(pts[0]).to(dev), torch.from_numpy(mask[0]).to(dev)
    k1p = vg.kernel_params(*kw)
    gx, gyz = k1p["gx"], k1p["gy"] * k1p["gz"]
    ok, lin, _ = vg.kept_cells(P0[None], M0[None], k1p)
    ix, iyz = lin[0] % gx, lin[0] // gx
    block = 512
    reset_counts()
    dets10 = centroid_pallas.circumcenter_features_table_pallas(mp, mm, 1.5)
    dets3 = centroid_pallas.circumcenter_features_table_pallas_v2(mp, mm, 1.5)
    ps = centroid_pallas.pair_stats_pallas(mp, mm, slab_rows=128)
    micro_torch_pair_stats.run(dev, reps=20, log=log)
    acc = accumulate_from_indices(P0, ix, iyz, ok[0], gx, gyz, block)
    micro_torch_acc.run(dev, reps=10, log=log)
    torch.cuda.synchronize()
    counts = read_counts()
    require("slice 5 entry points", counts,
            ("K10", "K3", "K6 keys", "K1", "K1-cm", "K1 raw", "K1-cm raw", "K1 fin", "K11"),
            report)
    m = (P0.shape[0] // block) * block
    acc6, _ = vg.accumulate_bf16x3_stacked(P0[None, :m].contiguous(), M0[None, :m], *kw)
    ps_dyn = centroid_pallas.pair_stats_pallas_dyn(mp, mm)
    eager = npy(circumcenter_from_pair_stats(*ps, mp, mm, torch.tensor(1.5, device=dev)))
    if not (equal(npy(dets10), eager) and equal(npy(dets3), eager)
            and equal(npy(acc), npy(acc6[0]))
            and all(equal(npy(a), npy(b)) for a, b in zip(ps, ps_dyn))):
        fail("slice 5 entry points: K10's or K3f's table against K3's stats and the eager "
             "selection, K6's key entry against its quantizing entry, or pair_stats_pallas "
             "against pair_stats_pallas_dyn differ")
    if not (np.isfinite(npy(dets10)).all() and int(acc[3].sum()) == int(ok[0, :m].sum())):
        fail("slice 5 entry points: non-finite detections or lost points")
    log(f"[4 slice 5] circumcenter_features_table_pallas (K10) and _v2 (K3f) C={mp.shape[0]} "
        f"P={mp.shape[1]} = K3's stats and the eager selection bit for bit; "
        f"pair_stats_pallas(slab_rows=128) = _dyn; "
        f"accumulate_from_indices N={P0.shape[0]} block={block}: {int(acc[3].sum())} points in "
        f"{int((acc[3] > 0).sum())} cells = K6's quantizing entry bit for bit; launches {counts}")


def phase_growth(dev, report):
    """Bank growth and checkpoint/resume through ``TrackerNode`` at full
    headline width: a two-slot bank over 12 headline frames overflows and
    grows, held against the JAX growth golden; a checkpoint of the state
    after frame 5 resumes (at the grown K = 4) bit for bit, and padded to
    256 slots (K4 past the TPU kernel's 128) within the golden's
    tolerances."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.checkpoint import load_state, save_state
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import grow_bank

    golden = dict(np.load(GOLDEN_GROWTH))
    n_fr, k_save = golden["publish"].shape[0], 6
    cfg, _, sc = bench_cases.growth_case(device=dev)
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "ckpt.npz")

    def fresh():
        node = TrackerNode(cfg, dev, keep_outputs=True)
        node.on_map(load_sim_grid())
        return node

    def outputs(node, lo=0):
        return {f: np.stack([getattr(o, f) for o in node.outputs[lo:]])
                for f in node.outputs[0]._fields}

    node = fresh()
    reset_counts()
    growths, ks = [], []
    for k in range(n_fr):
        if k == k_save:
            save_state(path, node.state, extra=node.checkpoint_extra())
        node.on_pointcloud(sc.frame(k))
        growths.append(node.n_growths)
        ks.append(node.config.caps.k_max_tracks)
    torch.cuda.synchronize()
    counts = read_counts()
    require("growth TrackerNode", counts, FAST_PATH, report)
    if not any(st.overflow > 0 for st in node.stats) or node.n_growths < 1:
        fail(f"growth: no overflow or no growth (n_growths {node.n_growths})")
    got = outputs(node) | {"n_growths": np.asarray(growths), "k_max_tracks": np.asarray(ks)}
    e = compare("growth TrackerNode vs JAX growth golden", got, golden, TOL_DETS, TOL_VEL)
    log(f"[4 growth] TrackerNode k_max_tracks=2 x{n_fr} headline frames: overflow "
        f"{[st.overflow for st in node.stats]}, n_growths {node.n_growths}, K {ks[-1]}, n_alive "
        f"{got['n_alive'].tolist()}, launches {counts}; vs JAX growth golden max abs err {e}")

    node2 = fresh()
    node2.resume(*load_state(path, dev))
    k_resumed = node2.config.caps.k_max_tracks
    for k in range(k_save, n_fr):
        node2.on_pointcloud(sc.frame(k))
    torch.cuda.synchronize()
    e = compare("resumed node vs the uninterrupted one", outputs(node2), outputs(node, k_save),
                0.0, 0.0)
    if k_resumed != ks[k_save - 1]:
        fail(f"resume: K {k_resumed}, the checkpoint's bank {ks[k_save - 1]}")
    state, meta = load_state(path, dev)
    save_state(path, grow_bank(state, 256), extra=meta)
    node3 = fresh()
    node3.resume(*load_state(path, dev))
    reset_counts()
    for k in range(k_save, n_fr):
        node3.on_pointcloud(sc.frame(k))
    torch.cuda.synchronize()
    counts = read_counts()
    require("grown checkpoint", counts, FAST_PATH, report)
    if node3.config.caps.k_max_tracks != 256:
        fail(f"grown checkpoint: K {node3.config.caps.k_max_tracks}, not the padded 256")
    report["K4 wide"]["launches"] = counts["K4"]     # every one of them at K = 256
    ref = {f: v[k_save:] for f, v in golden.items() if f not in ("n_growths", "k_max_tracks")}
    e3 = compare("256-slot resume vs JAX growth golden", outputs(node3), ref, TOL_DETS, TOL_VEL)
    log(f"[4 growth] save after frame {k_save - 1} -> load_state -> resume at K={k_resumed}: "
        f"frames {k_save}-{n_fr - 1} bit for bit the uninterrupted node's ({e}); the checkpoint "
        f"padded to K={node3.config.caps.k_max_tracks}: launches {counts}, vs JAX golden max abs "
        f"err {e3}")


# ---------------------------------------------------------------------------
# phase 5: timings
# ---------------------------------------------------------------------------
def time_path(tracker, env, P, M, T, reps: int = 3):
    """(ms/frame of bind_env one frame per call, of bind_env_multi S = 8)
    over the frames P, M, T, by CUDA events, ``reps`` repeats after a
    warm-up."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    step = tracker.bind_env(env)
    multi = tracker.bind_env_multi(env)
    n_fr = P.shape[0]

    def run_single():
        st = tracker.init_state()
        for k in range(n_fr):
            st, _ = step(st, Frame(P[k], M[k], T[k]))

    def run_multi():
        st = tracker.init_state()
        for d in range(n_fr // 8):
            sl = slice(d * 8, (d + 1) * 8)
            st, _ = multi(st, Frame(P[sl], M[sl], T[sl]))

    return cuda_ms(run_single, reps) / n_fr, cuda_ms(run_multi, reps) / n_fr


def trace_counts(fn, n_frames: int) -> tuple[float, float]:
    """(device operations -- kernels, copies, memsets -- per frame, host
    syncs per frame) of fn, from a torch.profiler trace of one run after a
    warm-up, between marker kernels (``micro_torch_digits.whole_trace``).
    A host sync is a read of a device value on the host (``.item()``,
    ``int()``, ``bool()`` of a CUDA tensor): one ``aten::_local_scalar_dense``
    each; the Python stack of the first is logged."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_digits

    fn()
    torch.cuda.synchronize()
    evs, ops, _ = micro_torch_digits.whole_trace(fn, with_stack=True)
    syncs = [ev for ev in evs if ev.name == "aten::_local_scalar_dense"]
    if syncs:
        log(f"[5 timing]   first host sync of {len(syncs)}: "
            f"{' <- '.join(str(f) for f in (syncs[0].stack or [])[:6])}")
    return len(ops) / n_frames, len(syncs) / n_frames


def device_ops_per_frame(fn, n_frames: int) -> float:
    return trace_counts(fn, n_frames)[0]


def phase_timings_pointlist(dev, smi, P, M, T):
    """bind_env and bind_env_multi of the point-list paths: C on the 32
    headline frames (3 repeats), D, E, F and G on 16 (2 repeats); the host
    syncs per frame of each entry point, and C's device ops per frame."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    paths = (("C pointlist", bench_cases.pointlist_case, 32),
             ("D pointlist jnp", bench_cases.pointlist_jnp_case, 16),
             ("E scan", bench_cases.scan_case, 16),
             ("F runs", bench_cases.pointlist_runs_case, 16),
             ("G defaults", bench_cases.default_case, 16))
    for tag, case, n_fr in paths:
        cfg, env, sc = case(device=dev)
        if cfg.caps.n_max_points == P.shape[1]:
            Pc, Mc, Tc = P[:n_fr], M[:n_fr], T[:n_fr]
        else:
            pts, mask, ts = headline_frames(sc, cfg.caps.n_max_points, range(n_fr))
            Pc, Mc, Tc = (torch.from_numpy(a).to(dev) for a in (pts, mask, ts))
        tracker = Tracker(cfg, dev)
        ms_single, ms_multi = time_path(tracker, env, Pc, Mc, Tc, reps=3 if n_fr == 32 else 2)
        step, multi = tracker.bind_env(env), tracker.bind_env_multi(env)

        def one():
            st = tracker.init_state()
            for k in range(8):
                st, _ = step(st, Frame(Pc[k], Mc[k], Tc[k]))

        def eight():
            multi(tracker.init_state(), Frame(Pc[:8], Mc[:8], Tc[:8]))

        (ops1, sync1), (ops8, sync8) = trace_counts(one, 8), trace_counts(eight, 8)
        extra = (f"; host syncs per frame bind_env {sync1:.3f}, bind_env_multi {sync8:.3f}; "
                 f"device ops per frame bind_env {ops1:.2f}, bind_env_multi {ops8:.2f}")
        log(f"[5 timing] {smi}: {tag} bind_env {ms_single:.4f} ms/frame "
            f"({1e3 / ms_single:.1f} clouds/s); bind_env_multi S=8 {ms_multi:.4f} ms/frame "
            f"({1e3 / ms_multi:.1f} clouds/s){extra}")


def phase_timings(dev, cfg, smi, tracker, env, frames, report):
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        assign_cuda, centroid_cuda, cluster_pallas, grid_cuda, segsum_cuda, track_cuda,
        transpose_cuda, voxel_grid_cuda)
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    P, M, T = frames
    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    caps = cfg.caps

    # end to end: bind_env one frame per call; bind_env_multi S = 8
    ms_single, ms_multi = time_path(tracker, env, P, M, T)
    step, multi = tracker.bind_env(env), tracker.bind_env_multi(env)

    def one():
        st = tracker.init_state()
        for k in range(8):
            st, _ = step(st, Frame(P[k], M[k], T[k]))

    def eight():
        multi(tracker.init_state(), Frame(P[:8], M[:8], T[:8]))

    (ops1, sync1), (ops8, sync8) = trace_counts(one, 8), trace_counts(eight, 8)
    log(f"[5 timing] {smi}: headline bind_env {ms_single:.4f} ms/frame "
        f"({1e3 / ms_single:.1f} clouds/s); bind_env_multi S=8 {ms_multi:.4f} ms/frame "
        f"({1e3 / ms_multi:.1f} clouds/s); host syncs per frame bind_env {sync1:.3f}, "
        f"bind_env_multi {sync8:.3f}; device ops per frame bind_env {ops1:.2f}, "
        f"bind_env_multi {ops8:.2f}")
    if sync1 or sync8:
        fail(f"headline host syncs per frame: bind_env {sync1}, bind_env_multi {sync8} (0 expected)")
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    for tag, case in (("A exact", bench_cases.exact_case), ("B runs", bench_cases.runs_case),
                      ("G-grid", bench_cases.default_grid_case)):
        cfg_m, env_m, sc_m = case(device=P.device)
        Pm, Mm, Tm = P, M, T
        if cfg_m.caps.n_max_points != P.shape[1]:
            Pm, Mm, Tm = (torch.from_numpy(a).to(dev) for a in
                          headline_frames(sc_m, cfg_m.caps.n_max_points, range(16)))
        tr_m = Tracker(cfg_m, P.device)
        ms_s, ms_m = time_path(tr_m, env_m, Pm, Mm, Tm, reps=3 if Pm.shape[0] == 32 else 2)
        step_m, multi_m = tr_m.bind_env(env_m), tr_m.bind_env_multi(env_m)

        def one_m():
            st = tr_m.init_state()
            for k in range(8):
                st, _ = step_m(st, Frame(Pm[k], Mm[k], Tm[k]))

        def eight_m():
            multi_m(tr_m.init_state(), Frame(Pm[:8], Mm[:8], Tm[:8]))

        (o1, s1), (o8, s8) = trace_counts(one_m, 8), trace_counts(eight_m, 8)
        extra = (f"; host syncs per frame bind_env {s1:.3f}, bind_env_multi {s8:.3f}; "
                 f"device ops per frame bind_env {o1:.2f}, bind_env_multi {o8:.2f}")
        log(f"[5 timing] {smi}: {tag} bind_env {ms_s:.4f} ms/frame ({1e3 / ms_s:.1f} "
            f"clouds/s); bind_env_multi S=8 {ms_m:.4f} ms/frame ({1e3 / ms_m:.1f} clouds/s)"
            f"{extra}")
    phase_timings_pointlist(dev, smi, P, M, T)

    # K1 and K5 per call at the headline, the CLI's and the default scene's
    # grids: one device operation each, fused or raw (the trace may drop an
    # event, never add one: more than one per call fails)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_digits

    for (shape, name), (_, ops, _, _, _) in micro_torch_digits.run(dev, 20, log).items():
        if ops > 1.0:
            fail(f"{name} at {shape}: {ops} device operations per call (1 expected)")
    # K8, K8a and K7 per call on C's and G's point lists and the headline's
    # sorted rows (K7 also through the sort's permutation): one device
    # operation each
    import micro_torch_cc_segsum

    for (name, shape), (_, ops, _) in micro_torch_cc_segsum.run(dev, 20, log).items():
        if ops > 1.0:
            fail(f"{name} at {shape}: {ops} device operations per call (1 expected)")

    # kernels vs plain versions, at the main path's shapes
    kw1 = (cfg.scene, leaf, leaf_z)
    acc, _ = voxel_grid_cuda.accumulate_fast_stacked(P[:8].contiguous(), M[:8], *kw1)
    plan = tracker.plan(env)
    kw2 = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=leaf, leaf_z=leaf_z,
               kwin=plan.table.k)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    outs = grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2)
    ctab = cluster_table_grid(outs[2], outs[3], outs[0], outs[1], plan.dims[0],
                              cfg.min_cluster_size, cfg.max_cluster_size,
                              caps.c_max_clusters, caps.p_max_cluster)
    mp, mm = ctab.mpts[3].contiguous(), ctab.member_mask[3].contiguous()
    mp8 = ctab.mpts.reshape(-1, caps.p_max_cluster, 3).contiguous()
    mm8 = ctab.member_mask.reshape(-1, caps.p_max_cluster).contiguous()
    T8 = T[:8].contiguous()
    K, D = caps.k_max_tracks, caps.c_max_clusters
    g = np.random.default_rng(5)
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene

    gains = tracker.gains_xy
    t4 = track_scene(5, cfg, K, D, 1, 1, (), P.device)
    t4w = track_scene(6, cfg, 1024, 128, 1, 1, (), P.device)
    kwt = dict(config=cfg, gains_xy=gains)
    kwi = dict(config=cfg.replace(position_filter="ihgp"), gains_xy=gains)

    def k4_ops(ins, out, ihgp=False):
        """The scan's per-lane work over the valid detections, then the
        window update and filter of each updated track (under ihgp also
        the position smoother's 14 operations per window row)."""
        k, n_det, n_upd = ins[0].bank.alive.shape[1], int(ins[2].sum()), int(out[1].valid.sum())
        return 12 * k * n_det + (20 + 14 * ihgp) * cfg.data_length * n_upd
    af0 = torch.from_numpy(g.uniform(-2, 2, (K, 3)).astype(np.float32)).to(dev)
    ai0 = torch.stack([(torch.arange(K) % 2).int(), torch.arange(K).int(),
                       torch.arange(K).int()], 1).int().to(dev)
    dets = torch.from_numpy(g.uniform(-2, 2, (D, 4)).astype(np.float32)).to(dev)
    dv = torch.zeros(D, dtype=torch.bool, device=dev)
    dv[:4] = True
    a4 = (af0, ai0, dets, dv, torch.tensor(True, device=dev),
          torch.tensor(64, dtype=torch.int32, device=dev),
          torch.tensor(64, dtype=torch.int32, device=dev))
    kw4 = dict(thr=cfg.id_threshold, dt_gp=cfg.dt_gp, interp_gap_factor=cfg.interp_gap_factor)
    offsets = grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance, leaf, leaf_z)
    ks, vals = sorted_rows(P[:8], M[:8], cfg)
    v4 = torch.stack(vals + [torch.ones_like(vals[0])], dim=-1).contiguous()
    _, perm8, v3 = sorted_perm(P[:8], M[:8], cfg)
    chans = [v3[..., c] for c in range(3)]
    P1, M1 = P[:8, :100_000].contiguous(), M[:8, :100_000].contiguous()
    pcfg = bench_cases.pointlist_case()[0]
    cpts, cmsk = pointlist_rows(dev, pcfg, P[:8].contiguous(), M[:8])
    tol, sweeps = pcfg.cluster_tolerance, 8 * pcfg.caps.label_prop_iters
    P8, M8 = P[:8].contiguous(), M[:8].contiguous()
    vg = voxel_grid_cuda
    raw1, _ = vg.accumulate_fast_stacked_raw(P8, M8, *kw1)
    raw5, _ = vg.accumulate_exact_stacked_raw(P8, M8, *kw1)
    Pcm8 = P8.transpose(1, 2).contiguous()

    # what the data needs, for the bounds: kept points, cells, K2's
    # iterations, K3's members, K8's valid rows and sweeps
    k1p = vg.kernel_params(*kw1)
    s8, nc = P8.shape[0], k1p["n_cells"]
    ok, lin, _ = vg.kept_cells(P8, M8, k1p)
    kept = int(ok.sum())
    kept1 = int(vg.kept_cells(P1, M1, k1p)[0].sum())
    gx, gyz = k1p["gx"], k1p["gy"] * k1p["gz"]
    ix8, iyz8 = (lin % gx).to(torch.int32), (lin // gx).to(torch.int32)
    n_off, iters = len(offsets), int(outs[3].sum())
    # configuration G's grid for K6f: 8 frames of 131,072 points
    gcfg, _, gsc = bench_cases.default_case()
    gp, gm, _ = headline_frames(gsc, gcfg.caps.n_max_points, range(8))
    GP8, GM8 = torch.from_numpy(gp).to(dev), torch.from_numpy(gm).to(dev)
    gkw = (gcfg.scene, gcfg.voxel_leaf_size, gcfg.leaf_z)
    gk = vg.kernel_params(*gkw)
    g_ok, g_lin, _ = vg.kept_cells(GP8, GM8, gk)
    g_kept, g_nc = int(g_ok.sum()), gk["n_cells"]
    g_frame = torch.arange(8, device=dev)[:, None]
    g_tgt = torch.where(g_ok, g_frame * g_nc + g_lin, 8 * g_nc).reshape(-1)
    g_vals4 = torch.cat([torch.where(g_ok[..., None], GP8, 0.0), g_ok[..., None].float()],
                        -1).reshape(-1, 4)
    g_base = torch.zeros((8 * g_nc + 1, 4), dtype=torch.float32, device=dev)
    _, k8_sweeps = cluster_pallas.connected_components_pallas(cpts, cmsk, tol, sweeps,
                                                              with_sweeps=True)
    v8 = cmsk.sum(dim=1).to(torch.float64)
    # the library calls: one PyTorch call computing the same function
    frame_of = torch.arange(s8, device=dev)[:, None]
    tgt = torch.where(ok, frame_of * nc + lin, s8 * nc).reshape(-1)
    vals4 = torch.cat([torch.where(ok[..., None], P8, 0.0), ok[..., None].float()], -1).reshape(-1, 4)
    base = torch.zeros((s8 * nc + 1, 4), dtype=torch.float32, device=dev)
    runs = torch.unique_consecutive((frame_of * (nc + 1) + ks).reshape(-1), return_counts=True)[1]
    idx1, dig1, tab1 = micro_torch_digits.digit_rows(vg, P8, M8, kw1, "fast")
    idx5, dig5, tab5 = micro_torch_digits.digit_rows(vg, P8, M8, kw1, "exact")
    lib1 = lambda: tab1.index_add_(0, idx1, dig1)  # noqa: E731
    lib5 = lambda: tab5.index_add_(0, idx5, dig5)  # noqa: E731
    rows3 = torch.stack(vals, dim=-1).reshape(-1, 3)
    rows4 = v4.reshape(-1, 4)
    pairs = {  # name: (kernel, plain, shape, inputs, operations, library call or None)
        "K1": (lambda: vg.accumulate_fast_stacked(P8, M8, *kw1),
               lambda: vg.accumulate_fast_stacked_plain(P8, M8, *kw1),
               "S=8 frames x 106496 points", (P8, M8), 35 * kept + 12 * s8 * nc, lib1),
        "K1 raw": (lambda: vg.accumulate_fast_stacked_raw(P8, M8, *kw1),
                   lambda: (vg.fast_digit_sums(P8, M8, *kw1), (M8 != 0).sum(1).int()),
                   "S=8 frames x 106496 points", (P8, M8), 35 * kept, lib1),
        "K1 fin": (lambda: vg.finalize_fast_stacked(raw1, *kw1),
                   lambda: vg.finalize_fast_digits(raw1, k1p),
                   "S=8 frames x 5500 cells", (raw1,), 12 * s8 * nc, None),
        "K2": (lambda: grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2),
               lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(
                   acc, *tb, dims=plan.dims, offsets=offsets, kwin=plan.table.k,
                   max_sweeps=2 * sum(plan.dims)),
               "S=8 frames x 5500 cells", (acc,) + tb,
               s8 * nc * (15 + 9 * n_off) + iters * nc * (2 * n_off + 1), None),
        "K3": (lambda: centroid_cuda.pair_stats(mp, mm),
               lambda: centroid_cuda.pair_stats_plain(mp, mm),
               f"C=32 P=384, {int(mm.any(1).sum())} active slots", (mp, mm),
               scan_ops(mm, False), None),
        "K4": (lambda: track_cuda.track_frames(*t4, **kwt),
               lambda: track_cuda.track_frames_plain(*t4, **kwt),
               f"K={K} 1 x 1 frame, D={D}, {int(t4[2].sum())} valid detections", t4,
               k4_ops(t4, track_cuda.track_frames(*t4, **kwt)), None),
        "K4 ihgp": (lambda: track_cuda.track_frames(*t4, **kwi),
                    lambda: track_cuda.track_frames_plain(*t4, **kwi),
                    f"K={K} 1 x 1 frame, D={D}, {int(t4[2].sum())} valid detections, ihgp", t4,
                    k4_ops(t4, track_cuda.track_frames(*t4, **kwi), True), None),
        "K4 wide": (lambda: track_cuda.track_frames(*t4w, **kwt),
                    lambda: track_cuda.track_frames_plain(*t4w, **kwt),
                    f"K=1024 1 x 1 frame, D=128, {int(t4w[2].sum())} valid detections", t4w,
                    k4_ops(t4w, track_cuda.track_frames(*t4w, **kwt)), None),
        "K4 scan": (lambda: assign_cuda.assoc_scan(*a4, **kw4),
                    lambda: assign_cuda.assoc_scan_plain(*a4, **kw4),
                    "K=64 D=32, 4 valid detections", a4, 12 * K * 4, None),
        "K3f": (lambda: centroid_cuda.circumcenter_features(mp8, mm8, T8),
                lambda: centroid_cuda.circumcenter_features_plain(mp8, mm8, T8),
                f"S=8 x C=32 P=384 stacked, {int(mm8.any(1).sum())} active slots", (mp8, mm8, T8),
                scan_ops(mm8, True), None),
        "K10": (lambda: centroid_cuda.circumcenter_xy(mp, mm),
                lambda: centroid_cuda.circumcenter_xy_plain(mp, mm),
                f"C=32 P=384, {int(mm.any(1).sum())} active slots", (mp, mm),
                scan_ops(mm, True), None),
        "K1-cm": (lambda: vg.accumulate_fast_stacked_cm(Pcm8, M8, *kw1),
                  lambda: vg.accumulate_fast_stacked_cm_plain(Pcm8, M8, *kw1),
                  "S=8 frames x 106496 points, (S, 3, N)", (Pcm8, M8),
                  35 * kept + 12 * s8 * nc, None),
        "K1-cm raw": (lambda: vg.accumulate_fast_stacked_cm_raw(Pcm8, M8, *kw1),
                      lambda: (vg.fast_digit_sums(P8, M8, *kw1), (M8 != 0).sum(1).int()),
                      "S=8 frames x 106496 points, (S, 3, N)", (Pcm8, M8), 35 * kept, None),
        "K11": (lambda: transpose_cuda.transpose_words(P8),
                lambda: transpose_cuda.transpose_words_plain(P8),
                "S=8 frames x 106496 points, (S, N, 3) -> (S, 3, N)", (P8,), 0,
                lambda: torch.permute(P8, (0, 2, 1)).contiguous()),
        "K6 keys": (lambda: vg.accumulate_bf16x3_keys(P8, ix8, iyz8, ok, gx, gyz),
                    lambda: vg.accumulate_bf16x3_keys_plain(P8, ix8, iyz8, ok, gx, gyz),
                    "S=8 frames x 106496 points, keys given", (P8, ix8, iyz8, ok), 50 * kept,
                    None),
        "K5": (lambda: vg.accumulate_exact_stacked(P8, M8, *kw1),
               lambda: vg.accumulate_exact_stacked_plain(P8, M8, *kw1),
               "S=8 frames x 106496 points", (P8, M8), 45 * kept + 18 * s8 * nc, lib5),
        "K5 raw": (lambda: vg.accumulate_exact_stacked_raw(P8, M8, *kw1),
                   lambda: (vg.exact_digit_sums(P8, M8, *kw1), (M8 != 0).sum(1).int()),
                   "S=8 frames x 106496 points", (P8, M8), 45 * kept, lib5),
        "K5 fin": (lambda: vg.finalize_exact_stacked(raw5, *kw1),
                   lambda: vg.finalize_exact_digits(raw5, *kw1),
                   "S=8 frames x 5500 cells", (raw5,), 18 * s8 * nc, None),
        "K6": (lambda: vg.accumulate_bf16x3_stacked(P1, M1, *kw1),
               lambda: vg.accumulate_bf16x3_stacked_plain(P1, M1, *kw1),
               "S=8 frames x 100000 points", (P1, M1), 50 * kept1, None),
        "K6f": (lambda: vg.accumulate_f32_stacked(P8, M8, *kw1),
                lambda: vg.accumulate_f32_stacked_plain(P8, M8, *kw1),
                "S=8 frames x 106496 points", (P8, M8), 20 * kept,
                lambda: torch.index_add(base, 0, tgt, vals4)),
        "K6f G": (lambda: vg.accumulate_f32_stacked(GP8, GM8, *gkw),
                  lambda: vg.accumulate_f32_stacked_plain(GP8, GM8, *gkw),
                  f"S=8 frames x {GP8.shape[1]} points at G's grid ({g_nc} cells)", (GP8, GM8),
                  20 * g_kept, lambda: torch.index_add(g_base, 0, g_tgt, g_vals4)),
        "K7": (lambda: segsum_cuda.segment_totals(ks, *chans, perm=perm8),
               lambda: segsum_cuda.segment_totals_plain(ks, *chans, perm=perm8),
               "S=8 frames x 106496 sorted rows, read through the sort's permutation",
               (ks, perm8, v3), 6 * ks.numel(),
               lambda: torch.segment_reduce(rows3, "sum", lengths=runs, axis=0)),
        "K8": (lambda: cluster_pallas.connected_components_pallas(cpts, cmsk, tol, sweeps),
               lambda: cluster_pallas.connected_components_pallas_plain(cpts, cmsk, tol, sweeps),
               f"S=8 frames x M={cpts.shape[1]} point lists ({int(cmsk.sum())} valid rows)",
               (cpts, cmsk), int(((9 + k8_sweeps) * v8 * v8).sum()), None),
        "K8a": (lambda: cluster_pallas.cc_adjacency(cpts, cmsk, tol),
                lambda: cluster_pallas.cc_adjacency_plain(cpts, cmsk, tol),
                f"S=8 frames x M={cpts.shape[1]} point lists, bool (M, M) out",
                (cpts, cmsk), int((9 * v8 * v8).sum()), None),
        "K9": (lambda: segsum_cuda.segment_totals_rows(ks, v4),
               lambda: segsum_cuda.segment_totals_rows_plain(ks, v4),
               "S=8 frames x 106496 sorted rows x 4 channels", (ks, v4), 8 * ks.numel(),
               lambda: torch.segment_reduce(rows4, "sum", lengths=runs, axis=0)),
    }
    # K3, K10 and K3f read only the members' rows (and K10 / K3f row 0 of a
    # slot without members, their fallback), the mask and t
    scan_bytes = {
        "K3": lambda: scan_bytes_read(mm, False) + nbytes(centroid_cuda.pair_stats(mp, mm)),
        "K10": lambda: scan_bytes_read(mm, True) + nbytes(centroid_cuda.circumcenter_xy(mp, mm)),
        "K3f": lambda: (scan_bytes_read(mm8, True) + nbytes(T8)
                        + nbytes(centroid_cuda.circumcenter_features(mp8, mm8, T8))),
    }
    for name, (fk, fp, shape, ins, ops, lib) in pairs.items():
        reps_p = 2 if name in ("K6", "K6f", "K6 keys", "K6f G") else 5
        ms_p = cuda_ms(fp, reps_p)
        ms_k = cuda_ms(fk, 50)
        ms_k2 = cuda_ms(fk, 50)
        ms_p2 = cuda_ms(fp, reps_p)
        moved = scan_bytes[name]() if name in scan_bytes else nbytes(ins) + nbytes(fk())
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        entry = report[name]
        entry["ms"] = min(ms_k, ms_k2)
        entry["plain_ms"] = min(ms_p, ms_p2)
        entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        entry["library_ms"] = cuda_ms(lib, 20) if lib is not None else None
        log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, "
            f"plain {ms_p:.4f}/{ms_p2:.4f} ms (run plain, kernel, kernel, plain; "
            f"min reported); bound {entry['bound_ms']:.4f} ms by {entry['bound_by']} "
            f"({moved} bytes, {ops} operations); library call "
            f"{'none' if lib is None else format(entry['library_ms'], '.4f') + ' ms'}")
        if name in DEVICE_TIMED:
            d_k, o_k = micro_torch_digits.device_profile(fk, 20)
            d_l, o_l = micro_torch_digits.device_profile(lib, 20)
            log(f"[5 timing] {smi}: {name} {shape}: device {d_k:.2f} us/call in {o_k:.1f} ops; "
                f"library call {d_l:.2f} us/call in {o_l:.1f} ops (torch.profiler)")
    return ms_single, ms_multi


def scan_ops(mm, line_scan: bool) -> int:
    """Operations K3's scan needs on a member mask (C, P): 9 per member
    pair i < j (the gram's 3 products and 2 sums, d2's 3 terms, the
    compare), 11 per member (the mean's sum, the centring, |p|^2); with
    ``line_scan`` (K10, K3f) 12 more per member for the line distance and
    the equality tests."""
    n = mm.sum(dim=1).to(torch.float64)
    return int((9 * n * (n - 1) / 2 + (23 if line_scan else 11) * n).sum())


def scan_bytes_read(mm, fallback_row: bool) -> int:
    """Bytes K3's scan must read from a member table: the members' rows
    (12 bytes each), the mask, and with ``fallback_row`` row 0 of each slot
    without members."""
    rows = int(mm.sum()) + (int((mm.sum(dim=1) == 0).sum()) if fallback_row else 0)
    return 12 * rows + nbytes(mm)


def nbytes(x) -> int:
    """Bytes of the tensors in x (a tensor or nested tuples of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(nbytes(y) for y in x)
    return 0


def phase_timings_fleet(dev, smi, fleet, env, frames):
    """The kernel fleet (B = 8 streams x 3 steps) beside bind_env_multi
    (the same 24 clouds as 3 dispatches of S = 8), in turns (multi, fleet,
    fleet, multi): ms per cloud, clouds/s and device ops per cloud."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    P, M, T = frames
    n_steps, b = P.shape[0], P.shape[1]
    n_clouds = n_steps * b
    step = fleet.bind_env(env)
    tracker = fleet.tracker
    multi = tracker.bind_env_multi(env)
    Pm, Mm, Tm = (a.reshape((n_clouds,) + a.shape[2:]) for a in (P, M, T))

    def run_fleet():
        st = fleet.init_state(b)
        for k in range(n_steps):
            st, _ = step(st, P[k], M[k], T[k])

    def run_multi():
        st = tracker.init_state()
        for d in range(n_clouds // 8):
            sl = slice(8 * d, 8 * d + 8)
            st, _ = multi(st, Frame(Pm[sl], Mm[sl], Tm[sl]))

    m1 = cuda_ms(run_multi, 3) / n_clouds
    f1 = cuda_ms(run_fleet, 3) / n_clouds
    f2 = cuda_ms(run_fleet, 3) / n_clouds
    m2 = cuda_ms(run_multi, 3) / n_clouds
    ops_f = device_ops_per_frame(run_fleet, n_clouds)
    ops_m = device_ops_per_frame(run_multi, n_clouds)
    log(f"[5 timing] {smi}: fleet B={b} x {n_steps} steps {f1:.4f}/{f2:.4f} ms/cloud "
        f"({1e3 / min(f1, f2):.1f} clouds/s), device ops per cloud {ops_f:.2f}; beside it "
        f"bind_env_multi S=8 {m1:.4f}/{m2:.4f} ms/cloud ({1e3 / min(m1, m2):.1f} clouds/s), "
        f"device ops per cloud {ops_m:.2f} (run multi, fleet, fleet, multi)")


# ---------------------------------------------------------------------------
# K4 under position_filter="ihgp"; F7 (the point-list CC's row bounds)
# ---------------------------------------------------------------------------
def one_op_profile(fn, reps: int):
    """(device us per recorded launch, device ops recorded per call, whole)
    of a one-launch call over ``reps`` calls after a warm-up, from a
    torch.profiler trace between marker kernels
    (``micro_torch_digits.whole_trace``: a trace that lost events at an end
    is taken again, up to three times).  The time is the mean over the
    launches recorded (NaN if none)."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_digits

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    _, evs, whole = micro_torch_digits.whole_trace(run)
    us = sum(e.time_range.elapsed_us() for e in evs)
    return (us / len(evs) if evs else float("nan")), len(evs) / reps, whole


def require_one_op(tag: str, ops: float, whole: bool) -> None:
    """Fail a reading of ``one_op_profile`` other than one device op per
    call; a trace still not whole after its tries can only under-read, so
    it fails above one op or with no launch recorded."""
    if ops != 1 if whole else not 0 < ops <= 1:
        fail(f"{tag}: {ops} device ops recorded per call (1 expected; whole trace: {whole})")


def f7_points(rng, s, m, n_blobs=40):
    """(S, M, 3) f32 points in n_blobs blobs (each a cluster at the
    headline's tolerance) and a 90%-valid (S, M) mask."""
    centres = rng.uniform(-8, 8, (s, n_blobs, 3)) * np.array([1, 1, 0.1])
    which = rng.integers(0, n_blobs, (s, m))
    pts = np.take_along_axis(centres, which[..., None], 1) + rng.normal(0, 0.05, (s, m, 3))
    return pts.astype(np.float32), rng.random((s, m)) < 0.9


def phase_kernels_slice11(dev, smi, report, cfg):
    """K4 under ``position_filter="ihgp"`` against its plain version, bit for
    bit, at K = 64 (the 128-thread build) and 1,024 (the 1,024-thread
    build), 1 x 1, 1 x S and B x 1, on ``track_scene``'s duplicates, gaps
    and overflow; then F7: K8a at a ragged M = 1,000 (the jnp CC's
    adjacency, which takes any M) against its plain version and the jnp CC
    through it against the CPU, K8 at M = 1,000 refusing as the JAX Pallas
    wrapper does, and K8 and K8a past ``MAX_ROWS`` (M = 8,448, the frame in
    device memory) against their plain versions and, through both CC
    backends, against the CPU."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster, cluster_pallas, track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    icfg = cfg.replace(position_filter="ihgp")
    gains = Tracker(icfg, dev).gains_xy
    D = cfg.caps.c_max_clusters
    check_track(dev, icfg, gains, cfg.caps.k_max_tracks,
                ((1, 1, D, ()), (1, 8, D, (0,)), (8, 1, D, (0,)), (1, 8, 128, ())),
                report, "K4 ihgp")
    check_track(dev, icfg, gains, 1024, ((1, 1, 128, ()), (1, 8, 128, (0,)), (8, 1, D, ())),
                report, "K4 ihgp")
    st, dets, valid, t = track_scene(11, cfg, 64, D, 1, 8, (), dev)
    o_l = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)[1]
    o_i = track_cuda.track_frames(st, dets, valid, t, config=icfg, gains_xy=gains)[1]
    v = npy(o_i.valid)
    moved = max_err(npy(o_l.pos)[v], npy(o_i.pos)[v])
    same_ids = equal(npy(o_l.obj_id), npy(o_i.obj_id))
    log(f"[3 K4 ihgp] 1 x 8 frames K=64: ihgp positions against LPF's max |diff| {moved} m, "
        f"decisions {'equal' if same_ids else 'differ'}")
    if not moved > 0 or not same_ids:
        fail("K4 under ihgp: positions equal to LPF's, or decisions changed")

    pcfg = bench_cases.pointlist_case()[0]
    tol, caps = pcfg.cluster_tolerance, pcfg.caps
    rng = np.random.default_rng(1107)
    pts, mask = f7_points(rng, 2, 1000)
    P, Mk = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    check_pair(report, "K8a", "S=2 M=1000 (no multiple of 256: the jnp CC's adjacency, F7)",
               lambda: (cluster_pallas.cc_adjacency(P, Mk, tol),),
               lambda: (cluster_pallas.cc_adjacency_plain(P, Mk, tol),))
    reset_counts()
    lab, it = cluster.connected_components(P, Mk, tol, caps.label_prop_iters, caps.pointer_jumps)
    torch.cuda.synchronize()
    counts = read_counts()
    lab_c, it_c = cluster.connected_components(P.cpu(), Mk.cpu(), tol, caps.label_prop_iters,
                                               caps.pointer_jumps)
    ok = equal(npy(lab), lab_c.numpy()) and equal(npy(it), it_c.numpy())
    n_comp = [len(np.unique(npy(lab)[f][mask[f]])) for f in range(2)]
    log(f"[3 F7] jnp CC on the card at M=1000 through K8a ({counts['K8a']} launch): labels and "
        f"sweeps equal the CPU's={ok}, components {n_comp}, sweeps {npy(it).tolist()}")
    if not ok or counts["K8a"] != 1:
        fail(f"F7: the jnp CC at M=1000 on the card (counts {counts}, equal {ok})")
    try:
        cluster_pallas.connected_components_pallas(P, Mk, tol)
    except ValueError as e:
        log(f"[3 F7] K8 at M=1000 raises, as the JAX Pallas wrapper: {e}")
    else:
        fail("F7: K8 at M=1000 ran (the JAX Pallas rule: M % 256 == 0 past 256)")

    m = cluster_pallas.MAX_ROWS + 256
    pts, mask = f7_points(rng, 1, m)
    P, Mk = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    layout = cluster_pallas._layout(m, None, dev)
    if layout[1] or not layout[2]:
        fail(f"F7: the layout at M={m} keeps the frame in shared memory: {layout}")
    sweeps = 8 * caps.label_prop_iters
    check_pair(report, "K8", f"S=1 M={m} past MAX_ROWS (F7: {layout[0]} CTAs, the frame, "
               "adjacency words and labels in device memory)",
               lambda: (cluster_pallas.connected_components_pallas(P, Mk, tol, sweeps),),
               lambda: (cluster_pallas.connected_components_pallas_plain(P, Mk, tol, sweeps),))
    check_pair(report, "K8a", f"S=1 M={m} past MAX_ROWS (F7: the frame in device memory)",
               lambda: (cluster_pallas.cc_adjacency(P, Mk, tol),),
               lambda: (cluster_pallas.cc_adjacency_plain(P, Mk, tol),))

    # the frame in device memory beside the frame in shared memory (M =
    # 8,192, the words in device memory): device us and ops per call, S = 1
    P0, M0 = P[:, :cluster_pallas.MAX_ROWS].contiguous(), Mk[:, :cluster_pallas.MAX_ROWS].contiguous()
    for kern, fn in (("K8", lambda p, k: cluster_pallas.connected_components_pallas(p, k, tol,
                                                                                    sweeps)),
                     ("K8a", lambda p, k: cluster_pallas.cc_adjacency(p, k, tol))):
        (us0, ops0, w0), (us1, ops1, w1) = (one_op_profile(lambda: fn(p, k), 20)
                                            for p, k in ((P0, M0), (P, Mk)))
        log(f"[3 F7] {smi}: {kern} S=1 device {us0:.2f} us/launch ({ops0:.2f} ops per call) "
            f"at M={cluster_pallas.MAX_ROWS} (frame in shared memory), {us1:.2f} us/launch "
            f"({ops1:.2f} ops per call) at M={m} (frame in device memory) (torch.profiler)")
        require_one_op(f"F7: {kern} at M={cluster_pallas.MAX_ROWS}", ops0, w0)
        require_one_op(f"F7: {kern} at M={m}", ops1, w1)
    ms_plain = cuda_ms(lambda: cluster_pallas.connected_components_pallas_plain(P, Mk, tol, sweeps),
                       1)
    log(f"[3 F7] {smi}: K8's plain version on the card at M={m}: {ms_plain:.3f} ms/call "
        "(CUDA events)")
    args = (tol, pcfg.min_cluster_size, pcfg.max_cluster_size, caps.c_max_clusters,
            caps.p_max_cluster, caps.label_prop_iters, caps.pointer_jumps)
    for backend, kern in (("jnp", "K8a"), ("pallas", "K8")):
        reset_counts()
        t0 = time.perf_counter()
        got = cluster.euclidean_cluster(P, Mk, *args, backend=backend)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        ref = cluster.euclidean_cluster(P.cpu(), Mk.cpu(), *args, backend=backend)
        bad = [f for f, a, b in zip(got._fields, got, ref) if not equal(npy(a), b.numpy())]
        log(f"[3 F7] {backend} CC at M={m} (past MAX_ROWS = {cluster_pallas.MAX_ROWS}) on the "
            f"card: {kern} {counts[kern]} launch(es), {int(got.n_clusters)} clusters in "
            f"{secs:.2f} s; equal to the CPU's plain route: {not bad}")
        if bad or counts[kern] != 1:
            fail(f"F7: the {backend} CC past MAX_ROWS (counts {counts}, differs in {bad})")


def cli_errors(records, golden):
    """(mismatches, max |pos / vel diff|) of the CLI's JSON records against
    a golden's: frames, stamps, ids and obstacle counts exact; positions
    and velocities within TOL_VEL plus the two records' 4-decimal rounding;
    each speed label exact, unless the golden's unrounded speed lies within
    TOL_VEL of the label's rounding boundary (a 0.005 m/s step)."""
    ref, speeds = golden["records"], golden["speeds"]
    if [r["frame"] for r in records] != [r["frame"] for r in ref]:
        return [f"frames {[r['frame'] for r in records]} vs {[r['frame'] for r in ref]}"], 0.0
    bad, err = [], 0.0
    for a, b, sp in zip(records, ref, speeds):
        k = a["frame"]
        ids_a = [o["id"] for o in a["obstacles"]]
        if a["t"] != b["t"] or ids_a != [o["id"] for o in b["obstacles"]]:
            bad.append(f"frame {k}: t / ids {a} vs {b}")
            continue
        for oa, ob in zip(a["obstacles"], b["obstacles"]):
            err = max(err, max_err(oa["pos"] + oa["vel"], ob["pos"] + ob["vel"]))
        for la, lb, v in zip(a["speed_labels"], b["speed_labels"], sp):
            frac = v * 100.0 - np.floor(v * 100.0)
            if la != lb and abs(frac - 0.5) * 0.01 >= TOL_VEL:
                bad.append(f"frame {k}: speed label {la} vs {lb} (speed {v})")
    if err > TOL_VEL + 1e-4:
        bad.append(f"pos / vel max abs err {err}")
    return bad, err


def run_cli(argv):
    """The port's CLI ``main(argv)`` in-process: (stdout, its JSON records,
    the JSON records on stderr)."""
    import contextlib
    import io

    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    if rc != 0:
        fail(f"the CLI {argv} returned {rc}")
    recs = [[json.loads(x) for x in v.getvalue().splitlines() if x.startswith("{")]
            for v in (out, err)]
    return out.getvalue(), recs[0], recs[1]


def phase_cli(dev, report):
    """The port's CLI on the card, as a user runs it: the first 16 headline
    PointCloud2 frames recorded to an npz bag and a ROS1 bag with the
    port's writers; ``run --map assets/sim_map.yaml --backend grid`` (the
    70,875-cell grid) replaying the npz bag with ``--svg`` and
    ``--checkpoint``, held to the JAX CLI's golden
    (tests/golden/torch_cli_headline.json); the ROS1 bag's replay byte for
    byte the npz bag's; a resume from the checkpoint over frames 16-19
    (the same three ids); and config files with ``position_filter: ihgp``
    and with ``association: hungarian``, each against its own golden.  Each
    run must launch K1, K2, K3f and K4 (its Hungarian build under
    hungarian, counted as "K4 hungarian"), take no plain route and make no
    host sync of K4's plain version."""
    import tempfile

    from multiple_object_tracking_lidar_tpu_torch.bench_cases import SIM_MAP, headline_case
    from multiple_object_tracking_lidar_tpu_torch.io.bag import record_bag
    from multiple_object_tracking_lidar_tpu_torch.io.rosbag import write_rosbag
    from multiple_object_tracking_lidar_tpu_torch.ops.track_cuda import track_step_plain

    _, _, sc = headline_case()
    n_fr = 16
    frames = [sc.frame(k) for k in range(n_fr)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    npz, ros = os.path.join(tmp, "frames.npz"), os.path.join(tmp, "frames.bag")
    svg, ck = os.path.join(tmp, "tracks.svg"), os.path.join(tmp, "state.npz")
    record_bag(npz, frames)
    write_rosbag(ros, frames)
    later = os.path.join(tmp, "later.npz")          # frames 16-19: the resumed run's
    record_bag(later, [sc.frame(k) for k in range(n_fr, n_fr + 4)])
    base = ["run", "--device", str(dev), "--map", SIM_MAP, "--backend", "grid", "--frames",
            str(n_fr)]
    ihgp_cfg = os.path.join(tmp, "ihgp.yaml")
    with open(ihgp_cfg, "w", encoding="utf-8") as fh:
        fh.write("position_filter: ihgp\n")
    hungarian_cfg = os.path.join(tmp, "hungarian.yaml")
    with open(hungarian_cfg, "w", encoding="utf-8") as fh:
        fh.write("association: hungarian\n")
    runs = (("lpf", GOLDEN_CLI, ["--bag", npz, "--svg", svg, "--checkpoint", ck]),
            ("ihgp", GOLDEN_CLI_IHGP, ["--bag", npz, "--config", ihgp_cfg]),
            ("hungarian", GOLDEN_CLI_HUNGARIAN, ["--bag", npz, "--config", hungarian_cfg]))
    outs = {}
    for tag, gpath, extra in runs:
        with open(gpath, encoding="utf-8") as fh:
            golden = json.load(fh)
        syncs0 = track_step_plain.host_syncs
        reset_counts()
        text, recs, err_recs = run_cli(base + extra)
        torch.cuda.synchronize()
        counts = read_counts()
        syncs = track_step_plain.host_syncs - syncs0
        bad, err = cli_errors(recs, golden)
        summary = next(r["summary"] for r in err_recs if "summary" in r)
        n_obs = sum(len(r["obstacles"]) for r in recs)
        log(f"[4 CLI {tag}] run --backend grid --bag <{n_fr} headline frames> "
            f"{' '.join(extra[2:])}: {len(recs)} records, {n_obs} obstacles, ids "
            f"{sorted({o['id'] for r in recs for o in r['obstacles']})}, launches {counts}, "
            f"K4 plain host syncs {syncs}; vs JAX CLI golden: pos/vel max abs err {err}, "
            f"mismatches {bad}")
        log(f"[4 CLI {tag}] node wall clock (stderr summary): p50 {summary['p50_ms']} ms/frame, "
            f"p99 {summary['p99_ms']} ms/frame, mean {summary['mean_ms']} over "
            f"{summary['frames']} frames (the first 3 left out)")
        if bad:
            fail(f"CLI {tag} against its golden: {bad}")
        require(f"CLI {tag}", counts, FAST_PATH, report,
                k4_report_as(tag, "hungarian" if tag == "hungarian" else "greedy"))
        if syncs:
            fail(f"CLI {tag}: {syncs} host syncs of K4's plain version (0 expected)")
        outs[tag] = (text, counts)

    with open(svg, encoding="utf-8") as fh:
        doc = fh.read()
    text_ros = run_cli(base + ["--bag", ros])[0]
    _, recs3, err3 = run_cli(base[:-1] + ["4", "--bag", later, "--checkpoint", ck])
    resumed = next((r for r in err3 if "resumed" in r), None)
    ids3 = {o["id"] for r in recs3 for o in r["obstacles"]}
    log(f"[4 CLI] SVG {len(doc)} bytes ({doc.count('<polyline')} trajectories); the ROS1 bag's "
        f"replay byte for byte the npz bag's: {text_ros == outs['lpf'][0]}; resumed {resumed} "
        f"on frames 16-19: {len(recs3)} of 4 published, ids {sorted(ids3)}")
    if not doc.startswith("<svg") or doc.count("<polyline") < 3:
        fail("CLI: the SVG holds fewer than 3 trajectories")
    if text_ros != outs["lpf"][0]:
        fail("CLI: the ROS1 bag's replay differs from the npz bag's")
    if resumed is None or resumed["alive"] != 3 or len(recs3) != 4 or ids3 != {0, 1, 2}:
        fail(f"CLI: the resume from the checkpoint ({resumed}, {len(recs3)} records, ids {ids3})")


def phase_ihgp(dev, report):
    """The headline config under ``position_filter="ihgp"`` through
    ``TrackerNode`` (12 frames, one K4 launch each), ``bind_env_multi`` (2 x
    S = 8) and the kernel fleet (B = 8 x 3 steps, bit for bit each stream's
    ``bind_env``), against the JAX golden (torch_ihgp_headline.npz)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    golden = dict(np.load(GOLDEN_IHGP))
    cfg, env, sc = bench_cases.headline_case(device=dev)
    cfg = cfg.replace(position_filter="ihgp")
    counts = {}
    got = run_node(dev, "ihgp", cfg, sc, golden, 12, FAST_PATH, report, counts)
    if counts["K4"] != 12:
        fail(f"ihgp TrackerNode: {counts['K4']} K4 launches for 12 frames (one per frame)")
    allm = run_multi(dev, "ihgp", cfg, env, sc, golden, 2, 8, FAST_PATH, report)
    e = compare("ihgp bind_env_multi vs TrackerNode", {f: v[:12] for f, v in allm.items()},
                got, 0.0, 0.0)
    lpf = dict(np.load(GOLDEN))
    v = golden["valid"]
    log(f"[4 ihgp] bind_env_multi vs TrackerNode, first 12 frames: max abs err {e}; ihgp "
        f"positions against the LPF golden's max |diff| {max_err(golden['pos'][v], lpf['pos'][v])}")
    tracker = Tracker(cfg, dev)
    frames = fleet_frames(dev, sc, cfg.caps.n_max_points, 8, 3)
    fleet = ShardedTracker(tracker, make_mesh(1, 1, device=dev), kernel_path="on")
    got_f, counts = run_fleet("kernel fleet ihgp", fleet, env, frames, FLEET_PATH, report)
    per_stream_bind_env("kernel fleet ihgp", tracker, env, frames, got_f)
    e_s0 = compare("kernel fleet ihgp stream 0 vs ihgp golden frames 0-2",
                   {f: v[:, 0] for f, v in got_f.items()},
                   {f: v[:3] for f, v in golden.items()}, TOL_DETS, TOL_VEL)
    log(f"[4 ihgp] kernel fleet B=8 x 3 steps: launches {counts}; bit for bit each stream's "
        f"bind_env; stream 0 vs ihgp golden {e_s0}")


def phase_timings_slice11(dev, smi, P, M, T):
    """The headline under ``ihgp`` beside ``lpf``, in turns (lpf, ihgp,
    ihgp, lpf), each side's range logged: ``bind_env`` and
    ``bind_env_multi`` ms/frame by CUDA events and their device ops per
    frame (torch.profiler, one trace per turn); K4's device us per call
    (torch.profiler) at 1 x 1 and 1 x 8; then ``bind_env_pipelined`` beside
    ``bind_env_multi`` in turns (multi, pipelined, pipelined, multi)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cfg, env, _ = bench_cases.headline_case(device=dev)
    trackers = {pf: Tracker(cfg.replace(position_filter=pf), dev) for pf in ("lpf", "ihgp")}
    scenes = {(pf, b, s_fr): track_scene(5, tr.config, tr.config.caps.k_max_tracks,
                                         tr.config.caps.c_max_clusters, b, s_fr, (), dev)
              for pf, tr in trackers.items() for b, s_fr in ((1, 1), (1, 8))}
    turns = ("lpf", "ihgp", "ihgp", "lpf")
    readings = {pf: [] for pf in trackers}
    for pf in turns:
        tr = trackers[pf]
        ms_s, ms_m = time_path(tr, env, P, M, T)
        step, multi = tr.bind_env(env), tr.bind_env_multi(env)

        def one():
            st = tr.init_state()
            for k in range(8):
                st, _ = step(st, Frame(P[k], M[k], T[k]))

        def eight():
            multi(tr.init_state(), Frame(P[:8], M[:8], T[:8]))

        (o1, s1), (o8, s8) = trace_counts(one, 8), trace_counts(eight, 8)
        if s1 or s8:
            fail(f"headline {pf}: host syncs per frame {s1} / {s8} (0 expected)")
        k4 = [one_op_profile(lambda: track_cuda.track_frames(*scenes[pf, b, s_fr],
                                                              config=tr.config,
                                                              gains_xy=tr.gains_xy), 50)
              for b, s_fr in ((1, 1), (1, 8))]
        for (b, s_fr), (_, ops, whole) in zip(((1, 1), (1, 8)), k4):
            require_one_op(f"K4 {pf} {b} x {s_fr}", ops, whole)
        readings[pf].append((ms_s, ms_m, o1, o8, k4[0][0], k4[1][0], k4[0][1], k4[1][1]))
        log(f"[5 timing] {smi}: headline {pf} (turn {len(readings[pf])} of 2) bind_env "
            f"{ms_s:.4f} ms/frame ({1e3 / ms_s:.1f} clouds/s); bind_env_multi S=8 {ms_m:.4f} "
            f"ms/frame ({1e3 / ms_m:.1f} clouds/s); host syncs per frame {s1:.3f} / {s8:.3f}; "
            f"device ops per frame bind_env {o1:.2f}, bind_env_multi {o8:.2f}; K4 {pf} K=64 "
            f"D=32 1 x 1 / 1 x 8: device {k4[0][0]:.2f} / {k4[1][0]:.2f} us per launch "
            f"({k4[0][1]:.2f} / {k4[1][1]:.2f} ops recorded per call) (torch.profiler)")
    names = ("bind_env ms/frame", "bind_env_multi ms/frame", "bind_env device ops/frame",
             "bind_env_multi device ops/frame", "K4 1x1 device us/launch",
             "K4 1x8 device us/launch", "K4 1x1 ops recorded/call", "K4 1x8 ops recorded/call")
    for pf, rows in readings.items():
        log(f"[5 timing] {smi}: headline {pf}, range over its 2 turns (lpf, ihgp, ihgp, lpf): "
            + "; ".join(f"{n} {min(r[i] for r in rows):.4f}-{max(r[i] for r in rows):.4f}"
                        for i, n in enumerate(names)))
    for pf, rows in readings.items():
        for i in (2, 3, 6, 7):          # one program: its op count cannot change between turns
            if rows[0][i] != rows[1][i] or (i > 5 and rows[0][i] != 1):
                log(f"[5 timing] {smi}: headline {pf} {names[i]} read {rows[0][i]} and "
                    f"{rows[1][i]} in its two turns: the profiler dropped events, so the "
                    "larger is a lower bound, not a count")

    tr = trackers["ihgp"]
    multi, pipe = tr.bind_env_multi(env), tr.bind_env_pipelined(env)

    def run(fn):
        def go():
            st = tr.init_state()
            for d in range(P.shape[0] // 8):
                sl = slice(8 * d, 8 * d + 8)
                st, _ = fn(st, Frame(P[sl], M[sl], T[sl]))
        return go

    n = P.shape[0]
    m1 = cuda_ms(run(multi), 3) / n
    p1 = cuda_ms(run(pipe), 3) / n
    p2 = cuda_ms(run(pipe), 3) / n
    m2 = cuda_ms(run(multi), 3) / n
    log(f"[5 timing] {smi}: headline ihgp bind_env_pipelined S=8 {p1:.4f}/{p2:.4f} "
        f"ms/frame beside bind_env_multi S=8 {m1:.4f}/{m2:.4f} (run multi, pipelined, "
        f"pipelined, multi)")


# ---------------------------------------------------------------------------
# association="hungarian": K12, K4's Hungarian builds, the paths
# ---------------------------------------------------------------------------
AUCTION_PROBLEMS = (  # (D, K, kind, max_iters) K12 is held to its plain version at
    (12, 10, "dense", 3000), (20, 6, "dense", 3000), (5, 30, "dense", 3000),
    (16, 16, "ties", 3000), (16, 16, "ties", 1), (32, 64, "sparse", 3000),
    (128, 1024, "sparse", 1000))   # saturates every phase: 1,000 keeps the run's time


def auction_problem(rng, d, k, kind):
    """(cost (D, K) f32, feasible): gate-like sparse costs, dense random
    ones (an all-infeasible row in both), or near ties (every cost within
    1e-4 of 0.25, two rows equal)."""
    if kind == "ties":
        cost = (np.float32(0.25) + rng.uniform(0, 1e-4, (d, k))).astype(np.float32)
        cost[1] = cost[0]
        return cost, np.ones((d, k), bool)
    cost = rng.uniform(0, 0.6 if kind == "dense" else 3.0, (d, k)).astype(np.float32)
    feas = (cost < 0.5) & (rng.uniform(size=(d, k)) < 0.8)
    feas[0] = False
    return cost, feas


def path_track_inputs(dev, cfg, env, sc, n_frames):
    """A Hungarian path's own track-step inputs: ``bind_env`` on the card
    over n_frames, and before each step the state, the frame's perceived
    detections and the gate's (cost, feasible) of the bank and those
    detections.  Returns (states (a list), dets (n, D, 4), valid (n, D),
    t (n,), costs (n, D, K), feasible (n, D, K))."""
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import gate_costs
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    tracker = Tracker(cfg, dev)
    plan, step, st = tracker.plan(env), tracker.bind_env(env), tracker.init_state()
    pts, mask, ts = headline_frames(sc, cfg.caps.n_max_points, range(n_frames))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, mask, ts))
    states, dets, valid, t, costs, feas = [], [], [], [], [], []
    for k in range(n_frames):
        p = tracker.perceive(Frame(P[k:k + 1], M[k:k + 1], T[k:k + 1]), plan)
        c, f = gate_costs(st.bank, p.dets[0], p.det_valid[0], cfg.id_threshold, st.initialized)
        states.append(st)
        dets.append(p.dets[0])
        valid.append(p.det_valid[0])
        t.append(torch.as_tensor(p.t).reshape(-1)[0].to(torch.float32))
        costs.append(c)
        feas.append(f)
        st, _ = step(st, Frame(P[k], M[k], T[k]))
    return (states, torch.stack(dets), torch.stack(valid), torch.stack(t), torch.stack(costs),
            torch.stack(feas))


def auction_ops(iters, d, k, per_pair) -> int:
    """Operations the auction's data needs: every iteration's sweep over
    the n = D + K columns (two differences and a comparison each), and in
    each phase's first iteration every real row's K pairs (``per_pair``
    operations each: K12 reads and subtracts, K4 rebuilds the cost)."""
    return int(sum(iters)) * 3 * (d + k) + len(iters) * per_pair * d * k


def phase_kernels_slice12(dev, smi, report, cfg):
    """K12 (the auction alone) against ``auction_assign_plain`` on the card:
    the assigned columns, saturated phases and iterations per phase bit for
    bit on dense, sparse and near-tie problems up to D = 128, K = 1,024
    (several problems in one launch), ``max_iters=1`` saturating, and on
    the headline and dense scenes' own problems under hungarian (their first
    4 and 2 frames; their iterations per phase logged); then K4's Hungarian
    builds against their plain version, bit for bit: on the dense scene's own
    frames (K = 96, D = 64; 1 x 2 and 2 x 1), and at K = 64 and 1,024, 1 x 1,
    1 x S and B x 1 (S, B = 2 at 1,024),
    under lpf and ihgp, on ``track_scene``'s gated scene (pairs of tracks
    0.35 m apart, conflicts, registrations, overflow)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import EPS, auction_assign_plain
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state, stack_states

    rng = np.random.default_rng(1207)
    report.setdefault("K12", {"max_abs_err": 0.0})

    def check(tag, C, F, eps, max_cost, max_iters):
        a, sat, it = hungarian_cuda.auction_assign(C, F, eps, max_cost, max_iters,
                                                   return_iters=True)
        torch.cuda.synchronize()
        ok, err = True, 0.0
        for b in range(C.shape[0]):
            pa, ps, pit = auction_assign_plain(C[b], F[b], eps, max_cost, max_iters,
                                               return_iters=True)
            ok = ok and equal(npy(a[b]), npy(pa)) and int(sat[b]) == int(ps)
            ok = ok and npy(it[b]).tolist() == pit
            err = max(err, max_err(npy(a[b]), npy(pa)))
        report["K12"]["max_abs_err"] = max(report["K12"]["max_abs_err"], err)
        log(f"[3 K12] {tag}, {C.shape[0]} problem(s) in one launch: exact={ok} "
            f"saturated={npy(sat).tolist()} iterations per phase {npy(it).tolist()}")
        if not ok:
            fail(f"K12 ({tag}) disagrees with its plain version")
        return npy(sat), npy(it)

    for d, k, kind, max_iters in AUCTION_PROBLEMS:
        eps, max_cost = (1e-4, 1.0) if kind == "ties" else (1e-3, 0.5)
        probs = [auction_problem(rng, d, k, kind) for _ in range(3 if k < 1024 else 1)]
        C = torch.from_numpy(np.stack([q[0] for q in probs])).to(dev)
        F = torch.from_numpy(np.stack([q[1] for q in probs])).to(dev)
        sat, _ = check(f"D={d} K={k} {kind} max_iters={max_iters}", C, F, eps, max_cost,
                       max_iters)
        if max_iters == 1 and sat.min() <= 0:
            fail("K12 at max_iters=1 did not saturate")
    for name, case, n in (("headline", bench_cases.hungarian_case, 4),
                          ("dense", bench_cases.dense_hungarian_case, 2)):
        hcfg, env, sc = case(device=dev)
        states, dets, valid, t, C, F = path_track_inputs(dev, hcfg, env, sc, n)
        check(f"the {name} scene's {n} frames under hungarian (D={C.shape[1]}, "
              f"K={C.shape[2]}, {int(F.sum())} feasible pairs)", C, F, EPS, hcfg.id_threshold,
              3000)
        if name == "dense":
            # K4's Hungarian build on the dense scene's own frames (K = 96,
            # D = 64): its n frames from the first state (1 x n), and each
            # frame from the state before it, one bank each (n x 1)
            gains = Tracker(hcfg, dev).gains_xy
            first = map_state(lambda x: x[None], states[0])
            check_track_inputs(hcfg, gains, (first, dets[None], valid[None], t[None]), report,
                               "K4 hungarian", f"the dense scene's {n} frames, K="
                               f"{hcfg.caps.k_max_tracks} 1 x {n}, D={dets.shape[1]}")
            check_track_inputs(hcfg, gains, (stack_states(states), dets[:, None],
                                             valid[:, None], t[:, None]), report,
                               "K4 hungarian", f"the dense scene's {n} frames, K="
                               f"{hcfg.caps.k_max_tracks} {n} x 1, D={dets.shape[1]}")

    hcfg = cfg.replace(association="hungarian")
    gains = Tracker(hcfg, dev).gains_xy
    D = cfg.caps.c_max_clusters
    check_track(dev, hcfg, gains, cfg.caps.k_max_tracks,
                ((1, 1, D, ()), (1, 8, D, (0,)), (8, 1, D, (0,)), (1, 8, 128, ())),
                report, "K4 hungarian", gated=True)
    check_track(dev, hcfg, gains, 1024, ((1, 1, 128, ()), (1, 2, D, (0,)), (2, 1, D, ())),
                report, "K4 hungarian", gated=True)
    check_track(dev, hcfg.replace(position_filter="ihgp"), gains, cfg.caps.k_max_tracks,
                ((1, 8, D, (0,)), (8, 1, D, (0,))), report, "K4 hungarian", gated=True)
    check_track(dev, hcfg.replace(position_filter="ihgp"), gains, 1024, ((1, 1, 128, ()),),
                report, "K4 hungarian", gated=True)


def phase_hungarian(dev, report):
    """The headline and the dense scene under ``association="hungarian"``
    through ``TrackerNode`` (12 / 8 frames, one K4 launch each),
    ``bind_env_multi`` (2 x S = 8 / 1 x S = 8) and the kernel fleet (B = 8
    x 3 steps, bit for bit each stream's ``bind_env``), against the JAX
    goldens (torch_hungarian_{headline,dense}.npz, every lane within
    TOL_DETS / TOL_VEL).  Every run launches K4's
    Hungarian build, counted as "K4 hungarian"."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    for tag, case, gkey, n_node, n_disp in (
            ("hungarian", bench_cases.hungarian_case, "hungarian", 12, 2),
            ("dense hungarian", bench_cases.dense_hungarian_case, "dense_hungarian", 8, 1)):
        golden = dict(np.load(GOLDEN_HUNGARIAN[gkey]))
        cfg, env, sc = case(device=dev)
        counts = {}
        got = run_node(dev, tag, cfg, sc, golden, n_node, FAST_PATH, report, counts)
        if counts["K4"] != n_node:
            fail(f"{tag} TrackerNode: {counts['K4']} K4 launches for {n_node} frames")
        allm = run_multi(dev, tag, cfg, env, sc, golden, n_disp, 8, FAST_PATH, report)
        n = min(n_node, 8 * n_disp)
        e = compare(f"{tag} bind_env_multi vs TrackerNode", {f: v[:n] for f, v in allm.items()},
                    {f: v[:n] for f, v in got.items()}, 0.0, 0.0)
        ids = [got["obj_id"][k][got["valid"][k]] for k in range(n_node)]
        dups = sum(len(i) - len(set(i.tolist())) for i in ids)
        log(f"[4 {tag}] bind_env_multi vs TrackerNode, first {n} frames: max abs err {e}; "
            f"duplicate ids per frame {dups}; assoc_saturated {got['assoc_saturated'].tolist()}")
        if dups:
            fail(f"{tag}: a track matched twice in a frame")
        tracker = Tracker(cfg, dev)
        frames = fleet_frames(dev, sc, cfg.caps.n_max_points, 8, 3)
        fleet = ShardedTracker(tracker, make_mesh(1, 1, device=dev), kernel_path="on")
        got_f, counts = run_fleet(f"kernel fleet {tag}", fleet, env, frames, FLEET_PATH, report)
        per_stream_bind_env(f"kernel fleet {tag}", tracker, env, frames, got_f)
        e_s0 = compare(f"kernel fleet {tag} stream 0 vs golden frames 0-2",
                       {f: v[:, 0] for f, v in got_f.items()},
                       {f: v[:3] for f, v in golden.items()}, TOL_DETS, TOL_VEL)
        log(f"[4 {tag}] kernel fleet B=8 x 3 steps: launches {counts}; bit for bit each "
            f"stream's bind_env; stream 0 vs golden {e_s0}")


def phase_timings_slice12(dev, smi, P, M, T, report):
    """The headline under ``greedy`` and ``hungarian`` in turns (greedy,
    hungarian, hungarian, greedy), each side's range logged: ``bind_env``
    and ``bind_env_multi`` ms/frame (CUDA events), device ops and host
    syncs per frame (torch.profiler; hungarian must make no host sync), and
    K4's device us per launch at K = 64, D = 32, 1 x 1 and 1 x 8 on the
    gated scene (the Hungarian build also at K = 1,024, D = 128); then K4
    hungarian and K12 against their plain versions with their bounds."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda, track_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
        EPS, auction_assign_plain, gate_costs)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, map_state

    cfg, env, _ = bench_cases.headline_case(device=dev)
    trackers = {a: Tracker(cfg.replace(association=a), dev) for a in ("greedy", "hungarian")}
    K, D = cfg.caps.k_max_tracks, cfg.caps.c_max_clusters
    scenes = {(b, s_fr): track_scene(5, cfg, K, D, b, s_fr, (), dev, gated=True)
              for b, s_fr in ((1, 1), (1, 8))}
    readings = {a: [] for a in trackers}
    for a in ("greedy", "hungarian", "hungarian", "greedy"):
        tr = trackers[a]
        ms_s, ms_m = time_path(tr, env, P, M, T)
        step, multi = tr.bind_env(env), tr.bind_env_multi(env)

        def one():
            st = tr.init_state()
            for k in range(8):
                st, _ = step(st, Frame(P[k], M[k], T[k]))

        def eight():
            multi(tr.init_state(), Frame(P[:8], M[:8], T[:8]))

        (o1, s1), (o8, s8) = trace_counts(one, 8), trace_counts(eight, 8)
        if s1 or s8:
            fail(f"headline {a}: host syncs per frame {s1} / {s8} (0 expected)")
        k4 = [one_op_profile(lambda: track_cuda.track_frames(*scenes[key], config=tr.config,
                                                              gains_xy=tr.gains_xy), 20)
              for key in ((1, 1), (1, 8))]
        for key, (_, ops, whole) in zip(((1, 1), (1, 8)), k4):
            require_one_op(f"K4 {a} {key[0]} x {key[1]}", ops, whole)
        readings[a].append((ms_s, ms_m, o1, o8, k4[0][0], k4[1][0]))
        log(f"[5 timing] {smi}: headline {a} (turn {len(readings[a])} of 2) bind_env "
            f"{ms_s:.4f} ms/frame; bind_env_multi S=8 {ms_m:.4f} ms/frame; host syncs per "
            f"frame {s1:.3f} / {s8:.3f}; device ops per frame {o1:.2f} / {o8:.2f}; K4 {a} "
            f"K={K} D={D} gated scene 1 x 1 / 1 x 8: device {k4[0][0]:.2f} / {k4[1][0]:.2f} us "
            f"per launch ({k4[0][1]:.2f} / {k4[1][1]:.2f} ops recorded per call)")
    names = ("bind_env ms/frame", "bind_env_multi ms/frame", "bind_env device ops/frame",
             "bind_env_multi device ops/frame", "K4 1x1 device us/launch",
             "K4 1x8 device us/launch")
    for a, rows in readings.items():
        log(f"[5 timing] {smi}: headline {a}, range over its 2 turns (greedy, hungarian, "
            "hungarian, greedy): " + "; ".join(
                f"{n} {min(r[i] for r in rows):.4f}-{max(r[i] for r in rows):.4f}"
                for i, n in enumerate(names)))
    hcfg = trackers["hungarian"].config
    gains = trackers["hungarian"].gains_xy
    wide = track_scene(6, cfg, 1024, 128, 1, 1, (), dev, gated=True)
    us_w, ops_w, whole = one_op_profile(lambda: track_cuda.track_frames(*wide, config=hcfg,
                                                                        gains_xy=gains), 20)
    require_one_op("K4 hungarian K=1024 D=128", ops_w, whole)
    log(f"[5 timing] {smi}: K4 hungarian K=1024 D=128 1 x 1 gated scene: device {us_w:.2f} us "
        f"per launch ({ops_w:.2f} ops recorded per call)")

    # the kernel report: K4 hungarian and K12 on the gated scene's frame
    t4 = scenes[1, 1]
    st0 = map_state(lambda x: x[0], t4[0])
    C, F = gate_costs(st0.bank, t4[1][0, 0], t4[2][0, 0], cfg.id_threshold, True)
    _, _, iters = auction_assign_plain(C, F, EPS, cfg.id_threshold, return_iters=True)
    kw = dict(config=hcfg, gains_xy=gains)
    out4 = track_cuda.track_frames(*t4, **kw)
    n_upd = int(out4[1].valid.sum())
    pairs = {
        "K4 hungarian": (lambda: track_cuda.track_frames(*t4, **kw),
                         lambda: track_cuda.track_frames_plain(*t4, **kw),
                         f"K={K} 1 x 1 frame, D={D}, gated scene, iterations per phase {iters}",
                         nbytes(t4) + nbytes(out4),
                         auction_ops(iters, D, K, 8) + 20 * cfg.data_length * n_upd),
        "K12": (lambda: hungarian_cuda.auction_assign(C, F, EPS, cfg.id_threshold),
                lambda: auction_assign_plain(C, F, EPS, cfg.id_threshold),
                f"D={D} K={K}, the same frame's gate costs, iterations per phase {iters}",
                nbytes((C, F)) + nbytes(hungarian_cuda.auction_assign(C, F, EPS,
                                                                       cfg.id_threshold)),
                auction_ops(iters, D, K, 2)),
    }
    for name, (fk, fp, shape, moved, ops) in pairs.items():
        ms_p = cuda_ms(fp, 3)
        ms_k = cuda_ms(fk, 20)
        ms_k2 = cuda_ms(fk, 20)
        ms_p2 = cuda_ms(fp, 3)
        us_k, ops_k, whole = one_op_profile(fk, 20)
        require_one_op(name, ops_k, whole)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        entry = report[name]
        entry["ms"] = min(ms_k, ms_k2)
        entry["plain_ms"] = min(ms_p, ms_p2)
        entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        entry["library_ms"] = None
        log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
            f"{ms_p:.4f}/{ms_p2:.4f} ms (run plain, kernel, kernel, plain; min reported); "
            f"device {us_k:.2f} us per launch ({ops_k:.2f} ops per call; "
            f"torch.profiler); bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} ({moved} "
            f"bytes, {ops} operations); library call none")


# ---------------------------------------------------------------------------
# dtype="float64" on the dense grid: K2, K3f and K4 built for double
# ---------------------------------------------------------------------------
F64_OPS_PER_S = 34e12          # H100 SXM: fp64 outside the tensor cores (NVIDIA's datasheet)
TOL_F64 = (1e-9, 1e-8)         # m, m/s: the JAX package's own f64 bounds (tests/test_grid.py:241)
GOLDEN_F64 = {"f64": os.path.join(HERE, "tests", "golden", "torch_f64_headline.npz"),
              "f64_hungarian_ihgp": os.path.join(HERE, "tests", "golden",
                                                 "torch_f64_hungarian_ihgp_headline.npz")}
GOLDEN_CLI_F64 = os.path.join(HERE, "tests", "golden", "torch_cli_f64_headline.json")
F64_PATH = ("K1", "K2 f64", "K3f f64", "K4 f64")   # the kernels the f64 headline must launch
F32_BUILDS = ("K2", "K3f", "K4", "K6f", "K8a", "K4 xl", "K14")   # which no f64 path may launch


def f64_track_inputs(inputs):
    """K4's inputs (``track_scene``'s) in f64: the bank's window and m0, the
    detections and the stamps."""
    st, dets, valid, t = inputs
    bank = st.bank._replace(window=st.bank.window.double(), m0=st.bank.m0.double())
    return st._replace(bank=bank), dets.double(), valid, t.double()


def require_f64(tag, counts, need=F64_PATH):
    """Fail an f64 path's run (its counts, already reported by ``require``)
    unless every kernel of ``need`` launched (by default K1 and the double
    builds of K2, K3f and K4) and no f32 build of K2, K3f, K4, K6f or K8a
    did (K7 and K8 stay f32 where the JAX route is f32): every f64 stage
    has its build, and none falls back."""
    missing = [k for k in need if counts[k] <= 0]
    ran32 = [k for k in F32_BUILDS if counts[k]]
    if missing or ran32:
        fail(f"the f64 {tag} path: {missing} not launched, f32 builds {ran32} launched: "
             f"{counts}")


def phase_kernels_slice13(dev, report, cfg):
    """K2, K3f and K4's double builds (dtype="float64") against their plain
    versions on the card, bit for bit: K2 on the headline's 8 frames of K1
    sums cast to f64 (and two adversarial frames: every cell occupied at its
    centre, half of them) and on ``k2_grids``' grids; K3f on ``k3f_tables``'
    edge cases and the headline's own f64 member tables; K4 f64 (lpf, ihgp)
    on ``track_scene`` at K = 64 (1 x 1, 1 x 8, 8 x 1) and 1,024, and K4
    hungarian f64 on its gated scene at K = 64 and 1,024, each in f64; a
    Hungarian f64 step past the narrow builds (D = 256) through K4 xl."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import (
        headline_case, k2_grids, k2_inputs, track_scene)
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, grid_cuda, track_cuda, voxel_grid_cuda)
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    cfg64 = cfg.replace(dtype="float64")
    tracker = Tracker(cfg64, dev)
    _, env, sc = headline_case(device=dev)
    plan = tracker.plan(env)
    leaf, leaf_z, tol = cfg.voxel_leaf_size, cfg.leaf_z, cfg.cluster_tolerance
    pts, msk, ts = headline_frames(sc, cfg.caps.n_max_points, range(8))
    P8, M8 = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
    T8 = torch.from_numpy(ts).to(dev).double()
    acc, _ = voxel_grid_cuda.accumulate_fast_stacked(P8, M8, cfg.scene, leaf, leaf_z)
    acc = acc.double()
    nc = acc.shape[2]
    k1 = voxel_grid_cuda.kernel_params(cfg.scene, leaf, leaf_z)
    lin = torch.arange(nc, device=dev)
    cx = (k1["bx"] + lin % k1["gx"]).double() * k1["leaf_xy"] + k1["half_xy"]
    cy = (k1["by"] + (lin // k1["gx"]) % k1["gy"]).double() * k1["leaf_xy"] + k1["half_xy"]
    adv = acc.clone()
    adv[7] = torch.stack([cx, cy, torch.full_like(cx, 0.5), torch.ones_like(cx)])
    adv[6] = adv[7] * (torch.arange(nc, device=dev) % 2 == 0)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw2 = dict(dims=plan.dims, tol=tol, leaf_xy=leaf, leaf_z=leaf_z, kwin=plan.table.k)
    offsets = grid_cuda.kernel_offsets(plan.dims, tol, leaf, leaf_z)

    def k2_pair(a, tbl, kw, offs):
        return (lambda: grid_cuda.fused_finalize_static_cc_stacked(a, *tbl, **kw),
                lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(
                    a, *tbl, dims=kw["dims"], offsets=offs, kwin=kw["kwin"],
                    max_sweeps=2 * sum(kw["dims"]), tol=kw["tol"]))

    report.setdefault("K2 f64", {"max_abs_err": 0.0})
    for label, a in (("the headline's 8 frames", acc), ("adversarial frames", adv)):
        fk, fp = k2_pair(a, tb, kw2, offsets)
        got, want = fk(), fp()
        torch.cuda.synchronize()
        ok = all(equal(npy(x), npy(y)) for x, y in zip(got, want))
        err = max_err(npy(got[0]), npy(want[0]))
        report["K2 f64"]["max_abs_err"] = max(report["K2 f64"]["max_abs_err"], err)
        log(f"[3 K2 f64] {label}, {nc} cells, {len(offsets)} offsets: bit-exact={ok} "
            f"dtype={got[0].dtype} iterations={npy(got[3]).tolist()} "
            f"dyn={npy(got[1].sum(1)).tolist()}")
        if not ok:
            fail(f"K2's double build ({label}) disagrees with its plain version")
    for label, dims, lf, lz, tl in k2_grids(cfg):
        n = dims[0] * dims[1] * dims[2]
        offs = grid_cuda.kernel_offsets(dims, tl, lf, lz)
        a, scal, br, bc, bits, kwin = k2_inputs(dims, lf, lz, tl, n, dev)
        fk, fp = k2_pair(a.double(), (scal, br, bc, bits),
                         dict(dims=dims, tol=tl, leaf_xy=lf, leaf_z=lz, kwin=kwin), offs)
        got, want = fk(), fp()
        torch.cuda.synchronize()
        ok = all(equal(npy(x), npy(y)) for x, y in zip(got, want))
        log(f"[3 K2 f64] {label}: {n} cells, {len(offs)} offsets, cluster "
            f"{grid_cuda.cluster_size(n, len(offs), dev)}: bit-exact={ok} "
            f"iterations={npy(got[3]).tolist()}")
        if not ok:
            fail(f"K2's double build at {n} cells disagrees with its plain version")

    # K3f f64: the edge-case tables and the headline's own member tables
    rng = np.random.default_rng(1301)
    outs = grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2)
    ctab = cluster_table_grid(outs[2], outs[3], outs[0], outs[1], plan.dims[0],
                              cfg.min_cluster_size, cfg.max_cluster_size,
                              cfg.caps.c_max_clusters, cfg.caps.p_max_cluster)
    mp_h = ctab.mpts.reshape(-1, cfg.caps.p_max_cluster, 3).contiguous()
    mm_h = ctab.member_mask.reshape(-1, cfg.caps.p_max_cluster).contiguous()
    mp_e, mm_e = k3f_tables(rng, 8, 32, cfg.caps.p_max_cluster, dev)
    report.setdefault("K3f f64", {"max_abs_err": 0.0})
    for label, mp, mm in (("the headline's f64 member tables, S=8 x C=32", mp_h, mm_h),
                          ("edge-case tables, S=8 x C=32", mp_e.double(), mm_e)):
        got = centroid_cuda.circumcenter_features(mp, mm, T8)
        want = centroid_cuda.circumcenter_features_plain(mp, mm, T8)
        torch.cuda.synchronize()
        ok = equal(npy(got), npy(want)) and got.dtype == torch.float64
        err = max_err(npy(got), npy(want))
        report["K3f f64"]["max_abs_err"] = max(report["K3f f64"]["max_abs_err"], err)
        log(f"[3 K3f f64] {label}, {int(mm.any(1).sum())} active slots: bit-exact={ok} "
            f"max_abs_err={err}")
        if not ok:
            fail(f"K3f's double build ({label}) disagrees with its plain version")

    # K4's double builds
    gains = tracker.gains_xy
    K, D = cfg.caps.k_max_tracks, cfg.caps.c_max_clusters
    for name, assoc, pfs, widths in (
            ("K4 f64", "greedy", ("lpf", "ihgp"), (K, 1024)),
            ("K4 hungarian f64", "hungarian", ("lpf", "ihgp"), (K, 1024))):
        for pf in pfs:
            c = cfg64.replace(association=assoc, position_filter=pf)
            for k in widths:
                d = D if k == K else 128
                for i, (b, s, fresh) in enumerate(((1, 1, ()), (1, 8, (0,)), (8, 1, (0,)))
                                                  if k == K else ((1, 1, ()),)):
                    ins = f64_track_inputs(track_scene(1300 + 10 * k + i, cfg, k, d, b, s,
                                                       fresh, dev, assoc == "hungarian"))
                    check_track_inputs(c, gains, ins, report, name,
                                       f"{pf}, K={k} {b} x {s} frames, D={d}, f64")
    past = f64_track_inputs(track_scene(1399, cfg, K, 256, 1, 1, (), dev, True))
    hcfg = cfg64.replace(association="hungarian")
    check_track_inputs(hcfg, Tracker(hcfg, dev).gains_xy, past, report, "K4 xl hungarian",
                       f"K={K} 1 x 1, D=256 (past the narrow builds' 128), f64")
    return {"acc": acc, "tb": tb, "kw2": kw2, "offsets": offsets, "mp": mp_h, "mm": mm_h,
            "T8": T8, "tracker": tracker}


def phase_f64(dev, report):
    """The f64 headline (``dtype="float64"``) through ``bind_env`` (12
    frames), ``bind_env_multi`` (S = 8, twice), ``TrackerNode`` (12 frames)
    and the CLI (a config file ``dtype: float64``) against the JAX package's
    f64 goldens (torch_f64_headline.npz, torch_cli_f64_headline.json), and
    under ``association="hungarian"`` + ``position_filter="ihgp"`` through
    ``TrackerNode`` and ``bind_env_multi`` against
    torch_f64_hungarian_ihgp_headline.npz: integers exact, floats within
    TOL_F64 (1e-9 m, 1e-8 m/s; the CLI's 4-decimal records within
    ``cli_errors``' bound); every run launches K1 and the double builds of
    K2, K3f and K4 and no f32 build of them."""
    import tempfile

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_torch_golden import CLI_CONFIGS, cli_bag

    base, env, sc = bench_cases.headline_case(device=dev)
    for gkey, fields in (("f64", {}), ("f64_hungarian_ihgp",
                                       {"association": "hungarian", "position_filter": "ihgp"})):
        golden = dict(np.load(GOLDEN_F64[gkey]))
        cfg = base.replace(dtype="float64", **fields)
        assoc = cfg.association
        n_gold = golden["publish"].shape[0]
        if gkey == "f64":
            tracker = Tracker(cfg, dev)
            step = tracker.bind_env(env)
            pts, msk, ts = headline_frames(sc, cfg.caps.n_max_points, range(n_gold))
            st = tracker.init_state()
            reset_counts()
            rows = []
            for k in range(n_gold):
                st, o = step(st, Frame(torch.from_numpy(pts[k]).to(dev),
                                       torch.from_numpy(msk[k]).to(dev),
                                       torch.tensor(ts[k], device=dev)))
                rows.append([npy(x) for x in o])
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([r[i] for r in rows]) for i, f in enumerate(golden)}
            if got["raw_centroid"].dtype != np.float64 or got["pos"].dtype != np.float64:
                fail(f"f64 bind_env returned {got['raw_centroid'].dtype} detections")
            e = compare("f64 bind_env vs JAX golden", got, golden, *TOL_F64)
            log(f"[4 f64] bind_env x{n_gold}: launches {counts}; vs JAX golden max abs err {e}")
            require("f64 bind_env", counts, (), report)
            require_f64("f64 bind_env", counts)
            if counts["K4 f64"] != n_gold:
                fail(f"f64 bind_env: {counts['K4 f64']} K4 f64 launches for {n_gold} frames")
        tag = f"{gkey} headline"
        counts = {}
        run_node(dev, tag, cfg, sc, golden, n_gold, (), report, counts, TOL_F64)
        require_f64(f"{tag} TrackerNode", counts)
        if counts["K4 f64"] != n_gold:
            fail(f"{tag} TrackerNode: {counts['K4 f64']} K4 f64 launches for {n_gold} frames")
        run_multi(dev, tag, cfg, env, sc, golden, n_gold // 8 or 1, 8, (), report, TOL_F64)
        require_f64(f"{tag} bind_env_multi", read_counts())
    # the CLI with a config file `dtype: float64`
    with open(GOLDEN_CLI_F64, encoding="utf-8") as fh:
        gold = json.load(fh)
    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_bag(os.path.join(tmp, "frames.npz"))
        conf = os.path.join(tmp, "config.yaml")
        with open(conf, "w", encoding="utf-8") as fh:
            fh.write(CLI_CONFIGS["cli_f64"])
        reset_counts()
        _, recs, _ = run_cli(argv + ["--config", conf, "--device", "cuda"])
        counts = read_counts()
    errs, worst = cli_errors(recs, gold)
    log(f"[4 f64] CLI run --config <dtype: float64>: {len(recs)} records, launches {counts}; "
        f"vs the JAX CLI golden: {errs or 'within tolerance'} (worst pos / vel {worst})")
    if errs:
        fail(f"f64 CLI: {errs}")
    require("f64 CLI", counts, (), report)
    require_f64("f64 CLI", counts)


def phase_timings_slice13(dev, smi, P, M, T, report, k):
    """The f32 and f64 headlines in turns (f32, f64, f64, f32), each side's
    range logged: ``bind_env`` and ``bind_env_multi`` ms/frame (CUDA events),
    device ops and host syncs per frame (torch.profiler; both must make no
    host sync); then K2, K3f and K4's double builds against their plain
    versions at the main path's shapes, with their bounds (fp64 at
    F64_OPS_PER_S, or the bytes at HBM_BYTES_PER_S)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda, grid_cuda, track_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
        EPS, auction_assign_plain, gate_costs)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, map_state

    cfg, env, _ = bench_cases.headline_case(device=dev)
    trackers = {dt: Tracker(cfg.replace(dtype=dt), dev) for dt in ("float32", "float64")}
    readings = {dt: [] for dt in trackers}
    for dt in ("float32", "float64", "float64", "float32"):
        tr = trackers[dt]
        ms_s, ms_m = time_path(tr, env, P, M, T)
        step, multi = tr.bind_env(env), tr.bind_env_multi(env)

        def one():
            st = tr.init_state()
            for i in range(8):
                st, _ = step(st, Frame(P[i], M[i], T[i]))

        def eight():
            multi(tr.init_state(), Frame(P[:8], M[:8], T[:8]))

        (o1, s1), (o8, s8) = trace_counts(one, 8), trace_counts(eight, 8)
        if s1 or s8:
            fail(f"headline {dt}: host syncs per frame {s1} / {s8} (0 expected)")
        readings[dt].append((ms_s, ms_m, o1, o8))
        log(f"[5 timing] {smi}: headline {dt} (turn {len(readings[dt])} of 2) bind_env "
            f"{ms_s:.4f} ms/frame; bind_env_multi S=8 {ms_m:.4f} ms/frame; host syncs per "
            f"frame {s1:.3f} / {s8:.3f}; device ops per frame {o1:.2f} / {o8:.2f}")
    names = ("bind_env ms/frame", "bind_env_multi ms/frame", "bind_env device ops/frame",
             "bind_env_multi device ops/frame")
    for dt, rows in readings.items():
        log(f"[5 timing] {smi}: headline {dt}, range over its 2 turns (f32, f64, f64, f32): "
            + "; ".join(f"{n} {min(r[i] for r in rows):.4f}-{max(r[i] for r in rows):.4f}"
                        for i, n in enumerate(names)))

    # the double builds beside their plain versions, with their bounds
    acc, tb, kw2, offsets = k["acc"], k["tb"], k["kw2"], k["offsets"]
    mp, mm, T8, tracker = k["mp"], k["mm"], k["T8"], k["tracker"]
    K, D = cfg.caps.k_max_tracks, cfg.caps.c_max_clusters
    gains = tracker.gains_xy
    c64 = tracker.config
    h64 = c64.replace(association="hungarian")
    t4_32 = track_scene(5, cfg, K, D, 1, 1, (), dev)
    t4h_32 = track_scene(5, cfg, K, D, 1, 1, (), dev, gated=True)
    t4, t4h = f64_track_inputs(t4_32), f64_track_inputs(t4h_32)
    g32 = trackers["float32"].gains_xy
    acc32, mp32, T32 = acc.float(), mp.float(), T8.float()
    twins = {  # each double build's f32 build on the same inputs rounded to f32
        "K2 f64": lambda: grid_cuda.fused_finalize_static_cc_stacked(acc32, *tb, **kw2),
        "K3f f64": lambda: centroid_cuda.circumcenter_features(mp32, mm, T32),
        "K4 f64": lambda: track_cuda.track_frames(*t4_32, config=cfg, gains_xy=g32),
        "K4 hungarian f64": lambda: track_cuda.track_frames(
            *t4h_32, config=cfg.replace(association="hungarian"), gains_xy=g32),
    }
    outs = grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2)
    s8, nc, n_off, iters = acc.shape[0], acc.shape[2], len(offsets), int(outs[3].sum())
    o4 = track_cuda.track_frames(*t4, config=c64, gains_xy=gains)
    o4h = track_cuda.track_frames(*t4h, config=h64, gains_xy=gains)
    st0 = map_state(lambda x: x[0], t4h[0])
    C, F = gate_costs(st0.bank, t4h[1][0, 0], t4h[2][0, 0], cfg.id_threshold, True)
    _, _, au_iters = auction_assign_plain(C, F, EPS, cfg.id_threshold, return_iters=True)

    def upd(out):
        return int(out[1].valid.sum())

    pairs = {  # name: (kernel, plain, shape, bytes, fp64 operations)
        "K2 f64": (lambda: grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2),
                   lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(
                       acc, *tb, dims=kw2["dims"], offsets=offsets, kwin=kw2["kwin"],
                       max_sweeps=2 * sum(kw2["dims"]), tol=kw2["tol"]),
                   f"S=8 frames x {nc} cells, f64", nbytes((acc,) + tb) + nbytes(outs),
                   s8 * nc * (15 + 9 * n_off) + iters * nc * (2 * n_off + 1)),
        "K3f f64": (lambda: centroid_cuda.circumcenter_features(mp, mm, T8),
                    lambda: centroid_cuda.circumcenter_features_plain(mp, mm, T8),
                    f"S=8 x C=32 P=384 stacked, {int(mm.any(1).sum())} active slots, f64",
                    2 * (scan_bytes_read(mm, True) - nbytes(mm)) + nbytes(mm) + nbytes(T8)
                    + nbytes(centroid_cuda.circumcenter_features(mp, mm, T8)),
                    scan_ops(mm, True)),
        "K4 f64": (lambda: track_cuda.track_frames(*t4, config=c64, gains_xy=gains),
                   lambda: track_cuda.track_frames_plain(*t4, config=c64, gains_xy=gains),
                   f"K={K} 1 x 1 frame, D={D}, {int(t4[2].sum())} valid detections, f64",
                   nbytes(t4) + nbytes(o4),
                   12 * K * int(t4[2].sum()) + 20 * cfg.data_length * upd(o4)),
        "K4 hungarian f64": (
            lambda: track_cuda.track_frames(*t4h, config=h64, gains_xy=gains),
            lambda: track_cuda.track_frames_plain(*t4h, config=h64, gains_xy=gains),
            f"K={K} 1 x 1 frame, D={D}, gated scene, iterations per phase {au_iters}, f64",
            nbytes(t4h) + nbytes(o4h),
            auction_ops(au_iters, D, K, 8) + 20 * cfg.data_length * upd(o4h)),
    }
    for name, (fk, fp, shape, moved, ops) in pairs.items():
        ms_p = cuda_ms(fp, 3)
        ms_k = cuda_ms(fk, 20)
        ms_k2 = cuda_ms(fk, 20)
        ms_p2 = cuda_ms(fp, 3)
        us32 = one_op_profile(twins[name], 10)[0]
        us_k, ops_k, whole = one_op_profile(fk, 20)
        require_one_op(name, ops_k, whole)
        us_k2 = one_op_profile(fk, 20)[0]
        us32_2 = one_op_profile(twins[name], 10)[0]
        log(f"[5 timing] {smi}: {name} device us per launch in turns (f32 build, double, "
            f"double, f32 build) {us32:.2f}, {us_k:.2f}, {us_k2:.2f}, {us32_2:.2f}: double / "
            f"f32 {min(us_k, us_k2) / min(us32, us32_2):.2f}x")
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
        entry = report[name]
        entry["ms"] = min(ms_k, ms_k2)
        entry["plain_ms"] = min(ms_p, ms_p2)
        entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        entry["library_ms"] = None
        log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
            f"{ms_p:.4f}/{ms_p2:.4f} ms (run plain, kernel, kernel, plain; min reported); "
            f"device {us_k:.2f} us per launch ({ops_k:.2f} ops per call; torch.profiler); "
            f"bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} ({moved} bytes, {ops} "
            "fp64 operations); library call none")


# ---------------------------------------------------------------------------
# dtype="float64" off the dense grid's fast digits
# ---------------------------------------------------------------------------
GOLDEN_F64_PL = {g: os.path.join(HERE, "tests", "golden", f"torch_{g}_headline.npz")
                 for g in ("f64_default", "f64_pointlist", "f64_pointlist_scan",
                           "f64_pointlist_runs", "f64_exact", "f64_runs")}
GOLDEN_CLI_F64_DEFAULT = os.path.join(HERE, "tests", "golden",
                                      "torch_cli_f64_default_headline.json")
def f64_points(pts, seed):
    """f64 copies of f32 points with noise below f32's resolution (so a
    route that rounds them through f32 shows)."""
    return pts.astype(np.float64) + np.random.default_rng(seed).normal(0, 1e-9, pts.shape)


def require_ops(tag: str, ops: float, whole: bool, n: int) -> None:
    """``require_one_op`` for a call of ``n`` launches (K6f: 2 + passes)."""
    if ops != n if whole else not 0 < ops <= n:
        fail(f"{tag}: {ops} device ops recorded per call ({n} expected; whole trace: {whole})")


def k6f_passes(vg, s, n, kw):
    return vg.sorted_sums_plan(s, n, vg.kernel_params(*kw)["n_cells"], 8)["passes"]


def phase_kernels_slice14(dev, report, cfg):
    """K6f, K8a and K2 fed f32 sums built for double (dtype="float64")
    against their plain versions on the card, bit for bit: K6f f64 on the
    headline's 8 frames in f64 (frame 7 adversarial: NaN, out of bounds, a
    one-cell blob) and on configuration G's grid (S = 8), 2 + passes
    launches per call; K8a f64 on C's M = 1,024 and G's M = 2,048 point
    lists in f64 (S = 1 and 8; C's frame 7 a boundary lattice at 1e-13 m)
    and past 4,096 rows (M = 6,144, the frame in device memory), one op per
    call; K2's double build fed the runs' f32 sums (K7's accumulator of the
    headline's 8 frames), one op per call."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import (
        default_case, headline_case, pointlist_case)
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        cluster_pallas, grid_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_pallas import (
        voxel_accumulate_runs_stacked)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    f64 = torch.float64
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    _, env, sc = headline_case(device=dev)
    pts, msk, ts = headline_frames(sc, cfg.caps.n_max_points, range(8))
    p64 = f64_points(pts, 1401)
    P64t = torch.from_numpy(p64.copy()).to(dev)      # the timings' frames: no adversarial one
    p64[7, :50, 0] = np.nan
    p64[7, 50:100] = [-999.0, 999.0, 0.5]
    p64[7, 100:2100] = np.array([0.35, 1.25, 0.5]) + np.random.default_rng(1402).normal(
        0, 0.01, (2000, 3))
    P32, M8 = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
    P64 = torch.from_numpy(p64).to(dev)
    gcfg, _, gsc = default_case()
    gp, gm, _ = headline_frames(gsc, gcfg.caps.n_max_points, range(8))
    GP32, GM = torch.from_numpy(gp).to(dev), torch.from_numpy(gm).to(dev)
    GP64 = torch.from_numpy(f64_points(gp, 1403)).to(dev)
    gkw = (gcfg.scene, gcfg.voxel_leaf_size, gcfg.leaf_z)
    for label, Pd, Md, kk in (("the headline's 8 frames (7 adversarial)", P64, M8, kw),
                              ("configuration G's grid, 8 frames", GP64, GM, gkw)):
        n_pass = k6f_passes(vg, 8, Pd.shape[1], kk)
        fk = lambda Pd=Pd, Md=Md, kk=kk: vg.accumulate_f32_stacked(Pd, Md, *kk)  # noqa: E731
        out = check_pair(report, "K6f f64", f"S=8 N={Pd.shape[1]} f64, "
                         f"{vg.kernel_params(*kk)['n_cells']} cells, {n_pass} passes: {label}",
                         fk, lambda Pd=Pd, Md=Md, kk=kk: vg.accumulate_f32_stacked_plain(
                             Pd, Md, *kk))
        if out[0].dtype != f64:
            fail(f"K6f f64 returned {out[0].dtype}")
        _, ops, whole = one_op_profile(fk, 5)
        require_ops(f"K6f f64 ({label})", ops, whole, 2 + n_pass)

    # K8a f64: C's and G's point lists (the f32 pipeline's rows, in f64 with
    # sub-f32 noise on the valid rows), S = 1 and 8
    pcfg = pointlist_case()[0]
    cpts, cmsk = pointlist_rows(dev, pcfg, P32, M8)
    gpts, gmsk = pointlist_rows(dev, gcfg, GP32, GM)
    rng = np.random.default_rng(1404)

    def widen(p, m):
        noise = torch.from_numpy(rng.normal(0, 1e-9, tuple(p.shape))).to(dev)
        return (p.double() + noise * m[..., None]).contiguous()

    c64, g64 = widen(cpts, cmsk), widen(gpts, gmsk)
    lat = torch.stack(torch.meshgrid(torch.arange(32), torch.arange(32), indexing="ij"), -1)
    c64[7] = 0.5
    c64[7, :, :2] = lat.reshape(-1, 2).to(dev).double() * 0.15 - 2.0
    c64[7] += torch.from_numpy(rng.normal(0, 1e-13, (c64.shape[1], 3))).to(dev)
    cmsk = cmsk.clone()
    cmsk[7] = True
    tol = pcfg.cluster_tolerance
    for label, p, m in (("C's M=1,024, S=1", c64[:1], cmsk[:1]),
                        ("C's M=1,024, S=8 (7: a boundary lattice at 1e-13 m)", c64, cmsk),
                        ("G's M=2,048, S=1", g64[:1], gmsk[:1]),
                        ("G's M=2,048, S=8", g64, gmsk)):
        fk = lambda p=p, m=m: (cluster_pallas.cc_adjacency(p, m, tol),)  # noqa: E731
        check_pair(report, "K8a f64", f"{label} point lists in f64 (layout "
                   f"{cluster_pallas._layout(p.shape[1], None, dev, f64)})", fk,
                   lambda p=p, m=m: (cluster_pallas.cc_adjacency_plain(p, m, tol),))
        _, ops, whole = one_op_profile(fk, 10)
        require_one_op(f"K8a f64 ({label})", ops, whole)
    big = 6144
    lay = cluster_pallas._layout(big, None, dev, f64)
    if not lay[2] or cluster_pallas._layout(big, None, dev)[2]:
        fail(f"M={big}: the f64 frame should leave shared memory and the f32 one stay: {lay}")
    bp = torch.from_numpy(rng.normal(0, 0.8, (2, big, 3))).to(dev)
    bp[..., 2] *= 0.1
    bm = torch.from_numpy(rng.random((2, big)) < 0.7).to(dev)
    bp[0, :c64.shape[1]], bm[0, :c64.shape[1]] = c64[0], cmsk[0]
    bp[1, :g64.shape[1]], bm[1, :g64.shape[1]] = g64[0], gmsk[0]
    fk = lambda: (cluster_pallas.cc_adjacency(bp, bm, tol),)  # noqa: E731
    check_pair(report, "K8a f64", f"S=2 M={big} past 4,096 rows (the frame in device memory, "
               f"{lay[0]} CTAs per frame)", fk,
               lambda: (cluster_pallas.cc_adjacency_plain(bp, bm, tol),))
    _, ops, whole = one_op_profile(fk, 3)
    require_one_op(f"K8a f64 (M={big})", ops, whole)

    # K2 f64 fed the runs' f32 sums
    rcfg = cfg.replace(voxel_mode="runs", dtype="float64")
    plan = Tracker(rcfg, dev).plan(env)
    acc_r, _ = voxel_accumulate_runs_stacked(P32, M8, *kw)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw2 = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
               leaf_z=cfg.leaf_z, kwin=plan.table.k)
    offsets = grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance, cfg.voxel_leaf_size,
                                       cfg.leaf_z)
    fk = lambda: grid_cuda.fused_finalize_static_cc_stacked(  # noqa: E731
        acc_r, *tb, dtype=f64, **kw2)
    out = check_pair(report, "K2 f64 f32-sums", f"S=8 x {acc_r.shape[2]} cells of the runs' "
                     "f32 sums (K7's accumulator), finalized in f32, widened, d^2 in f64", fk,
                     lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(
                         acc_r, *tb, dims=plan.dims, offsets=offsets, kwin=plan.table.k,
                         max_sweeps=2 * sum(plan.dims), tol=cfg.cluster_tolerance, dtype=f64))
    if out[0].dtype != f64:
        fail(f"K2 f64 f32-sums returned {out[0].dtype} centroids")
    wide = grid_cuda.fused_finalize_static_cc_stacked(acc_r.double(), *tb, **kw2)[0]
    log(f"[3 K2 f64 f32-sums] centroids differ from dividing the f32 sums in f64 in "
        f"{int((wide != out[0]).sum())} of {wide.numel()} values; dyn "
        f"{npy(out[1].sum(1)).tolist()}, iterations {npy(out[3]).tolist()}")
    _, ops, whole = one_op_profile(fk, 10)
    require_one_op("K2 f64 f32-sums", ops, whole)
    return {"P64": P64t, "M8": M8, "kw": kw, "GP64": GP64, "GM": GM, "gkw": gkw, "c64": c64,
            "cmsk": cmsk, "g64": g64, "gmsk": gmsk, "tol": tol, "acc_r": acc_r, "tb": tb,
            "kw2": kw2, "offsets": offsets}


def phase_f64_pointlist(dev, report):
    """``dtype="float64"`` off the fast digits against the JAX package's f64
    goldens (4 headline frames each; integers exact, floats within TOL_F64):
    G (``TrackerConfig(dtype="float64")``) through ``bind_env``,
    ``bind_env_multi`` (S = 8), ``TrackerNode`` and the CLI (a config file
    ``dtype: float64``, no ``--backend``, 8 frames); C, E, F and the exact
    and runs modes through ``bind_env``.  Each run launches its double
    builds (K6f, K8a, K2, K3f, K4; K2 fed f32 sums under runs) and K7 / K8
    in f32 where the JAX route is f32, and no f32 build of K2, K3f, K4,
    K6f or K8a."""
    import tempfile

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_torch_golden import CASE_FIELDS, CLI_CONFIGS, FRAMES, cli_bag

    g_need = ("K6f f64", "K8a f64", "K3f f64", "K4 f64")
    paths = (("f64_default", bench_cases.default_case, "G f64", g_need),
             ("f64_pointlist", bench_cases.headline_case, "C f64",
              ("K6f f64", "K8", "K3f f64", "K4 f64")),
             ("f64_pointlist_scan", bench_cases.headline_case, "E f64",
              ("K8a f64", "K3f f64", "K4 f64")),
             ("f64_pointlist_runs", bench_cases.headline_case, "F f64",
              ("K7", "K8", "K3f f64", "K4 f64")),
             ("f64_exact", bench_cases.headline_case, "exact f64",
              ("K6f f64", "K2 f64", "K3f f64", "K4 f64")),
             ("f64_runs", bench_cases.headline_case, "runs f64",
              ("K7", "K2 f64 f32-sums", "K3f f64", "K4 f64")))
    for gkey, case, tag, need in paths:
        golden = dict(np.load(GOLDEN_F64_PL[gkey]))
        cfg, env, sc = case(device=dev)
        cfg = cfg.replace(**CASE_FIELDS[gkey])
        n_gold = golden["publish"].shape[0]
        tracker = Tracker(cfg, dev)
        step = tracker.bind_env(env)
        pts, msk, ts = headline_frames(sc, cfg.caps.n_max_points, range(n_gold))
        st = tracker.init_state()
        reset_counts()
        rows = []
        for k in range(n_gold):
            st, o = step(st, Frame(torch.from_numpy(pts[k]).to(dev),
                                   torch.from_numpy(msk[k]).to(dev),
                                   torch.tensor(ts[k], device=dev)))
            rows.append([npy(x) for x in o])
        torch.cuda.synchronize()
        counts = read_counts()
        got = {f: np.stack([r[i] for r in rows]) for i, f in enumerate(golden)}
        if got["raw_centroid"].dtype != np.float64 or got["pos"].dtype != np.float64:
            fail(f"{tag} bind_env returned {got['raw_centroid'].dtype} detections")
        e = compare(f"{tag} bind_env vs JAX golden", got, golden, *TOL_F64)
        log(f"[4 {tag}] bind_env x{n_gold} ({cfg.voxel_mode} / {cfg.cluster_backend} / "
            f"{cfg.voxel_quant}, N={cfg.caps.n_max_points}): n_clusters "
            f"{got['n_clusters'].tolist()}, launches {counts}; vs JAX golden max abs err {e}")
        require(f"{tag} bind_env", counts, need, report)
        require_f64(f"{tag} bind_env", counts, need)
        if counts["K4 f64"] != n_gold:
            fail(f"{tag} bind_env: {counts['K4 f64']} K4 f64 launches for {n_gold} frames")
        if gkey != "f64_default":
            continue
        counts = {}
        run_node(dev, tag, cfg, sc, golden, n_gold, need, report, counts, TOL_F64)
        require_f64(f"{tag} TrackerNode", counts, need)
        run_multi(dev, tag, cfg, env, sc, golden, 1, 8, need, report, TOL_F64)
        require_f64(f"{tag} bind_env_multi", read_counts(), need)
    # the CLI: a config file `dtype: float64` on the default backend
    with open(GOLDEN_CLI_F64_DEFAULT, encoding="utf-8") as fh:
        gold = json.load(fh)
    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_bag(os.path.join(tmp, "frames.npz"), FRAMES["cli_f64_default"], grid=False)
        conf = os.path.join(tmp, "config.yaml")
        with open(conf, "w", encoding="utf-8") as fh:
            fh.write(CLI_CONFIGS["cli_f64_default"])
        reset_counts()
        _, recs, _ = run_cli(argv + ["--config", conf, "--device", "cuda"])
        counts = read_counts()
    errs, worst = cli_errors(recs, gold)
    log(f"[4 G f64] CLI run --config <dtype: float64> (no --backend): {len(recs)} records, "
        f"launches {counts}; vs the JAX CLI golden: {errs or 'within tolerance'} (worst pos / "
        f"vel {worst})")
    if errs:
        fail(f"G f64 CLI: {errs}")
    require("G f64 CLI", counts, g_need, report)
    require_f64("G f64 CLI", counts, g_need)


def phase_timings_slice14(dev, smi, report, k):
    """Each new double build beside its f32 build on the same inputs
    rounded to f32, device us per call in turns (f32, f64, f64, f32;
    torch.profiler): K6f at the headline's S = 8 and G's grid S = 8, K8a at
    M = 1,024 and 2,048, S = 1 and 8, K2 fed f32 sums beside K2 f32 and K2
    f64; the report's entries (kernel and plain ms by CUDA events in turns,
    bounds: bytes at HBM_BYTES_PER_S, fp64 operations at F64_OPS_PER_S and
    the integer ones at F32_OPS_PER_S; K6f f64's library call a
    ``torch.index_add`` in f64); then the f64 G frame's device ops and host
    syncs per frame (bind_env and bind_env_multi S = 8)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        cluster_pallas, grid_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    tol, tb, kw2, acc_r = k["tol"], k["tb"], k["kw2"], k["acc_r"]

    def device_us(fn, reps):
        us, ops, _ = one_op_profile(fn, reps)
        return us * ops

    def turns(tag, f32, f64, reps):
        a, b = device_us(f32, reps), device_us(f64, reps)
        b2, a2 = device_us(f64, reps), device_us(f32, reps)
        log(f"[5 timing] {smi}: {tag} device us per call in turns (f32 build, double, double, "
            f"f32 build) {a:.2f}, {b:.2f}, {b2:.2f}, {a2:.2f}: double / f32 "
            f"{min(b, b2) / min(a, a2):.2f}x")
        return min(b, b2)

    for label, P, Mk, kk in (("headline S=8", k["P64"], k["M8"], k["kw"]),
                             ("G's grid S=8", k["GP64"], k["GM"], k["gkw"])):
        P32 = P.float()
        turns(f"K6f f64 {label}", lambda P32=P32, Mk=Mk, kk=kk: vg.accumulate_f32_stacked(
            P32, Mk, *kk), lambda P=P, Mk=Mk, kk=kk: vg.accumulate_f32_stacked(P, Mk, *kk), 10)
    for label, p, m in (("M=1,024 S=1", k["c64"][:1], k["cmsk"][:1]),
                        ("M=1,024 S=8", k["c64"], k["cmsk"]),
                        ("M=2,048 S=1", k["g64"][:1], k["gmsk"][:1]),
                        ("M=2,048 S=8", k["g64"], k["gmsk"])):
        p32 = p.float()
        turns(f"K8a f64 {label}", lambda p32=p32, m=m: cluster_pallas.cc_adjacency(p32, m, tol),
              lambda p=p, m=m: cluster_pallas.cc_adjacency(p, m, tol), 20)
    acc64 = acc_r.double()
    k2_32 = lambda: grid_cuda.fused_finalize_static_cc_stacked(acc_r, *tb, **kw2)  # noqa: E731
    k2_64 = lambda: grid_cuda.fused_finalize_static_cc_stacked(acc64, *tb, **kw2)  # noqa: E731
    k2_fs = lambda: grid_cuda.fused_finalize_static_cc_stacked(  # noqa: E731
        acc_r, *tb, dtype=torch.float64, **kw2)
    turns("K2 f64 f32-sums (beside K2 f32)", k2_32, k2_fs, 20)
    turns("K2 f64 f32-sums (beside K2 f64, as the 'f32 build' column)", k2_64, k2_fs, 20)

    # the report's entries
    P64, M8, kw = k["P64"], k["M8"], k["kw"]
    k1p = vg.kernel_params(*kw)
    s8, nc = P64.shape[0], k1p["n_cells"]
    ok, lin, _ = vg.kept_cells(P64.float(), M8, k1p)
    kept = int(ok.sum())
    frame_of = torch.arange(s8, device=dev)[:, None]
    tgt = torch.where(ok, frame_of * nc + lin, s8 * nc).reshape(-1)
    vals4 = torch.cat([torch.where(ok[..., None], P64, 0.0), ok[..., None].double()],
                      -1).reshape(-1, 4)
    base = torch.zeros((s8 * nc + 1, 4), dtype=torch.float64, device=dev)
    g64, gmsk = k["g64"], k["gmsk"]
    vg8 = gmsk.sum(dim=1).to(torch.float64)
    outs = grid_cuda.fused_finalize_static_cc_stacked(acc_r, *tb, dtype=torch.float64, **kw2)
    n_off, iters = len(k["offsets"]), int(outs[3].sum())
    pairs = {  # name: (kernel, plain, shape, bytes, (fp64 ops, other ops), library call)
        "K6f f64": (lambda: vg.accumulate_f32_stacked(P64, M8, *kw),
                    lambda: vg.accumulate_f32_stacked_plain(P64, M8, *kw),
                    f"S=8 frames x {P64.shape[1]} f64 points, {nc} cells",
                    nbytes((P64, M8)) + nbytes(vg.accumulate_f32_stacked(P64, M8, *kw)),
                    (3 * kept, 17 * kept), lambda: torch.index_add(base, 0, tgt, vals4)),
        "K8a f64": (lambda: cluster_pallas.cc_adjacency(g64, gmsk, tol),
                    lambda: cluster_pallas.cc_adjacency_plain(g64, gmsk, tol),
                    f"S=8 x M={g64.shape[1]} G point lists in f64, bool (M, M) out",
                    nbytes((g64, gmsk)) + nbytes(cluster_pallas.cc_adjacency(g64, gmsk, tol)),
                    (int((9 * vg8 * vg8).sum()), 0), None),
        "K2 f64 f32-sums": (k2_fs, lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(
            acc_r, *tb, dims=kw2["dims"], offsets=k["offsets"], kwin=kw2["kwin"],
            max_sweeps=2 * sum(kw2["dims"]), tol=kw2["tol"], dtype=torch.float64),
            f"S=8 frames x {acc_r.shape[2]} cells of f32 sums, f64 centroids and d^2",
            nbytes((acc_r,) + tb) + nbytes(outs),
            (s8 * acc_r.shape[2] * 9 * n_off,
             s8 * acc_r.shape[2] * 15 + iters * acc_r.shape[2] * (2 * n_off + 1)), None),
    }
    for name, (fk, fp, shape, moved, (ops64, ops32), lib) in pairs.items():
        ms_p = cuda_ms(fp, 2)
        ms_k = cuda_ms(fk, 20)
        ms_k2 = cuda_ms(fk, 20)
        ms_p2 = cuda_ms(fp, 2)
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = ops64 / F64_OPS_PER_S + ops32 / F32_OPS_PER_S
        entry = report[name]
        entry["ms"] = min(ms_k, ms_k2)
        entry["plain_ms"] = min(ms_p, ms_p2)
        entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        entry["library_ms"] = cuda_ms(lib, 20) if lib is not None else None
        log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
            f"{ms_p:.4f}/{ms_p2:.4f} ms (run plain, kernel, kernel, plain; min reported); "
            f"bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} ({moved} bytes, {ops64} "
            f"fp64 and {ops32} other operations); library call "
            f"{'none' if lib is None else format(entry['library_ms'], '.4f') + ' ms'}")

    # G in f32 and f64 in turns: ms/frame; device ops and host syncs per frame
    cfg, env, sc = bench_cases.default_case(device=dev)
    pts, msk, ts = headline_frames(sc, cfg.caps.n_max_points, range(8))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, msk, ts))
    trackers = {dt: Tracker(cfg.replace(dtype=dt), dev) for dt in ("float32", "float64")}
    for turn, dt in enumerate(("float32", "float64", "float64", "float32")):
        tr = trackers[dt]
        step, multi = tr.bind_env(env), tr.bind_env_multi(env)

        def one():
            st = tr.init_state()
            for i in range(8):
                st, _ = step(st, Frame(P[i], M[i], T[i]))

        def eight():
            multi(tr.init_state(), Frame(P, M, T))

        ms1, ms8 = cuda_ms(one, 2) / 8, cuda_ms(eight, 2) / 8
        counts = ""
        if turn < 2:
            (o1, s1), (o8, s8_) = trace_counts(one, 8), trace_counts(eight, 8)
            counts = (f"; device ops per frame {o1:.2f} / {o8:.2f}; host syncs per frame "
                      f"{s1:.3f} / {s8_:.3f}")
        log(f"[5 timing] {smi}: G {dt} (turn {turn + 1} of f32, f64, f64, f32) bind_env "
            f"{ms1:.4f} ms/frame, bind_env_multi S=8 {ms8:.4f} ms/frame{counts}")


# ---------------------------------------------------------------------------
# slice 15: the learning mode (K13)
# ---------------------------------------------------------------------------
K13_SHAPES = (  # (label, A problems, B windows, T steps, mask, logLengthScale per problem)
    ("headline node", 2, 3, 39, "all", None),
    ("tune default", 1, 60, 9, "all", None),
    ("wide node", 2, 1024, 39, "all", None),
    ("wide tune", 1, 4096, 9, "all", None),
    ("one window", 1, 1, 39, "all", None),
    ("half mask", 2, 64, 39, "half", None),
    ("edges", 2, 8, 5, "all", (-10.0, 10.0)),
    ("W + 1", 2, 33, 39, "all", None),         # one window past a CTA's 32
    ("nine CTAs", 2, 273, 39, "half", None),   # 8 x 32 + 17 windows a problem
)
K13_DT = 0.1
TOL_LEARN_LP = 5e-5    # the node's log-parameters against the golden (tests/
TOL_LEARN_NLL = 1e-3   # test_torch_golden_learning.py: the windows' last bits)
TOL_TUNE = 1e-4 + 1e-9  # tune's records, rounded to 4 decimals


def k13_inputs(rng, dev, a, b, t, mask, lls):
    """(log_params (A, 3), y (A, B, T), mask (A, B)) on the card: the
    config's log-parameters (logLengthScale set per problem where given),
    mean-centred noisy sinusoid windows, every window or every other one."""
    lp = np.tile(np.asarray([-5.5, -3.5, 0.75], np.float32), (a, 1))
    if lls is not None:
        lp[:, 2] = lls
    s = np.arange(t + 1) * K13_DT
    v = 0.5 * np.sin(s * rng.uniform(0.5, 2, (a * b, 1))) + rng.normal(0, 0.05, (a * b, t + 1))
    v = v[:, 1:].reshape(a, b, t)
    y = (v - v.mean(-1, keepdims=True)).astype(np.float32)
    m = np.ones((a, b), bool)
    if mask == "half":
        m[:, ::2] = False
    return tuple(torch.from_numpy(x).to(dev) for x in (lp, y, m))


def k13_ops(lp, b, t) -> int:
    """K13's floating-point operations on these inputs, counted from
    csrc/learning.cu (an FMA two): per problem, the model (~60), the 2 x 2
    and three 4 x 4 expms at this run's Pade orders and squarings, the DARE
    (72 a trip) and three Lyapunov recursions (28 a trip), ~400 of
    gains, then 122 per window step and 12 per window."""
    from multiple_object_tracking_lidar_tpu_torch.models import learning as TL

    def mm(n):
        return n * n * (2 * n - 1)

    def expm(a):
        n = a.shape[-1]
        norm = float(np.abs(a).sum(0).max())
        idx = (norm >= TL.EXPM_CONDS[0]) + (norm >= TL.EXPM_CONDS[1])
        nsq = max(0.0, np.floor(np.log2(norm / TL.EXPM_MAXNORM))) if norm > 0 else 0.0
        if not nsq <= TL.EXPM_MAX_SQUARINGS:
            return n * n + 60
        pade = (mm(n) + 5 * n * n, 2 * mm(n) + 9 * n * n, 3 * mm(n) + 13 * n * n)[idx] + mm(n)
        return 60 + n * n * 3 + pade + 2 * n * n + 8 * n ** 3 // 3 + int(nsq) * mm(n)

    total = 0
    for row in lp.cpu().numpy():
        ssm = TL.matern32_torch(torch.from_numpy(row))
        f = (ssm["F"] * K13_DT).numpy()
        ops = 60 + expm(f) + 100 * 72 + 400
        for j in range(3):
            ff = np.block([[f, np.zeros((2, 2))], [ssm["dF"][j].numpy() * K13_DT, f]])
            ops += expm(ff) + 100 * 28
        total += ops + b * t * 122 + b * 12
    return total


def phase_kernels_slice15(dev, report):
    """K13 against its plain version on the card, bit for bit, at the
    shapes of ``K13_SHAPES`` (the headline node's two axes of 3 windows of
    39 steps, the tune default's 60 windows of 9, 1,024 and 4,096 windows,
    one window, half the mask off, logLengthScale at -10 -- the NaN reset --
    and +10, one window past a CTA's 32, nine CTAs a problem with half the
    mask off); each call one device op (``require_one_op``)."""
    from multiple_object_tracking_lidar_tpu_torch.models import learning as TL
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda

    rng = np.random.default_rng(15)
    report.setdefault("K13", {"max_abs_err": 0.0})
    for label, a, b, t, mask, lls in K13_SHAPES:
        L, Y, M = k13_inputs(rng, dev, a, b, t, mask, lls)
        fk = lambda L=L, Y=Y, M=M: learning_cuda.learning_step_cuda(L, Y, M, K13_DT)  # noqa: E731
        new, nll = fk()
        pn, pl = TL.learning_step_plain(L, Y, M, K13_DT)
        if not (equal(npy(new), npy(pn)) and equal(npy(nll), npy(pl))):
            fail(f"K13 {label} (A={a}, B={b}, T={t}): {npy(new).tolist()} {npy(nll).tolist()} "
                 f"vs plain {npy(pn).tolist()} {npy(pl).tolist()}")
        if lls is not None and not (np.isnan(npy(nll)[0]) and npy(new)[0].tolist() == [-5.5, 0, 0]
                                    and abs(npy(new)[1, 2]) == 10.0):
            fail(f"K13 edges: {npy(new).tolist()} {npy(nll).tolist()} (NaN reset at -10, "
                 "the clamp at +10)")
        us, ops, whole = one_op_profile(fk, 20)
        require_one_op(f"K13 {label}", ops, whole)
        log(f"[3 K13] {label} (A={a}, B={b}, T={t}): bit for bit the plain version; device "
            f"{us:.2f} us in {ops:g} op per call; NLL {npy(nll).tolist()}")


LEARN_FIELDS = ("update_frame", "log_params", "nll_history")   # a learning golden's own


@contextlib.contextmanager
def no_plain_learning_step():
    """Within it, the plain learning step fails the run if called with a
    CUDA tensor: the learning paths on the card launch K13 only."""
    from multiple_object_tracking_lidar_tpu_torch.models import learning as TL

    plain = TL.learning_step_plain

    def card_guard(lp, *args, **kw):
        if lp.device.type != "cpu":
            fail("the plain learning step ran on the card")
        return plain(lp, *args, **kw)

    TL.learning_step_plain = card_guard
    try:
        yield
    finally:
        TL.learning_step_plain = plain


def phase_learning(dev, smi, report):
    """The learning mode on the card, as a user runs it: the headline
    ``TrackerNode`` with ``param_fix=False``, ``learn_period=0.2`` on the 16
    golden frames against tests/golden/torch_learning_headline.npz (frames
    within TOL_DETS / TOL_VEL, the updates at the golden's frames, the
    log-parameters within TOL_LEARN_LP and the NLL within TOL_LEARN_NLL),
    one K13 launch per update and one K4 per frame, K1-K4 as on the
    headline path; then the CLI's ``tune`` at its defaults (``TrackerConfig()``
    on the point list, 60 frames, 30 steps, one K13 launch per step)
    against tests/golden/torch_cli_tune.json within TOL_TUNE.  No plain
    learning step may run on the card (it fails if called with a CUDA
    tensor).  Then the timings: K13 and its plain version in turns (CUDA
    events; the plain version's launches per call from a trace), K13's
    entry of the report with its bound, K13's device us at every shape of
    ``K13_SHAPES`` beside its operations and its chain bound
    (``scripts/micro_torch_learning.py::chain_bound_us``), and the node's
    wall ms per frame with learning on and off in turns, the update by
    piece (``learning_pieces``)."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.models import learning as TL
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    golden = dict(np.load(GOLDEN_LEARNING))
    cfg, _, sc = headline_case(device=dev)
    lcfg = cfg.replace(param_fix=False, learn_period=0.2)
    n = golden["publish"].shape[0]
    with no_plain_learning_step():
        node = TrackerNode(lcfg, dev, keep_outputs=True)
        node.on_map(load_sim_grid())
        frames = [sc.frame(k) for k in range(n)]
        reset_counts()
        upd, lps = [], []
        for k, msg in enumerate(frames):
            n0 = len(node.nll_history)
            node.on_pointcloud(msg)
            if len(node.nll_history) > n0:
                upd.append(k)
                lps.append(np.stack([node.log_params["x"], node.log_params["y"]]))
        torch.cuda.synchronize()
        counts = read_counts()
        got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
        e = compare("learning TrackerNode vs JAX golden", got,
                    {f: v for f, v in golden.items() if f not in LEARN_FIELDS}, TOL_DETS, TOL_VEL)
        if upd != golden["update_frame"].tolist():
            fail(f"learning node updated after frames {upd}, the golden {golden['update_frame']}")
        e_lp = max_err(np.asarray(lps), golden["log_params"])
        e_nll = max_err(np.asarray(node.nll_history), golden["nll_history"])
        if e_lp > TOL_LEARN_LP or e_nll > TOL_LEARN_NLL:
            fail(f"learning node: log_params max abs err {e_lp}, NLL {e_nll}")
        if counts["K13"] != len(upd) or counts["K4"] != n:
            fail(f"learning node: K13 {counts['K13']} launches for {len(upd)} updates, K4 "
                 f"{counts['K4']} for {n} frames")
        log(f"[4 learning] TrackerNode x{n} (headline, param_fix=False, learn_period=0.2): "
            f"{len(upd)} updates after frames {upd}; vs JAX golden max abs err {e}, "
            f"log_params {e_lp}, NLL {e_nll}; launches {counts}")
        require("learning TrackerNode", counts, FAST_PATH + ("K13",), report)

        with open(GOLDEN_TUNE, encoding="utf-8") as fh:
            gt = json.load(fh)
        argv = [os.path.join(HERE, a) if a.endswith(".yaml") else a for a in gt["argv"]]
        reset_counts()
        _, recs, _ = run_cli(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        counts = read_counts()
        ref = gt["records"]
        if [r["step"] for r in recs] != [r["step"] for r in ref]:
            fail(f"tune printed steps {[r['step'] for r in recs]}")
        e_t = max(abs(a[k] - b[k]) for a, b in zip(recs, ref)
                  for k in ("nll", "logMagnSigma2", "logLengthScale"))
        if e_t > TOL_TUNE:
            fail(f"tune vs JAX golden: max abs err {e_t}")
        if counts["K13"] != len(ref):
            fail(f"tune: K13 {counts['K13']} launches for {len(ref)} steps")
        log(f"[4 learning] CLI tune {' '.join(gt['argv'][1:])} (TrackerConfig(), 60 frames, "
            f"{len(ref)} steps): vs JAX golden max abs err {e_t}; last {recs[-1]}; "
            f"launches {counts}")
        require("tune", counts, ("K6f", "K8a", "K3f", "K4", "K13"), report)

    # timings: K13 and its plain version in turns at the node's shape
    rng = np.random.default_rng(150)
    L, Y, M = k13_inputs(rng, dev, 2, 3, 39, "all", None)
    fk = lambda: learning_cuda.learning_step_cuda(L, Y, M, K13_DT)  # noqa: E731
    fp = lambda: TL.learning_step_plain(L, Y, M, K13_DT)  # noqa: E731
    ms_p = cuda_ms(fp, 2)
    ms_k = cuda_ms(fk, 50)
    ms_k2 = cuda_ms(fk, 50)
    ms_p2 = cuda_ms(fp, 2)
    plain_ops, plain_syncs = trace_counts(fp, 1)
    moved = nbytes((L, Y, M)) + nbytes(fk())
    ops = k13_ops(L, 3, 39)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    entry = report["K13"]
    entry["ms"] = min(ms_k, ms_k2)
    entry["plain_ms"] = min(ms_p, ms_p2)
    entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    entry["library_ms"] = None
    log(f"[5 timing] {smi}: K13 (A=2, B=3, T=39, the headline node's update): kernel "
        f"{ms_k:.4f}/{ms_k2:.4f} ms, plain {ms_p:.4f}/{ms_p2:.4f} ms (run plain, kernel, "
        f"kernel, plain; min reported); plain {plain_ops:g} device ops and {plain_syncs:g} "
        f"host syncs per call; bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} "
        f"({moved} bytes, {ops} operations); library call none")
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_learning as mtl

    sm_mhz, sm_max = (float(x) for x in mtl.smi("clocks.sm,clocks.max.sm").split(","))
    for label, a, b, t, mask, lls in K13_SHAPES:
        La, Ya, Ma = k13_inputs(rng, dev, a, b, t, mask, lls)
        us, n_ops, whole = one_op_profile(
            lambda: learning_cuda.learning_step_cuda(La, Ya, Ma, K13_DT), 20)
        require_one_op(f"K13 {label}", n_ops, whole)
        log(f"[5 timing] {smi}: K13 {label} (A={a}, B={b}, T={t}) device {us:.2f} us per "
            f"launch, {n_ops:g} op; {k13_ops(La, b, t)} operations; chain bound "
            f"{mtl.chain_bound_us(t, sm_max):.2f} us ({mtl.chain_ops(t)} dependent ops at "
            f"{sm_max:g} MHz; SM clock read {sm_mhz:g} MHz)")
    learning_pieces(dev, smi, cfg, lcfg, sc)


def learning_pieces(dev, smi, cfg, lcfg, sc, n: int = 48):
    """The headline node's wall ms per frame over ``n`` scenario frames,
    learning on and off in turns (on, off, off, on), p50 / p99 on the update
    frames (those after which an on turn learned) and on the other frames;
    and on the on turns each update by piece, by wrapping the node's own
    callables: the window copy (``_maybe_learn`` up to its learning step:
    ``alive`` and ``window`` to the host and the windows' upload), the host
    windows (``velocity_windows``, both axes), K13 (``learning_step_stacked``
    from its launch to a synchronise: new and nll ready for the host),
    ``Tracker.compute_gains`` (host f64), the swap (the rest of ``_set_gains``: the gains to the device) and the rest
    of the update (new and nll to the host)."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime import node as node_mod
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    frames = [sc.frame(k) for k in range(n)]
    cur: dict = {}
    o_learn, o_step = TrackerNode._maybe_learn, node_mod.learning_step_stacked
    o_gains, o_set = Tracker.compute_gains, TrackerNode._set_gains
    o_windows = node_mod.velocity_windows

    def p_learn(self, t):
        cur["enter"] = time.perf_counter()
        cur["windows"] = 0.0
        o_learn(self, t)
        cur["exit"] = time.perf_counter()

    def p_windows(*args, **kw):
        t0 = time.perf_counter()
        out = o_windows(*args, **kw)
        cur["windows"] += time.perf_counter() - t0
        return out

    def p_step(*args, **kw):
        cur["call"] = time.perf_counter()
        out = o_step(*args, **kw)
        torch.cuda.synchronize()
        cur["k13"] = time.perf_counter() - cur["call"]
        return out

    def p_gains(*args, **kw):
        t0 = time.perf_counter()
        out = o_gains(*args, **kw)
        cur["gains"] = time.perf_counter() - t0
        return out

    def p_set(self):
        t0 = time.perf_counter()
        o_set(self)
        cur["set"] = time.perf_counter() - t0

    def pct(x, q):
        return float(np.percentile(np.asarray(x), q)) if len(x) else float("nan")

    upd_frames = None
    for turn, on in enumerate((True, False, False, True)):
        TrackerNode._maybe_learn, node_mod.learning_step_stacked = p_learn, p_step
        Tracker.compute_gains, TrackerNode._set_gains = staticmethod(p_gains), p_set
        node_mod.velocity_windows = p_windows
        try:
            node = TrackerNode(lcfg if on else cfg, dev)
            node.on_map(load_sim_grid())
            wall, upd, pieces = [], [], []
            for k, msg in enumerate(frames):
                cur.clear()
                t0 = time.perf_counter()
                node.on_pointcloud(msg)
                wall.append(1e3 * (time.perf_counter() - t0))
                if "call" in cur:
                    upd.append(k)
                    ms = {key: 1e3 * cur[key] for key in ("k13", "gains", "windows")}
                    ms["copy"] = 1e3 * (cur["call"] - cur["enter"]) - ms["windows"]
                    ms["swap"] = 1e3 * cur["set"] - ms["gains"]
                    ms["update"] = 1e3 * (cur["exit"] - cur["enter"])
                    ms["rest"] = (ms["update"] - ms["copy"] - ms["windows"] - ms["k13"]
                                  - 1e3 * cur["set"])
                    pieces.append(ms)
        finally:
            TrackerNode._maybe_learn, node_mod.learning_step_stacked = o_learn, o_step
            Tracker.compute_gains, TrackerNode._set_gains = staticmethod(o_gains), o_set
            node_mod.velocity_windows = o_windows
        if on and upd_frames is None:
            upd_frames = set(upd)
        w_upd = [x for k, x in enumerate(wall) if k >= 2 and k in upd_frames]
        w_oth = [x for k, x in enumerate(wall) if k >= 2 and k not in upd_frames]
        log(f"[5 timing] {smi}: headline TrackerNode {cfg.dtype} learning "
            f"{'on ' if on else 'off'} (turn "
            f"{turn + 1} of on, off, off, on; {n} frames, {len(upd)} updates): wall ms/frame "
            f"on the update frames p50 {pct(w_upd, 50):.4f} p99 {pct(w_upd, 99):.4f} "
            f"({len(w_upd)} frames), on the others p50 {pct(w_oth, 50):.4f} p99 "
            f"{pct(w_oth, 99):.4f} ({len(w_oth)}), all p50 {pct(wall[2:], 50):.4f} p99 "
            f"{pct(wall[2:], 99):.4f}")
        if pieces:
            parts = ", ".join(
                f"{key} p50 {pct([p[key] for p in pieces], 50):.4f} p99 "
                f"{pct([p[key] for p in pieces], 99):.4f}"
                for key in ("update", "copy", "windows", "k13", "gains", "swap", "rest"))
            log(f"[5 timing] {smi}: {cfg.dtype} learning update by piece (turn {turn + 1}, "
                f"{len(pieces)} updates), ms: {parts}")


def phase_half_learning(dev, smi, report):
    """The learning mode and ``tune`` under bf16 and f16 on the card, as a
    user runs them: the headline ``TrackerNode`` with ``param_fix=False``,
    ``learn_period=0.2`` and the half dtype over the 16 golden frames
    against tests/golden/torch_{bf16,f16}_learning_headline.npz, bit for
    bit (every frame's fields, the update frames, the log-parameters and
    the NLL: the windows are the JAX node's, ``velocity_windows``, and K13
    is the JAX step's to the last bit); one K13 launch per update, one K4
    half build per frame, the half builds of K2 and K3f and no other build
    of their families (``require_half``, ``require_builds``), no plain
    route and no plain learning step.  Then the CLI's ``tune`` at its
    defaults with a config file setting the dtype (``TrackerConfig()`` on
    the point list, 60 frames, 30 steps) against
    torch_cli_{bf16,f16}_tune.json, every record exactly, one K13 launch
    per step.  Then the node's wall ms per frame with learning on and off
    in turns, each update by piece (``learning_pieces``: the window copy,
    the host windows, K13, the host gains, the swap)."""
    import tempfile

    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    t0 = time.perf_counter()
    cfg0, _, sc = headline_case(device=dev)
    for htag, dname in HALF_NAMES:
        golden = dict(np.load(GOLDEN_HALF_LEARNING[htag]))
        cfg = cfg0.replace(dtype=dname)
        lcfg = cfg.replace(param_fix=False, learn_period=0.2)
        n = golden["publish"].shape[0]
        tag = f"{htag} learning TrackerNode"
        with no_plain_learning_step():
            node = TrackerNode(lcfg, dev, keep_outputs=True)
            node.on_map(load_sim_grid())
            frames = [sc.frame(k) for k in range(n)]
            reset_counts()
            plain = plain_counters()
            upd, lps = [], []
            for k, msg in enumerate(frames):
                n0 = len(node.nll_history)
                node.on_pointcloud(msg)
                if len(node.nll_history) > n0:
                    upd.append(k)
                    lps.append(np.stack([node.log_params["x"], node.log_params["y"]]))
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([getattr(o, f) for o in node.outputs])
                   for f in node.outputs[0]._fields}
            compare_half(tag, got, {f: v for f, v in golden.items() if f not in LEARN_FIELDS})
            if upd != golden["update_frame"].tolist():
                fail(f"{tag} updated after frames {upd}, the golden {golden['update_frame']}")
            if not (equal(np.asarray(lps), golden["log_params"])
                    and equal(np.asarray(node.nll_history), golden["nll_history"])):
                fail(f"{tag}: log_params max abs err "
                     f"{max_err(np.asarray(lps), golden['log_params'])}, NLL "
                     f"{max_err(np.asarray(node.nll_history), golden['nll_history'])}")
            if counts["K13"] != len(upd) or counts[f"K4 {htag}"] != n:
                fail(f"{tag}: K13 {counts['K13']} launches for {len(upd)} updates, K4 {htag} "
                     f"{counts[f'K4 {htag}']} for {n} frames")
            require_half("learning TrackerNode", counts, htag)
            require_builds(tag, counts, (f"K2 {htag}", f"K3f {htag}", f"K4 {htag}"), plain)
            require(tag, counts, ("K13",), report)
            log(f"[4 half learning] {tag} x{n} (headline, param_fix=False, learn_period=0.2): "
                f"{len(upd)} updates after frames {upd}; the JAX golden bit for bit (frames, "
                f"log_params, NLL); last log_params {lps[-1].tolist()}; launches {counts}")

            with open(GOLDEN_HALF_TUNE[htag], encoding="utf-8") as fh:
                gt = json.load(fh)
            ref = gt["records"]
            with tempfile.TemporaryDirectory() as tmp:
                cfg_file = os.path.join(tmp, "config.yaml")
                with open(cfg_file, "w", encoding="utf-8") as fh:
                    fh.write(gt["argv"][-1][1:-1] + "\n")
                argv = [os.path.join(HERE, a) if a.endswith(".yaml") else a
                        for a in gt["argv"][:-1]] + [cfg_file, "--device", "cuda"]
                reset_counts()
                plain = plain_counters()
                _, recs, _ = run_cli(argv)
                torch.cuda.synchronize()
                counts = read_counts()
            if recs != ref:
                bad = [(a, b) for a, b in zip(recs, ref) if a != b][:3]
                fail(f"{htag} tune vs JAX golden: {len(recs)} records, first differing {bad}")
            if counts["K13"] != len(ref):
                fail(f"{htag} tune: K13 {counts['K13']} launches for {len(ref)} steps")
            require_builds(f"{htag} tune", counts, tuple(f"{k} {htag}" for k in (
                "K6f", "K8a", "K3f", "K4")), plain)
            require(f"{htag} tune", counts, ("K13",), report)
            log(f"[4 half learning] {htag} CLI tune {' '.join(gt['argv'][1:])} (60 frames, "
                f"{len(ref)} steps): the JAX golden's records exactly; last {recs[-1]}; "
                f"launches {counts}")
        learning_pieces(dev, smi, cfg, lcfg, sc)
    log(f"[4 half learning] the half learning node and tune in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# slice 16: every size on the card -- K4 xl, K1 / K5 wide, K14
# ---------------------------------------------------------------------------
GOLDEN_FLOOR = {case: os.path.join(HERE, "tests", "golden", f"torch_{case}_headline.npz")
                for case in ("floor", "floor_hungarian", "floor_f64")}
GOLDEN_TRACK_WIDE = os.path.join(HERE, "tests", "golden", "torch_track_wide.npz")
FLOOR_FIELDS = {"floor": {}, "floor_hungarian": {"association": "hungarian"},
                "floor_f64": {"dtype": "float64"}}
TOL_F64 = (1e-9, 1e-8)   # m, m/s: the f64 goldens' bounds (the JAX package's own)
XL_SHAPES = ((2048, 32), (4096, 64), (64, 256), (1024, 512))   # (K, D) past K4's narrow builds
# of each pair of XL_SHAPES (K > 1,024; D > 128), the one the Hungarian runs
# under (lpf, f32) and (ihgp, f64) take; the other two (filter, dtype) take
# the other
XL_HUNGARIAN_SECOND = ((4096, 64), (1024, 512))
# K4 at K = 64, D = 32, 1 x 1, lpf on track_scene(5, ...): device us per launch, the
# range PR 11's call 11 and PR 13's calls measured (PERF.md section 6, row 4); the
# narrow builds this slice refactored must stay within FACTOR of its top
K4_NARROW_US, K4_NARROW_FACTOR = (62.98, 63.96), 1.15


def floor_report_as(cfg):
    """A floor path's counts in the report: K1 as K1 wide, the double
    builds of K4 xl and K14 under their names, a Hungarian path's K4 xl as
    K4 xl hungarian."""
    xl = "K4 xl hungarian" if cfg.association == "hungarian" else "K4 xl"
    return {"K1": "K1 wide", "K4 xl": xl, "K4 xl f64": xl, "K14 f64": "K14"}


def floor_need(cfg):
    """The kernels a floor path must launch: K1 (wide), K14, K3f and K4 xl,
    their double builds under f64 (K1 stays f32 there: the fast digits)."""
    if cfg.dtype == "float64":
        return ("K1", "K14 f64", "K3f f64", "K4 xl f64")
    return ("K1", "K14", "K3f", "K4 xl")


def plain_counters():
    """The plain routes' counters the card must leave at 0: the digit sums'
    CPU route, and the host syncs of the stencil CC and the plain track
    step."""
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster_grid, track_cuda, voxel_grid

    return {"plain digit sums": voxel_grid.digit_sums_stacked.plain_routes,
            "stencil CC host syncs": cluster_grid.connected_components_grid.host_syncs,
            "plain track step host syncs": track_cuda.track_step_plain.host_syncs}


def require_floor(tag, counts, cfg, report, plain_before, need=None):
    """``require`` for a floor path (its kernels, reported under the floor
    names), no f32 build on an f64 path, and every plain route's counter
    unmoved since ``plain_before``."""
    need = need or floor_need(cfg)
    require(tag, counts, need, report, floor_report_as(cfg))
    if cfg.dtype == "float64":
        require_f64(tag, counts, need)
    after = plain_counters()
    if after != plain_before:
        fail(f"{tag}: a plain route ran on the card: {plain_before} -> {after}")


def two_max_cells_case(dev, rng, s):
    """(points (S, 131,072, 3), mask, kw) on a 968 x 480 x 1 grid of 2 x
    ``max_cells`` = 464,640 cells (0.05 m leaf): uniform points, frame 1
    with 99% of its points in one cell."""
    from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    scene = SceneBounds(x_min=0.0, x_max=967.5 * 0.05, y_min=0.0, y_max=479.5 * 0.05,
                        z_min=0.0, z_max=0.5)
    kw = (scene, 0.05, 1.0)
    if vg.kernel_params(*kw)["n_cells"] != 2 * vg.max_cells():
        fail(f"the 2 x max_cells grid has {vg.kernel_params(*kw)['n_cells']} cells")
    n = 131_072
    pts = np.stack([rng.uniform(-0.1, 48.5, (s, n)), rng.uniform(-0.1, 24.1, (s, n)),
                    rng.uniform(-0.1, 0.6, (s, n))], -1).astype(np.float32)
    pts[1, : 99 * n // 100] = pts[1, 0] + rng.normal(0, 0.005, (99 * n // 100, 3))
    mask = rng.random((s, n)) < 0.97
    return torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev), kw


def floor_cells(dev, fcfg, fenv, P, M):
    """The floor frames' centroids and dynamic cells as the path computes
    them (K1, the finalize, the per-cell static drop), and the plan."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import (
        remove_static, remove_static_cells)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense_cm
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    plan = Tracker(fcfg, dev).plan(fenv)
    if plan.k2:
        fail("the floor's plan took K2 (its grid is past K2's cells)")
    acc, _ = vg.accumulate_fast_stacked(P, M, fcfg.scene, fcfg.voxel_leaf_size, fcfg.leaf_z)
    cent, occ, _ = finalize_dense_cm(acc)
    dyn = (remove_static_cells(cent, occ, plan.env, plan.table) if plan.table is not None
           else remove_static(cent.transpose(-1, -2), occ, plan.env))
    return cent, dyn, plan


def phase_kernels_slice16(dev, report):
    """K4 xl, K1 / K5 wide and K14 against their plain versions on the card,
    bit for bit, one device op per call: K4 xl (greedy and Hungarian, lpf
    and ihgp, f32 and f64) at ``XL_SHAPES`` on ``track_scene``'s frames
    (greedy 1 x 3 and 2 x 1 with a first frame, Hungarian 1 x 1 on its
    gated scene, each (filter, dtype) on one of the two banks K = 2,048 and
    4,096 and on one of the two widths D = 256 and 512: their plain
    versions run every auction phase to its cap, ~5-10 s a frame on the
    card); K1 and K5 (and K1's raw entry) at the floor's 1,119,963
    cells and at 2 x ``max_cells``, S = 1 and 8; K14 on the floor frames'
    own dynamic cells, f32 and f64, converged and at ``max_iters = 1``."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import (
        bench_config, floor_case, track_scene)
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        stencil_cc_cuda as k14, track_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import kernel_offsets
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape, in_dtype
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    t0 = time.perf_counter()
    cfg = bench_config()
    for assoc, name in (("greedy", "K4 xl"), ("hungarian", "K4 xl hungarian")):
        report.setdefault(name, {"max_abs_err": 0.0})
        for pf in ("lpf", "ihgp"):
            for dt in ("float32", "float64"):
                c = cfg.replace(association=assoc, position_filter=pf, dtype=dt)
                gains = Tracker(c, dev).gains_xy
                for K, D in XL_SHAPES:
                    if assoc == "hungarian" and ((K, D) in XL_HUNGARIAN_SECOND) != ((pf, dt) in (
                            ("lpf", "float32"), ("ihgp", "float64"))):
                        # past K4's narrow builds each (filter, dtype) runs once over the
                        # two banks (K > 1,024) and once over the two widths (D > 128)
                        continue
                    cases = ((1, 3, ()), (2, 1, (1,))) if assoc == "greedy" else ((1, 1, ()),)
                    for B, S, fresh in cases:
                        inp = track_scene(16 * K + D + B, c, K, D, B, S, fresh, dev,
                                          assoc == "hungarian")
                        if dt == "float64":
                            inp = f64_track_inputs(inp)
                        check_track_inputs(c, gains, inp, report, name,
                                           f"{pf} {dt} K={K} D={D} {B} x {S}")
                    st, dets, valid, t = inp
                    _, ops, whole = one_op_profile(lambda: track_cuda.track_frames(
                        st, dets, valid, t, config=c, gains_xy=gains), 1)
                    require_one_op(f"{name} {pf} {dt} K={K} D={D}", ops, whole)
        log(f"[3 {name}] every build bit for bit its plain version, one op per call "
            f"({time.perf_counter() - t0:.1f} s so far)")

    fcfg, fenv, fsc = floor_case(dev)
    kw = (fcfg.scene, fcfg.voxel_leaf_size, fcfg.leaf_z)
    pts, msk, _ = headline_frames(fsc, fcfg.caps.n_max_points, range(8))
    P, M = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
    P2, M2, kw2 = two_max_cells_case(dev, np.random.default_rng(16), 8)
    for label, PP, MM, kk in (("floor", P, M, kw), ("2 x max_cells", P2, M2, kw2)):
        nc = vg.kernel_params(*kk)["n_cells"]
        for s in (1, 8):
            for name, fk, fp, groups in (
                    ("K1 wide", vg.accumulate_fast_stacked, vg.accumulate_fast_stacked_plain, 1),
                    ("K5 wide", vg.accumulate_exact_stacked, vg.accumulate_exact_stacked_plain, 3)):
                what = (f"{label} {nc} cells, S={s}, N={PP.shape[1]}, layout (ranges, chunks) "
                        f"{vg.digit_layout(nc, s, groups)}")
                check_pair(report, name, what, lambda: fk(PP[:s], MM[:s], *kk),
                           lambda: fp(PP[:s], MM[:s], *kk))
                us, ops, whole = one_op_profile(lambda: fk(PP[:s], MM[:s], *kk), 10)
                require_one_op(f"{name} {what}", ops, whole)
                log(f"[3 {name}] {what}: device {us:.2f} us per call (torch.profiler)")
        check_pair(report, "K1 wide", f"{label} raw entry (the kernel fleet's), S=2",
                   lambda: vg.accumulate_fast_stacked_raw(PP[:2], MM[:2], *kk),
                   lambda: (vg.fast_digit_sums(PP[:2], MM[:2], *kk), vg._npts(MM[:2], 2)))

    cent, dyn, _ = floor_cells(dev, fcfg, fenv, P, M)
    dims = grid_shape(*kw)
    tol, caps = fcfg.cluster_tolerance, fcfg.caps
    offs = kernel_offsets(dims, tol, kw[1], kw[2])
    for dt in (torch.float32, torch.float64):
        C = cent.to(dt)
        for mi in (caps.label_prop_iters, 1):
            args = (mi, caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
            out = check_pair(
                report, "K14", f"floor {dims} ({len(offs)} offsets), S=8, {dt}, max_iters={mi}",
                lambda: k14.stencil_cc(C, dyn, dims, tol, kw[1], kw[2], *args),
                lambda: k14.stencil_cc_plain(C, dyn, dims, offs, in_dtype(tol * tol, dt), *args))
            us, ops, whole = one_op_profile(
                lambda: k14.stencil_cc(C, dyn, dims, tol, kw[1], kw[2], *args), 5)
            require_one_op(f"K14 {dt} max_iters={mi}", ops, whole)
            log(f"[3 K14] {dt} max_iters={mi}: dynamic cells {npy(dyn.sum(1)).tolist()}, "
                f"n_sweeps {npy(out[1]).tolist()}, saturated {npy(out[2]).tolist()}; device "
                f"{us:.2f} us per call (torch.profiler)")
    log(f"[3 slice 16] kernels checked in {time.perf_counter() - t0:.1f} s")


def track_wide_golden(dev, report):
    """tests/golden/torch_track_wide.npz: each case's inputs
    (``bench_cases.track_wide_inputs``, rebuilt from their seed) through
    ``track_frames`` on the card (K4 xl: K = 2,048 or D = 256), its frames in
    one launch, against the jitted JAX ``track_step``: integers and
    decisions exact, pos / vel within the dtype's tolerances where valid."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import (
        TRACK_WIDE, TRACK_WIDE_L, track_wide_inputs)
    from multiple_object_tracking_lidar_tpu_torch.config import Capacities, TrackerConfig
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackBank, TrackerState

    g = dict(np.load(GOLDEN_TRACK_WIDE))
    for k, d, assoc, dtype in TRACK_WIDE:
        key = f"k{k}_d{d}_{assoc}_{dtype}"
        cfg = TrackerConfig(data_length=TRACK_WIDE_L, association=assoc, dtype=dtype,
                            caps=Capacities(n_max_points=1024, m_max_voxels=256,
                                            m_max_dynamic=128, c_max_clusters=d,
                                            p_max_cluster=32, k_max_tracks=k))
        tracker = Tracker(cfg, dev)
        bank, scal, frames = track_wide_inputs(k, d, assoc, dtype)
        state = TrackerState(
            bank=TrackBank(**{f: torch.from_numpy(v)[None].to(dev) for f, v in bank.items()}),
            **{f: torch.as_tensor(v)[None].to(dev) for f, v in scal.items()})
        dets, valid, t = (torch.from_numpy(np.stack([fr[i] for fr in frames]))[None].to(dev)
                          for i in range(3))
        reset_counts()
        st, o = track_cuda.track_frames(state, dets, valid, t, config=cfg,
                                        gains_xy=tracker.gains_xy)
        torch.cuda.synchronize()
        counts = read_counts()
        xl = "K4 xl f64" if dtype == "float64" else "K4 xl"
        if counts[xl] != 1:
            fail(f"track_wide {key}: launches {counts} (one {xl} expected)")
        got = {f: npy(getattr(o, f))[0] for f in o._fields}
        ref = {f: g[f"{key}/out_{f}"] for f in o._fields}
        e = compare(f"track_wide {key} vs JAX golden", got, ref,
                    *(TOL_F64 if dtype == "float64" else (TOL_DETS, TOL_VEL)))
        for f in ("alive", "obj_id", "birth_seq"):
            if not equal(npy(getattr(st.bank, f))[0], g[f"{key}/bank_{f}"]):
                fail(f"track_wide {key}: the bank's {f} differs from the golden's")
        name = "K4 xl hungarian" if assoc == "hungarian" else "K4 xl"
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry["launches"] = entry.get("launches", 0) + 1
        log(f"[4 floor] track_wide {key}: {ref['publish'].shape[0]} frames in one K4 xl launch "
            f"vs JAX golden max abs err {e}; valid {int(got['valid'].sum())}, registered "
            f"{int(got['new_track'].sum())}, assoc_saturated {got['assoc_saturated'].tolist()}")


def run_floor_bind_env(dev, cfg, env, P, M, T, report, tag):
    """bind_env over the frames on the card, counters reset before and read
    after (the floor's kernels required, no plain route); outputs stacked
    over frames and the final state."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    tracker = Tracker(cfg, dev)
    step = tracker.bind_env(env)
    st = tracker.init_state()
    plain = plain_counters()
    reset_counts()
    rows = []
    for k in range(P.shape[0]):
        st, o = step(st, Frame(P[k], M[k], T[k]))
        rows.append(o)
    torch.cuda.synchronize()
    counts = read_counts()
    require_floor(tag, counts, cfg, report, plain)
    return {f: np.stack([npy(getattr(o, f)) for o in rows]) for f in rows[0]._fields}, st, counts


def phase_floor(dev, report):
    """The floor case (``bench_cases.floor_case``) on the card.  The goldens'
    cut floor (16 m, 328,683 cells) through ``bind_env`` in f32 greedy,
    Hungarian and f64 against tests/golden/torch_floor{,_hungarian,_f64}
    _headline.npz (the map's hash first), and track_wide against its
    golden; then the full floor (30 m, 1,119,963 cells, C = 256, 150
    movers) in f32 greedy, Hungarian and f64: ``bind_env`` over 8 frames,
    ``bind_env_multi`` (S = 8) bit for bit ``bind_env``, ``TrackerNode``
    (k_max_tracks 64 grown by the node; its first frame bit for bit
    ``bind_env``'s), the vmap fleet (``ShardedTracker``, kernel_path "off",
    B = 2 on one card, bit for bit a B = 1 fleet per stream); and the grown
    bank padded to 2,048 slots: greedy bit for bit the 256-slot bank's
    frames, Hungarian against its plain version on the card for a frame.
    Every path launches K1 (wide), K14, K3f and K4 xl (their double builds
    under f64) and moves no plain route's counter."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases as bc
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
        Frame, grow_bank, map_state)

    t0 = time.perf_counter()
    gcfg0, genv, gsc = bc.floor_golden_case(dev)
    map_hash = bc.floor_map_hash(bc.floor_map(bc.FLOOR_SEED, bc.FLOOR_GOLDEN_M))
    n_g = bc.FLOOR_GOLDEN_FRAMES
    pts, msk, ts = headline_frames(gsc, gcfg0.caps.n_max_points, range(n_g))
    GP, GM, GT = (torch.from_numpy(a).to(dev) for a in (pts, msk, ts))
    for case, fields in FLOOR_FIELDS.items():
        golden = dict(np.load(GOLDEN_FLOOR[case]))
        if str(golden.pop("map_hash")) != map_hash:
            fail(f"{case}: the golden's floor map is not the one rebuilt from its seed")
        gcfg = gcfg0.replace(**fields)
        got, _, counts = run_floor_bind_env(dev, gcfg, genv, GP, GM, GT, report, f"{case} (16 m)")
        e = compare(f"{case} (16 m) bind_env vs JAX golden", got, golden,
                    *(TOL_F64 if gcfg.dtype == "float64" else (TOL_DETS, TOL_VEL)))
        log(f"[4 floor] {case} at the goldens' 16 m floor ({n_g} frames): n_clusters "
            f"{got['n_clusters'].tolist()}, valid {got['valid'].sum(1).tolist()}, launches "
            f"{counts}; vs JAX golden max abs err {e}")
    track_wide_golden(dev, report)

    fcfg0, fenv, fsc = bc.floor_case(dev)
    n_f = 8
    pts, msk, ts = headline_frames(fsc, fcfg0.caps.n_max_points, range(n_f + 2))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, msk, ts))
    mesh = make_mesh(1, 1, device=dev)
    for case, fields in FLOOR_FIELDS.items():
        fcfg = fcfg0.replace(**fields)
        tag = f"{case} (30 m)"
        ref, _, counts = run_floor_bind_env(dev, fcfg, fenv, P[:n_f], M[:n_f], T[:n_f], report, tag)
        if not np.isfinite(ref["pos"][ref["valid"]]).all():
            fail(f"{tag}: non-finite positions")
        tracker = Tracker(fcfg, dev)
        multi = tracker.bind_env_multi(fenv)
        plain = plain_counters()
        reset_counts()
        _, om = multi(tracker.init_state(), Frame(P[:n_f], M[:n_f], T[:n_f]))
        torch.cuda.synchronize()
        require_floor(f"{tag} bind_env_multi", read_counts(), fcfg, report, plain)
        compare(f"{tag} bind_env_multi vs bind_env", {f: npy(getattr(om, f)) for f in om._fields},
                ref, 0.0, 0.0)

        node = TrackerNode(fcfg, dev, keep_outputs=True)
        node.on_map(bc.floor_map(bc.FLOOR_SEED, bc.FLOOR_M))
        plain = plain_counters()
        reset_counts()
        for k in range(n_f):
            node.on_pointcloud(fsc.frame(k))
        torch.cuda.synchronize()
        require_floor(f"{tag} TrackerNode", read_counts(), fcfg, report, plain)
        k_node = node.config.caps.k_max_tracks
        first = {f: getattr(node.outputs[0], f)[None] for f in ref}
        compare(f"{tag} TrackerNode frame 0 vs bind_env", first, {f: v[:1] for f, v in ref.items()},
                0.0, 0.0)
        if node.n_growths < 1 or k_node < 256:
            fail(f"{tag} TrackerNode: {node.n_growths} growths to K {k_node} (256 expected)")

        vf2 = ShardedTracker(tracker, mesh, kernel_path="off")
        step2, step1 = vf2.bind_env(fenv), ShardedTracker(tracker, mesh, kernel_path="off").bind_env(fenv)
        s2 = vf2.init_state(2)
        s1 = [vf2.init_state(1), vf2.init_state(1)]
        plain = plain_counters()
        reset_counts()
        for k in range(2):
            s2, o2 = step2(s2, torch.stack([P[k], P[k + 2]]), torch.stack([M[k], M[k + 2]]),
                           torch.stack([T[k], T[k + 2]]))
        torch.cuda.synchronize()
        counts = read_counts()
        need = ("K6f f64" if fcfg.dtype == "float64" else "K6f",) + floor_need(fcfg)[1:]
        require_floor(f"{tag} vmap fleet B=2", counts, fcfg, report, plain, need)
        for s, off in enumerate((0, 2)):
            for k in range(2):
                s1[s], o1 = step1(s1[s], P[k + off][None], M[k + off][None], T[k + off][None])
            bad = [f for f in o2._fields if not equal(npy(getattr(o2, f))[s], npy(getattr(o1, f))[0])]
            if bad:
                fail(f"{tag} vmap fleet: stream {s} differs from a B = 1 fleet in {bad}")
        log(f"[4 floor] {tag}: bind_env x{n_f} n_clusters {ref['n_clusters'].tolist()}, valid "
            f"{ref['valid'].sum(1).tolist()}, overflow {ref['overflow'].tolist()}; "
            f"bind_env_multi S={n_f} bit for bit bind_env; TrackerNode grew {node.n_growths} "
            f"times to K {k_node} (frame 0 bit for bit bind_env's); vmap fleet B=2 x 2 steps "
            f"bit for bit B=1 per stream, launches {counts}; "
            f"({time.perf_counter() - t0:.1f} s so far)")

        if case == "floor_f64":
            continue
        # the grown bank padded to 2,048 slots (K4 xl past 1,024), two more frames
        state = node.state
        big = tracker_for(fcfg, 2048, dev)
        small = tracker_for(fcfg, k_node, dev)
        padded = grow_bank(state, 2048)
        if case == "floor":
            bstep, sstep = big.bind_env(fenv), small.bind_env(fenv)
            plain = plain_counters()
            reset_counts()
            sb, ss = padded, state
            for k in range(n_f, n_f + 2):
                fr = Frame(P[k], M[k], T[k])
                sb, ob = bstep(sb, fr)
                ss, os_ = sstep(ss, fr)
                bad = [f for f in ob._fields if not equal(npy(getattr(ob, f)), npy(getattr(os_, f)))]
                if bad:
                    fail(f"{tag}: the bank padded to 2,048 slots differs from K={k_node} in {bad}")
            torch.cuda.synchronize()
            counts = read_counts()
            require_floor(f"{tag} padded to 2,048", counts, fcfg, report, plain)
            log(f"[4 floor] {tag}: the node's K={k_node} bank padded to 2,048 slots, frames "
                f"{n_f}-{n_f + 1}: bit for bit the K={k_node} bank's; launches {counts}")
        else:
            plan = big.plan(fenv)
            p = big.perceive(Frame(P[n_f:n_f + 1], M[n_f:n_f + 1], T[n_f:n_f + 1]), plan)
            args = (map_state(lambda x: x[None], padded), p.dets[None], p.det_valid[None],
                    torch.as_tensor(p.t).reshape(1, 1))
            check_track_inputs(big.config, big.gains_xy, args, report, "K4 xl hungarian",
                               f"the floor node's K={k_node} bank padded to 2,048, "
                               f"D={fcfg.caps.c_max_clusters}, one frame")
    report["K5 wide"].setdefault("launches", 0)   # exact mode only: no floor path runs it


def tracker_for(cfg, k, dev):
    """A Tracker of ``cfg`` with ``k_max_tracks = k``."""
    import dataclasses

    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    return Tracker(cfg.replace(caps=dataclasses.replace(cfg.caps, k_max_tracks=k)), dev)


def busy_idle(fn, n_frames):
    """(wall ms per frame under the profiler, device busy us per frame, idle
    share) of one run of fn after a warm-up: busy = the union of its device
    intervals (``scripts/profile_torch_slice.py::_busy_us``)."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import profile_torch_slice

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy = profile_torch_slice._busy_us(prof)
    return wall_us / 1e3 / n_frames, busy / n_frames, 1.0 - busy / wall_us


def k4_bytes(inp, out) -> int:
    """K4's bytes: each input read once (the state, the frames), each output
    written once (the state after, the outputs)."""
    st, dets, valid, t = inp
    ns, no = out
    return (nbytes(tuple(st.bank) + tuple(st[1:]) + (dets, valid, t))
            + nbytes(tuple(ns.bank) + tuple(ns[1:]) + tuple(no)))


def phase_timings_slice16(dev, smi, report):
    """The narrow K4 beside its PR 11-13 range (K = 64, D = 32, 1 x 1, lpf:
    the refactor into slot_step must not move it); the kernels' report
    entries (kernel and plain ms by CUDA events in turns, bounds: bytes at
    HBM_BYTES_PER_S, operations at F32_OPS_PER_S, counted from this run's
    data): K4 xl (greedy lpf f32, K = 2,048, D = 32, 1 x 1), K4 xl
    hungarian (the same bank and frame under hungarian: the auction's
    iterations per phase from its plain version), K1 wide and K5 wide (the
    floor, S = 1), K14 (the floor's dynamic cells, S = 1); then the floor
    (30 m, greedy f32 and Hungarian) ``bind_env`` and ``bind_env_multi``
    ms/frame, device ops, host syncs and idle share per frame, and the
    floor bank padded to 2,048 slots under greedy and Hungarian."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases as bc
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        stencil_cc_cuda as k14, track_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import kernel_offsets
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
        EPS, MAX_ITERS, auction_assign_plain, gate_costs)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape, in_dtype
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, grow_bank, map_state

    cfg = bc.bench_config()
    tr = Tracker(cfg, dev)
    inp = bc.track_scene(5, cfg, 64, 32, 1, 1, (), dev)
    us, ops, whole = one_op_profile(
        lambda: track_cuda.track_frames(*inp, config=cfg, gains_xy=tr.gains_xy), 50)
    require_one_op("K4 1 x 1", ops, whole)
    lo, hi = K4_NARROW_US
    log(f"[5 timing] {smi}: K4 (narrow build) K=64 D=32 1 x 1 lpf: device {us:.2f} us per "
        f"launch; PR 11-13's range {lo}-{hi}")
    if us > K4_NARROW_FACTOR * hi:
        fail(f"K4's narrow build at the headline: {us:.2f} us, past {K4_NARROW_FACTOR} x {hi}")

    def entry(name, fk, fp, moved, n_ops, what, plain_reps=2, plain_turns=2):
        ms_p = cuda_ms(fp, plain_reps)
        ms_k = cuda_ms(fk, 5)
        ms_k2 = cuda_ms(fk, 5)
        ms_p2 = cuda_ms(fp, plain_reps) if plain_turns == 2 else ms_p
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
        e = report.setdefault(name, {"max_abs_err": 0.0})
        e["ms"] = min(ms_k, ms_k2)
        e["plain_ms"] = min(ms_p, ms_p2)
        e["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        e["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        e["library_ms"] = None
        turns = "plain, kernel, kernel, plain" if plain_turns == 2 else "plain, kernel, kernel"
        log(f"[5 timing] {smi}: {name} {what}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
            f"{ms_p:.4f}/{ms_p2:.4f} ms ({turns}; min reported); bound "
            f"{e['bound_ms']:.6f} ms by {e['bound_by']} ({moved} bytes, {n_ops} operations); "
            "library call none")

    # K4 xl and K4 xl hungarian at K = 2,048, D = 32, 1 x 1
    for assoc, name in (("greedy", "K4 xl"), ("hungarian", "K4 xl hungarian")):
        c = cfg.replace(association=assoc)
        gains = Tracker(c, dev).gains_xy
        inp = bc.track_scene(2048 * 16 + 32 + 1, c, 2048, 32, 1, 1, (), dev, assoc == "hungarian")
        fk = lambda: track_cuda.track_frames(*inp, config=c, gains_xy=gains)  # noqa: E731
        fp = lambda: track_cuda.track_frames_plain(*inp, config=c, gains_xy=gains)  # noqa: E731
        out = fk()
        n_up = int(npy(out[1].valid).sum())
        v = npy(inp[2])[0, 0]
        scanned = int(np.flatnonzero(v).max()) + 1 if v.any() else 0
        st0 = inp[0]
        n_ops = scanned * 2048 * 6 + n_up * 20 * cfg.data_length
        what = "K=2,048 D=32 1 x 1 (track_scene)"
        if assoc == "hungarian":
            bank = map_state(lambda x: x[0], st0).bank
            cost, feas = gate_costs(bank, inp[1][0, 0], inp[2][0, 0], cfg.id_threshold, True)
            _, _, iters = auction_assign_plain(cost, feas, EPS, cfg.id_threshold, MAX_ITERS,
                                               return_iters=True)
            n = 32 + 2048
            n_ops = sum(iters) * 3 * n + len(iters) * 32 * 2048
            what += f", auction iterations per phase {list(iters)} (cap {MAX_ITERS})"
        entry(name, fk, fp, k4_bytes(inp, out), n_ops, what, 1,
              2 if assoc == "greedy" else 1)   # a plain Hungarian frame here: ~6 s
        us, ops, whole = one_op_profile(fk, 3)
        require_one_op(name, ops, whole)
        log(f"[5 timing] {smi}: {name} {what}: device {us:.2f} us per launch (torch.profiler)")

    # K1 wide, K5 wide and K14 at the floor, S = 1
    fcfg, fenv, fsc = bc.floor_case(dev)
    kw = (fcfg.scene, fcfg.voxel_leaf_size, fcfg.leaf_z)
    pts, msk, ts = headline_frames(fsc, fcfg.caps.n_max_points, range(10))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, msk, ts))
    k1p = vg.kernel_params(*kw)
    nc, kept = k1p["n_cells"], int(vg.kept_cells(P[:1], M[:1], k1p)[0].sum())
    for name, fk, fp, per_pt in (
            ("K1 wide", vg.accumulate_fast_stacked, vg.accumulate_fast_stacked_plain, 20),
            ("K5 wide", vg.accumulate_exact_stacked, vg.accumulate_exact_stacked_plain, 40)):
        out = fk(P[:1], M[:1], *kw)
        entry(name, lambda fk=fk: fk(P[:1], M[:1], *kw), lambda fp=fp: fp(P[:1], M[:1], *kw),
              nbytes((P[:1], M[:1])) + nbytes(out), kept * per_pt,
              f"floor {nc} cells, S=1, N={P.shape[1]} ({kept} kept), layout "
              f"{vg.digit_layout(nc, 1, 1 if name == 'K1 wide' else 3)}")
    cent, dyn, _ = floor_cells(dev, fcfg, fenv, P[:1], M[:1])
    dims = grid_shape(*kw)
    caps, tol = fcfg.caps, fcfg.cluster_tolerance
    offs = kernel_offsets(dims, tol, kw[1], kw[2])
    args = (caps.label_prop_iters, caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
    labels, n_sw, _ = k14.stencil_cc(cent, dyn, dims, tol, kw[1], kw[2], *args)
    n_dyn = int(dyn.sum())
    d3 = dyn.reshape(dims[2], dims[1], dims[0])
    pairs = 0
    for dz, dy, dx in offs:   # dynamic cells with a dynamic neighbour at each offset
        a = d3[max(0, -dz):dims[2] - max(0, dz), max(0, -dy):dims[1] - max(0, dy),
               max(0, -dx):dims[0] - max(0, dx)]
        b = d3[max(0, dz):dims[2] - max(0, -dz), max(0, dy):dims[1] - max(0, -dy),
               max(0, dx):dims[0] - max(0, -dx)]
        pairs += int((a & b).sum())
    iters = int(n_sw[0]) // caps.grid_sweeps_per_iter
    moved = nc + 3 * 4 * n_dyn + nbytes((labels,)) + 8
    n_ops = 8 * pairs + iters * (caps.grid_sweeps_per_iter * pairs + caps.grid_jumps_per_iter * n_dyn)
    entry("K14", lambda: k14.stencil_cc(cent, dyn, dims, tol, kw[1], kw[2], *args),
          lambda: k14.stencil_cc_plain(cent, dyn, dims, offs, in_dtype(tol * tol, cent.dtype),
                                       *args),
          moved, n_ops, f"floor {dims}, S=1, {n_dyn} dynamic cells, {pairs} dynamic neighbour "
          f"pairs, {iters} iterations")

    # the floor end to end (greedy and Hungarian, f32), and the bank padded to 2,048
    for assoc in ("greedy", "hungarian"):
        c = fcfg.replace(association=assoc)
        tr = Tracker(c, dev)
        step, multi = tr.bind_env(fenv), tr.bind_env_multi(fenv)

        def one():
            st = tr.init_state()
            for k in range(8):
                st, _ = step(st, Frame(P[k], M[k], T[k]))

        def eight():
            multi(tr.init_state(), Frame(P[:8], M[:8], T[:8]))

        ms1, ms8 = cuda_ms(one, 2) / 8, cuda_ms(eight, 2) / 8
        (o1, s1), (o8, s8) = trace_counts(one, 8), trace_counts(eight, 8)
        if s1 or s8:
            fail(f"floor {assoc}: host syncs per frame {s1} / {s8} (0 expected)")
        (_, b1, i1), (_, b8, i8) = busy_idle(one, 8), busy_idle(eight, 8)
        log(f"[5 timing] {smi}: floor 30 m {assoc} (1,119,963 cells, C=256, K=64) bind_env "
            f"{ms1:.4f} ms/frame, bind_env_multi S=8 {ms8:.4f} ms/frame; device ops per frame "
            f"{o1:.2f} / {o8:.2f}; host syncs per frame {s1:.3f} / {s8:.3f}; device busy "
            f"{b1:.1f} / {b8:.1f} us per frame, idle share {i1:.3f} / {i8:.3f}")
        st = tr.init_state()
        for k in range(8):
            st, _ = step(st, Frame(P[k], M[k], T[k]))
        big = tracker_for(c, 2048, dev)
        bstep = big.bind_env(fenv)
        padded = grow_bank(st, 2048)

        def two():
            s = padded
            for k in (8, 9):
                s, _ = bstep(s, Frame(P[k], M[k], T[k]))

        ms2 = cuda_ms(two, 1) / 2
        (o2, s2) = trace_counts(two, 2)
        log(f"[5 timing] {smi}: floor {assoc}, the K=64 bank after 8 frames padded to 2,048 "
            f"slots (K4 xl): bind_env {ms2:.4f} ms/frame, {o2:.2f} device ops and {s2:.3f} "
            "host syncs per frame")


# ---------------------------------------------------------------------------
# slice 17: the auction and K14 redesigned
# ---------------------------------------------------------------------------
def net_tie_costs(d=8, k=24):
    """(cost, feasible): costs 0.3 + j * 2^-22, exact in f32, so bids differ
    by less than an ulp of the dummy nets and distinct prices round to one
    net (the first index, not the lower price, takes the dummy bid); each
    row gates three columns, the last none (tests/
    test_torch_auction_schedule.py::net_tie_problem)."""
    j = np.arange(d * k).reshape(d, k)
    cost = (np.float32(0.3) + (j % 7).astype(np.float32) * np.float32(2.0**-22)).astype(np.float32)
    feas = np.zeros((d, k), bool)
    for r in range(d - 1):
        feas[r, [(3 * r) % k, (3 * r + 1) % k, (3 * r + 5) % k]] = True
    return cost, feas


def stretch_costs(rng, d, k, density):
    """(cost, feasible): few real rows, many columns, sparse gates and one
    row none: each phase is long runs of dummy-only iterations, cut where a
    dummy bid takes a column a real row holds."""
    cost = rng.uniform(0, 0.6, (d, k)).astype(np.float32)
    feas = (cost < 0.5) & (rng.uniform(size=(d, k)) < density)
    feas[1] = False
    return cost, feas


def net_tie_scene(cfg, K, D, dev):
    """``track_scene``'s gated bank (B = 1, S = 1) with every slot's window
    at x = 0.3 + (k % 7) * 2^-22, y = 2 (k % D) and detection d at (0, 2 d),
    all valid: each detection gates the alive slots k = d (mod D) at costs
    0.3 plus less than an ulp of the dummy nets -- net_tie_costs in K4."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene

    st, dets, valid, t = track_scene(K + D + 17, cfg, K, D, 1, 1, (), dev, True)
    k = torch.arange(K, device=dev)
    w = st.bank.window.clone()
    w[0, :, :, 0] = (0.3 + (k % 7).to(torch.float32) * 2.0**-22)[:, None]
    w[0, :, :, 1] = (2.0 * (k % D)).to(torch.float32)[:, None]
    dets = dets.clone()
    dets[0, 0, :, 0] = 0.0
    dets[0, 0, :, 1] = 2.0 * torch.arange(D, device=dev, dtype=torch.float32)
    valid = torch.ones_like(valid)
    return st._replace(bank=st.bank._replace(window=w)), dets, valid, t


def k14_grid_frames(rng, dims, s, leaf=0.05, leaf_z=1.0):
    """(cent (S, 3, n) f32, dyn (S, n) bool) on a grid of ``dims``: blobs of
    dynamic cells (a few thousand a frame) with centroids jittered inside
    their cells, and dynamic cells on the grid's edges."""
    gx, gy, gz = dims
    n = gx * gy * gz
    lin = np.arange(n)
    ix, iy, iz = lin % gx, (lin // gx) % gy, lin // (gx * gy)
    cents, dyns = [], []
    for _ in range(s):
        cent = np.stack([(ix + rng.uniform(0.1, 0.9, n)) * leaf,
                         (iy + rng.uniform(0.1, 0.9, n)) * leaf,
                         (iz + rng.uniform(0.1, 0.9, n)) * leaf_z]).astype(np.float32)
        dyn = np.zeros(n, bool)
        for _ in range(60):
            cx, cy, r = rng.integers(0, gx), rng.integers(0, gy), int(rng.integers(1, 7))
            lo_x, hi_x = max(0, cx - r), min(gx, cx + r + 1)
            lo_y, hi_y = max(0, cy - r), min(gy, cy + r + 1)
            for y in range(lo_y, hi_y):
                row = y * gx + np.arange(lo_x, hi_x)
                for z in range(gz):
                    dyn[row + z * gx * gy] |= rng.random(hi_x - lo_x) < 0.6
        dyn |= ((ix == 0) | (ix == gx - 1)) & (iy < 4)
        cents.append(cent)
        dyns.append(dyn)
    return np.stack(cents), np.stack(dyns)


def phase_kernels_slice17(dev, report):
    """The redesigned auction and K14 against their plain versions on the
    card, bit for bit.  The auction (one device function in every build):
    K12 on the net-tie problem and on long dummy-only stretches cut by
    real-row evictions (D = 8, K = 300: past 256 columns; converged and
    capped); K4's narrow Hungarian builds (f32 and f64, lpf and ihgp, 128
    and 1,024 lanes) and K4 xl (lpf f32, ihgp f64, at K = 64, D = 256) on
    the net-tie scene.  K14 at 232,336 cells (one row past K1's 16 ranges)
    and 464,640 (2 x max_cells): S = 1 f32 and S = 8 f64 converged, S = 8
    f32 at max_iters = 1, one device op per call; at the floor S = 1 every
    cluster size (1-16 CTAs) gives the plain version's outputs."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import bench_config, floor_case
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda, stencil_cc_cuda as k14
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import kernel_offsets
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import auction_assign_plain
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape, in_dtype
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    t0 = time.perf_counter()
    rng = np.random.default_rng(1717)

    def k12(tag, probs, max_iters):
        C = torch.from_numpy(np.stack([q[0] for q in probs])).to(dev)
        F = torch.from_numpy(np.stack([q[1] for q in probs])).to(dev)
        a, sat, it = hungarian_cuda.auction_assign(C, F, 1e-3, 0.5, max_iters, return_iters=True)
        torch.cuda.synchronize()
        ok = True
        for b in range(C.shape[0]):
            pa, ps, pit = auction_assign_plain(C[b], F[b], 1e-3, 0.5, max_iters,
                                               return_iters=True)
            ok = ok and equal(npy(a[b]), npy(pa)) and int(sat[b]) == int(ps)
            ok = ok and npy(it[b]).tolist() == pit
        log(f"[3 K12 slice 17] {tag}: exact={ok} saturated={npy(sat).tolist()} iterations per "
            f"phase {npy(it).tolist()}")
        if not ok:
            fail(f"K12 ({tag}) disagrees with its plain version")
        return npy(sat)

    k12("net ties D=8 K=24, 3 problems", [net_tie_costs()] * 3, 3000)
    stretches = [stretch_costs(rng, 8, 300, 0.01) for _ in range(2)]
    k12("dummy-only stretches D=8 K=300 (past 256 columns)", stretches, 3000)
    if k12("dummy-only stretches D=8 K=300 capped", stretches, 200).min() <= 0:
        fail("K12 at max_iters=200 on K=300 columns did not saturate")

    # K4's narrow Hungarian builds at 128 lanes (K = 64) and 1,024 lanes (K =
    # 288: n = 320, past 256 columns), K4 xl at D = 256, on the net-tie scene
    cfg = bench_config().replace(association="hungarian")
    for pf in ("lpf", "ihgp"):
        for dt in ("float32", "float64"):
            c = cfg.replace(position_filter=pf, dtype=dt)
            gains = Tracker(c, dev).gains_xy
            for K, D, name in ((64, 32, "K4 hungarian"), (288, 32, "K4 hungarian"),
                               (64, 256, "K4 xl hungarian")):
                if name == "K4 xl hungarian" and (pf == "lpf") != (dt == "float32"):
                    continue   # K4 xl: lpf f32 and ihgp f64 (every build: phase_kernels_slice16)
                inp = net_tie_scene(c, K, D, dev)
                if dt == "float64":
                    inp = f64_track_inputs(inp)
                check_track_inputs(c, gains, inp, report, name,
                                   f"{pf} {dt} net-tie scene K={K} D={D} 1 x 1")
    log(f"[3 slice 17] auction builds checked ({time.perf_counter() - t0:.1f} s so far)")

    fcfg, fenv, fsc = floor_case(dev)
    tol, caps = fcfg.cluster_tolerance, fcfg.caps
    args = (caps.label_prop_iters, caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
    for dims in ((14_521, 16, 1), (968, 480, 1)):
        cent, dyn = (torch.from_numpy(a).to(dev) for a in k14_grid_frames(rng, dims, 8))
        offs = kernel_offsets(dims, tol, 0.05, 1.0)
        n = dims[0] * dims[1] * dims[2]
        for dt, s, mi in ((torch.float32, 1, args[0]), (torch.float64, 8, args[0]),
                          (torch.float32, 8, 1)):
            C = cent.to(dt)
            tol2 = in_dtype(tol * tol, dt)
            a = (mi,) + args[1:]
            what = (f"{n} cells {dims} ({len(offs)} offsets, cluster "
                    f"{k14.cluster_size(n, dev)}), S={s}, {dt}, max_iters={mi}")
            out = check_pair(report, "K14", what,
                             lambda: k14.stencil_cc(C[:s], dyn[:s], dims, tol, 0.05, 1.0, *a),
                             lambda: k14.stencil_cc_plain(C[:s], dyn[:s], dims, offs, tol2, *a))
            note = ""
            if s == 8 and mi > 1:
                us, ops, whole = one_op_profile(
                    lambda: k14.stencil_cc(C[:s], dyn[:s], dims, tol, 0.05, 1.0, *a), 5)
                require_one_op(f"K14 {what}", ops, whole)
                note = f"; device {us:.2f} us per call, one op"
            log(f"[3 K14 slice 17] {what}: dynamic cells {npy(dyn[:s].sum(1)).tolist()}, "
                f"n_sweeps {npy(out[1]).tolist()}, saturated {npy(out[2]).tolist()}{note}")
    pts, msk, _ = headline_frames(fsc, fcfg.caps.n_max_points, range(1))
    P, M = torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)
    cent, dyn, _ = floor_cells(dev, fcfg, fenv, P, M)
    kw = (fcfg.scene, fcfg.voxel_leaf_size, fcfg.leaf_z)
    dims = grid_shape(*kw)
    ref = k14.stencil_cc_plain(cent, dyn, dims, kernel_offsets(dims, tol, kw[1], kw[2]),
                               in_dtype(tol * tol, cent.dtype), *args)
    for cl in (1, 2, 4, 8, 16):
        if cl > k14.cluster_size(1 << 30, dev):
            continue
        got = k14.stencil_cc(cent, dyn, dims, tol, kw[1], kw[2], *args, cluster=cl)
        if not all(equal(npy(x), npy(y)) for x, y in zip(got, ref)):
            fail(f"K14 at {cl} CTAs per frame differs from its plain version on the floor")
    log(f"[3 K14 slice 17] the floor {dims}, S=1: every cluster size bit for bit the plain "
        f"version; slice 17 checked in {time.perf_counter() - t0:.1f} s")


HALF_NAMES = (("bf16", "bfloat16"), ("f16", "float16"))
KERNELS = (
    ("K1", "voxel_grid fast-digit histogram + finalize, one launch (cell ranges x point-chunk "
     "clusters)",
     f"{PKG}/csrc/voxel_grid.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1272"),
    ("K1 raw", "K1's histogram alone, int32 digit sums for the fleet's all-reduce "
     "(replaces _v5_stacked_raw :1642 and _v4_stacked_raw :1778)",
     f"{PKG}/csrc/voxel_grid.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1642"),
    ("K1 fin", "K1's finalize alone (no TPU kernel: the jnp finalize_fast_digits)",
     f"{PKG}/csrc/voxel_grid.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1900"),
    ("K2", "fused finalize + static drop + grid CC, one thread-block cluster per frame",
     f"{PKG}/csrc/grid_cc.cu", "multiple_object_tracking_lidar_tpu/ops/grid_pallas.py:288"),
    ("K3", "farthest-pair column stats (its own and the JAX-named entries; no tracking path)",
     f"{PKG}/csrc/centroid.cu", "multiple_object_tracking_lidar_tpu/ops/centroid_pallas.py:415"),
    ("K3f", "the tracking paths' whole circumcenter feature [x, y, 0, t] in one launch (K10's "
     "kernel body; replaces the pair stats kernel and the jnp selection after it)",
     f"{PKG}/csrc/circumcenter.cu", "multiple_object_tracking_lidar_tpu/ops/centroid_pallas.py:456"),
    ("K4", "the whole greedy + LPF track step (decision scan, window updates, chained IHGP "
     "passes, LPF, expiry), one CTA per bank, S frames scanned in order",
     f"{PKG}/csrc/assign.cu", "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188"),
    ("K4 ihgp", "K4 under position_filter=ihgp: an IHGP position pass chained before each "
     "velocity pass (W_pos's weights beside W_vel's in shared memory; timed at K = 64 1 x 1, "
     "launched on the CLI's ihgp run)",
     f"{PKG}/csrc/assign.cu", "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188"),
    ("K4 scan", "K4's decision scan alone (the TPU kernel's function, from the same device "
     "function)", f"{PKG}/csrc/assign.cu",
     "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188"),
    ("K5", "voxel_grid exact two-digit histogram + finalize, one launch (three channel groups of "
     "cell ranges x point-chunk clusters)",
     f"{PKG}/csrc/voxel_exact.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1538"),
    ("K5 raw", "K5's histogram alone, int32 two-digit sums for the fleet's all-reduce "
     "(replaces _v6_stacked_raw :1686 and _v3_stacked_raw :1830)",
     f"{PKG}/csrc/voxel_exact.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1686"),
    ("K5 fin", "K5's finalize alone (no TPU kernel: the jnp finalize_exact_digits)",
     f"{PKG}/csrc/voxel_exact.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1918"),
    ("K6", "voxel_grid bf16x3 sums in ascending point index",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:408"),
    ("K6f", "K6 f32 mode: the point-list scatter-add's sums in ascending point index "
     "(no TPU kernel: an XLA scatter)",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel.py:96"),
    ("K6f keys", "K6 f32 mode's sums over given bins (voxel_downsample_sort's runs: the "
     "unbounded scene's sort downsample, O(N) memory; no TPU kernel: an XLA scatter-add)",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel.py:197"),
    ("K6f keys f64", "K6f keys' double build (f64 points, the sums in f64)",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel.py:197"),
    ("K6f G", "K6 f32 mode at configuration G's grid (193,536 cells, N = 131,072; timed at "
     "S = 8, launched on G's path)",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel.py:96"),
    ("K7", "segmented prefix totals over sorted rows, read through the sort's permutation, one "
     "launch (the carry a chained scan)",
     f"{PKG}/csrc/segsum.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_pallas.py:316"),
    ("K8", "all-pairs fixed-radius connected components, one launch: a thread-block cluster per "
     "frame, adjacency bits in shared memory, Jacobi sweeps over distributed shared memory",
     f"{PKG}/csrc/cluster_cc.cu", "multiple_object_tracking_lidar_tpu/ops/cluster_pallas.py:96"),
    ("K8a", "K8's adjacency stage alone (the same kernel body without the sweeps): the bool "
     "(M, M) matrix the jnp CC sweeps (configurations D, E, G)",
     f"{PKG}/csrc/cluster_cc.cu", "multiple_object_tracking_lidar_tpu/ops/cluster_pallas.py:96"),
    ("K9", "segmented prefix totals over (N, 4) rows, 2048-row blocks, one launch: K7's kernel "
     "body over 16-byte rows (the carry a chained scan; below 2048 rows one block of any N)",
     f"{PKG}/csrc/segsum.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_pallas.py:69"),
    ("K10", "the whole circumcenter per cluster slot (farthest pair, line scan, determinant)",
     f"{PKG}/csrc/circumcenter.cu", "multiple_object_tracking_lidar_tpu/ops/centroid_pallas.py:124"),
    ("K6 keys", "K6's key entry: bf16x3 sums from precomputed grid indices",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:2020"),
    ("K1-cm", "K1 reading (S, 3, N) channel-major points (the accumulator probes' layout)",
     f"{PKG}/csrc/voxel_grid.cu", "scripts/micro_acc_v7.py:109"),
    ("K1-cm raw", "K1-cm's histogram alone (make_v5_stacked's layout)",
     f"{PKG}/csrc/voxel_grid.cu", "scripts/micro_acc_v5.py:276"),
    ("K4 wide", "K4 on a bank grown past the TPU kernel's 128 slots (one CTA of up to 1,024 "
     "lanes; timed at K = 1,024, launched on the path at K = 256)",
     f"{PKG}/csrc/assign.cu", "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188"),
    ("K4 hungarian", "K4 under association=hungarian: the eps-scaling auction (one warp, "
     "auction.cuh, the cost rebuilt from the detections and the slots' last x / y) and the "
     "Hungarian registrations in place of the greedy scan (timed at K = 64 1 x 1 on a gated "
     "scene; launched on the headline and dense scenes' hungarian paths)",
     f"{PKG}/csrc/assign.cu", "multiple_object_tracking_lidar_tpu/ops/hungarian.py:139"),
    ("K12", "the Hungarian auction alone on given (D, K) cost matrices, one warp per problem "
     "(K4's Hungarian stage's device function: the column summaries kept per lane, the "
     "iterations with no real row unassigned applied without keys, atomics or lists; no "
     "tracking path launches it)",
     f"{PKG}/csrc/auction.cu", "multiple_object_tracking_lidar_tpu/ops/hungarian.py:34"),
    ("K2 f64", "K2's double build (dtype=float64): f64 finalize, the static drop on the "
     "centroid rounded to f32, the stencil's d^2 as fma(dz, dz, fma(dx, dx, dy * dy)) in f64",
     f"{PKG}/csrc/grid_cc.cu", "multiple_object_tracking_lidar_tpu/ops/grid_pallas.py:288"),
    ("K3f f64", "K3f's double build (dtype=float64): the circumcenter of f64 member tables, "
     "the mean a sequential f64 sum",
     f"{PKG}/csrc/circumcenter.cu", "multiple_object_tracking_lidar_tpu/ops/centroid_pallas.py:456"),
    ("K4 f64", "K4's greedy double builds (dtype=float64, lpf and ihgp): the whole track step "
     "in f64", f"{PKG}/csrc/assign.cu",
     "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188"),
    ("K4 hungarian f64", "K4's Hungarian double builds (dtype=float64): the auction in f64, "
     "each column's winner by a 64-bit atomicMax of the bid then an atomicMin of the row, its "
     "tables in dynamic shared memory", f"{PKG}/csrc/assign.cu", "multiple_object_tracking_lidar_tpu/ops/hungarian.py:139"),
    ("K6f f64", "K6f's double build (dtype=float64): the point list's scatter sums and the "
     "exact route's in f64, ascending point index, the cells from the points rounded to f32 "
     "(timed at the headline's S = 8; launched on G, C and exact in f64)",
     f"{PKG}/csrc/voxel_bf16x3.cu", "multiple_object_tracking_lidar_tpu/ops/voxel.py:96"),
    ("K8a f64", "K8a's double build (dtype=float64): the jnp CC's f64 adjacency, the 32-row "
     "tree sum and the FMA chains in f64 against the f64 tol * tol, the frame in shared memory "
     "up to 4,096 rows (timed at G's M = 2,048, S = 8; launched on G and E in f64)",
     f"{PKG}/csrc/cluster_cc.cu", "multiple_object_tracking_lidar_tpu/ops/cluster_pallas.py:96"),
    ("K2 f64 f32-sums", "K2's double build fed f32 sums (voxel_mode=runs under dtype=float64): "
     "the f32 finalize and static drop, the centroid widened, the stencil's d^2 in f64",
     f"{PKG}/csrc/grid_cc.cu", "multiple_object_tracking_lidar_tpu/ops/grid_pallas.py:288"),
    ("K13", "one SGD step of the IHGP hyperparameter learning for A stacked problems, CTAs of "
     "32 windows: the model, JAX's f32 expm, the 100-trip DARE (its divisions on two lanes) "
     "beside three Van Loan expms, three Lyapunov recursions, then per block of steps the "
     "windows' recursions, their divisions over all threads and the sums in turn, the last "
     "CTA's sum over chunks by an integer ticket, the update (timed at the headline node's "
     "2 x 3 windows of 39 steps; launched on the learning node and tune)",
     f"{PKG}/csrc/learning.cu", "multiple_object_tracking_lidar_tpu/models/learning.py:121"),
    ("K4 xl", "K4 past its narrow builds (K > 1,024 slots or D > 128 detections): lane t owns "
     "slots t, t + 1,024, ...; the slots' summaries, the decisions and the detection flags in "
     "device memory; every reduction over a lane's own slots first, then K4's (timed at K = "
     "2,048, D = 32, 1 x 1; launched on the floor paths at D = 256 and K = 64-2,048, f32 and "
     "f64)", f"{PKG}/csrc/assign.cu",
     "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188"),
    ("K4 xl hungarian", "K4 xl under association=hungarian: the auction on n = D + K columns, "
     "its tables sized at run time (shared memory while they fit, device memory past that), "
     "the cost rebuilt, the registrations by rank in slot order (timed at K = 2,048, D = 32, "
     "1 x 1; launched on the floor's hungarian paths)", f"{PKG}/csrc/assign.cu",
     "multiple_object_tracking_lidar_tpu/ops/hungarian.py:139"),
    ("K1 wide", "K1 past 232,320 cells: more cell ranges (a power of two), each CTA reading "
     "every point of its frame and keeping its own range in shared memory, one launch (timed "
     "at the floor's 1,119,963 cells, S = 1; launched on every floor path)",
     f"{PKG}/csrc/voxel_grid.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1272"),
    ("K5 wide", "K5 past 232,320 cells, K1 wide's layout over its three channel groups "
     "(exact mode only: checked and timed at the floor's grid, no floor path launches it)",
     f"{PKG}/csrc/voxel_exact.cu", "multiple_object_tracking_lidar_tpu/ops/voxel_grid.py:1538"),
    ("K14", "the dense grid's stencil CC (grid_cc=jnp, no per-cell table, past K2's cells): one "
     "thread-block cluster of up to 16 CTAs per frame, the flags read in 16-byte chunks and "
     "the dynamic cells listed across the cluster, one warp per cell's adjacency words (lane b "
     "tests offset 32 w + b), Jacobi sweeps and pointer jumps split over the CTAs between "
     "cluster barriers, the frame's vote in distributed shared memory, no host sync; f32 and "
     "f64 builds (no TPU kernel: the JAX jnp connected_components_grid)",
     f"{PKG}/csrc/stencil_cc.cu",
     "multiple_object_tracking_lidar_tpu/ops/cluster_grid.py:60"),
    ("K11", "batched transpose of 32-bit words: the (S, N, 3) -> (S, 3, N) points K1-cm reads "
     "(4-row groups, 16-byte loads and stores, no shared memory), and the probes' (1, B) -> "
     "(B, 1) int32 row (a copy) and (16, 128) tile",
     f"{PKG}/csrc/transpose.cu", "scripts/micro_transpose.py:49"),
    *((f"K2 {h}", f"K2's {h} build (dtype={n}): the half sums' finalize (an f32 division "
       "rounded), the static drop on the centroid widened, the stencil's d^2 in the half dtype "
       "as XLA's CPU code computes it", f"{PKG}/csrc/grid_cc.cu",
       "multiple_object_tracking_lidar_tpu/ops/grid_pallas.py:288") for h, n in HALF_NAMES),
    *((f"K14 {h}", f"K14's {h} build (dtype={n}, grid_cc=jnp): the stencil CC on half "
       "centroids, d^2 in the half dtype (no TPU kernel: the JAX jnp "
       "connected_components_grid)", f"{PKG}/csrc/stencil_cc.cu",
       "multiple_object_tracking_lidar_tpu/ops/cluster_grid.py:60") for h, n in HALF_NAMES),
    *((f"K3f {h}", f"K3f's {h} build (dtype={n}): the JAX half route's circumcenter (the "
       "jnp table route: member mean, gram d2, line scan, determinant; one CTA per slot)",
       f"{PKG}/csrc/circumcenter.cu",
       "multiple_object_tracking_lidar_tpu/ops/centroid_pallas.py:456") for h, n in HALF_NAMES),
    *((f"K4 {h}", f"K4's greedy {h} builds (dtype={n}, lpf and ihgp): the whole track step "
       "with every op rounded to the half dtype, the smoother's sums in f32", f"{PKG}/csrc/assign.cu",
       "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188") for h, n in HALF_NAMES),
    *((f"K4 xl {h}", f"K4 xl's greedy {h} builds (dtype={n}): the half track step past "
       "1,024 slots or 128 detections", f"{PKG}/csrc/assign.cu",
       "multiple_object_tracking_lidar_tpu/ops/assign_pallas.py:188") for h, n in HALF_NAMES),
    *((f"K6f {h}", f"K6f's {h} build (dtype={n}): the point list's scatter sums in the half "
       "dtype, ascending point index, every add rounded, the count stopping at 2^p; the cells "
       "from the points rounded to the half dtype (timed at the headline's S = 8; launched on "
       "C, D, G and the dense grid in half)", f"{PKG}/csrc/voxel_bf16x3.cu",
       "multiple_object_tracking_lidar_tpu/ops/voxel.py:96") for h, n in HALF_NAMES),
    *((f"K8a {h}", f"K8a's {h} build (dtype={n}): the jnp CC's half adjacency -- the 32-row "
       "tree sum in f32 rounded, half centring, sq and gram as f32 sums rounded once, d2 per "
       "op -- on half rows, the f32 build's frame bounds (timed at G's M = 2,048, S = 8; "
       "launched on D, E and G in half)", f"{PKG}/csrc/cluster_cc.cu",
       "multiple_object_tracking_lidar_tpu/ops/cluster_pallas.py:96") for h, n in HALF_NAMES),
    *((f"K2 {h} f32-sums", f"K2's {h} build fed f32 sums (voxel_mode=runs under dtype={n}): "
       "the f32 finalize and static drop, the centroid rounded to the half dtype, the "
       "stencil's d^2 in it", f"{PKG}/csrc/grid_cc.cu",
       "multiple_object_tracking_lidar_tpu/ops/grid_pallas.py:288") for h, n in HALF_NAMES),
    ("K3f table", "K3f's f32 table build: the half builds' body (the JAX jnp _one_cluster: "
     "member mean, gram d2, line scan, determinant) on f32 values with XLA's f32 FMAs, the "
     "runs' point list's circumcenter under bf16 / f16 before its cast (timed on 8 sorted "
     "lists of C = 32, P = 384; launched on F in half)", f"{PKG}/csrc/circumcenter.cu",
     "multiple_object_tracking_lidar_tpu/ops/centroid.py:30"),
    *((f"K4 hungarian {h}", f"K4's Hungarian {h} builds (dtype={n}, lpf and ihgp): the gate "
       "cost and the eps-scaling auction on half values (every sum and difference rounded to "
       "the half dtype, _NEG -inf in f16), then the half track step (timed at K = 64 1 x 1 on "
       "a gated scene; launched on the half Hungarian headline and dense scenes' paths)",
       f"{PKG}/csrc/assign.cu", "multiple_object_tracking_lidar_tpu/ops/hungarian.py:139")
      for h, n in HALF_NAMES),
    *((f"K4 xl hungarian {h}", f"K4 xl's Hungarian {h} builds (dtype={n}): the half auction on "
       "tables sized for n = D + K columns past 1,024 slots or 128 detections (timed at K = "
       "2,048, D = 32, 1 x 1; launched on the half Hungarian headline with its bank padded to "
       "2,048 slots)", f"{PKG}/csrc/assign.cu",
       "multiple_object_tracking_lidar_tpu/ops/hungarian.py:139") for h, n in HALF_NAMES),
    *((f"K12 {h}", f"K12's {h} build (dtype={n}): the auction alone on half (D, K) cost "
       "matrices (no tracking path launches it)", f"{PKG}/csrc/auction.cu",
       "multiple_object_tracking_lidar_tpu/ops/hungarian.py:34") for h, n in HALF_NAMES),
)


# ---------------------------------------------------------------------------
# slice 19: the half builds (dtype="bfloat16" / "float16" on the dense grid)
# ---------------------------------------------------------------------------
HALF = (("bf16", torch.bfloat16), ("f16", torch.float16))


def half_track_inputs(inputs, dt):
    """K4's inputs (``track_scene``'s) in a half dtype: the bank's window and
    m0, the detections and the stamps rounded to it."""
    st, dets, valid, t = inputs
    bank = st.bank._replace(window=st.bank.window.to(dt), m0=st.bank.m0.to(dt))
    return st._replace(bank=bank), dets.to(dt), valid, t.to(dt)


def widen_track_inputs(inputs):
    """Half K4 inputs (``half_track_inputs``') widened to f32, exactly: the
    f32 build's scene is the half build's."""
    st, dets, valid, t = inputs
    bank = st.bank._replace(window=st.bank.window.float(), m0=st.bank.m0.float())
    return st._replace(bank=bank), dets.float(), valid, t.float()


def lane_diff(a, b, limit=4):
    """Where two arrays' bits differ: the count and the first lanes as
    (index, a, b), for a failure's message."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind != "f":
        idx = np.argwhere(a != b)
    else:
        u = np.uint32 if a.dtype == np.float32 else np.uint64
        idx = np.argwhere(a.view(u) != b.astype(a.dtype).view(u))
    return len(idx), [(tuple(int(q) for q in i), a[tuple(i)].item(), b[tuple(i)].item())
                      for i in idx[:limit]]


def phase_kernels_slice19(dev, report, cfg):
    """K2, K14, K3f and K4's half builds (bf16, f16) against their plain
    versions on the card, bit for bit: K2 on the headline's 8 frames of K1
    sums rounded to the half dtype (S = 8, and S = 1); K14 on K2's half
    centroids and dynamic cells (the grid_cc="jnp" route); K3f on the
    headline's half member tables and ``k3f_tables``' edge cases in the half
    dtype; K4 (lpf, ihgp) on ``track_scene`` at K = 64 (1 x 1, 1 x 8, 8 x
    1) and 1,024, and K4 xl at K = 2,048.  Then K6f's key entry (f32, f64)
    against its plain version, and ``voxel_downsample_sort`` (the entry
    point launching it) on a headline cloud with far returns against the
    same function on the CPU.  Returns the inputs the timings reuse."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, grid_cuda, stencil_cc_cuda, voxel_grid_cuda)
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    _, env, sc = headline_case(device=dev)
    leaf, leaf_z, tol = cfg.voxel_leaf_size, cfg.leaf_z, cfg.cluster_tolerance
    caps = cfg.caps
    pts, msk, ts = headline_frames(sc, caps.n_max_points, range(8))
    M8 = torch.from_numpy(msk).to(dev)
    K, D = caps.k_max_tracks, caps.c_max_clusters
    keep = {}

    def held(tag, label, got, want):
        """Every output's bits equal, or fail naming the lanes that differ."""
        for i, (x, y) in enumerate(zip(got, want)):
            n_bad, where = lane_diff(npy(x), npy(y))
            if n_bad or x.dtype != y.dtype:
                fail(f"{tag} ({label}) disagrees with its plain version: output {i} "
                     f"{x.dtype}/{y.dtype}, {n_bad} lanes, e.g. {where}")

    for tag, dt in HALF:
        hcfg = cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[tag])
        tracker = Tracker(hcfg, dev)
        plan = tracker.plan(env)
        P8 = torch.from_numpy(pts).to(dev).to(dt).float()     # the points rounded, widened
        T8 = torch.from_numpy(ts).to(dev).to(dt)
        acc32, _ = voxel_grid_cuda.accumulate_fast_stacked(P8, M8, cfg.scene, leaf, leaf_z)
        acc = acc32.to(dt)
        tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
        kw2 = dict(dims=plan.dims, tol=tol, leaf_xy=leaf, leaf_z=leaf_z, kwin=plan.table.k)
        offsets = grid_cuda.kernel_offsets(plan.dims, tol, leaf, leaf_z)
        name = f"K2 {tag}"
        report.setdefault(name, {"max_abs_err": 0.0})
        for label, a in (("the headline's 8 frames", acc), ("one frame", acc[3:4])):
            got = grid_cuda.fused_finalize_static_cc_stacked(a, *tb, **kw2)
            want = grid_cuda.fused_finalize_static_cc_stacked_plain(
                a, *tb, dims=plan.dims, offsets=offsets, kwin=plan.table.k,
                max_sweeps=2 * sum(plan.dims), tol=tol)
            torch.cuda.synchronize()
            err = max_err(npy(got[0]), npy(want[0]))
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
            held(name, label, got, want)
            log(f"[3 {name}] {label}, {acc.shape[2]} cells, {len(offsets)} offsets: "
                f"bit-exact=True dtype={got[0].dtype} iterations={npy(got[3]).tolist()} "
                f"dyn={npy(got[1].sum(1)).tolist()}")
        cent, dyn, labels, n_sw, _ = grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2)
        name = f"K14 {tag}"
        report.setdefault(name, {"max_abs_err": 0.0})
        cc_args = (plan.dims, tol, leaf, leaf_z, caps.label_prop_iters,
                   caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
        got = stencil_cc_cuda.stencil_cc(cent, dyn, *cc_args)
        want = stencil_cc_cuda.stencil_cc_plain(
            cent, dyn, plan.dims, offsets, in_dtype(tol * tol, dt), *cc_args[4:])
        torch.cuda.synchronize()
        held(name, "the headline's 8 frames", got, want)
        log(f"[3 {name}] the headline's 8 frames (K2's {tag} centroids): bit-exact=True "
            f"n_sweeps={npy(got[1]).tolist()} components="
            f"{[len(set(npy(got[0][s]).tolist())) - 1 for s in range(8)]}")
        ctab = cluster_table_grid(labels, n_sw, cent, dyn, plan.dims[0], cfg.min_cluster_size,
                                  cfg.max_cluster_size, caps.c_max_clusters, caps.p_max_cluster)
        mp_h = ctab.mpts.reshape(-1, caps.p_max_cluster, 3).contiguous()
        mm_h = ctab.member_mask.reshape(-1, caps.p_max_cluster).contiguous()
        mp_e, mm_e = k3f_tables(np.random.default_rng(1901), 8, 32, caps.p_max_cluster, dev)
        name = f"K3f {tag}"
        report.setdefault(name, {"max_abs_err": 0.0})
        for label, mp, mm in ((f"the headline's {tag} member tables, S=8 x C=32", mp_h, mm_h),
                              (f"edge-case tables in {tag}, S=8 x C=32", mp_e.to(dt), mm_e)):
            got = centroid_cuda.circumcenter_features(mp, mm, T8)
            want = centroid_cuda.circumcenter_features_half_plain(mp, mm, T8)
            torch.cuda.synchronize()
            err = max_err(npy(got), npy(want))
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
            held(name, label, (got,), (want,))
            log(f"[3 {name}] {label}, {int(mm.any(1).sum())} active slots: bit-exact=True "
                f"max_abs_err={err}")
        gains = tracker.gains_xy
        for pf in ("lpf", "ihgp"):
            c = hcfg.replace(position_filter=pf)
            for k in (K, 1024, 2048):
                d = D if k == K else 128
                cases = (((1, 1, ()), (1, 8, (0,)), (8, 1, (0,))) if k == K
                         else ((1, 1, ()),))
                for i, (b, s, fresh) in enumerate(cases):
                    ins = half_track_inputs(track_scene(1900 + 10 * k + i, cfg, k, d, b, s,
                                                        fresh, dev), dt)
                    check_track_inputs(c, gains, ins, report,
                                       f"K4 xl {tag}" if k > 1024 else f"K4 {tag}",
                                       f"{pf}, K={k} {b} x {s} frames, D={d}, {tag}")
        keep[tag] = {"acc": acc, "acc32": acc32, "tb": tb, "kw2": kw2, "cent": cent,
                     "dyn": dyn, "cc_args": cc_args, "mp": mp_h, "mm": mm_h, "T8": T8,
                     "tracker": tracker, "hcfg": hcfg}
    keep["keys"] = phase_k6f_keys(dev, report, pts[0], msk[0])
    return keep


def phase_k6f_keys(dev, report, pts, msk):
    """K6f's key entry (f32, f64) against its plain version on the card, bit
    for bit, on a headline cloud's points binned by 0.1 m cell run (as
    ``voxel_downsample_sort`` bins them) and on random bins with dropped
    points; then ``voxel_downsample_sort`` on that cloud with far returns
    (a box of ~1e13 cells at its 0.1 m leaf) against the same function on
    the CPU, launching K6f keys once.  Returns the timed inputs."""
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_downsample_sort

    cloud = pts[msk].copy()
    cloud[5] = [9.5e5, -8.25e5, 40.0]                 # far returns
    cloud[9] = [-7.0e5, 6.5e5, -30.0]
    n, m_max = cloud.shape[0], 32768
    p32 = torch.from_numpy(cloud).to(dev)
    q = torch.floor(p32 * np.float32(10.0)).to(torch.int64)
    key = (q[:, 2] - q[:, 2].min()) * 2**48 + (q[:, 1] - q[:, 1].min()) * 2**24 + (
        q[:, 0] - q[:, 0].min())
    _, run = torch.unique(key, return_inverse=True)   # each point's cell, ranked
    rng = torch.Generator(device="cpu").manual_seed(1907)
    rand = torch.randint(-1, 4096, (1, n), generator=rng).to(dev)
    timed = None
    for dt, name in ((torch.float32, "K6f keys"), (torch.float64, "K6f keys f64")):
        report.setdefault(name, {"max_abs_err": 0.0})
        v = p32.to(dt)[None]
        for label, bins, nb in ((f"{n} points by cell run", run[None], m_max),
                                (f"{n} points, random bins, dropped ones", rand, 4096)):
            got = voxel_grid_cuda.accumulate_sums_keys(v, bins, nb)
            want = voxel_grid_cuda.accumulate_sums_keys_plain(v, bins, nb)
            torch.cuda.synchronize()
            n_bad, where = lane_diff(npy(got), npy(want))
            log(f"[3 {name}] {label}, {nb} bins: bit-exact={n_bad == 0} "
                f"bins used {int((npy(want)[0, 3] > 0).sum())}")
            if n_bad:
                fail(f"{name} ({label}) disagrees with its plain version: {n_bad} lanes, "
                     f"e.g. {where}")
        if dt == torch.float32:
            timed = (v, run[None], m_max)
    msk_t = torch.ones(n, dtype=torch.bool, device=dev)
    reset_counts()
    got = [voxel_downsample_sort(p32.to(dt), msk_t, 0.1, 0.1, m_max)
           for dt in (torch.float32, torch.float64)]
    torch.cuda.synchronize()
    counts = read_counts()
    for g, dt in zip(got, (torch.float32, torch.float64)):
        want = voxel_downsample_sort(p32.to(dt).cpu(), msk_t.cpu(), 0.1, 0.1, m_max)
        ok = all(lane_diff(npy(a), npy(b))[0] == 0 for a, b in zip(g, want))
        log(f"[3 K6f keys] voxel_downsample_sort {dt}, {n} points with far returns, leaf "
            f"0.1 m, m_max {m_max}: {int(npy(g[2]))} cells; the CPU's bit for bit: {ok}")
        if not ok:
            fail(f"voxel_downsample_sort {dt} on the card departs from the CPU's")
    log(f"[3 K6f keys] launches {counts['K6f keys']} (f32), {counts['K6f keys f64']} (f64)")
    require("voxel_downsample_sort", counts, ("K6f keys", "K6f keys f64"), report)
    return timed



GOLDEN_HALF = {h: os.path.join(HERE, "tests", "golden", f"torch_{h}_headline.npz")
               for h in ("bf16", "f16")}
GOLDEN_CLI_HALF = {h: os.path.join(HERE, "tests", "golden", f"torch_cli_{h}_headline.json")
                   for h in ("bf16", "f16")}
F32_TAIL = ("K2", "K3f", "K4", "K14", "K4 xl")   # f32 builds no half path may launch


def compare_half(tag, got: dict, ref: dict):
    """The half goldens' contract (tests/test_torch_half.py): every field
    bit for bit (pos / vel on valid lanes)."""
    for f, r in ref.items():
        g, r = np.asarray(got[f]), np.asarray(r)
        if f in ("pos", "vel"):
            g, r = g[ref["valid"]], r[ref["valid"]]
        if not equal(g, r):
            fail(f"{tag}: {f} differs (max abs err {max_err(g, r)})")


def require_half(tag, counts, htag, need=("K2", "K3f", "K4")):
    """Fail a half path's run (its counts, reported by ``require``) unless
    K1 and the ``need`` kernels' ``htag`` builds launched and no f32 or
    f64 build of K2, K3f, K4, K4 xl or K14 did: every half stage has its
    build, none falls back."""
    missing = [k for k in ("K1", *(f"{n} {htag}" for n in need)) if counts[k] <= 0]
    other = [k for k in (*F32_TAIL, *(f"{k} f64" for k in ("K2", "K3f", "K4", "K14")),
                         "K4 xl f64", *(f"{k} {o}" for k in F32_TAIL
                                        for o in ("bf16", "f16") if o != htag))
             if counts.get(k, 0)]
    if missing or other:
        fail(f"the {htag} {tag} path: {missing} not launched, other builds {other} launched: "
             f"{counts}")


def half_frames(dev, sc, n_pts, n):
    pts, msk, ts = headline_frames(sc, n_pts, range(n))
    return tuple(torch.from_numpy(a).to(dev) for a in (pts, msk, ts))


def phase_half(dev, smi, report):
    """The bf16 and f16 headline (``dtype="bfloat16"`` / ``"float16"``, lpf
    and ihgp) through ``bind_env`` (12 frames), ``bind_env_multi`` (S = 8,
    then S = 4), ``TrackerNode`` (12 PointCloud2 frames, the native
    decoder; ``StreamingNode`` publishing bit for bit what it does) and the
    CLI (a config file setting the dtype) against the JAX package's half
    goldens, bit for bit (``compare_half``; the CLI's 4-decimal records
    within ``cli_errors``' bound), each run launching K1 and the half builds of K2,
    K3f and K4 and no other build of them; K14's half build through
    ``grid_cc="jnp"`` and K4 xl's through a bank padded to 2,048 slots, on
    the same goldens; then ms/frame (bind_env over 8 frames, multi S = 8)
    and device ops per frame, f32 / bf16 / f16 in turns."""
    import dataclasses
    import tempfile

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_torch_golden import CLI_CONFIGS, cli_bag

    base, env, sc = bench_cases.headline_case(device=dev)
    n_pts = base.caps.n_max_points
    for htag, dname in HALF_NAMES:
        gold_all = dict(np.load(GOLDEN_HALF[htag]))
        for variant, fields in (("lpf", {}), ("ihgp", {"position_filter": "ihgp"})):
            golden = {k.split("/", 1)[1]: v for k, v in gold_all.items()
                      if k.startswith(variant + "/")}
            n_gold = golden["publish"].shape[0]
            P, M, T = half_frames(dev, sc, n_pts, n_gold)
            report_as = {f"K4 {htag}": f"K4 {htag}"}
            for label, cfg, need in (
                    ("bind_env", base.replace(dtype=dname, **fields), ("K2", "K3f", "K4")),
                    ("bind_env grid_cc=jnp", base.replace(dtype=dname, grid_cc="jnp", **fields),
                     ("K14", "K3f", "K4")),
                    ("bind_env, bank padded to 2,048", base.replace(
                        dtype=dname, caps=dataclasses.replace(base.caps, k_max_tracks=2048),
                        **fields), ("K2", "K3f", "K4 xl"))):
                if variant == "ihgp" and label != "bind_env":
                    continue
                tracker = Tracker(cfg, dev)
                step = tracker.bind_env(env)
                st = tracker.init_state()
                reset_counts()
                rows = []
                for k in range(n_gold):
                    st, o = step(st, Frame(P[k], M[k], T[k]))
                    rows.append([npy(x) for x in o])
                torch.cuda.synchronize()
                counts = read_counts()
                got = {f: np.stack([r[i] for r in rows]) for i, f in enumerate(golden)}
                compare_half(f"{htag} {variant} {label}", got, golden)
                log(f"[4 {htag}] {variant} {label} x{n_gold}: launches {counts}; the JAX "
                    f"golden bit for bit")
                require(f"{htag} {label}", counts, (), report, report_as)
                require_half(label, counts, htag, need)
            cfg = base.replace(dtype=dname, **fields)
            # bind_env_multi: S = 8, then S = 4
            tracker = Tracker(cfg, dev)
            multi = tracker.bind_env_multi(env)
            st = tracker.init_state()
            reset_counts()
            rows = []
            for sl in (slice(0, 8), slice(8, n_gold)):
                st, o = multi(st, Frame(P[sl], M[sl], T[sl]))
                rows.append([npy(x) for x in o])
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.concatenate([r[i] for r in rows]) for i, f in enumerate(golden)}
            compare_half(f"{htag} {variant} bind_env_multi", got, golden)
            log(f"[4 {htag}] {variant} bind_env_multi S=8 + S=4: launches {counts}; the JAX "
                f"golden bit for bit")
            require(f"{htag} bind_env_multi", counts, (), report)
            require_half("bind_env_multi", counts, htag)
            # TrackerNode, the native decoder
            node = TrackerNode(cfg, dev, keep_outputs=True)
            node.on_map(load_sim_grid())
            reset_counts()
            replies = [node.on_pointcloud(sc.frame(k)) for k in range(n_gold)]
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([np.asarray(getattr(o, f)) for o in node.outputs])
                   for f in golden}
            compare_half(f"{htag} {variant} TrackerNode", got, golden)
            log(f"[4 {htag}] {variant} TrackerNode x{n_gold} (decoder {node.decoder}): launches "
                f"{counts}; the JAX golden bit for bit")
            if node.decoder != "native":
                fail(f"the {htag} node decoded with {node.decoder}, not the native decoder")
            require(f"{htag} TrackerNode", counts, (), report)
            require_half("TrackerNode", counts, htag)
            # StreamingNode: what the node publishes, bit for bit
            streamed = []
            snode = StreamingNode(cfg, on_outputs=lambda *r: streamed.append(r), depth=2,
                                  device=dev)
            snode.on_map(load_sim_grid())
            reset_counts()
            for k in range(n_gold):
                snode.submit(sc.frame(k))
            snode.flush()
            counts = read_counts()
            pub = [r for r in replies if r is not None]
            same = len(streamed) == len(pub) and all(
                [o.id for o in a.obstacles] == [o.id for o in b.obstacles]
                and all(np.array_equal(oa.position, ob.position)
                        and np.array_equal(oa.velocity, ob.velocity)
                        for oa, ob in zip(a.obstacles, b.obstacles))
                for (a, _, _), (b, _, _) in zip(streamed, pub))
            log(f"[4 {htag}] {variant} StreamingNode x{n_gold} (depth 2): {len(streamed)} "
                f"publishes, the node's bit for bit: {same}; summary {snode.summary()}")
            if not same or snode.summary()["decoder"] != "native":
                fail(f"the {htag} StreamingNode departs from the node or its decoder")
            require(f"{htag} StreamingNode", counts, (), report)
            require_half("StreamingNode", counts, htag)
        # the CLI with a config file setting the dtype
        with open(GOLDEN_CLI_HALF[htag], encoding="utf-8") as fh:
            gold = json.load(fh)
        with tempfile.TemporaryDirectory() as tmp:
            argv = cli_bag(os.path.join(tmp, "frames.npz"))
            conf = os.path.join(tmp, "config.yaml")
            with open(conf, "w", encoding="utf-8") as fh:
                fh.write(CLI_CONFIGS[f"cli_{htag}"])
            reset_counts()
            _, recs, err_recs = run_cli(argv + ["--config", conf, "--device", "cuda"])
            counts = read_counts()
        errs, worst = cli_errors(recs, gold)
        summary = next(r["summary"] for r in err_recs if "summary" in r)
        log(f"[4 {htag}] CLI run --config <dtype: {dname}>: {len(recs)} records, launches "
            f"{counts}, summary {summary}; vs the JAX CLI golden: "
            f"{errs or 'within tolerance'} (worst pos / vel {worst})")
        if errs:
            fail(f"{htag} CLI: {errs}")
        require(f"{htag} CLI", counts, (), report)
        require_half("CLI", counts, htag)

    # ms/frame and device ops per frame, f32 / bf16 / f16 in turns
    P, M, T = half_frames(dev, sc, n_pts, 8)
    trackers = {d: Tracker(base.replace(dtype=d), dev) for d in ("float32", "bfloat16", "float16")}
    for turn, d in enumerate(("float32", "bfloat16", "float16", "float16", "bfloat16",
                              "float32")):
        tr = trackers[d]
        step, multi = tr.bind_env(env), tr.bind_env_multi(env)

        def one():
            st = tr.init_state()
            for i in range(8):
                st, _ = step(st, Frame(P[i], M[i], T[i]))

        def eight():
            multi(tr.init_state(), Frame(P, M, T))

        ms1, ms8 = cuda_ms(one, 3) / 8, cuda_ms(eight, 3) / 8
        counts = ""
        if turn < 3:
            (o1, s1), (o8, s8) = trace_counts(one, 8), trace_counts(eight, 8)
            counts = (f"; device ops per frame {o1:.2f} / {o8:.2f}; host syncs per frame "
                      f"{s1:.3f} / {s8:.3f}")
        log(f"[5 timing] {smi}: headline {d} (turn {turn + 1} of f32, bf16, f16, f16, bf16, "
            f"f32) bind_env {ms1:.4f} ms/frame, bind_env_multi S=8 {ms8:.4f} ms/frame{counts}")


def phase_timings_slice19(dev, smi, report, keep):
    """Each half build beside the f32 build of the same kernel on the same
    inputs (the f32 inputs the half values widened), device us per call in
    turns (f32, half, half, f32; torch.profiler between marker kernels):
    K2 and K14 at the headline's S = 8 and S = 1, K3f at S = 8 x C = 32, K4
    at K = 64 1 x 1 and 1 x 8 (lpf), K4 xl at K = 2,048; then the report's
    entries (kernel ms and plain ms in turns, both on the card by CUDA
    events, bounds, no library call); K6f's key entry beside index_add."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, grid_cuda, stencil_cc_cuda, track_cuda, voxel_grid_cuda)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype

    def device_us(fn, reps):
        us, ops, _ = one_op_profile(fn, reps)
        return us * ops

    def turns(tag, f32, half, reps):
        a, b = device_us(f32, reps), device_us(half, reps)
        b2, a2 = device_us(half, reps), device_us(f32, reps)
        log(f"[5 timing] {smi}: {tag} device us per call in turns (f32 build, half, half, "
            f"f32 build) {a:.2f}, {b:.2f}, {b2:.2f}, {a2:.2f}: half / f32 "
            f"{min(b, b2) / min(a, a2):.2f}x")

    cfg = keep["bf16"]["hcfg"].replace(dtype="float32")
    K, D = cfg.caps.k_max_tracks, cfg.caps.c_max_clusters
    for htag, dt in HALF:
        k = keep[htag]
        tb, kw2, acc, cc_args = k["tb"], k["kw2"], k["acc"], k["cc_args"]
        acc32 = acc.float()
        for label, sl in (("S=8", slice(0, 8)), ("S=1", slice(3, 4))):
            a32, ah = acc32[sl].contiguous(), acc[sl].contiguous()
            turns(f"K2 {htag} headline {label}",
                  lambda a=a32: grid_cuda.fused_finalize_static_cc_stacked(a, *tb, **kw2),
                  lambda a=ah: grid_cuda.fused_finalize_static_cc_stacked(a, *tb, **kw2), 20)
            c16, dyn = k["cent"][sl].contiguous(), k["dyn"][sl].contiguous()
            c32 = c16.float()
            turns(f"K14 {htag} headline {label}",
                  lambda c=c32, d=dyn: stencil_cc_cuda.stencil_cc(c, d, *cc_args),
                  lambda c=c16, d=dyn: stencil_cc_cuda.stencil_cc(c, d, *cc_args), 20)
        mp, mm, T8 = k["mp"], k["mm"], k["T8"]
        turns(f"K3f {htag} S=8 x C=32, P={mp.shape[1]}",
              lambda: centroid_cuda.circumcenter_features(mp.float(), mm, T8.float()),
              lambda: centroid_cuda.circumcenter_features(mp, mm, T8), 20)
        gains_h = keep[htag]["tracker"].gains_xy
        g32 = {a: ({w: x.float() for w, x in g.items()} if isinstance(g, dict) else g.float())
               for a, g in gains_h.items()}
        hcfg = k["hcfg"]
        for label, kk, d, b, s in (("K = 64 1 x 1", K, D, 1, 1), ("K = 64 1 x 8", K, D, 1, 8),
                                   ("K4 xl K = 2,048 1 x 1", 2048, D, 1, 1)):
            hins = half_track_inputs(track_scene(1950 + kk + s, cfg, kk, d, b, s, (), dev), dt)
            ins = widen_track_inputs(hins)
            f32 = lambda ins=ins: track_cuda.track_frames(*ins, config=cfg, gains_xy=g32)  # noqa
            half = lambda ins=hins, c=hcfg, g=gains_h: track_cuda.track_frames(  # noqa: E731
                *ins, config=c, gains_xy=g)
            turns(f"K4 {htag} {label} (lpf)", f32, half, 10)
            k[f"track {label}"] = (half, hins)

    # the report's entries
    for htag, dt in HALF:
        k = keep[htag]
        tb, kw2, acc, cc_args = k["tb"], k["kw2"], k["acc"], k["cc_args"]
        n = acc.shape[2]
        n_off = len(grid_cuda.kernel_offsets(kw2["dims"], kw2["tol"], kw2["leaf_xy"],
                                             kw2["leaf_z"]))
        outs = grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2)
        iters = int(outs[3].sum())
        cent, dyn = k["cent"], k["dyn"]
        lab = stencil_cc_cuda.stencil_cc(cent, dyn, *cc_args)
        mp, mm, T8 = k["mp"], k["mm"], k["T8"]
        half, hins = k["track K = 64 1 x 1"]
        xl, xins = k["track K4 xl K = 2,048 1 x 1"]
        kout = half()
        xout = xl()
        pairs = {  # name: (kernel, plain, shape, bytes, operations)
            f"K2 {htag}": (
                lambda: grid_cuda.fused_finalize_static_cc_stacked(acc, *tb, **kw2),
                lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(
                    acc, *tb, dims=kw2["dims"], offsets=grid_cuda.kernel_offsets(
                        kw2["dims"], kw2["tol"], kw2["leaf_xy"], kw2["leaf_z"]),
                    kwin=kw2["kwin"], max_sweeps=2 * sum(kw2["dims"]), tol=kw2["tol"]),
                f"S=8 frames x {n} cells of {htag} sums", nbytes((acc,) + tb) + nbytes(outs),
                8 * n * (15 + 12 * n_off) + iters * n * (2 * n_off + 1)),
            f"K14 {htag}": (
                lambda: stencil_cc_cuda.stencil_cc(cent, dyn, *cc_args),
                lambda: stencil_cc_cuda.stencil_cc_plain(
                    cent, dyn, kw2["dims"], grid_cuda.kernel_offsets(
                        kw2["dims"], kw2["tol"], kw2["leaf_xy"], kw2["leaf_z"]),
                    in_dtype(kw2["tol"] * kw2["tol"], dt), *cc_args[4:]),
                f"S=8 frames x {n} cells of {htag} centroids", nbytes((cent, dyn)) + nbytes(lab),
                8 * n * 12 * n_off + int(lab[1].sum()) * n * (2 * n_off + 1) // 8),
            f"K3f {htag}": (
                lambda: centroid_cuda.circumcenter_features(mp, mm, T8),
                lambda: centroid_cuda.circumcenter_features_half_plain(mp, mm, T8),
                f"S=8 x C=32 slots of P={mp.shape[1]} {htag} members",
                nbytes((mp, mm, T8)) + mp.shape[0] * 4 * mp.element_size(), k3f_half_ops(mm)),
            f"K4 {htag}": (half, lambda: track_cuda.track_frames_plain(
                *hins, config=k["hcfg"], gains_xy=k["tracker"].gains_xy),
                f"K = {hins[0].bank.window.shape[1]}, 1 x 1, D = {hins[1].shape[2]}",
                k4_bytes(hins, kout), 0),
            f"K4 xl {htag}": (xl, lambda: track_cuda.track_frames_plain(
                *xins, config=k["hcfg"], gains_xy=k["tracker"].gains_xy),
                f"K = {xins[0].bank.window.shape[1]}, 1 x 1, D = {xins[1].shape[2]}",
                k4_bytes(xins, xout), 0),
        }
        for name, (fk, fp, shape, moved, ops) in pairs.items():
            ms_p = cuda_ms(fp, 1)
            ms_k = cuda_ms(fk, 20)
            ms_k2 = cuda_ms(fk, 20)
            ms_p2 = cuda_ms(fp, 1)
            t_bytes = moved / HBM_BYTES_PER_S
            t_ops = ops / F32_OPS_PER_S
            entry = report.setdefault(name, {"max_abs_err": 0.0})
            entry["ms"] = min(ms_k, ms_k2)
            entry["plain_ms"] = min(ms_p, ms_p2)
            entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            entry["library_ms"] = None
            log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
                f"{ms_p:.4f}/{ms_p2:.4f} ms (both on the card; run plain, kernel, kernel, "
                f"plain; min reported); "
                f"bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} ({moved} bytes, "
                f"{ops} operations); library call none")

    # K6f's key entry, f32 and f64, beside index_add (the library's scatter-add)
    v, bins, m = keep["keys"]
    n = v.shape[1]
    for name, vv in (("K6f keys", v), ("K6f keys f64", v.double())):
        out = voxel_grid_cuda.accumulate_sums_keys(vv, bins, m)
        vals4 = torch.cat([vv[0], torch.ones_like(vv[0][:, :1])], 1)
        tgt = torch.where((bins[0] >= 0) & (bins[0] < m), bins[0], m)
        base = torch.zeros((m + 1, 4), dtype=vv.dtype, device=dev)
        fk = lambda vv=vv: voxel_grid_cuda.accumulate_sums_keys(vv, bins, m)  # noqa: E731
        fp = lambda vv=vv: voxel_grid_cuda.accumulate_sums_keys_plain(vv, bins, m)  # noqa: E731
        ms_p = cuda_ms(fp, 1)
        ms_k, ms_k2 = cuda_ms(fk, 20), cuda_ms(fk, 20)
        ms_p2 = cuda_ms(fp, 1)
        ms_l = cuda_ms(lambda: torch.index_add(base, 0, tgt, vals4), 20)
        moved = nbytes((vv, bins)) + nbytes(out)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, 3 * n / F32_OPS_PER_S
        entry = report.setdefault(name, {"max_abs_err": 0.0})
        entry.update(ms=min(ms_k, ms_k2), plain_ms=min(ms_p, ms_p2), library_ms=ms_l,
                     bound_ms=1e3 * max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[5 timing] {smi}: {name} {n} points into {m} bins: kernel {ms_k:.4f}/"
            f"{ms_k2:.4f} ms, plain {ms_p:.4f}/{ms_p2:.4f} ms (on the card; plain, kernel, "
            f"kernel, plain), index_add {ms_l:.4f} ms; bound {entry['bound_ms']:.6f} ms by "
            f"{entry['bound_by']} ({moved} bytes)")


def phase_host_slice19(dev, smi, report):
    """The host surface on the card's machine: the native decoder built
    from source (its build seconds), bit for bit numpy's on the headline's
    106,496-point clouds, ms per cloud native and numpy (host clock, min of
    reps, in turns); the port's TrackerNode on the card decoding natively,
    its wall ms/frame split into decode, upload, step (synchronised),
    outputs to the host and the rest, beside ``bind_env``'s ms/frame; the
    rosbridge loopback round trip (``scripts/ros_interop_demo_torch.py``)
    through the node on the card."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.io import native, pointcloud2
    from multiple_object_tracking_lidar_tpu_torch.runtime import node as node_mod
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:   # a build from nothing, timed
        keep_dir, native.BUILD_DIR = native.BUILD_DIR, tmp
        try:
            t0 = time.perf_counter()
            native.build_native()
            secs = time.perf_counter() - t0
        finally:
            native.BUILD_DIR = keep_dir
    path = native.build_native()
    native.load_native()
    log(f"[6 host] native decoder {os.path.relpath(path, HERE)}: native/motl_host.cpp "
        f"built with g++ in {secs:.2f} s (into an empty directory), loaded")
    cfg, env, sc = bench_cases.headline_case(device=dev)
    n_max = cfg.caps.n_max_points
    clouds = [sc.frame(k) for k in range(8)]
    for k, msg in enumerate(clouds):
        a = pointcloud2.decode_pointcloud2_named(msg, n_max)
        b = pointcloud2.decode_pointcloud2_named(msg, n_max, use_native=False)
        if a[2] != "native" or not (equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(f"the native decoder ({a[2]}) disagrees with numpy on cloud {k}")
    n_valid = int(pointcloud2.decode_pointcloud2(clouds[0], n_max)[1].sum())

    def per_cloud(use_native, reps=5):
        best = float("inf")
        for _ in range(reps):
            t = time.perf_counter()
            for msg in clouds:
                pointcloud2.decode_pointcloud2(msg, n_max, use_native=use_native)
            best = min(best, (time.perf_counter() - t) / len(clouds))
        return 1e3 * best

    times = [per_cloud(True), per_cloud(False), per_cloud(False), per_cloud(True)]
    log(f"[6 host] {smi}: decode of the headline's {clouds[0].n_points}-point clouds "
        f"({n_valid} valid), ms per cloud in turns (native, numpy, numpy, native): "
        f"{', '.join(f'{x:.4f}' for x in times)}; bit for bit numpy's on 8 clouds")

    # the node's wall clock by piece, on the card: the decode and the step
    # (synchronised before and after) timed around their calls; the rest of
    # the node's wall_ms is the upload and the outputs' copies to the host,
    # on_pointcloud's time past wall_ms the messages, stats and colours
    n = 24
    msgs = [sc.frame(k) for k in range(n)]
    pieces = {"decode": [], "step": []}
    orig_decode = node_mod.decode_pointcloud2_named

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        out = orig_decode(*a, **kw)
        pieces["decode"].append(1e3 * (time.perf_counter() - t))
        return out

    node = node_mod.TrackerNode(cfg, dev)
    node.on_map(load_sim_grid())
    orig_step = node._bound_step

    def timed_step(state, frame):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_step(state, frame)
        torch.cuda.synchronize()
        pieces["step"].append(1e3 * (time.perf_counter() - t))
        return out

    node._bound_step = timed_step
    node_mod.decode_pointcloud2_named = timed_decode
    walls = []
    try:
        for msg in msgs:
            t = time.perf_counter()
            node.on_pointcloud(msg)
            walls.append(1e3 * (time.perf_counter() - t))
    finally:
        node_mod.decode_pointcloud2_named = orig_decode
    p50 = lambda xs: float(np.percentile(np.asarray(xs[4:]), 50))  # noqa: E731
    wall_ms = [s_.wall_ms for s_ in node.stats]
    tracker = Tracker(cfg, dev)
    step = tracker.bind_env(node.env)
    pts, msk, ts = headline_frames(sc, n_max, range(8))
    P, M, T = (torch.from_numpy(a).to(dev) for a in (pts, msk, ts))

    def one():
        st = tracker.init_state()
        for i in range(8):
            st, _ = step(st, Frame(P[i], M[i], T[i]))

    ms_bind = cuda_ms(one, 3) / 8
    rest = p50(wall_ms) - p50(pieces["decode"]) - p50(pieces["step"])
    log(f"[6 host] {smi}: TrackerNode on the card, {n} headline frames (p50 over the last "
        f"{n - 4}), decoder {node.decoder}: on_pointcloud {p50(walls):.3f} ms, of which its "
        f"wall_ms {p50(wall_ms):.3f} = decode {p50(pieces['decode']):.3f} + step (bind_env, "
        f"synchronised) {p50(pieces['step']):.3f} + upload and outputs to the host "
        f"{rest:.3f}; messages, stats and colours {p50(walls) - p50(wall_ms):.3f}; "
        f"bind_env alone (frames on the card) {ms_bind:.4f} ms/frame")
    if node.decoder != "native":
        fail(f"the node decoded with {node.decoder}")

    # the rosbridge loopback through the port's node on the card
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import contextlib
    import io

    import ros_interop_demo_torch

    with contextlib.redirect_stdout(io.StringIO()):
        res = ros_interop_demo_torch.main(["--device", dev.type, "--frames", "12"])
    log(f"[6 host] {smi}: rosbridge loopback (scripts/ros_interop_demo_torch.py, the mock "
        f"rosbridge_tcp endpoint on 127.0.0.1, the port's node on the card): {res}")
    if res["frames"] != 12 or res["obstacle_arrays_received"] < 6 or res["decoder"] != "native":
        fail(f"the rosbridge loopback: {res}")


# ---------------------------------------------------------------------------
# slice 20: bf16 / f16 on every perception front end
# ---------------------------------------------------------------------------
# build families: a half path may launch only the builds of these that it
# needs (``require_builds``)
FAMILIES = ("K2", "K3f", "K4", "K6f", "K8a", "K14")


def require_builds(tag, counts, need, plain_before):
    """Fail unless every build of ``need`` launched in the run, no other
    build of ``FAMILIES`` did (no f32, f64 or other half build of them),
    and no plain route's counter moved since ``plain_before``."""
    missing = [k for k in need if counts.get(k, 0) <= 0]
    other = [k for k, c in counts.items()
             if c and k.split(" ")[0] in FAMILIES and k not in need]
    after = plain_counters()
    if missing or other or after != plain_before:
        fail(f"{tag}: {missing} not launched, other builds {other} launched, plain routes "
             f"{plain_before} -> {after}: {counts}")


def k3f_half_ops(mm) -> int:
    """The operations of K3f's half and table builds on the member mask mm
    (C, P): n (n - 1) / 2 member pairs a slot at 12 each (the gram's dot,
    d2 and the running pick) and 30 a member (its mean term, the centring,
    its squared norm and its line distance)."""
    n = mm.sum(1).to(torch.float64)
    return int((n * (n - 1) / 2 * 12 + 30 * n).sum())


def half_sorted_lists(rng, s, c, p, dt, dev):
    """S cluster-sorted point lists in ``dt`` (C clusters of 1-P members,
    the first three of P, 300 and 33; the last two slots invalid) as
    ``circumcenter_features_sorted`` takes them: (sorted (S, M + P, 3),
    starts (S, C), sizes (S, C), valid (S, C))."""
    rows, starts, sizes = [], [], []
    for _ in range(s):
        sz = rng.integers(1, p + 1, c)
        sz[:3] = [p, 300, 33]
        centre = np.repeat(rng.uniform(-20, 20, (c, 3)), sz, axis=0)
        rows.append(centre + rng.normal(0, 0.4, centre.shape))
        starts.append(np.concatenate([[0], np.cumsum(sz)[:-1]]))
        sizes.append(sz)
    m = max(len(r) for r in rows)
    pts = np.zeros((s, m + p, 3))
    for f, r in enumerate(rows):
        pts[f, :len(r)] = r
    valid = np.ones((s, c), bool)
    valid[:, -2:] = False
    return (torch.from_numpy(pts).to(dt).to(dev), torch.from_numpy(np.stack(starts)).to(dev),
            torch.from_numpy(np.stack(sizes)).to(dev), torch.from_numpy(valid).to(dev))


def sorted_list_table(lists, p_max):
    """The (S * C, P, 3) member table and (S * C, P) mask of sorted point
    lists (``half_sorted_lists``' form), as circumcenter_features_sorted
    gathers them."""
    pts, starts, sizes, valid = lists
    s = starts.shape[0]
    lane = torch.arange(p_max, device=pts.device)
    rows = (starts.to(torch.int64)[:, :, None] + lane).reshape(s, -1)
    mpts = torch.gather(pts, 1, rows[..., None].expand(-1, -1, 3)).reshape(-1, p_max, 3)
    mm = ((lane < sizes[:, :, None]) & valid[:, :, None]).reshape(-1, p_max)
    return mpts, mm


def phase_kernels_slice20(dev, report, cfg):
    """K6f, K8a and K2 fed f32 sums built for bf16 and f16, and K3f's half
    build on the sorted point list at G's P = 512, against their plain
    versions on the card, bit for bit: K6f on the headline's 8 frames
    rounded to the half dtype (frame 6 with a cell of 300 points: the bf16
    count stops at 256) and on G's grid (S = 8), 2 + passes launches per
    call; K8a on C's M = 1,024 and G's M = 2,048 half point lists (S = 1
    and 8) and at M = 8,448 (the frame in device memory), one op per call;
    K2 fed the runs' f32 sums of the half points (S = 8), one op; K3f on 8
    sorted lists of C = 64 clusters of up to 512 members.  Returns the
    inputs the timings reuse."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import (
        default_case, headline_case, pointlist_case)
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, cluster_pallas, grid_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features_sorted
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_pallas import (
        voxel_accumulate_runs_stacked)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    t0 = time.perf_counter()
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    _, env, sc = headline_case(device=dev)
    pts, msk, _ = headline_frames(sc, cfg.caps.n_max_points, range(8))
    pts[6, :300] = np.float32([0.31, 1.27, 0.5])       # one cell of 300 points
    M8 = torch.from_numpy(msk).to(dev)
    gcfg, _, gsc = default_case()
    gp, gm, _ = headline_frames(gsc, gcfg.caps.n_max_points, range(8))
    GM = torch.from_numpy(gm).to(dev)
    gkw = (gcfg.scene, gcfg.voxel_leaf_size, gcfg.leaf_z)
    pcfg = pointlist_case()[0]
    tol = pcfg.cluster_tolerance
    rng = np.random.default_rng(2001)
    keep = {"M8": M8, "GM": GM, "kw": kw, "gkw": gkw, "tol": tol}
    for htag, dt in HALF:
        P8 = torch.from_numpy(pts).to(dev).to(dt).float()     # the points rounded, widened
        GP = torch.from_numpy(gp).to(dev).to(dt).float()
        name = f"K6f {htag}"
        for label, Pd, Md, kk in (("the headline's 8 frames (6: a cell of 300 points)", P8, M8,
                                   kw), ("configuration G's grid, 8 frames", GP, GM, gkw)):
            n_pass = vg.sorted_sums_plan(8, Pd.shape[1], vg.kernel_params(*kk)["n_cells"])[
                "passes"]
            fk = lambda Pd=Pd, Md=Md, kk=kk: vg.accumulate_f32_stacked(  # noqa: E731
                Pd, Md, *kk, dtype=dt)
            out = check_pair(report, name, f"S=8 N={Pd.shape[1]}, "
                             f"{vg.kernel_params(*kk)['n_cells']} cells, {n_pass} passes: "
                             f"{label}", fk, lambda Pd=Pd, Md=Md, kk=kk:
                             vg.accumulate_f32_stacked_plain(Pd, Md, *kk, dtype=dt))
            if out[0].dtype != dt:
                fail(f"{name} returned {out[0].dtype}")
            _, ops, whole = one_op_profile(fk, 5)
            require_ops(f"{name} ({label})", ops, whole, 2 + n_pass)
        top = float(vg.accumulate_f32_stacked(P8[6:7], M8[6:7], *kw, dtype=dt)[0][0, 3].max())
        exact = float(vg.accumulate_f32_stacked(P8[6:7], M8[6:7], *kw)[0][0, 3].max())
        log(f"[3 {name}] the fullest cell of frame 6 holds {exact:.0f} points; its {htag} "
            f"count {top} (a half count stops at {vg.COUNT_SAT[dt]})")
        if exact < 300 or top != min(exact, vg.COUNT_SAT[dt]):
            fail(f"{name}: the fullest cell's count is {top}, of {exact} points")

        # K8a: C's and G's half point lists, S = 1 and 8, and past 8,192 rows
        name = f"K8a {htag}"
        cpts, cmsk = pointlist_rows(dev, pcfg, P8, M8)
        gpts, gmsk = pointlist_rows(dev, gcfg, GP, GM)
        ch, gh = cpts.to(dt).contiguous(), gpts.to(dt).contiguous()
        big = 8448
        bp = torch.from_numpy(rng.normal(0, 2.5, (1, big, 3))).to(dev)
        bp[..., 2] *= 0.1
        bp = bp.to(dt)
        bm = torch.from_numpy(rng.random((1, big)) < 0.8).to(dev)
        for label, p, m in (("C's M=1,024, S=1", ch[:1], cmsk[:1]), ("C's M=1,024, S=8", ch, cmsk),
                            ("G's M=2,048, S=1", gh[:1], gmsk[:1]), ("G's M=2,048, S=8", gh, gmsk),
                            (f"M={big}, S=1 (the frame in device memory)", bp, bm)):
            fk = lambda p=p, m=m: (cluster_pallas.cc_adjacency(p, m, tol),)  # noqa: E731
            check_pair(report, name, f"{label} point lists in {htag}", fk,
                       lambda p=p, m=m: (cluster_pallas.cc_adjacency_half_plain(p, m, tol),))
            _, ops, whole = one_op_profile(fk, 5)
            require_one_op(f"{name} ({label})", ops, whole)
        keep[htag] = {"P8": P8, "GP": GP, "ch": ch, "cmsk": cmsk, "gh": gh, "gmsk": gmsk}

        # K2 fed the runs' f32 sums of the half points
        name = f"K2 {htag} f32-sums"
        rcfg = cfg.replace(voxel_mode="runs", dtype={"bf16": "bfloat16", "f16": "float16"}[htag])
        plan = Tracker(rcfg, dev).plan(env)
        acc_r, _ = voxel_accumulate_runs_stacked(P8, M8, *kw)
        tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
        kw2 = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
                   leaf_z=cfg.leaf_z, kwin=plan.table.k)
        offsets = grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance,
                                           cfg.voxel_leaf_size, cfg.leaf_z)
        fk = lambda: grid_cuda.fused_finalize_static_cc_stacked(  # noqa: E731
            acc_r, *tb, dtype=dt, **kw2)
        fp = lambda: grid_cuda.fused_finalize_static_cc_stacked_plain(  # noqa: E731
            acc_r, *tb, dims=plan.dims, offsets=offsets, kwin=plan.table.k,
            max_sweeps=2 * sum(plan.dims), tol=cfg.cluster_tolerance, dtype=dt)
        out = check_pair(report, name, f"S=8 x {acc_r.shape[2]} cells of the runs' f32 sums of "
                         f"the {htag} points, finalized in f32, rounded, d^2 in {htag}", fk, fp)
        if out[0].dtype != dt:
            fail(f"{name} returned {out[0].dtype} centroids")
        _, ops, whole = one_op_profile(fk, 10)
        require_one_op(name, ops, whole)
        keep[htag].update(acc_r=acc_r, tb=tb, kw2=kw2, offsets=offsets, fp_k2=fp)

        # K3f's half build on the sorted point list at P = 512
        name = f"K3f {htag}"
        lists = half_sorted_lists(rng, 8, 64, 512, dt, dev)
        T8 = torch.arange(8, device=dev).to(dt) * 0.1 + 100.0
        p_max = 512
        mpts, mm = sorted_list_table(lists, p_max)
        check_pair(report, name, "8 sorted point lists x C=64 clusters of up to P=512 members",
                   lambda: (circumcenter_features_sorted(*lists, T8, p_max).reshape(-1, 4),),
                   lambda: (centroid_cuda.circumcenter_features_half_plain(mpts, mm, T8),))
        keep[htag].update(lists=lists, T8=T8)
    log(f"[3 slice 20] the half front ends' builds checked in {time.perf_counter() - t0:.1f} s")
    return keep


HALF_FRONT_ENDS = (  # golden (after "<h>_"), case, tag, the builds its run must launch
    ("pointlist", "headline_case", "C", ("K6f {h}", "K8", "K3f {h}", "K4 {h}")),
    ("pointlist_jnp", "headline_case", "D", ("K6f {h}", "K8a {h}", "K3f {h}", "K4 {h}")),
    ("pointlist_scan", "headline_case", "E", ("K8a {h}", "K3f {h}", "K4 {h}")),
    ("pointlist_runs", "headline_case", "F", ("K7", "K8", "K3f table", "K4 {h}")),
    ("runs", "headline_case", "B", ("K7", "K2 {h} f32-sums", "K3f {h}", "K4 {h}")),
    ("dense_grid", "headline_case", "dense grid", ("K6f {h}", "K2 {h}", "K3f {h}", "K4 {h}")),
    ("default", "default_case", "G", ("K6f {h}", "K8a {h}", "K3f {h}", "K4 {h}")),
)


def phase_half_pointlist(dev, smi, report):
    """bf16 and f16 on every perception front end against the JAX
    package's goldens (``tests/golden/torch_{bf16,f16}_<case>_headline.
    npz``): C, D, E, F, B, the dense grid fed by the scatter sums and G at
    full width through ``bind_env`` (12 frames; G 4) and ``bind_env_multi``
    (S = 8, then S = 4; G S = 4), ``TrackerNode`` on D (12 PointCloud2
    frames) and the CLI on its default backend, the point list (a config
    file setting the dtype, 8 frames).  Every output bit for bit
    (``compare_half``; F too, whose f32 circumcenter -- K3f's f32 table
    build, the JAX f32 ``_one_cluster`` -- is cast; the CLI's records within
    ``cli_errors``' bound).
    Each run launches the builds ``HALF_FRONT_ENDS`` names and no other
    build of K2, K3f, K4, K6f, K8a or K14, and no plain route moves
    (``require_builds``).  Then ms/frame and device ops per frame of D and
    G, f32 / bf16 / f16 in turns."""
    import tempfile

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_torch_golden import CASE_FIELDS, CLI_CONFIGS, FRAMES, GOLDENS, cli_bag

    t0 = time.perf_counter()
    for htag, dname in HALF_NAMES:
        def check(tag, got, golden):
            compare_half(tag, got, golden)
            return "bit for bit"

        for key, case, tag, need in HALF_FRONT_ENDS:
            gkey = f"{htag}_{key}"
            golden = dict(np.load(GOLDENS[gkey]))
            n_gold = golden["publish"].shape[0]
            cfg, env, sc = getattr(bench_cases, case)(device=dev)
            cfg = cfg.replace(**CASE_FIELDS[gkey])
            need = tuple(n.format(h=htag) for n in need)
            P, M, T = half_frames(dev, sc, cfg.caps.n_max_points, n_gold)
            tracker = Tracker(cfg, dev)
            step = tracker.bind_env(env)
            st = tracker.init_state()
            reset_counts()
            plain = plain_counters()
            rows = []
            for k in range(n_gold):
                st, o = step(st, Frame(P[k], M[k], T[k]))
                rows.append([npy(x) for x in o])
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([r[i] for r in rows]) for i, f in enumerate(golden)}
            verdict = check(f"{tag} {htag} bind_env", got, golden)
            log(f"[4 {tag} {htag}] bind_env x{n_gold} ({cfg.voxel_mode} / {cfg.cluster_backend}, "
                f"N={cfg.caps.n_max_points}, C={cfg.caps.c_max_clusters}, "
                f"P={cfg.caps.p_max_cluster}): n_clusters {got['n_clusters'].tolist()}, "
                f"launches {counts}; the JAX golden {verdict}")
            require(f"{tag} {htag} bind_env", counts, need, report)
            require_builds(f"{tag} {htag} bind_env", counts, need, plain)
            # bind_env_multi: S = 8, then S = 4 (G: its 4 frames at once)
            multi = tracker.bind_env_multi(env)
            st = tracker.init_state()
            reset_counts()
            plain = plain_counters()
            rows = []
            cuts = (slice(0, 8), slice(8, n_gold)) if n_gold > 8 else (slice(0, n_gold),)
            for sl in cuts:
                st, o = multi(st, Frame(P[sl], M[sl], T[sl]))
                rows.append([npy(x) for x in o])
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.concatenate([r[i] for r in rows]) for i, f in enumerate(golden)}
            verdict = check(f"{tag} {htag} bind_env_multi", got, golden)
            log(f"[4 {tag} {htag}] bind_env_multi S={[c.stop - c.start for c in cuts]}: "
                f"launches {counts}; the JAX golden {verdict}")
            require(f"{tag} {htag} bind_env_multi", counts, need, report)
            require_builds(f"{tag} {htag} bind_env_multi", counts, need, plain)
            if key != "pointlist_jnp":
                continue
            # TrackerNode on D, the native decoder
            node = TrackerNode(cfg, dev, keep_outputs=True)
            node.on_map(load_sim_grid())
            reset_counts()
            plain = plain_counters()
            for k in range(n_gold):
                node.on_pointcloud(sc.frame(k))
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([np.asarray(getattr(o, f)) for o in node.outputs])
                   for f in golden}
            compare_half(f"{tag} {htag} TrackerNode", got, golden)
            log(f"[4 {tag} {htag}] TrackerNode x{n_gold} (decoder {node.decoder}): launches "
                f"{counts}; the JAX golden bit for bit")
            require(f"{tag} {htag} TrackerNode", counts, need, report)
            require_builds(f"{tag} {htag} TrackerNode", counts, need, plain)
        # the CLI: a config file setting the dtype, no --backend (G's point list)
        case = f"cli_{htag}_default"
        with open(GOLDENS[case], encoding="utf-8") as fh:
            gold = json.load(fh)
        need = tuple(n.format(h=htag) for n in HALF_FRONT_ENDS[-1][3])
        with tempfile.TemporaryDirectory() as tmp:
            argv = cli_bag(os.path.join(tmp, "frames.npz"), FRAMES[case], grid=False)
            conf = os.path.join(tmp, "config.yaml")
            with open(conf, "w", encoding="utf-8") as fh:
                fh.write(CLI_CONFIGS[case])
            reset_counts()
            plain = plain_counters()
            _, recs, _ = run_cli(argv + ["--config", conf, "--device", "cuda"])
            counts = read_counts()
        errs, worst = cli_errors(recs, gold)
        log(f"[4 G {htag}] CLI run --config <dtype: {dname}> (no --backend): {len(recs)} "
            f"records, launches {counts}; vs the JAX CLI golden: {errs or 'within tolerance'} "
            f"(worst pos / vel {worst})")
        if errs:
            fail(f"G {htag} CLI: {errs}")
        require(f"G {htag} CLI", counts, need, report)
        require_builds(f"G {htag} CLI", counts, need, plain)
    log(f"[4 slice 20] the half front ends against their goldens in "
        f"{time.perf_counter() - t0:.1f} s")

    # D and G: ms/frame and device ops per frame, f32 / bf16 / f16 in turns
    for tag, case, fields in (("D", "headline_case", CASE_FIELDS["pointlist_jnp"]),
                              ("G", "default_case", {})):
        cfg, env, sc = getattr(bench_cases, case)(device=dev)
        P, M, T = half_frames(dev, sc, cfg.caps.n_max_points, 8)
        trackers = {d: Tracker(cfg.replace(dtype=d, **fields), dev)
                    for d in ("float32", "bfloat16", "float16")}
        for turn, d in enumerate(("float32", "bfloat16", "float16", "float16", "bfloat16",
                                  "float32")):
            tr = trackers[d]
            step, multi = tr.bind_env(env), tr.bind_env_multi(env)

            def one():
                st = tr.init_state()
                for i in range(8):
                    st, _ = step(st, Frame(P[i], M[i], T[i]))

            def eight():
                multi(tr.init_state(), Frame(P, M, T))

            ms1, ms8 = cuda_ms(one, 2) / 8, cuda_ms(eight, 2) / 8
            counts = ""
            if turn < 3:
                (o1, s1), (o8, s8) = trace_counts(one, 8), trace_counts(eight, 8)
                counts = (f"; device ops per frame {o1:.2f} / {o8:.2f}; host syncs per frame "
                          f"{s1:.3f} / {s8:.3f}")
            log(f"[5 timing] {smi}: {tag} {d} (turn {turn + 1} of f32, bf16, f16, f16, bf16, "
                f"f32) bind_env {ms1:.4f} ms/frame, bind_env_multi S=8 {ms8:.4f} "
                f"ms/frame{counts}")


def phase_timings_slice20(dev, smi, report, keep):
    """Each new half build beside the f32 build of the same kernel on the
    same inputs (the half values widened), device us per call in turns
    (f32, half, half, f32; torch.profiler between marker kernels): K6f at
    the headline's S = 8 and G's grid S = 8, K8a at M = 1,024 and 2,048 (S
    = 1 and 8), K2 fed f32 sums beside K2 f32, K3f on the sorted lists at
    P = 512; then the report's entries (kernel and plain ms by CUDA events
    in turns, bounds: bytes at HBM_BYTES_PER_S, operations at
    F32_OPS_PER_S; K6f's library call a ``torch.index_add`` in the half
    dtype)."""
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        cluster_pallas, grid_cuda, voxel_grid_cuda as vg)
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features_sorted

    def device_us(fn, reps):
        us, ops, _ = one_op_profile(fn, reps)
        return us * ops

    def turns(tag, f32, half, reps):
        a, b = device_us(f32, reps), device_us(half, reps)
        b2, a2 = device_us(half, reps), device_us(f32, reps)
        log(f"[5 timing] {smi}: {tag} device us per call in turns (f32 build, half, half, "
            f"f32 build) {a:.2f}, {b:.2f}, {b2:.2f}, {a2:.2f}: half / f32 "
            f"{min(b, b2) / min(a, a2):.2f}x")

    M8, GM, kw, gkw, tol = keep["M8"], keep["GM"], keep["kw"], keep["gkw"], keep["tol"]
    for htag, dt in HALF:
        k = keep[htag]
        for label, P, Mk, kk in (("headline S=8", k["P8"], M8, kw),
                                 ("G's grid S=8", k["GP"], GM, gkw)):
            turns(f"K6f {htag} {label}",
                  lambda P=P, Mk=Mk, kk=kk: vg.accumulate_f32_stacked(P, Mk, *kk),
                  lambda P=P, Mk=Mk, kk=kk: vg.accumulate_f32_stacked(P, Mk, *kk, dtype=dt), 10)
        for label, p, m in (("M=1,024 S=1", k["ch"][:1], k["cmsk"][:1]),
                            ("M=1,024 S=8", k["ch"], k["cmsk"]),
                            ("M=2,048 S=1", k["gh"][:1], k["gmsk"][:1]),
                            ("M=2,048 S=8", k["gh"], k["gmsk"])):
            p32 = p.float()
            turns(f"K8a {htag} {label}",
                  lambda p32=p32, m=m: cluster_pallas.cc_adjacency(p32, m, tol),
                  lambda p=p, m=m: cluster_pallas.cc_adjacency(p, m, tol), 20)
        acc_r, tb, kw2 = k["acc_r"], k["tb"], k["kw2"]
        k2_32 = lambda: grid_cuda.fused_finalize_static_cc_stacked(acc_r, *tb, **kw2)  # noqa: E731
        k2_h = lambda: grid_cuda.fused_finalize_static_cc_stacked(  # noqa: E731
            acc_r, *tb, dtype=dt, **kw2)
        turns(f"K2 {htag} f32-sums (beside K2 f32)", k2_32, k2_h, 20)
        lists, T8 = k["lists"], k["T8"]
        l32 = (lists[0].float(),) + lists[1:]
        turns(f"K3f {htag} sorted lists S=8 x C=64, P=512",
              lambda: circumcenter_features_sorted(*l32, T8.float(), 512),
              lambda: circumcenter_features_sorted(*lists, T8, 512), 10)

        # the report's entries
        P8 = k["P8"]
        k1p = vg.kernel_params(*kw)
        s8, nc = P8.shape[0], k1p["n_cells"]
        ok, lin, _ = vg.kept_cells(P8, M8, k1p)
        kept = int(ok.sum())
        frame_of = torch.arange(s8, device=dev)[:, None]
        tgt = torch.where(ok, frame_of * nc + lin, s8 * nc).reshape(-1)
        vals4 = torch.cat([torch.where(ok[..., None], P8, 0.0), ok[..., None].float()],
                          -1).reshape(-1, 4).to(dt)
        base = torch.zeros((s8 * nc + 1, 4), dtype=dt, device=dev)
        gh, gmsk = k["gh"], k["gmsk"]
        vg8 = gmsk.sum(dim=1).to(torch.float64)
        outs = k2_h()
        n_off, iters = len(k["offsets"]), int(outs[3].sum())
        n = acc_r.shape[2]
        pairs = {  # name: (kernel, plain, shape, bytes, operations, library call)
            f"K6f {htag}": (lambda: vg.accumulate_f32_stacked(P8, M8, *kw, dtype=dt),
                            lambda: vg.accumulate_f32_stacked_plain(P8, M8, *kw, dtype=dt),
                            f"S=8 frames x {P8.shape[1]} points, {nc} cells, {htag} sums",
                            nbytes((P8, M8)) + nbytes(vg.accumulate_f32_stacked(
                                P8, M8, *kw, dtype=dt)),
                            23 * kept, lambda: torch.index_add(base, 0, tgt, vals4)),
            f"K8a {htag}": (lambda: cluster_pallas.cc_adjacency(gh, gmsk, tol),
                            lambda: cluster_pallas.cc_adjacency_half_plain(gh, gmsk, tol),
                            f"S=8 x M={gh.shape[1]} G point lists in {htag}, bool (M, M) out",
                            nbytes((gh, gmsk)) + nbytes(cluster_pallas.cc_adjacency(gh, gmsk,
                                                                                    tol)),
                            int((12 * vg8 * vg8).sum()), None),
            f"K2 {htag} f32-sums": (k2_h, k["fp_k2"],
                                    f"S=8 frames x {n} cells of f32 sums, {htag} centroids "
                                    "and d^2", nbytes((acc_r,) + tb) + nbytes(outs),
                                    s8 * n * (15 + 14 * n_off) + iters * n * (2 * n_off + 1),
                                    None),
        }
        for name, (fk, fp, shape, moved, ops, lib) in pairs.items():
            ms_p = cuda_ms(fp, 2)
            ms_k = cuda_ms(fk, 20)
            ms_k2 = cuda_ms(fk, 20)
            ms_p2 = cuda_ms(fp, 2)
            t_bytes = moved / HBM_BYTES_PER_S
            t_ops = ops / F32_OPS_PER_S
            entry = report[name]
            entry["ms"] = min(ms_k, ms_k2)
            entry["plain_ms"] = min(ms_p, ms_p2)
            entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            entry["library_ms"] = cuda_ms(lib, 20) if lib is not None else None
            log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
                f"{ms_p:.4f}/{ms_p2:.4f} ms (run plain, kernel, kernel, plain; min reported); "
                f"bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} ({moved} bytes, {ops} "
                f"operations); library call "
                f"{'none' if lib is None else format(entry['library_ms'], '.4f') + ' ms'}")


# ---------------------------------------------------------------------------
# slice 21: F9 repaired (K3f's f32 table build) and bf16 / f16 under Hungarian
# association and in the fleet
# ---------------------------------------------------------------------------
GOLDEN_HALF_HUNGARIAN = {(h, g): os.path.join(HERE, "tests", "golden", f"torch_{h}_{g}.npz")
                         for h in ("bf16", "f16")
                         for g in ("hungarian_headline", "hungarian_dense", "fleet_headline")}
AUCTION_PROBLEMS_NPZ = os.path.join(HERE, "tests", "golden", "torch_auction_problems.npz")
HALF_K12_PROBLEMS = (  # (D, K, kind, max_iters): AUCTION_PROBLEMS' small ones, in half;
    # near ties capped at 200 (in bf16 their six phases run to any cap: the
    # plain version's 18,000 synced iterations would cost a minute); the
    # headline's (32, 64) shape comes from the scene's own problem below
    (12, 10, "dense", 3000), (16, 16, "ties", 200), (16, 16, "ties", 1))
SCENE_PROBLEMS = 1   # the scenes' own problems K12's half builds take (frames of each)


def hungarian_half_report_as(htag):
    """A half Hungarian path's K4 / K4 xl half launches count in the report
    as K4 hungarian's / K4 xl hungarian's half builds."""
    return {f"K4 {htag}": f"K4 hungarian {htag}", f"K4 xl {htag}": f"K4 xl hungarian {htag}"}


def phase_kernels_slice21(dev, report, cfg):
    """The new builds against their plain versions on the card, bit for bit:
    K12's half builds (assignments, saturated phases, iterations per phase
    and the dummy-only ones) on dense, near-tie, capped and gate-like
    problems and on the headline and dense scenes' own problems cast to
    the half dtype; K4's Hungarian half builds (lpf at 1 x 1, 1 x 2 and 2 x
    1, ihgp at 1 x 2, K = 64, on ``track_scene``'s gated scene) and K4 xl's
    at K = 2,048 (its plain time kept for the report); K3f's f32 table
    build on 8 sorted lists of C = 32 clusters of up to P = 384 members,
    and the half builds' mesh spelling of cy.  Returns the inputs the
    timings reuse."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda, hungarian_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features_sorted
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import EPS, auction_assign_plain
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    t0 = time.perf_counter()
    rng = np.random.default_rng(2101)
    scenes = np.load(AUCTION_PROBLEMS_NPZ)
    K, D = cfg.caps.k_max_tracks, cfg.caps.c_max_clusters
    keep = {}
    for htag, dt in HALF:
        dname = dict(HALF_NAMES)[htag]
        name = f"K12 {htag}"
        report.setdefault(name, {"max_abs_err": 0.0})

        def check(tag, C, F, eps, max_cost, max_iters, name=name):
            a, sat, it, fast = hungarian_cuda.auction_assign(C, F, eps, max_cost, max_iters,
                                                             return_split=True)
            torch.cuda.synchronize()
            ok, err = True, 0.0
            for b in range(C.shape[0]):
                pa, ps, pit, pfast = auction_assign_plain(C[b], F[b], eps, max_cost, max_iters,
                                                          return_split=True)
                ok = (ok and equal(npy(a[b]), npy(pa)) and int(sat[b]) == int(ps)
                      and npy(it[b]).tolist() == pit and npy(fast[b]).tolist() == pfast)
                err = max(err, max_err(npy(a[b]), npy(pa)))
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
            log(f"[3 {name}] {tag}, {C.shape[0]} problem(s) in one launch: exact={ok} "
                f"saturated={npy(sat).tolist()} iterations per phase {npy(it).tolist()} "
                f"(dummy-only {npy(fast).tolist()})")
            if not ok:
                fail(f"{name} ({tag}) disagrees with its plain version")
            return npy(sat)

        for d, k, kind, max_iters in HALF_K12_PROBLEMS:
            eps, max_cost = (1e-4, 1.0) if kind == "ties" else (1e-3, 0.5)
            probs = [auction_problem(rng, d, k, kind) for _ in range(3)]
            C = torch.from_numpy(np.stack([q[0] for q in probs])).to(dev).to(dt)
            F = torch.from_numpy(np.stack([q[1] for q in probs])).to(dev)
            sat = check(f"D={d} K={k} {kind} max_iters={max_iters} in {htag}", C, F, eps,
                        max_cost, max_iters)
            if max_iters == 1 and sat.min() <= 0:
                fail(f"{name} at max_iters=1 did not saturate")
        for scene in ("headline", "dense"):
            C = torch.from_numpy(scenes[f"{scene}_cost"][:SCENE_PROBLEMS]).to(dev).to(dt)
            F = torch.from_numpy(scenes[f"{scene}_feas"][:SCENE_PROBLEMS]).to(dev)
            check(f"the {scene} scene's first {SCENE_PROBLEMS} problems (D={C.shape[1]}, "
                  f"K={C.shape[2]}) cast to {htag}", C, F, EPS, float(scenes[f"{scene}_thr"]),
                  3000)

        # K4's Hungarian half builds on the gated scene, and K4 xl's at 2,048 slots
        hcfg = cfg.replace(association="hungarian", dtype=dname)
        gains = Tracker(hcfg, dev).gains_xy
        for pf, cases in (("lpf", ((1, 1, ()), (1, 2, (0,)), (2, 1, (0,)))),
                          ("ihgp", ((1, 2, (0,)),))):
            c = hcfg.replace(position_filter=pf)
            for i, (b, s_fr, fresh) in enumerate(cases):
                ins = half_track_inputs(track_scene(2100 + i, cfg, K, D, b, s_fr, fresh, dev,
                                                   gated=True), dt)
                check_track_inputs(c, gains, ins, report, f"K4 hungarian {htag}",
                                   f"{pf}, K={K} {b} x {s_fr} frames, D={D}, gated, {htag}")
        wide = half_track_inputs(track_scene(2150, cfg, 2048, D, 1, 1, (), dev, gated=True), dt)
        t_p = time.perf_counter()
        check_track_inputs(hcfg, gains, wide, report, f"K4 xl hungarian {htag}",
                           f"lpf, K=2048 1 x 1, D={D}, gated, {htag}")
        keep[htag] = {"hcfg": hcfg, "gains": gains, "wide": wide,
                      "xl_check_s": time.perf_counter() - t_p}

    # K3f's f32 table build (F's circumcenter under half) and the mesh spelling
    name = "K3f table"
    lists = half_sorted_lists(rng, 8, 32, 384, torch.float32, dev)
    T8 = torch.arange(8, device=dev).float() * 0.1 + 100.0
    mpts, mm = sorted_list_table(lists, 384)
    check_pair(report, name, "8 sorted f32 point lists x C=32 clusters of up to P=384 members "
               "(the jnp _one_cluster in f32; the norm's epilogue slots 24-31 contracted)",
               lambda: (circumcenter_features_sorted(*lists, T8, 384, table=True).reshape(-1, 4),),
               lambda: (centroid_cuda.circumcenter_features_half_plain(mpts, mm, T8, 32),))
    for htag, dt in HALF:
        hl = (lists[0].to(dt),) + lists[1:]
        hm, _ = sorted_list_table(hl, 384)
        with centroid_cuda.mesh_program():
            check_pair(report, f"K3f {htag}", f"8 sorted {htag} point lists, C=32, P=384, cy "
                       "as the JAX fleet's program on several devices spells it",
                       lambda hl=hl, dt=dt: (circumcenter_features_sorted(
                           *hl, T8.to(dt), 384).reshape(-1, 4),),
                       lambda hm=hm, dt=dt: (centroid_cuda.circumcenter_features_half_plain(
                           hm, mm, T8.to(dt), 32, cy_alt=True),))
    keep["lists"], keep["T8"] = lists, T8
    log(f"[3 slice 21] the new builds checked in {time.perf_counter() - t0:.1f} s")
    return keep


def phase_hungarian_half(dev, smi, report):
    """bf16 and f16 under ``association="hungarian"`` against the JAX
    goldens (``tests/golden/torch_{bf16,f16}_hungarian_{headline,dense}.npz``,
    every field bit for bit): the headline through ``bind_env`` (12
    frames, one K4 launch each), ``bind_env_multi`` (S = 8, then 4) and
    ``TrackerNode`` (12 PointCloud2 frames), the dense scene (K = 96)
    through ``bind_env`` and ``bind_env_multi`` (S = 8); each frame's
    ``assoc_saturated`` logged.  The headline again with its bank padded
    to 2,048 slots (``k_max_tracks``, 3 frames), which K4 xl's half
    Hungarian build runs (held to its plain version in
    ``phase_kernels_slice21``; here its launches, saturation and finite
    positions).  The half fleet golden
    (``torch_{bf16,f16}_fleet_headline.npz``: the JAX vmap fleet, B = 8 x 3
    steps) on a one-rank NCCL mesh, bit for bit; then the half fleet under
    hungarian (which the JAX vmap fleet cannot trace), B = 4 x 2 steps,
    each stream bit for bit a fleet of its own.  Every run launches the half
    builds of its stages and no other build (``require_half``,
    ``require_builds``), and no plain route moves."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    t0 = time.perf_counter()
    for htag, dt in HALF:
        dname = dict(HALF_NAMES)[htag]
        ras = hungarian_half_report_as(htag)
        for tag, case, gkey, s_cuts in (
                ("hungarian", bench_cases.hungarian_case, "hungarian_headline", (8, 4)),
                ("dense hungarian", bench_cases.dense_hungarian_case, "hungarian_dense", (8,))):
            golden = dict(np.load(GOLDEN_HALF_HUNGARIAN[htag, gkey]))
            n = golden["publish"].shape[0]
            cfg, env, sc = case(device=dev)
            cfg = cfg.replace(dtype=dname)
            P, M, T = half_frames(dev, sc, cfg.caps.n_max_points, n)
            tracker = Tracker(cfg, dev)
            step, st = tracker.bind_env(env), tracker.init_state()
            reset_counts()
            plain = plain_counters()
            rows = []
            for k in range(n):
                st, o = step(st, Frame(P[k], M[k], T[k]))
                rows.append([npy(x) for x in o])
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([r[i] for r in rows]) for i, f in enumerate(golden)}
            compare_half(f"{tag} {htag} bind_env", got, golden)
            require_half(f"{tag} bind_env", counts, htag)
            if counts[f"K4 {htag}"] != n or counts.get(f"K4 xl {htag}", 0):
                fail(f"{tag} {htag} bind_env: {counts[f'K4 {htag}']} K4 {htag} launches for "
                     f"{n} frames")
            require_builds(f"{tag} {htag} bind_env", counts,
                           (f"K2 {htag}", f"K3f {htag}", f"K4 {htag}"), plain)
            require(f"{tag} {htag} bind_env", counts, (), report, ras)
            log(f"[4 {tag} {htag}] bind_env x{n} (K={cfg.caps.k_max_tracks}, "
                f"C={cfg.caps.c_max_clusters}): assoc_saturated "
                f"{got['assoc_saturated'].tolist()}, valid per frame "
                f"{got['valid'].sum(1).tolist()}, launches {counts}; the JAX golden bit for bit")
            multi = tracker.bind_env_multi(env)
            st = tracker.init_state()
            reset_counts()
            plain = plain_counters()
            rows, at = [], 0
            for cut in s_cuts:
                sl = slice(at, min(n, at + cut))
                at = sl.stop
                st, o = multi(st, Frame(P[sl], M[sl], T[sl]))
                rows.append([npy(x) for x in o])
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.concatenate([r[i] for r in rows]) for i, f in enumerate(golden)}
            compare_half(f"{tag} {htag} bind_env_multi", got, {f: v[:at] for f, v in
                                                               golden.items()})
            require_half(f"{tag} bind_env_multi", counts, htag)
            require_builds(f"{tag} {htag} bind_env_multi", counts,
                           (f"K2 {htag}", f"K3f {htag}", f"K4 {htag}"), plain)
            require(f"{tag} {htag} bind_env_multi", counts, (), report, ras)
            log(f"[4 {tag} {htag}] bind_env_multi S={list(s_cuts)}: launches {counts}; the "
                f"JAX golden's first {at} frames bit for bit")
            if tag != "hungarian":
                continue
            node = TrackerNode(cfg, dev, keep_outputs=True)
            node.on_map(load_sim_grid())
            reset_counts()
            plain = plain_counters()
            for k in range(n):
                node.on_pointcloud(sc.frame(k))
            torch.cuda.synchronize()
            counts = read_counts()
            got = {f: np.stack([np.asarray(getattr(o, f)) for o in node.outputs])
                   for f in golden}
            compare_half(f"{tag} {htag} TrackerNode", got, golden)
            require_half(f"{tag} TrackerNode", counts, htag)
            require(f"{tag} {htag} TrackerNode", counts, (), report, ras)
            log(f"[4 {tag} {htag}] TrackerNode x{n} (decoder {node.decoder}): launches "
                f"{counts}; the JAX golden bit for bit")
            # the bank padded to 2,048 slots: K4 xl's half Hungarian build
            wcfg = cfg.replace(caps=dataclasses.replace(cfg.caps, k_max_tracks=2048))
            wtr = Tracker(wcfg, dev)
            wstep, wst = wtr.bind_env(env), wtr.init_state()
            reset_counts()
            plain = plain_counters()
            wrows = []
            for k in range(3):
                wst, o = wstep(wst, Frame(P[k], M[k], T[k]))
                wrows.append(o)
            torch.cuda.synchronize()
            counts = read_counts()
            if counts[f"K4 xl {htag}"] != 3 or counts[f"K4 {htag}"]:
                fail(f"{tag} {htag} padded to 2,048 slots: K4 xl {htag} "
                     f"{counts[f'K4 xl {htag}']} launches for 3 frames: {counts}")
            require_builds(f"{tag} {htag} 2,048 slots", counts,
                           (f"K2 {htag}", f"K3f {htag}", f"K4 xl {htag}"), plain)
            require(f"{tag} {htag} 2,048 slots", counts, (), report, ras)
            fin = all(bool(torch.isfinite(o.pos[o.valid]).all()) for o in wrows)
            log(f"[4 {tag} {htag}] bind_env x3 with the bank padded to 2,048 slots: launches "
                f"{counts}; assoc_saturated {[int(o.assoc_saturated) for o in wrows]}, valid "
                f"{[int(o.valid.sum()) for o in wrows]}, finite positions {fin}")
            if not fin:
                fail(f"{tag} {htag} 2,048 slots: non-finite positions on valid lanes")

        # the half fleet golden: the JAX vmap fleet, B = 8 x 3 steps
        golden = dict(np.load(GOLDEN_HALF_HUNGARIAN[htag, "fleet_headline"]))
        cfg, env, sc = bench_cases.headline_case(device=dev)
        cfg = cfg.replace(dtype=dname)
        frames = fleet_frames(dev, sc, cfg.caps.n_max_points, 8, 3)
        mesh = make_mesh(1, 1, device=dev)
        fleet = ShardedTracker(Tracker(cfg, dev), mesh)
        if fleet._use_kernel_fleet:
            fail(f"the {htag} fleet took the kernel fleet (f32 only)")
        need = (f"K6f {htag}", f"K14 {htag}", f"K3f {htag}", f"K4 {htag}")
        step, state = fleet.bind_env(env), fleet.init_state(8)
        reset_counts()
        plain = plain_counters()
        outs = []
        for k in range(3):
            state, o = step(state, frames[0][k], frames[1][k], frames[2][k])
            outs.append(o)
        torch.cuda.synchronize()
        counts = read_counts()
        got = {f: np.stack([npy(getattr(o, f)) for o in outs]) for f in golden}
        compare_half(f"{htag} vmap fleet B=8 x 3", got, golden)
        if counts[f"K4 {htag}"] != 3:
            fail(f"{htag} fleet: {counts[f'K4 {htag}']} K4 {htag} launches for 3 steps")
        require_builds(f"{htag} fleet", counts, need, plain)
        require(f"{htag} fleet", counts, (), report)
        log(f"[4 fleet {htag}] the vmap fleet on a one-rank NCCL mesh, B=8 x 3 steps: launches "
            f"{counts}; the JAX fleet golden bit for bit")
        # the half fleet under hungarian (B x 1: one K4 launch for the four
        # banks), each stream against a fleet of its own (1 x 1)
        hcfg = cfg.replace(association="hungarian")
        hfleet = ShardedTracker(Tracker(hcfg, dev), mesh)
        hstep, hstate = hfleet.bind_env(env), hfleet.init_state(4)
        own = [hfleet.init_state(1) for _ in range(4)]
        reset_counts()
        plain = plain_counters()
        for k in range(2):
            hstate, o = hstep(hstate, frames[0][k, :4], frames[1][k, :4], frames[2][k, :4])
        torch.cuda.synchronize()
        counts = read_counts()
        if counts[f"K4 {htag}"] != 2:
            fail(f"{htag} hungarian fleet: {counts[f'K4 {htag}']} K4 {htag} launches for 2 steps")
        require_builds(f"{htag} hungarian fleet", counts, need, plain)
        require(f"{htag} hungarian fleet", counts, (), report, ras)
        outs = [o]
        hstate = hfleet.init_state(4)
        for k in range(2):
            hstate, o = hstep(hstate, frames[0][k, :4], frames[1][k, :4], frames[2][k, :4])
            for si in range(4):
                own[si], w = hstep(own[si], *(f[k, si:si + 1] for f in frames))
                bad = [f for f in w._fields if not equal(npy(getattr(o, f)[si]),
                                                         npy(getattr(w, f)[0]))]
                if bad:
                    fail(f"{htag} hungarian fleet: stream {si} step {k} differs from its own "
                         f"fleet in {bad}")
        log(f"[4 fleet {htag}] the vmap fleet under hungarian, B=4 x 2 steps (one K4 {htag} "
            f"launch a step): bit for bit each stream's own 1 x 1 fleet; assoc_saturated "
            f"{npy(outs[0].assoc_saturated).tolist()}; launches {counts}")
    log(f"[4 slice 21] the half Hungarian goldens and the half fleet in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_timings_slice21(dev, smi, report, keep):
    """The Hungarian headline's ``bind_env`` and ``bind_env_multi`` ms/frame
    in f32, bf16 and f16 in turns; then each new build in turns with its f32
    build on the same values widened (f32, half, half, f32; device us per
    launch from torch.profiler between marker kernels): K4 hungarian at K =
    64, D = 32, 1 x 1 on the gated scene and on the dense scene's own frame
    1 (K = 96, D = 64), K4 xl hungarian at K = 2,048, K12 on the gated
    frame's gate costs, K3f's table build beside the f32 pair-stats build on
    the same lists; each auction's iterations per phase split into
    dummy-only and general (K12's ``return_split``, past K12's columns the
    plain version's).  Then the report's entries: kernel ms by CUDA events
    (twice), plain ms from one call (K4 xl hungarian's from its check);
    bounds: bytes at HBM_BYTES_PER_S, operations at F32_OPS_PER_S."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import (
        centroid_cuda, hungarian_cuda, track_cuda)
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features_sorted
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import (
        EPS, auction_assign_plain, gate_costs)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state

    def device_us(fn, reps):
        us, ops, whole = one_op_profile(fn, reps)
        return us * ops

    def turns(tag, f32, half, reps):
        a, b = device_us(f32, reps), device_us(half, reps)
        b2, a2 = device_us(half, reps), device_us(f32, reps)
        log(f"[5 timing] {smi}: {tag} device us per launch in turns (f32 build, half, half, "
            f"f32 build) {a:.2f}, {b:.2f}, {b2:.2f}, {a2:.2f}: half / f32 "
            f"{min(b, b2) / min(a, a2):.2f}x")

    def split(tag, C, F, thr):
        if C.shape[-1] <= hungarian_cuda.MAX_COLS:
            _, sat, it, fast = hungarian_cuda.auction_assign(C, F, EPS, thr, return_split=True)
            it, fast = npy(it).tolist(), npy(fast).tolist()
        else:   # past K12's columns: the plain version's count (the same, bit for bit)
            _, sat, it, fast = auction_assign_plain(C, F, EPS, thr, return_split=True)
        log(f"[5 timing] {smi}: {tag}: iterations per phase {it}, dummy-only {fast}, general "
            f"{[a - b for a, b in zip(it, fast)]}, saturated {int(sat)}")
        return it

    cfg, env, _ = bench_cases.headline_case(device=dev)
    K, D = cfg.caps.k_max_tracks, cfg.caps.c_max_clusters
    dcfg, denv, dsc = bench_cases.dense_hungarian_case(device=dev)
    lists, T8 = keep["lists"], keep["T8"]
    # the Hungarian headline end to end, f32 / bf16 / f16 in turns (16 frames)
    hcfg0, henv, hsc = bench_cases.hungarian_case(device=dev)
    P, M, T = half_frames(dev, hsc, hcfg0.caps.n_max_points, 16)
    trackers = {d: Tracker(hcfg0.replace(dtype=d), dev)
                for d in ("float32", "bfloat16", "float16")}
    for turn, d in enumerate(("float32", "bfloat16", "float16", "float16", "bfloat16",
                              "float32")):
        ms1, ms8 = time_path(trackers[d], henv, P, M, T, reps=2)
        log(f"[5 timing] {smi}: the Hungarian headline {d} (turn {turn + 1} of f32, bf16, "
            f"f16, f16, bf16, f32) bind_env {ms1:.4f} ms/frame, bind_env_multi S=8 "
            f"{ms8:.4f} ms/frame")
    l_tab = lambda: circumcenter_features_sorted(*lists, T8, 384, table=True)  # noqa: E731
    turns("K3f table (beside the f32 pair-stats build) 8 sorted lists C=32 P=384",
          lambda: circumcenter_features_sorted(*lists, T8, 384), l_tab, 20)
    for htag, dt in HALF:
        k = keep[htag]
        hcfg, gains = k["hcfg"], k["gains"]
        f32cfg = hcfg.replace(dtype="float32")
        g32 = {q: ({a: b.float() for a, b in w.items()} if isinstance(w, dict) else w.float())
               for q, w in gains.items()}
        gated = half_track_inputs(track_scene(5, cfg, K, D, 1, 1, (), dev, gated=True), dt)
        wide32 = widen_track_inputs(gated)
        turns(f"K4 hungarian {htag} K={K} D={D} 1 x 1 gated scene",
              lambda: track_cuda.track_frames(*wide32, config=f32cfg, gains_xy=g32),
              lambda: track_cuda.track_frames(*gated, config=hcfg, gains_xy=gains), 5)
        st0 = map_state(lambda x: x[0], gated[0])
        C, F = gate_costs(st0.bank, gated[1][0, 0], gated[2][0, 0], cfg.id_threshold, True)
        C32, _ = gate_costs(map_state(lambda x: x[0], wide32[0]).bank, wide32[1][0, 0],
                            wide32[2][0, 0], cfg.id_threshold, True)
        iters = split(f"the gated frame's auction in {htag} (K4 hungarian {htag}, K12 {htag})",
                      C, F, cfg.id_threshold)
        split("the same frame widened, f32", C32, F, cfg.id_threshold)
        turns(f"K12 {htag} on the gated frame's costs (beside K12 f32 on them widened)",
              lambda: hungarian_cuda.auction_assign(C.float(), F, EPS, cfg.id_threshold),
              lambda: hungarian_cuda.auction_assign(C, F, EPS, cfg.id_threshold), 5)
        # the dense scene's frame 1 (K = 96, D = 64) from the state before it
        dh = dcfg.replace(dtype=dict(HALF_NAMES)[htag])
        states, dets, valid, t, DC, DF = path_track_inputs(dev, dh, denv, dsc, 2)
        dins = (map_state(lambda x: x[None], states[1]), dets[1][None, None],
                valid[1][None, None], t[1][None, None].to(dt))
        d32 = widen_track_inputs(dins)
        dgains = Tracker(dh, dev).gains_xy
        dg32 = {q: ({a: b.float() for a, b in w.items()} if isinstance(w, dict) else w.float())
                for q, w in dgains.items()}
        turns(f"K4 hungarian {htag} on the dense scene's frame 1 (K=96, D=64)",
              lambda: track_cuda.track_frames(*d32, config=dh.replace(dtype="float32"),
                                              gains_xy=dg32),
              lambda: track_cuda.track_frames(*dins, config=dh, gains_xy=dgains), 3)
        split(f"the dense scene's frame 1 auction in {htag}", DC[1], DF[1], dh.id_threshold)
        split(f"the dense scene's frame 1 widened, f32", DC[1].float(), DF[1], dh.id_threshold)
        wide = k["wide"]
        turns(f"K4 xl hungarian {htag} K=2048 D={D} 1 x 1 gated scene",
              lambda: track_cuda.track_frames(*widen_track_inputs(wide), config=f32cfg,
                                              gains_xy=g32),
              lambda: track_cuda.track_frames(*wide, config=hcfg, gains_xy=gains), 2)
        wst0 = map_state(lambda x: x[0], wide[0])
        WC, WF = gate_costs(wst0.bank, wide[1][0, 0], wide[2][0, 0], cfg.id_threshold, True)
        witers = split(f"K4 xl hungarian {htag}'s frame (K=2048)", WC, WF, cfg.id_threshold)

        # the report's entries
        kw = dict(config=hcfg, gains_xy=gains)
        out4 = track_cuda.track_frames(*gated, **kw)
        outw = track_cuda.track_frames(*wide, **kw)
        n_upd = int(out4[1].valid.sum())
        pairs = {  # name: (kernel, plain or None (its check's time), shape, bytes, operations)
            f"K4 hungarian {htag}": (
                lambda: track_cuda.track_frames(*gated, **kw),
                lambda: track_cuda.track_frames_plain(*gated, **kw),
                f"K={K} 1 x 1 frame, D={D}, gated scene in {htag}, iterations per phase {iters}",
                nbytes(gated) + nbytes(out4),
                auction_ops(iters, D, K, 8) + 20 * cfg.data_length * n_upd),
            f"K4 xl hungarian {htag}": (
                lambda: track_cuda.track_frames(*wide, **kw), None,
                f"K=2048 1 x 1 frame, D={D}, gated scene in {htag}, iterations per phase "
                f"{witers}", nbytes(wide) + nbytes(outw),
                auction_ops(witers, D, 2048, 8) + 20 * cfg.data_length * int(outw[1].valid.sum())),
            f"K12 {htag}": (
                lambda: hungarian_cuda.auction_assign(C, F, EPS, cfg.id_threshold),
                lambda: auction_assign_plain(C, F, EPS, cfg.id_threshold),
                f"D={D} K={K}, the gated frame's {htag} gate costs, iterations per phase {iters}",
                nbytes((C, F)) + nbytes(hungarian_cuda.auction_assign(C, F, EPS,
                                                                       cfg.id_threshold)),
                auction_ops(iters, D, K, 2)),
        }
        if htag == "bf16":
            mp, mm = sorted_list_table(lists, 384)
            pairs["K3f table"] = (
                l_tab, lambda: centroid_cuda.circumcenter_features_half_plain(mp, mm, T8, 32),
                "8 sorted f32 lists x C=32, P=384", nbytes(lists) + nbytes(l_tab()),
                k3f_half_ops(mm))
        for name, (fk, fp, shape, moved, ops) in pairs.items():
            # one plain call (the plain auction takes seconds: its spread is
            # nothing beside that); K4 xl's from its check
            ms_p = ms_p2 = (1e3 * keep[htag]["xl_check_s"] if fp is None else once_ms(fp))
            ms_k = cuda_ms(fk, 5)
            ms_k2 = cuda_ms(fk, 5)
            t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            entry = report[name]
            entry["ms"] = min(ms_k, ms_k2)
            entry["plain_ms"] = min(ms_p, ms_p2)
            entry["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            entry["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            entry["library_ms"] = None
            log(f"[5 timing] {smi}: {name} {shape}: kernel {ms_k:.4f}/{ms_k2:.4f} ms, plain "
                f"{ms_p:.4f}/{ms_p2:.4f} ms"
                + (" (the check's one plain call, wrapper and kernel beside it)" if fp is None
                   else " (one plain call, then the kernel twice)")
                + f"; bound {entry['bound_ms']:.6f} ms by {entry['bound_by']} ({moved} bytes, "
                f"{ops} operations); library call none (no PyTorch call solves an assignment "
                "or a circumcenter)")


# ---------------------------------------------------------------------------
# slice 23: K3f's half kernel redesigned (bf16, f16 and the f32 table build)
# ---------------------------------------------------------------------------
K3F_HALF_BUILDS = (("bf16", torch.bfloat16), ("f16", torch.float16), ("table", torch.float32))


def phase_kernels_slice23(dev, report, k19, k20, k21):
    """K3f's redesigned half and table builds (``circumcenter_half_kernel``:
    members compacted, the mean in 32-lane windows, the pair stage in 32 x
    32 tiles dealt over the warps, block reductions under jnp.argmax's
    order) against their plain version on the card, bit for bit, one launch
    a call: the headline's half member tables (S = 8 x C = 32, P = 384; the
    table build on the bf16 ones widened), ``bench_cases.k3f_edge_tables`` at
    P = 100, 384 and 1,100 and ``k3f_tables`` at S = 8 x C = 32, P = 384
    and 512, the half builds also with cy as the multi-device fleet spells
    it; G's sorted lists (C = 64, P = 512; F's f32 lists, C = 32, P = 384,
    for the table build) through ``circumcenter_features_sorted``; P past
    ``HALF_P_MAX`` raising, naming it, and P at it bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import k3f_edge_tables
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features_sorted

    t0 = time.perf_counter()
    cf, plain = centroid_cuda.circumcenter_features, centroid_cuda.circumcenter_features_half_plain
    by = cf.launches_by
    tables = []   # (label, members, mask, frames)
    for p in (100, 384, 1100):
        mp, mm = k3f_edge_tables(2300 + p, p)
        tables.append((f"edge tables S=2 x C=16, P={p}", torch.from_numpy(mp).to(dev),
                       torch.from_numpy(mm).to(dev), 2))
    for p in (384, 512):
        mp, mm = k3f_tables(np.random.default_rng(2300 + p), 8, 32, p, dev)
        tables.append((f"k3f_tables S=8 x C=32, P={p}", mp.double(), mm, 8))
    for build, dt in K3F_HALF_BUILDS:
        name, entry, table = f"K3f {build}", f"motl_circumcenter_features_{build}", build == "table"
        head = k19["bf16" if table else build]
        cases = [(f"the headline's {'bf16 member tables widened' if table else build + ' member tables'}"
                  f", S=8 x C=32, P=384", head["mp"].to(dt), head["mm"], head["T8"].to(dt), 32)]
        for label, mp, mm, s in tables:
            t = (torch.arange(s, device=dev, dtype=torch.float64) * 0.1 + 100.0).to(dt)
            cases.append((label, mp.to(dt), mm, t, mp.shape[0] // s))
        for cy_alt in ((False,) if table else (False, True)):
            with centroid_cuda.mesh_program(cy_alt):
                for label, mp, mm, t, per in cases:
                    n0 = by[entry]
                    check_pair(report, name, label + (", cy as on a multi-device mesh" if cy_alt
                                                      else ""),
                               lambda mp=mp, mm=mm, t=t: (cf(mp, mm, t, table=table),),
                               lambda mp=mp, mm=mm, t=t, per=per, a=cy_alt: (
                                   plain(mp, mm, t, per, a),))
                    if by[entry] != n0 + 1:
                        fail(f"{name}: {by[entry] - n0} launches of {entry} for one call")
        lists, T8, p_max = ((k21["lists"], k21["T8"], 384) if table
                            else (k20[build]["lists"], k20[build]["T8"], 512))
        mpts, mm = sorted_list_table(lists, p_max)
        c = lists[1].shape[1]
        check_pair(report, name, f"8 sorted lists x C={c}, P={p_max} through "
                   "circumcenter_features_sorted",
                   lambda: (circumcenter_features_sorted(*lists, T8, p_max, table=table)
                            .reshape(-1, 4),),
                   lambda: (plain(mpts, mm, T8, c),))
        p = centroid_cuda.HALF_P_MAX
        t1 = torch.zeros(1, dtype=dt, device=dev)
        try:
            cf(torch.zeros((1, p + 1, 3), dtype=dt, device=dev),
               torch.zeros((1, p + 1), dtype=torch.bool, device=dev), t1, table=table)
            fail(f"{name}: P = {p + 1} past HALF_P_MAX did not raise")
        except ValueError as e:
            if "HALF_P_MAX" not in str(e):
                fail(f"{name}: P past the bound raised without naming it: {e}")
            log(f"[3 {name}] P = {p + 1} raises: {e}")
        rng = np.random.default_rng(p)
        mp = torch.from_numpy(rng.normal(0, 2, (2, p, 3))).to(dt).to(dev)
        mm = torch.from_numpy(rng.random((2, p)) < 0.05).to(dev)
        check_pair(report, name, f"2 slots at P = HALF_P_MAX = {p}, ~5% members",
                   lambda: (cf(mp, mm, t1, table=table),), lambda: (plain(mp, mm, t1, 2),))
    log(f"[3 slice 23] K3f's redesigned half and table builds checked in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_timings_slice23(dev, smi):
    """K3f's redesigned builds in turns with its f32 build on the same values
    (``scripts/micro_torch_pair_stats.py::run_half``: the half values
    widened; device us per call from torch.profiler between marker kernels):
    bf16 and f16 on the headline's member tables (S = 8 x C = 32, P = 384;
    the target: within 1.5x of the f32 build), on micro tables at S = 1 and
    8 for (C, P) = (32, 384) and (64, 512) and on sorted lists (C = 64, P =
    512), the table build beside them and on F's form of lists (C = 32, P =
    384); then the half headline and G end to end, ``bind_env`` and
    ``bind_env_multi`` (S = 8) ms/frame over 16 frames in dtype turns (f32,
    bf16, f16, f16, bf16, f32)."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_pair_stats

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    micro_torch_pair_stats.run_half(dev, reps=20, log=log)
    for tag, case in (("the headline", bench_cases.headline_case),
                      ("G", bench_cases.default_case)):
        cfg0, env, sc = case(device=dev)
        P, M, T = half_frames(dev, sc, cfg0.caps.n_max_points, 16)
        trackers = {d: Tracker(cfg0.replace(dtype=d), dev)
                    for d in ("float32", "bfloat16", "float16")}
        for turn, d in enumerate(("float32", "bfloat16", "float16", "float16", "bfloat16",
                                  "float32")):
            ms1, ms8 = time_path(trackers[d], env, P, M, T, reps=2)
            log(f"[5 timing] {smi}: {tag} {d} (turn {turn + 1} of f32, bf16, f16, f16, bf16, "
                f"f32) bind_env {ms1:.4f} ms/frame, bind_env_multi S=8 {ms8:.4f} ms/frame")


PHASE_SECONDS: dict = {}   # wall seconds of each phase main runs


def timed(phase, *args):
    """Run ``phase(*args)``, keeping its wall seconds in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = round(time.perf_counter() - t0, 1)
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_card()
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    timed(phase_build)
    report: dict = {}
    cfg, sc, k1_inputs, table = timed(phase_kernels, dev, report)
    timed(phase_kernels_more, dev, report, cfg, k1_inputs)
    timed(phase_kernels_pointlist, dev, report, cfg, k1_inputs)
    timed(phase_kernels_fleet, dev, report, cfg, k1_inputs)
    timed(phase_kernels_slice5, dev, report, cfg, k1_inputs, table)
    timed(phase_kernels_slice7, dev, report)
    timed(phase_kernels_slice8, dev, report, cfg, k1_inputs)
    timed(phase_kernels_slice11, dev, smi, report, cfg)
    timed(phase_kernels_slice12, dev, smi, report, cfg)
    k13 = timed(phase_kernels_slice13, dev, report, cfg)
    k14 = timed(phase_kernels_slice14, dev, report, cfg)
    timed(phase_kernels_slice15, dev, report)
    timed(phase_kernels_slice16, dev, report)
    timed(phase_kernels_slice17, dev, report)
    k19 = timed(phase_kernels_slice19, dev, report, cfg)
    k20 = timed(phase_kernels_slice20, dev, report, cfg)
    k21 = timed(phase_kernels_slice21, dev, report, cfg)
    timed(phase_kernels_slice23, dev, report, k19, k20, k21)
    tracker, env, frames = timed(phase_slice, dev, cfg, sc, report)
    timed(phase_cli, dev, report)
    timed(phase_ihgp, dev, report)
    timed(phase_hungarian, dev, report)
    timed(phase_f64, dev, report)
    timed(phase_f64_pointlist, dev, report)
    timed(phase_modes, dev, report)
    timed(phase_pointlist, dev, report)
    timed(phase_g_grid, dev, report)
    fleet, fleet_env, fleet_in = timed(phase_fleet, dev, report)
    timed(phase_entry_points, dev, report, cfg, sc, table)
    timed(phase_growth, dev, report)
    timed(phase_floor, dev, report)
    timed(phase_half, dev, smi, report)
    timed(phase_half_pointlist, dev, smi, report)
    timed(phase_hungarian_half, dev, smi, report)
    timed(phase_host_slice19, dev, smi, report)
    timed(phase_timings, dev, cfg, smi, tracker, env, frames, report)
    timed(phase_timings_fleet, dev, smi, fleet, fleet_env, fleet_in)
    timed(phase_timings_slice11, dev, smi, *frames)
    timed(phase_timings_slice12, dev, smi, *frames, report)
    timed(phase_timings_slice13, dev, smi, *frames, report, k13)
    timed(phase_timings_slice14, dev, smi, report, k14)
    timed(phase_learning, dev, smi, report)
    timed(phase_half_learning, dev, smi, report)
    timed(phase_timings_slice16, dev, smi, report)
    timed(phase_timings_slice19, dev, smi, report, k19)
    timed(phase_timings_slice20, dev, smi, report, k20)
    timed(phase_timings_slice21, dev, smi, report, k21)
    timed(phase_timings_slice23, dev, smi)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import micro_torch_digits

    log(f"[5 timing] torch.profiler traces taken again after losing device events: "
        f"{micro_torch_digits.retaken}")
    log(f"[7 phases] seconds by phase, longest first: "
        f"{sorted(PHASE_SECONDS.items(), key=lambda kv: -kv[1])}")
    log(f"[7 total] {time.perf_counter() - t_start:.1f} s from the start, the build included")
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": f"{k}: {desc}", "route": "cuda", "source": src, "replaces": rep,
         **{key: report[k][key] for key in keys}}
        for k, desc, src, rep in KERNELS
    ]
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
