"""The kernel fleet across several cards of one host: B = 8 headline
streams on ``--ranks`` processes, one card each, joined by NCCL (gloo with
``--device cpu``), on three mesh shapes -- the streams split (ranks x 1),
each cloud's points split (1 x ranks), and both (2 x ranks / 2).

    python3 scripts/fleet_multichip.py [--ranks 4] [--steps 3] [--device cuda|cpu]

First, in this process, the one-card fleet (a 1 x 1 mesh on card 0) as
the baseline of the same call.  Then every rank checks, per mesh shape,
that its streams' outputs equal each stream's own ``bind_env`` on its card
bit for bit, and that every step made exactly two ``all_reduce`` calls
(the int32 digit sums and the point counts over the space group) and no
other collective.  Rank 0 prints the fleet's ms per cloud (CUDA events
around 3 runs of all steps, after a warm-up, with a barrier before each
run) beside the card's name and power limit.  Exits 1 if any check fails
or no GPU is found (unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(sc, n, b, n_steps):
    """(points (steps, B, n, 3), mask (steps, B, n), t (steps, B)) as numpy:
    stream s at step k gets headline frame 3 s + k."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame

    rows = [[padded_frame(sc, 3 * s + k, n) for s in range(b)] for k in range(n_steps)]
    return tuple(np.stack([np.stack([r[i] for r in row]) for row in rows]) for i in range(3))


def _time_fleet(fleet, env, frames, dev, barrier=None, reps=3) -> float:
    """ms per cloud of the whole fleet: all steps, ``reps`` runs after a
    warm-up, CUDA events (host clock on the CPU)."""
    P, M, T = frames
    step = fleet.bind_env(env)
    n_steps, b = P.shape[0], P.shape[1] * fleet.n_stream

    def run():
        st = fleet.init_state(b)
        for k in range(n_steps):
            st, _ = step(st, P[k], M[k], T[k])

    run()
    if barrier:
        barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            run()
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        ms = 1e3 * (time.perf_counter() - t0)
    return ms / (reps * n_steps * b)


def _rank(rank: int, world: int, port: int, args, smi: str) -> None:
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.parallel.sharding import (
        ShardedTracker, local_shard, make_mesh)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cuda = args.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    cfg, env, sc = bench_cases.headline_case(device=dev)
    tracker = Tracker(cfg, dev)
    pts, mask, ts = _frames(sc, cfg.caps.n_max_points, args.streams, args.steps)

    calls = {"all_reduce": 0, "other": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    shapes = [(world, 1), (1, world)] + ([(2, world // 2)] if world % 2 == 0 and world > 2 else [])
    for n_stream, n_space in shapes:
        mesh = make_mesh(n_stream, n_space, device=dev)
        fleet = ShardedTracker(tracker, mesh, kernel_path="on")
        frames = tuple(torch.from_numpy(np.stack([local_shard(a[k], mesh) for k in range(args.steps)]))
                       .to(dev) for a in (pts, mask, ts))
        real_ar = dist.all_reduce
        others = {n: getattr(dist, n) for n in ("all_gather", "all_gather_into_tensor",
                                                 "broadcast", "reduce", "reduce_scatter_tensor",
                                                 "all_to_all_single")}
        dist.all_reduce = counting("all_reduce", real_ar)
        for n, fn in others.items():
            setattr(dist, n, counting("other", fn))
        step = fleet.bind_env(env)
        state = fleet.init_state(args.streams)
        outs = []
        for k in range(args.steps):
            before = dict(calls)
            state, o = step(state, frames[0][k], frames[1][k], frames[2][k])
            if calls["all_reduce"] - before["all_reduce"] != 2 or calls["other"] != before["other"]:
                raise SystemExit(f"rank {rank} mesh {n_stream}x{n_space} step {k}: collectives {calls}")
            outs.append(o)
        dist.all_reduce = real_ar
        for n, fn in others.items():
            setattr(dist, n, fn)
        # each local stream against its own bind_env on this card
        i = mesh.get_local_rank("stream")
        b_local = args.streams // n_stream
        one = tracker.bind_env(env)
        for s in range(b_local):
            g = i * b_local + s
            st = tracker.init_state()
            for k in range(args.steps):
                st, o = one(st, Frame(*(torch.as_tensor(a[k, g]).to(dev) for a in (pts, mask, ts))))
                for f, x, y in zip(o._fields, o, outs[k]):
                    if x.cpu().numpy().tobytes() != y[s].cpu().numpy().tobytes():
                        raise SystemExit(f"rank {rank} mesh {n_stream}x{n_space}: stream {g} step {k} "
                                         f"field {f} differs from its bind_env")
        ms = _time_fleet(fleet, env, frames, dev, barrier=dist.barrier)
        worst = torch.tensor([ms], dtype=torch.float64, device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        if rank == 0:
            print(f"[fleet {n_stream}x{n_space}] {smi}: {world} ranks, B={args.streams} x {args.steps} "
                  f"steps: every stream bit for bit its bind_env, 2 all_reduce per step; slowest "
                  f"rank {float(worst):.4f} ms/cloud ({1e3 / float(worst):.1f} clouds/s)", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
            print(f"needs {args.ranks} GPUs", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    else:
        smi = "cpu (gloo)"
    print(smi.replace("\n", "; "), flush=True)

    # the one-card baseline, in this process
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.parallel.sharding import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    cfg, env, sc = bench_cases.headline_case(device=dev)
    fleet = ShardedTracker(Tracker(cfg, dev), make_mesh(1, 1, device=dev), kernel_path="on")
    frames = tuple(torch.from_numpy(a).to(dev)
                   for a in _frames(sc, cfg.caps.n_max_points, args.streams, args.steps))
    ms = _time_fleet(fleet, env, frames, dev)
    print(f"[fleet 1x1] {smi.splitlines()[0]}: one card, B={args.streams} x {args.steps} steps: "
          f"{ms:.4f} ms/cloud ({1e3 / ms:.1f} clouds/s)", flush=True)
    torch.distributed.destroy_process_group()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_rank, args=(args.ranks, port, args, smi.splitlines()[0]),
                                nprocs=args.ranks, join=True)
    print("FLEET_MULTICHIP_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
