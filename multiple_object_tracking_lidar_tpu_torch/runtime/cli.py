"""Command-line driver — the framework's `main()` (ref: node.cpp:4-33).

Port of ``multiple_object_tracking_lidar_tpu/runtime/cli.py``: the same
subcommands, flags, JSON-line records on stdout and JSON records on stderr.

Subcommands:
  run    replay a scenario ("bag") through the tracker, emit JSON-lines
  bench  the port's throughput benchmark (not ported yet: raises)
  tune   GP hyperparameter fitting on a scenario's velocity windows
  info   print config + device summary

``run`` and ``tune`` take one flag the JAX CLI lacks, ``--device``
(default ``cuda``): the tracker and the learning step (K13) run on the card
unless the caller asks for the CPU, and without a CUDA device they raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _load_cfg(args):
    from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig, load_config

    cfg = load_config(args.config) if args.config else TrackerConfig()
    if args.data_length:
        cfg = cfg.replace(data_length=args.data_length)
    return cfg


def _apply_backend(cfg, grid, backend: str):
    """backend='grid' switches to the dense-grid kernel perception path with
    the scene bounds derived from the map's extent (grid-mode cost scales
    with the cell count)."""
    if backend != "grid":
        return cfg
    from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds

    return cfg.replace(
        voxel_mode="onehot",
        cluster_backend="grid",
        scene=SceneBounds.from_map(
            grid.info.width, grid.info.height, grid.info.resolution,
            grid.info.origin_x, grid.info.origin_y,
        ),
    )


def cmd_run(args) -> int:
    import numpy as np

    from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml

    cfg = _load_cfg(args)
    grid = load_map_yaml(args.map)
    cfg = _apply_backend(cfg, grid, getattr(args, "backend", "default"))
    node = TrackerNode(
        cfg, device=args.device, use_native=getattr(args, "decoder", "native") == "native"
    )
    node.on_map(grid)

    ckpt = getattr(args, "checkpoint", None)
    if ckpt and os.path.exists(ckpt):
        from multiple_object_tracking_lidar_tpu_torch.runtime.checkpoint import load_state

        state, meta = load_state(ckpt, device=args.device)
        node.resume(state, meta)
        print(
            json.dumps({"resumed": ckpt, "alive": int(state.bank.alive.sum())}),
            file=sys.stderr,
        )

    if getattr(args, "bag", None):
        if args.bag.endswith(".bag"):
            # real ROS1 v2.0 container (the reference's input artifact,
            # ref: README.md:37-43)
            from multiple_object_tracking_lidar_tpu_torch.io.rosbag import read_rosbag

            frames_iter = list(read_rosbag(args.bag))[: args.frames]
        else:
            from multiple_object_tracking_lidar_tpu_torch.io.bag import replay_bag

            frames_iter = list(replay_bag(args.bag))[: args.frames]
    else:
        objs = [
            ScenarioObject(x0=0.0, y0=1.0, vx=0.0, vy=0.45, turn_every=8.0),
            ScenarioObject(x0=-0.8, y0=4.0, vx=0.35, vy=0.0, turn_every=6.0),
            ScenarioObject(x0=0.9, y0=6.5, vx=-0.25, vy=0.25, turn_every=7.0),
        ][: args.objects]
        # scale the synthetic static returns to the configured point capacity
        # so object returns are never truncated away
        sc = Scenario(
            grid=grid,
            objects=objs,
            frequency=cfg.frequency,
            static_points_per_frame=min(4000, cfg.caps.n_max_points // 2),
        )
        frames_iter = [sc.frame(k) for k in range(args.frames)]

    if getattr(args, "record_bag", None):
        if args.record_bag.endswith(".bag"):
            from multiple_object_tracking_lidar_tpu_torch.io.rosbag import write_rosbag

            write_rosbag(args.record_bag, frames_iter)
        else:
            from multiple_object_tracking_lidar_tpu_torch.io.bag import record_bag

            record_bag(args.record_bag, frames_iter)

    trajectories: dict[int, list] = {}
    speeds: dict[int, float] = {}
    for k, msg in enumerate(frames_iter):
        result = node.on_pointcloud(msg)
        if result is None:
            continue
        obstacles, markers, _ = result
        rec = {
            "frame": k,
            "t": round(msg.stamp, 3),
            "obstacles": [
                {
                    "id": o.id,
                    "pos": [round(v, 4) for v in o.position[:2]],
                    "vel": [round(v, 4) for v in o.velocity[:2]],
                }
                for o in obstacles.obstacles
            ],
            "speed_labels": [m.text for m in markers.markers],
        }
        print(json.dumps(rec))
        for o in obstacles.obstacles:
            trajectories.setdefault(o.id, []).append(tuple(o.position[:2]))
            speeds[o.id] = float(np.hypot(o.velocity[0], o.velocity[1]))

    if getattr(args, "svg", None) and trajectories:
        from multiple_object_tracking_lidar_tpu_torch.outputs.svg import render_svg

        with open(args.svg, "w", encoding="utf-8") as f:
            f.write(render_svg(grid, trajectories, node.colors, speeds))
        print(json.dumps({"svg": args.svg, "tracks": len(trajectories)}), file=sys.stderr)

    if node.stats:
        wall = [s.wall_ms for s in node.stats[3:]] or [s.wall_ms for s in node.stats]
        print(
            json.dumps(
                {
                    "summary": {
                        "frames": len(node.stats),
                        "decoder": node.decoder,
                        "mean_ms": round(float(np.mean(wall)), 3),
                        "p50_ms": round(float(np.percentile(wall, 50)), 3),
                        "p99_ms": round(float(np.percentile(wall, 99)), 3),
                    }
                }
            ),
            file=sys.stderr,
        )
    if ckpt:
        from multiple_object_tracking_lidar_tpu_torch.runtime.checkpoint import save_state

        save_state(ckpt, node.state, extra=node.checkpoint_extra())
        print(json.dumps({"checkpoint": ckpt}), file=sys.stderr)
    return 0


def cmd_tune(args) -> int:
    """Fit (logMagnSigma2, logLengthScale) on velocity windows harvested
    from a scenario run -- the reference's dead hyperparameter-learning loop
    (IHGP_nonfixed, cpp:922-1011) as a working workflow (JAX cli.py:163-215):
    the same scenario, windows and JSON lines, each step one K13 launch on
    the card."""
    import numpy as np
    import torch

    from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
    from multiple_object_tracking_lidar_tpu_torch.models.learning import (
        learning_step,
        velocity_windows,
    )
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml

    cfg = _load_cfg(args)
    grid = load_map_yaml(args.map)
    cfg = _apply_backend(cfg, grid, getattr(args, "backend", "default"))
    node = TrackerNode(
        cfg, device=args.device, use_native=getattr(args, "decoder", "native") == "native"
    )
    node.on_map(grid)
    sc = Scenario(
        grid=grid,
        objects=[ScenarioObject(0.0, 1.0, 0.0, 0.45, turn_every=8.0)],
        frequency=cfg.frequency,
        static_points_per_frame=min(4000, cfg.caps.n_max_points // 2),
    )

    # harvest mean-centered velocity windows from the live track bank: each
    # alive track's x row, as the JAX CLI's numpy computes it in the compute
    # dtype (velocity_windows), f32 out
    windows = []
    for k in range(args.frames):
        node.on_pointcloud(sc.frame(k))
        bank = node.state.bank
        alive = bank.alive.cpu()
        windows.extend(velocity_windows(bank.window.cpu()[alive][..., 0], cfg.dt_gp))
    # float32 whatever the tracker's dtype, as the JAX CLI runs the step
    dev = node.tracker.device
    y = torch.from_numpy(np.stack(windows)).to(dev)
    mask = torch.ones(len(windows), dtype=torch.bool, device=dev)

    lp = torch.tensor([cfg.logSigma2_x, cfg.logMagnSigma2_x, cfg.logLengthScale_x],
                      dtype=torch.float32, device=dev)
    for step_i in range(args.steps):
        lp, nll = learning_step(lp, y, mask, cfg.dt_gp)
        print(
            json.dumps(
                {
                    "step": step_i,
                    "nll": round(float(nll), 4),
                    "logMagnSigma2": round(float(lp[1]), 4),
                    "logLengthScale": round(float(lp[2]), 4),
                }
            )
        )
    return 0


def cmd_bench(_args) -> int:
    raise NotImplementedError(
        "bench is not ported yet: the JAX CLI runs bench.py, which imports JAX, "
        "and the port's benchmark does not exist yet (ROADMAP Queue 1 item 10)"
    )


def cmd_info(args) -> int:
    import torch

    cfg = _load_cfg(args)
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    print(f"devices: {names or ['cpu']} (cuda device_count {n})", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mot-lidar-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="replay a scenario or bag through the tracker")
    pr.add_argument("--map", required=True, help="map YAML (map_server format)")
    pr.add_argument("--config", help="config file (.yaml/.json/.launch)")
    pr.add_argument("--frames", type=int, default=100)
    pr.add_argument("--objects", type=int, default=2)
    pr.add_argument("--data-length", type=int, dest="data_length")
    pr.add_argument("--bag", help="replay frames from a bag instead of synthesizing (.bag = ROS1 v2.0 container, anything else = npz)")
    pr.add_argument("--record-bag", dest="record_bag", help="record the frames to a bag (.bag = ROS1 v2.0 container, anything else = npz)")
    pr.add_argument("--svg", help="write track trajectories to an SVG file")
    pr.add_argument(
        "--backend",
        choices=["default", "grid"],
        default="default",
        help="'grid' switches to the dense-grid kernel perception path "
        "(voxel_mode=onehot, cluster_backend=grid, scene from the map)",
    )
    pr.add_argument(
        "--checkpoint",
        help="resume TrackerState from this .npz if it exists; always save "
        "to it on exit (runtime/checkpoint.py; bit-exact resume)",
    )
    pr.add_argument(
        "--device",
        default="cuda",
        help="torch device the tracker runs on (default cuda; 'cpu' runs the "
        "plain PyTorch versions of the kernels)",
    )
    pr.add_argument(
        "--decoder",
        choices=["native", "numpy"],
        default="native",
        help="PointCloud2 decoder: 'native' (native/motl_host.cpp, built with "
        "g++ at first use; a failed build raises) or 'numpy'",
    )
    pr.set_defaults(fn=cmd_run)

    pt = sub.add_parser(
        "tune", help="fit GP hyperparameters on a scenario (resurrected IHGP_nonfixed)"
    )
    pt.add_argument("--map", required=True)
    pt.add_argument("--config", help="config file")
    pt.add_argument(
        "--backend", choices=["default", "grid"], default="default",
        help="'grid' tunes on the dense-grid kernel perception path",
    )
    pt.add_argument("--frames", type=int, default=60)
    pt.add_argument("--steps", type=int, default=30)
    pt.add_argument("--data-length", type=int, dest="data_length")
    pt.add_argument(
        "--device",
        default="cuda",
        help="torch device the tracker and the learning step run on (default cuda; "
        "'cpu' runs the plain PyTorch versions of the kernels)",
    )
    pt.set_defaults(fn=cmd_tune)

    pb = sub.add_parser("bench", help="run the throughput benchmark (not ported yet)")
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="print config and devices")
    pi.add_argument("--config", help="config file")
    pi.add_argument("--data-length", type=int, dest="data_length")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
