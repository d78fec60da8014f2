"""Live ROS interop demo: tracker <-> rosbridge JSON over a real TCP socket.

Plays BOTH roles so it runs self-contained with zero ROS installed:

* the "ROS side" — a mock rosbridge_tcp endpoint that publishes
  sensor_msgs/PointCloud2 frames of a synthetic two-object scene and prints
  every costmap_converter/ObstacleArrayMsg + MarkerArray it receives back,
  exactly as a TEB planner / RViz stack would see them;
* the tracker side — a stock TrackerNode driven through RosBridgeClient
  (advertise -> subscribe -> publish per frame).

Point it at a REAL rosbridge server instead with --connect host:port — then
the mock side is skipped and the tracker consumes live `/scan_matched_points2`
frames from the robot.

The PyTorch/CUDA port's counterpart of scripts/ros_interop_demo.py: the
same mock endpoint and scene, the port's TrackerNode and rosbridge module,
on the card (--device cuda, the default) or the CPU.  ``main(argv)``
returns a summary (frames, publishes received by the ROS side, the node's
wall ms per frame, the decoder that ran, the round trip's seconds).

Usage: python scripts/ros_interop_demo_torch.py [--frames 12] [--device cpu|cuda] [--strict]
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="torch device of the step (cuda or cpu)")
    ap.add_argument("--decoder", choices=["native", "numpy"], default="native",
                    help="the node's PointCloud2 decoder")
    ap.add_argument("--strict", action="store_true",
                    help="reproduce the reference's in-loop republish quirk (cpp:293)")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="use a real rosbridge server instead of the mock")
    args = ap.parse_args(argv)

    from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig
    from multiple_object_tracking_lidar_tpu_torch.io import rosbridge as rb
    from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ymap = os.path.join(here, "assets", "sim_map.yaml")
    if not os.path.exists(ymap):
        import subprocess

        subprocess.run(
            [sys.executable, os.path.join(here, "assets", "make_fixture_map.py")],
            check=True,
        )
    grid = load_map_yaml(ymap)

    cfg = TrackerConfig(voxel_leaf_size=0.1, data_length=10)
    node = TrackerNode(cfg, device=args.device, use_native=args.decoder == "native")
    node.on_map(grid)
    received = {"publishes": 0, "obstacle_arrays": 0}

    if args.connect:
        host, port = args.connect.rsplit(":", 1)
        port = int(port)
        mock = None
    else:
        # ---- mock ROS side ------------------------------------------------
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        host, port = srv.getsockname()

        sc = Scenario(
            grid=grid,
            objects=[
                ScenarioObject(x0=-0.5, y0=4.0, vx=0.35, vy=0.0, points_per_frame=40),
                ScenarioObject(x0=0.0, y0=1.2, vx=0.0, vy=0.45, points_per_frame=40),
            ],
            static_points_per_frame=2000,
            clutter_points=64,
            seed=7,
        )

        done = threading.Event()   # the feeder has sent every frame

        def ros_side() -> None:
            conn, _ = srv.accept()
            f = conn.makefile("rb")
            # drain advertises/subscribe, then co-run: publish frames, print
            # whatever the tracker publishes back
            n_in = 0
            for line in f:
                msg = json.loads(line)
                op = msg.get("op")
                if op == "advertise":
                    print(f"[ros] advertised {msg['topic']} ({msg['type']})")
                elif op == "subscribe":
                    print(f"[ros] tracker subscribed to {msg['topic']}")
                    threading.Thread(
                        target=feed_frames, args=(conn,), daemon=True
                    ).start()
                elif op == "publish":
                    n_in += 1
                    received["publishes"] += 1
                    if msg["topic"] == rb.OBSTACLE_TOPIC:
                        received["obstacle_arrays"] += 1
                        obs = msg["msg"]["obstacles"]
                        brief = [
                            (
                                o["id"],
                                round(o["polygon"]["points"][0]["x"], 2),
                                round(o["polygon"]["points"][0]["y"], 2),
                                round(o["velocities"]["twist"]["linear"]["x"], 2),
                                round(o["velocities"]["twist"]["linear"]["y"], 2),
                            )
                            for o in obs
                        ]
                        print(f"[ros] ObstacleArrayMsg {brief}")
                    elif msg["topic"] == rb.MARKER_TOPIC:
                        texts = [m["text"] for m in msg["msg"]["markers"]]
                        print(f"[ros] MarkerArray speed labels {texts}")

        def feed_frames(conn: socket.socket) -> None:
            for i in range(args.frames):
                pc = sc.frame(i)
                rb.serve_lines(
                    conn,
                    [
                        {
                            "op": "publish",
                            "topic": rb.INPUT_TOPIC,
                            "msg": rb.pointcloud2_to_ros(pc),
                        }
                    ],
                )
            done.set()

        mock = threading.Thread(target=ros_side, daemon=True)
        mock.start()

    # ---- tracker side -----------------------------------------------------
    inbox: "queue.Queue" = queue.Queue()
    client = rb.RosBridgeClient(
        host, port, on_cloud=inbox.put, strict_republish=args.strict
    )

    import time

    t_start = time.perf_counter()
    n_done = 0
    while n_done < args.frames:
        pc = inbox.get(timeout=120)
        res = node.on_pointcloud(pc)
        n_done += 1
        if res is not None:
            oa, ma, pm = res
            client.send_frame(oa, ma, pm)
    t_loop = time.perf_counter() - t_start
    # let the mock side drain the last publishes
    time.sleep(0.5)
    client.close()
    st = node.stats[-1]
    print(
        f"[tracker] processed {n_done} frames; last frame: "
        f"{st.n_clusters} clusters, {st.n_alive} tracks, {st.wall_ms:.1f} ms"
    )
    wall = [s_.wall_ms for s_ in node.stats]
    return {
        "frames": n_done,
        "publishes_received": received["publishes"],
        "obstacle_arrays_received": received["obstacle_arrays"],
        "last_alive": st.n_alive,
        "wall_ms_p50": sorted(wall)[len(wall) // 2],
        "loop_s": t_loop,
        "decoder": node.decoder,
    }


if __name__ == "__main__":
    print(json.dumps(main()))
