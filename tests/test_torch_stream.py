"""The port's streaming runtime on the CPU (``device="cpu"``): the
asynchronous ring of ``StreamingNode`` publishes exactly what the
synchronous ``TrackerNode`` publishes, and ``serve()`` answers a client
over localhost TCP end to end (tests/test_stream.py's checks of the JAX
package, on the port)."""

import socket
import threading

import numpy as np
import pytest

from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities, TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.io import wire
from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode, serve

TINY = Capacities(n_max_points=2048, m_max_voxels=512, m_max_dynamic=256, c_max_clusters=16,
                  p_max_cluster=64, k_max_tracks=16)
CONFIGS = {
    "defaults": TrackerConfig(voxel_leaf_size=0.1, max_cluster_size=300, data_length=10, caps=TINY),
    "grid": bench_cases.bench_config().replace(data_length=10, caps=TINY),
}


def _frames(n):
    sc = Scenario(grid=bench_cases.load_sim_grid(), objects=[ScenarioObject(0.0, 1.0, 0.0, 0.45)],
                  static_points_per_frame=400, seed=17)
    return [sc.frame(k) for k in range(n)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_streaming_node_matches_sync_node(name):
    cfg = CONFIGS[name]
    frames = _frames(10)
    sync = TrackerNode(cfg, device="cpu")
    sync.on_map(bench_cases.load_sim_grid())
    sync_out = [sync.on_pointcloud(m) for m in frames]

    got = []
    node = StreamingNode(cfg, on_outputs=lambda *recs: got.append(recs), depth=3, device="cpu")
    node.on_map(bench_cases.load_sim_grid())
    for m in frames:
        node.submit(m)
        assert len(node._pending) <= 3
    node.flush()

    want = [r for r in sync_out if r is not None]
    assert len(got) == len(want) >= 8
    for (a_obs, a_mk, a_pose), (b_obs, b_mk, b_pose) in zip(got, want):
        assert [o.id for o in a_obs.obstacles] == [o.id for o in b_obs.obstacles]
        for oa, ob in zip(a_obs.obstacles, b_obs.obstacles):
            np.testing.assert_array_equal(oa.position, ob.position)
            np.testing.assert_array_equal(oa.velocity, ob.velocity)
        assert [m.text for m in a_mk.markers] == [m.text for m in b_mk.markers]
        np.testing.assert_array_equal(a_pose.points, b_pose.points)
        assert a_pose.intensity == b_pose.intensity
    s = node.summary()
    assert s["frames"] == 10 and s["dispatch_ms_p50"] is not None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tcp_stream_end_to_end():
    """Map + 8 frames over TCP in, records + summary out."""
    cfg = CONFIGS["defaults"]
    node = StreamingNode(cfg, depth=2, device="cpu")
    ready = threading.Event()
    result = {}
    port = _free_port()

    def run():
        result.update(serve(node, port=port, max_frames=8, ready=ready))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(10)

    conn = socket.create_connection(("127.0.0.1", port), timeout=60)
    wf = conn.makefile("wb")
    rf = conn.makefile("rb")
    wire.write_map(wf, bench_cases.load_sim_grid())
    for m in _frames(8):
        wire.write_frame(wf, m)
    wf.flush()
    conn.shutdown(socket.SHUT_WR)

    records = []
    while True:
        m = wire.read_message(rf)
        if m is None:
            break
        records.append(m)
        if isinstance(m, tuple) and m[0] == "summary":
            break
    th.join(60)
    conn.close()

    kinds = [r[0] for r in records if isinstance(r, tuple)]
    assert kinds.count("ObstacleArray") >= 6   # the first frame registers only
    assert kinds.count("MarkerArray") == kinds.count("ObstacleArray")
    assert kinds[-1] == "summary"
    assert result["frames"] == 8
    obstacles = [r for r in records if isinstance(r, tuple) and r[0] == "ObstacleArray"]
    ids = {o["id"] for r in obstacles for o in r[1]["obstacles"]}
    assert ids == {0}
