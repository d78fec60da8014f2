"""The port's copies of the host modules, pinned against their originals.

The JAX package cannot be imported without JAX, so the PyTorch port
carries copies of the numpy-only host code it needs.  Each copy must keep
producing exactly what the original produces.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import multiple_object_tracking_lidar_tpu.config as jcfg
import multiple_object_tracking_lidar_tpu_torch.config as tcfg
from multiple_object_tracking_lidar_tpu.io import pointcloud2 as jpc2
from multiple_object_tracking_lidar_tpu.io import scenario as jscen
from multiple_object_tracking_lidar_tpu.models import ihgp as jihgp
from multiple_object_tracking_lidar_tpu.models import matern32 as jm32
from multiple_object_tracking_lidar_tpu.outputs import messages as jmsg
from multiple_object_tracking_lidar_tpu.utils import colors as jcol
from multiple_object_tracking_lidar_tpu.utils import pgm as jpgm
from multiple_object_tracking_lidar_tpu_torch.io import pointcloud2 as tpc2
from multiple_object_tracking_lidar_tpu_torch.io import scenario as tscen
from multiple_object_tracking_lidar_tpu_torch.models import ihgp as tihgp
from multiple_object_tracking_lidar_tpu_torch.models import matern32 as tm32
from multiple_object_tracking_lidar_tpu_torch.outputs import messages as tmsg
from multiple_object_tracking_lidar_tpu_torch.utils import colors as tcol
from multiple_object_tracking_lidar_tpu_torch.utils import pgm as tpgm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_MAP = os.path.join(REPO, "assets", "sim_map.yaml")


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize(
    "path",
    ["assets/sim_01/simTracker.launch", None],
    ids=["launch", "defaults"],
)
def test_config_copy_matches(path):
    if path is None:
        a, b = jcfg.TrackerConfig(), tcfg.TrackerConfig()
    else:
        a = jcfg.load_config(os.path.join(REPO, path))
        b = tcfg.load_config(os.path.join(REPO, path))
    assert _fields(a) == _fields(b)
    assert (a.dt_gp, a.leaf_z) == (b.dt_gp, b.leaf_z)
    assert [f.name for f in dataclasses.fields(jcfg.TrackerConfig)] == [
        f.name for f in dataclasses.fields(tcfg.TrackerConfig)
    ]
    mapping = {"static_tolerance": 7, "caps.k_max_tracks": 32, "scene.z_max": 3.0}
    assert _fields(jcfg.config_from_mapping(mapping)) == _fields(
        tcfg.config_from_mapping(mapping)
    )


def test_bench_config_and_headline_case_match_originals():
    sys.path.insert(0, REPO)
    import bench
    from __graft_entry__ import _bench_config
    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    assert _fields(_bench_config()) == _fields(bench_cases.bench_config())
    jc, jenv, jsc = bench.headline_case()
    tc, tenv, tsc = bench_cases.headline_case()
    assert _fields(jc) == _fields(tc)
    for k in (0, 7):
        jp, jt = jsc.frame_arrays(k)
        tp, tt = tsc.frame_arrays(k)
        assert jt == tt
        np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(np.asarray(jenv.dilated), tenv.dilated.numpy())


def test_map_and_scenario_copies_match():
    ja, tb = jpgm.load_map_yaml(SIM_MAP), tpgm.load_map_yaml(SIM_MAP)
    assert _fields(ja.info) == _fields(tb.info)
    np.testing.assert_array_equal(ja.data, tb.data)
    objs = dict(x0=0.1, y0=1.0, vx=0.3, vy=-0.2, turn_every=2.0)
    js = jscen.Scenario(grid=ja, objects=[jscen.ScenarioObject(**objs)], seed=5, clutter_points=40)
    ts = tscen.Scenario(grid=tb, objects=[tscen.ScenarioObject(**objs)], seed=5, clutter_points=40)
    for k in (0, 3, 41):
        jp, jt = js.frame_arrays(k)
        tp, tt = ts.frame_arrays(k)
        assert jt == tt
        np.testing.assert_array_equal(jp, tp)
        assert js.ground_truth(k) == ts.ground_truth(k)
    jm, tm = js.frame(3), ts.frame(3)
    assert jm.data == tm.data and jm.point_step == tm.point_step
    # decode: the copy keeps only the numpy route
    for n_max in (64, 8192):
        jx, jmask = jpc2.decode_pointcloud2(jm, n_max, use_native=False)
        tx, tmask = tpc2.decode_pointcloud2(tm, n_max)
        np.testing.assert_array_equal(jx, tx)
        np.testing.assert_array_equal(jmask, tmask)


def test_colors_and_messages_copies_match():
    assert jcol.make_colorset(9) == tcol.make_colorset(9)
    g1, g2 = jcol.GlibcRand(5323), tcol.GlibcRand(5323)
    assert [g1.rand() for _ in range(50)] == [g2.rand() for _ in range(50)]
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(4, 2)).astype(np.float32)
    vel = rng.normal(size=(4, 2)).astype(np.float32)
    colors = {i: c for i, c in enumerate(jcol.make_colorset(4))}
    a = jmsg.build_outputs(1.5, "map", [0, 3, 1, 2], pos, vel, colors)
    b = tmsg.build_outputs(1.5, "map", [0, 3, 1, 2], pos, vel, colors)
    assert [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]


@pytest.mark.parametrize("length", [9, 39])
def test_gains_and_smoother_weights_match_f64(length):
    """The host-f64 gain builders are copies: identical f64 outputs."""
    for logs in ((-5.5, -3.5, 0.75), (-4.0, -2.0, 0.2)):
        ja = jihgp.stationary_gains(jm32.matern32_from_log(*logs), 0.1)
        tb = tihgp.stationary_gains(tm32.matern32_from_log(*logs), 0.1)
        for f in dataclasses.fields(ja):
            np.testing.assert_array_equal(getattr(ja, f.name), getattr(tb, f.name))
        jw = jihgp.smoother_weights(ja, length)
        tw = tihgp.smoother_weights(tb, length)
        for k in jw:
            np.testing.assert_array_equal(jw[k], tw[k])
        jx = jihgp.smoother_weights_xy(ja, ja, length)
        tx = tihgp.smoother_weights_xy(tb, tb, length)
        for k in jx:
            np.testing.assert_array_equal(jx[k], tx[k])
        ga, gb = ja.as_jax(), tb.as_arrays()
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k])


def test_tracker_gains_match():
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JT
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TT
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import gains_to_numpy

    cfg = jcfg.TrackerConfig(voxel_mode="onehot", cluster_backend="grid", data_length=40)
    tcfg_ = tcfg.TrackerConfig(voxel_mode="onehot", cluster_backend="grid", data_length=40)
    ja = JT(cfg).gains_xy
    tb = gains_to_numpy(TT(tcfg_, device="cpu").gains_xy)
    assert set(ja) == set(tb)
    for k, v in ja.items():
        if isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(v[kk], tb[k][kk])
        else:
            np.testing.assert_array_equal(v, tb[k])


@pytest.mark.parametrize("gz_max", [1.0, 2.0], ids=["gz1", "gz2"])
def test_static_mask_and_cell_table_match(gz_max):
    from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm
    from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape as jgs
    from multiple_object_tracking_lidar_tpu_torch.ops import static_mask as tsm
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import grid_shape as tgs

    grid_j, grid_t = jpgm.load_map_yaml(SIM_MAP), tpgm.load_map_yaml(SIM_MAP)
    scene = dict(x_min=-2.4, x_max=2.5, y_min=-1.5, y_max=9.4, z_min=0.0, z_max=gz_max)
    js, ts = jcfg.SceneBounds(**scene), tcfg.SceneBounds(**scene)
    dims = jgs(js, 0.1, 2.0)
    assert dims == tgs(ts, 0.1, 2.0)
    jenv = jsm.build_static_mask(grid_j, 2, 50)
    tenv = tsm.build_static_mask(grid_t, 2, 50)
    np.testing.assert_array_equal(np.asarray(jenv.dilated), tenv.dilated.numpy())
    for f in ("origin_x", "origin_y", "cos_nyaw", "sin_nyaw", "inv_resolution"):
        assert np.float32(getattr(jenv, f)) == getattr(tenv, f).numpy()
        assert getattr(tenv, f).dtype == torch.float32
    jt = jsm.build_cell_static_table(jenv, js, 0.1, *dims)
    tt = tsm.build_cell_static_table(tenv, ts, 0.1, *dims)
    assert jt.k == tt.k
    for f in ("base_row", "base_col", "bits"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)), getattr(tt, f).numpy())
        assert getattr(tt, f).dtype == torch.int32


def test_quantize_and_grid_shape_match():
    from multiple_object_tracking_lidar_tpu.ops.voxel import _quantize as jq
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import _quantize as tq

    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 12, (4096, 3)).astype(np.float32)
    pts[:512] = np.round(pts[:512] / 0.1).astype(np.float32) * np.float32(0.1)  # boundaries
    import jax.numpy as jnp

    for a, b in zip(jq(jnp.asarray(pts), 0.1, 2.0), tq(torch.from_numpy(pts), 0.1, 2.0)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_wire_copy_matches_original():
    """The port's io/wire.py writes the bytes the original writes, and each
    reads what the other wrote: frames, records, maps and the framing
    errors."""
    import io

    from multiple_object_tracking_lidar_tpu.io import wire as jwire
    from multiple_object_tracking_lidar_tpu_torch.io import wire as twire

    xyz = np.random.default_rng(9).normal(0, 1, (57, 3)).astype(np.float32)
    msgs = (jpc2.make_pointcloud2(xyz, stamp=12.25, frame_id="base", extra_padding=4),
            tpc2.make_pointcloud2(xyz, stamp=12.25, frame_id="base", extra_padding=4))
    grid = jpgm.load_map_yaml(SIM_MAP)
    rec = jmsg.build_outputs(1.5, "map", [0, 2], np.zeros((2, 2), np.float32),
                             np.ones((2, 2), np.float32), {0: (1, 0, 0, 1), 2: (0, 1, 0, 1)})[0]
    outs = []
    for w, msg in zip((jwire, twire), msgs):
        buf = io.BytesIO()
        w.write_frame(buf, msg)
        w.write_record(buf, rec)
        w.write_map(buf, grid)
        w.write_json(buf, "summary", {"frames": 3})
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    for r in (jwire, twire):
        buf = io.BytesIO(outs[0])
        frame = r.read_message(buf)
        assert (frame.stamp, frame.frame_id, frame.point_step, frame.data) == (
            12.25, "base", 16, msgs[0].data)
        assert [tuple(dataclasses.astuple(f)) for f in frame.fields] == [
            tuple(dataclasses.astuple(f)) for f in msgs[0].fields]
        assert r.read_message(buf)[0] == "ObstacleArray"
        typ, data = r.read_message(buf)
        assert typ == "map" and data["info"]["resolution"] == grid.info.resolution
        assert r.read_message(buf) == ("summary", {"frames": 3})
        assert r.read_message(buf) is None
        with pytest.raises(ValueError):
            r.read_message(io.BytesIO(b"\xff\xff\xff\xff"))
    assert (jwire.MAX_HEADER, jwire.MAX_PAYLOAD) == (twire.MAX_HEADER, twire.MAX_PAYLOAD)


def _pc2_fields(msg):
    return (msg.stamp, msg.frame_id, msg.height, msg.width, msg.is_bigendian,
            msg.point_step, msg.row_step, msg.data, msg.is_dense,
            [dataclasses.astuple(f) for f in msg.fields])


def _scenario_msgs(pc2, n=4):
    """n ragged PointCloud2 frames (one empty) built by ``pc2``."""
    rng = np.random.default_rng(12)
    sizes = (37, 0, 211, 5)[:n]
    return [pc2.make_pointcloud2(rng.normal(0, 2, (s, 3)).astype(np.float32),
                                 stamp=0.1 * (k + 1) + 1e-7 * k, frame_id="map")
            for k, s in enumerate(sizes)]


def test_bag_copy_matches_original(tmp_path):
    """io/bag.py: each package's recording holds the same arrays, replays
    the same messages in either package, and ``bag_info`` agrees."""
    from multiple_object_tracking_lidar_tpu.io import bag as jbag
    from multiple_object_tracking_lidar_tpu_torch.io import bag as tbag

    paths = [str(tmp_path / f"{w}.npz") for w in ("j", "t")]
    assert jbag.record_bag(paths[0], _scenario_msgs(jpc2)) == 4
    assert tbag.record_bag(paths[1], _scenario_msgs(tpc2)) == 4
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in paths:
        ja, tb = list(jbag.replay_bag(path)), list(tbag.replay_bag(path))
        assert [_pc2_fields(m) for m in ja] == [_pc2_fields(m) for m in tb]
        assert jbag.bag_info(path) == tbag.bag_info(path)


def test_rosbag_copy_matches_original(tmp_path):
    """io/rosbag.py: the same bag bytes, the same messages read back by
    either reader (a bz2 chunk included), the same serialization."""
    import bz2

    from multiple_object_tracking_lidar_tpu.io import rosbag as jrb
    from multiple_object_tracking_lidar_tpu_torch.io import rosbag as trb

    paths = [str(tmp_path / f"{w}.bag") for w in ("j", "t")]
    assert jrb.write_rosbag(paths[0], _scenario_msgs(jpc2), topic="/points") == 4
    assert trb.write_rosbag(paths[1], _scenario_msgs(tpc2), topic="/points") == 4
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        raw = a.read()
        assert raw == b.read()
    for r in (jrb, trb):
        assert [_pc2_fields(m) for m in r.read_rosbag(paths[1])] == [
            _pc2_fields(m) for m in jrb.read_rosbag(paths[0])]
        assert list(r.read_rosbag(paths[0], topic="/other")) == []
        assert r.rosbag_info(paths[0]) == jrb.rosbag_info(paths[0])
    msg = _scenario_msgs(jpc2)[2]
    assert trb.serialize_pointcloud2(msg, seq=3) == jrb.serialize_pointcloud2(msg, seq=3)
    # a bz2-compressed chunk: rewrite the one chunk record compressed
    z = tmp_path / "z.bag"
    fields, data, pos = jrb._read_record(raw, 4096 + len(jrb._MAGIC))
    assert fields["op"][0] == jrb._OP_CHUNK
    comp = jrb._record({**fields, "compression": b"bz2"}, bz2.compress(data))
    z.write_bytes(raw[: 4096 + len(jrb._MAGIC)] + comp + raw[pos:])
    assert [_pc2_fields(m) for m in trb.read_rosbag(str(z))] == [
        _pc2_fields(m) for m in jrb.read_rosbag(str(z))]
    for bad in (b"#ROSBAG V1.2\n", b"not a bag at all"):
        (tmp_path / "bad.bag").write_bytes(bad + b"\0" * 16)
        for r in (jrb, trb):
            with pytest.raises(ValueError):
                list(r.read_rosbag(str(tmp_path / "bad.bag")))


def test_svg_copy_matches_original():
    """outputs/svg.py: the same document with and without a map, with and
    without speeds."""
    from multiple_object_tracking_lidar_tpu.outputs import svg as jsvg
    from multiple_object_tracking_lidar_tpu_torch.outputs import svg as tsvg

    tracks = {0: [(0.1, 1.0), (0.12, 1.05), (0.15, 1.1)], 3: [(-0.8, 4.0)], 1: [(0.9, 6.5)]}
    colors = {0: (0.5, 0.25, 0.125, 0.8), 3: (1.0, 0.0, 0.0, 0.5)}
    speeds = {0: 0.4567, 3: 0.0312}
    for grid in (jpgm.load_map_yaml(SIM_MAP), None):
        for sp in (speeds, None):
            a = jsvg.render_svg(grid, tracks, colors, sp, scale=40.0)
            assert a == tsvg.render_svg(grid, tracks, colors, sp, scale=40.0)
            assert a.startswith("<svg") and a.endswith("</svg>")


def test_stage_timer_copy_matches_original():
    """runtime/profiler.py: ``StageTimer`` and ``StageStats`` give the JAX
    package's summary and report on the same samples."""
    from multiple_object_tracking_lidar_tpu.runtime import profiler as jprof
    from multiple_object_tracking_lidar_tpu_torch.runtime import profiler as tprof

    samples = {"decode": [0.5, 0.7, 3.0, 0.4, 0.45, 0.6], "step": [10.0, 2.5], "emit": [0.1]}
    timers = [jprof.StageTimer(), tprof.StageTimer()]
    for tm in timers:
        for name, xs in samples.items():
            for x in xs:
                tm.record(name, x)
        with tm.stage("wrapped"):
            pass
    sj, st = (tm.summary() for tm in timers)
    assert sj.keys() == st.keys()
    for name in samples:
        assert dataclasses.asdict(sj[name]) == dataclasses.asdict(st[name])
    assert st["wrapped"].count == 1
    strip = lambda tm: [ln for ln in tm.report().splitlines() if "wrapped" not in ln]
    assert strip(timers[0]) == strip(timers[1])
    assert [f.name for f in dataclasses.fields(jprof.StageStats)] == [
        f.name for f in dataclasses.fields(tprof.StageStats)]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """``device_trace`` over torch.profiler: the trace holds the ops run
    inside it (CPU activities here)."""
    import json as _json

    from multiple_object_tracking_lidar_tpu_torch.runtime.profiler import device_trace

    with device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).cumsum(0)
    with open(prof.trace_path, encoding="utf-8") as fh:
        names = {e.get("name") for e in _json.load(fh)["traceEvents"]}
    assert "aten::cumsum" in names


# ---- item 25: the rosbridge copy and the native decoder ---------------------

def _rb_modules(pkg):
    import importlib

    rb = importlib.import_module(pkg + ".io.rosbridge")
    pc2 = importlib.import_module(pkg + ".io.pointcloud2")
    msg = importlib.import_module(pkg + ".outputs.messages")
    return rb, pc2, msg


PKGS = ["multiple_object_tracking_lidar_tpu", "multiple_object_tracking_lidar_tpu_torch"]


def test_rosbridge_copy_is_the_original():
    """The copy's source is the original's with the package renamed."""
    src = {}
    for pkg in PKGS:
        path = os.path.join(REPO, pkg, "io", "rosbridge.py")
        with open(path, encoding="utf-8") as f:
            src[pkg] = f.read()
    assert src[PKGS[1]] == src[PKGS[0]].replace(PKGS[0] + ".", PKGS[1] + ".")


def _rb_outputs(msgmod, n):
    ids = list(range(n))
    pos = np.arange(2 * n, dtype=np.float64).reshape(n, 2) * 0.5
    vel = np.ones((n, 2)) * 0.31
    colors = {i: (0.1 * i, 0.2 * i, 0.3 * i, 0.8) for i in ids}
    return msgmod.build_outputs(12.25, "map", ids, pos, vel, colors)


@pytest.mark.parametrize("strict", [False, True])
def test_rosbridge_schemas_and_republish_match_original(strict):
    """Every op each package emits for the same frame (obstacles, markers,
    pose cloud, the advertises and the subscribe), normalised and strict
    (the reference's republish quirk, cpp:293), is the same JSON."""
    import json

    ops = []
    for pkg in PKGS:
        rb, _, msgmod = _rb_modules(pkg)
        oa, ma, pm = _rb_outputs(msgmod, 3)
        ops.append(json.dumps([rb.publish_ops(oa, ma, pm, strict_republish=strict),
                               rb.advertise_ops(), rb.subscribe_op(),
                               rb.obstacle_array_to_ros(oa, seq=7),
                               rb.marker_array_to_ros(ma, oa.stamp, seq=3),
                               rb.pose_cloud_to_ros(pm, oa.stamp)], sort_keys=True))
    assert ops[0] == ops[1]
    n_ob = sum(1 for o in json.loads(ops[1])[0] if o["topic"] == "move_base/TebLocalPlannerROS/obstacles")
    assert n_ob == (3 if strict else 1)


@pytest.mark.parametrize("byte_list", [False, True])
def test_rosbridge_pointcloud2_round_trip_matches_original(byte_list):
    import json

    xyz = np.random.default_rng(21).normal(size=(100, 3)).astype(np.float32)
    got = []
    for pkg in PKGS:
        rb, pc2, _ = _rb_modules(pkg)
        pc = pc2.make_pointcloud2(xyz, stamp=3.5, frame_id="velo", extra_padding=4)
        msg = rb.pointcloud2_to_ros(pc)
        json.dumps(msg)
        if byte_list:
            msg["data"] = list(pc.data)
        back = rb.pointcloud2_from_ros(msg)
        out, mask = pc2.decode_pointcloud2(back, 128, use_native=False)
        got.append((json.dumps(rb.pointcloud2_to_ros(back), sort_keys=True), out, mask))
        assert back.stamp == 3.5 and back.frame_id == "velo"
        np.testing.assert_array_equal(out[:100], xyz)
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_rosbridge_live_tcp_round_trip_through_the_port_node():
    """The port's TrackerNode on the CPU behind its RosBridgeClient, over a
    loopback socket: advertises + subscribe, clouds in, obstacle arrays
    out, the same records the JAX node publishes for the same clouds."""
    import json
    import socket
    import threading

    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
    from multiple_object_tracking_lidar_tpu_torch.io import rosbridge as rb
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    grid = tpgm.load_map_yaml(SIM_MAP)
    cfg = tcfg.TrackerConfig(voxel_leaf_size=0.1, data_length=10)
    sc = tscen.Scenario(grid=grid, objects=[
        tscen.ScenarioObject(x0=-0.5, y0=4.0, vx=0.35, vy=0.0, points_per_frame=40),
        tscen.ScenarioObject(x0=0.0, y0=1.2, vx=0.0, vy=0.45, points_per_frame=40)],
        static_points_per_frame=600, clutter_points=16, seed=7)
    frames = [sc.frame(k) for k in range(4)]
    node = TrackerNode(cfg, device="cpu")
    node.on_map(grid)
    jnode = JNode(jcfg.TrackerConfig(voxel_leaf_size=0.1, data_length=10))
    jnode.on_map(jpgm.load_map_yaml(SIM_MAP))

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    inbox, got = [], threading.Event()

    def on_cloud(pc):
        inbox.append(pc)
        if len(inbox) == len(frames):
            got.set()

    client = rb.RosBridgeClient("127.0.0.1", srv.getsockname()[1], on_cloud=on_cloud)
    conn, _ = srv.accept()
    f = conn.makefile("rb")
    head = [json.loads(f.readline()) for _ in range(4)]
    assert [h["op"] for h in head] == ["advertise"] * 3 + ["subscribe"]
    rb.serve_lines(conn, [{"op": "publish", "topic": rb.INPUT_TOPIC,
                           "msg": rb.pointcloud2_to_ros(pc)} for pc in frames])
    assert got.wait(10.0)
    published = 0
    for pc, jpc in zip(inbox, frames):
        res = node.on_pointcloud(pc)
        jres = jnode.on_pointcloud(jpc)
        assert (res is None) == (jres is None)
        if res is None:
            continue
        n_ops = client.send_frame(*res)
        ops = [json.loads(f.readline()) for _ in range(n_ops)]
        want = rb.obstacle_array_to_ros(jres[0], seq=0)["obstacles"]
        ob = [o for o in ops if o["topic"] == rb.OBSTACLE_TOPIC][0]["msg"]["obstacles"]
        assert [o["id"] for o in ob] == [o["id"] for o in want]
        np.testing.assert_allclose([o["polygon"]["points"][0]["x"] for o in ob],
                                   [o["polygon"]["points"][0]["x"] for o in want], atol=1e-6)
        published += 1
    assert published >= 2 and node.decoder == "native"
    client.close()
    conn.close()
    srv.close()


def _jax_native_on(path):
    """The JAX package's ctypes binding, loading the library at ``path``."""
    from multiple_object_tracking_lidar_tpu.io import native as jnative

    jnative._LIB, jnative._TRIED = None, False
    orig = jnative._lib_path
    jnative._lib_path = lambda: path
    try:
        assert jnative.native_available()
    finally:
        jnative._lib_path = orig
    return jnative


def test_native_decoder_matches_numpy_and_the_original_binding():
    """The port builds native/motl_host.cpp under build/native/ and decodes
    bit for bit as numpy and as the JAX package's binding of the same
    library: NaN / inf rows dropped, padding, truncation past n_max, a
    big-endian cloud; a layout it does not take decodes with numpy."""
    from multiple_object_tracking_lidar_tpu_torch.io import native as tnative

    path = tnative.build_native()
    assert path.startswith(os.path.join(REPO, "build", "native"))
    jnative = _jax_native_on(path)
    rng = np.random.default_rng(23)
    xyz = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    xyz[11] = np.nan
    xyz[200, 1] = np.inf
    for n_max in (600, 64):
        for big in (False, True):
            msg = tpc2.make_pointcloud2(xyz, stamp=2.0, extra_padding=4)
            if big:
                rec = np.frombuffer(msg.data, np.uint8).reshape(500, -1).copy()
                rec[:, :12] = rec[:, :12].reshape(500, 3, 4)[:, :, ::-1].reshape(500, 12)
                msg = dataclasses.replace(msg, data=rec.tobytes(), is_bigendian=True)
            got = tpc2.decode_pointcloud2_named(msg, n_max)
            want = tpc2.decode_pointcloud2_named(msg, n_max, use_native=False)
            orig = jnative.decode_pc2_native(msg, n_max)
            assert (got[2], want[2]) == ("native", "numpy")
            for g, w, o in zip(got[:2], want[:2], orig):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, o)
    assert int(tpc2.decode_pointcloud2(msg, 64)[1].sum()) == 64
    f64 = tpc2.make_pointcloud2(xyz[:10].astype(np.float64), stamp=1.0)
    if any(f.datatype == 8 for f in f64.fields):
        assert tpc2.decode_pointcloud2_named(f64, 16)[2] == "numpy"
    for seed in (0, 12345):
        np.testing.assert_array_equal(tnative.glibc_colors_native(seed, 37),
                                      jnative.glibc_colors_native(seed, 37))


def test_native_decoder_that_fails_to_build_raises(tmp_path, monkeypatch):
    """use_native=True never falls back to numpy quietly: a library that
    does not build raises; use_native=False decodes with numpy."""
    from multiple_object_tracking_lidar_tpu_torch.io import native as tnative

    bad = tmp_path / "motl_host.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build_native(str(bad))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    msg = tpc2.make_pointcloud2(np.zeros((4, 3), np.float32), stamp=0.0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tpc2.decode_pointcloud2(msg, 8)
    assert not tnative.native_available()
    assert tpc2.decode_pointcloud2_named(msg, 8, use_native=False)[2] == "numpy"
