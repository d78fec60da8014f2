"""Hungarian association through the port's entry points against the JAX
package on the CPU (``Tracker(cfg.replace(association="hungarian"),
device="cpu")``: K4's plain version, whose auction is
``ops/hungarian.py::auction_assign_plain``).

- The headline slice at tiny caps (N = 8,192 points, C = 16, K = 16)
  through ``bind_env``, ``bind_env_multi`` and ``bind_env_pipelined``
  under ``lpf`` and ``ihgp``, frame for frame against the same JAX entry
  points.
- The dense scene (``bench_cases.dense_case``, 40 objects 0.55 m apart
  under a 0.5 m gate, C = 64, K = 96) cut to 16,384 points: the port's
  track step on the JAX perception's detections against the JAX
  ``track_step``; ``bind_env`` against the JAX ``bind_env``, every integer
  exact and every float within the tolerances (F8, two circumcenters once
  1.3e-5 and 4.4e-4 m off, is repaired: ROADMAP Queue 3), and its cause
  shown on the full dense frame 3: the JAX package's jitted CPU voxel sums
  are the port's digit scheme with the quantize, the cell centre and the
  finalize each contracted into an FMA, which K1 now spells too.
- The fleet (``ShardedTracker``, kernel form, B = 2 streams) against the
  JAX ``ShardedTracker``; ``TrackerNode`` against the JAX ``TrackerNode``,
  its per-frame stats (``assoc_saturated`` among them) included; and
  ``StreamingNode`` against the port's ``TrackerNode``.

Every JAX program is built once per module.  Tolerances: decisions, ids,
counters and flags exact; positions and detections within 1e-5 m,
velocities within 1e-4 m/s on valid lanes (test_torch_pipeline.py's
bounds and reasons).
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_POS, TOL_VEL = 1e-5, 1e-4
S = 4
TINY = dict(n_max_points=8192, m_max_voxels=1024, m_max_dynamic=256, c_max_clusters=16,
            p_max_cluster=128, k_max_tracks=16)


def _jax_config(tcfg):
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["caps"] = JCaps(**dataclasses.asdict(tcfg.caps))
    kw["scene"] = JScene(**dataclasses.asdict(tcfg.scene))
    return JConfig(**kw)


def _cut(sc, n, n_frames, keep):
    """Frames of ``sc`` cut to n points by ``keep(pts)``, zero-padded."""
    frames = []
    for k in range(n_frames):
        pts, t = sc.frame_arrays(k)
        sub = keep(pts)[:n]
        buf = np.zeros((n, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(n, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    return frames


@functools.lru_cache(maxsize=None)
def _case(name):
    """(tcfg, tenv, jcfg, jenv, frames) of a named case."""
    if name == "dense":
        tcfg, tenv, sc = bench_cases.dense_hungarian_case()
        n = 16384
        tcfg = tcfg.replace(caps=dataclasses.replace(tcfg.caps, n_max_points=n))
        # the walls every 20th point, every object point, every 2nd clutter point
        frames = _cut(sc, n, 4, lambda p: np.concatenate([p[:85800:20], p[85800:91000],
                                                          p[91000::2]]))
    else:
        tcfg, tenv, sc = bench_cases.hungarian_case()
        tcfg = tcfg.replace(position_filter=name, caps=dataclasses.replace(tcfg.caps, **TINY))
        frames = _cut(sc, TINY["n_max_points"], 8,
                      lambda p: np.concatenate([p[:95200:20], p[95200:99700:2], p[99700:]]))
    jcfg = _jax_config(tcfg)
    jenv = jsm.build_static_mask(load_map_yaml(bench_cases.SIM_MAP), jcfg.static_tolarance,
                                 jcfg.occupied_threshold)
    return tcfg, tenv, jcfg, jenv, frames


def _stacked(frames, lib):
    if lib == "jax":
        return JFrame(*(jnp.asarray(np.stack([f[i] for f in frames])) for i in range(3)))
    return TFrame(*(torch.from_numpy(np.stack([f[i] for f in frames])) for i in range(3)))


def _outputs(tracker, env, entry, frames, lib):
    """Per-frame FrameOutputs of ``entry`` (JAX: numpy fields)."""
    st = tracker.init_state()
    kw = {"donate_state": False} if lib == "jax" else {}
    outs = []
    if entry == "bind_env":
        step = tracker.bind_env(env, **kw)
        for buf, mask, t in frames:
            if lib == "jax":
                st, o = step(st, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
                o = jax.tree.map(np.asarray, o)
            else:
                st, o = step(st, TFrame(torch.from_numpy(buf), torch.from_numpy(mask),
                                        torch.tensor(t)))
            outs.append(o)
        return outs
    run = getattr(tracker, entry)(env, **kw)
    for lo in range(0, len(frames), S):
        st, o = run(st, _stacked(frames[lo:lo + S], lib))
        if lib == "jax":
            o = jax.tree.map(np.asarray, o)
        outs += [type(o)(*(x[i] for x in o)) for i in range(S)]
    return outs


def _check(tag, got, ref):
    v = np.asarray(ref.valid)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        if f in ("pos", "vel"):
            tol = TOL_VEL if f == "vel" else TOL_POS
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_POS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


@pytest.mark.parametrize(
    "name,entry",
    [("lpf", "bind_env"), ("lpf", "bind_env_multi"), ("ihgp", "bind_env"),
     ("ihgp", "bind_env_pipelined"), ("lpf", "bind_env_pipelined")],
)
def test_hungarian_entry_point_matches_jax(name, entry):
    tcfg, tenv, jcfg, jenv, frames = _case(name)
    ref = _outputs(JTracker(jcfg), jenv, entry, frames, "jax")
    got = _outputs(TTracker(tcfg, device="cpu"), tenv, entry, frames, "torch")
    published = 0
    for k, (g, r) in enumerate(zip(got, ref)):
        _check(f"{name} {entry} frame {k}", g, r)
        ids = g.obj_id.numpy()[g.valid.numpy()]
        assert len(ids) == len(set(ids.tolist()))             # one detection per track
        published += int(g.valid.sum())
    assert published >= 2 * (len(frames) - 1)


def test_dense_track_step_matches_jax_on_jax_detections():
    """The Hungarian track step on the dense scene's detections (the JAX
    perception's, handed to both packages): every output exact or within
    the tolerances, every frame."""
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import perceive as j_perceive
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_step

    tcfg, _, jcfg, jenv, frames = _case("dense")
    jt, tt = JTracker(jcfg), TTracker(tcfg, device="cpu")
    jperc = jax.jit(functools.partial(j_perceive, config=jcfg))
    jstep = jax.jit(functools.partial(j_track_step, config=jcfg, gains_xy=jt.gains_xy))
    js, ts = jt.init_state(), tt.init_state()
    published = 0
    for k, (buf, mask, t) in enumerate(frames):
        p = jperc(JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)), jenv)
        js, jo = jstep(js, p)
        tp = Perception(*(torch.from_numpy(np.array(x)) for x in p))
        ts, to = track_step(ts, tp, config=tcfg, gains_xy=tt.gains_xy)
        _check(f"dense track step frame {k}", to, jax.tree.map(np.asarray, jo))
        published += int(to.valid.sum())
    assert published >= 60


def test_dense_perception_departs_from_jax_in_one_cluster():
    """F8 (ROADMAP Queue 3, resolved): on the dense scene the port's
    ``bind_env`` makes every decision of the JAX ``bind_env`` (ids, flags,
    counts exact on every frame), and no detection departs past the 1e-5
    the headline holds -- the two that did (frame 2, slot 35 by 1.3e-5 m
    and frame 3, slot 1 by 4.4e-4 m, its farthest-pair pick flipped) came
    from the ulp the JAX CPU finalize's FMAs move voxel centroids by, which
    K1 now spells.  Pinned so that a change in either direction shows."""
    tcfg, tenv, jcfg, jenv, frames = _case("dense")
    ref = _outputs(JTracker(jcfg), jenv, "bind_env", frames, "jax")
    got = _outputs(TTracker(tcfg, device="cpu"), tenv, "bind_env", frames, "torch")
    departed = []
    for k, (g, r) in enumerate(zip(got, ref)):
        for f in r._fields:
            if f not in ("pos", "vel", "raw_centroid"):
                np.testing.assert_array_equal(np.asarray(getattr(g, f)), getattr(r, f),
                                              err_msg=f"frame {k} {f}")
        d = np.abs(g.raw_centroid.numpy() - r.raw_centroid).max(axis=1)
        departed += [(k, int(i)) for i in np.flatnonzero(d > TOL_POS)]
        _check(f"dense bind_env frame {k}", g, r)
    assert departed == []


def _fma32(a, b, c):
    """f32 fma(a, b, c) of f32 arrays: the product and the sum in f64, one
    rounding to f32.  Exact here: a product of two f32 values needs 48
    bits, and each sum below spans less than the 53 of an f64."""
    f64 = np.float64
    return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(np.float32)


def test_f8_cause_xla_contracts_the_fast_digit_quantize_and_finalize():
    """F8's cause (ROADMAP Queue 3), on frame 3 of the dense scene at full
    size: the JAX package's jitted CPU voxel sums (``quant="fast"``, its jnp
    lowering) are the port's integer digit scheme with three products
    contracted into an FMA -- the quantize's ``p - floor * leaf``, the cell
    centre's ``(base + i) * leaf + half`` and the finalize's ``cnt * centre
    + digit_sum * 2^-k``.  Spelled so, every cell agrees bit for bit; the
    port's K1 plain version, unfused, departed in 1,600-odd cells (x 776, y
    829 of 2,843 occupied, 15 of the y digit sums among them).  K1 now
    spells the same FMAs (F8's repair): its plain version equals the JAX
    sums in every cell."""
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot_cm
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg

    cfg, _, sc = bench_cases.dense_case()
    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    pts, mask, _ = padded_frame(sc, 3, cfg.caps.n_max_points)
    jscene = JScene(**dataclasses.asdict(cfg.scene))
    ref = np.asarray(jax.jit(lambda p, m: voxel_accumulate_onehot_cm(
        p, m, jscene, leaf, leaf_z, quant="fast"))(jnp.asarray(pts, jnp.float32),
                                                    jnp.asarray(mask)))
    P, M = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
    port = vg.accumulate_fast_stacked_plain(P, M, cfg.scene, leaf, leaf_z)[0][0].numpy()

    k = vg.kernel_params(cfg.scene, leaf, leaf_z)
    ok, lin, floors = vg.kept_cells(P, M, k)
    ok, lin = ok[0].numpy(), lin[0].numpy()
    n = ref.shape[1]
    cell = np.arange(n)
    idx = (cell % k["gx"], cell // k["gx"] % k["gy"], cell // (k["gx"] * k["gy"]))
    base = (k["bx"], k["by"], k["bz"])
    f32 = np.float32
    cnt = np.bincount(lin[ok], minlength=n).astype(f32)
    got = np.zeros_like(ref)
    for c in range(3):
        leaf_c, half, sq, invq = (f32(k[f"{v}_{'z' if c == 2 else 'xy'}"])
                                  for v in ("leaf", "half", "sq", "invq"))
        fl = floors[c][0].numpy()
        frac = _fma32(-fl, np.full_like(fl, leaf_c), pts[:, c]) - half
        q = np.clip(np.round(np.where(ok, frac, f32(0)) * sq), -127, 127).astype(np.int64)
        digit_sum = np.bincount(lin[ok], weights=q[ok], minlength=n).astype(f32)
        centre = _fma32((base[c] + idx[c]).astype(f32), np.full(n, leaf_c), np.full(n, half))
        got[c] = _fma32(cnt, centre, digit_sum * invq)
    got[3] = cnt
    np.testing.assert_array_equal(got, ref)
    occupied = cnt > 0
    departed = [int((port[c] != ref[c])[occupied].sum()) for c in range(4)]
    assert departed == [0, 0, 0, 0]


def test_dense_scene_greedy_and_hungarian_disagree():
    """On the dense scene the two associations publish different ids: the
    reason the scene is a cell of its own."""
    tcfg, tenv, _, _, frames = _case("dense")
    ids = {}
    for assoc in ("greedy", "hungarian"):
        outs = _outputs(TTracker(tcfg.replace(association=assoc), device="cpu"), tenv,
                        "bind_env", frames, "torch")
        ids[assoc] = np.stack([o.obj_id.numpy() * o.valid.numpy() for o in outs])
    assert not np.array_equal(ids["greedy"], ids["hungarian"])


def test_hungarian_fleet_matches_jax_sharded_tracker():
    """The kernel fleet, B = 2 streams x 2 steps, on 1 x 1 meshes of both
    packages: each stream's outputs and the final banks."""
    from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker as JSharded
    from multiple_object_tracking_lidar_tpu.parallel.sharding import make_mesh as jmesh

    tcfg, tenv, jcfg, jenv, frames = _case("lpf")
    jst = JSharded(JTracker(jcfg), jmesh(1, 1), kernel_path="on")
    tst = ShardedTracker(TTracker(tcfg, device="cpu"), make_mesh(1, 1, device="cpu"),
                         kernel_path="on")
    assert tst._use_kernel_fleet and jst._use_kernel_fleet
    b = 2
    jstate, tstate = jst.init_state(b), tst.init_state(b)
    step = tst.bind_env(tenv)
    for k in range(2):
        fr = [frames[k], frames[k + 3]]
        arr = [np.stack([f[i] for f in fr]) for i in range(3)]
        jstate, jo = jst.step(jstate, *(jnp.asarray(a) for a in arr), jenv)
        jo = jax.tree.map(np.asarray, jo)
        tstate, to = step(tstate, *(torch.from_numpy(a) for a in arr))
        for s in range(b):
            _check(f"fleet step {k} stream {s}", type(to)(*(np.asarray(f[s]) for f in to)),
                   type(jo)(*(f[s] for f in jo)))
    js_np = jax.tree.map(np.asarray, jstate)
    for f in ("alive", "obj_id", "birth_seq"):
        np.testing.assert_array_equal(getattr(tstate.bank, f).numpy(), getattr(js_np.bank, f))


def _node_frames(n):
    sc = bench_cases.hungarian_case()[2]
    return [sc.frame(k) for k in range(n)]


def _node_config():
    """The headline under hungarian at C = 16, K = 16, whole 100,000-point
    PointCloud2 frames."""
    tcfg = bench_cases.hungarian_case()[0]
    return tcfg.replace(caps=dataclasses.replace(tcfg.caps, **(TINY | {"n_max_points": 106496})))


def test_hungarian_node_matches_jax_node():
    """``TrackerNode`` on headline PointCloud2 frames (K = 16, C = 16):
    every step's outputs and every frame's stats, ``assoc_saturated`` and
    ``overflow`` among them, against the JAX node."""
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import node_outputs

    tcfg = _node_config()
    frames = _node_frames(4)
    jnode = JNode(_jax_config(tcfg))
    ref = node_outputs(jnode, load_map_yaml(bench_cases.SIM_MAP), frames)
    node = TrackerNode(tcfg, device="cpu", keep_outputs=True)
    node.on_map(bench_cases.load_sim_grid())
    for m in frames:
        node.on_pointcloud(m)
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
    v = ref["valid"]
    for f, g in got.items():
        if f in ("pos", "vel"):
            np.testing.assert_allclose(g[v], ref[f][v], rtol=0,
                                       atol=TOL_VEL if f == "vel" else TOL_POS, err_msg=f)
        elif f == "raw_centroid":
            np.testing.assert_allclose(g, ref[f], rtol=0, atol=TOL_POS, err_msg=f)
        else:
            np.testing.assert_array_equal(g, ref[f], err_msg=f)
    keys = ("n_alive", "overflow", "dup_saturated", "cc_saturated", "assoc_saturated")
    assert ([[getattr(s, k) for k in keys] for s in node.stats]
            == [[getattr(s, k) for k in keys] for s in jnode.stats])
    assert int(v.sum()) >= 6


def test_hungarian_streaming_node_matches_sync_node():
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode

    tcfg = _node_config()
    frames = _node_frames(4)
    sync = TrackerNode(tcfg, device="cpu")
    sync.on_map(bench_cases.load_sim_grid())
    want = [r for r in (sync.on_pointcloud(m) for m in frames) if r is not None]
    got = []
    node = StreamingNode(tcfg, on_outputs=lambda *recs: got.append(recs), depth=2, device="cpu")
    node.on_map(bench_cases.load_sim_grid())
    for m in frames:
        node.submit(m)
    node.flush()
    assert len(got) == len(want) >= 3
    for (a_obs, _, _), (b_obs, _, _) in zip(got, want):
        assert [o.id for o in a_obs.obstacles] == [o.id for o in b_obs.obstacles]
        for oa, ob in zip(a_obs.obstacles, b_obs.obstacles):
            np.testing.assert_array_equal(oa.position, ob.position)
            np.testing.assert_array_equal(oa.velocity, ob.velocity)
