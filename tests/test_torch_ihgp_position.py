"""IHGP position filtering (``position_filter="ihgp"``, the reference's
present-but-disabled mode, cpp:835-869) and ``bind_env_pipelined``
against the JAX package on the CPU.

- K4's plain version (``ops/track_cuda.py::track_step_plain``, behind
  ``tracker/pipeline.py::track_step``) under ``ihgp`` against the JAX
  ``track_step`` (f32, under ``jax.jit``) on scripted scenes: the first
  frame, a track matched two and three times in one frame (each duplicate
  runs its own chained position + velocity pass and publishes its own
  position), interpolation backfills, a full bank with overflow, an empty
  frame and expiry.
- The headline slice on tiny caps with ``ihgp`` through the port's
  ``bind_env``, ``bind_env_multi`` and ``bind_env_pipelined`` against the
  same JAX entry points; ``bind_env_pipelined`` also under ``lpf`` on the
  headline and on the point list (configuration C); the fleet
  (``ShardedTracker``) under ``ihgp`` bit for bit against each stream's
  own ``bind_env``.

Tolerances: decisions, ids, counters and flags exact.  Positions within
1e-5 m and velocities within 1e-4 m/s on valid lanes, windows within 1e-6,
GP carries within 1e-4: the JAX side applies the smoother weights as an
f32 einsum that XLA sums in its own order, the port as ascending f32
loops started from the first term (test_torch_track_kernel.py's bounds;
no widening was needed).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Perception as JPerception
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities as TCaps
from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig as TConfig
from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception as TPerception
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_step
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame
from multiple_object_tracking_lidar_tpu_torch.tracker.state import FrameOutput

TOL_POS, TOL_VEL, TOL_WIN, TOL_M = 1e-5, 1e-4, 1e-6, 1e-4

# ---------------------------------------------------------------------------
# the track step on scripted scenes
# ---------------------------------------------------------------------------
L, K, D = 10, 6, 8
CAPS = dict(n_max_points=2048, m_max_voxels=512, m_max_dynamic=256, c_max_clusters=D,
            p_max_cluster=64, k_max_tracks=K)
CFG = dict(data_length=L, prune_period=0.6, voxel_leaf_size=0.1, max_cluster_size=300,
           position_filter="ihgp")

# frames of (t, [(x, y), ...] valid detections, {lane: (x, y)} invalid lanes)
SCENES = {
    "first-frame": [
        (0.1, [(0.0, 0.0), (0.2, 0.1), (3.0, 3.0)], {}),
        (0.2, [(0.02, 0.01), (3.05, 3.0)], {}),
        (0.3, [(0.04, 0.02), (3.1, 3.05), (0.25, 0.12)], {}),
    ],
    "duplicates": [
        (0.1, [(0.0, 0.0), (2.0, 2.0)], {}),
        (0.2, [(0.02, 0.01), (-0.05, 0.03), (2.03, 2.0), (0.04, -0.02)], {1: (9.0, 9.0)}),
        (0.3, [(0.05, 0.02), (0.01, 0.06)], {}),
        (0.4, [(2.1, 2.05), (0.08, 0.03), (0.03, 0.08), (0.06, 0.05)], {}),
        (0.5, [(0.1, 0.05)], {}),
    ],
    "interp": [
        (0.1, [(0.0, 0.0), (1.0, -1.0)], {}),
        (0.2, [(0.03, 0.01), (1.02, -1.0)], {}),
        (0.9, [(0.2, 0.05), (1.1, -0.95)], {}),                 # gap 0.7 s: 6 backfilled
        (1.0, [(0.22, 0.06)], {}),
        (3.0, [(0.3, 0.1), (1.2, -0.9)], {}),                   # past the window
        (3.1, [(0.31, 0.11), (1.21, -0.9)], {}),
    ],
    "overflow": [
        (0.1, [(0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)], {}),
        (0.2, [(0.0, 5.0), (1.0, 5.0), (2.0, 5.0), (3.0, 5.0), (0.02, 0.0)], {}),
        (0.3, [(4.0, 4.0), (1.01, 5.0), (0.03, 0.01)], {}),
        (0.4, [(4.0, 4.0), (5.0, 5.0)], {2: (7.0, 7.0)}),
    ],
    "expiry": [(0.1 * (k + 1), [(0.01 * k, 0.0)] + ([(2.0, 2.0)] if k < 2 else []), {})
               for k in range(7)]
    + [(0.8, [], {}), (0.9, [(0.08, 0.0)], {})]
    + [(1.0 + 0.1 * k, [(0.09 + 0.01 * k, 0.0)], {}) for k in range(6)],
}


def _scene_frames(name):
    """(t, dets (D, 4) f32, valid (D,)) per frame; lanes past the valid
    ones carry noise (a NaN among them)."""
    rng = np.random.default_rng(sum(map(ord, name)) + 11)
    out = []
    for t, xy, invalid in SCENES[name]:
        dets = rng.uniform(-5, 5, (D, 4)).astype(np.float32)
        dets[D - 1, 0] = np.nan
        valid = np.zeros(D, bool)
        lane = 0
        for x, y in xy:
            while lane in invalid:
                dets[lane, :2] = invalid[lane]
                lane += 1
            dets[lane] = [x, y, 0.0, t]
            valid[lane] = True
            lane += 1
        out.append((np.float32(t), dets, valid))
    return out


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig(caps=JCaps(**CAPS), **CFG)
    tcfg = TConfig(caps=TCaps(**CAPS), **CFG)
    jt = JTracker(jcfg)
    jstep = jax.jit(functools.partial(j_track_step, config=jcfg, gains_xy=jt.gains_xy))
    return jt, jstep, TTracker(tcfg, "cpu"), tcfg


def _jp(t, dets, valid):
    z = jnp.int32(0)
    return JPerception(dets=jnp.asarray(dets), det_valid=jnp.asarray(valid), t=jnp.float32(t),
                       n_points=z, n_vox=z, n_dynamic=z, n_clusters=jnp.int32(valid.sum()),
                       cc_saturated=z)


def _tp(t, dets, valid):
    z = torch.tensor(0, dtype=torch.int32)
    return TPerception(dets=torch.from_numpy(dets), det_valid=torch.from_numpy(valid),
                       t=torch.tensor(t), n_points=z, n_vox=z, n_dynamic=z,
                       n_clusters=torch.tensor(int(valid.sum()), dtype=torch.int32),
                       cc_saturated=z)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_ihgp_track_step_matches_jax(pair, name):
    jt, jstep, tt, tcfg = pair
    js, ts = jt.init_state(), tt.init_state()
    seen = dict(publish=0, dups=0, overflow=0, expired=0, interp=0, moved=0)
    for k, (t, dets, valid) in enumerate(_scene_frames(name)):
        alive_before = ts.bank.alive.clone()
        js, jo = jstep(js, _jp(t, dets, valid))
        ts, to = track_step(ts, _tp(t, dets, valid), config=tcfg, gains_xy=tt.gains_xy)
        v = np.asarray(jo.valid)
        for f in FrameOutput._fields:
            a, b = np.asarray(getattr(jo, f)), getattr(to, f).numpy()
            if f == "pos":
                np.testing.assert_allclose(b[v], a[v], rtol=0, atol=TOL_POS, err_msg=f"{k} {f}")
            elif f == "vel":
                np.testing.assert_allclose(b[v], a[v], rtol=0, atol=TOL_VEL, err_msg=f"{k} {f}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"frame {k} {f}")
        for f in ("alive", "obj_id", "birth_seq"):
            np.testing.assert_array_equal(getattr(ts.bank, f).numpy(),
                                          np.asarray(getattr(js.bank, f)), err_msg=f"{k} {f}")
        for f in ("next_obj_num", "next_birth", "spin_counter", "initialized"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                          err_msg=f"{k} {f}")
        np.testing.assert_allclose(ts.bank.window.numpy(), np.asarray(js.bank.window),
                                   rtol=0, atol=TOL_WIN, err_msg=f"{k} window")
        np.testing.assert_allclose(ts.bank.m0.numpy(), np.asarray(js.bank.m0), rtol=0,
                                   atol=TOL_M, err_msg=f"{k} m0")
        tv = to.valid.numpy()
        ids = to.obj_id.numpy()[tv]
        seen["publish"] += int(to.publish)
        seen["dups"] += len(ids) - len(set(ids.tolist()))
        seen["overflow"] += int(to.overflow)
        seen["expired"] += int((alive_before & ~ts.bank.alive).sum())
        seen["interp"] += int(name == "interp" and k == 2)
        # the IHGP position is not the window's last detection
        seen["moved"] += int(np.any(to.pos.numpy()[tv] != dets[tv, :2]))
    want = {"duplicates": "dups", "overflow": "overflow", "expiry": "expired",
            "interp": "interp", "first-frame": "publish"}[name]
    assert seen[want] > 0 and seen["moved"] > 0, seen


def test_duplicates_publish_their_own_position_pass(pair):
    """A track matched three times in one frame publishes three different
    positions: each duplicate reads the position pass of its own ordinal,
    each pass chained on the previous pass's velocity carry."""
    _, _, tt, tcfg = pair
    ts = tt.init_state()
    for t, dets, valid in _scene_frames("duplicates")[:4]:
        ts, to = track_step(ts, _tp(t, dets, valid), config=tcfg, gains_xy=tt.gains_xy)
    ids = to.obj_id.numpy()
    v = to.valid.numpy()
    pos = to.pos.numpy()
    track0 = np.flatnonzero(v & (ids == 0))
    assert len(track0) == 3
    assert len({tuple(p) for p in pos[track0]}) == 3
    lpf_step = track_step(ts, _tp(*_scene_frames("duplicates")[4]),
                          config=tcfg.replace(position_filter="lpf"), gains_xy=tt.gains_xy)[1]
    ihgp_step = track_step(ts, _tp(*_scene_frames("duplicates")[4]), config=tcfg,
                           gains_xy=tt.gains_xy)[1]
    assert not torch.equal(lpf_step.pos, ihgp_step.pos)


# ---------------------------------------------------------------------------
# the entry points on the headline slice and on C
# ---------------------------------------------------------------------------
N, N_FRAMES, S = 8192, 8, 4
TINY = dict(n_max_points=N, m_max_voxels=1024, m_max_dynamic=256, c_max_clusters=16,
            p_max_cluster=128, k_max_tracks=16)


def _jax_config(tcfg):
    kw = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    kw["caps"] = JCaps(**dataclasses.asdict(tcfg.caps))
    kw["scene"] = JScene(**dataclasses.asdict(tcfg.scene))
    return JConfig(**kw)


def _slice_frames(sc):
    frames = []
    for k in range(N_FRAMES):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])
        buf = np.zeros((N, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    return frames


CASES = {
    "headline-ihgp": ("headline_case", {"position_filter": "ihgp"}),
    "headline-lpf": ("headline_case", {}),
    "C-lpf": ("pointlist_case", {}),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    case, fields = CASES[name]
    tcfg, tenv, sc = getattr(bench_cases, case)()
    tcfg = tcfg.replace(**fields, caps=dataclasses.replace(tcfg.caps, **TINY))
    jcfg = _jax_config(tcfg)
    jenv = jsm.build_static_mask(load_map_yaml(bench_cases.SIM_MAP), jcfg.static_tolarance,
                                 jcfg.occupied_threshold)
    return tcfg, tenv, jcfg, jenv, _slice_frames(sc)


def _stacked_j(frames):
    return JFrame(*(jnp.asarray(np.stack([f[i] for f in frames])) for i in range(3)))


def _stacked_t(frames):
    return TFrame(*(torch.from_numpy(np.stack([f[i] for f in frames])) for i in range(3)))


def _jax_outputs(jt, jenv, entry, frames):
    """Per-frame JAX FrameOutputs (numpy) of ``entry``."""
    js = jt.init_state()
    outs = []
    if entry == "bind_env":
        step = jt.bind_env(jenv, donate_state=False)
        for buf, mask, t in frames:
            js, o = step(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
            outs.append(jax.tree.map(np.asarray, o))
        return outs
    run = getattr(jt, entry)(jenv, donate_state=False)
    for lo in range(0, len(frames), S):
        js, o = run(js, _stacked_j(frames[lo:lo + S]))
        o = jax.tree.map(np.asarray, o)
        outs += [type(o)(*(x[i] for x in o)) for i in range(S)]
    return outs


def _port_outputs(tt, tenv, entry, frames):
    st = tt.init_state()
    outs = []
    if entry == "bind_env":
        step = tt.bind_env(tenv)
        for buf, mask, t in frames:
            st, o = step(st, TFrame(torch.from_numpy(buf), torch.from_numpy(mask),
                                    torch.tensor(t)))
            outs.append(o)
        return outs
    run = getattr(tt, entry)(tenv)
    for lo in range(0, len(frames), S):
        st, o = run(st, _stacked_t(frames[lo:lo + S]))
        outs += [type(o)(*(x[i] for x in o)) for i in range(S)]
    return outs


def _check(tag, got, ref):
    v = np.asarray(ref.valid)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        if f in ("pos", "vel"):
            tol = TOL_VEL if f == "vel" else TOL_POS
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_POS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


@pytest.mark.parametrize(
    "name,entry",
    [("headline-ihgp", "bind_env"), ("headline-ihgp", "bind_env_multi"),
     ("headline-ihgp", "bind_env_pipelined"), ("headline-lpf", "bind_env_pipelined"),
     ("C-lpf", "bind_env_pipelined")],
)
def test_entry_point_matches_jax(name, entry):
    tcfg, tenv, jcfg, jenv, frames = _case(name)
    ref = _jax_outputs(JTracker(jcfg), jenv, entry, frames)
    got = _port_outputs(TTracker(tcfg, device="cpu"), tenv, entry, frames)
    published = 0
    for k, (g, r) in enumerate(zip(got, ref)):
        _check(f"{name} {entry} frame {k}", g, r)
        published += int(g.valid.sum())
    assert published >= 2 * (N_FRAMES - 1)


def test_pipelined_is_bind_env_multi_bit_for_bit():
    """On every config the port's ``bind_env_pipelined`` is the
    ``bind_env_multi`` program: the same bits."""
    tcfg, tenv, _, _, frames = _case("headline-ihgp")
    tt = TTracker(tcfg, device="cpu")
    a = _port_outputs(tt, tenv, "bind_env_pipelined", frames)
    b = _port_outputs(tt, tenv, "bind_env_multi", frames)
    for x, y in zip(a, b):
        for f, u, w in zip(x._fields, x, y):
            assert torch.equal(u.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), f


def test_ihgp_fleet_matches_each_streams_bind_env():
    """The fleet reaches K4 (here its plain version) through the same
    ``track_frames`` call and takes ``position_filter`` with it: two
    streams of a ``ShardedTracker`` under ``ihgp``, bit for bit their own
    ``bind_env``."""
    tcfg, tenv, _, _, frames = _case("headline-ihgp")
    tt = TTracker(tcfg, device="cpu")
    fleet = ShardedTracker(tt, make_mesh(1, 1, device="cpu"))
    step = fleet.bind_env(tenv)
    st = fleet.init_state(2)
    streams = (frames[:4], frames[2:6])
    outs = []
    for k in range(4):
        fr = [streams[0][k], streams[1][k]]
        st, o = step(st, *(torch.from_numpy(np.stack([f[i] for f in fr])) for i in range(3)))
        outs.append(o)
    for b, stream in enumerate(streams):
        ref = _port_outputs(tt, tenv, "bind_env", stream)
        for k, r in enumerate(ref):
            for f, u, w in zip(r._fields, r, outs[k]):
                assert torch.equal(u.reshape(-1).view(torch.uint8),
                                   w[b].reshape(-1).view(torch.uint8)), (b, k, f)


@pytest.mark.parametrize("entry", ["Tracker", "TrackerNode"])
def test_ihgp_config_builds(entry):
    """``position_filter="ihgp"`` is ported: the headline config under it
    builds ``Tracker`` and ``TrackerNode`` (no ROADMAP refusal), with the
    position smoother's weights beside the velocity's."""
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    cfg = bench_cases.bench_config().replace(position_filter="ihgp")
    built = TTracker(cfg, device="cpu") if entry == "Tracker" else TrackerNode(cfg, device="cpu")
    tracker = built if entry == "Tracker" else built.tracker
    assert tracker.config.position_filter == "ihgp"
    assert {"W_pos", "W_vel"} <= set(tracker.gains_xy)
