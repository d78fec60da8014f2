"""K4's plain version -- the whole track step, ``ops/track_cuda.py::
track_step_plain`` behind ``tracker/pipeline.py::track_step`` -- against the
JAX package's ``track_step`` on scripted multi-frame scenes: the first
frame, a track matched two and three times in one frame (chained IHGP
passes), interpolation backfills (one inside the window, one longer than
it), a full bank with overflow, an empty frame, and expiry.  The
detections are built with numpy and handed to both packages as f32.

Decisions, ids, counters and flags are exact.  Positions within 1e-5 m and
velocities within 1e-4 m/s on valid lanes (the port sums the smoother's
39-term dot products and the velocity mean as ascending f32 loops, XLA in
its own order); windows within 1e-6 (XLA may contract the backfill's
``last + jj * step`` into an FMA under jit); the GP carries within 1e-4.
Then the batched entry (``track_batch``: B banks x S frames, K4's launch
shape) against the same steps one at a time, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Perception as JPerception
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step
from multiple_object_tracking_lidar_tpu_torch.config import Capacities as TCaps
from multiple_object_tracking_lidar_tpu_torch.config import TrackerConfig as TConfig
from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception as TPerception
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_batch, track_step
from multiple_object_tracking_lidar_tpu_torch.tracker.state import FrameOutput, map_state

L, K, D = 10, 6, 8
CAPS = dict(n_max_points=2048, m_max_voxels=512, m_max_dynamic=256, c_max_clusters=D,
            p_max_cluster=64, k_max_tracks=K)
CFG = dict(data_length=L, prune_period=0.6, voxel_leaf_size=0.1, max_cluster_size=300)
TOL_POS, TOL_VEL, TOL_WIN, TOL_M = 1e-5, 1e-4, 1e-6, 1e-4

# scenes: frames of (t, [(x, y), ...] valid detections, {lane: (x, y)}
# invalid lanes inside the bound)
SCENES = {
    "first-frame": [
        (0.1, [(0.0, 0.0), (0.2, 0.1), (3.0, 3.0)], {}),      # all register, ungated
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
        (3.0, [(0.3, 0.1), (1.2, -0.9)], {}),                   # gap 2.0 s: past the window
        (3.1, [(0.31, 0.11), (1.21, -0.9)], {}),
    ],
    "overflow": [
        (0.1, [(0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)], {}),
        (0.2, [(0.0, 5.0), (1.0, 5.0), (2.0, 5.0), (3.0, 5.0), (0.02, 0.0)], {}),  # 2 overflow
        (0.3, [(4.0, 4.0), (1.01, 5.0), (0.03, 0.01)], {}),
        (0.4, [(4.0, 4.0), (5.0, 5.0)], {2: (7.0, 7.0)}),
    ],
    "expiry": [(0.1 * (k + 1), [(0.01 * k, 0.0)] + ([(2.0, 2.0)] if k < 2 else []), {})
               for k in range(7)]
    + [(0.8, [], {}), (0.9, [(0.08, 0.0)], {})]                # an empty frame
    + [(1.0 + 0.1 * k, [(0.09 + 0.01 * k, 0.0)], {}) for k in range(6)],
}


def _frames(name):
    """(t, dets (D, 4) f32, valid (D,)) per frame; lanes past the valid
    ones carry noise (a NaN among them)."""
    rng = np.random.default_rng(sum(map(ord, name)))
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
def test_plain_track_step_matches_jax(pair, name):
    jt, jstep, tt, tcfg = pair
    js, ts = jt.init_state(), tt.init_state()
    seen = dict(publish=0, dups=0, interp=0, overflow=0, expired=0)
    for k, (t, dets, valid) in enumerate(_frames(name)):
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
        ids = to.obj_id.numpy()[to.valid.numpy()]
        seen["publish"] += int(to.publish)
        seen["dups"] += len(ids) - len(set(ids.tolist()))
        seen["overflow"] += int(to.overflow)
        seen["expired"] += int((alive_before & ~ts.bank.alive).sum())
        if name == "interp" and k == 2:
            # slot 0: a gap of 7 periods backfills 6 rows from its last x
            # (0.03) to the detection's (0.2), which is then pushed; rows
            # L-7..L-3 hold the first five, strictly between
            xs = ts.bank.window[0, L - 7:L - 2, 0].numpy()
            seen["interp"] += int(np.all(np.diff(xs) > 0) and xs[0] > 0.03 and xs[-1] < 0.2)
    # each scene exercises what it is named for
    want = {"duplicates": "dups", "overflow": "overflow", "expiry": "expired",
            "interp": "interp", "first-frame": "publish"}[name]
    assert seen[want] > 0, seen


def _same(a, b):
    """Bit for bit (NaN payloads included)."""
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def test_track_batch_equals_steps_one_at_a_time(pair):
    """K4's launch shape on the CPU: two banks x three frames in one
    ``track_batch`` call give the bits of six ``track_step`` calls."""
    _, _, tt, tcfg = pair
    names = ("duplicates", "interp")
    frames = [_frames(n)[:3] for n in names]
    dets = torch.from_numpy(np.stack([[f[1] for f in fr] for fr in frames]))
    valid = torch.from_numpy(np.stack([[f[2] for f in fr] for fr in frames]))
    t = torch.tensor([[f[0] for f in fr] for fr in frames])
    st, out = track_batch(tt.init_state(batch=2), dets, valid, t, config=tcfg,
                          gains_xy=tt.gains_xy)
    for b, fr in enumerate(frames):
        s1 = tt.init_state()
        for s, (ti, di, vi) in enumerate(fr):
            s1, o = track_step(s1, _tp(ti, di, vi), config=tcfg, gains_xy=tt.gains_xy)
            for f in track_cuda.TrackOutputs._fields:
                assert _same(getattr(out, f)[b, s], getattr(o, f)), (b, s, f)
        got = map_state(lambda x: x[b], st)
        assert all(_same(x, y) for x, y in zip(got.bank, s1.bank))
        assert all(_same(x, y) for x, y in zip(got[1:], s1[1:]))


def test_plain_sums_ascend_from_the_first_term():
    """The smoother's y-parts and the velocity mean are ascending f32 loops
    started from the first term (the kernel's order), not torch's
    reductions: pinned on a window whose velocities cancel only in that
    order."""
    w = torch.zeros((1, 4, 4))
    w[0, :, 0] = torch.tensor([0.0, 1e8, 1e8 + 1.0, 1.0]) * 0.1
    wv = {"Wy": torch.ones((2, 3, 3)), "My": torch.ones((2, 2, 3))}
    vmean, ey, my = track_cuda.smoother_parts(w, wv, 0.1)
    v = ((w[0, 1:, 0] - w[0, :-1, 0]) / np.float32(0.1)).numpy()
    s = np.float32(v[0])
    for x in v[1:]:
        s = np.float32(s + np.float32(x))
    assert vmean[0, 0].item() == np.float32(s / np.float32(3))
    y = (v - np.float32(s / np.float32(3))).astype(np.float32)
    e = y[0]
    for x in y[1:]:
        e = np.float32(e + x)
    assert ey[0, 0].item() == e and my[0, 0, 1].item() == e
