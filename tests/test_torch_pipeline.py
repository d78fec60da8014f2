"""The port's dense-grid slice end to end against the JAX package's
``Tracker.bind_env`` on the CPU: the headline scene's geometry with the
capacities cut to N = 8192 points, C = 16 slots of P = 128, K = 16 tracks,
over 12 frames, through the port's ``bind_env`` and ``bind_env_multi``
(S = 4), plus a mid-sequence hand-over of the JAX state through the
carry-across functions.

Integers, booleans and decisions are exact.  Float tolerances: detections
and positions atol 1e-5 m (the JAX pair scan centres members with an f32
sum, K3 rounds an f64 one, and XLA may contract the finalize into an FMA:
a few ulp at |x| <= 10 m); velocities atol 1e-4 m/s (window differences
/ dt amplify those ulps x10, and the 39-term smoother sums run in another
order).  pos / vel are compared where ``valid``: other lanes follow
det_slot, which is defined only where det_ok.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities
from multiple_object_tracking_lidar_tpu_torch.tracker import state as tstate
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C, P, K = 8192, 16, 128, 16
N_FRAMES = 12
TOL_DETS, TOL_VEL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def case():
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, sc = bench.headline_case()
    jcfg = jcfg.replace(caps=dataclasses.replace(
        jcfg.caps, n_max_points=N, c_max_clusters=C, p_max_cluster=P, k_max_tracks=K))
    tcfg, tenv, _ = bench_cases.headline_case()
    tcfg = tcfg.replace(caps=Capacities(**dataclasses.asdict(jcfg.caps)))
    frames = []
    for k in range(N_FRAMES):
        pts, t = sc.frame_arrays(k)
        # the frame is [95,200 wall returns, 3 x 1,500 object points, 300
        # clutter]: keep every 20th wall return and every 2nd object point
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])
        assert len(sub) <= N
        buf = np.zeros((N, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    jt = JTracker(jcfg)
    jstep = jt.bind_env(jenv, donate_state=False)
    js = jt.init_state()
    jouts, jstates = [], []
    for buf, mask, t in frames:
        js, out = jstep(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
        jouts.append(jax.tree.map(np.asarray, out))
        jstates.append(jax.tree.map(np.asarray, js))
    return dict(jcfg=jcfg, jenv=jenv, tcfg=tcfg, tenv=tenv, frames=frames,
                jouts=jouts, jstates=jstates, jt=jt)


def _check(tag, got, ref):
    """got: FrameOutput of tensors; ref: JAX FrameOutput of numpy."""
    v = np.asarray(ref.valid)
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        if f in ("pos", "vel"):
            tol = TOL_VEL if f == "vel" else TOL_DETS
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_DETS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


def _tframe(fr):
    buf, mask, t = fr
    return TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t))


def test_bind_env_matches_jax(case):
    tt = TTracker(case["tcfg"], device="cpu")
    step = tt.bind_env(case["tenv"])
    st = tt.init_state()
    published = 0
    for k, fr in enumerate(case["frames"]):
        st, out = step(st, _tframe(fr))
        _check(f"frame {k}", out, case["jouts"][k])
        published += int(out.valid.sum())
    assert published >= 3 * (N_FRAMES - 1)      # three objects tracked from frame 1
    jst = case["jstates"][-1]
    for f in ("alive", "obj_id", "birth_seq"):
        np.testing.assert_array_equal(getattr(st.bank, f).numpy(), np.asarray(getattr(jst.bank, f)))


def test_bind_env_multi_matches_jax(case):
    tt = TTracker(case["tcfg"], device="cpu")
    multi = tt.bind_env_multi(case["tenv"])
    st = tt.init_state()
    s = 4
    for d in range(N_FRAMES // s):
        fr = case["frames"][d * s:(d + 1) * s]
        frames = TFrame(
            torch.from_numpy(np.stack([f[0] for f in fr])),
            torch.from_numpy(np.stack([f[1] for f in fr])),
            torch.from_numpy(np.stack([f[2] for f in fr])),
        )
        st, outs = multi(st, frames)
        for i in range(s):
            got = type(outs)(*(x[i] for x in outs))
            _check(f"dispatch {d} frame {i}", got, case["jouts"][d * s + i])


def test_state_hand_over_through_carry_across(case):
    """Start the port from the JAX state after frame 5, with the JAX env,
    cell table and gains carried across; frames 6-11 must then match."""
    from multiple_object_tracking_lidar_tpu.ops.static_mask import get_cell_static_table
    from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape

    jcfg, jenv, jt = case["jcfg"], case["jenv"], case["jt"]
    dims = grid_shape(jcfg.scene, jcfg.voxel_leaf_size, jcfg.leaf_z)
    jtab = get_cell_static_table(jenv, jcfg.scene, jcfg.voxel_leaf_size, *dims)
    tenv = tstate.env_from_numpy(jax.tree.map(np.asarray, jenv))
    ttab = tstate.table_from_numpy(type(jtab)(*(np.asarray(x) for x in jtab[:3]), jtab.k))
    np.testing.assert_array_equal(tstate.env_to_numpy(tenv)["dilated"], np.asarray(jenv.dilated))
    assert tstate.table_to_numpy(ttab)["k"] == jtab.k
    gains = tstate.gains_from_numpy(jax.tree.map(np.asarray, jt.gains_xy))
    back = tstate.gains_to_numpy(gains)
    np.testing.assert_array_equal(back["W_vel"]["Wy"], np.asarray(jt.gains_xy["W_vel"]["Wy"]))

    tt = TTracker(case["tcfg"], device="cpu")
    tt.gains_xy = gains
    st = tstate.state_from_numpy(case["jstates"][5])
    rt = tstate.state_to_numpy(st)
    np.testing.assert_array_equal(rt["bank"]["window"], case["jstates"][5].bank.window)
    assert rt["next_obj_num"] == case["jstates"][5].next_obj_num
    step = tt.bind_env(tenv)
    for k in range(6, N_FRAMES):
        st, out = step(st, _tframe(case["frames"][k]))
        _check(f"handed-over frame {k}", out, case["jouts"][k])
    jst = case["jstates"][-1]
    np.testing.assert_array_equal(st.next_obj_num.numpy(), np.asarray(jst.next_obj_num))
    np.testing.assert_array_equal(st.spin_counter.numpy(), np.asarray(jst.spin_counter))


@pytest.mark.parametrize(
    "field,value",
    [("dtype", "bfloat16"), ("dtype", "float64")],
)
def test_unported_configs_raise(field, value):
    cfg = bench_cases.bench_config().replace(**{field: value})
    if value == "float64":
        # f64 runs every configuration, the stencil CC of grid_cc="jnp"
        # included (K14's double build on the card)
        from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import make_plan

        TTracker(cfg, device="cpu")
        env = bench_cases.headline_case("cpu")[1]
        assert not make_plan(cfg.replace(grid_cc="jnp"), env, "cpu").k2
        return
    # bf16 runs every perception front end since item 28's second part (the
    # point list here), Hungarian association since its third and the
    # learning mode since its last; a dtype the package does not know
    # raises, naming the ROADMAP
    cfg = cfg.replace(cluster_backend="jnp")
    TTracker(cfg, device="cpu")
    TTracker(cfg.replace(association="hungarian"), device="cpu")
    assert not TTracker(cfg.replace(param_fix=False), device="cpu").config.param_fix
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTracker(cfg.replace(dtype="float8_e4m3fn"), device="cpu")
