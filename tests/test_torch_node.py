"""The port's node: bank growth and checkpoint/resume against the JAX node,
on the CPU.

- Growth: tests/test_runtime.py's scene (five well-separated moving
  objects, a two-slot bank, the default ``grow_bank_on_overflow``) through
  both nodes.  Per frame: every integer output (ids, validity, counts,
  overflow) exact, positions within 1e-5 m, velocities within 1e-4 m/s
  (test_torch_golden.py's tolerances and reasons); the same growths at the
  same frames and the same final K; the final bank, padded slots included,
  equal to the JAX node's (windows and GP carries within 1e-5).
- ``grow_bank`` pads with the JAX node's fill values.
- Checkpoints: a port save loads in the JAX ``load_state`` and the
  reverse, array for array; a resumed node continues bit for bit
  (test_runtime.py:60-90); a grown checkpoint resumes grown; a window
  length that differs from the config raises.
- K4's plain version on a bank grown past the TPU kernel's 128 slots
  (K = 256) against the JAX greedy association's jnp scan, which the JAX
  package takes there: decisions exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.io.scenario import Scenario as JScenario
from multiple_object_tracking_lidar_tpu.io.scenario import ScenarioObject as JObject
from multiple_object_tracking_lidar_tpu.ops.assign import associate_and_update as j_assoc
from multiple_object_tracking_lidar_tpu.runtime import checkpoint as jckpt
from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank as JBank
from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
from multiple_object_tracking_lidar_tpu_torch.bench_cases import SIM_MAP, load_sim_grid
from multiple_object_tracking_lidar_tpu_torch.config import Capacities, TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
from multiple_object_tracking_lidar_tpu_torch.ops import assign_cuda
from multiple_object_tracking_lidar_tpu_torch.ops.assign import associate_and_update as t_assoc
from multiple_object_tracking_lidar_tpu_torch.runtime import checkpoint as tckpt
from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.tracker.state import (
    TrackBank,
    TrackerState,
    grow_bank,
    init_state,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_POS, TOL_VEL = 1e-5, 1e-4
N_FRAMES = 9
CAPS = dict(n_max_points=1024, m_max_voxels=512, m_max_dynamic=128, c_max_clusters=8,
            p_max_cluster=64, k_max_tracks=2)
OBJECTS = [(-1.2, 0.6, 0.05, 0.0), (0.0, 0.6, 0.0, 0.05), (1.2, 0.6, -0.05, 0.0),
           (-0.8, 3.6, 0.05, 0.0), (0.8, 3.6, 0.0, 0.05)]   # test_runtime.py:130-136


def _config(**caps):
    return TrackerConfig(voxel_leaf_size=0.1, data_length=6, caps=Capacities(**(CAPS | caps)))


def _frames(n=N_FRAMES):
    sc = Scenario(grid=load_sim_grid(), objects=[ScenarioObject(*o) for o in OBJECTS],
                  static_points_per_frame=300, seed=3)
    return [sc.frame(k) for k in range(n)]


def _run(node, frames):
    growths, ks = [], []
    for msg in frames:
        node.on_pointcloud(msg)
        growths.append(node.n_growths)
        ks.append(node.config.caps.k_max_tracks)
    return growths, ks


def _outputs(node, lo=0):
    return {f: np.stack([getattr(o, f) for o in node.outputs[lo:]])
            for f in node.outputs[0]._fields}


@pytest.fixture(scope="module")
def jax_growth():
    """The JAX node over the scene: its recorded outputs and final state."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import node_outputs

    grid = load_map_yaml(SIM_MAP)
    sc = JScenario(grid=grid, objects=[JObject(*o) for o in OBJECTS],
                   static_points_per_frame=300, seed=3)
    node = JNode(JConfig(voxel_leaf_size=0.1, data_length=6, caps=JCaps(**CAPS)))
    out = node_outputs(node, grid, [sc.frame(k) for k in range(N_FRAMES)])
    return out, node


@pytest.fixture(scope="module")
def port_growth():
    node = TrackerNode(_config(), device="cpu", keep_outputs=True)
    node.on_map(load_sim_grid())
    growths, ks = _run(node, _frames())
    return node, growths, ks


def test_growth_matches_jax_node(jax_growth, port_growth):
    ref, jnode = jax_growth
    node, growths, ks = port_growth
    assert ref["overflow"].sum() > 0 and ref["n_growths"][-1] >= 2
    np.testing.assert_array_equal(growths, ref["n_growths"])
    np.testing.assert_array_equal(ks, ref["k_max_tracks"])
    assert node.n_growths == jnode.n_growths
    assert node.config.caps.k_max_tracks == jnode.config.caps.k_max_tracks >= 5
    got = _outputs(node)
    v = ref["valid"]
    for f in got:
        if f in ("pos", "vel"):
            np.testing.assert_allclose(got[f][v], ref[f][v], rtol=0,
                                       atol=TOL_VEL if f == "vel" else TOL_POS, err_msg=f)
        elif f == "raw_centroid":
            np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=TOL_POS, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert node.stats[-1].n_alive == 5                     # nobody permanently dropped


def test_grown_bank_matches_jax_node(jax_growth, port_growth):
    """The final bank, the slots the growths padded included."""
    _, jnode = jax_growth
    node, _, _ = port_growth
    jb, tb = jnode.state.bank, node.state.bank
    for f in ("alive", "obj_id", "birth_seq"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), err_msg=f)
    for f in ("window", "m0"):
        np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    free = ~tb.alive
    assert free.any()
    assert (tb.obj_id[free] == -1).all() and (tb.birth_seq[free] == 2**30).all()
    for f in ("next_obj_num", "next_birth", "spin_counter", "initialized"):
        assert getattr(node.state, f).item() == np.asarray(getattr(jnode.state, f)).item(), f


def test_grow_bank_pads_with_the_jax_fill_values():
    rng = np.random.default_rng(0)
    st = init_state(3, 4)
    st = st._replace(bank=TrackBank(
        alive=torch.tensor([True, False, True]), obj_id=torch.tensor([5, -1, 7], dtype=torch.int32),
        birth_seq=torch.tensor([1, 2**30, 0], dtype=torch.int32),
        window=torch.from_numpy(rng.normal(size=(3, 4, 4)).astype(np.float32)),
        m0=torch.from_numpy(rng.normal(size=(3, 2, 2)).astype(np.float32))),
        next_obj_num=torch.tensor(8, dtype=torch.int32))
    g = grow_bank(st, 8)
    for f in TrackBank._fields:
        a, b = getattr(st.bank, f), getattr(g.bank, f)
        assert b.shape == (8,) + a.shape[1:] and b.dtype == a.dtype and torch.equal(b[:3], a)
    assert not g.bank.alive[3:].any()
    assert (g.bank.obj_id[3:] == -1).all() and (g.bank.birth_seq[3:] == 2**30).all()
    assert (g.bank.window[3:] == 0).all() and (g.bank.m0[3:] == 0).all()
    assert g.next_obj_num is st.next_obj_num
    with pytest.raises(ValueError):
        grow_bank(st, 2)


def _as_jax_state(state):
    from multiple_object_tracking_lidar_tpu.tracker.state import TrackerState as JState

    return JState(bank=JBank(*(jnp.asarray(f.numpy()) for f in state.bank)),
                  **{f: jnp.asarray(getattr(state, f).numpy())
                     for f in TrackerState._fields if f != "bank"})


def test_checkpoints_load_across_packages(port_growth, tmp_path):
    node, _, _ = port_growth
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tckpt.save_state(p1, node.state, extra=node.checkpoint_extra())
    jstate, jmeta = jckpt.load_state(p1)
    assert jmeta == node.checkpoint_extra()
    jckpt.save_state(p2, _as_jax_state(node.state), extra={"frame": 9})
    tstate, tmeta = tckpt.load_state(p2, device="cpu")
    assert tmeta == {"frame": 9}
    for f in TrackBank._fields:
        want = getattr(node.state.bank, f)
        np.testing.assert_array_equal(np.asarray(getattr(jstate.bank, f)), want.numpy())
        got = getattr(tstate.bank, f)
        assert got.dtype == want.dtype and torch.equal(got, want), f
    for f in TrackerState._fields[1:]:
        np.testing.assert_array_equal(np.asarray(getattr(jstate, f)), getattr(node.state, f).numpy())
        assert torch.equal(getattr(tstate, f), getattr(node.state, f)), f
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def _continue(node, frames):
    node.outputs.clear()
    for msg in frames:
        node.on_pointcloud(msg)
    return _outputs(node)


@pytest.mark.parametrize("k_save", [1, 5])
def test_resume_continues_bit_for_bit(tmp_path, k_save):
    """Saved after frame k_save - 1 (k_save 1: before the second growth,
    5: after both), resumed into a fresh node at the initial K: the rest
    is bit for bit the uninterrupted node's, at the checkpoint's K."""
    frames = _frames()
    node = TrackerNode(_config(), device="cpu", keep_outputs=True)
    node.on_map(load_sim_grid())
    _run(node, frames[:k_save])
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, node.state, extra=node.checkpoint_extra())
    k_ckpt = node.config.caps.k_max_tracks
    want = _continue(node, frames[k_save:])

    fresh = TrackerNode(_config(), device="cpu", keep_outputs=True)
    fresh.on_map(load_sim_grid())
    fresh.resume(*tckpt.load_state(path, device="cpu"))
    assert fresh.config.caps.k_max_tracks == k_ckpt > 2             # a grown bank resumes grown
    got = _continue(fresh, frames[k_save:])
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert fresh.config.caps.k_max_tracks == node.config.caps.k_max_tracks
    assert fresh.colors == node.colors


def test_resume_rejects_another_window_length(port_growth, tmp_path):
    node, _, _ = port_growth
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_state(path, node.state)
    other = TrackerNode(_config().replace(data_length=7), device="cpu")
    with pytest.raises(ValueError, match="data_length"):
        other.resume(*tckpt.load_state(path, device="cpu"))


K_WIDE, L, D = 256, 10, 32
THR, DT, GAP = 0.5, 0.1, 3.0


@pytest.mark.parametrize("name", ["conflicts", "full-bank"])
def test_plain_k4_on_a_grown_bank_matches_jnp_scan(name):
    rng = np.random.default_rng(len(name))
    alive = rng.random(K_WIDE) < 0.6 if name == "conflicts" else np.ones(K_WIDE, bool)
    obj_id = np.where(alive, np.arange(K_WIDE) + 10, -1).astype(np.int32)
    birth = np.where(alive, rng.permutation(K_WIDE), 2**30).astype(np.int32)
    window = np.zeros((K_WIDE, L, 4), np.float32)
    xy = rng.uniform(-8, 8, (K_WIDE, 2)).astype(np.float32)
    for j in range(L):
        window[:, j, :2] = xy + np.float32(0.02) * j
        window[:, j, 3] = np.float32(1.0 - (L - 1 - j) * DT)
    m0 = rng.normal(0, 0.1, (K_WIDE, 2, 2)).astype(np.float32)
    live = np.flatnonzero(alive)
    dets = np.zeros((D, 4), np.float32)
    dets[:, :2] = rng.uniform(9, 12, (D, 2))                 # far from every track
    dets[:, 3] = np.float32(1.1)
    dets[0, :2] = window[live[-1], -1, :2] + 0.1             # slots past 128
    dets[1, :2] = window[live[-1], -1, :2] - 0.1
    dets[2, :2] = window[live[-20], -1, :2] + 0.05
    dets[3, :2], dets[3, 3] = window[live[-40], -1, :2], 1.5  # an interpolation gap
    valid = np.ones(D, bool)
    valid[6] = False
    jb = JBank(*(jnp.asarray(a) for a in (alive, obj_id, birth, window, m0)))
    tb = TrackBank(*(torch.from_numpy(a) for a in (alive, obj_id, birth, window, m0)))
    ref = j_assoc(jb, jnp.int32(300), jnp.int32(400), jnp.asarray(dets), jnp.asarray(valid),
                  THR, DT, GAP, allow_match=True, backend="jnp")
    before = assign_cuda.assoc_scan.launches
    got = t_assoc(tb, torch.tensor(300, dtype=torch.int32), torch.tensor(400, dtype=torch.int32),
                  torch.from_numpy(dets), torch.from_numpy(valid), THR, DT, GAP, allow_match=True)
    assert assign_cuda.assoc_scan.launches == before
    ok = np.asarray(ref.det_ok)
    np.testing.assert_array_equal(ok, got.det_ok.numpy())
    np.testing.assert_array_equal(np.asarray(ref.det_slot)[ok], got.det_slot.numpy()[ok])
    for f in ("det_id", "det_new", "next_obj_num", "next_birth", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(got, f).numpy(), err_msg=f)
    for f in ("alive", "obj_id", "birth_seq", "m0"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.bank, f)), getattr(got.bank, f).numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(ref.bank.window), got.bank.window.numpy(), rtol=0, atol=1e-6)
    assert got.det_slot.numpy()[ok].max() >= 128
    if name == "full-bank":
        assert int(got.overflow) > 0


def test_grown_jax_checkpoint_resumes_in_the_port(jax_growth, tmp_path):
    """The JAX node's grown state, saved by the JAX package, resumes grown
    in the port's node and tracks on without growing again."""
    _, jnode = jax_growth
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jnode.state, extra=jnode.checkpoint_extra())
    node = TrackerNode(_config(), device="cpu")
    node.on_map(load_sim_grid())
    node.resume(*tckpt.load_state(path, device="cpu"))
    assert node.config.caps.k_max_tracks == jnode.config.caps.k_max_tracks
    assert node.time_init == jnode.time_init
    node.on_pointcloud(_frames(N_FRAMES + 1)[-1])
    assert node.stats[-1].n_alive == 5 and node.n_growths == 0
