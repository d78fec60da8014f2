"""``dtype="bfloat16"`` and ``"float16"`` on the dense grid through the
entry points, against the JAX package under ``jax.jit`` on the CPU: 12
frames of the cut headline scene through ``bind_env`` and
``bind_env_multi`` (S = 4), lpf and ihgp, fast and exact digits, one run
with its stamps offset to ~100 s; the grid without K2 (``grid_cc="jnp"``,
K14's plain version) with a two-slot bank that overflows; and the
learning mode and Hungarian association building on the grid, the point
list and the runs (tests/test_torch_half_learning.py holds the learning
node to the JAX node).  The helpers and the
comparisons are tests/test_torch_half.py's: every output bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)
from test_torch_half import (
    N_FRAMES,
    TORCH,
    _check_outputs,
    _configs,
    _frames,
    _jax_entry,
    _jax_exact_from_k5,
    _port_entry,
)

from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker

DTYPES = ["bfloat16", "float16"]
pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("dtype,position_filter,quant,entry,t0", [
    ("bfloat16", "lpf", "fast", "bind_env", 100.0),
    ("bfloat16", "ihgp", "exact", "bind_env", 0.0),
    ("bfloat16", "lpf", "fast", "bind_env_multi", 0.0),
    ("float16", "lpf", "exact", "bind_env", 0.0),
    ("float16", "ihgp", "fast", "bind_env", 0.0),
    ("float16", "ihgp", "fast", "bind_env_multi", 0.0),
])
def test_entry_points_match_jax(dtype, position_filter, quant, entry, t0):
    """12 frames of the cut headline scene through ``bind_env`` or
    ``bind_env_multi`` (S = 4) against the JAX package's: every output bit
    for bit.  Stamps offset to
    ~100 s round the half ``t`` column (bf16 keeps 8 bits: 100.x s rounds to
    0.5 s steps), which the window, the gap test and the staleness test
    read.  Exact mode is held to the JAX route from the exact digits' sums
    (``_jax_exact_from_k5``)."""
    fields = dict(position_filter=position_filter, voxel_quant=quant)
    jcfg, jenv, tcfg, tenv, sc = _configs(dtype, **fields)
    frames = _frames(sc, t0=t0)
    want = (_jax_exact_from_k5(jcfg, jenv, tcfg, frames) if quant == "exact"
            else _jax_entry(jcfg, jenv, frames, entry))
    got = _port_entry(tcfg, tenv, frames, entry)
    published = 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.raw_centroid.dtype == TORCH[dtype] and g.vel.dtype == TORCH[dtype]
        _check_outputs(f"{dtype}/{position_filter}/{quant}/{entry} frame {k}", g, w)
        published += int(np.asarray(w.valid).sum())
    assert published >= 2 * (N_FRAMES - 2)


@pytest.mark.parametrize("fields", [
    dict(association="hungarian"), dict(param_fix=False),
    dict(association="hungarian", voxel_mode="dense", cluster_backend="jnp"),
    dict(param_fix=False, voxel_mode="scan", cluster_backend="jnp"),
    dict(association="hungarian", voxel_mode="runs"),
    dict(param_fix=False, voxel_mode="runs", cluster_backend="pallas"),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_other_half_configs_build(dtype, fields):
    """Under a half dtype Hungarian association (item 28's third part) and
    the learning mode (its last part) build on the dense grid, the point
    list and the runs alike; the learning node steps through the gains as
    an argument, with the tracker's half gains to start from."""
    cfg = bench_cases.bench_config().replace(dtype=dtype, **fields)
    if "association" in fields:
        assert TTracker(cfg, device="cpu").config.association == "hungarian"
        return
    node = TrackerNode(cfg, device="cpu")
    assert node.learning and not node.tracker.config.param_fix
    assert node._gains["W_vel"]["Wy"].dtype == TORCH[dtype]
    assert node.log_params["x"].dtype == np.float32


def test_half_grid_cc_jnp_and_a_two_slot_bank_match_jax():
    """The grid without K2 (``grid_cc="jnp"``: the finalize, the static drop
    and K14's plain version) and a bank of two slots that overflows, under
    f16, through ``bind_env``: as the JAX package, as above."""
    jcfg, jenv, tcfg, tenv, sc = _configs("float16", grid_cc="jnp")
    kw = dict(k_max_tracks=2)
    jcfg = jcfg.replace(caps=dataclasses.replace(jcfg.caps, **kw))
    tcfg = tcfg.replace(caps=dataclasses.replace(tcfg.caps, **kw))
    frames = _frames(sc, n=6)
    want = _jax_entry(jcfg, jenv, frames, "bind_env")
    got = _port_entry(tcfg, tenv, frames, "bind_env")
    assert sum(int(np.asarray(w.overflow)) for w in want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        _check_outputs(f"grid_cc=jnp K=2 frame {k}", g, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_half_nodes_match_jax(dtype, tmp_path):
    """``TrackerNode`` under the half dtype on the cut headline frames as
    PointCloud2 messages (the native decoder) publishes what the JAX node
    publishes, bit for bit; ``StreamingNode`` publishes bit for bit what
    the port's ``TrackerNode`` does; a checkpoint of the half state resumes
    with the same dtype and bits."""
    check_half_nodes(dtype, tmp_path)


def check_half_nodes(dtype, tmp_path, k_max_tracks=None, **fields):
    """``test_half_nodes_match_jax``'s checks on the config of ``fields``
    (and a bank of ``k_max_tracks`` slots where given: the streaming node,
    like the JAX one, never grows its bank, so the bank must hold every
    track for the two nodes to agree)."""
    from multiple_object_tracking_lidar_tpu.io.pointcloud2 import make_pointcloud2 as jmake
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
    from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import make_pointcloud2
    from multiple_object_tracking_lidar_tpu_torch.runtime.checkpoint import load_state, save_state
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    from multiple_object_tracking_lidar_tpu_torch.runtime.stream import StreamingNode
    from multiple_object_tracking_lidar_tpu_torch.utils.pgm import load_map_yaml

    import os

    jcfg, _, tcfg, _, sc = _configs(dtype, **fields)
    if k_max_tracks is not None:
        jcfg = jcfg.replace(caps=dataclasses.replace(jcfg.caps, k_max_tracks=k_max_tracks))
        tcfg = tcfg.replace(caps=dataclasses.replace(tcfg.caps, k_max_tracks=k_max_tracks))
    sim = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "sim_map.yaml")
    frames = _frames(sc, n=8)
    msgs = [make_pointcloud2(buf[mask], stamp=float(t) + 1.0) for buf, mask, t in frames]
    jmsgs = [jmake(buf[mask], stamp=float(t) + 1.0) for buf, mask, t in frames]
    jnode = JNode(jcfg)
    from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml as jload

    jnode.on_map(jload(sim))
    want = [jnode.on_pointcloud(m) for m in jmsgs]
    node = TrackerNode(tcfg, device="cpu")
    node.on_map(load_map_yaml(sim))
    got = [node.on_pointcloud(m) for m in msgs]
    assert node.decoder == "native" and node.state.bank.window.dtype == TORCH[dtype]
    published = 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        published += 1
        assert [o.id for o in g[0].obstacles] == [o.id for o in w[0].obstacles]
        for og, ow in zip(g[0].obstacles, w[0].obstacles):
            np.testing.assert_array_equal(og.position, ow.position)
            np.testing.assert_array_equal(og.velocity, ow.velocity)
    assert published >= 5
    streamed = []
    snode = StreamingNode(tcfg, on_outputs=lambda *r: streamed.append(r), depth=2, device="cpu")
    snode.on_map(load_map_yaml(sim))
    for m in msgs:
        snode.submit(m)
    snode.flush()
    assert snode.summary()["decoder"] == "native"
    pub = [r for r in got if r is not None]
    assert len(streamed) == len(pub)
    for (a, _, _), (b, _, _) in zip(streamed, pub):
        assert [o.id for o in a.obstacles] == [o.id for o in b.obstacles]
        for oa, ob in zip(a.obstacles, b.obstacles):
            np.testing.assert_array_equal(oa.position, ob.position)
            np.testing.assert_array_equal(oa.velocity, ob.velocity)
    path = str(tmp_path / "state.npz")
    save_state(path, node.state, extra=node.checkpoint_extra())
    st, meta = load_state(path, device="cpu")
    assert st.bank.window.dtype == TORCH[dtype] and meta == node.checkpoint_extra()
    assert torch.equal(st.bank.window.view(torch.int16), node.state.bank.window.view(torch.int16))
    assert torch.equal(st.bank.m0.view(torch.int16), node.state.bank.m0.view(torch.int16))


def test_half_bank_past_k4s_narrow_builds_matches_jax():
    """A bank of 1,100 slots -- past K4's 1,024, so K4 xl on the card --
    under bf16 through ``bind_env``: as the JAX package, bit for bit."""
    jcfg, jenv, tcfg, tenv, sc = _configs("bfloat16")
    kw = dict(k_max_tracks=1100)
    jcfg = jcfg.replace(caps=dataclasses.replace(jcfg.caps, **kw))
    tcfg = tcfg.replace(caps=dataclasses.replace(tcfg.caps, **kw))
    frames = _frames(sc, n=5)
    want = _jax_entry(jcfg, jenv, frames, "bind_env")
    got = _port_entry(tcfg, tenv, frames, "bind_env")
    for k, (g, w) in enumerate(zip(got, want)):
        _check_outputs(f"K=1,100 frame {k}", g, w)
