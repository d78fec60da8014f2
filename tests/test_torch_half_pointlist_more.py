"""``dtype="bfloat16"`` and ``"float16"`` on the perception front ends,
continued (tests/test_torch_half_pointlist_paths.py has the rest): the
one-hot accumulator into the point list (fast digits with the jnp CC,
exact digits with the Pallas CC) and the runs with the jnp CC through
``bind_env``; ``bind_env_multi`` (S = 4) on a front end of each kind;
``TrackerNode``, ``StreamingNode`` and a checkpoint round trip on D (G's
form); and the fleet, which runs under a half dtype (F10 repaired).  Every
output bit for bit the JAX package's under ``jax.jit`` on the CPU."""

import pytest

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)
from test_torch_half import N_FRAMES
from test_torch_half_paths import check_half_nodes
from test_torch_half_pointlist_paths import FRONT_ENDS, run_front_end

from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("name", ["onehot_jnp", "onehot_pallas_exact", "runs_jnp"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_more_front_ends_match_jax_through_bind_env(name, dtype):
    assert run_front_end(name, dtype, "bind_env") >= 2 * (N_FRAMES - 2)


@pytest.mark.parametrize("name,dtype", [
    ("D", "bfloat16"), ("C", "float16"), ("E", "float16"), ("F", "bfloat16"),
    ("B", "float16"), ("dense_grid", "bfloat16"),
])
def test_front_ends_match_jax_through_bind_env_multi(name, dtype):
    """12 frames in chunks of S = 4: one stacked perception and one K4
    launch per chunk, each frame's result ``bind_env``'s."""
    assert run_front_end(name, dtype, "bind_env_multi") >= 2 * (N_FRAMES - 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_point_list_nodes_match_jax(dtype, tmp_path):
    """``TrackerNode`` against the JAX node, ``StreamingNode`` against the
    port's node, and the half checkpoint's round trip, on D (the jnp CC on
    the scatter sums: ``TrackerConfig()``'s front end), with G's bank of 64
    slots, which holds every bf16 track of these frames (the streaming node
    never grows its bank)."""
    check_half_nodes(dtype, tmp_path, k_max_tracks=64, **FRONT_ENDS["D"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fleet_raises_under_a_half_dtype(dtype):
    """F10, repaired by item 28's third part: ``ShardedTracker`` runs under a
    half dtype, on the dense grid (the one-hot config, whose kernel fleet
    needs f32, so the vmap fleet as in JAX) and on the point list, and its
    half sums stay in the half dtype (tests/test_torch_half_fleet.py holds
    it bit for bit to the JAX fleet)."""
    mesh = make_mesh(1, 1, device="cpu")
    for fields in ({}, FRONT_ENDS["D"]):
        cfg = bench_cases.bench_config().replace(dtype=dtype, **fields)
        st = ShardedTracker(Tracker(cfg, device="cpu"), mesh)
        assert not st._use_kernel_fleet
        with pytest.raises(ValueError, match="kernel_path='on'"):
            ShardedTracker(Tracker(cfg, device="cpu"), mesh, kernel_path="on")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_step_from_voxel_acc_on_the_point_list_matches_jax(dtype):
    """``perceive_from_acc`` and ``step_from_voxel_acc`` (the entries after
    the accumulator, the point-sharded deployment's) on D under a half
    dtype: the same half scatter sums into both packages, 6 frames, every
    output bit for bit the jitted JAX ``step_from_voxel_acc``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import (
        step_from_voxel_acc as j_step_from_voxel_acc)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import (
        perceive_from_acc, step_from_voxel_acc)
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame
    from test_torch_half import _check_outputs, _configs, _frames

    jcfg, jenv, tcfg, tenv, sc = _configs(dtype, **FRONT_ENDS["D"])
    hd = jnp.dtype(dtype)
    jt, tt = JTracker(jcfg), Tracker(tcfg, device="cpu")
    jstep = jax.jit(lambda s, a, t, n: j_step_from_voxel_acc(s, a, t, n, jenv, config=jcfg,
                                                             gains_xy=jt.gains_xy))
    js, ts = jt.init_state(), tt.init_state()
    published = 0
    for k, (buf, mask, t) in enumerate(_frames(sc, n=6)):
        fr = tt._frame(Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        accs, npts = tt.accumulate(fr.points[None], fr.mask[None])
        acc = accs[0].T
        assert acc.dtype == fr.t.dtype
        js, jo = jstep(js, jnp.asarray(acc.float().numpy()).astype(hd), jnp.asarray(t, hd),
                       jnp.int32(int(npts[0])))
        jo = jax.tree.map(np.asarray, jo)
        p = perceive_from_acc(acc, fr.t, npts[0], tenv, config=tcfg)
        assert p.dets.dtype == fr.t.dtype
        ts, to = step_from_voxel_acc(ts, acc, fr.t, npts[0], tenv, config=tcfg,
                                     gains_xy=tt.gains_xy)
        _check_outputs(f"D {dtype} step_from_voxel_acc frame {k}", to, jo)
        np.testing.assert_array_equal(p.dets.float().numpy(), to.raw_centroid.float().numpy())
        published += int(jo.valid.sum())
    assert published >= 8
