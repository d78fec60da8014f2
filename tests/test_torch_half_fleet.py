"""The fleet (``ShardedTracker``) under ``dtype="bfloat16"`` / ``"float16"``
against the JAX package's vmap fleet, bit for bit (the JAX kernel fleet
needs f32, so every half fleet is the vmap form in both packages):

- 1 x 1 meshes, B = 4 streams, two chained steps: the headline's dense
  grid (no per-cell table in the fleet: the finalize, the per-point static
  drop, K14's half plain version) and the point list;
- under Hungarian association the JAX vmap fleet does not trace in any
  dtype (its auction's ``while_loop`` carry under ``shard_map``), so the
  port's half fleet is held to the function that fleet maps over the
  streams, the jitted JAX ``step_from_voxel_acc``, stream by stream;
- ``half_psum`` on 4 gloo ranks against the JAX ``psum`` over 4 CPU
  devices inside ``shard_map`` (bf16 summed in f32 in rank order and
  rounded once, f16 added natively in rank order);
- the (2, 2) mesh on 4 gloo ranks (2 streams and half of each cloud per
  rank) against the JAX fleet on a (2, 2) mesh of CPU devices -- whose f16
  program, compiled for several devices, contracts the circumcenter's cy
  apart from the one-device program (``centroid_cuda.mesh_program``).
"""

import dataclasses
import os
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from multiple_object_tracking_lidar_tpu.ops import static_mask as jsm  # noqa: E402
from multiple_object_tracking_lidar_tpu.parallel.sharding import ShardedTracker as JSharded  # noqa: E402
from multiple_object_tracking_lidar_tpu.parallel.sharding import make_mesh as jmesh  # noqa: E402
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker  # noqa: E402

from multiple_object_tracking_lidar_tpu_torch import bench_cases  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.ops import static_mask as tsm  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh  # noqa: E402
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker  # noqa: E402

from test_torch_fleet import TINY, _fleet_frames, _jax_config, _maps, _run_ranks  # noqa: E402
from test_torch_golden import one_intra_op_thread  # noqa: E402, F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DTYPES = ("bfloat16", "float16")
FLEETS = {  # name: config fields
    "dense-grid": {},
    "pointlist": {"voxel_mode": "dense", "cluster_backend": "jnp"},
}


def _config(dtype, fields):
    cfg = bench_cases.bench_config().replace(data_length=6, dtype=dtype, **fields)
    return cfg.replace(caps=dataclasses.replace(cfg.caps, **TINY))


def _widened(x):
    """An output field as numpy, half values widened to f32 (exactly)."""
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" else x


def _check(tag, got, want, rows=None):
    """Every field bit for bit (pos / vel on valid lanes: the others follow
    det_slot, defined only where det_ok); ``rows`` picks streams of want."""
    def pick(x):
        return _widened(x) if rows is None else _widened(x)[rows]

    v = pick(want.valid).astype(bool)
    for f in want._fields:
        a, b = pick(getattr(want, f)), _widened(getattr(got, f))
        assert a.shape == b.shape, (tag, f)
        if f in ("pos", "vel"):
            a, b = a[v], b[v]
        np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


def _jax_fleet(cfg, mesh, pts, mask, ts):
    """The JAX vmap fleet's outputs per step (numpy), on ``mesh``."""
    jcfg = _jax_config(cfg)
    grid_j, _ = _maps(0.0)
    jenv = jsm.build_static_mask(grid_j, jcfg.static_tolarance, jcfg.occupied_threshold)
    jst = JSharded(JTracker(jcfg), mesh)
    assert not jst._use_kernel_fleet
    state = jst.init_state(pts.shape[1])
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # f16's -inf _NEG cast
        for k in range(pts.shape[0]):
            state, o = jst.step(state, jnp.asarray(pts[k]), jnp.asarray(mask[k]),
                                jnp.asarray(ts[k]).astype(cfg.dtype), jenv)
            outs.append(jax.tree.map(np.asarray, o))
    return outs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(FLEETS))
def test_half_fleet_matches_jax_on_one_rank(name, dtype):
    cfg = _config(dtype, FLEETS[name])
    b = 4
    pts, mask, ts = _fleet_frames(b, cfg.caps.n_max_points, 2)
    want = _jax_fleet(cfg, jmesh(1, 1), pts, mask, ts)
    tenv = tsm.build_static_mask(_maps(0.0)[1], cfg.static_tolarance, cfg.occupied_threshold)
    tst = ShardedTracker(TTracker(cfg, device="cpu"), make_mesh(1, 1, device="cpu"))
    assert not tst._use_kernel_fleet
    state, step = tst.init_state(b), tst.bind_env(tenv)
    for k in range(2):
        state, o = step(state, torch.from_numpy(pts[k]), torch.from_numpy(mask[k]),
                        torch.from_numpy(ts[k]))
        assert o.pos.dtype == getattr(torch, dtype)
        _check(f"{name} {dtype} step {k}", o, want[k])
    assert int(o.n_clusters.min()) >= 1 and int(o.valid.sum()) >= b


@pytest.mark.parametrize("dtype", DTYPES)
def test_half_hungarian_fleet_matches_jax_step_from_voxel_acc(dtype):
    """B = 3 streams x 2 steps under Hungarian association on a 1 x 1 mesh:
    each stream's outputs bit for bit the jitted JAX ``step_from_voxel_acc``
    on the JAX half scatter sums of its points (what the JAX vmap fleet
    maps, and cannot trace here: its ``while_loop`` carry types under
    ``shard_map`` -- checked)."""
    import functools

    from multiple_object_tracking_lidar_tpu.ops.voxel import voxel_accumulate as jacc
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import step_from_voxel_acc

    cfg = _config(dtype, {"association": "hungarian"})
    jcfg = _jax_config(cfg)
    b = 3
    pts, mask, ts = _fleet_frames(b, cfg.caps.n_max_points, 2)
    with pytest.raises(TypeError, match="while_loop"):
        _jax_fleet(cfg, jmesh(1, 1), pts[:1], mask[:1], ts[:1])
    jenv = jsm.build_static_mask(_maps(0.0)[0], jcfg.static_tolarance, jcfg.occupied_threshold)
    jt = JTracker(jcfg)
    acc = jax.jit(lambda p, m: jacc(p.astype(dtype), m, jcfg.scene, jcfg.voxel_leaf_size,
                                    jcfg.leaf_z))
    step_j = jax.jit(functools.partial(step_from_voxel_acc, config=jcfg, gains_xy=jt.gains_xy))
    jstates = [jt.init_state() for _ in range(b)]
    tenv = tsm.build_static_mask(_maps(0.0)[1], cfg.static_tolarance, cfg.occupied_threshold)
    tst = ShardedTracker(TTracker(cfg, device="cpu"), make_mesh(1, 1, device="cpu"))
    state, step = tst.init_state(b), tst.bind_env(tenv)
    for k in range(2):
        state, o = step(state, torch.from_numpy(pts[k]), torch.from_numpy(mask[k]),
                        torch.from_numpy(ts[k]))
        for si in range(b):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                a = acc(jnp.asarray(pts[k, si]), jnp.asarray(mask[k, si]))
                jstates[si], jo = step_j(jstates[si], a, jnp.asarray(ts[k, si]).astype(dtype),
                                         jnp.int32(mask[k, si].sum()), jenv)
            jo = jax.tree.map(np.asarray, jo)
            _check(f"{dtype} step {k} stream {si}", type(o)(*(f[si] for f in o)), jo)
    assert int(o.valid.sum()) >= b


PSUM_WORKER = textwrap.dedent(
    """
    import sys, datetime
    sys.path.insert(0, REPO)
    import numpy as np, torch, torch.distributed as dist
    rank, store, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=90))
    from multiple_object_tracking_lidar_tpu_torch.parallel.sharding import half_psum
    d = np.load(inp)
    rows = {}
    for dt in ("bfloat16", "float16"):
        x = torch.from_numpy(d[dt][rank]).to(getattr(torch, dt))
        rows[dt] = half_psum(x, dist.group.WORLD).float().numpy()
    np.savez(out, **rows)
    dist.destroy_process_group()
    print("RANK_OK", rank)
    """
)


def test_half_psum_on_four_gloo_ranks_is_xla_s(tmp_path):
    """Values spread over 24 binades, where the order of the adds shows:
    ``half_psum`` on 4 gloo ranks equals the JAX psum over 4 devices."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 3, 500)) * np.exp2(rng.integers(-12, 12, (4, 3, 500))))
    halves = {dt: torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dt)).float().numpy()
              for dt in DTYPES}
    inp = tmp_path / "in.npz"
    np.savez(inp, **halves)
    _run_ranks(PSUM_WORKER, 4, lambda r: [str(r), str(tmp_path / "store"), str(inp),
                                           str(tmp_path / f"out{r}.npz")], tmp_path)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    psum = jax.jit(jax.shard_map(lambda v: jax.lax.psum(v[0], "space"), mesh=mesh,
                                 in_specs=P("space"), out_specs=P()))
    for dt in DTYPES:
        want = np.asarray(psum(jnp.asarray(halves[dt]).astype(dt))).astype(np.float32)
        for r in range(4):
            np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npz")[dt], want, err_msg=dt)
        # the order matters on these values: the reversed order's adds differ
        rev = torch.from_numpy(halves[dt][3]).to(getattr(torch, dt))
        for r in (2, 1, 0):
            rev = rev + torch.from_numpy(halves[dt][r]).to(getattr(torch, dt))
        assert (rev.float().numpy() != want).any(), dt


FLEET_WORKER = textwrap.dedent(
    """
    import sys, datetime, dataclasses
    sys.path.insert(0, REPO)
    import numpy as np, torch, torch.distributed as dist
    rank, store, inp, out, dtype = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                    sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=90))
    torch.set_num_threads(1)
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask
    from multiple_object_tracking_lidar_tpu_torch.parallel.sharding import (
        ShardedTracker, local_shard, make_mesh)
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    cfg = bench_cases.bench_config().replace(data_length=6, dtype=dtype)
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, **TINY))
    env = build_static_mask(bench_cases.load_sim_grid(), cfg.static_tolarance,
                            cfg.occupied_threshold)
    st = ShardedTracker(Tracker(cfg, device="cpu"), make_mesh(2, 2, device="cpu"))
    assert not st._use_kernel_fleet
    step = st.bind_env(env)
    d = np.load(inp)
    state = st.init_state(d["pts"].shape[1])
    rows = {}
    for k in range(d["pts"].shape[0]):
        state, o = step(state, *(torch.from_numpy(local_shard(d[f][k], st.mesh))
                                 for f in ("pts", "mask", "t")))
        for f, v in zip(o._fields, o):
            rows[f"{k}/{f}"] = v.float().numpy() if v.is_floating_point() else v.numpy()
    np.savez(out, **rows)
    dist.destroy_process_group()
    print("RANK_OK", rank)
    """
)


@pytest.mark.parametrize("dtype", DTYPES)
def test_half_fleet_on_a_two_by_two_gloo_mesh_matches_jax(tmp_path, dtype):
    """The half vmap fleet on a (2, 2) mesh of 4 gloo ranks (2 streams and
    half of each cloud per rank, the half sums summed over the space pair)
    against the JAX fleet on a (2, 2) mesh of CPU devices: every output of
    every rank bit for bit."""
    cfg = _config(dtype, {})
    b, n_steps = 4, 2
    pts, mask, ts = _fleet_frames(b, cfg.caps.n_max_points, n_steps, seed=300)
    inp = tmp_path / "in.npz"
    np.savez(inp, pts=pts, mask=mask, t=ts)
    _run_ranks(FLEET_WORKER, 4, lambda r: [str(r), str(tmp_path / "store"), str(inp),
                                            str(tmp_path / f"out{r}.npz"), dtype], tmp_path)
    want = _jax_fleet(cfg, jmesh(2, 2), pts, mask, ts)
    for k in range(n_steps):
        for r in range(4):
            got = np.load(tmp_path / f"out{r}.npz")
            out = type(want[k])(*(got[f"{k}/{f}"] for f in want[k]._fields))
            rows = slice(2 * (r // 2), 2 * (r // 2) + 2)  # the streams of stream rank r // 2
            _check(f"step {k} rank {r}", out, want[k], rows)
    assert int(want[-1].n_clusters.min()) >= 1
