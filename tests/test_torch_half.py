"""``dtype="bfloat16"`` and ``"float16"`` on the dense grid (``voxel_mode=
"onehot"``, ``cluster_backend="grid"``, greedy association) against the
JAX package under ``jax.jit`` on the CPU, stage by stage and end to end.

How XLA's jitted CPU code computes in the half dtypes (the map written
into ``tracker/pipeline.py``'s docstring, and spelled by the plain versions
through ``ops/half.py``): bf16 rounds after every operation and contracts
nothing; f16 rounds after every operation but contracts each multiply-add
the step's compiled code contracts into one FMA, rounded once; reductions,
dots and einsums of half operands accumulate exact products in f32 in
ascending index and round once; a mean is that sum times f32(1 / n),
rounded; a division by a constant is a product by its reciprocal.

Tolerances: none -- integers, flags, CC labels, cluster tables,
decisions and every float bit for bit, but where a test holds the port to a
JAX program other than the tracking step's (the circumcenter table
function jitted alone) and says why.
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
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C, P, K = 8192, 16, 64, 16
N_FRAMES = 12
DTYPES = ["bfloat16", "float16"]
TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16}
JNP = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


def _configs(dtype, **fields):
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, sc = bench.headline_case()
    jcfg = jcfg.replace(caps=dataclasses.replace(
        jcfg.caps, n_max_points=N, c_max_clusters=C, p_max_cluster=P, k_max_tracks=K),
        data_length=10, dtype=dtype, **fields)
    tcfg, tenv, _ = bench_cases.headline_case()
    tcfg = tcfg.replace(caps=Capacities(**dataclasses.asdict(jcfg.caps)), data_length=10,
                        dtype=dtype, **fields)
    return jcfg, jenv, tcfg, tenv, sc


def _frames(sc, n=N_FRAMES, t0=0.0):
    """Headline frames cut to N points (every 20th wall return, every 2nd
    object point, the clutter), f32 on both sides; stamps offset by t0."""
    out = []
    for k in range(n):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])[:N]
        buf = np.zeros((N, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        out.append((buf, mask, np.float32(t + t0)))
    return out


@pytest.fixture(scope="module")
def cases():
    out = {}
    for dtype in DTYPES:
        jcfg, jenv, tcfg, tenv, sc = _configs(dtype)
        out[dtype] = dict(jcfg=jcfg, jenv=jenv, tcfg=tcfg, tenv=tenv, frames=_frames(sc))
    return out


def _np(x):
    x = x.detach().cpu() if torch.is_tensor(x) else x
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype in (torch.bfloat16, torch.float16) else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(a.dtype) in ("bfloat16",
                                                                          "float16") else a


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=msg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulator_is_k1_on_half_points_rounded(cases, dtype):
    """The points rounded to the half dtype, widened, K1's f32 sums, then
    rounded to the half dtype (JAX pipeline.py:846, voxel_grid.py:239)."""
    from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import voxel_accumulate_onehot_cm

    c = cases[dtype]
    tcfg = c["tcfg"]
    tt = TTracker(tcfg, device="cpu")
    js = JScene(**dataclasses.asdict(tcfg.scene))
    for buf, mask, t in c["frames"][:2]:
        fr = tt._frame(TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        assert fr.points.dtype == torch.float32 and fr.t.dtype == TORCH[dtype]
        accs, _ = tt.accumulate(fr.points[None], fr.mask[None])
        assert accs.dtype == TORCH[dtype]
        ref = jax.jit(lambda p, m: voxel_accumulate_onehot_cm(
            p.astype(JNP[dtype]), m, js, tcfg.voxel_leaf_size, tcfg.leaf_z, quant="fast"))(
                jnp.asarray(buf), jnp.asarray(mask))
        assert ref.dtype == JNP[dtype]
        _eq(accs[0], ref)


def _jax_perception_stages(c, buf, mask):
    """The JAX half route's accumulator, finalize, static drop and stencil
    CC on one frame, jitted."""
    from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import connected_components_grid
    from multiple_object_tracking_lidar_tpu.ops.static_mask import (
        get_cell_static_table, remove_static_cells)
    from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import (
        finalize_dense_cm, voxel_accumulate_onehot_cm)

    cfg, env = c["jcfg"], c["jenv"]
    dims = grid_shape(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    tab = get_cell_static_table(env, cfg.scene, cfg.voxel_leaf_size, *dims)
    js = JScene(**dataclasses.asdict(cfg.scene))

    def run(p, m):
        acc = voxel_accumulate_onehot_cm(p.astype(jnp.dtype(cfg.dtype)), m, js,
                                         cfg.voxel_leaf_size, cfg.leaf_z, quant="fast")
        cent, occ, _ = finalize_dense_cm(acc)
        dyn = remove_static_cells(cent, occ, env, tab)
        lab, n_it, sat = connected_components_grid(
            cent, dyn, dims, cfg.cluster_tolerance, cfg.voxel_leaf_size, cfg.leaf_z,
            cfg.caps.label_prop_iters, cfg.caps.grid_sweeps_per_iter,
            cfg.caps.grid_jumps_per_iter)
        return acc, cent, dyn, lab, n_it, sat

    if "stages" not in c:         # compiled once per case
        c["stages"] = jax.jit(run)
    return c["stages"](jnp.asarray(buf), jnp.asarray(mask))


@pytest.mark.parametrize("dtype", DTYPES)
def test_finalize_static_drop_and_cc_match_jax(cases, dtype):
    """K2's plain half version and, apart, the finalize + static drop +
    K14's plain version (the ``grid_cc="jnp"`` route) on the half
    accumulator: centroids, dynamic cells and labels exact."""
    from multiple_object_tracking_lidar_tpu_torch.ops import grid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import connected_components_grid
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import remove_static_cells
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import finalize_dense_cm

    c = cases[dtype]
    tcfg = c["tcfg"]
    tt = TTracker(tcfg, device="cpu")
    plan = tt.plan(c["tenv"])
    assert plan.k2
    caps = tcfg.caps
    for buf, mask, t in c["frames"][1:3]:
        jacc, jc, jdyn, jlab, jn, jsat = _jax_perception_stages(c, buf, mask)
        fr = tt._frame(TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        accs, _ = tt.accumulate(fr.points[None], fr.mask[None])
        _eq(accs[0], jacc)
        k2 = grid_cuda.fused_finalize_static_cc_stacked(
            accs, plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits,
            dims=plan.dims, tol=tcfg.cluster_tolerance, leaf_xy=tcfg.voxel_leaf_size,
            leaf_z=tcfg.leaf_z, kwin=plan.table.k, dtype=TORCH[dtype])
        assert k2[0].dtype == TORCH[dtype]
        _eq(k2[0][0], jc, "K2 cent")
        _eq(k2[1][0], jdyn, "K2 dyn")
        _eq(k2[2][0], jlab, "K2 labels")
        cent, occ, _ = finalize_dense_cm(accs[0])
        dyn = remove_static_cells(cent, occ, plan.env, plan.table)
        lab, n_it, sat = connected_components_grid(
            cent, dyn, plan.dims, tcfg.cluster_tolerance, tcfg.voxel_leaf_size, tcfg.leaf_z,
            caps.label_prop_iters, caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
        _eq(cent, jc, "cent")
        _eq(dyn, jdyn, "dyn")
        _eq(lab, jlab, "K14 labels")
        _eq(n_it, jn)
        _eq(sat, jsat)
        assert int((lab < lab.numel()).sum()) > 50


def _jax_track_run(c, fields, frames):
    """The JAX perception and track step, jitted, frame by frame: the
    perceptions (numpy) and outputs."""
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import perceive as j_perceive
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step as j_track_step

    from multiple_object_tracking_lidar_tpu.ops.static_mask import get_cell_static_table
    from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape

    jcfg = c["jcfg"].replace(**fields)
    jt = JTracker(jcfg)
    dims = grid_shape(jcfg.scene, jcfg.voxel_leaf_size, jcfg.leaf_z)
    table = get_cell_static_table(c["jenv"], jcfg.scene, jcfg.voxel_leaf_size, *dims)
    jperc = jax.jit(lambda f, tab: j_perceive(f, c["jenv"], config=jcfg, table=tab))
    jstep = jax.jit(lambda s, p: j_track_step(s, p, config=jcfg, gains_xy=jt.gains_xy))
    js = jt.init_state()
    percs, outs = [], []
    for buf, mask, t in frames:
        p = jperc(JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.asarray(t)), table)
        js, o = jstep(js, p)
        percs.append(p)
        outs.append(o)
    return percs, outs, js


def _check_outputs(tag, got, ref):
    """Every field of a FrameOutput / TrackOutputs bit for bit (pos / vel on
    valid lanes: the others follow det_slot, defined only where det_ok)."""
    v = _np(ref.valid).astype(bool)
    for f in ref._fields:
        a, b = _np(getattr(ref, f)), _np(getattr(got, f))
        if f in ("pos", "vel"):
            a, b = a[v], b[v]
        np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


@pytest.mark.parametrize("position_filter", ["lpf", "ihgp"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_track_step_matches_jax(cases, dtype, position_filter):
    """K4's plain half version (greedy association) on the JAX half
    perception's detections: decisions, ids, flags and positions exact;
    velocities within two ulps of the dtype at their magnitude, and at
    least at 0.25 m/s, the magnitude of the terms a velocity near zero is
    the difference of (and the GP carry, which feeds the next frames'
    velocities): XLA keeps some of the
    smoother's intermediates in f32 inside its fusions (its half-float
    conversion pairs simplified away) and sums the 9-term mean in its own
    order, which the per-op plain version follows on ~99% of values
    (one ulp of a velocity ~0.2 m/s is 1e-3 m/s in bf16)."""
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Perception, track_step
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import state_from_numpy

    c = cases[dtype]
    fields = dict(position_filter=position_filter)
    tcfg = c["tcfg"].replace(**fields)
    tt = TTracker(tcfg, device="cpu")
    percs, outs, js = _jax_track_run(c, fields, c["frames"])
    ts = tt.init_state()
    published = 0
    for k, (p, jo) in enumerate(zip(percs, outs)):
        tp = Perception(*(state_from_numpy(None) if False else _to_torch(x) for x in p))
        assert tp.dets.dtype == TORCH[dtype]
        ts, to = track_step(ts, tp, config=tcfg, gains_xy=tt.gains_xy)
        _check_outputs(f"{dtype}/{position_filter} frame {k}", to, jo)
        published += int(to.valid.sum())
    assert published >= 2 * (N_FRAMES - 1)
    jst = state_from_numpy(jax.tree.map(np.asarray, js))
    _eq(ts.bank.window, jst.bank.window, "window")
    _eq(ts.bank.m0, jst.bank.m0, "m0")


def _to_torch(x):
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import _t

    a = np.asarray(x)
    if a.dtype.name in ("bfloat16", "float16"):
        return _t(a, TORCH[a.dtype.name], "cpu")
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cluster_table_and_circumcenter_match_jax(cases, dtype):
    """The cluster table of the half centroids (copied values: exact) and
    K3f's plain half version against the JAX half pipeline's detections
    (``bind_env``'s raw centroids, whose circumcenter is the jnp table
    route), bit for bit.  Under f16 the step's program is the reference:
    XLA contracts f16 multiply-adds as each compiled program's fusion puts
    them, and ``perceive`` jitted alone departs from the step by up to
    ~0.005 m on an ill-conditioned cluster of the headline frames (G small),
    as the table function alone does (next test)."""
    from multiple_object_tracking_lidar_tpu.ops.cluster_grid import cluster_table_grid as j_ctg
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import cluster_table_grid

    c = cases[dtype]
    tcfg = c["tcfg"]
    tt = TTracker(tcfg, device="cpu")
    plan = tt.plan(c["tenv"])
    steps = _jax_entry(c["jcfg"], c["jenv"], c["frames"][:4], "bind_env")
    active = 0
    for k in (1, 2, 3):
        buf, mask, t = c["frames"][k]
        _, jc, jdyn, jlab, jn, _ = _jax_perception_stages(c, buf, mask)
        args = (plan.dims[0], tcfg.min_cluster_size, tcfg.max_cluster_size, C, P)
        jtab = jax.jit(lambda *a: j_ctg(*a, *args))(jlab, jn, jc, jdyn)
        tab = cluster_table_grid(_to_torch(jlab), _to_torch(jn), _to_torch(jc), _to_torch(jdyn),
                                 *args)
        assert tab.mpts.dtype == TORCH[dtype]
        for f in ("mpts", "member_mask", "sizes", "cluster_valid", "roots", "n_clusters"):
            _eq(getattr(tab, f), getattr(jtab, f), f)
        tj = jnp.asarray(t).astype(JNP[dtype])
        got = centroid_cuda.circumcenter_features(tab.mpts, tab.member_mask, _to_torch(tj))
        assert got.dtype == TORCH[dtype]
        v = tab.cluster_valid.numpy()
        _eq(got[v], steps[k].raw_centroid[v], "dets")
        active += int(v.sum())
    assert active >= 6


def test_k3f_half_plain_against_the_jax_table_function():
    """K3f's plain half version against the jnp ``circumcenter_features_table``
    jitted on its own, on 3,000 drawn clusters of 1-16 members: bf16 bit for
    bit; in f16 that program is not the tracking step's -- XLA contracts
    f's other product in x's numerator there -- so x agrees on most slots
    and parts by an ulp or a few elsewhere, y on all but about one in
    10,000 (the tracking step's own bits are held end to end)."""
    from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features_table
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda

    rng = np.random.default_rng(31)
    c, p = 3000, 16
    centre = rng.uniform(-20, 20, (c, 1, 3))
    mpts = (centre + rng.normal(0, 0.3, (c, p, 3))).astype(np.float32)
    mm = np.arange(p)[None] < rng.integers(1, p + 1, c)[:, None]
    for dtype in DTYPES:
        jm = jnp.asarray(mpts).astype(JNP[dtype])
        ref = _np(jax.jit(circumcenter_features_table)(jm, jnp.asarray(mm),
                                                       jnp.asarray(1.0, JNP[dtype])))
        got = _np(centroid_cuda.circumcenter_features(_to_torch(jm), torch.from_numpy(mm), 1.0))
        if dtype == "bfloat16":
            _eq(got, ref)
        else:
            _eq(got[:, 2:], ref[:, 2:])
            assert (got[:, 1] == ref[:, 1]).mean() > 0.999
            assert (got[:, 0] == ref[:, 0]).mean() > 0.8

def _jax_entry(jcfg, jenv, frames, entry, s_multi=4):
    jt = JTracker(jcfg)
    js = jt.init_state()
    hd = jnp.dtype(jcfg.dtype)
    outs = []
    if entry == "bind_env":
        step = jt.bind_env(jenv, donate_state=False)
        for buf, mask, t in frames:
            js, o = step(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.asarray(t, hd)))
            outs.append(jax.tree.map(np.asarray, o))
        return outs
    multi = jt.bind_env_multi(jenv, donate_state=False)
    for i in range(0, len(frames), s_multi):
        chunk = frames[i:i + s_multi]
        js, o = multi(js, JFrame(jnp.asarray(np.stack([f[0] for f in chunk])),
                                 jnp.asarray(np.stack([f[1] for f in chunk])),
                                 jnp.asarray(np.stack([f[2] for f in chunk]), hd)))
        o = jax.tree.map(np.asarray, o)
        outs += [type(o)(*(x[k] for x in o)) for k in range(len(chunk))]
    return outs


def _jax_exact_from_k5(jcfg, jenv, tcfg, frames):
    """The JAX package's exact-mode half route as its TPU runs it: the exact
    digits' f32 sums (the Pallas v6 kernel, which K5 ports and
    tests/test_torch_exact.py pins bit for bit; JAX's CPU ``bind_env`` takes
    its bf16x3 one-hot lowering instead, whose f32 sums differ in
    summation order -- an ulp of a half sum), rounded to the half dtype,
    then ``step_from_voxel_acc`` jitted, frame by frame."""
    from multiple_object_tracking_lidar_tpu.ops.static_mask import get_cell_static_table
    from multiple_object_tracking_lidar_tpu.ops.voxel import grid_shape
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import step_from_voxel_acc

    dims = grid_shape(jcfg.scene, jcfg.voxel_leaf_size, jcfg.leaf_z)
    get_cell_static_table(jenv, jcfg.scene, jcfg.voxel_leaf_size, *dims)   # concrete, cached
    jt = JTracker(jcfg)
    js = jt.init_state()
    hd = jnp.dtype(jcfg.dtype)
    step = jax.jit(lambda s, a, t, n: step_from_voxel_acc(s, a, t, n, jenv, config=jcfg,
                                                          gains_xy=jt.gains_xy))
    tt = TTracker(tcfg, device="cpu")
    outs = []
    for buf, mask, t in frames:
        fr = tt._frame(TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        accs, npts = tt.accumulate(fr.points[None], fr.mask[None])
        acc = jnp.asarray(accs[0].T.float().numpy()).astype(hd)
        js, o = step(js, acc, jnp.asarray(t, hd), jnp.int32(int(npts[0])))
        outs.append(jax.tree.map(np.asarray, o))
    return outs


def _port_entry(tcfg, tenv, frames, entry, s_multi=4):
    tt = TTracker(tcfg, device="cpu")
    st = tt.init_state()
    outs = []
    if entry == "bind_env":
        step = tt.bind_env(tenv)
        for buf, mask, t in frames:
            st, o = step(st, TFrame(torch.from_numpy(buf), torch.from_numpy(mask),
                                    torch.tensor(t)))
            outs.append(o)
        return outs
    multi = tt.bind_env_multi(tenv)
    for i in range(0, len(frames), s_multi):
        chunk = frames[i:i + s_multi]
        st, o = multi(st, TFrame(*(torch.from_numpy(np.stack([f[j] for f in chunk]))
                                   for j in range(3))))
        outs += [type(o)(*(x[k] for x in o)) for k in range(len(chunk))]
    return outs
