"""Exact mode (``voxel_quant="exact"``) of the port against the JAX package.

- K5's plain version (ops/voxel_grid_cuda.py) against the TPU kernels it
  replaces, run in interpret mode: ``_accumulate_pallas_v6``, ``_v3`` and
  their stacked forms, including N = 131,072 on a tiny grid (the v3 regime,
  N * 128 >= 2^24).  Raw digit sums (the JAX ``*_stacked_raw`` kernels),
  counts, point counts and the finalized f32 sums are exact, against the
  jitted ``finalize_exact_digits`` too: XLA's CPU code contracts the
  quantize's ``p - cell0`` (at the 2^19 digit scale it moves the rounded
  digit of ~0.1% of points by one) and the finalize's ``(base + i) * leaf
  + half`` and ``cnt * centre + s * 2^-k`` into FMAs, and K5 spells the
  same FMAs.
- K6's plain version against ``_accumulate_pallas_v2`` (interpret) and the
  jnp bf16x3 lowering: counts exact, sums within the JAX package's own
  tolerances (test_grid.py:395-398, :433-436): 1e-6 at a 0.1-0.15 m leaf,
  1e-5 at 0.5 m.  The two sum in different orders (the MXU's or XLA's
  against K6's ascending point index), so bits may differ.  K6's own order
  is pinned against a numpy loop.
- The dispatch: which kernel each (leaf, N, quant) takes.
- The slice on tiny caps (6 frames): the port's ``bind_env`` and
  ``bind_env_multi`` against JAX ``Tracker.bind_env_multi(hoist="on")``,
  which runs the interpret-mode stacked v6 -- the TPU's program (JAX's
  ``bind_env`` on the CPU takes the bf16x3 lowering instead).  Integers and
  decisions exact, positions within 1e-5 m, velocities within 1e-4 m/s (see
  test_torch_pipeline.py); the port's two entry points bit for bit.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.ops import voxel_grid as jvg
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid as tvg
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as kv
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
TINY = dict(x_min=0.0, x_max=0.35, y_min=0.0, y_max=0.15, z_min=0.0, z_max=1.0)


def _points(rng, n, scene, leaf, finite=False):
    """Uniform points over the scene and 0.5 m past it, a quarter on leaf
    boundaries, a dense one-cell blob, masked points; NaN and inf unless
    ``finite`` (the jnp bf16x3 lowering multiplies them by 0)."""
    pts = np.stack(
        [rng.uniform(scene["x_min"] - 0.5, scene["x_max"] + 0.5, n),
         rng.uniform(scene["y_min"] - 0.5, scene["y_max"] + 0.5, n),
         rng.uniform(scene["z_min"] - 0.5, scene["z_max"] + 0.5, n)], axis=1,
    ).astype(np.float32)
    q = n // 8
    pts[:q, :2] = (np.round(pts[:q, :2] / leaf) * leaf).astype(np.float32)
    pts[2 * q:3 * q] = (np.float32([0.05, 1.05, 0.5])
                        + rng.normal(0, 0.01, (q, 3))).astype(np.float32)
    if not finite:
        pts[q:q + 7, 0] = np.nan
        pts[q + 7:q + 11, 2] = np.inf
    mask = rng.random(n) < 0.85
    return pts, mask


def _assert_fused(got, ref, sums, scene, leaf):
    """``got`` (K5's FMA spelling) equals ``ref`` wherever XLA's CPU code
    contracted the finalize; a few cells of some programs (the v3 kernel's
    8-cell grid, a vectorized loop's remainder) keep ``cnt * (cell0 + half)
    + (s0 + 256 s1) * 2^-k`` unfused, and there ``ref`` must be that
    spelling's value bit for bit."""
    k = kv.kernel_params(TScene(**scene), leaf, 20 * leaf, quant="exact")
    nc = k["n_cells"]
    lin = np.arange(nc)
    ix, iyz = lin % k["gx"], lin // k["gx"]
    f32 = np.float32
    cell0 = [f32(k["bx"] + ix) * f32(k["leaf_xy"]), f32(k["by"] + iyz % k["gy"]) * f32(k["leaf_xy"]),
             f32(k["bz"] + iyz // k["gy"]) * f32(k["leaf_z"])]
    a = sums.astype(np.float32)
    np.testing.assert_array_equal(got[:, 3], ref[:, 3])
    for ch, (half, invq) in enumerate([(k["half_xy"], k["invq_xy"])] * 2 + [(k["half_z"], k["invq_z"])]):
        unfused = (a[:, 6] * (cell0[ch] + f32(half))
                   + (a[:, 2 * ch] + f32(256.0) * a[:, 2 * ch + 1]) * f32(invq))
        same = got[:, ch] == ref[:, ch]
        assert (same | (unfused == ref[:, ch])).all(), ch
        assert (~same).sum() <= 16, ch


def _raw(raw, nc):
    """JAX (S, 7, w1, 128) raw digit sums -> (S, 7, nc) int64."""
    raw = np.asarray(raw)
    return raw.reshape(raw.shape[0], 7, -1)[..., :nc].astype(np.int64)


def _check_k5(pts, mask, scene, leaf, ref, n_ref, raw_ref):
    ts = TScene(**scene)
    got, n_got = kv.accumulate_exact_stacked(torch.from_numpy(pts), torch.from_numpy(mask),
                                             ts, leaf, 20 * leaf)
    sums = kv.exact_digit_sums(torch.from_numpy(pts), torch.from_numpy(mask), ts, leaf, 20 * leaf)
    nc = sums.shape[2]
    np.testing.assert_array_equal(sums.numpy().astype(np.int64), _raw(raw_ref, nc))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_ref).reshape(-1))
    ref = np.asarray(ref).reshape(got.shape)
    _assert_fused(got.numpy(), ref, sums.numpy(), scene, leaf)
    # the port's finalize on the JAX raw sums against the JAX finalize, jitted
    jfin = np.asarray(jax.jit(lambda r: jvg.finalize_exact_digits(r, JScene(**scene), leaf,
                                                                  20 * leaf))(jnp.asarray(raw_ref)),
                      np.float32)
    tfin = kv.finalize_exact_digits(torch.from_numpy(_raw(raw_ref, nc).astype(np.int32)),
                                    ts, leaf, 20 * leaf).numpy()
    _assert_fused(tfin, jfin, sums.numpy(), scene, leaf)
    return sums


@pytest.mark.parametrize("kernel", ["v6", "v3"])
@pytest.mark.parametrize("leaf", [0.1, 0.05])
def test_plain_k5_matches_single_frame_kernels(kernel, leaf):
    rng = np.random.default_rng(int(leaf * 100) + len(kernel))
    n = 4096
    pts, mask = _points(rng, n, SCENE, leaf)
    js = JScene(**SCENE)
    fn = jvg._accumulate_pallas_v6 if kernel == "v6" else jvg._accumulate_pallas_v3
    raw_fn = (jvg._accumulate_pallas_v6_stacked_raw if kernel == "v6"
              else jvg._accumulate_pallas_v3_stacked_raw)
    ref, n_ref = fn(jnp.asarray(pts), jnp.asarray(mask), js, leaf, 20 * leaf,
                    block=2048, interpret=True)
    raw, _ = raw_fn(jnp.asarray(pts[None]), jnp.asarray(mask[None]), js, leaf, 20 * leaf,
                    block=2048, interpret=True)
    _check_k5(pts[None], mask[None], SCENE, leaf, ref, n_ref, raw)


@pytest.mark.parametrize("kernel", ["v6", "v3"])
def test_plain_k5_matches_stacked_kernels(kernel):
    rng = np.random.default_rng(7 + len(kernel))
    frames = [_points(rng, 2048, SCENE, 0.1) for _ in range(2)]
    pts = np.stack([f[0] for f in frames])
    mask = np.stack([f[1] for f in frames])
    js = JScene(**SCENE)
    fn = jvg._accumulate_pallas_v6_stacked if kernel == "v6" else jvg._accumulate_pallas_v3_stacked
    raw_fn = (jvg._accumulate_pallas_v6_stacked_raw if kernel == "v6"
              else jvg._accumulate_pallas_v3_stacked_raw)
    ref, n_ref = fn(jnp.asarray(pts), jnp.asarray(mask), js, 0.1, 2.0, block=1024, interpret=True)
    raw, _ = raw_fn(jnp.asarray(pts), jnp.asarray(mask), js, 0.1, 2.0, block=1024, interpret=True)
    _check_k5(pts, mask, SCENE, 0.1, ref, n_ref, raw)


def test_plain_k5_matches_v3_past_the_f32_bound():
    """N = 131,072 >= 2^24 / 128: the TPU leaves v6 for the i32 v3.  99% of
    the points sit in one cell near the top of the digit range, so the
    cell's digit sums are in the tens of millions."""
    n = 131_072
    assert not jvg._v6_exact_n(n)
    rng = np.random.default_rng(131)
    pts = np.stack([rng.uniform(-0.05, 0.4, n), rng.uniform(-0.05, 0.2, n),
                    rng.uniform(0.0, 1.0, n)], axis=1).astype(np.float32)
    blob = int(0.99 * n)
    pts[:blob] = [0.1999, 0.0999, 1.9]
    pts[blob:blob + 5, 1] = np.nan
    mask = rng.random(n) < 0.95
    mask[:blob] = True
    js = JScene(**TINY)
    ref, n_ref = jvg._accumulate_pallas_v3(jnp.asarray(pts), jnp.asarray(mask), js, 0.1, 2.0,
                                           block=2048, interpret=True)
    raw, _ = jvg._accumulate_pallas_v3_stacked_raw(jnp.asarray(pts[None]), jnp.asarray(mask[None]),
                                                   js, 0.1, 2.0, block=2048, interpret=True)
    sums = _check_k5(pts[None], mask[None], TINY, 0.1, ref, n_ref, raw)
    assert sums[0, 6].max() >= blob and np.abs(sums.numpy()[0, :6]).max() > 2**23


def _finite_frame(seed, n, scene, leaf):
    return _points(np.random.default_rng(seed), n, scene, leaf, finite=True)


@pytest.mark.parametrize("leaf,leaf_z,tol", [(0.5, 10.0, 1e-5), (0.15, 3.0, 1e-6)],
                         ids=["leaf0.5", "leaf0.15"])
def test_plain_k6_matches_v2_kernel(leaf, leaf_z, tol):
    pts, mask = _finite_frame(17, 2048, SCENE, leaf)
    ref = jvg._accumulate_pallas_v2(jnp.asarray(pts), jnp.asarray(mask), JScene(**SCENE),
                                    leaf, leaf_z, block=512, interpret=True)
    got, n_got = kv.accumulate_bf16x3_stacked(torch.from_numpy(pts)[None],
                                              torch.from_numpy(mask)[None],
                                              TScene(**SCENE), leaf, leaf_z)
    ref, got = np.asarray(ref), got[0].numpy()
    assert int(n_got[0]) == int(mask.sum())
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[:3], ref[:3], rtol=0, atol=tol)


def test_plain_k6_matches_jnp_lowering_when_no_block_tiles_n():
    n = 1000
    assert jvg._pick_block(n) is None and tvg.exact_route(n, 0.1, 2.0) == "K6"
    pts, mask = _finite_frame(23, n, SCENE, 0.1)
    ref, n_ref = jvg.voxel_accumulate_onehot_cm(
        jnp.asarray(pts), jnp.asarray(mask), JScene(**SCENE), 0.1, 2.0,
        use_pallas=False, quant="exact", with_npts=True)
    got, n_got = tvg.voxel_accumulate_onehot_cm(
        torch.from_numpy(pts), torch.from_numpy(mask), TScene(**SCENE), 0.1, 2.0,
        quant="exact", with_npts=True)
    ref, got = np.asarray(ref), got.numpy()
    assert int(n_ref) == int(n_got)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[:3], ref[:3], rtol=0, atol=1e-6)


def test_plain_k6_sums_in_ascending_point_index():
    """K6's written order: per cell, each bf16 part sum starts at +0.0 and
    adds the points one f32 add at a time in ascending point index; the
    result is (S1 + S2) + S3.  A numpy loop in that order gives the same
    bits, and the stacked call equals one call per frame."""
    scene = dict(x_min=-0.5, x_max=0.5, y_min=-0.5, y_max=0.5, z_min=0.0, z_max=2.0)
    ts = TScene(**scene)
    rng = np.random.default_rng(5)
    pts = rng.normal(0.0, 0.3, (3, 600, 3)).astype(np.float32) * np.float32([1, 1, 3])
    pts[:, :, 2] = np.abs(pts[:, :, 2])
    pts[1, 10:20] = np.nan
    mask = rng.random((3, 600)) < 0.9
    got, _ = kv.accumulate_bf16x3_stacked(torch.from_numpy(pts), torch.from_numpy(mask), ts, 0.1, 2.0)
    k = kv.kernel_params(ts, 0.1, 2.0)
    ok, lin, _ = kv.kept_cells(torch.from_numpy(pts), torch.from_numpy(mask), k)
    parts = kv.bf16x3_parts(torch.from_numpy(pts)).numpy()             # (S, N, 3, 3)
    for s in range(3):
        acc = np.zeros((k["n_cells"], 3, 3), np.float32)
        cnt = np.zeros(k["n_cells"], np.float32)
        for i in np.flatnonzero(ok[s].numpy()):
            c = int(lin[s, i])
            acc[c] = acc[c] + parts[s, i]                                # one f32 add each
            cnt[c] += 1
        want = np.concatenate([((acc[..., 0] + acc[..., 1]) + acc[..., 2]).T, cnt[None]])
        np.testing.assert_array_equal(got[s].numpy().view(np.uint32), want.view(np.uint32))
        one, _ = kv.accumulate_bf16x3_stacked(torch.from_numpy(pts[s:s + 1]),
                                              torch.from_numpy(mask[s:s + 1]), ts, 0.1, 2.0)
        assert torch.equal(one[0].view(torch.int32), got[s].view(torch.int32))
    v = torch.from_numpy(rng.normal(0, 5, 1000).astype(np.float32))
    np.testing.assert_array_equal(kv.bf16_rne(v).numpy(),
                                  v.to(torch.bfloat16).to(torch.float32).numpy())


@pytest.mark.parametrize(
    "leaf_xy,leaf_z,n,route",
    [(0.1, 2.0, 106_496, "K5"), (0.1, 2.0, 100_000, "K6"), (0.124, 3.9, 4096, "K5"),
     (0.125, 2.0, 4096, "K6"), (0.1, 4.0, 4096, "K6"), (0.15, 3.0, 106_496, "K6"),
     (0.05, 1.0, 512, "K5"), (0.05, 1.0, 600, "K6")],
)
def test_exact_dispatch_follows_the_tpu(leaf_xy, leaf_z, n, route):
    """K5 where the TPU takes v6/v3 (a block tiles N and the leaf fits two
    digits), K6 where it takes v2 or the jnp lowering; fast mode is K1 for
    every N (covered by test_torch_voxel.py)."""
    assert tvg._pick_block(n) == jvg._pick_block(n)
    assert tvg._v3_leaf_ok(leaf_xy, leaf_z) == jvg._v3_leaf_ok(leaf_xy, leaf_z)
    tpu = ("v6/v3" if jvg._pick_block(n) is not None and jvg._v3_leaf_ok(leaf_xy, leaf_z)
           else "v2/jnp")
    assert tvg.exact_route(n, leaf_xy, leaf_z) == route
    assert (route == "K5") == (tpu == "v6/v3")


# ---------------------------------------------------------------------------
# the slice on tiny caps
# ---------------------------------------------------------------------------
C, P, K = 16, 128, 16
N_FRAMES = 6
TOL_DETS, TOL_VEL = 1e-5, 1e-4


@pytest.fixture(scope="module", params=[8192, 8000], ids=["K5-route", "K6-route"])
def case(request):
    n = request.param
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, sc = bench.headline_case()
    jcfg = jcfg.replace(voxel_quant="exact", caps=dataclasses.replace(
        jcfg.caps, n_max_points=n, c_max_clusters=C, p_max_cluster=P, k_max_tracks=K))
    tcfg, tenv, _ = bench_cases.exact_case()
    tcfg = tcfg.replace(caps=Capacities(**dataclasses.asdict(jcfg.caps)))
    frames = []
    for k in range(N_FRAMES):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])[:n]
        buf = np.zeros((n, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(n, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    stack = [np.stack([f[i] for f in frames]) for i in range(3)]
    jt = JTracker(jcfg)
    multi = jt.bind_env_multi(jenv, donate_state=False, hoist="on")
    _, jout = multi(jt.init_state(), JFrame(*(jnp.asarray(a) for a in stack)))
    jout = jax.tree.map(np.asarray, jout)
    return dict(tcfg=tcfg, tenv=tenv, frames=frames, stack=stack, jout=jout, n=n)


def _check(tag, got, ref, k):
    v = ref.valid[k]
    for f in ref._fields:
        a, b = getattr(ref, f)[k], getattr(got, f).cpu().numpy()
        if f in ("pos", "vel"):
            tol = TOL_VEL if f == "vel" else TOL_DETS
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_DETS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


def test_exact_slice_matches_jax_multi(case):
    assert tvg.exact_route(case["n"], 0.1, 2.0) == ("K5" if case["n"] == 8192 else "K6")
    tt = TTracker(case["tcfg"], device="cpu")
    step = tt.bind_env(case["tenv"])
    st = tt.init_state()
    singles = []
    for k, (buf, mask, t) in enumerate(case["frames"]):
        st, out = step(st, TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        _check(f"bind_env frame {k}", out, case["jout"], k)
        singles.append(out)
    assert sum(int(o.valid.sum()) for o in singles) >= 3 * (N_FRAMES - 1)

    multi = tt.bind_env_multi(case["tenv"])
    st = tt.init_state()
    for d in range(2):
        sl = slice(3 * d, 3 * d + 3)
        st, outs = multi(st, TFrame(*(torch.from_numpy(a[sl]) for a in case["stack"])))
        for i in range(3):
            k = 3 * d + i
            got = type(outs)(*(x[i] for x in outs))
            _check(f"bind_env_multi frame {k}", got, case["jout"], k)
            for f, a, b in zip(got._fields, got, singles[k]):      # bit for bit
                assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), f
