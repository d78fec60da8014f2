"""Runs mode (``voxel_mode="runs"``, ``cluster_backend="grid"``) of the port
against the JAX package.

- K7's plain version (ops/segsum_cuda.py) against
  ``voxel_pallas.py::segment_totals_raster`` in interpret mode, bit for bit:
  runs across the 8,192-row block edges, length-1 runs, one run over every
  row, N < 8,192 and N = 3 * 8,192.  With inf and signed zeros in the
  values it is held to a numpy transcription of the kernel's written ops
  instead (NaN compared as NaN): XLA's CPU simplifier rewrites
  ``x * f32(same)`` into a select, so interpret mode does not spread an inf
  through the multiply-by-0 terms as the written kernel -- and K7 -- do.
- ``voxel_accumulate_runs_cm`` against JAX's, bit for bit, on NaN-free
  inputs (JAX's NaN handling is implementation-defined, see
  ops/voxel_pallas.py); the stacked call equals one call per frame.
- The kernel's register/shuffle schedule, rehearsed in numpy on K7's
  blocks and on K9's (one ragged block of 3, 7, 13 or 1,001 rows; three of
  2,048), against the written tree, bit for bit.
- The slice on tiny caps (6 frames): the port's ``bind_env`` and
  ``bind_env_multi`` against JAX ``Tracker.bind_env`` in runs mode.
  Integers and decisions exact, positions within 1e-5 m, velocities within
  1e-4 m/s (see test_torch_pipeline.py); the port's two entry points bit for
  bit.
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
from multiple_object_tracking_lidar_tpu.ops import voxel_pallas as jvp
from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.config import Capacities
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import segsum_cuda
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_pallas as tvp
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker as TTracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame as TFrame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)


def _same_bits(a, b):
    """Bitwise equality of f32 arrays, every NaN equal to every NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return (nan == np.isnan(b)).all() and np.array_equal(a[~nan].view(np.uint32),
                                                         b[~nan].view(np.uint32))


def _keys(rng, n, kind):
    if kind == "distinct":
        return np.arange(n, dtype=np.int32) * 3
    if kind == "one-run":
        return np.full(n, 17, np.int32)
    lengths = rng.integers(1, 40, n)
    k = np.repeat(np.arange(n), lengths)[:n].astype(np.int32)
    if kind == "block-edges":
        k[8150:8250] = k[8150]               # one run across the first block edge
        k[16300:24700] = k[16300]            # one run over all of block 2 and past it
        k = np.maximum.accumulate(k)
    return k


def _written_tree(ks, v, t=None):
    """The Pallas kernel's ops as written, in numpy f32, over blocks of t
    rows (K7's ``block_rows(N)`` by default): cyclic rolls,
    multiply-by-0/1, then the carry chain."""
    t = segsum_cuda.block_rows(len(ks)) if t is None else t
    k, c = ks.reshape(-1, t), v.reshape(-1, t).copy()
    i = np.arange(t)
    sh = 1
    with np.errstate(invalid="ignore"):
        while sh < t:
            same = ((np.roll(k, sh, 1) == k) & (i >= sh)).astype(np.float32)
            c = c + np.roll(c, sh, 1) * same
            sh *= 2
        for b in range(1, k.shape[0]):
            c[b] = c[b] + (k[b] == k[b - 1, -1]).astype(np.float32) * c[b - 1, -1]
    return c.reshape(-1)


@pytest.mark.parametrize(
    "n,kind,nonfinite",
    [(1024, "runs", False), (3 * 8192, "block-edges", False), (4096, "distinct", False),
     (3 * 8192, "one-run", False), (2 * 8192, "block-edges", True)],
    ids=["N1024", "3-blocks-edges", "length-1", "one-run", "inf-and-signed-zeros"],
)
def test_plain_k7_matches_segment_totals_raster(n, kind, nonfinite):
    rng = np.random.default_rng(n + len(kind))
    ks = _keys(rng, n, kind)
    vals = rng.normal(0, 3, (3, n)).astype(np.float32)
    if nonfinite:
        vals[0, 9000] = np.inf
        vals[1, 8191] = -np.inf                 # a block's last row feeds the carry
        vals[2, ::7] = -0.0
        ref = [_written_tree(ks, v) for v in vals]
        assert np.isnan(ref[0]).any()                # the inf spreads as written
    else:
        ref = jvp.segment_totals_raster(jnp.asarray(ks), *(jnp.asarray(v) for v in vals),
                                        interpret=True)
    got = segsum_cuda.segment_totals(torch.from_numpy(ks), *(torch.from_numpy(v) for v in vals))
    for g, r in zip(got, ref):
        assert _same_bits(g.numpy(), r)
    if not nonfinite:                       # each run's last row holds its total
        last = np.r_[ks[1:] != ks[:-1], True]
        tot = np.zeros(ks.max() + 1)
        np.add.at(tot, ks, vals[0].astype(np.float64))
        np.testing.assert_allclose(got[0].numpy()[last], tot[ks[last]], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize(
    "n,kind,nonfinite",
    [(3 * 8192, "block-edges", False), (1024, "runs", False), (2 * 8192, "block-edges", True)],
    ids=["3-blocks-edges", "N1024", "inf-and-signed-zeros"],
)
def test_plain_k7_with_permutation_matches_segment_totals_raster(n, kind, nonfinite):
    """K7's plain version reading the channels of one (N, 3) array through
    a permutation, as the runs front end hands them over, against JAX on the
    gathered rows (with inf and -0.0: the kernel's written ops, as above)."""
    rng = np.random.default_rng(7 * n + len(kind))
    ks = _keys(rng, n, kind)
    perm = rng.permutation(n)
    rows = rng.normal(0, 3, (n, 3)).astype(np.float32)        # rows in sorted order
    if nonfinite:
        rows[9000, 0] = np.inf
        rows[8191, 1] = -np.inf                   # a block's last row feeds the carry
        rows[::7, 2] = -0.0
    vals = np.empty_like(rows)
    vals[perm] = rows                             # unsorted, so that vals[perm] == rows
    if nonfinite:
        ref = [_written_tree(ks, rows[:, c]) for c in range(3)]
    else:
        ref = jvp.segment_totals_raster(jnp.asarray(ks), *(jnp.asarray(rows[:, c]) for c in range(3)),
                                        interpret=True)
    tv = torch.from_numpy(vals)
    got = segsum_cuda.segment_totals(torch.from_numpy(ks), tv[:, 0], tv[:, 1], tv[:, 2],
                                     perm=torch.from_numpy(perm))
    for g, r in zip(got, ref):
        assert _same_bits(g.numpy(), r)


def _chain_block_schedule(k, v):
    """One block of K7 or K9 as csrc/segsum.cu schedules it, in numpy f32:
    8 rows per thread at a pitch of T rounded up to 8 (the last thread
    holds T mod 8 rows); sh = 1, 2, 4 inside each thread on its rows and the
    7 before them (cyclic: thread 0's wrap to the block's end, more than
    once when T < 7), [row >= sh] tested only in thread 0; sh = 8 m from
    thread t - m by shuffle (lanes >= m) or from the shared array, where
    only the threads the kernel lets write have written (the rest NaN, which
    even a multiply by 0 passes on), rows i < sh reading row i - sh + T
    there."""
    t_rows = len(k)
    nt = -(-t_rows // 8)
    kp = np.zeros(8 * nt, k.dtype)
    kp[:t_rows] = k
    vp = np.zeros(8 * nt, np.float32)
    vp[:t_rows] = v
    c = vp.reshape(nt, 8).copy()
    with np.errstate(invalid="ignore"):
        for t in range(nt):
            hr = [t * 8 - 7 + q if t * 8 - 7 + q >= 0 else (t * 8 - 7 + q) % t_rows
                  for q in range(15)]
            h = np.array([vp[r] for r in hr[:7]] + list(c[t]), np.float32)
            hk = [kp[r] for r in hr]
            for sh in (1, 2, 4):
                if sh >= t_rows:
                    break
                for q in range(14, 2 * sh - 2, -1):
                    ge = t > 0 or (q - 7 >= sh if q >= 7 else hr[q] >= sh)
                    same = np.float32(hk[q - sh] == hk[q] and ge)
                    h[q] = h[q] + h[q - sh] * same
            c[t] = h[7:]
        sh = 8
        while sh < t_rows:
            m = sh // 8
            shared = np.full((nt, 8), np.nan, np.float32)
            for t in range(nt):
                if m >= 32 or t % 32 >= 32 - m or (t + 1) * 8 > t_rows - sh:
                    shared[t] = c[t]
            new = c.copy()
            for t in range(nt):
                src = t - m + nt if t < m else t - m
                if not (m >= 32 or t % 32 < m):
                    vals = c[t - m]
                elif t >= m or t_rows % 8 == 0:
                    vals = shared[src]
                else:
                    vals = shared.reshape(-1)[t_rows - sh + t * 8 + np.arange(8)]
                i = t * 8 + np.arange(8)
                same = ((kp[src * 8:src * 8 + 8] == kp[i]) & (i >= sh)).astype(np.float32)
                new[t] = c[t] + vals * same
            c = new
            sh *= 2
    return c.reshape(-1)[:t_rows]


@pytest.mark.parametrize("n,kind", [(384, "runs"), (1024, "one-run"), (3 * 8192, "block-edges"),
                                    (3, "k9-wrap"), (7, "k9-wrap"), (13, "k9-wrap"),
                                    (1001, "k9-wrap"),
                                    (3 * 2048, "k9-runs")])
def test_k7_register_schedule_rehearsed(n, kind):
    """The kernel's pass schedule (registers, shuffles, the shared array's
    writers) and its chained carry give the written tree bit for bit,
    with inf and -0.0 in the values: K7's blocks, and K9's ("k9-", blocks
    of ``row_block(N)``: three of 2,048, and one ragged block of 3, 7, 13
    or 1,001 rows whose first 8 rows are -0.0 and the rest negative but a
    last run of +2 and -1, so that a wrapped row read from the wrong place,
    the padding's +0.0, or a wrong [row >= sh] turns a -0.0 into +0.0)."""
    rng = np.random.default_rng(n)
    ks = _keys(rng, n, kind[3:] if kind.startswith("k9-") else kind)
    v = rng.normal(0, 3, n).astype(np.float32)
    v[n // 3] = np.inf
    v[::7] = -0.0
    t = segsum_cuda.row_block(n) if kind.startswith("k9-") else segsum_cuda.block_rows(n)
    if kind == "k9-wrap":                           # no inf: it would turn the block to NaN
        v[:] = -np.abs(rng.normal(0, 3, n)).astype(np.float32) - np.float32(0.5)
        v[:8] = -0.0
        ks[n - 1] = ks[n - 2]                       # the last two rows one run: +2 - 1 > 0
        v[n - 2:] = (2.0, -1.0)
    blocks = [_chain_block_schedule(ks[b * t:(b + 1) * t], v[b * t:(b + 1) * t])
              for b in range(n // t)]
    with np.errstate(invalid="ignore"):
        for b in range(1, len(blocks)):             # the chain: b - 1's last output
            same = (ks[b * t:(b + 1) * t] == ks[b * t - 1]).astype(np.float32)
            blocks[b] = blocks[b] + same * blocks[b - 1][-1]
    want = _written_tree(ks, v, t)
    assert _same_bits(np.concatenate(blocks), want)
    if kind.startswith("k9-"):
        vals = np.zeros((n, 4), np.float32)
        vals[:, 2] = v
        got = segsum_cuda.segment_totals_rows(torch.from_numpy(ks), torch.from_numpy(vals))
        assert _same_bits(got[:, 2].numpy(), want)


def test_sorted_runs_reads_through_the_permutation(monkeypatch):
    """The runs front end hands K7 the sort's permutation and the channels
    of one (S, N, 3) tensor (no gather), and gets the gathered rows' sums."""
    seen = {}
    real = tvp.segment_totals

    def spy(ks, xs, ys, zs, perm=None):
        seen["perm"], seen["base"] = perm, {c.untyped_storage().data_ptr() for c in (xs, ys, zs)}
        return real(ks, xs, ys, zs, perm=perm)

    monkeypatch.setattr(tvp, "segment_totals", spy)
    pts, mask = _frame(21, 4096)
    P, M = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
    k, ks, tots, ok, lin = tvp._sorted_runs(P, M, TScene(**SCENE), 0.1, 2.0)
    assert seen["perm"] is not None and len(seen["base"]) == 1
    vals = torch.where(ok[..., None], P, 0.0)
    rows = [torch.gather(vals[..., c], 1, seen["perm"]) for c in range(3)]
    for a, b in zip(tots, segsum_cuda.segment_totals_plain(ks, *rows)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k7_wrapper_cpu_route_and_shape_checks():
    before = segsum_cuda.segment_totals.launches
    z = torch.zeros((2, 256))
    segsum_cuda.segment_totals(torch.zeros((2, 256), dtype=torch.int32), z, z, z)
    assert segsum_cuda.segment_totals.launches == before
    assert segsum_cuda.block_rows(106_496) == 8192 and segsum_cuda.block_rows(1024) == 1024
    with pytest.raises(ValueError, match="multiple of 128"):
        segsum_cuda.block_rows(1000)
    with pytest.raises(ValueError, match="multiple of 64"):
        segsum_cuda.block_rows(128 * 65)


def _frame(seed, n):
    r = np.random.default_rng(seed)
    pts = np.stack([r.uniform(-3, 3, n), r.uniform(-2, 7, n), r.uniform(-0.5, 2.5, n)],
                   axis=1).astype(np.float32)
    pts[: n // 4] = (np.float32([0.35, 1.25, 0.5]) + r.normal(0, 0.02, (n // 4, 3))).astype(np.float32)
    return pts, r.random(n) < 0.9


def test_runs_accumulator_matches_jax_bit_for_bit():
    n = 8192
    frames = [_frame(s, n) for s in (11, 12)]
    accs = []
    for pts, mask in frames:
        ref = jvp.voxel_accumulate_runs_cm(jnp.asarray(pts), jnp.asarray(mask), JScene(**SCENE),
                                           0.1, 2.0, interpret=True)
        got = tvp.voxel_accumulate_runs_cm(torch.from_numpy(pts), torch.from_numpy(mask),
                                           TScene(**SCENE), 0.1, 2.0)
        assert got.shape == ref.shape
        assert _same_bits(got.numpy(), ref)
        accs.append(got)
    stacked, npts = tvp.voxel_accumulate_runs_stacked(
        torch.from_numpy(np.stack([f[0] for f in frames])),
        torch.from_numpy(np.stack([f[1] for f in frames])), TScene(**SCENE), 0.1, 2.0)
    for s in range(2):
        assert torch.equal(stacked[s].view(torch.int32), accs[s].view(torch.int32))
        assert int(npts[s]) == int(frames[s][1].sum())


def test_runs_accumulator_drops_nan_points():
    """The port drops a NaN point before any cast, whatever its other
    coordinates; the rest of the frame is what it is without that point."""
    pts, mask = _frame(13, 1024)
    pts[5] = [np.nan, 1.25, 0.5]
    pts[6] = [0.35, np.nan, 0.5]
    clean = mask.copy()
    clean[5:7] = False
    ts = TScene(**SCENE)
    got = tvp.voxel_accumulate_runs_cm(torch.from_numpy(pts), torch.from_numpy(mask), ts, 0.1, 2.0)
    want = tvp.voxel_accumulate_runs_cm(torch.from_numpy(pts), torch.from_numpy(clean), ts, 0.1, 2.0)
    assert torch.isfinite(got).all() and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the slice on tiny caps
# ---------------------------------------------------------------------------
N, C, P, K = 8192, 16, 128, 16
N_FRAMES = 6
TOL_DETS, TOL_VEL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def case():
    sys.path.insert(0, REPO)
    import bench

    jcfg, jenv, sc = bench.headline_case()
    jcfg = jcfg.replace(voxel_mode="runs", caps=dataclasses.replace(
        jcfg.caps, n_max_points=N, c_max_clusters=C, p_max_cluster=P, k_max_tracks=K))
    tcfg, tenv, _ = bench_cases.runs_case()
    tcfg = tcfg.replace(caps=Capacities(**dataclasses.asdict(jcfg.caps)))
    frames = []
    for k in range(N_FRAMES):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])
        buf = np.zeros((N, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(N, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    jt = JTracker(jcfg)
    jstep = jt.bind_env(jenv, donate_state=False)
    js = jt.init_state()
    jouts = []
    for buf, mask, t in frames:
        js, out = jstep(js, JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.float32(t)))
        jouts.append(jax.tree.map(np.asarray, out))
    return dict(tcfg=tcfg, tenv=tenv, frames=frames, jouts=jouts)


def _check(tag, got, ref):
    v = ref.valid
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(got, f).cpu().numpy()
        if f in ("pos", "vel"):
            tol = TOL_VEL if f == "vel" else TOL_DETS
            np.testing.assert_allclose(b[v], a[v], rtol=0, atol=tol, err_msg=f"{tag} {f}")
        elif f == "raw_centroid":
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL_DETS, err_msg=f"{tag} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {f}")


def test_runs_slice_matches_jax(case):
    tt = TTracker(case["tcfg"], device="cpu")
    step = tt.bind_env(case["tenv"])
    st = tt.init_state()
    singles = []
    for k, (buf, mask, t) in enumerate(case["frames"]):
        st, out = step(st, TFrame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        _check(f"bind_env frame {k}", out, case["jouts"][k])
        singles.append(out)
    assert sum(int(o.valid.sum()) for o in singles) >= 3 * (N_FRAMES - 1)

    multi = tt.bind_env_multi(case["tenv"])
    st = tt.init_state()
    for d in range(2):
        fr = case["frames"][3 * d:3 * d + 3]
        st, outs = multi(st, TFrame(*(torch.from_numpy(np.stack([f[i] for f in fr]))
                                      for i in range(3))))
        for i in range(3):
            k = 3 * d + i
            got = type(outs)(*(x[i] for x in outs))
            _check(f"bind_env_multi frame {k}", got, case["jouts"][k])
            for f, a, b in zip(got._fields, got, singles[k]):      # bit for bit
                assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)), f
