"""K3f's half kernel (``csrc/circumcenter.cu::circumcenter_half_kernel``:
bf16, f16 and the f32 table build) rehearsed in torch on the CPU, in the
kernel's work layout, against its plain version
``circumcenter_features_half_plain`` and, through it, the JAX ``_one_cluster``
under ``jax.jit``.

The model (``kernel_model``) runs the kernel's decomposition with the same
half ops (``fp_half.cuh``'s rounding per op, ``dot3``, the f16 / f32 FMAs):

- the members compacted in lane order; an empty slot's determinant on its
  row 0;
- the window-parallel mean: each lane's term (its value for a member, 0 *
  value otherwise), a sum per 32-lane window in lane order, the windows'
  sums in order;
- the pair stage split as the kernel splits it -- the upper triangle's 32 x
  32 tiles, in each a lane's column and the tile's first maximum of it under
  the kernel's update rule -- and the partials, each thread's sentinel among
  them, merged in a shuffled order under jnp.argmax's total order;
- the line pick: each qualifying member's distance, with the sentinel
  (-1, lane 0), merged in a shuffled order under the same order.

Tables: ``chip_smoke.py::k3f_tables``' cases (S = 2 x C = 32, P = 384) and
``bench_cases.k3f_edge_tables`` at P = 100, 384 and 1,100 (members with
gaps, a NaN and an inf in non-member lanes, empty slots on a non-finite
row 0, d2 ties, f16 squared norms past its range).  A d2 of exactly -1
comes from no table -- the gram's rounding stays below the distances it
rounds -- so the pair merge is also held against the plain version's
selection on drawn d2 matrices with -1, values below it, ties, NaN and
infinities.

Tolerance: none -- every output bit; a NaN equals a NaN whatever its
payload (the model holds half values in f32 tensors, so its NaNs carry
other payloads than the plain version's half ops; on the card the kernel
is held to the plain version's bits, payloads included:
``tests/test_torch_cuda_k3f_half.py``, ``chip_smoke.py``).  Against
JAX: bf16 bit for bit to ``circumcenter_features_table`` jitted alone; f16
bit for bit, every slot, to the tracking step's own program (``bind_env``
with the table injected for its cluster table) -- the program that
contracts d2's doubling into its difference, so that an f16 2 gram past
65,504 is not inf; the f32 table build to the function jitted alone as
``test_torch_half.py`` holds a program that is not the step's (NaN where it
has NaN, y on more than 99.9% of slots, x on more than 80%).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.ops.centroid import circumcenter_features_table
from multiple_object_tracking_lidar_tpu_torch.bench_cases import k3f_edge_tables
from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma32

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS, WARPS, TILE = 512, 16, 32
BUILDS = {"bf16": torch.bfloat16, "f16": torch.float16, "table": torch.float32}
JNP = {"bf16": jnp.bfloat16, "f16": jnp.float16, "table": jnp.float32}


class Half:
    """Policy H of ``fp_half.cuh`` on half values held in f32 tensors."""

    def __init__(self, dt):
        self.dt = dt

    def rnd(self, x):
        return x if self.dt == torch.float32 else x.to(self.dt).float()

    def add(self, a, b):
        return self.rnd(a + b)

    def sub(self, a, b):
        return self.rnd(a - b)

    def mul(self, a, b):
        return self.rnd(a * b)

    def div(self, a, b):
        return self.rnd(a / b)

    def madd(self, a, b, c):
        if self.dt == torch.float32:
            return fma32(a, b, c)
        if self.dt == torch.float16:
            return (a.double() * b.double() + c.double()).to(torch.float16).float()
        return self.rnd(self.rnd(a * b) + c)

    def dot3(self, ax, ay, az, bx, by, bz):
        if self.dt == torch.float32:
            return fma32(az, bz, fma32(ay, by, ax * bx))
        return self.rnd((ax * bx + ay * by) + az * bz)


def beats(v, a, b, bv, ba, bb):
    """jnp.argmax's total order, elementwise: (v, a, b) beats (bv, ba, bb)."""
    vn, bn = torch.isnan(v), torch.isnan(bv)
    lex = (a < ba) | ((a == ba) & (b < bb))
    return torch.where(vn != bn, vn, torch.where(~vn & (v != bv), v > bv, lex))


def merge_shuffled(v, a, b, rng):
    """The winner of partials (v, a, b) under ``beats``, merged pairwise in
    a random order."""
    perm = torch.from_numpy(rng.permutation(len(v)))
    v, a, b = v[perm], a[perm], b[perm]
    while len(v) > 1:
        if len(v) % 2:
            v, a, b = torch.cat([v, v[-1:]]), torch.cat([a, a[-1:]]), torch.cat([b, b[-1:]])
        h = len(v) // 2
        w = beats(v[h:], a[h:], b[h:], v[:h], a[:h], b[:h])
        v, a, b = (torch.where(w, v[h:], v[:h]), torch.where(w, a[h:], a[:h]),
                   torch.where(w, b[h:], b[:h]))
    return float(v[0]), int(a[0]), int(b[0])


def pair_stage(d2, n, rng):
    """The kernel's pair stage on the (n, n) [row, column] d2 of compacted
    members (entries past the triangle unread): the tiles' per-lane first
    maxima, then every partial and each of the 512 threads' sentinel (-1,
    -1, -1) merged in a shuffled order.  Returns compacted (row, column),
    (-1, -1) for the sentinel."""
    nb = (n + TILE - 1) // TILE
    tiles = [(ib, jb) for jb in range(nb) for ib in range(jb + 1)]
    ib = torch.tensor([t[0] for t in tiles])[:, None]
    jb = torch.tensor([t[1] for t in tiles])[:, None]
    lane = torch.arange(TILE)[None, :]
    jj = TILE * jb + lane                                              # (T, 32)
    rows = torch.where(jj >= n, 0, torch.where(ib == jb, lane, TILE))
    tv = torch.full(jj.shape, -1.0)
    tr = torch.full(jj.shape, -1, dtype=torch.int64)
    col = jj.clamp(max=n - 1)
    for r in range(TILE):
        row = (TILE * ib + r).clamp(max=n - 1).expand_as(jj)
        v = d2[row, col]
        upd = (r < rows) & (tv == tv) & ~(v <= tv)
        tv = torch.where(upd, v, tv)
        tr = torch.where(upd, r, tr)
    keep = tr >= 0
    v = torch.cat([tv[keep], torch.full((THREADS,), -1.0)])
    a = torch.cat([(TILE * ib + tr).expand_as(jj)[keep], torch.full((THREADS,), -1)])
    b = torch.cat([jj[keep], torch.full((THREADS,), -1)])
    _, bi, bj = merge_shuffled(v, a, b, rng)
    return bi, bj


def circumcenter(h, pi, pj, pk, cy_alt):
    """The determinant per op of policy h: [x, y] of (Pi, Pj, Pk)."""
    pix, piy, pjx, pjy, pkx, pky = pi[0], pi[1], pj[0], pj[1], pk[0], pk[1]
    a, b = h.sub(pjx, pix), h.sub(pjy, piy)
    cc, d = h.sub(pkx, pix), h.sub(pky, piy)
    s1, s2, s3, s4 = h.add(pix, pjx), h.add(piy, pjy), h.add(pix, pkx), h.add(piy, pky)
    e = h.madd(a, s1, h.mul(b, s2))
    f = h.madd(cc, s3, h.mul(d, s4))
    g = h.mul(torch.tensor(2.0), h.madd(a, h.sub(pky, pjy), -h.mul(b, h.sub(pkx, pjx))))
    collinear = bool(g == 0.0)
    gs = torch.tensor(1.0) if collinear else g
    cx = pix if collinear else h.div(h.madd(d, e, -h.mul(b, f)), gs)
    if cy_alt:
        e, f = h.madd(b, s2, h.mul(a, s1)), h.madd(d, s4, h.mul(cc, s3))
    cy = piy if collinear else h.div(h.madd(a, f, -h.mul(cc, e)), gs)
    return cx, cy


def kernel_model(mpts, mm, t, t_div, cy_alt, seed):
    """(C, 4) of ``circumcenter_half_kernel`` in its work layout (module
    docstring), in mpts' dtype: bf16 / f16, or f32 for the table build."""
    dt = mpts.dtype
    h = Half(dt)
    rng = np.random.default_rng(seed)
    c, p, _ = mpts.shape
    out = torch.zeros((c, 4))
    for k in range(c):
        raw = mpts[k].float()                                          # (P, 3)
        lanes = torch.nonzero(mm[k]).reshape(-1)                       # compacted, in order
        n = len(lanes)
        out[k, 3] = t[k // t_div].float()
        if n == 0:
            out[k, :2] = torch.stack(circumcenter(h, raw[0], raw[0], raw[0], cy_alt))
            continue
        # the mean: a window sum per (axis, 32 lanes) in lane order, then the windows
        terms = torch.where(mm[k][:, None], raw, 0.0 * raw)
        n_win = (p + TILE - 1) // TILE
        part = torch.zeros((n_win, 3))
        for w in range(n_win):
            win = terms[TILE * w: TILE * (w + 1)]
            acc = win[0]
            for row in win[1:]:
                acc = acc + row
            part[w] = acc
        total = part[0]
        for w in range(1, n_win):
            total = total + part[w]
        cen = h.div(h.rnd(total), h.rnd(torch.tensor(float(n))))
        q = h.sub(raw[lanes], cen)                                     # (n, 3) centred members
        sq = h.dot3(q[:, 0], q[:, 1], q[:, 2], q[:, 0], q[:, 1], q[:, 2])
        g = h.dot3(q[:, None, 0], q[:, None, 1], q[:, None, 2], q[None, :, 0], q[None, :, 1],
                   q[None, :, 2])
        d2 = h.sub(h.add(sq[:, None], sq[None, :]), 2.0 * g)   # 2 g unrounded
        bi, bj = pair_stage(d2, n, rng)
        i_star = 0 if bi < 0 else int(lanes[bi])
        j_star = 0 if bi < 0 else int(lanes[bj])
        pi, pj = raw[i_star], raw[j_star]
        # the line pick over the compacted members, the sentinel (-1, lane 0)
        ex, ey = h.sub(pj[0], pi[0]), h.sub(pj[1], pi[1])
        tail = dt == torch.float32 and k % t_div >= 8 * ((t_div - 1) // 8)
        norm = h.rnd(torch.sqrt(h.madd(ex, ex, h.mul(ey, ey)) if tail
                                else h.add(h.mul(ex, ex), h.mul(ey, ey))))
        den = torch.maximum(norm, h.rnd(torch.tensor(1e-30)))
        # fmaxf: a NaN norm gives the clamp (every distance is NaN then anyway)
        den = torch.where(torch.isnan(norm), h.rnd(torch.tensor(1e-30)), den)
        m = raw[lanes]
        eq_i, eq_j = (m == pi).all(1), (m == pj).all(1)
        cross = torch.abs(h.madd(ex, h.sub(m[:, 1], pi[1]), -h.mul(ey, h.sub(m[:, 0], pi[0]))))
        dist = h.div(cross, den)
        ok = ~eq_i & ~eq_j
        v = torch.cat([dist[ok], torch.tensor([-1.0])])
        a = torch.cat([lanes[ok], torch.tensor([0])])
        _, k_star, _ = merge_shuffled(v, a, torch.zeros_like(a), rng)
        out[k, :2] = torch.stack(circumcenter(h, pi, pj, raw[k_star], cy_alt))
    return out.to(dt)


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def _tables(kind, p, dt):
    """(mpts (C, P, 3) in dt, mask (C, P), t (S,) in dt)."""
    if kind == "edge":   # 2 x 16 slots; past P = 1,024 one frame of them (the time)
        mp, mm = k3f_edge_tables(2300 + p, p, 32 if p <= 1024 else 16)
        mp, mm, s = torch.from_numpy(mp), torch.from_numpy(mm), 2 if p <= 1024 else 1
    else:
        mp, mm = _chip_smoke().k3f_tables(np.random.default_rng(p), 2, 32, p, "cpu")
        s = 2
    return mp.to(dt), mm, (torch.arange(s, dtype=torch.float64) * 0.1 + 100.0).to(dt)


def _bits(x):
    """x's bits widened to f32, every NaN one pattern."""
    x = x.float()
    return torch.where(torch.isnan(x), float("nan"), x).view(torch.int32)


TABLES = [("k3f_tables", 384), ("edge", 100), ("edge", 384), ("edge", 1100)]


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("kind,p", TABLES)
def test_kernel_layout_matches_plain(build, kind, p):
    mp, mm, t = _tables(kind, p, BUILDS[build])
    c = mp.shape[0]
    for cy_alt in ((False, True) if build != "table" else (False,)):
        got = kernel_model(mp, mm, t, c // len(t), cy_alt, seed=p)
        want = centroid_cuda.circumcenter_features_half_plain(mp, mm, t, c // len(t), cy_alt)
        assert torch.equal(_bits(got), _bits(want)), (build, cy_alt)


@pytest.mark.parametrize("seed", range(4))
def test_pair_merge_matches_plain_selection_on_drawn_d2(seed):
    """The pair stage's split and shuffled merge against the plain version's
    selection (d2m, the row maxima, ``_first_max``) on drawn d2 with -1,
    values below it, ties, NaN and infinities, and masks with gaps."""
    rng = np.random.default_rng(seed)
    p = (37, 100, 257, 64)[seed]
    vals = np.array([-1.0, -1.0, -3.0, -np.inf, 0.0, 2.5, 2.5, 7.0, np.inf, np.nan])
    for trial in range(6):
        d2 = torch.from_numpy(rng.choice(vals, (p, p)).astype(np.float32))
        if trial % 3 == 0:     # no NaN: ties among the largest
            d2 = torch.where(torch.isnan(d2), 2.5, d2)
        if trial % 3 == 1:     # nothing above -1: the sentinel
            d2 = torch.where(torch.isnan(d2) | (d2 > -1), -1.0, d2)
        mm = torch.from_numpy(rng.random(p) < (0.3, 0.8)[trial % 2])
        lanes = torch.nonzero(mm).reshape(-1)
        n = len(lanes)
        iu = torch.arange(p)
        pair = mm[:, None] & mm[None, :] & (iu[:, None] < iu[None, :])
        d2m = torch.where(pair, d2, -1.0)
        row_arg = centroid_cuda._first_max(d2m, 1)
        i_ref = int(centroid_cuda._first_max(d2m.max(dim=1).values, 0))
        j_ref = int(row_arg[i_ref])
        if n == 0:
            continue
        bi, bj = pair_stage(d2[lanes][:, lanes], n, rng)
        got = (0, 0) if bi < 0 else (int(lanes[bi]), int(lanes[bj]))
        assert got == (i_ref, j_ref), (seed, trial)


def _jax_step_detections(mp, mm, monkeypatch):
    """(C, 4) f32: the JAX f16 tracking step's raw centroids (``bind_env``,
    the program the f16 goldens come from) with its cluster table replaced
    by (mp, mm) -- ``cluster_table_grid`` patched for the trace, the table
    selected by a runtime predicate so that XLA folds nothing -- on the
    headline's first frame cut to 8,192 points (C and P of the table)."""
    import dataclasses

    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu.ops import cluster_grid as jcg
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
    from multiple_object_tracking_lidar_tpu.tracker.state import Frame as JFrame

    c, p, _ = mp.shape
    jm, jmm = jnp.asarray(mp.float().numpy()).astype(jnp.float16), jnp.asarray(mm.numpy())
    real = jcg.cluster_table_grid

    def injected(labels, n_iters, *args, **kwargs):
        tab = real(labels, n_iters, *args, **kwargs)
        on = n_iters >= 0
        return tab._replace(mpts=jnp.where(on, jm, jnp.zeros_like(jm)), member_mask=jmm & on)

    monkeypatch.setattr(jcg, "cluster_table_grid", injected)
    jcfg, jenv, sc = bench.headline_case()
    jcfg = jcfg.replace(caps=dataclasses.replace(
        jcfg.caps, n_max_points=8192, c_max_clusters=c, p_max_cluster=p, k_max_tracks=16),
        data_length=10, dtype="float16")
    pts, t = sc.frame_arrays(0)
    sub = np.concatenate([pts[:95200:20], pts[95200:99700:2], pts[99700:]])[:8192]
    buf, mask = np.zeros((8192, 3), np.float32), np.arange(8192) < len(sub)
    buf[: len(sub)] = sub
    jt = JTracker(jcfg)
    _, out = jt.bind_env(jenv, donate_state=False)(
        jt.init_state(), JFrame(jnp.asarray(buf), jnp.asarray(mask), jnp.asarray(t, jnp.float16)))
    monkeypatch.undo()
    return np.asarray(out.raw_centroid.astype(jnp.float32))


@pytest.mark.parametrize("build,kind,p", [(b, k, p) for b in BUILDS for k, p in TABLES
                                           if b != "table" or p <= 1024])
def test_plain_against_jax_one_cluster(build, kind, p, monkeypatch):
    """The plain version (so the model, above) against the JAX
    ``_one_cluster``.  bf16: ``circumcenter_features_table`` jitted alone on
    16 slots, bit for bit.  f16: the tracking step's program (``bind_env``,
    that of the f16 goldens) on every slot of the table, bit for bit -- the
    function jitted alone is another f16 program (it contracts f's other
    product in x's numerator, and on overflowing slots it and the step part
    by NaN against inf).  The f32 table build: the function jitted alone on
    16 slots (its program is the runs' point list in the step), as
    ``test_torch_half.py`` holds a program that is not the step's: 0 and t
    equal, NaN where it has NaN in x and y, y equal on more than 99.9% of
    slots and x on more than 80% (up to P = 384: its plain fma chains at P =
    1,100 take seconds on this CPU)."""
    mp, mm, _ = _tables(kind, p, BUILDS[build])
    if build == "f16":
        ref = _jax_step_detections(mp, mm, monkeypatch)
        got = centroid_cuda.circumcenter_features_half_plain(
            mp, mm, torch.tensor(float(ref[0, 3])).half(), mp.shape[0]).float().numpy()
        assert ((got == ref) | (np.isnan(got) & np.isnan(ref))).all()
        return
    mp, mm = mp[:16], mm[:16]
    jm = jnp.asarray(mp.float().numpy()).astype(JNP[build])
    ref = np.asarray(jax.jit(circumcenter_features_table)(
        jm, jnp.asarray(mm.numpy()), jnp.asarray(100.0, JNP[build])).astype(jnp.float32))
    got = centroid_cuda.circumcenter_features_half_plain(
        mp, mm, torch.tensor(100.0).to(mp.dtype), 16).float().numpy()
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    if build == "bf16":
        assert same.all()
        return
    assert same[:, 2:].all() and (np.isnan(got) == np.isnan(ref)).all()
    assert same[:, 1].mean() > 0.999 and same[:, 0].mean() > 0.8


def test_half_p_bound():
    """The half and table builds' bound on P: at least the first design's
    5,667 (P x 41 B in 227 KB), the shared memory within the H100's block
    limit at the bound and past it one lane on."""
    p = centroid_cuda.HALF_P_MAX
    assert p >= 5667
    assert centroid_cuda.half_smem_bytes(p) <= centroid_cuda.HALF_SMEM_LIMIT
    assert centroid_cuda.half_smem_bytes(p + 1) > centroid_cuda.HALF_SMEM_LIMIT
    assert centroid_cuda.half_smem_bytes(384) == 16 * 384 + 12 * (384 + 12) + 8 * 384
    assert centroid_cuda.half_smem_bytes(100) == 16 * 128 + 12 * (100 + 4) + 8 * 100
