"""K3f, the tracking paths' whole circumcenter feature in one launch
(``ops/centroid_cuda.py::circumcenter_features``), on the CPU, where its
plain version runs:

- against the JAX package's ``circumcenter_features_table_pallas_v2`` (the
  JAX pipeline's route: the Pallas pair stats in interpret mode, then the
  jnp selection) at C = 4, P = 64 with a time per slot.  The picks (i*, j*)
  taken from the two packages' pair stats are exact, and so are z, t and
  the collinear fallback (G == 0 -> Pi); x and y within atol 1e-6 m, since
  the JAX kernel centres with an f32 sum and an MXU gram where K3f rounds
  an f64 sum and evaluates the gram elementwise (a few ulp of d2); and the
  one departure, a NaN member (JAX: a NaN detection; K3f: row 0), which no
  tracking path reaches;
- a rehearsal of the kernel's banded scan in plain torch (the members
  compacted, each column's rows split over 32 lanes, lane l taking rows
  l, l + 32, ..., each lane's partial (best, row) by the serial rule, the
  partials merged by larger value, then smaller row) held bit for bit to
  ``pair_stats_plain`` on lattice clusters full of ties, NaN and inf
  members, empty and singleton slots, and to its column rule on a d2 with
  NaN entries;
- its time forms (per slot, per frame of stacked frames, one for all) and
  its CPU route (no launch);
- the tracking paths on the CPU (the dense grid through ``bind_env`` and
  ``bind_env_multi``, the point list through ``bind_env``) route the
  feature through ``circumcenter_features`` and never through K3's
  ``pair_stats`` (checked by monkeypatching).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.ops import centroid_pallas as jcp
from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

C, P = 4, 64
LANES = 32


def _table(seed):
    """(C, P) slots: a random cluster, a collinear one (G == 0), a lattice
    cluster with duplicated points (ties in both scans), an empty slot."""
    rng = np.random.default_rng(seed)
    mp = np.zeros((C, P, 3), np.float32)
    mm = np.zeros((C, P), bool)
    n = int(rng.integers(20, P))
    mp[0, :n] = (rng.normal(0, 0.3, (n, 3)) + rng.uniform(-3, 3, 3)).astype(np.float32)
    mm[0, :n] = True
    line = np.arange(25, dtype=np.float32)
    mp[1, :25] = np.stack([1.0 + 0.25 * line, -2.0 + 0.5 * line, 0.5 + 0 * line], 1)
    mm[1, :25] = True
    lat = (np.round(rng.normal(0, 1, (30, 3)) * 5) / 5).astype(np.float32)
    mp[2, :30], mp[2, 30:60] = lat, lat
    mm[2, :60] = True
    mm[2, ::7] = False                                   # gaps between members
    return mp, mm


def _picks(cm, fr):
    """(i*, j*) per slot by the selection rule, from (C, P) pair stats."""
    cm, fr = np.asarray(cm), np.asarray(fr)
    gmax = cm.max(axis=1, keepdims=True)
    have = gmax[:, 0] > -0.5
    hit = cm == gmax
    i = np.where(have, np.where(hit, fr, P).min(axis=1), 0)
    lane = np.arange(cm.shape[1])[None]
    j = np.where(have, np.where(hit & (fr == i[:, None]), lane, P).min(axis=1), 0)
    return i, j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3f_plain_matches_jax_route(seed):
    mp, mm = _table(seed)
    t = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    ref = np.asarray(jcp.circumcenter_features_table_pallas_v2(
        jnp.asarray(mp), jnp.asarray(mm), jnp.asarray(t)[:, None], interpret=True))
    got = centroid_cuda.circumcenter_features(
        torch.from_numpy(mp), torch.from_numpy(mm), torch.from_numpy(t)).numpy()
    jcm, jfr = jcp.pair_stats_pallas_dyn(jnp.asarray(mp), jnp.asarray(mm), interpret=True)
    tcm, tfr = centroid_cuda.pair_stats_plain(torch.from_numpy(mp), torch.from_numpy(mm))
    for a, b in zip(_picks(jcm, jfr), _picks(tcm, tfr)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 2:], ref[:, 2:])
    np.testing.assert_array_equal(got[:, 3], t)
    i_star = _picks(tcm, tfr)[0]
    np.testing.assert_array_equal(got[1, :2], mp[1, i_star[1], :2])   # collinear: Pi
    np.testing.assert_array_equal(got[3, :2], mp[3, 0, :2])           # empty: row 0


def test_k3f_nan_member_departs_from_jax():
    """A NaN member: JAX's column max propagates the NaN (i* = j* = 0) and
    its argmax picks the NaN lane for k*, so its detection is NaN; K3f's
    serial rule lets no NaN win, so no pair qualifies and the collinear
    fallback gives row 0.  No tracking path reaches this: the bounds test
    drops NaN points before the voxel grid, so every member is a centroid of
    finite points.  The other slots agree."""
    mp, mm = _table(0)
    mp[0, 5, 1] = np.nan
    t = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    ref = np.asarray(jcp.circumcenter_features_table_pallas_v2(
        jnp.asarray(mp), jnp.asarray(mm), jnp.asarray(t)[:, None], interpret=True))
    got = centroid_cuda.circumcenter_features(
        torch.from_numpy(mp), torch.from_numpy(mm), torch.from_numpy(t)).numpy()
    assert np.isnan(ref[0, :2]).all()
    np.testing.assert_array_equal(got[0, :2], mp[0, 0, :2])
    np.testing.assert_allclose(got[1:, :2], ref[1:, :2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 2:], ref[:, 2:])


def _serial_column_max(d2, ok):
    """The serial rule on one (P, P) d2 in plain Python: rows ascending,
    update on a strict '>' from -1."""
    p = d2.shape[0]
    cm, fr = np.full(p, -1.0, np.float32), np.zeros(p, np.int32)
    for j in range(p):
        for i in range(p):
            if ok[i, j] and d2[i, j] > cm[j]:
                cm[j], fr[j] = d2[i, j], i
    return cm, fr


def _banded(d2, ok):
    """The kernel's scan over one slot's compacted (n, n) d2 and pair mask:
    lane l keeps a partial over rows l, l + 32, ... by the serial rule; the
    lanes' partials merge by larger value, then smaller row."""
    n = d2.shape[0]
    best = torch.full((LANES, n), -1.0)
    row = torch.full((LANES, n), 2 ** 30)
    for ii in range(n):
        lane = ii % LANES
        upd = ok[ii] & (d2[ii] > best[lane])
        best[lane] = torch.where(upd, d2[ii], best[lane])
        row[lane] = torch.where(upd, ii, row[lane])
    order = torch.randperm(LANES, generator=torch.Generator().manual_seed(n))
    b, r = best[order[0]], row[order[0]]                 # merge in any order
    for lane in order[1:]:
        take = (best[lane] > b) | ((best[lane] == b) & (row[lane] < r))
        b = torch.where(take, best[lane], b)
        r = torch.where(take, row[lane], r)
    return b, torch.where(b > -1.0, r, 0)


def _rehearse(mp: torch.Tensor, mm: torch.Tensor):
    """pair_stats by the kernel's steps: compaction, the mean, centring,
    the banded scan, the statistics spread back over the original lanes."""
    c, p, _ = mp.shape
    cm = torch.full((c, p), -1.0)
    fr = torch.zeros((c, p), dtype=torch.int32)
    for k in range(c):
        lanes = torch.nonzero(mm[k]).flatten()
        n = len(lanes)
        if n == 0:
            fr[k] = p
            continue
        q = mp[k, lanes]
        mean = q.to(torch.float64).sum(0).to(torch.float32) / torch.tensor(float(n))
        pc = q - mean
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        sq = (x * x + y * y) + z * z
        gram = (x[:, None] * x[None] + y[:, None] * y[None]) + z[:, None] * z[None]
        d2 = (sq[:, None] + sq[None]) - 2.0 * gram
        ar = torch.arange(n)
        b, r = _banded(d2, ar[:, None] < ar[None])
        cm[k, lanes] = b
        fr[k, lanes] = torch.where(b > -1.0, lanes[r.clamp(max=n - 1)], 0).to(torch.int32)
    return cm, fr


def _ties_table(seed):
    rng = np.random.default_rng(seed)
    mp = np.zeros((6, 96, 3), np.float32)
    mm = np.zeros((6, 96), bool)
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2), indexing="ij"), -1)
    mp[0, :32] = g.reshape(-1, 3) * np.float32(0.1)      # a lattice: ties everywhere
    mm[0, :32] = True
    mp[1, :80] = np.round(rng.normal(0, 1, (80, 3)) * 4) / 4
    mm[1, :80] = True
    mm[1, 3::5] = False
    mp[2, 0] = [1.0, 2.0, 3.0]                            # singleton
    mm[2, 0] = True
    mp[3, :40] = rng.normal(0, 1, (40, 3))
    mm[3, :40] = True
    mp[3, 17, 1] = np.nan                                 # a NaN member
    mp[4, :10] = rng.normal(0, 1, (10, 3))
    mm[4, :10] = True
    mp[4, 4, 0] = np.inf                                  # an inf member
    return torch.from_numpy(mp), torch.from_numpy(mm)    # slot 5 empty


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_scan_rehearsal_matches_pair_stats_plain(seed):
    mp, mm = _ties_table(seed)
    want = centroid_cuda.pair_stats_plain(mp, mm)
    got = _rehearse(mp, mm)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert (want[0][3] == -1).all() and (want[1][3] == 0).all()     # NaN: no pair wins
    assert (want[1][5] == 96).all() and (want[0][2] == -1).all()


def test_banded_merge_matches_the_column_rule_with_nan():
    rng = np.random.default_rng(3)
    n = 70
    d2 = np.round(rng.uniform(-1.5, 3, (n, n)) * 4) / 4          # ties, values <= -1
    d2[rng.random((n, n)) < 0.1] = np.nan
    d2 = d2.astype(np.float32)
    ok = np.triu(np.ones((n, n), bool), 1)
    ok[:, 5] = False
    cm_s, fr_s = _serial_column_max(d2, ok)
    b, r = _banded(torch.from_numpy(d2), torch.from_numpy(ok))
    cm_p, fr_p = centroid_cuda.column_max_plain(torch.from_numpy(d2)[None],
                                                torch.from_numpy(ok)[None])
    np.testing.assert_array_equal(b.numpy(), cm_s)
    np.testing.assert_array_equal(r.numpy(), fr_s)
    np.testing.assert_array_equal(cm_p[0].numpy(), cm_s)
    np.testing.assert_array_equal(fr_p[0].numpy(), fr_s)


def test_k3f_time_forms_and_cpu_route():
    mp, mm = (torch.from_numpy(a) for a in _table(0))
    per_slot = torch.tensor([0.5, 0.5, 0.7, 0.7])
    before = (centroid_cuda.circumcenter_features.launches, centroid_cuda.pair_stats.launches)
    a = centroid_cuda.circumcenter_features(mp, mm, per_slot)
    b = centroid_cuda.circumcenter_features(mp, mm, torch.tensor([0.5, 0.7]))   # S = 2 frames
    c = centroid_cuda.circumcenter_features(mp, mm, 0.5)
    assert torch.equal(a, b) and torch.equal(a[:2], c[:2])
    assert (c[:, 3] == 0.5).all()
    assert (centroid_cuda.circumcenter_features.launches,
            centroid_cuda.pair_stats.launches) == before
    with pytest.raises(ValueError):
        centroid_cuda.circumcenter_features(mp, mm, torch.zeros(3))
    xy = centroid_cuda.circumcenter_xy(mp, mm)
    assert torch.equal(xy, a[:, :2])


@pytest.fixture()
def route_spy(monkeypatch):
    """Counts the calls of K3f's entry (and their slot counts) and of K3's."""
    calls = {"k3f": [], "k3": 0}
    k3f, k3 = centroid_cuda.circumcenter_features, centroid_cuda.pair_stats

    def spy_k3f(mpts, member_mask, t, **kw):
        calls["k3f"].append(tuple(mpts.shape))
        return k3f(mpts, member_mask, t, **kw)

    def spy_k3(mpts, member_mask):
        calls["k3"] += 1
        return k3(mpts, member_mask)

    monkeypatch.setattr(centroid_cuda, "circumcenter_features", spy_k3f)
    monkeypatch.setattr(centroid_cuda, "pair_stats", spy_k3)
    return calls


def _frames(sc, n, count):
    out = []
    for k in range(count):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:40], pts[95200:99700:3], pts[99700:]])[:n]
        buf = np.zeros((n, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(n, bool)
        mask[: len(sub)] = True
        out.append((torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(np.float32(t))))
    return out


@pytest.mark.parametrize("case", ["headline_case", "pointlist_case"])
def test_tracking_paths_route_through_k3f(route_spy, case):
    cfg, env, sc = getattr(bench_cases, case)()
    n = 4096
    cfg = cfg.replace(caps=dataclasses.replace(
        cfg.caps, n_max_points=n, c_max_clusters=8, p_max_cluster=64, k_max_tracks=8,
        m_max_voxels=min(cfg.caps.m_max_voxels, 2048),
        m_max_dynamic=min(cfg.caps.m_max_dynamic, 256)))
    tracker = Tracker(cfg, device="cpu")
    frames = _frames(sc, n, 2)
    step = tracker.bind_env(env)
    st = tracker.init_state()
    for fr in frames:
        st, out = step(st, Frame(*fr))
    assert route_spy["k3f"] == [(8, 64, 3)] * 2
    multi = tracker.bind_env_multi(env)
    stacked = Frame(*(torch.stack([f[i] for f in frames]) for i in range(3)))
    multi(tracker.init_state(), stacked)
    assert route_spy["k3f"][2:] == [(16, 64, 3)]                    # S * C slots, one call
    assert route_spy["k3"] == 0
    assert torch.isfinite(out.pos[out.valid]).all()
