"""Greedy association (ops/assign.py with K4's plain version) against the
JAX package's ``associate_and_update(backend="jnp")``.

Decisions, ids, counters and the GP carries must match exactly; det_slot is
compared where det_ok (the only lanes where it is defined).  Windows are
copies or the interpolation backfill's f32 arithmetic: held to atol 1e-6,
because XLA on the CPU may contract ``last + jj * step`` into an FMA.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.ops.assign import associate_and_update as j_assoc
from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank as JBank
from multiple_object_tracking_lidar_tpu_torch.ops import assign_cuda as k4
from multiple_object_tracking_lidar_tpu_torch.ops.assign import associate_and_update as t_assoc
from multiple_object_tracking_lidar_tpu_torch.tracker.state import TrackBank as TBank

K, L, D = 16, 10, 8
THR, DT, GAP = 0.5, 0.1, 3.0


def _bank(rng, n_alive, t_last=1.0, full=False):
    alive = np.zeros(K, bool)
    alive[rng.permutation(K)[: (K if full else n_alive)]] = True
    obj_id = np.where(alive, np.arange(K) + 10, -1).astype(np.int32)
    birth = np.where(alive, rng.permutation(K), 2**30).astype(np.int32)
    window = np.zeros((K, L, 4), np.float32)
    xy = rng.uniform(-3, 3, (K, 2)).astype(np.float32)
    for j in range(L):
        window[:, j, :2] = xy + np.float32(0.02) * j
        window[:, j, 3] = np.float32(t_last - (L - 1 - j) * DT)
    m0 = rng.normal(0, 0.1, (K, 2, 2)).astype(np.float32)
    return alive, obj_id, birth, window, m0


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "first-frame":
        bank = _bank(rng, 0)
        dets = rng.uniform(-3, 3, (D, 4)).astype(np.float32)
        dets[:, 2], dets[:, 3] = 0.0, 0.1
        valid = np.array([1, 1, 0, 1, 1, 1, 0, 0], bool)
        return bank, dets, valid, False, 0, 0
    bank = _bank(rng, 9, full=name == "full-bank")
    alive, _, _, window, _ = bank
    live = np.flatnonzero(alive)
    dets = np.zeros((D, 4), np.float32)
    dets[:, :2] = rng.uniform(5, 8, (D, 2))          # far from every track
    dets[:, 3] = np.float32(1.1)
    dets[0, :2] = window[live[0], -1, :2] + 0.1      # two detections, one track
    dets[1, :2] = window[live[0], -1, :2] - 0.1
    dets[2, :2] = [9.0, 9.0]                         # registers ...
    dets[3, :2] = [9.2, 9.1]                         # ... and is matched again
    dets[4, :2] = window[live[1], -1, :2] + 0.05
    if name == "interp-gaps":
        # gaps 0.2 s (none), 0.35 s (backfill 3), 1.0 s (9), 2.0 s (> L)
        dets[0, 3], dets[1, 3] = 1.2, 1.35
        dets[4, :2] = window[live[2], -1, :2]
        dets[4, 3] = 2.0
        dets[5, :2] = window[live[3], -1, :2] + 0.2
        dets[5, 3] = 3.0
    valid = np.ones(D, bool)
    valid[6] = False
    return bank, dets, valid, True, 20, 30


@pytest.mark.parametrize("name", ["first-frame", "conflicts", "full-bank", "interp-gaps"])
def test_associate_matches_jnp_scan(name):
    (alive, obj_id, birth, window, m0), dets, valid, allow, nobj, nbirth = _case(name)
    jb = JBank(*(jnp.asarray(a) for a in (alive, obj_id, birth, window, m0)))
    tb = TBank(*(torch.from_numpy(a) for a in (alive, obj_id, birth, window, m0)))
    ref = j_assoc(jb, jnp.int32(nobj), jnp.int32(nbirth), jnp.asarray(dets),
                  jnp.asarray(valid), THR, DT, GAP, allow_match=allow, backend="jnp")
    got = t_assoc(tb, torch.tensor(nobj, dtype=torch.int32), torch.tensor(nbirth, dtype=torch.int32),
                  torch.from_numpy(dets), torch.from_numpy(valid), THR, DT, GAP, allow_match=allow)
    ok = np.asarray(ref.det_ok)
    np.testing.assert_array_equal(ok, got.det_ok.numpy())
    for f in ("det_id", "det_new", "next_obj_num", "next_birth", "overflow", "assoc_saturated"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), getattr(got, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.det_slot)[ok], got.det_slot.numpy()[ok])
    for f in ("alive", "obj_id", "birth_seq", "m0"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref.bank, f)), getattr(got.bank, f).numpy(), err_msg=f
        )
    np.testing.assert_allclose(np.asarray(ref.bank.window), got.bank.window.numpy(), rtol=0, atol=1e-6)
    if name == "full-bank":
        assert int(got.overflow) > 0
    if name != "first-frame":
        ids = got.det_id.numpy()
        assert ids[2] == ids[3]  # registered, then matched in the same frame (ref quirk)


def test_plain_k4_defaults_past_the_last_valid_detection():
    """Lanes past the last valid detection keep the kernel's defaults, and
    the CPU route launches nothing."""
    (alive, obj_id, birth, window, m0), dets, valid, allow, nobj, nbirth = _case("conflicts")
    valid[5:] = False
    af0 = torch.from_numpy(np.stack([window[:, -1, 0], window[:, -1, 1], window[:, -1, 3]], 1))
    ai0 = torch.from_numpy(np.stack([alive.astype(np.int32), obj_id, birth], 1))
    before = k4.assoc_scan.launches
    out = k4.assoc_scan(af0, ai0, torch.from_numpy(dets), torch.from_numpy(valid),
                        torch.tensor(True), torch.tensor(nobj), torch.tensor(nbirth),
                        thr=THR, dt_gp=DT, interp_gap_factor=GAP)
    assert k4.assoc_scan.launches == before
    slots, ids, news, oks, interps = out[6:]
    assert (slots[5:] == 0).all() and (ids[5:] == -1).all()
    assert not (news[5:] | oks[5:] | interps[5:]).any()
