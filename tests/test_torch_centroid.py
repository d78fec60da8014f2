"""K3's plain version (ops/centroid_cuda.py) and the circumcenter selection
(ops/centroid.py) against the JAX package.

Pair stats vs ``pair_stats_pallas_dyn`` in interpret mode: ``firstrow``
exact; ``colmax`` within atol 1e-6 + rtol 1e-5, because the JAX kernel
centres the members with an f32 sum and a HIGHEST-precision MXU gram while
K3 rounds an f64 sum and evaluates the gram elementwise in a fixed order
(a few ulp of d2 ~ 1 m^2).  The selection + determinant, given the same
pair stats, must be bit-identical (same elementwise IEEE ops, no FMA); end
to end against the jnp ``circumcenter_features_table`` the picks agree, so
the detections agree to atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.ops.centroid import (
    circumcenter_features_table,
    circumcenter_from_pair_stats as j_circ,
)
from multiple_object_tracking_lidar_tpu.ops.centroid_pallas import pair_stats_pallas_dyn
from multiple_object_tracking_lidar_tpu_torch.ops import centroid as tcen
from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda as k3

C, P = 16, 64


def _table(seed=0):
    """(C, P, 3) member table: random clusters of varied size, an empty
    slot between active ones, a collinear cluster (G == 0), duplicated
    points, a two-point and a one-point cluster, a full slot."""
    rng = np.random.default_rng(seed)
    mp = np.zeros((C, P, 3), np.float32)
    mm = np.zeros((C, P), bool)
    for c in range(C):
        if c in (3, 9):
            continue                                       # empty slots
        n = int(rng.integers(5, P))
        mp[c, :n] = (rng.normal(0, 0.15, (n, 3)) + rng.uniform(-2, 8, 3)).astype(np.float32)
        mm[c, :n] = True
    t = np.linspace(0.0, 1.0, 20, dtype=np.float32)
    mp[4] = 0.0
    mm[4] = False
    mp[4, :20] = np.stack([1.0 + 0.25 * t, 2.0 + 0.5 * t, 0.3 + 0 * t], 1)   # collinear
    mm[4, :20] = True
    mp[5, 20:40] = mp[5, :20]                                                  # duplicates
    mm[5, :40] = True
    mp[6, 2:], mm[6, 2:] = 0.0, False                                          # two points
    mp[7, 1:], mm[7, 1:] = 0.0, False                                          # one point
    mp[8] = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    mm[8] = True                                                               # full slot
    return mp, mm


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_pair_stats_match_pallas_interpret(seed):
    mp, mm = _table(seed)
    jcm, jfr = pair_stats_pallas_dyn(jnp.asarray(mp), jnp.asarray(mm), interpret=True)
    tcm, tfr = k3.pair_stats(torch.from_numpy(mp), torch.from_numpy(mm))
    np.testing.assert_array_equal(np.asarray(jfr), tfr.numpy())
    np.testing.assert_allclose(np.asarray(jcm), tcm.numpy(), rtol=1e-5, atol=1e-6)
    # init values for empty slots, and the no-pair columns of active ones
    assert (tcm[3] == -1).all() and (tfr[3] == P).all()
    assert tcm[7, 0] == -1 and tfr[7, 0] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_circumcenter_selection_bit_identical(seed):
    mp, mm = _table(seed)
    tcm, tfr = k3.pair_stats(torch.from_numpy(mp), torch.from_numpy(mm))
    t = np.float32(1.5)
    ref = j_circ(jnp.asarray(tcm.numpy()), jnp.asarray(tfr.numpy()), jnp.asarray(mp),
                 jnp.asarray(mm), jnp.float32(t))
    got = tcen.circumcenter_from_pair_stats(tcm, tfr, torch.from_numpy(mp),
                                            torch.from_numpy(mm), torch.tensor(t))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # collinear cluster: G == 0 falls back to Pi exactly
    assert got[4, 0] in mp[4, :20, 0] and got[4, 1] in mp[4, :20, 1]
    assert (got[:, 2] == 0).all() and (got[:, 3] == t).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_circumcenter_end_to_end_matches_jnp(seed):
    mp, mm = _table(seed)
    ref = circumcenter_features_table(jnp.asarray(mp), jnp.asarray(mm), jnp.float32(0.7))
    got = k3.circumcenter_features(torch.from_numpy(mp), torch.from_numpy(mm), torch.tensor(0.7))
    active = mm.any(1)
    np.testing.assert_allclose(np.asarray(ref)[active], got.numpy()[active], rtol=0, atol=1e-6)


def test_pair_stats_wrapper_cpu_route():
    mp, mm = _table(0)
    before = k3.pair_stats.launches
    k3.pair_stats(torch.from_numpy(mp), torch.from_numpy(mm))
    assert k3.pair_stats.launches == before
