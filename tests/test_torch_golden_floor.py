"""The floor goldens (tests/golden/torch_floor{,_hungarian,_f64}_headline.npz)
and tests/golden/torch_track_wide.npz, written by
scripts/make_torch_golden.py, which the card holds the port against
(chip_smoke.py ``phase_floor``; the card has no JAX):

1. The JAX package still produces them: the track_wide cases at D = 256
   (greedy in f32 and f64, Hungarian in f32) recomputed under ``jax.jit``,
   their first frame (integers exact, floats within 1e-6; f64 1e-12), and
   each floor golden's map hash is the hash of the map rebuilt from its
   seed (``bench_cases.floor_map``).
2. The port's plain path on the CPU reproduces them: the track_wide cases
   (K = 2,048 under greedy, D = 256 under both associations, f32 and f64;
   the Hungarian ones at K = 2,048 run every auction phase to its 3,000
   iterations, minutes for the plain version here, and are held on the
   card, K4 xl against the golden; the Hungarian ones at their first
   frame), and the first frame of the f32 floor golden through
   ``Tracker.bind_env`` at the goldens' 16 m floor (328,683 cells: the
   stencil CC, D = 256; the f64 and Hungarian floors are held to the JAX
   package at a 6 m floor in tests/test_torch_floor.py) --
   integers and decisions exact, positions within 1e-5 m and velocities
   within 1e-4 m/s (f64: 1e-9 m, 1e-8 m/s); pos / vel compared where
   ``valid``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu_torch import bench_cases as bc
from multiple_object_tracking_lidar_tpu_torch.config import Capacities, TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker, track_batch
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, TrackBank, TrackerState

from test_torch_golden import _compare, one_intra_op_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
FLOOR = {"floor": {}, "floor_hungarian": {"association": "hungarian"},
         "floor_f64": {"dtype": "float64"}}
TOLS = {"float32": (1e-5, 1e-4), "float64": (1e-9, 1e-8)}
N_FLOOR = 1   # the floor golden's frames the plain path reproduces here (all 8 on the card)


@functools.lru_cache(maxsize=1)
def _track_wide():
    return dict(np.load(os.path.join(GOLDEN_DIR, "torch_track_wide.npz")))


def _wide_case(k, d, assoc, dtype):
    """(config, state with a leading bank axis, dets (1, S, D, 4), valid, t)."""
    cfg = TrackerConfig(data_length=bc.TRACK_WIDE_L, association=assoc, dtype=dtype,
                        caps=Capacities(n_max_points=1024, m_max_voxels=256, m_max_dynamic=128,
                                        c_max_clusters=d, p_max_cluster=32, k_max_tracks=k))
    bank, scal, frames = bc.track_wide_inputs(k, d, assoc, dtype)
    state = TrackerState(bank=TrackBank(**{f: torch.from_numpy(v)[None] for f, v in bank.items()}),
                         **{f: torch.as_tensor(v)[None] for f, v in scal.items()})
    dets, valid, t = (torch.from_numpy(np.stack([fr[i] for fr in frames]))[None]
                      for i in range(3))
    return cfg, state, dets, valid, t


@pytest.mark.parametrize("case", [c for c in bc.TRACK_WIDE if c[:3] != (2048, 32, "hungarian")],
                         ids=lambda c: "_".join(map(str, c)))
def test_port_plain_path_reproduces_track_wide_golden(case):
    k, d, assoc, dtype = case
    key = f"k{k}_d{d}_{assoc}_{dtype}"
    g = _track_wide()
    cfg, state, dets, valid, t = _wide_case(*case)
    n = 1 if assoc == "hungarian" else dets.shape[1]    # the auction's frames: the first here
    st, out = track_batch(state, dets[:, :n], valid[:, :n], t[:, :n], config=cfg,
                          gains_xy=Tracker(cfg, "cpu").gains_xy)
    got = {f: getattr(out, f)[0].numpy() for f in out._fields}
    ref = {f: g[f"{key}/out_{f}"][:n] for f in out._fields}
    _compare(got, ref, *TOLS[dtype])
    if n == dets.shape[1]:
        for f in ("alive", "obj_id", "birth_seq"):
            np.testing.assert_array_equal(getattr(st.bank, f)[0].numpy(), g[f"{key}/bank_{f}"])
    assert ref["valid"].sum() > 0 and ref["new_track"].sum() > 0


@pytest.mark.parametrize("case", [c for c in bc.TRACK_WIDE if c[1] == 256
                                  and c[2:] != ("hungarian", "float64")],
                         ids=lambda c: "_".join(map(str, c)))
def test_track_wide_golden_is_what_the_jax_package_computes(case):
    import jax
    import jax.numpy as jnp
    from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
    from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Perception
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import Tracker as JTracker
    from multiple_object_tracking_lidar_tpu.tracker.pipeline import track_step
    from multiple_object_tracking_lidar_tpu.tracker.state import TrackBank as JBank
    from multiple_object_tracking_lidar_tpu.tracker.state import TrackerState as JState

    k, d, assoc, dtype = case
    key = f"k{k}_d{d}_{assoc}_{dtype}"
    g = _track_wide()
    jcfg = JConfig(data_length=bc.TRACK_WIDE_L, association=assoc, dtype=dtype,
                   caps=JCaps(n_max_points=1024, m_max_voxels=256, m_max_dynamic=128,
                              c_max_clusters=d, p_max_cluster=32, k_max_tracks=k))
    bank, scal, frames = bc.track_wide_inputs(k, d, assoc, dtype)
    state = JState(bank=JBank(**{f: jnp.asarray(v) for f, v in bank.items()}),
                   **{f: jnp.asarray(v) for f, v in scal.items()})
    step = jax.jit(functools.partial(track_step, config=jcfg,
                                     gains_xy=JTracker(jcfg).gains_xy))
    tol = 1e-12 if dtype == "float64" else 1e-6
    dets, valid, t = frames[0]
    z = jnp.int32(0)
    _, o = step(state, Perception(jnp.asarray(dets), jnp.asarray(valid), jnp.asarray(t), z, z, z,
                                  jnp.int32(valid.sum()), z))
    for f in o._fields:
        a, b = np.asarray(getattr(o, f)), g[f"{key}/out_{f}"][0]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_floor_goldens_map_and_shape():
    grid = bc.floor_map(bc.FLOOR_SEED, bc.FLOOR_GOLDEN_M)
    cfg, _, _ = bc.floor_golden_case()
    for case in FLOOR:
        g = dict(np.load(os.path.join(GOLDEN_DIR, f"torch_{case}_headline.npz")))
        assert str(g["map_hash"]) == bc.floor_map_hash(grid)
        assert g["publish"].shape == (bc.FLOOR_GOLDEN_FRAMES,)
        assert g["valid"].shape[1] == cfg.caps.c_max_clusters == 256
        assert (g["n_clusters"] > 128).all() and (g["cc_saturated"] == 0).all()
        assert g["pos"].dtype == np.dtype("float64" if case == "floor_f64" else "float32")


@pytest.mark.parametrize("case", ["floor"])
def test_port_plain_path_reproduces_floor_golden(case):
    g = dict(np.load(os.path.join(GOLDEN_DIR, f"torch_{case}_headline.npz")))
    g.pop("map_hash")
    cfg, env, sc = bc.floor_golden_case()
    cfg = cfg.replace(**FLOOR[case])
    tr = Tracker(cfg, "cpu")
    step, st = tr.bind_env(env), tr.init_state()
    rows = []
    for k in range(N_FLOOR):
        pts, mask, t = bc.padded_frame(sc, k, cfg.caps.n_max_points)
        st, o = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(o)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    _compare(got, {f: v[:N_FLOOR] for f, v in g.items()}, *TOLS[cfg.dtype])
