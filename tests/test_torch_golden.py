"""The committed golden outputs of the JAX package on the headline scene
(tests/golden/torch_*_headline.npz, written by scripts/make_torch_golden.py),
which the GPU machine -- it has no JAX -- holds the port against.  This
file holds the dense-grid slice and the exact and runs modes, and the
helpers the other golden files share:

1. The JAX package still produces them: its first 2 frames are recomputed
   here.  Integers exact; floats within 1e-6, because XLA's CPU code
   generation (FMA contraction) may vary with the host CPU and with the x64
   flag the test session sets.
2. The port's plain path on the CPU reproduces all 12 frames: integers
   exact, detections and positions within 1e-5 m, velocities within
   1e-4 m/s (see test_torch_pipeline.py for the reasons); pos / vel
   compared where ``valid``.  Exact mode's K6 route (unpadded
   100,000-point frames, bf16x3 sums instead of the digits) is held to the
   exact golden with the same tolerances.

The other goldens are held by families, each in a file of its own so that
``--dist loadfile`` spreads them over workers: the point list
(test_torch_golden_pointlist.py), the fleet and bank growth
(test_torch_golden_fleet.py), ihgp and Hungarian
(test_torch_golden_hungarian.py), the CLI (test_torch_golden_cli.py), and
the f64 ones (test_torch_golden_f64.py, test_torch_golden_f64_pointlist.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_slice_headline.npz")
TOL_DETS, TOL_VEL = 1e-5, 1e-4


@pytest.fixture
def one_intra_op_thread():
    """The test on one intra-op thread, restored after.  The golden tests
    run thousands of torch ops on the CPU each; with the suite's workers
    oversubscribing the cores, every op's OpenMP team waits at its barriers
    for threads the OS has descheduled (the CLI golden took 675 s in the
    6-worker suite against 12 s alone).  They hold tolerances against the
    goldens, so one thread's reduction order changes no verdict."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# every golden file runs its tests so (the others import the fixture)
pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _compare(got: dict, ref: dict, tol_dets, tol_vel, n=None):
    v = ref["valid"][:n]
    for f, r in ref.items():
        r, g = r[:n], np.asarray(got[f])[:n]
        if f in ("pos", "vel"):
            np.testing.assert_allclose(g[v], r[v], rtol=0, atol=tol_vel if f == "vel" else tol_dets,
                                       err_msg=f)
        elif f == "raw_centroid":
            np.testing.assert_allclose(g, r, rtol=0, atol=tol_dets, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def test_golden_file_is_what_the_jax_package_computes(golden):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    out = golden_outputs(n_frames=2)
    assert set(out) == set(golden)
    assert golden["publish"].shape == (12,) and golden["raw_centroid"].shape == (12, 32, 4)
    _compare(out, golden, 1e-6, 1e-6, n=2)


def test_port_plain_path_reproduces_golden(golden):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cfg, env, sc = headline_case()
    tracker = Tracker(cfg, device="cpu")
    step = tracker.bind_env(env)
    st = tracker.init_state()
    rows = []
    for k in range(golden["publish"].shape[0]):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(out)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    _compare(got, golden, TOL_DETS, TOL_VEL)
    assert golden["valid"][1:].sum(axis=1).min() == 3          # three tracked objects
    assert golden["overflow"].sum() == 0 and golden["cc_saturated"].sum() == 0


def _load(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS

    return dict(np.load(GOLDENS[case]))


@pytest.mark.parametrize("case", ["exact", "runs"])
def test_exact_and_runs_goldens_are_what_the_jax_package_computes(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = _load(case)
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref)
    assert ref["publish"].shape == (12,) and ref["raw_centroid"].shape == (12, 32, 4)
    _compare(out, ref, 1e-6, 1e-6, n=2)


@pytest.mark.parametrize("case", ["exact", "runs", "exact_unpadded"])
def test_port_plain_path_reproduces_exact_and_runs_goldens(case):
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import exact_route
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cfg, env, sc = getattr(bench_cases, f"{case}_case")()
    ref = _load(case.split("_")[0])
    if case.startswith("exact"):
        want = "K6" if case == "exact_unpadded" else "K5"
        assert exact_route(cfg.caps.n_max_points, cfg.voxel_leaf_size, cfg.leaf_z) == want
    tracker = Tracker(cfg, device="cpu")
    step = tracker.bind_env(env)
    st = tracker.init_state()
    rows = []
    for k in range(ref["publish"].shape[0]):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(out)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    _compare(got, ref, TOL_DETS, TOL_VEL)
    assert ref["valid"][1:].sum(axis=1).min() == 3
