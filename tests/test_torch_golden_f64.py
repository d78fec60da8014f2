"""The f64 goldens (``dtype="float64"`` on the headline, under greedy +
``lpf`` and under hungarian + ``ihgp``, and the CLI with a config file
``dtype: float64``; written by scripts/make_torch_golden.py with
jax_enable_x64 on), which the GPU machine holds the port's double builds
against (chip_smoke.py ``phase_f64``):

1. the JAX package still produces them: the first 2 frames recomputed
   (the CLI's first records);
2. the port's plain path on the CPU reproduces all 12 frames (the CLI's
   16) within the JAX package's f64 bounds, 1e-9 m and 1e-8 m/s (the
   CLI's 4-decimal records within ``chip_smoke.cli_errors``' bound).

Kept apart from tests/test_torch_golden.py so that the two files run on
separate workers.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_golden import one_intra_op_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _load(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS

    return dict(np.load(GOLDENS[case]))


def _compare(got: dict, ref: dict, tol_dets, tol_vel, n=None):
    """Integers and flags exact; floats within the tolerances; pos / vel
    where ``valid`` (test_torch_golden.py's rule)."""
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


def _cli_golden(case):
    import json

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS

    with open(GOLDENS[case], encoding="utf-8") as fh:
        return json.load(fh)


TOL_F64_POS, TOL_F64_VEL = 1e-9, 1e-8   # the JAX package's f64 bounds (tests/test_grid.py:241)


@pytest.mark.parametrize("case", ["f64", "f64_hungarian_ihgp"])
def test_f64_goldens_are_what_the_jax_package_computes(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = _load(case)
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref) and ref["publish"].shape == (12,)
    assert ref["raw_centroid"].dtype == ref["pos"].dtype == np.float64
    _compare(out, ref, TOL_F64_POS, TOL_F64_VEL, n=2)


@pytest.mark.parametrize("case", ["f64", "f64_hungarian_ihgp"])
def test_port_plain_path_reproduces_f64_goldens(case):
    """The port's f64 plain path (``dtype="float64"``: K1's sums cast, K2,
    K3f and K4's plain f64 versions) through ``bind_env`` on the 12
    headline frames: integers exact, floats within 1e-9 m and 1e-8 m/s."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import CASE_FIELDS

    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    ref = _load(case)
    cfg, env, sc = headline_case()
    cfg = cfg.replace(**CASE_FIELDS[case])
    tracker = Tracker(cfg, device="cpu")
    step, st = tracker.bind_env(env), tracker.init_state()
    rows = []
    for k in range(ref["publish"].shape[0]):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(out)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    assert got["pos"].dtype == got["raw_centroid"].dtype == np.float64
    _compare(got, ref, TOL_F64_POS, TOL_F64_VEL)
    assert ref["valid"][1:].sum(axis=1).min() == 3


def test_cli_f64_golden_is_what_the_jax_cli_computes():
    """The ``cli_f64`` golden (a config file ``dtype: float64``): the JAX
    CLI still prints its first records."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    import chip_smoke
    from make_torch_golden import cli_outputs

    ref = _cli_golden("cli_f64")
    out = cli_outputs("cli_f64", n_frames=3)
    n = len(out["records"])
    assert n == 2 and out["argv"] == ref["argv"][:2] + ["--frames", "3"] + ref["argv"][4:]
    first = {"records": ref["records"][:n], "speeds": ref["speeds"][:n]}
    assert chip_smoke.cli_errors(out["records"], first)[0] == []
    np.testing.assert_allclose(np.concatenate(out["speeds"]),
                               np.concatenate(first["speeds"]), rtol=0, atol=1e-9)


def test_port_cli_reproduces_the_f64_cli_golden(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    import chip_smoke
    from make_torch_golden import CLI_CONFIGS, cli_bag

    ref = _cli_golden("cli_f64")
    argv = cli_bag(str(tmp_path / "frames.npz")) + ["--device", "cpu"]
    (tmp_path / "config.yaml").write_text(CLI_CONFIGS["cli_f64"])
    argv += ["--config", str(tmp_path / "config.yaml")]
    _, recs, _ = chip_smoke.run_cli(argv)
    assert chip_smoke.cli_errors(recs, ref)[0] == []
    assert len(recs) == 15 and all(len(r["obstacles"]) == 3 for r in recs)
