"""The f64 goldens off the dense grid's fast digits (written by
scripts/make_torch_golden.py with jax_enable_x64 on): G under
``TrackerConfig(dtype="float64")`` (``f64_default``), C, E and F
(``f64_pointlist``, ``f64_pointlist_scan``, ``f64_pointlist_runs``), the
exact and runs modes on the dense grid (``f64_exact``, ``f64_runs``), each
``CASE_FIELDS`` of its f32 case plus ``dtype="float64"`` over 4 headline
frames, and the CLI with a config file ``dtype: float64`` on its default
backend, the point list (``cli_f64_default``, 8 frames).  The GPU machine
holds the port's double builds against them (chip_smoke.py
``phase_f64_pointlist``):

1. the JAX package still produces them: the first 2 frames recomputed
   (the CLI's first 3 frames' records);
2. the port's plain path on the CPU reproduces every frame within the JAX
   package's f64 bounds, 1e-9 m and 1e-8 m/s (the CLI's 4-decimal records
   within ``chip_smoke.cli_errors``' bound); integers exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

from test_torch_golden_f64 import (  # noqa: E402, F401
    TOL_F64_POS, TOL_F64_VEL, _cli_golden, _compare, _load, one_intra_op_thread)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CASES = ["f64_default", "f64_pointlist", "f64_pointlist_scan", "f64_pointlist_runs",
         "f64_exact", "f64_runs"]


@pytest.mark.parametrize("case", CASES)
def test_f64_pointlist_goldens_are_what_the_jax_package_computes(case):
    from make_torch_golden import golden_outputs

    ref = _load(case)
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref) and ref["publish"].shape == (4,)
    assert ref["raw_centroid"].dtype == ref["pos"].dtype == np.float64
    _compare(out, ref, TOL_F64_POS, TOL_F64_VEL, n=2)


def _port_config(case):
    from make_torch_golden import CASE_FIELDS

    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    case_fn = bench_cases.default_case if case == "f64_default" else bench_cases.headline_case
    cfg, env, sc = case_fn()
    return cfg.replace(**CASE_FIELDS[case]), env, sc


@pytest.mark.parametrize("case", CASES)
def test_port_plain_path_reproduces_f64_pointlist_goldens(case):
    """The port's f64 plain path through ``bind_env`` on the golden's 4
    headline frames: integers exact, floats within 1e-9 m and 1e-8 m/s."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    ref = _load(case)
    cfg, env, sc = _port_config(case)
    assert cfg.dtype == "float64"
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


def test_cli_f64_default_golden_is_what_the_jax_cli_computes():
    """``cli_f64_default`` (a config file ``dtype: float64``, no
    ``--backend grid``): the JAX CLI still prints its first records."""
    import chip_smoke
    from make_torch_golden import cli_outputs

    ref = _cli_golden("cli_f64_default")
    assert ref["argv"][:2] == ["--frames", "8"]
    out = cli_outputs("cli_f64_default", n_frames=3)
    n = len(out["records"])
    assert n == 2 and out["argv"] == ["--frames", "3"] + ref["argv"][2:]
    first = {"records": ref["records"][:n], "speeds": ref["speeds"][:n]}
    assert chip_smoke.cli_errors(out["records"], first)[0] == []
    np.testing.assert_allclose(np.concatenate(out["speeds"]),
                               np.concatenate(first["speeds"]), rtol=0, atol=1e-9)


def test_port_cli_reproduces_the_f64_default_cli_golden(tmp_path):
    """The port's CLI on the CPU, ``run`` with the config file and no
    ``--backend``: the point list of ``TrackerConfig(dtype="float64")``."""
    import chip_smoke
    from make_torch_golden import CLI_CONFIGS, cli_bag

    ref = _cli_golden("cli_f64_default")
    argv = cli_bag(str(tmp_path / "frames.npz"), 8, grid=False) + ["--device", "cpu"]
    assert "--backend" not in argv
    (tmp_path / "config.yaml").write_text(CLI_CONFIGS["cli_f64_default"])
    argv += ["--config", str(tmp_path / "config.yaml")]
    _, recs, _ = chip_smoke.run_cli(argv)
    assert chip_smoke.cli_errors(recs, ref)[0] == []
    assert len(recs) == 7 and all(len(r["obstacles"]) == 3 for r in recs)
