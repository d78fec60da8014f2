"""The learning goldens (tests/golden/torch_learning_headline.npz and
torch_cli_tune.json, written by scripts/make_torch_golden.py), which the GPU
machine holds the port's learning node and ``tune`` against:

- the learning golden (the JAX TrackerNode on the headline config with
  ``param_fix=False``, ``learn_period=0.2``, 16 frames): its first 3 frames
  and their 2 updates recomputed (floats within 1e-6, as
  test_torch_golden.py's recomputations); the port's TrackerNode on the CPU
  reproduces all 16 frames (test_torch_golden.py's tolerances) and its 7
  updates at the same frames, the log-parameters within 5e-5 and the NLL
  within 1e-3.  The windows are the detections, which agree to their last
  bits (the goldens hold them to 1e-5 m); the finite differences divide by
  dt_gp = 0.1 s and the updates carry the difference forward
  (test_torch_learning_node.py): 1.1e-5 and 3.3e-4 seen here, three
  tracks' windows of 39 steps;
- the tune golden (the JAX CLI's ``tune`` at its defaults, 60 frames and
  30 steps): its first step recomputed exactly (the JSON lines are rounded
  to 4 decimals).  The port's ``tune`` against the JAX CLI's on the CPU is
  tests/test_torch_cli.py's, at a small config: at the defaults the port
  takes ~40 s here.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import (  # noqa: E402, F401
    REPO, TOL_DETS, TOL_VEL, _compare, one_intra_op_thread)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

LEARNING = os.path.join(REPO, "tests", "golden", "torch_learning_headline.npz")
TUNE = os.path.join(REPO, "tests", "golden", "torch_cli_tune.json")
LEARN_FIELDS = ("update_frame", "log_params", "nll_history")
TOL_LP, TOL_NLL = 5e-5, 1e-3


def _frames_part(d):
    return {f: v for f, v in d.items() if f not in LEARN_FIELDS}


def test_learning_golden_is_what_the_jax_package_computes():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = dict(np.load(LEARNING))
    out = golden_outputs(n_frames=3, case="learning")
    assert set(out) == set(ref) and ref["publish"].shape == (16,)
    _compare(_frames_part(out), _frames_part(ref), 1e-6, 1e-6, n=3)
    np.testing.assert_array_equal(out["update_frame"], [0, 2])
    np.testing.assert_array_equal(ref["update_frame"][:2], [0, 2])
    np.testing.assert_allclose(out["log_params"], ref["log_params"][:2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["nll_history"], ref["nll_history"][:2], rtol=1e-6)
    assert len(ref["update_frame"]) >= 6 and ref["log_params"].dtype == np.float32


def test_port_node_reproduces_learning_golden():
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    ref = dict(np.load(LEARNING))
    cfg, _, sc = headline_case()
    node = TrackerNode(cfg.replace(param_fix=False, learn_period=0.2), device="cpu",
                       keep_outputs=True)
    node.on_map(load_sim_grid())
    frames, lps = [], []
    for k in range(ref["publish"].shape[0]):
        n0 = len(node.nll_history)
        node.on_pointcloud(sc.frame(k))
        if len(node.nll_history) > n0:
            frames.append(k)
            lps.append(np.stack([node.log_params["x"], node.log_params["y"]]))
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
    _compare(got, _frames_part(ref), TOL_DETS, TOL_VEL)
    np.testing.assert_array_equal(frames, ref["update_frame"])
    np.testing.assert_allclose(np.asarray(lps), ref["log_params"], rtol=0, atol=TOL_LP)
    np.testing.assert_allclose(np.asarray(node.nll_history), ref["nll_history"], rtol=0,
                               atol=TOL_NLL)


def test_tune_golden_is_what_the_jax_package_computes():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import TUNE_ARGV, tune_outputs

    with open(TUNE, encoding="utf-8") as fh:
        ref = json.load(fh)
    assert ref["argv"] == TUNE_ARGV and [r["step"] for r in ref["records"]] == list(range(30))
    out = tune_outputs(steps=1)
    assert out["records"] == ref["records"][:1]
