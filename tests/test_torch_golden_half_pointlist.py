"""The bf16 perception front ends' goldens (tests/
test_torch_golden_half_pointlist_f16.py: the f16 ones, with the helpers
here).  The half perception front ends' goldens (written by
scripts/make_torch_golden.py): C, D, E, F, B, the dense grid fed by the
scatter sums and G under ``dtype="bfloat16"`` / ``"float16"`` over the full
headline frames (``{bf16,f16}_<case>``, 12 frames; G 4), and the CLI on its
default backend, the point list, with a config file setting the dtype
(``cli_{bf16,f16}_default``, 8 frames).  The GPU machine holds the port's
half builds against them (chip_smoke.py ``phase_half_pointlist``); this
file pairs with tests/test_torch_golden_half.py, which holds the dense
grid's one-hot half goldens:

1. the JAX package still produces them: the first 2 frames recomputed bit
   for bit (the CLI's first 3 frames' records);
2. the port's plain path on the CPU reproduces the first 6 frames bit for
   bit (G's 4), and the runs' point list (F) all 12 -- its f32
   circumcenter, JAX's f32 ``_one_cluster`` program, cast to half (F9,
   whose one f16 ulp on a slot of frame 7 the pair-stats route gave); the
   CLI's first 6 frames within ``chip_smoke.cli_errors``' bound
   (its records are rounded to 4 decimals).
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

from test_torch_golden import one_intra_op_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

FRONT_ENDS = ("pointlist", "pointlist_jnp", "pointlist_scan", "pointlist_runs", "runs",
              "dense_grid", "default")
PORT_FRAMES = 6   # frames the port reproduces on the CPU (all of G's and F's)


@pytest.mark.parametrize("case", [f"bf16_{c}" for c in FRONT_ENDS])
def test_half_pointlist_goldens_are_what_the_jax_package_computes(case):
    check_jax_recomputes(case)


@pytest.mark.parametrize("case", [f"bf16_{c}" for c in FRONT_ENDS])
def test_port_plain_path_reproduces_half_pointlist_goldens(case):
    check_port_reproduces(case)


def check_jax_recomputes(case):
    from make_torch_golden import GOLDENS, golden_outputs, n_frames_of

    ref = dict(np.load(GOLDENS[case]))
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref) and ref["publish"].shape == (n_frames_of(case),)
    assert ref["raw_centroid"].dtype == ref["pos"].dtype == np.float32
    assert int(ref["valid"].sum()) >= 3 * (n_frames_of(case) - 1)
    for f, r in ref.items():
        np.testing.assert_array_equal(out[f], r[:2], err_msg=f"{case} {f}")


def check_port_reproduces(case):
    import bench
    import chip_smoke
    from make_torch_golden import CASE_FIELDS, GOLDENS, _frame, n_frames_of

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    ref = dict(np.load(GOLDENS[case]))
    case_fn = bench_cases.default_case if case.endswith("_default") else bench_cases.headline_case
    cfg, env, _ = case_fn()
    cfg = cfg.replace(**CASE_FIELDS[case])
    sc = bench.headline_case()[2]
    tracker = Tracker(cfg, device="cpu")
    step = tracker.bind_env(env)
    st = tracker.init_state()
    runs_list = case.endswith("_pointlist_runs")
    n = n_frames_of(case) if runs_list else min(PORT_FRAMES, n_frames_of(case))
    ref = {f: v[:n] for f, v in ref.items()}
    rows = []
    for k in range(n):
        buf, mask, t = _frame(sc, k, cfg.caps.n_max_points)
        st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        rows.append([chip_smoke.npy(x) for x in o])
    got = {f: np.stack([r[i] for r in rows]) for i, f in enumerate(o._fields)}
    chip_smoke.compare_half(case, got, ref)


def test_half_pointlist_cli_golden():
    check_cli_golden("cli_bf16_default")


def check_cli_golden(case):
    """The JAX CLI's first 3 frames' records recomputed bit for bit; the
    port's CLI (no --backend: the point list) on the CPU over the bag's
    first 6 frames within ``cli_errors``' bound (the card runs all 8)."""
    import contextlib
    import io
    import json
    import tempfile

    import chip_smoke
    from make_torch_golden import CLI_CONFIGS, GOLDENS, cli_bag, cli_outputs

    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as tmain

    with open(GOLDENS[case], encoding="utf-8") as fh:
        gold = json.load(fh)
    assert len(gold["records"]) >= 7 and "--backend" not in gold["argv"]
    again = cli_outputs(case, n_frames=3)
    assert again["records"] == [r for r in gold["records"] if r["frame"] < 3]
    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_bag(os.path.join(tmp, "frames.npz"), 6, grid=False)
        conf = os.path.join(tmp, "config.yaml")
        with open(conf, "w", encoding="utf-8") as fh:
            fh.write(CLI_CONFIGS[case])
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            assert tmain(argv + ["--config", conf, "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    keep = [i for i, r in enumerate(gold["records"]) if r["frame"] < 6]
    cut = {"records": [gold["records"][i] for i in keep],
           "speeds": [gold["speeds"][i] for i in keep]}
    errs, _ = chip_smoke.cli_errors(recs, cut)
    assert not errs, errs
