"""The half goldens (``dtype="bfloat16"`` and ``"float16"`` on the headline,
lpf and ihgp, and the CLI with a config file setting the dtype; written by
scripts/make_torch_golden.py), which the GPU machine holds the port's half
builds against (chip_smoke.py ``phase_half``):

1. the JAX package still produces them: the first 2 frames of each variant
   recomputed (the CLI's first records), bit for bit;
2. the port's plain path on the CPU reproduces the first 4 frames of each
   variant bit for bit, and the CLI's first records within
   ``chip_smoke.cli_errors``' bound (its records are rounded to 4 decimals).

The goldens hold the half fields widened to f32 (exactly): the card's
numpy has no bf16.  The other front ends' half goldens (the point list,
the scatter sums and the runs) are held the same way in
tests/test_torch_golden_half_pointlist.py and its f16 twin.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_golden import one_intra_op_thread  # noqa: E402, F401
from test_torch_half import _check_outputs  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
DTYPES = {"bf16": "bfloat16", "f16": "float16"}


def _variants(case, n=None):
    """{variant: {field: (frames, ...)}} of a half golden file (or of the
    golden maker's output)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS

    flat = dict(np.load(GOLDENS[case])) if n is None else n
    out = {}
    for key, v in flat.items():
        variant, field = key.split("/", 1)
        out.setdefault(variant, {})[field] = v
    return out


class _Row:
    """A golden frame's fields as attributes (``_check_outputs`` reads them)."""

    def __init__(self, fields: dict, k: int):
        self._fields = tuple(fields)
        for f, v in fields.items():
            setattr(self, f, v[k])


@pytest.mark.parametrize("case", ["bf16", "f16"])
def test_half_goldens_are_what_the_jax_package_computes(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = _variants(case)
    out = _variants(case, golden_outputs(n_frames=2, case=case))
    assert set(ref) == set(out) == {"lpf", "ihgp"}
    for variant, fields in ref.items():
        assert fields["publish"].shape == (12,) and fields["pos"].dtype == np.float32
        assert int(fields["valid"].sum()) >= 20
        for f, r in fields.items():
            np.testing.assert_array_equal(out[variant][f], r[:2], err_msg=f"{variant} {f}")


@pytest.mark.parametrize("case", ["bf16", "f16"])
def test_port_plain_path_reproduces_half_goldens(case):
    sys.path.insert(0, REPO)
    import bench
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import _frame

    dtype = DTYPES[case]
    base, env, _ = bench_cases.headline_case()
    sc = bench.headline_case()[2]
    n = 4
    for variant, ref in _variants(case).items():
        cfg = base.replace(dtype=dtype, **({"position_filter": "ihgp"} if variant == "ihgp"
                                           else {}))
        tracker = Tracker(cfg, device="cpu")
        step = tracker.bind_env(env)
        st = tracker.init_state()
        for k in range(n):
            buf, mask, t = _frame(sc, k, cfg.caps.n_max_points)
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask),
                                   torch.tensor(t)))
            _check_outputs(f"{case} {variant} frame {k}", o, _Row(ref, k))


@pytest.mark.parametrize("case", ["cli_bf16", "cli_f16"])
def test_half_cli_goldens(case):
    """The JAX CLI's first 3 records recomputed bit for bit; the port's CLI
    on the CPU over the bag's first 6 frames within ``cli_errors``' bound
    (the card runs all 16)."""
    import contextlib
    import io
    import json
    import tempfile

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke
    from make_torch_golden import CLI_CONFIGS, GOLDENS, cli_bag, cli_outputs

    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as tmain

    with open(GOLDENS[case], encoding="utf-8") as fh:
        gold = json.load(fh)
    assert len(gold["records"]) >= 12
    again = cli_outputs(case, n_frames=3)
    assert again["records"] == [r for r in gold["records"] if r["frame"] < 3]
    with tempfile.TemporaryDirectory() as tmp:
        argv = cli_bag(os.path.join(tmp, "frames.npz"))
        conf = os.path.join(tmp, "config.yaml")
        with open(conf, "w", encoding="utf-8") as fh:
            fh.write(CLI_CONFIGS[case])
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            assert tmain(argv + ["--config", conf, "--device", "cpu", "--frames", "6"]) == 0
    recs = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    keep = [i for i, r in enumerate(gold["records"]) if r["frame"] < 6]
    cut = {"records": [gold["records"][i] for i in keep], "speeds": [gold["speeds"][i] for i in keep]}
    errs, _ = chip_smoke.cli_errors(recs, cut)
    assert not errs, errs
