"""The CLI goldens (the JAX CLI's JSON lines for ``run --backend grid`` on
16 headline frames from an npz bag, under ``lpf``, ``ihgp`` and
``association: hungarian``): the JAX CLI still prints the first 3 frames'
records, and the port's CLI on the CPU (``--device cpu``) reproduces all
16 within ``chip_smoke.cli_errors``' tolerances (frames, ids and labels
exact, pos / vel within 1e-4 plus the 4-decimal rounding).  Kept in a file
of its own so that ``--dist loadfile`` puts it on its own worker.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import REPO, one_intra_op_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _cli_golden(case):
    import json

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS

    with open(GOLDENS[case], encoding="utf-8") as fh:
        return json.load(fh)


def test_cli_golden_is_what_the_jax_cli_computes():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    import chip_smoke
    from make_torch_golden import cli_outputs

    ref = _cli_golden("cli")
    out = cli_outputs("cli", n_frames=3)
    n = len(out["records"])
    assert n == 2 and out["argv"][:2] == ref["argv"][:2]
    first = {"records": ref["records"][:n], "speeds": ref["speeds"][:n]}
    assert chip_smoke.cli_errors(out["records"], first)[0] == []
    np.testing.assert_allclose(np.concatenate(out["speeds"]),
                               np.concatenate(first["speeds"]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["cli", "cli_ihgp", "cli_hungarian"])
def test_port_cli_reproduces_cli_goldens(tmp_path, case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    sys.path.insert(0, REPO)
    import chip_smoke
    from make_torch_golden import CLI_CONFIGS, cli_bag

    ref = _cli_golden(case)
    argv = cli_bag(str(tmp_path / "frames.npz")) + ["--device", "cpu"]
    if case in CLI_CONFIGS:
        (tmp_path / "config.yaml").write_text(CLI_CONFIGS[case])
        argv += ["--config", str(tmp_path / "config.yaml")]
    _, recs, _ = chip_smoke.run_cli(argv)
    assert chip_smoke.cli_errors(recs, ref)[0] == []
    assert len(recs) == 15 and all(len(r["obstacles"]) == 3 for r in recs)
