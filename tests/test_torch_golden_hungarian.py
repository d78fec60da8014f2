"""The ``ihgp`` golden (the headline config with ``position_filter="ihgp"``)
and the Hungarian goldens (``association="hungarian"`` on the headline, 12
frames, and on the dense scene of ``bench.dense_case``, 8 frames): the JAX
package still produces them (2 frames recomputed), and the port's plain
path on the CPU reproduces every frame, with tests/test_torch_golden.py's
tolerances and ``_compare``.  Kept in a file of its own so that
``--dist loadfile`` puts it on its own worker.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import (  # noqa: E402, F401
    REPO, TOL_DETS, TOL_VEL, _compare, _load, golden, one_intra_op_thread)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def test_ihgp_golden_is_what_the_jax_package_computes():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = _load("ihgp")
    out = golden_outputs(n_frames=2, case="ihgp")
    assert set(out) == set(ref) and ref["publish"].shape == (12,)
    _compare(out, ref, 1e-6, 1e-6, n=2)


def test_port_plain_path_reproduces_ihgp_golden(golden):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    ref = _load("ihgp")
    cfg, env, sc = headline_case()
    cfg = cfg.replace(position_filter="ihgp")
    step = Tracker(cfg, device="cpu").bind_env(env)
    st = Tracker(cfg, device="cpu").init_state()
    rows = []
    for k in range(ref["publish"].shape[0]):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(out)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    _compare(got, ref, TOL_DETS, TOL_VEL)
    v = ref["valid"]
    assert v[1:].sum(axis=1).min() == 3
    assert np.abs(ref["pos"][v] - golden["pos"][v]).max() > 1e-3     # not the LPF positions


@pytest.mark.parametrize("case", ["hungarian", "dense_hungarian"])
def test_hungarian_goldens_are_what_the_jax_package_computes(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs, n_frames_of

    ref = _load(case)
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref) and ref["publish"].shape == (n_frames_of(case),)
    _compare(out, ref, 1e-6, 1e-6, n=2)


@pytest.mark.parametrize("case", ["hungarian", "dense_hungarian"])
def test_port_plain_path_reproduces_hungarian_goldens(case):
    """As 2, on the dense golden too: every detection and lane within the
    1e-5 m and 1e-4 m/s of the others (``chip_smoke.compare``), the two
    detections F8 once moved included (ROADMAP Queue 3, resolved)."""
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    ref = _load(case)
    make = {"hungarian": bench_cases.hungarian_case,
            "dense_hungarian": bench_cases.dense_hungarian_case}[case]
    cfg, env, sc = make()
    tracker = Tracker(cfg, device="cpu")
    step, st = tracker.bind_env(env), tracker.init_state()
    rows = []
    for k in range(ref["publish"].shape[0]):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(out)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.compare(case, got, ref, TOL_DETS, TOL_VEL)
    ids = [got["obj_id"][k][got["valid"][k]] for k in range(len(rows))]
    assert all(len(i) == len(set(i.tolist())) for i in ids)   # one detection per track
    assert got["valid"][1:].sum(axis=1).min() >= (3 if case == "hungarian" else 20)
