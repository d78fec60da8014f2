"""The point-list goldens (tests/golden/torch_{pointlist,pointlist_scan,
pointlist_runs,default}_headline.npz): configurations C (dense + pallas), E
(scan + jnp), F (runs + pallas) and G (the JAX package's
``TrackerConfig()``); configuration D (dense + jnp) shares C's golden.
The JAX package still produces them (2 frames recomputed), and the port's
plain path on the CPU reproduces every frame, as tests/test_torch_golden.py
holds the headline's (its tolerances and its ``_compare``).  Kept in a file
of its own so that ``--dist loadfile`` puts it on its own worker.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import (  # noqa: E402, F401
    REPO, TOL_DETS, TOL_VEL, _compare, _load, one_intra_op_thread)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


POINTLIST = {   # golden -> the bench_cases configurations held to it
    "pointlist": ("pointlist_case", "pointlist_jnp_case"),
    "pointlist_scan": ("scan_case",),
    "pointlist_runs": ("pointlist_runs_case",),
    "default": ("default_case",),
}


@pytest.mark.parametrize("case", list(POINTLIST))
def test_pointlist_goldens_are_what_the_jax_package_computes(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs, n_frames_of

    ref = _load(case)
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref)
    c = 64 if case == "default" else 32
    assert ref["publish"].shape == (n_frames_of(case),) and ref["raw_centroid"].shape[1:] == (c, 4)
    _compare(out, ref, 1e-6, 1e-6, n=2)
    assert ref["valid"][1:].sum(axis=1).min() == 3 and ref["cc_saturated"].sum() == 0


def test_configuration_d_shares_the_pointlist_golden():
    """The jnp CC (D) gives C's labels on these frames and does not
    saturate, so D's outputs are C's golden."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    out = golden_outputs(n_frames=2, case="pointlist_jnp")
    _compare(out, _load("pointlist"), 1e-6, 1e-6, n=2)
    assert out["cc_saturated"].sum() == 0


@pytest.mark.parametrize("case", [c for cs in POINTLIST.values() for c in cs])
def test_port_plain_path_reproduces_pointlist_goldens(case):
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    gold = next(g for g, cs in POINTLIST.items() if case in cs)
    ref = _load(gold)
    cfg, env, sc = getattr(bench_cases, case)()
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
