"""The half Hungarian and half fleet goldens (``association="hungarian"``
on the headline, 12 frames, and on ``bench.dense_case``'s dense scene, 8
frames; the fleet B = 8 streams x 3 steps, the JAX vmap fleet; written by
scripts/make_torch_golden.py under ``dtype`` bf16 / f16), which the GPU
machine holds the port's half builds against (chip_smoke.py
``phase_hungarian_half``):

1. the JAX package still produces them: the first 2 frames of the headline
   and the dense scene and the fleet's first step recomputed, bit for bit;
2. the port's plain path on the CPU reproduces the headline's first 4
   frames and the dense scene's first 2 through ``bind_env`` (every field
   bit for bit, ``assoc_saturated`` among them: bf16 saturates two of the
   four eps phases on every headline frame) and the fleet's first 2 steps
   through ``ShardedTracker`` on a one-rank gloo mesh.

The checks run on bf16 here and on f16 in
tests/test_torch_golden_half_hungarian_f16.py, so that ``--dist loadfile``
puts them on two workers.
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
PORT_FRAMES = {"hungarian": 4, "dense_hungarian": 2, "fleet": 2}


class _Row:
    """A golden frame's fields as attributes (``_check_outputs`` reads them)."""

    def __init__(self, fields: dict, k):
        self._fields = tuple(fields)
        for f, v in fields.items():
            setattr(self, f, v[k])


def check_jax_recomputes(htag, case):
    import warnings

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS, golden_outputs, n_frames_of

    key = f"{htag}_{case}"
    ref = dict(np.load(GOLDENS[key]))
    n = 1 if case == "fleet" else 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)     # f16's -inf _NEG cast
        out = golden_outputs(n_frames=n, case=key)
    assert set(out) == set(ref) and ref["publish"].shape[0] == n_frames_of(key)
    assert ref["pos"].dtype == np.float32 and int(ref["valid"].sum()) >= 3
    for f, r in ref.items():
        np.testing.assert_array_equal(out[f], r[:n], err_msg=f"{key} {f}")


def check_port_reproduces(htag, case):
    import bench
    from make_torch_golden import GOLDENS, HALF_DTYPES, _frame

    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    key = f"{htag}_{case}"
    ref = dict(np.load(GOLDENS[key]))
    dtype = HALF_DTYPES[htag]
    n = PORT_FRAMES[case]
    if case == "fleet":
        from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

        cfg, env, _ = bench_cases.headline_case()
        sc = bench.headline_case()[2]
        cfg = cfg.replace(dtype=dtype)
        fleet = ShardedTracker(Tracker(cfg, device="cpu"), make_mesh(1, 1, device="cpu"))
        step, state = fleet.bind_env(env), fleet.init_state(8)
        for k in range(n):
            fr = [_frame(sc, 3 * s + k, cfg.caps.n_max_points) for s in range(8)]
            state, o = step(state, *(torch.from_numpy(np.stack([f[i] for f in fr]))
                                     for i in range(3)))
            for s in range(8):
                _check_outputs(f"{key} step {k} stream {s}", type(o)(*(f[s] for f in o)),
                               _Row(ref, (k, s)))
        return
    make = bench_cases.dense_case if case == "dense_hungarian" else bench_cases.headline_case
    cfg, env, _ = make()
    sc = (bench.dense_case() if case == "dense_hungarian" else bench.headline_case())[2]
    cfg = cfg.replace(dtype=dtype, association="hungarian")
    tracker = Tracker(cfg, device="cpu")
    step, st = tracker.bind_env(env), tracker.init_state()
    for k in range(n):
        buf, mask, t = _frame(sc, k, cfg.caps.n_max_points)
        st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
        _check_outputs(f"{key} frame {k}", o, _Row(ref, k))


CASES = ("hungarian", "dense_hungarian", "fleet")


@pytest.mark.parametrize("case", CASES)
def test_half_hungarian_goldens_are_what_the_jax_package_computes(case):
    check_jax_recomputes("bf16", case)


@pytest.mark.parametrize("case", CASES)
def test_port_plain_path_reproduces_half_hungarian_goldens(case):
    check_port_reproduces("bf16", case)
