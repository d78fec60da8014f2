"""The fleet and growth goldens (tests/golden/torch_{fleet,growth}_headline.npz):

- the fleet golden (the JAX kernel fleet, 8 streams x 3 steps): step 0 of
  streams 0-1 recomputed; the port's kernel fleet reproduces streams 0-1
  over all 3 steps;
- the growth golden (the JAX TrackerNode with a two-slot bank, which it
  grows): its first 2 frames recomputed; the port's TrackerNode reproduces
  all 12 frames, growths and K exact;

with tests/test_torch_golden.py's tolerances and ``_compare``.  Kept in a
file of its own so that ``--dist loadfile`` puts it on its own worker.
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


def test_fleet_golden_is_what_the_jax_package_computes():
    """The fleet golden (the JAX kernel fleet, B = 8 streams x 3 steps):
    step 0 of streams 0-1 recomputed here (B = 2)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import FLEET_STREAMS, golden_outputs, n_frames_of

    ref = _load("fleet")
    out = golden_outputs(n_frames=1, case="fleet", n_streams=2)
    assert set(out) == set(ref)
    assert ref["publish"].shape == (n_frames_of("fleet"), FLEET_STREAMS)
    assert ref["raw_centroid"].shape == (3, 8, 32, 4)
    _compare({f: v[0] for f, v in out.items()}, {f: v[0, :2] for f, v in ref.items()},
             1e-6, 1e-6)
    assert ref["valid"][1:].sum(axis=2).min() == 3 and ref["cc_saturated"].sum() == 0


def test_port_plain_fleet_reproduces_fleet_golden():
    """The port's kernel fleet on a 1 x 1 gloo mesh, plain versions on the
    CPU, streams 0-1 over the golden's 3 steps."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

    ref = _load("fleet")
    cfg, env, sc = headline_case()
    fleet = ShardedTracker(Tracker(cfg, device="cpu"), make_mesh(1, 1, device="cpu"),
                           kernel_path="on")
    step = fleet.bind_env(env)
    state = fleet.init_state(2)
    for k in range(ref["publish"].shape[0]):
        frames = [padded_frame(sc, 3 * s + k, cfg.caps.n_max_points) for s in range(2)]
        state, out = step(state, *(torch.from_numpy(np.stack([f[i] for f in frames]))
                                   for i in range(3)))
        _compare({f: getattr(out, f).numpy() for f in out._fields},
                 {f: v[k, :2] for f, v in ref.items()}, TOL_DETS, TOL_VEL)


def test_growth_golden_is_what_the_jax_package_computes():
    """The growth golden (the JAX TrackerNode, k_max_tracks=2, on the 12
    headline PointCloud2 frames): its first 2 frames recomputed, the
    growth on frame 0 included."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = _load("growth")
    out = golden_outputs(n_frames=2, case="growth")
    assert set(out) == set(ref) and ref["publish"].shape == (12,)
    _compare(out, ref, 1e-6, 1e-6, n=2)
    assert ref["overflow"][0] > 0 and ref["n_growths"][-1] >= 1
    assert ref["k_max_tracks"][-1] == 2 * 2 ** int(ref["n_growths"][-1])


def test_port_node_reproduces_growth_golden():
    """The port's TrackerNode on the CPU grows as the JAX node did and
    reproduces its 12 frames with the tolerances above."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import growth_case, load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    ref = _load("growth")
    cfg, _, sc = growth_case()
    node = TrackerNode(cfg, device="cpu", keep_outputs=True)
    node.on_map(load_sim_grid())
    growths, ks = [], []
    for k in range(ref["publish"].shape[0]):
        node.on_pointcloud(sc.frame(k))
        growths.append(node.n_growths)
        ks.append(node.config.caps.k_max_tracks)
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
    got |= {"n_growths": np.asarray(growths), "k_max_tracks": np.asarray(ks)}
    _compare(got, ref, TOL_DETS, TOL_VEL)
