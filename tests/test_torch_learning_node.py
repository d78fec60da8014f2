"""The port's learning node (``param_fix=False``) against the JAX node, on
the CPU: tests/test_runtime.py::test_online_learning_param_fix_false's
scenario (:149-221) through both nodes, one run through bank growth (a
two-slot bank and three objects: K 2 -> 4) and one through a resume from
the JAX node's checkpoint.

Per frame: every integer output exact, positions within 1e-5 m and
velocities within 1e-4 m/s (test_torch_golden.py's tolerances and
reasons).  Per update: the same updates at the same frames, the
log-parameters within ``TOL_LP`` and the mean NLL within ``TOL_NLL``.
Given the same windows the port's learning step is the JAX step's to the
last bit (tests/test_torch_learning.py); the windows differ by the
detections' last bits (up to 2.4e-7 m in these runs, 4.8e-7 m on the
published positions), which the finite differences divide by dt_gp = 0.1 s.
The updates carry that forward: up to 7.2e-6 on the log-parameters after
11 updates.  The NLL's terms are v^2 / (2 S) with S ~ 4.5e-3 (sigma2 =
exp(-5.5)), so a window's NLL moves by ~|v| dv / S: up to 1.6e-4 seen.
"""

import os
import sys

import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
from multiple_object_tracking_lidar_tpu.io.scenario import Scenario as JScenario
from multiple_object_tracking_lidar_tpu.io.scenario import ScenarioObject as JObject
from multiple_object_tracking_lidar_tpu.runtime import checkpoint as jckpt
from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode
from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
from multiple_object_tracking_lidar_tpu_torch.bench_cases import SIM_MAP, load_sim_grid
from multiple_object_tracking_lidar_tpu_torch.config import Capacities, TrackerConfig
from multiple_object_tracking_lidar_tpu_torch.io.scenario import Scenario, ScenarioObject
from multiple_object_tracking_lidar_tpu_torch.runtime import checkpoint as tckpt
from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import one_intra_op_thread  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TOL_POS, TOL_VEL = 1e-5, 1e-4
TOL_LP = 1e-5     # log-parameters after every update (absolute)
TOL_NLL = 5e-4    # mean NLL of every update (absolute)
N_FRAMES = 25
CAPS = dict(n_max_points=1024, m_max_voxels=512, m_max_dynamic=128, c_max_clusters=8,
            p_max_cluster=64, k_max_tracks=8)
LEARN = dict(voxel_leaf_size=0.1, data_length=6, param_fix=False, learn_period=0.2)
OBJECTS = [(0.0, 1.0, 0.0, 0.4), (-1.0, 3.0, 0.3, 0.0)]     # test_runtime.py:177
GROWTH_OBJECTS = OBJECTS + [(1.2, 0.6, -0.05, 0.0)]


def _nodes(k_max=8):
    caps = CAPS | {"k_max_tracks": k_max}
    jn = JNode(JConfig(caps=JCaps(**caps), **LEARN))
    tn = TrackerNode(TrackerConfig(caps=Capacities(**caps), **LEARN), device="cpu",
                     keep_outputs=True)
    return jn, tn


def _frames(objects, seed=9):
    jsc = JScenario(grid=load_map_yaml(SIM_MAP), objects=[JObject(*o) for o in objects],
                    static_points_per_frame=300, seed=seed)
    tsc = Scenario(grid=load_sim_grid(), objects=[ScenarioObject(*o) for o in objects],
                   static_points_per_frame=300, seed=seed)
    return jsc, tsc


def _drive(node, sc, ks, record):
    """Frames ``ks`` into ``node``; per frame the published (ids, pos, vel)
    and K, and the log-parameters after each update."""
    out = []
    for k in ks:
        n0 = len(node.nll_history)
        res = node.on_pointcloud(sc.frame(k))
        if len(node.nll_history) > n0:
            record.append((k, {a: np.array(v) for a, v in node.log_params.items()},
                           node.nll_history[-1][1]))
        obs = [] if res is None else res[0].obstacles
        out.append(([o.id for o in obs], np.asarray([o.position[:2] for o in obs]),
                    np.asarray([o.velocity[:2] for o in obs]), node.config.caps.k_max_tracks))
    return out


def _compare(jout, tout, jrec, trec):
    for k, (a, b) in enumerate(zip(jout, tout)):
        assert a[0] == b[0] and a[3] == b[3], k
        if a[0]:
            np.testing.assert_allclose(b[1], a[1], rtol=0, atol=TOL_POS, err_msg=str(k))
            np.testing.assert_allclose(b[2], a[2], rtol=0, atol=TOL_VEL, err_msg=str(k))
    assert [r[0] for r in trec] == [r[0] for r in jrec] and len(jrec) >= 3
    for (k, jl, jn), (_, tl, tn) in zip(jrec, trec):
        for ax in ("x", "y"):
            assert tl[ax].dtype == np.float32
            np.testing.assert_allclose(tl[ax], jl[ax], rtol=0, atol=TOL_LP, err_msg=f"{k} {ax}")
        np.testing.assert_allclose(tn, jn, rtol=0, atol=TOL_NLL, err_msg=str(k))


def test_learning_node_matches_jax_node():
    """test_runtime.py's scenario: 25 frames, an update every 0.2 s; the
    learned gains live in the step, sigma2 frozen."""
    jn, tn = _nodes()
    assert tn.learning
    jn.on_map(load_map_yaml(SIM_MAP))
    tn.on_map(load_sim_grid())
    jsc, tsc = _frames(OBJECTS)
    jrec, trec = [], []
    jout = _drive(jn, jsc, range(N_FRAMES), jrec)
    tout = _drive(tn, tsc, range(N_FRAMES), trec)
    _compare(jout, tout, jrec, trec)
    assert sum(bool(o[0]) for o in tout) >= 20 and tn.stats[-1].n_alive == 2
    assert tn.log_params["x"][0] == np.float32(tn.config.logSigma2_x)     # sigma2 frozen
    # the live gains are the learned ones, not the config's
    w_init = Tracker(tn.config, "cpu").gains_xy["W_vel"]["Wy"]
    assert not torch.allclose(tn._gains["W_vel"]["Wy"], w_init)
    assert tn._gains["W_vel"]["Wy"].dtype == torch.float32


def test_learning_node_grows_as_jax_node():
    """A two-slot bank and three objects: the first frame overflows and the
    bank grows to 4 slots, the gains derived anew from the learned
    log-parameters, as the JAX node does (node.py:268-276)."""
    jn, tn = _nodes(k_max=2)
    jn.on_map(load_map_yaml(SIM_MAP))
    tn.on_map(load_sim_grid())
    jsc, tsc = _frames(GROWTH_OBJECTS, seed=3)
    jrec, trec = [], []
    jout = _drive(jn, jsc, range(12), jrec)
    tout = _drive(tn, tsc, range(12), trec)
    assert tn.n_growths == jn.n_growths >= 1 and tout[-1][3] == 4
    _compare(jout, tout, jrec, trec)


def test_learning_node_resumes_as_jax_node(tmp_path):
    """The JAX node's checkpoint after 6 frames, resumed by a fresh node
    of each package: the next 8 frames and their updates match (the
    learned log-parameters are not checkpointed: both restart from the
    config's, JAX node.py:195-199)."""
    jn, _ = _nodes()
    jn.on_map(load_map_yaml(SIM_MAP))
    jsc, tsc = _frames(OBJECTS)
    _drive(jn, jsc, range(6), [])
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_state(path, jn.state, extra=jn.checkpoint_extra())
    jr, tr = _nodes()
    jr.on_map(load_map_yaml(SIM_MAP))
    tr.on_map(load_sim_grid())
    jr.resume(*jckpt.load_state(path))
    tr.resume(*tckpt.load_state(path, device="cpu"))
    jrec, trec = [], []
    jout = _drive(jr, jsc, range(6, 14), jrec)
    tout = _drive(tr, tsc, range(6, 14), trec)
    _compare(jout, tout, jrec, trec)
