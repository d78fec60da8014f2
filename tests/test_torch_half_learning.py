"""The learning mode (``param_fix=False``) and ``tune`` under bf16, bit for
bit against the JAX package on the CPU (tests/test_torch_half_learning_f16.py
runs the same checks under f16).

The JAX package's learning step is f32 under every compute dtype (its node
keeps the log-parameters in f32 and casts each window to f32; ``tune``
stacks its windows as f32), so the half work is the host's: the velocity
windows, which numpy computes in the compute dtype, and the gains,
``Tracker.compute_gains`` in f64 cast to the half dtype.  Given the same
windows the port's learning step is the JAX step's to the last bit
(tests/test_torch_learning.py), and the half detections are the JAX
package's bit for bit; so every check here is exact:

- (a) ``models/learning.py::velocity_windows`` against the ``y`` the JAX
  node's ``_maybe_learn`` and the JAX ``tune`` hand their learning step
  (captured by patching it), on banks of random half windows: random bit
  patterns over every exponent, equal neighbours, large magnitudes whose
  differences overflow, subnormal differences, a NaN row, dead rows; and
  on every finite half value as a difference.  Bits equal, NaN where the
  JAX windows hold NaN (numpy and torch give a NaN different payloads);
- F11: the port's ``tune`` under a half dtype printed nothing and raised
  ``TypeError`` (``Tensor.numpy()`` refuses bf16) where the JAX CLI
  prints its JSON lines; now it prints the JAX lines exactly;
- (b) tests/test_torch_learning_node.py's three scenarios (the test_runtime
  scenario, bank growth 2 -> 4, a resume from the JAX checkpoint) under the
  half dtype: every published id, position and velocity, the frame stats,
  the update frames, the log-parameters, the NLL and the final bank;
- (c) the goldens tests/golden/torch_{bf16,f16}_learning_headline.npz and
  torch_cli_{bf16,f16}_tune.json (scripts/make_torch_golden.py): their
  first frames, updates and records recomputed from the JAX package, and
  the port's CPU node and ``tune`` reproducing all of them.
"""

import contextlib
import io
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_golden import REPO, one_intra_op_thread  # noqa: E402, F401
from test_torch_learning_node import (  # noqa: E402
    CAPS, GROWTH_OBJECTS, LEARN, N_FRAMES, OBJECTS, _frames)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DTYPES = {"bf16": "bfloat16", "f16": "float16"}
TORCH = {"bf16": torch.bfloat16, "f16": torch.float16}
SIM_MAP = os.path.join(REPO, "assets", "sim_map.yaml")
TINY = ("voxel_leaf_size: 0.1\ndata_length: 6\ncaps:\n  n_max_points: 1024\n"
        "  m_max_voxels: 512\n  m_max_dynamic: 128\n  c_max_clusters: 8\n"
        "  p_max_cluster: 64\n  k_max_tracks: 8\n")   # tests/test_torch_cli.py's
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_{}_learning_headline.npz")
TUNE_GOLDEN = os.path.join(REPO, "tests", "golden", "torch_cli_{}_tune.json")
LEARN_FIELDS = ("update_frame", "log_params", "nll_history")


# -- (a) the velocity windows -------------------------------------------------
def _np_half(htag):
    import ml_dtypes

    return {"bf16": ml_dtypes.bfloat16, "f16": np.float16}[htag]


def _to_torch(w, htag):
    """A numpy half array (ml_dtypes' bf16 or f16) as a torch tensor, its bits."""
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int16)).view(TORCH[htag])


def random_banks(htag, seed, k=256, length=40):
    """(window (k, length, 4) in the half dtype, alive (k,)): rows of random
    bit patterns (every exponent, finite), smooth tracks, equal neighbours,
    large magnitudes whose differences overflow, subnormal differences, a
    NaN row and dead rows."""
    hd = _np_half(htag)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 16, size=(k, length, 4), dtype=np.uint16)
    w = bits.view(hd).copy()
    w[~np.isfinite(w.astype(np.float32))] = hd(1.5)
    top = 65504.0 if htag == "f16" else 3.0e38
    tiny = 2.0 ** -24 if htag == "f16" else 2.0 ** -133     # the least subnormal
    smooth = rng.normal(size=(k // 4, 1, 4)) * 5.0 + np.cumsum(
        rng.normal(size=(k // 4, length, 4)) * 0.04, axis=1)
    w[: k // 4] = smooth.astype(hd)
    w[k // 4: k // 2] = w[k // 4: k // 2].astype(np.float32).round(0).astype(hd)
    w[10, 5:9] = w[10, 4]                                       # equal neighbours
    w[11, ::2] = hd(top * 0.75)                                  # overflowing differences
    w[11, 1::2] = hd(-top * 0.75)
    w[12] = (rng.integers(-6, 7, size=(length, 4)) * tiny).astype(hd)   # subnormal steps
    w[13, length // 2, :] = np.nan                               # a NaN row
    alive = rng.random(k) < 0.8
    alive[10:14] = True
    return w, alive


def every_half_difference(htag):
    """(window, alive): one row [0, d, d] per finite half value d (each d is
    a difference, its quotient and the centring of [d / dt, 0])."""
    hd = _np_half(htag)
    d = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(hd)
    d = d[np.isfinite(d.astype(np.float32))]
    w = np.zeros((len(d), 3, 4), hd)
    w[:, 1, :2] = d[:, None]
    w[:, 2, :2] = d[:, None]
    w[:, 1, 2:] = -d[:, None]
    return w, np.ones(len(d), bool)


def assert_same_windows(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    bad = (got.view(np.uint32) != ref.view(np.uint32)) & ~nan
    assert not bad.any(), (what, int(bad.sum()), got[bad][:4], ref[bad][:4])


def _jax_node(htag, caps=CAPS):
    from multiple_object_tracking_lidar_tpu.config import Capacities as JCaps
    from multiple_object_tracking_lidar_tpu.config import TrackerConfig as JConfig
    from multiple_object_tracking_lidar_tpu.runtime.node import TrackerNode as JNode

    return JNode(JConfig(caps=JCaps(**caps), dtype=DTYPES[htag], **LEARN))


def _port_node(htag, caps=CAPS):
    from multiple_object_tracking_lidar_tpu_torch.config import Capacities, TrackerConfig
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    return TrackerNode(TrackerConfig(caps=Capacities(**caps), dtype=DTYPES[htag], **LEARN),
                       device="cpu", keep_outputs=True)


def jax_node_windows(htag, w, alive):
    """The (x, y) windows the JAX node's ``_maybe_learn`` hands its learning
    step for a bank of ``w`` and ``alive``."""
    import jax.numpy as jnp

    from multiple_object_tracking_lidar_tpu.models import learning as jlearning

    node = _jax_node(htag)
    node.state = node.state._replace(bank=node.state.bank._replace(
        window=jnp.asarray(w), alive=jnp.asarray(alive)))
    seen = []

    def capture(lp, y, mask, dt):
        seen.append(np.asarray(y))
        return lp, jnp.float32(0.0)

    orig = jlearning.learning_step
    jlearning.learning_step = capture
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            node._maybe_learn(0.0)
    finally:
        jlearning.learning_step = orig
    assert len(seen) == 2 and all(y.dtype == np.float32 for y in seen)
    return seen


def port_node_windows(htag, w, alive):
    """The (2, B, L - 1) windows the port node's ``_maybe_learn`` hands K13's
    entry for the same bank."""
    from multiple_object_tracking_lidar_tpu_torch.runtime import node as node_mod

    node = _port_node(htag)
    bank = node.state.bank._replace(window=_to_torch(w, htag),
                                    alive=torch.from_numpy(alive))
    node.state = node.state._replace(bank=bank)
    seen = []

    def capture(lp, y, mask, dt, *a):
        seen.append(y.clone())
        return lp.clone(), torch.zeros(2)

    orig = node_mod.learning_step_stacked
    node_mod.learning_step_stacked = capture
    try:
        node._maybe_learn(0.0)
    finally:
        node_mod.learning_step_stacked = orig
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    return seen[0].numpy()


def check_node_windows(htag):
    from multiple_object_tracking_lidar_tpu_torch.models.learning import velocity_windows

    dt = 0.1
    for what, (w, alive) in (("random banks", random_banks(htag, 2201)),
                             ("every half difference", every_half_difference(htag))):
        ref = jax_node_windows(htag, w, alive)
        t = _to_torch(w, htag)[torch.from_numpy(alive)]
        for col in (0, 1):
            assert_same_windows(velocity_windows(t[..., col], dt), ref[col], f"{what} col {col}")
        got = port_node_windows(htag, w, alive)
        for col in (0, 1):
            assert_same_windows(got[col], ref[col], f"{what}: the port node's col {col}")
    # other periods: the quotient's rounding of dt
    w, alive = random_banks(htag, 2202, k=64)
    t = _to_torch(w, htag)[torch.from_numpy(alive)][..., 0]
    for dt in (1.0 / 30.0, 0.05, 0.25):
        wf = w[alive][..., 0]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            v = (wf[:, 1:] - wf[:, :-1]) / dt
            ref = (v - v.mean(axis=1, keepdims=True)).astype(np.float32)
        assert_same_windows(velocity_windows(t, dt), ref, f"dt={dt}")


def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert main(argv) == 0
    return [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]


def check_tune_windows(htag, tmp_path):
    """The windows each ``tune`` hands its learning step, the banks
    replaced by ``random_banks`` after every frame (the trackers do not
    run): the port's bit for bit the JAX CLI's."""
    import jax.numpy as jnp

    from multiple_object_tracking_lidar_tpu.models import learning as jlearning
    from multiple_object_tracking_lidar_tpu.runtime import node as jnode_mod
    from multiple_object_tracking_lidar_tpu.runtime.cli import main as jmain
    from multiple_object_tracking_lidar_tpu_torch.models import learning as tlearning
    from multiple_object_tracking_lidar_tpu_torch.runtime import node as tnode_mod
    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as tmain

    banks = [random_banks(htag, 2210 + k, k=32, length=6) for k in range(3)]
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(TINY + f"dtype: {DTYPES[htag]}\n")
    argv = ["tune", "--map", SIM_MAP, "--config", str(cfg), "--frames", "3", "--steps", "1"]
    seen = {}

    def j_frame(self, msg):
        w, alive = banks[self._k]
        self._k += 1
        self.state = self.state._replace(bank=self.state.bank._replace(
            window=jnp.asarray(w), alive=jnp.asarray(alive)))

    def t_frame(self, msg):
        w, alive = banks[self._k]
        self._k += 1
        self.state = self.state._replace(bank=self.state.bank._replace(
            window=_to_torch(w, htag), alive=torch.from_numpy(alive)))

    def j_step(lp, y, mask, dt):
        seen["jax"] = np.asarray(y)
        return lp, jnp.float32(0.0)

    def t_step(lp, y, mask, dt):
        seen["port"] = y.numpy().copy()
        return lp, torch.zeros(())

    patches = [(jnode_mod.TrackerNode, "on_pointcloud", j_frame),
               (jnode_mod.TrackerNode, "_k", 0), (jlearning, "learning_step", j_step),
               (tnode_mod.TrackerNode, "on_pointcloud", t_frame),
               (tnode_mod.TrackerNode, "_k", 0), (tlearning, "learning_step", t_step)]
    saved = [(obj, name, getattr(obj, name, None)) for obj, name, _ in patches]
    try:
        for obj, name, val in patches:
            setattr(obj, name, val)
        ref = _run_cli(jmain, argv)
        got = _run_cli(tmain, [*argv, "--device", "cpu"])
    finally:
        for obj, name, val in saved:
            if val is None:
                delattr(obj, name)
            else:
                setattr(obj, name, val)
    assert seen["jax"].shape == (sum(int(a.sum()) for _, a in banks), 5)
    assert_same_windows(seen["port"], seen["jax"], "tune's windows")
    assert len(got) == len(ref) == 1


def check_f11(htag, tmp_path):
    """F11: the port's ``tune`` under a half dtype raised ``TypeError`` at
    its window copy (``Tensor.numpy()`` refuses bf16) where the JAX CLI
    prints its lines; now it prints the JAX CLI's lines exactly, at the
    tiny config, 20 frames and 4 steps."""
    from multiple_object_tracking_lidar_tpu.runtime.cli import main as jmain
    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as tmain

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(TINY + f"dtype: {DTYPES[htag]}\n")
    argv = ["tune", "--map", SIM_MAP, "--config", str(cfg), "--frames", "20", "--steps", "4"]
    ref = _run_cli(jmain, argv)
    assert [r["step"] for r in ref] == [0, 1, 2, 3]
    assert _run_cli(tmain, [*argv, "--device", "cpu"]) == ref


# -- (b) the learning node's scenarios ---------------------------------------
def _drive_exact(node, sc, ks, record):
    """Frames ``ks`` into ``node``: per frame the published (ids, positions,
    velocities), the frame's stats and K; per update (frame, log-params, NLL)."""
    out = []
    for k in ks:
        n0 = len(node.nll_history)
        res = node.on_pointcloud(sc.frame(k))
        if len(node.nll_history) > n0:
            record.append((k, np.stack([node.log_params["x"], node.log_params["y"]]),
                           node.nll_history[-1]))
        obs = [] if res is None else res[0].obstacles
        s = node.stats[-1]
        out.append(([o.id for o in obs], [list(o.position) for o in obs],
                     [list(o.velocity) for o in obs],
                     (s.n_points, s.n_voxels, s.n_dynamic, s.n_clusters, s.n_alive, s.overflow),
                     node.config.caps.k_max_tracks))
    return out


def _same_runs(jout, tout, jrec, trec, jnode, tnode):
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import host_numpy

    assert tout == jout
    assert [r[0] for r in trec] == [r[0] for r in jrec] and len(jrec) >= 3
    for (k, jl, jn), (_, tl, tn) in zip(jrec, trec):
        assert tl.dtype == np.float32
        np.testing.assert_array_equal(tl, jl, err_msg=str(k))
        assert tn == jn, k
    for f in ("window", "alive", "obj_id", "m0"):
        np.testing.assert_array_equal(host_numpy(getattr(tnode.state.bank, f)),
                                      np.asarray(getattr(jnode.state.bank, f)).astype(
                                          host_numpy(getattr(tnode.state.bank, f)).dtype),
                                      err_msg=f)


def check_scenario(htag, scenario, tmp_path):
    from multiple_object_tracking_lidar_tpu.runtime import checkpoint as jckpt
    from multiple_object_tracking_lidar_tpu.utils.pgm import load_map_yaml
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime import checkpoint as tckpt

    caps = CAPS | ({"k_max_tracks": 2} if scenario == "growth" else {})
    jn, tn = _jax_node(htag, caps), _port_node(htag, caps)
    jn.on_map(load_map_yaml(SIM_MAP))
    tn.on_map(load_sim_grid())
    if scenario == "growth":
        jsc, tsc = _frames(GROWTH_OBJECTS, seed=3)
        ks = range(12)
    else:
        jsc, tsc = _frames(OBJECTS)
        ks = range(N_FRAMES)
    if scenario == "resume":
        first = _jax_node(htag)
        first.on_map(load_map_yaml(SIM_MAP))
        _drive_exact(first, jsc, range(6), [])
        path = str(tmp_path / "ckpt.npz")
        jckpt.save_state(path, first.state, extra=first.checkpoint_extra())
        if htag == "bf16":
            # the JAX load_state refuses its own bf16 file (numpy reads
            # ml_dtypes' bf16 back as |V2 voids): the JAX node resumes the
            # state the file holds, the port node the file itself
            jn.resume(first.state, {"time_init": first.time_init})
            with pytest.raises(TypeError, match="V2"):
                jckpt.load_state(path)
        else:
            jn.resume(*jckpt.load_state(path))
        tn.resume(*tckpt.load_state(path, device="cpu"))
        assert tn.state.bank.window.dtype == TORCH[htag]
        ks = range(6, 14)
    jrec, trec = [], []
    jout = _drive_exact(jn, jsc, ks, jrec)
    tout = _drive_exact(tn, tsc, ks, trec)
    _same_runs(jout, tout, jrec, trec, jn, tn)
    assert tn._gains["W_vel"]["Wy"].dtype == TORCH[htag]
    if scenario == "growth":
        assert tn.n_growths == jn.n_growths >= 1 and tout[-1][-1] == 4
    else:
        assert sum(bool(o[0]) for o in tout) >= len(ks) - 5


# -- (c) the goldens -----------------------------------------------------------
def _frames_part(d):
    return {f: v for f, v in d.items() if f not in LEARN_FIELDS}


def check_golden_recomputes(htag):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = dict(np.load(GOLDEN.format(htag)))
    out = golden_outputs(n_frames=3, case=f"{htag}_learning")
    assert set(out) == set(ref) and ref["publish"].shape == (16,)
    for f, v in _frames_part(out).items():
        np.testing.assert_array_equal(v, ref[f][:3], err_msg=f)
    np.testing.assert_array_equal(out["update_frame"], [0, 2])
    n = len(out["update_frame"])
    np.testing.assert_array_equal(ref["update_frame"][:n], out["update_frame"])
    np.testing.assert_array_equal(out["log_params"], ref["log_params"][:n])
    np.testing.assert_array_equal(out["nll_history"], ref["nll_history"][:n])
    assert len(ref["update_frame"]) >= 6 and ref["log_params"].dtype == np.float32


def check_port_reproduces_golden(htag):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    ref = dict(np.load(GOLDEN.format(htag)))
    cfg, _, sc = headline_case()
    node = TrackerNode(cfg.replace(param_fix=False, learn_period=0.2, dtype=DTYPES[htag]),
                       device="cpu", keep_outputs=True)
    node.on_map(load_sim_grid())
    frames, lps = [], []
    for k in range(ref["publish"].shape[0]):
        n0 = len(node.nll_history)
        node.on_pointcloud(sc.frame(k))
        if len(node.nll_history) > n0:
            frames.append(k)
            lps.append(np.stack([node.log_params["x"], node.log_params["y"]]))
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
    for f, v in _frames_part(ref).items():
        np.testing.assert_array_equal(got[f], v, err_msg=f)
    np.testing.assert_array_equal(frames, ref["update_frame"])
    np.testing.assert_array_equal(np.asarray(lps), ref["log_params"])
    np.testing.assert_array_equal(np.asarray(node.nll_history), ref["nll_history"])


def _tune_argv(golden, tmp_path):
    """A golden's argv with its ``<config text>`` written to a file."""
    argv = list(golden["argv"])
    cfg = tmp_path / "config.yaml"
    cfg.write_text(argv[-1][1:-1] + "\n")
    argv[-1] = str(cfg)
    return [os.path.join(REPO, a) if a.endswith("sim_map.yaml") else a for a in argv]


def _tune_golden(htag):
    with open(TUNE_GOLDEN.format(htag), encoding="utf-8") as fh:
        return json.load(fh)


def check_tune_golden_recomputes(htag):
    """The tune golden's first record recomputed by the JAX CLI."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import TUNE_ARGV, tune_outputs

    ref = _tune_golden(htag)
    assert ref["argv"] == TUNE_ARGV + ["--config", f"<dtype: {DTYPES[htag]}>"]
    assert [r["step"] for r in ref["records"]] == list(range(30))
    assert tune_outputs(steps=1, case=f"cli_{htag}_tune")["records"] == ref["records"][:1]


def check_port_tune_reproduces(htag, tmp_path):
    """The port's ``tune`` at the golden's arguments prints every record
    exactly."""
    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as tmain

    ref = _tune_golden(htag)
    got = _run_cli(tmain, [*_tune_argv(ref, tmp_path), "--device", "cpu"])
    assert got == ref["records"]


# -- the tests (bf16) ----------------------------------------------------------
HTAG = "bf16"


def test_velocity_windows_are_the_jax_node_windows():
    check_node_windows(HTAG)


def test_velocity_windows_are_the_jax_tune_windows(tmp_path):
    check_tune_windows(HTAG, tmp_path)


def test_f11_tune_under_a_half_dtype_prints_the_jax_lines(tmp_path):
    check_f11(HTAG, tmp_path)


@pytest.mark.parametrize("scenario", ["runtime", "growth", "resume"])
def test_half_learning_node_is_the_jax_node(scenario, tmp_path):
    check_scenario(HTAG, scenario, tmp_path)


def test_half_learning_golden_is_what_the_jax_package_computes():
    check_golden_recomputes(HTAG)


def test_port_node_reproduces_half_learning_golden():
    check_port_reproduces_golden(HTAG)


def test_half_tune_golden_is_what_the_jax_cli_prints():
    check_tune_golden_recomputes(HTAG)


def test_port_tune_reproduces_half_tune_golden(tmp_path):
    check_port_tune_reproduces(HTAG, tmp_path)
