"""The port's CLI (``runtime/cli.py``) against the JAX CLI, in-process on
the CPU (``--device cpu``), on tests/test_cli.py's tiny config.

Each config (the default point-list backend, ``--backend grid``, and a
config file with ``position_filter: ihgp``) is run once through the JAX
``main`` (module scope: the JAX step compiles at most three times), with
``--svg``, ``--record-bag`` and ``--checkpoint``.  The port's ``run`` must
give the same JSON lines: frames, ids, obstacle counts and speed labels
exactly, positions and velocities within 1e-4 m (m/s) plus the records'
4-decimal rounding (test_torch_golden.py's tolerances: the JAX step sums
the smoother in XLA's order).  Then: the port's SVG byte-identical to the
JAX SVG; the npz bags record the same frames; a replay of the port's own
recording (npz and ROS1 ``.bag``) prints the recording run's JSON lines
byte for byte; ``--checkpoint`` saves a state the JAX checkpoint matches
and resumes it (ids kept); ``info`` prints the JAX ``info``'s config JSON;
``tune`` prints the JAX ``tune``'s JSON lines (the step exactly, the NLL and
the log-parameters within 1e-4: 4-decimal roundings of values that agree
to ~1e-6); ``bench`` raises ``NotImplementedError``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from multiple_object_tracking_lidar_tpu.runtime.cli import main as jmain
from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_MAP = os.path.join(REPO, "assets", "sim_map.yaml")
TINY = (
    "voxel_leaf_size: 0.1\n"
    "data_length: 6\n"
    "caps:\n"
    "  n_max_points: 1024\n"
    "  m_max_voxels: 512\n"
    "  m_max_dynamic: 128\n"
    "  c_max_clusters: 8\n"
    "  p_max_cluster: 64\n"
    "  k_max_tracks: 8\n"
)
FRAMES, OBJECTS = 8, 2
TOL = 1e-4 + 1e-4       # the tolerance, plus two 4-decimal roundings of 0.5e-4
CONFIGS = {"default": ("", []), "grid": ("", ["--backend", "grid"]),
           "ihgp": ("position_filter: ihgp\n", [])}


def _call(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    assert rc == 0
    return out.getvalue(), err.getvalue()


def _records(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _same_tracks(got, ref):
    """Frames, ids, counts and labels exact; pos / vel within TOL."""
    g, r = _records(got), _records(ref)
    assert [x["frame"] for x in g] == [x["frame"] for x in r]
    for a, b in zip(g, r):
        assert a["t"] == b["t"] and a["speed_labels"] == b["speed_labels"], (a, b)
        assert [o["id"] for o in a["obstacles"]] == [o["id"] for o in b["obstacles"]], (a, b)
        for oa, ob in zip(a["obstacles"], b["obstacles"]):
            for key in ("pos", "vel"):
                np.testing.assert_allclose(oa[key], ob[key], rtol=0, atol=TOL,
                                           err_msg=f"frame {a['frame']} {key}")
    return g


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per config: the config file, the JAX run's (stdout, stderr) and the
    files it wrote (svg, npz bag, checkpoint)."""
    out = {}
    for name, (extra, flags) in CONFIGS.items():
        d = tmp_path_factory.mktemp(f"cli_{name}")
        cfg = d / "cfg.yaml"
        cfg.write_text(TINY + extra)
        files = {k: str(d / f"jax_{k}") for k in ("svg", "bag.npz", "ckpt.npz")}
        argv = ["run", "--map", SIM_MAP, "--config", str(cfg), "--frames", str(FRAMES),
                "--objects", str(OBJECTS), *flags, "--svg", files["svg"],
                "--record-bag", files["bag.npz"], "--checkpoint", files["ckpt.npz"]]
        out[name] = dict(dir=d, cfg=str(cfg), flags=flags, files=files,
                         jax=_call(jmain, argv))
    return out


def _port_run(r, *extra):
    return _call(tmain, ["run", "--device", "cpu", "--map", SIM_MAP, "--config", r["cfg"],
                         "--frames", str(FRAMES), "--objects", str(OBJECTS), *r["flags"],
                         *extra])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches_jax(runs, name):
    r = runs[name]
    svg = str(r["dir"] / "port.svg")
    out, err = _port_run(r, "--svg", svg)
    recs = _same_tracks(out, r["jax"][0])
    assert len(recs) >= FRAMES - 2 and all(len(x["obstacles"]) == OBJECTS for x in recs[2:])
    summary = [x for x in _records(err) if "summary" in x]
    assert summary and summary[0]["summary"]["frames"] == FRAMES
    assert {"svg": svg, "tracks": OBJECTS} in _records(err)


def test_svg_byte_identical_to_jax(runs):
    r = runs["default"]
    svg = str(r["dir"] / "port_svg.svg")
    _port_run(r, "--svg", svg)
    with open(svg, "rb") as a, open(r["files"]["svg"], "rb") as b:
        text = a.read()
        assert text == b.read()
    assert text.startswith(b"<svg") and b"polyline" in text


@pytest.mark.parametrize("ext", ["npz", "bag"])
def test_record_then_replay_is_byte_identical(runs, ext):
    r = runs["default"]
    bag = str(r["dir"] / f"port_rec.{ext}")
    rec_out, _ = _port_run(r, "--record-bag", bag)
    replay_out, _ = _port_run(r, "--bag", bag)
    assert replay_out == rec_out
    _same_tracks(rec_out, r["jax"][0])
    if ext == "npz":           # the same frames as the JAX recording
        with np.load(bag) as a, np.load(r["files"]["bag.npz"]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    else:                      # a ROS1 bag the JAX reader reads back
        from multiple_object_tracking_lidar_tpu.io.rosbag import read_rosbag

        assert len(list(read_rosbag(bag))) == FRAMES


def test_checkpoint_saves_and_resumes(runs):
    r = runs["default"]
    ck = str(r["dir"] / "port_ckpt.npz")
    _, err1 = _port_run(r, "--checkpoint", ck)
    assert {"checkpoint": ck} in _records(err1)
    with np.load(ck) as a, np.load(r["files"]["ckpt.npz"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out2, err2 = _port_run(r, "--checkpoint", ck)
    resumed = [x for x in _records(err2) if "resumed" in x]
    assert resumed == [{"resumed": ck, "alive": OBJECTS}]
    tracks = _records(out2)
    ids = {o["id"] for x in tracks for o in x["obstacles"]}
    assert ids == {0, 1} and len(tracks) >= FRAMES - 1     # publishes from its first frame
    # the port resumes the JAX package's checkpoint to the same records
    jck = str(r["dir"] / "jax_ckpt_copy.npz")
    with np.load(r["files"]["ckpt.npz"]) as z:
        np.savez(jck, **{k: z[k] for k in z.files})
    out3, _ = _port_run(r, "--checkpoint", jck)
    _same_tracks(out3, out2)


def test_info_prints_the_jax_config_json(runs):
    r = runs["ihgp"]
    t_out, t_err = _call(tmain, ["info", "--config", r["cfg"], "--data-length", "7"])
    j_out, _ = _call(jmain, ["info", "--config", r["cfg"], "--data-length", "7"])
    assert json.loads(t_out) == json.loads(j_out)
    assert json.loads(t_out)["position_filter"] == "ihgp"
    assert t_err.startswith("devices: ")


@pytest.mark.parametrize("cmd", [["tune", "--map", SIM_MAP], ["bench"]])
def test_tune_and_bench_raise(cmd, tmp_path):
    """``tune`` (ported: it raised before) matches the JAX CLI's on the
    tiny config, 20 frames and 6 steps; ``bench`` still raises, naming its
    ROADMAP item."""
    if cmd[0] == "bench":
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
            tmain(cmd)
        return
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(TINY)
    argv = [*cmd, "--config", str(cfg), "--frames", "20", "--steps", "6"]
    ref = _records(_call(jmain, argv)[0])
    got = _records(_call(tmain, [*argv, "--device", "cpu"])[0])
    assert [x["step"] for x in got] == [x["step"] for x in ref] == list(range(6))
    for a, b in zip(got, ref):
        for key in ("nll", "logMagnSigma2", "logLengthScale"):
            assert abs(a[key] - b[key]) <= 1e-4 + 1e-9, (a, b)
    assert ref[-1]["logMagnSigma2"] != ref[0]["logMagnSigma2"]
