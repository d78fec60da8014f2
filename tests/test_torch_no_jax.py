"""The port imports and runs where JAX is absent (the GPU machine has no
JAX): a fresh interpreter with ``jax`` and the JAX package blocked imports
every module of the port (``parallel/*``, ``runtime/fleet.py`` and
``runtime/stream.py`` among them), and ``chip_smoke.py``, steps 2 frames on
the CPU, one frame each in exact mode and runs mode, one frame of each
point-list configuration (C-G), one kernel-fleet step of two streams and
one TrackerNode frame that overflows a two-slot bank and grows it, on
small caps; then the CLI (``runtime/cli.py``: ``run --device cpu`` under
``position_filter: ihgp`` with ``--record-bag`` to a ROS1 bag and ``--svg``,
the bag replayed, ``info``), ``bind_env_pipelined`` and the profiler's
``device_trace``."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    for blocked in ("jax", "jaxlib", "multiple_object_tracking_lidar_tpu"):
        sys.modules[blocked] = None          # any import of them raises
    sys.path.insert(0, REPO)
    import dataclasses
    import numpy as np
    import torch
    import multiple_object_tracking_lidar_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (its import needs no JAX either)
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame
    cfg, env, sc = headline_case()
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, n_max_points=4096,
                                               c_max_clusters=8, p_max_cluster=64, k_max_tracks=8))
    tr = Tracker(cfg, device="cpu")
    step = tr.bind_env(env)
    st = tr.init_state()
    for k in range(2):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:40], pts[95200:99700:3]])
        buf = np.zeros((4096, 3), np.float32); buf[:len(sub)] = sub
        mask = np.zeros(4096, bool); mask[:len(sub)] = True
        st, out = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
    assert int(out.n_clusters) >= 3 and bool(out.publish), out
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import exact_case, runs_case
    for case in (exact_case, runs_case):        # K5 and K7 plain on one frame
        c = case()[0].replace(caps=cfg.caps)
        o = Tracker(c, device="cpu").bind_env(env)(Tracker(c, device="cpu").init_state(), Frame(
            torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))[1]
        assert int(o.n_clusters) >= 3, (case.__name__, o)
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    small = dict(n_max_points=4096, m_max_voxels=1024, m_max_dynamic=256,
                 c_max_clusters=8, p_max_cluster=64, k_max_tracks=8)
    for name in ("pointlist_case", "pointlist_jnp_case", "scan_case",
                 "pointlist_runs_case", "default_case"):
        c = getattr(bench_cases, name)()[0]
        c = c.replace(caps=dataclasses.replace(c.caps, **small))
        o = Tracker(c, device="cpu").bind_env(env)(Tracker(c, device="cpu").init_state(), Frame(
            torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))[1]
        assert int(o.n_clusters) >= 3, (name, o)
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    st = ShardedTracker(Tracker(cfg, device="cpu"), make_mesh(1, 1, device="cpu"))
    pb, mb = (torch.from_numpy(np.stack([a, a])) for a in (buf, mask))
    _, fo = st.bind_env(env)(st.init_state(2), pb, mb, torch.tensor([t, t]))
    assert st._use_kernel_fleet and int(fo.n_clusters.min()) >= 3, fo
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import make_pointcloud2
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode
    node = TrackerNode(cfg.replace(caps=dataclasses.replace(cfg.caps, k_max_tracks=2)), "cpu")
    node.on_map(load_sim_grid())
    node.on_pointcloud(make_pointcloud2(sub, stamp=float(t)))    # 3 clusters, 2 slots
    assert node.n_growths == 1 and node.config.caps.k_max_tracks == 4, node.stats
    import contextlib, io, json, os, tempfile
    from multiple_object_tracking_lidar_tpu_torch.runtime.cli import main
    from multiple_object_tracking_lidar_tpu_torch.runtime.profiler import device_trace
    tmp = tempfile.mkdtemp()
    with open(os.path.join(tmp, "cfg.yaml"), "w") as fh:
        fh.write("voxel_leaf_size: 0.1\\ndata_length: 6\\nposition_filter: ihgp\\ncaps:\\n"
                 "  n_max_points: 1024\\n  m_max_voxels: 512\\n  m_max_dynamic: 128\\n"
                 "  c_max_clusters: 8\\n  p_max_cluster: 64\\n  k_max_tracks: 8\\n")
    runs = []
    for flag in ("--record-bag", "--bag"):
        text = io.StringIO()
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
            assert main(["run", "--device", "cpu", "--map", os.path.join(REPO, "assets", "sim_map.yaml"),
                         "--config", os.path.join(tmp, "cfg.yaml"), "--frames", "4",
                         flag, os.path.join(tmp, "f.bag"), "--svg", os.path.join(tmp, "t.svg")]) == 0
        runs.append(text.getvalue())
    assert runs[0] == runs[1] and json.loads(runs[0].splitlines()[-1])["obstacles"], runs
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert main(["info"]) == 0
    pipe = Tracker(cfg, device="cpu").bind_env_pipelined(env)
    with device_trace(os.path.join(tmp, "trace")) as prof:
        _, po = pipe(Tracker(cfg, device="cpu").init_state(), Frame(*(x[None] for x in (
            torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))))
    assert int(po.n_clusters[0]) >= 3 and os.path.exists(prof.trace_path)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("NO_JAX_OK", len(names), int(out.valid.sum()))
    """
)


def test_port_runs_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", f"REPO = {REPO!r}\n" + SCRIPT],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "NO_JAX_OK" in res.stdout
    n_modules = int(res.stdout.split("NO_JAX_OK")[1].split()[0])
    assert n_modules >= 20


def test_no_jax_import_in_port_sources():
    pkg = os.path.join(REPO, "multiple_object_tracking_lidar_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                s = line.strip()
                assert not (s.startswith(("import jax", "from jax"))), (path, s)
                assert "import multiple_object_tracking_lidar_tpu " not in s + " ", (path, s)
                assert not s.startswith("from multiple_object_tracking_lidar_tpu."), (path, s)
                assert not s.startswith("from multiple_object_tracking_lidar_tpu import"), (path, s)
