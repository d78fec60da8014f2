"""The committed golden outputs of the JAX package on the headline scene
(tests/golden/torch_*_headline.npz, written by scripts/make_torch_golden.py),
which the GPU machine -- it has no JAX -- holds the port against: the
dense-grid slice, exact and runs modes, and the point-list configurations C
(dense + pallas), E (scan + jnp), F (runs + pallas) and G (the JAX
package's ``TrackerConfig()``).  Configuration D (dense + jnp) shares C's
golden.

1. The JAX package still produces them: its first 2 frames are recomputed
   here.  Integers exact; floats within 1e-6, because XLA's CPU code
   generation (FMA contraction) may vary with the host CPU and with the x64
   flag the test session sets.
2. The port's plain path on the CPU reproduces all 12 frames: integers
   exact, detections and positions within 1e-5 m, velocities within
   1e-4 m/s (see test_torch_pipeline.py for the reasons); pos / vel
   compared where ``valid``.  Exact mode's K6 route (unpadded
   100,000-point frames, bf16x3 sums instead of the digits) is held to the
   exact golden with the same tolerances.
3. The fleet golden (the JAX kernel fleet, 8 streams x 3 steps): step 0 of
   streams 0-1 recomputed; the port's kernel fleet reproduces streams 0-1
   over all 3 steps with the tolerances of 2.
4. The growth golden (the JAX TrackerNode with a two-slot bank, which it
   grows): its first 2 frames recomputed; the port's TrackerNode
   reproduces all 12 frames, growths and K exact, with the tolerances
   of 2.
5. The ``ihgp`` golden (the headline config with ``position_filter=
   "ihgp"``): as 1 and 2.
6. The Hungarian goldens (``association="hungarian"`` on the headline,
   12 frames, and on the dense scene of ``bench.dense_case``, 8 frames):
   as 1 and 2.
7. The CLI goldens (the JAX CLI's JSON lines for ``run --backend grid``
   on 16 headline frames from an npz bag, under ``lpf``, ``ihgp`` and
   ``association: hungarian``):
   the JAX CLI still prints the first 3 frames' records, and the port's
   CLI on the CPU (``--device cpu``) reproduces all 16 within
   ``chip_smoke.cli_errors``' tolerances (frames, ids and labels exact,
   pos / vel within 1e-4 plus the 4-decimal rounding).
The f64 goldens are held in tests/test_torch_golden_f64.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_slice_headline.npz")
TOL_DETS, TOL_VEL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def _compare(got: dict, ref: dict, tol_dets, tol_vel, n=None):
    v = ref["valid"][:n]
    for f, r in ref.items():
        r, g = r[:n], np.asarray(got[f])[:n]
        if f in ("pos", "vel"):
            np.testing.assert_allclose(g[v], r[v], rtol=0, atol=tol_vel if f == "vel" else tol_dets,
                                       err_msg=f)
        elif f == "raw_centroid":
            np.testing.assert_allclose(g, r, rtol=0, atol=tol_dets, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def test_golden_file_is_what_the_jax_package_computes(golden):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    out = golden_outputs(n_frames=2)
    assert set(out) == set(golden)
    assert golden["publish"].shape == (12,) and golden["raw_centroid"].shape == (12, 32, 4)
    _compare(out, golden, 1e-6, 1e-6, n=2)


def test_port_plain_path_reproduces_golden(golden):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case, padded_frame
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cfg, env, sc = headline_case()
    tracker = Tracker(cfg, device="cpu")
    step = tracker.bind_env(env)
    st = tracker.init_state()
    rows = []
    for k in range(golden["publish"].shape[0]):
        pts, mask, t = padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
        rows.append(out)
    got = {f: np.stack([getattr(r, f).numpy() for r in rows]) for f in rows[0]._fields}
    _compare(got, golden, TOL_DETS, TOL_VEL)
    assert golden["valid"][1:].sum(axis=1).min() == 3          # three tracked objects
    assert golden["overflow"].sum() == 0 and golden["cc_saturated"].sum() == 0


def _load(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import GOLDENS

    return dict(np.load(GOLDENS[case]))


@pytest.mark.parametrize("case", ["exact", "runs"])
def test_exact_and_runs_goldens_are_what_the_jax_package_computes(case):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_torch_golden import golden_outputs

    ref = _load(case)
    out = golden_outputs(n_frames=2, case=case)
    assert set(out) == set(ref)
    assert ref["publish"].shape == (12,) and ref["raw_centroid"].shape == (12, 32, 4)
    _compare(out, ref, 1e-6, 1e-6, n=2)


@pytest.mark.parametrize("case", ["exact", "runs", "exact_unpadded"])
def test_port_plain_path_reproduces_exact_and_runs_goldens(case):
    from multiple_object_tracking_lidar_tpu_torch import bench_cases
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import padded_frame
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_grid import exact_route
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    cfg, env, sc = getattr(bench_cases, f"{case}_case")()
    ref = _load(case.split("_")[0])
    if case.startswith("exact"):
        want = "K6" if case == "exact_unpadded" else "K5"
        assert exact_route(cfg.caps.n_max_points, cfg.voxel_leaf_size, cfg.leaf_z) == want
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
    assert ref["valid"][1:].sum(axis=1).min() == 3


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
