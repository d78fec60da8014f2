"""The card's half Hungarian builds, K3f's f32 table build and the half
fleet against their plain versions (GPU only: marked ``cuda``, skipped
without one; no JAX is imported, so it runs on the GPU machine):

- K4's Hungarian half builds (bf16 / f16) at K = 64 (the 128-thread build)
  and 1,024, 1 x 1, 1 x S and B x 1, and K4 xl's past 1,024 slots: every
  state and output field bit for bit, ``assoc_saturated`` among them, one
  launch of the half entry per call;
- K12's half builds on dense, sparse, tie and capped problems: assignments,
  saturated phases, iterations and dummy-only iterations per phase;
- K3f's f32 table build (the runs' point list under half) and its half
  builds' mesh spelling of cy;
- the half fleet on a one-rank NCCL mesh against its CPU plain path.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import (  # noqa: F401  (fixtures)
    HALF_CUDA,
    _bits,
    _chip_smoke,
    _leaves,
    _same_tree,
    _widen_canonical,
    dev,
    small,
)

from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker

pytestmark = pytest.mark.cuda
DTYPE_NAMES = {"bf16": "bfloat16", "f16": "float16"}


@pytest.mark.parametrize("h", ["bf16", "f16"])
@pytest.mark.parametrize("K,B,S,D,pf", [
    (64, 1, 1, 32, "lpf"), (64, 1, 8, 32, "lpf"), (64, 8, 1, 32, "lpf"), (64, 1, 8, 32, "ihgp"),
    (1024, 1, 1, 128, "lpf"), (2048, 1, 1, 32, "lpf")])
def test_k4_hungarian_half_matches_plain(dev, small, h, K, B, S, D, pf):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state

    dt = HALF_CUDA[h]
    cfg = small[0].replace(association="hungarian", position_filter=pf, dtype=DTYPE_NAMES[h])
    gains = Tracker(cfg, dev).gains_xy
    fresh = (0,) if B > 1 else ()
    st, dets, valid, t = track_scene(K + B + S + D, cfg, K, D, B, S, fresh, dev, gated=True)
    st = st._replace(bank=st.bank._replace(window=st.bank.window.to(dt),
                                           m0=st.bank.m0.to(dt)))
    dets, t = dets.to(dt), (t + 100.0).to(dt)
    entry = "motl_track_step" + ("_xl" if K > 1024 else "") + f"_{h}"
    by = track_cuda.track_frames.launches_by
    n0 = by[entry]
    got = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert by[entry] == n0 + 1 and got[0].bank.window.dtype == dt
    cpu = lambda x: x.cpu()  # noqa: E731
    gcpu = {k: ({q: v.cpu() for q, v in w.items()} if isinstance(w, dict) else w.cpu())
            for k, w in gains.items()}
    want = track_cuda.track_frames_plain(map_state(cpu, st), dets.cpu(), valid.cpu(), t.cpu(),
                                         config=cfg, gains_xy=gcpu)
    assert _same_tree(tuple(map(_widen_canonical, _leaves(got))),
                      tuple(map(_widen_canonical, _leaves(want))))


@pytest.mark.parametrize("h", ["bf16", "f16"])
@pytest.mark.parametrize("d,k,kind,max_iters", [
    (12, 10, "dense", 3000), (16, 16, "ties", 200), (16, 16, "ties", 1),
    (32, 64, "sparse", 3000), (128, 1024, "sparse", 100)])
def test_k12_half_matches_plain(dev, h, d, k, kind, max_iters):
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import auction_assign_plain

    rng = np.random.default_rng(d * 1000 + k + max_iters)
    eps, max_cost = (1e-4, 1.0) if kind == "ties" else (1e-3, 0.5)
    probs = [_chip_smoke().auction_problem(rng, d, k, kind) for _ in range(3 if k < 1024 else 1)]
    dt = HALF_CUDA[h]
    C = torch.from_numpy(np.stack([p[0] for p in probs])).to(dev).to(dt)
    F = torch.from_numpy(np.stack([p[1] for p in probs])).to(dev)
    entry = f"motl_auction_assign_{h}"
    n0 = hungarian_cuda.auction_assign.launches_by[entry]
    a, sat, it, fast = hungarian_cuda.auction_assign(C, F, eps, max_cost, max_iters,
                                                     return_split=True)
    assert hungarian_cuda.auction_assign.launches_by[entry] == n0 + 1
    for b in range(C.shape[0]):
        pa, ps, pit, pfast = auction_assign_plain(C[b].cpu(), F[b].cpu(), eps, max_cost,
                                                  max_iters, return_split=True)
        assert _bits(a[b], pa) and int(sat[b]) == int(ps)
        assert it[b].tolist() == pit and fast[b].tolist() == pfast


@pytest.mark.parametrize("cy_alt", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_k3f_table_and_mesh_spellings_match_plain(dev, dtype, cy_alt):
    """K3f's f32 table build (``table=True``: S = 4 frames of C = 32 slots,
    the norm's epilogue slots included) and its half builds under
    ``mesh_program``, on cluster-like member tables: bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda

    rng = np.random.default_rng(21)
    s, c, p = 4, 32, 64
    base = rng.uniform(-8, 8, (s * c, 1, 3))
    mp = (base + rng.normal(0, 0.15, (s * c, p, 3))).astype(np.float32)
    mm = rng.uniform(size=(s * c, p)) < 0.7
    mm[::7] = False
    mpts = torch.from_numpy(mp).to(dtype)
    t = torch.arange(s, dtype=dtype) * 0.1
    table = dtype == torch.float32
    if cy_alt and table:
        pytest.skip("the mesh spelling is the half builds'")
    with centroid_cuda.mesh_program(cy_alt):
        got = centroid_cuda.circumcenter_features(mpts.to(dev), torch.from_numpy(mm).to(dev),
                                                  t.to(dev), table=table)
        want = centroid_cuda.circumcenter_features(mpts, torch.from_numpy(mm), t, table=table)
    assert _bits(_widen_canonical(got), _widen_canonical(want))


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_half_fleet_on_one_nccl_rank_matches_streams_alone(dev, small, h):
    """The half fleet (the vmap form: K6f's half build, the half sums, the
    half perception, K4's half build at B x 1; greedy and Hungarian) on a
    one-rank NCCL mesh, B = 4 x 2 steps: each stream bit for bit a fleet of
    its own (1 x 1), one K4 launch a step (the CPU tests hold the same
    fleet to the JAX package's)."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.static_mask import build_static_mask
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

    cfg0, _, frames = small
    env = build_static_mask(load_sim_grid(), cfg0.static_tolarance, cfg0.occupied_threshold)
    b = 4
    mesh = make_mesh(1, 1, device=dev)
    for assoc in ("greedy", "hungarian"):
        cfg = cfg0.replace(dtype=DTYPE_NAMES[h], association=assoc)
        fleet = ShardedTracker(Tracker(cfg, device=dev), mesh)
        step = fleet.bind_env(env)
        state, own = fleet.init_state(b), [fleet.init_state(1) for _ in range(b)]
        for k in range(2):
            fr = [torch.from_numpy(np.stack([frames[(s + 3 * k) % 8][i] for s in range(b)]))
                  for i in range(3)]
            n0 = track_cuda.track_frames.launches_by[f"motl_track_step_{h}"]
            state, o = step(state, *fr)
            assert track_cuda.track_frames.launches_by[f"motl_track_step_{h}"] == n0 + 1
            for s in range(b):
                own[s], w = step(own[s], *(f[s:s + 1] for f in fr))
                assert _same_tree(tuple(_widen_canonical(f[s]) for f in o),
                                  tuple(_widen_canonical(f[0]) for f in w)), (assoc, k, s)
