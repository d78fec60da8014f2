"""The CUDA kernels (K1-K11, K3f, K6 in both modes and its key entry, K1-cm,
K4 on banks past 128 slots, K1's and K5's histograms and finalizes alone,
K1 and K5 at 70,200 and 193,536 cells)
against their plain PyTorch versions, the slices
(fast, exact and runs mode, the stencil CC of ``grid_cc="jnp"``; the
point-list configurations C-F) on the GPU against the port's plain path on
the CPU, and the kernel fleet on a one-rank NCCL mesh against ``bind_env``;
K4 under ``position_filter="ihgp"``, F7 (K8a at a ragged M; K8 and K8a
past 8,192 rows, the frame in device memory) and the CLI's ``run --backend grid`` against the
JAX CLI's goldens; K12 (the Hungarian auction alone) and K4's Hungarian
builds against their plain versions, and the Hungarian paths against the
JAX goldens; under ``dtype="float64"`` the double builds (K2, K3f, K4;
K6f, K8a and K2 fed f32 sums) against their plain versions, the f64 paths
(the dense grid, the point list, the exact and runs modes) against the
CPU plain path, and the f64 routes with no double build raising; K13
(the IHGP learning step) against its plain version and past its bounds,
and the learning node and ``tune`` against their JAX goldens (in f32, and
under bf16 / f16 bit for bit); under bf16 / f16 the half
builds (K2, K14, K3f, K4; K6f, K8a, K2 fed f32 sums, K3f on the sorted
point list at P = 512) against their plain versions and each perception
front end against the CPU plain path.  Marked
``cuda``: they
skip without a GPU.  This file imports no JAX, so on the GPU machine (which
has none) it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Kernel and plain version must agree bit for bit (integer sums, labels and
decisions exactly; floats are the same IEEE ops in the same order, no FMA).
The slice on the GPU matches the CPU plain path exactly except for the
velocities, whose mean and 39-term smoother sums reduce in another order
on the card (atol 1e-5 m/s).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.bench_cases import headline_case
from multiple_object_tracking_lidar_tpu_torch.ops import (
    assign_cuda,
    centroid_cuda,
    cluster_pallas,
    grid_cuda,
    segsum_cuda,
    transpose_cuda,
    voxel_grid_cuda,
)
from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import Tracker
from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame, FrameOutput

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the plain versions run in the CPU tests")
    return torch.device("cuda", 0)


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def small(dev):
    cfg, env, sc = headline_case(device=dev)
    cfg = cfg.replace(caps=dataclasses.replace(
        cfg.caps, n_max_points=16384, c_max_clusters=16, p_max_cluster=128, k_max_tracks=16))
    frames = []
    for k in range(8):
        pts, t = sc.frame_arrays(k)
        sub = np.concatenate([pts[:95200:10], pts[95200:]])[:16384]
        buf = np.zeros((16384, 3), np.float32)
        buf[: len(sub)] = sub
        mask = np.zeros(16384, bool)
        mask[: len(sub)] = True
        frames.append((buf, mask, np.float32(t)))
    buf = frames[7][0]
    buf[:50, 0] = np.nan                                         # adversarial frame
    buf[50:100] = [-999.0, 999.0, 0.5]
    buf[100:2000, :2] = np.round(buf[100:2000, :2] / 0.1) * np.float32(0.1)
    return cfg, env, frames


def test_k1_matches_plain(dev, small):
    cfg, _, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    args = (P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    n0 = voxel_grid_cuda.accumulate_fast_stacked.launches
    ka, kn = voxel_grid_cuda.accumulate_fast_stacked(*args)
    pa, pn = voxel_grid_cuda.accumulate_fast_stacked_plain(*args)
    assert voxel_grid_cuda.accumulate_fast_stacked.launches == n0 + 1
    assert _bits(ka, pa) and _bits(kn, pn)


def test_k2_matches_plain(dev, small):
    cfg, env, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    accs, _ = voxel_grid_cuda.accumulate_fast_stacked(
        P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    coin = torch.from_numpy(np.random.default_rng(6).random(accs.shape[2]) < 0.5).to(dev)
    accs[6, 3] = torch.where(accs[6, 3] > 0, accs[6, 3], coin.float())  # many components
    plan = Tracker(cfg, dev).plan(env)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
              leaf_z=cfg.leaf_z, kwin=plan.table.k)
    k = grid_cuda.fused_finalize_static_cc_stacked(accs, *tb, **kw)
    p = grid_cuda.fused_finalize_static_cc_stacked_plain(
        accs, *tb, dims=plan.dims, kwin=plan.table.k, max_sweeps=2 * sum(plan.dims),
        offsets=grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance,
                                         cfg.voxel_leaf_size, cfg.leaf_z))
    for a, b in zip(k, p):
        assert _bits(a, b)


def test_k3_matches_plain(dev):
    rng = np.random.default_rng(4)
    mp = torch.from_numpy(rng.normal(0, 0.2, (16, 128, 3)).astype(np.float32)).to(dev)
    mm = torch.from_numpy(rng.random((16, 128)) < 0.4).to(dev)
    mm[3] = False
    mp[5, 60:] = mp[5, :68].clone()                              # duplicates
    line = torch.linspace(0, 1, 30, device=dev)
    mp[6, :30] = torch.stack([line, 2 * line, 0 * line], 1)
    kc, kf = centroid_cuda.pair_stats(mp, mm)
    pc, pf = centroid_cuda.pair_stats_plain(mp, mm)
    assert _bits(kc, pc) and _bits(kf, pf)


@pytest.mark.parametrize("allow,full", [(False, False), (True, False), (True, True)])
def test_k4_matches_plain(dev, allow, full):
    rng = np.random.default_rng(7)
    K, D = 16, 12
    af0 = torch.from_numpy(rng.uniform(-1, 1, (K, 3)).astype(np.float32)).to(dev)
    alive = torch.ones(K, dtype=torch.int32) if full else (torch.arange(K) % 3 != 0).int()
    births = torch.from_numpy(rng.permutation(K)).int()
    ai0 = torch.stack([alive, torch.arange(K).int(), births], 1).int().to(dev)
    dets = torch.from_numpy(rng.uniform(-1.2, 1.2, (D, 4)).astype(np.float32)).to(dev)
    dets[:, 3] = 0.6
    dv = torch.from_numpy(rng.random(D) < 0.8).to(dev)
    args = (af0, ai0, dets, dv, torch.tensor(allow, device=dev),
            torch.tensor(40, dtype=torch.int32, device=dev),
            torch.tensor(50, dtype=torch.int32, device=dev))
    kw = dict(thr=0.5, dt_gp=0.1, interp_gap_factor=3.0)
    k = assign_cuda.assoc_scan(*args, **kw)
    p = assign_cuda.assoc_scan_plain(*args, **kw)
    ok = p[9].cpu()
    for i, (a, b) in enumerate(zip(k, p)):
        if i == 6:
            a, b = a.cpu()[ok], b.cpu()[ok]
        assert _bits(a.reshape(-1), b.reshape(-1).to(a.dtype)), i


@pytest.mark.parametrize("K", [33, 128, 256, 1000, 1024])
def test_k4_wide_matches_plain(dev, K):
    """K4 on banks grown past the TPU kernel's 128 slots (one CTA of
    32 * ceil(K / 32) lanes); tracks gated near slots past 128."""
    rng = np.random.default_rng(K)
    D = 32
    af0 = torch.from_numpy(rng.uniform(-8, 8, (K, 3)).astype(np.float32)).to(dev)
    ai0 = torch.stack([(torch.arange(K) % 4 != 1).int(), torch.arange(K).int(),
                       torch.from_numpy(rng.permutation(K)).int()], 1).int().to(dev)
    dets = torch.from_numpy(rng.uniform(-8, 8, (D, 4)).astype(np.float32)).to(dev)
    dets[:, 3] = 0.6
    dets[:4, :2] = af0[K - 1, :2] + 0.05                         # near the last slot
    dv = torch.ones(D, dtype=torch.bool, device=dev)
    args = (af0, ai0, dets, dv, torch.tensor(True, device=dev),
            torch.tensor(40, dtype=torch.int32, device=dev),
            torch.tensor(50, dtype=torch.int32, device=dev))
    kw = dict(thr=0.5, dt_gp=0.1, interp_gap_factor=3.0)
    n0 = assign_cuda.assoc_scan.launches
    k = assign_cuda.assoc_scan(*args, **kw)
    p = assign_cuda.assoc_scan_plain(*args, **kw)
    assert assign_cuda.assoc_scan.launches == n0 + 1
    ok = p[9].cpu()
    for i, (a, b) in enumerate(zip(k, p)):
        if i == 6:
            a, b = a.cpu()[ok], b.cpu()[ok]
        assert _bits(a.reshape(-1), b.reshape(-1).to(a.dtype)), i
    with pytest.raises(ValueError, match="1024"):
        assign_cuda.assoc_scan(torch.zeros((1025, 3), device=dev),
                               torch.zeros((1025, 3), dtype=torch.int32, device=dev), *args[2:], **kw)


def test_k10_matches_plain(dev):
    """K10 on knife edges (a 0.1 m lattice: ties; a collinear cluster; a
    singleton; duplicates; empty slots) at P = 384 and 512."""
    rng = np.random.default_rng(10)
    for c, p in ((16, 384), (8, 512)):
        mp = np.zeros((c, p, 3), np.float32)
        mm = np.zeros((c, p), bool)
        for k in range(0, c, 2):
            n = int(rng.integers(2, p))
            mp[k, :n] = np.round(rng.normal(0, 1, (n, 3)) * 10) / 10
            mm[k, :n] = True
        mp[1, 0], mm[1, 0] = [1.0, 2.0, 0.5], True
        mp[3, :9] = np.stack([0.1 * np.arange(9), 0.2 * np.arange(9), np.zeros(9)], 1)
        mm[3, :9] = True
        mp[5, :20] = np.round(rng.normal(0, 1, (20, 3)) * 10) / 10
        mp[5, 20:40] = mp[5, :20]
        mm[5, :40] = True
        tp, tm = torch.from_numpy(mp).to(dev), torch.from_numpy(mm).to(dev)
        n0 = centroid_cuda.circumcenter_xy.launches
        k = centroid_cuda.circumcenter_xy(tp, tm)
        assert centroid_cuda.circumcenter_xy.launches == n0 + 1
        assert _bits(k, centroid_cuda.circumcenter_xy_plain(tp, tm))
        assert (k[3].cpu().numpy() == mp[3, :9, :2]).all(1).any()     # collinear: Pi


def _k3f_table(rng, s, c, p, dev):
    """S stacked (C, P) member tables: a 0.1 m lattice cluster (ties), a
    collinear one (G == 0), a singleton, two members, all-equal members, a
    NaN member, a full slot and empty slots."""
    mp = np.zeros((s, c, p, 3), np.float32)
    mm = np.zeros((s, c, p), bool)
    for f in range(s):
        n = int(rng.integers(2, p))
        mp[f, 0, :n] = np.round(rng.normal(0, 1, (n, 3)) * 10) / 10
        mm[f, 0, :n] = True
        mp[f, 1, :9] = np.stack([0.25 * np.arange(9), 0.5 * np.arange(9), np.zeros(9)], 1)
        mm[f, 1, :9] = True
        mp[f, 2, 3], mm[f, 2, 3] = [1.0, 2.0, 0.5], True
        mp[f, 3, :2], mm[f, 3, :2] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], True
        mp[f, 4, :12], mm[f, 4, :12] = [3.0, -1.0, 0.25], True
        mp[f, 5, :40] = rng.normal(0, 1, (40, 3))
        mm[f, 5, :40] = True
        mp[f, 5, 21, 1] = np.nan
        mp[f, 6] = rng.uniform(-2, 2, (p, 3))
        mm[f, 6] = True
    return (torch.from_numpy(mp).reshape(s * c, p, 3).to(dev),
            torch.from_numpy(mm).reshape(s * c, p).to(dev))


@pytest.mark.parametrize("s,c,p", [(1, 32, 384), (8, 32, 384), (8, 64, 512)])
def test_k3f_matches_plain(dev, s, c, p):
    """K3f at the headline's and configuration G's tables, S stacked
    frames, one time per frame: bit for bit its plain version, and K3's
    stats with the eager selection after them."""
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_from_pair_stats

    mp, mm = _k3f_table(np.random.default_rng(c + s), s, c, p, dev)
    t = torch.arange(s, dtype=torch.float32, device=dev) * 0.1 + 0.05
    n0 = centroid_cuda.circumcenter_features.launches
    k = centroid_cuda.circumcenter_features(mp, mm, t)
    assert centroid_cuda.circumcenter_features.launches == n0 + 1
    assert _bits(k, centroid_cuda.circumcenter_features_plain(mp, mm, t))
    ref = circumcenter_from_pair_stats(*centroid_cuda.pair_stats(mp, mm), mp, mm,
                                       t.repeat_interleave(c))
    assert _bits(k, ref)
    assert _bits(k[1::c, :2], mp[1::c, 0, :2]) or _bits(k[1::c, :2], mp[1::c, 8, :2])


@pytest.mark.parametrize("case", ["headline_case", "default_case"])
@pytest.mark.parametrize("mode", ["bf16x3", "f32", "keys"])
def test_k6_sort_matches_plain(dev, case, mode):
    """K6's three entries at the headline's and configuration G's grids,
    S = 3: a frame whose points all fall in one cell, an all-dropped frame,
    NaN points and keys at n_cells - 1."""
    cfg, _, sc = getattr(bench_cases, case)()
    n = cfg.caps.n_max_points
    rows = [bench_cases.padded_frame(sc, k, n) for k in range(3)]
    P = torch.from_numpy(np.stack([r[0] for r in rows])).to(dev)
    M = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    P[0, ::9, 0] = float("nan")
    P[1] = torch.tensor([0.05, 2.05, 0.5], device=dev)
    M[2] = False
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    if mode == "keys":
        k = voxel_grid_cuda.kernel_params(*kw)
        gx, gyz = k["gx"], k["gy"] * k["gz"]
        M[2] = True
        ok, lin, _ = voxel_grid_cuda.kept_cells(P, M, k)
        ix, iyz = lin % gx, lin // gx
        ix[:, :64], iyz[:, :64], ok[:, :64] = gx - 1, gyz - 1, True
        ok[2] = False
        args = (P, ix, iyz, ok, gx, gyz)
        out = ((voxel_grid_cuda.accumulate_bf16x3_keys(*args),),
               (voxel_grid_cuda.accumulate_bf16x3_keys_plain(*args),))
    else:
        wrapper = getattr(voxel_grid_cuda, f"accumulate_{mode}_stacked")
        plain = getattr(voxel_grid_cuda, f"accumulate_{mode}_stacked_plain")
        n0 = wrapper.launches
        out = wrapper(P, M, *kw), plain(P, M, *kw)
        assert wrapper.launches == n0 + 1
    assert all(_bits(a, b) for a, b in zip(*out))
    if mode != "keys":
        assert out[0][0][1, 3].max() == M[1].sum() and (out[0][0][2] == 0).all()


def test_k6_keys_matches_plain(dev, small):
    cfg, _, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    k = voxel_grid_cuda.kernel_params(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    gx, gyz = k["gx"], k["gy"] * k["gz"]
    ok, lin, _ = voxel_grid_cuda.kept_cells(P, M, k)
    ix, iyz = lin % gx, lin // gx
    ix[:, :100], iyz[:, 100:200], ok[:, 200:300] = gx, -1, False
    args = (P, ix, iyz, ok, gx, gyz)
    n0 = voxel_grid_cuda.accumulate_bf16x3_keys.launches
    got = voxel_grid_cuda.accumulate_bf16x3_keys(*args)
    assert voxel_grid_cuda.accumulate_bf16x3_keys.launches == n0 + 1
    assert _bits(got, voxel_grid_cuda.accumulate_bf16x3_keys_plain(*args))



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6f_keys_and_sort_downsample_match_plain(dev, small, dtype):
    """K6f's key entry (f32, and its double build) bit for bit its plain
    version on the same CUDA tensors (frame 7's NaN points included), bins
    dropped below 0 and past n_bins; then ``voxel_downsample_sort`` on the
    card, with a far return, bit for bit the same function on the CPU."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_downsample_sort

    _, _, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dtype).to(dev)
    g = torch.Generator().manual_seed(5)
    bins = torch.randint(-2, 1100, P.shape[:2], generator=g).to(dev)
    by = voxel_grid_cuda.accumulate_sums_keys.launches_by
    entry = "motl_voxel_sums_keys" + ("_f64" if dtype == torch.float64 else "")
    n0 = by[entry]
    got = voxel_grid_cuda.accumulate_sums_keys(P, bins, 1024)
    assert by[entry] == n0 + 1
    assert _bits(got, voxel_grid_cuda.accumulate_sums_keys_plain(P, bins, 1024))
    pts = P[0].clone()
    pts[3] = torch.tensor([9.5e5, -8.25e5, 40.0], dtype=dtype)
    mask = torch.from_numpy(frames[0][1]).to(dev)
    mask[3] = True
    got = voxel_downsample_sort(pts, mask, 0.1, 0.1, 4096)
    want = voxel_downsample_sort(pts.cpu(), mask.cpu(), 0.1, 0.1, 4096)
    assert all(_bits(a, b) for a, b in zip(got, want))

def test_k1_cm_matches_plain(dev, small):
    cfg, _, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    Pcm = P.transpose(1, 2).contiguous()
    vg = voxel_grid_cuda
    ka, kn = vg.accumulate_fast_stacked_cm(Pcm, M, *kw)
    pa, pn = vg.accumulate_fast_stacked_cm_plain(Pcm, M, *kw)
    assert _bits(ka, pa) and _bits(kn, pn)
    ra, rn = vg.accumulate_fast_stacked_cm_raw(Pcm, M, *kw)
    assert _bits(ra, vg.fast_digit_sums(P, M, *kw)) and _bits(rn, pn)
    assert _bits(vg.finalize_fast_stacked(ra, *kw), ka)
    assert _bits(ka, vg.accumulate_fast_stacked(P, M, *kw)[0])


@pytest.mark.parametrize("shape,dtype", [((8, 5000, 3), torch.float32),
                                         ((1, 1, 2048), torch.int32),
                                         ((1, 16, 128), torch.int32),
                                         ((3, 70, 45), torch.float32)])
def test_k11_matches_plain(dev, shape, dtype):
    """K11 on the points' (S, N, 3), the TPU probes' (1, B) and (16, 128)
    int32 rows, and partial tiles both ways; NaN words move unchanged."""
    g = torch.Generator().manual_seed(11)
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int64)
    x = x.to(torch.int32).view(dtype).to(dev)
    n0 = transpose_cuda.transpose_words.launches
    got = transpose_cuda.transpose_words(x)
    assert transpose_cuda.transpose_words.launches == n0 + 1
    assert _bits(got, transpose_cuda.transpose_words_plain(x))
    assert _device_ops(lambda: transpose_cuda.transpose_words(x)) == 1


def _words(g, shape, dtype):
    x = torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int64)
    return x.to(torch.int32).view(dtype)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 33, 128])
def test_k11_every_route_matches_plain(dev, c):
    """Every width K11's routes tell apart (C = 1 a copy, 2-4 the 16-byte
    row groups, past 4 the tiles) at R % 4 = 0-3 (a ragged last group,
    misaligned planes and frame bases), int32 and f32 words; one launch and
    one device op per call."""
    g = torch.Generator().manual_seed(c)
    for r in (36, 37, 38, 39, 4099):
        for dtype in (torch.int32, torch.float32):
            x = _words(g, (3, r, c), dtype).to(dev)
            n0 = transpose_cuda.transpose_words.launches
            got = transpose_cuda.transpose_words(x)
            assert transpose_cuda.transpose_words.launches == n0 + 1
            assert _bits(got, transpose_cuda.transpose_words_plain(x)), (r, dtype)
    assert _device_ops(lambda: transpose_cuda.transpose_words(x)) == 1


@pytest.mark.parametrize("shape", [(3, 37, 3), (2, 4096, 3), (2, 40, 4), (2, 1, 77), (2, 50, 5)])
def test_k11_misaligned_frame_base_matches_plain(dev, shape):
    """An input whose data pointer sits 4 bytes past a 16-byte boundary:
    every access that cannot be 16 bytes moves word by word."""
    g = torch.Generator().manual_seed(sum(shape))
    n = shape[0] * shape[1] * shape[2]
    x = _words(g, (n + 1,), torch.float32).to(dev)[1:].view(shape)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    assert _bits(transpose_cuda.transpose_words(x), transpose_cuda.transpose_words_plain(x))


@pytest.mark.parametrize("name,leaf", [("exact", 0.1), ("exact", 0.12), ("bf16x3", 0.05),
                                       ("bf16x3", 0.1), ("bf16x3", 0.5), ("f32", 0.05),
                                       ("f32", 0.1)])
def test_k5_k6_match_plain(dev, small, name, leaf):
    cfg, _, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    args = (P, M, cfg.scene, leaf, 20 * leaf)
    wrapper = getattr(voxel_grid_cuda, f"accumulate_{name}_stacked")
    plain = getattr(voxel_grid_cuda, f"accumulate_{name}_stacked_plain")
    n0 = wrapper.launches
    ka, kn = wrapper(*args)
    pa, pn = plain(*args)
    assert wrapper.launches == n0 + 1
    assert _bits(ka, pa) and _bits(kn, pn)


def test_k5_raises_past_one_cta(dev, small):
    """298,377 cells (0.05 m / 0.25 m over 6.4 x 12.8 x 2.1 m): past K5's
    16 ranges of CTAs (232,320 cells) the wrapper no longer raises: K5
    takes the wide layout (32 ranges), one launch, bit for bit its plain
    version; it never falls back."""
    from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds

    _, _, frames = small
    scene = SceneBounds(x_min=0.0, x_max=6.43, y_min=0.0, y_max=12.83, z_min=0.0, z_max=2.1)
    P = torch.from_numpy(frames[0][0][None]).to(dev)
    M = torch.from_numpy(frames[0][1][None]).to(dev)
    assert voxel_grid_cuda.kernel_params(scene, 0.05, 0.25)["n_cells"] == 298_377
    assert voxel_grid_cuda.digit_layout(298_377, 1, 3)[0] == 32
    n0 = voxel_grid_cuda.accumulate_exact_stacked.launches
    got = voxel_grid_cuda.accumulate_exact_stacked(P, M, scene, 0.05, 0.25)
    assert voxel_grid_cuda.accumulate_exact_stacked.launches == n0 + 1
    want = voxel_grid_cuda.accumulate_exact_stacked_plain(P.cpu(), M.cpu(), scene, 0.05, 0.25)
    assert _bits(got[0], want[0]) and _bits(got[1], want[1])


@pytest.mark.parametrize("grid", ["CLI grid", "default scene"])
@pytest.mark.parametrize("quant", ["fast", "exact"])
def test_k1_k5_clusters_match_plain(dev, grid, quant):
    """K1 and K5, fused and raw, at the CLI's 70,200 cells and the default
    scene's 193,536 (``bench_cases.digit_grids``; 8 and 16 cell ranges by
    ``digit_layout``) on two frames of the path's points, one of them with
    NaN rows and half its points in one cell: bit for bit their plain
    versions, one launch each."""
    cfg = bench_cases.headline_case()[0]
    _, scene, leaf, leaf_z, case = next(g for g in bench_cases.digit_grids(cfg) if g[0] == grid)
    ccfg, _, sc = getattr(bench_cases, f"{case}_case")()
    rows = [bench_cases.padded_frame(sc, k, ccfg.caps.n_max_points) for k in (0, 1)]
    pts = np.stack([r[0] for r in rows])
    mask = np.stack([r[1] for r in rows])
    pts[1, ::2] = pts[1, 0]
    pts[1, 1:200:3, 1] = np.nan
    P, M = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    args = (P, M, scene, leaf, leaf_z)
    vg = voxel_grid_cuda
    fused, raw, plain, plain_raw = (
        (vg.accumulate_fast_stacked, vg.accumulate_fast_stacked_raw,
         vg.accumulate_fast_stacked_plain, vg.fast_digit_sums) if quant == "fast" else
        (vg.accumulate_exact_stacked, vg.accumulate_exact_stacked_raw,
         vg.accumulate_exact_stacked_plain, vg.exact_digit_sums))
    n0 = (fused.launches, raw.launches)
    got, got_raw = fused(*args), raw(*args)
    assert (fused.launches, raw.launches) == (n0[0] + 1, n0[1] + 1)
    cpu = (P.cpu(), M.cpu(), scene, leaf, leaf_z)
    assert _bits(got[0], plain(*cpu)[0]) and _bits(got[1], plain(*cpu)[1])
    assert _bits(got_raw[0], plain_raw(*cpu)) and _bits(got_raw[1], got[1])


def _device_ops(fn) -> float:
    """Device operations of one call of fn after a warm-up, from a trace
    between marker kernels (``chip_smoke.one_op_profile``: a trace that lost
    events at an end is taken again, up to three times)."""
    return _chip_smoke().one_op_profile(fn, 1)[1]


@pytest.mark.parametrize("n", [1024, 384, 3 * 8192, 13 * 8192])
@pytest.mark.parametrize("with_perm", [False, True])
def test_k7_matches_plain(dev, n, with_perm):
    rng = np.random.default_rng(n)
    ks = np.sort(rng.integers(0, n // 5, (2, n)), axis=1).astype(np.int32)
    if n > 8192:
        ks[1, 8000:8400] = ks[1, 8000]                           # across a block edge
        ks[1] = np.maximum.accumulate(ks[1])
    v = rng.normal(0, 3, (2, n, 3)).astype(np.float32)
    v[0, n // 2, 0] = np.inf                                     # inf and signed zeros
    v[0, ::7, 2] = -0.0
    V = torch.from_numpy(v).to(dev)
    K = torch.from_numpy(ks).to(dev)
    perm = None
    if with_perm:                                                # the channels of one (S, N, 3)
        perm = torch.stack([torch.randperm(n, generator=torch.Generator().manual_seed(f))
                            for f in range(2)]).to(dev)
        vals = [V[..., c] for c in range(3)]
    else:
        vals = [V[..., c].contiguous() for c in range(3)]
    n0 = segsum_cuda.segment_totals.launches
    k = segsum_cuda.segment_totals(K, *vals, perm=perm)
    assert segsum_cuda.segment_totals.launches == n0 + 1
    p = segsum_cuda.segment_totals_plain(K, *vals, perm=perm)
    for a, b in zip(k, p):
        assert _bits(a, b)
    # one device op per call, and a second call on the same scratch agrees
    assert _device_ops(lambda: segsum_cuda.segment_totals(K, *vals, perm=perm)) == 1
    for a, b in zip(segsum_cuda.segment_totals(K, *vals, perm=perm), p):
        assert _bits(a, b)


@pytest.mark.parametrize("quant", ["fast", "exact"])
def test_raw_and_finalize_match_plain(dev, small, quant):
    """K1's and K5's histograms alone and their finalizes alone (the kernel
    fleet's entries) against their plain versions, and raw + finalize
    against the fused kernel: bit for bit."""
    cfg, _, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    args = (P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    vg = voxel_grid_cuda
    raw_fn, fin_fn, fused, plain_raw = (
        (vg.accumulate_fast_stacked_raw, vg.finalize_fast_stacked, vg.accumulate_fast_stacked,
         vg.fast_digit_sums) if quant == "fast" else
        (vg.accumulate_exact_stacked_raw, vg.finalize_exact_stacked, vg.accumulate_exact_stacked,
         vg.exact_digit_sums))
    n0 = (raw_fn.launches, fin_fn.launches)
    raw, n = raw_fn(*args)
    fin = fin_fn(raw, *kw)
    assert (raw_fn.launches, fin_fn.launches) == (n0[0] + 1, n0[1] + 1)
    assert _bits(raw, plain_raw(*args)) and _bits(n, (M != 0).sum(1).int())
    assert _bits(fin, fin_fn(raw.cpu(), *kw))                   # the plain finalize
    assert _bits(fin, fused(*args)[0])


def test_kernel_fleet_gpu_matches_bind_env(dev, small):
    """The kernel fleet on a one-rank NCCL mesh, 4 streams x 2 steps, against
    each stream's own bind_env on the card: bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh

    cfg, env, frames = small
    tr = Tracker(cfg, dev)
    fleet = ShardedTracker(tr, make_mesh(1, 1), kernel_path="on")
    step = fleet.bind_env(env)
    state = fleet.init_state(4)
    outs = []
    for k in range(2):
        fr = [frames[2 * s + k] for s in range(4)]
        state, o = step(state, *(torch.from_numpy(np.stack([f[i] for f in fr])).to(dev)
                                 for i in range(3)))
        outs.append(o)
    for s in range(4):
        one = tr.bind_env(env)
        st = tr.init_state()
        for k in range(2):
            buf, mask, t = frames[2 * s + k]
            st, o = one(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            for name, a, b in zip(FrameOutput._fields, o, outs[k]):
                assert _bits(a, b[s]), (s, k, name)


@pytest.mark.parametrize("field,value", [("voxel_quant", "exact"), ("voxel_mode", "runs"),
                                         ("grid_cc", "jnp")])
def test_exact_and_runs_slices_gpu_match_cpu_plain_path(dev, small, field, value):
    cfg, env, frames = small
    cfg = cfg.replace(**{field: value})
    env_cpu = headline_case()[1]
    outs = {}
    for where, e in (("cpu", env_cpu), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        step = tr.bind_env(e)
        st = tr.init_state()
        rows = []
        for buf, mask, t in frames[:7]:
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([x.cpu() for x in o])
        outs[where] = rows
    for rc, rg in zip(outs["cpu"], outs["gpu"]):
        for name, a, b in zip(FrameOutput._fields, rc, rg):
            if name == "vel":
                assert torch.allclose(a, b, rtol=0, atol=1e-5), name
            else:
                assert _bits(a, b), name


def _blobs(seed, s, m, n_valid):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, (s, 8, 3)) * np.array([1, 1, 0.1])
    which = rng.integers(0, 8, (s, m))
    pts = (np.take_along_axis(centres, which[..., None], 1)
           + rng.normal(0, 0.06, (s, m, 3))).astype(np.float32)
    mask = np.zeros((s, m), bool)
    for f in range(s):
        mask[f, rng.permutation(m)[:n_valid]] = True
    return pts, mask


def _k8_frames(dev, m, n_sweeps):
    pts, mask = _blobs(m + n_sweeps, 4, m, int(0.8 * m))
    n = min(m, 200)                                   # frame 2: a reversed chain
    pts[2] = 50.0
    pts[2, :n, 0] = np.arange(n)[::-1] * 0.1
    mask[2] = False
    mask[2, :n] = True
    mask[1] = False                                   # frame 1: empty
    pts[3, np.flatnonzero(~mask[3])[:3], 0] = [np.nan, np.inf, -np.inf]  # 3: in invalid rows
    return torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("m,n_sweeps", [(256, 64), (1024, 256), (2048, 256), (1024, 5),
                                        (4096, 64), (8192, 32), (8448, 64), (8448, 5)])
def test_k8_matches_plain(dev, m, n_sweeps):
    """At C's M = 1,024 and G's 2,048, at 4,096 (16 CTAs, the words still in
    shared memory) and 8,192 (past it: the words in device memory), at
    8,448 (past MAX_ROWS: the frame and the labels in device memory too),
    and chains cut at n_sweeps = 5."""
    P, M = _k8_frames(dev, m, n_sweeps)
    n0 = cluster_pallas.connected_components_pallas.launches
    k, ks = cluster_pallas.connected_components_pallas(P, M, 0.15, n_sweeps, with_sweeps=True)
    p, ps = cluster_pallas.connected_components_pallas_plain(P, M, 0.15, n_sweeps,
                                                             with_sweeps=True)
    assert cluster_pallas.connected_components_pallas.launches == n0 + 1
    assert _bits(k, p) and ks == ps
    a0 = cluster_pallas.cc_adjacency.launches
    adj = cluster_pallas.cc_adjacency(P, M, 0.15)
    assert cluster_pallas.cc_adjacency.launches == a0 + 1
    assert adj.dtype == torch.bool
    assert _bits(adj, cluster_pallas.cc_adjacency_plain(P, M, 0.15))
    if n_sweeps == 5:
        assert ks == 5                                # the chain was cut short


@pytest.mark.parametrize("m", [1024, 2048])
def test_k8_every_cluster_size_matches_plain(dev, m):
    P, M = _k8_frames(dev, m, 64)
    p = cluster_pallas.connected_components_pallas_plain(P, M, 0.15, 64)
    a = cluster_pallas.cc_adjacency_plain(P, M, 0.15)
    for c in (1, 2, 4, 8, 16):
        if c > grid_cuda.max_cluster(dev):
            continue
        assert _bits(cluster_pallas.connected_components_pallas(P, M, 0.15, 64, cluster=c), p), c
        assert _bits(cluster_pallas.cc_adjacency(P, M, 0.15, cluster=c), a), c


def test_k8_one_device_op_per_call(dev):
    """On the point list as compact_points hands it over (strided views of
    its (S, M + 1) buffers), each call is its kernel and nothing else."""
    from multiple_object_tracking_lidar_tpu_torch.ops.compact import compact_points

    pts, mask = _blobs(9, 2, 1400, 1100)
    P, M = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    cp, cm, _ = compact_points(P, M, 1024)
    assert not cp.is_contiguous()
    assert _device_ops(lambda: cluster_pallas.connected_components_pallas(cp, cm, 0.15, 64)) == 1
    assert _device_ops(lambda: cluster_pallas.cc_adjacency(cp, cm, 0.15)) == 1
    assert _bits(cluster_pallas.connected_components_pallas(cp, cm, 0.15, 64),
                 cluster_pallas.connected_components_pallas_plain(cp, cm, 0.15, 64))


@pytest.mark.parametrize("n", [1000, 3 * 2048])
def test_k9_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    ks = np.sort(rng.integers(0, n // 5, (2, n)), axis=1).astype(np.int32)
    if n > 2048:
        ks[1, 2000:2100] = ks[1, 2000]                           # across a block edge
        ks[1] = np.maximum.accumulate(ks[1])
    K = torch.from_numpy(ks).to(dev)
    V = torch.from_numpy(rng.normal(0, 3, (2, n, 4)).astype(np.float32)).to(dev)
    assert _bits(segsum_cuda.segment_totals_rows(K, V), segsum_cuda.segment_totals_rows_plain(K, V))


@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("n", [7, 1001, 2048, 3 * 2048, 106496])
def test_k9_every_shape_matches_plain(dev, n, s):
    """K9 at one block of a ragged T = N (7, 1,001), one block, three and
    the headline's 52, for S = 1 and 8: frame 0 with inf and -0.0 in the
    rows the cyclic roll wraps onto and in the rows that read them, and a
    run across the first block edge; frame 1 one run over every block;
    frame 2 length-1 runs.  One launch and one device op per call, and the
    same bits from a (S, N, 4) array 4 bytes past 16-byte alignment."""
    rng = np.random.default_rng(n + s)
    t = segsum_cuda.row_block(n)
    ks = np.sort(rng.integers(0, max(2, n // 5), (s, n)), axis=1).astype(np.int32)
    v = rng.normal(0, 3, (s, n, 4)).astype(np.float32)
    v[0, t - 1, 3] = np.inf                                      # inf * 0 -> NaN into row 0
    v[0, t - 3:t, 1] = -0.0
    v[0, :4, 2] = -0.0
    v[0, max(0, t - 4):t, 2] = 1.5
    if n > 2048:
        ks[0, 2000:2100] = ks[0, 2000]                           # across a block edge
        ks[0] = np.maximum.accumulate(ks[0])
    if s > 1:
        ks[1] = 5                                                # one run over every block
        ks[2] = np.arange(n)                                     # length-1 runs
    K = torch.from_numpy(ks).to(dev)
    V = torch.from_numpy(v).to(dev)
    n0 = segsum_cuda.segment_totals_rows.launches
    got = segsum_cuda.segment_totals_rows(K, V)
    assert segsum_cuda.segment_totals_rows.launches == n0 + 1
    want = segsum_cuda.segment_totals_rows_plain(K, V)
    assert _bits(got, want)
    assert _device_ops(lambda: segsum_cuda.segment_totals_rows(K, V)) == 1
    off = torch.empty(V.numel() + 1, dtype=torch.float32, device=dev)[1:].view(V.shape)
    off.copy_(V)
    assert off.data_ptr() % 16 != 0
    assert _bits(segsum_cuda.segment_totals_rows(K, off), want)


@pytest.mark.parametrize("case", ["pointlist_case", "pointlist_jnp_case", "scan_case",
                                  "pointlist_runs_case"])
def test_pointlist_slices_gpu_match_cpu_plain_path(dev, small, case):
    cfg0, _, frames = small
    cfg, env, _ = getattr(bench_cases, case)(device=dev)
    cfg = cfg.replace(caps=dataclasses.replace(cfg0.caps, m_max_voxels=2048, m_max_dynamic=512))
    env_cpu = getattr(bench_cases, case)()[1]
    outs = {}
    for where, e in (("cpu", env_cpu), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        step = tr.bind_env(e)
        st = tr.init_state()
        rows = []
        for buf, mask, t in frames[:7]:
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([x.cpu() for x in o])
        outs[where] = rows
    for rc, rg in zip(outs["cpu"], outs["gpu"]):
        for name, a, b in zip(FrameOutput._fields, rc, rg):
            if name == "vel":
                assert torch.allclose(a, b, rtol=0, atol=1e-5), name
            else:
                assert _bits(a, b), name


def test_slice_gpu_matches_cpu_plain_path(dev, small):
    cfg, env, frames = small
    env_cpu = headline_case()[1]
    outs = {}
    for where, e in (("cpu", env_cpu), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        step = tr.bind_env(e)
        st = tr.init_state()
        rows = []
        for buf, mask, t in frames[:7]:
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([x.cpu() for x in o])
        outs[where] = rows
    for rc, rg in zip(outs["cpu"], outs["gpu"]):
        for name, a, b in zip(FrameOutput._fields, rc, rg):
            if name == "vel":
                assert torch.allclose(a, b, rtol=0, atol=1e-5), name
            else:
                assert _bits(a, b), name


def test_headline_bind_env_launches_k3f_not_k3(dev, small):
    """The headline's bind_env on the card: the circumcenter is K3f, one
    launch per frame, and K3 never launches; the outputs match the CPU
    plain path (velocities within 1e-5 m/s)."""
    cfg, env, frames = small
    env_cpu = headline_case()[1]
    outs = {}
    for where, e in (("cpu", env_cpu), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        step = tr.bind_env(e)
        st = tr.init_state()
        k3f0, k30 = centroid_cuda.circumcenter_features.launches, centroid_cuda.pair_stats.launches
        rows = []
        for buf, mask, t in frames[:4]:
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([x.cpu() for x in o])
        outs[where] = rows
        if where == "gpu":
            assert centroid_cuda.circumcenter_features.launches - k3f0 == 4
            assert centroid_cuda.pair_stats.launches == k30
    for rc, rg in zip(outs["cpu"], outs["gpu"]):
        for name, a, b in zip(FrameOutput._fields, rc, rg):
            if name == "vel":
                assert torch.allclose(a, b, rtol=0, atol=1e-5), name
            else:
                assert _bits(a, b), name


def _nan_canonical(tree):
    """Every NaN as one bit pattern: the CPU multiplies a NaN by 0 keeping
    its payload, the card gives its canonical NaN (the NaN lane's default
    pos/vel, ``det * 0``)."""
    if isinstance(tree, torch.Tensor):
        t = tree.cpu()
        return torch.where(torch.isnan(t), torch.nan, t) if t.is_floating_point() else t
    items = [_nan_canonical(x) for x in tree]
    return tuple(items) if type(tree) is tuple else type(tree)(*items)


def _same_tree(a, b) -> bool:
    """Every tensor of two (nested) tuples bit for bit."""
    if isinstance(a, torch.Tensor):
        return _bits(a, b)
    return all(_same_tree(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("K,B,S,D", [(64, 1, 1, 16), (64, 1, 8, 16), (64, 8, 1, 16),
                                     (64, 1, 8, 128), (1024, 1, 4, 128), (1024, 4, 1, 32)])
def test_k4_track_step_matches_plain(dev, small, K, B, S, D):
    """K4, the whole track step, against its plain version on the card:
    every state and output field bit for bit, one launch per call."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg, _, _ = small
    gains = Tracker(cfg, dev).gains_xy
    st, dets, valid, t = track_scene(K + B + S, cfg, K, D, B, S, (0,), dev)
    n0 = track_cuda.track_frames.launches
    got = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert track_cuda.track_frames.launches == n0 + 1
    want = track_cuda.track_frames_plain(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert _same_tree(got, want)


@pytest.mark.parametrize("k_max,c_max,backend", [(2048, 16, "auto"), (64, 256, "auto"),
                                                 (64, 16, "jnp")])
def test_f1_track_step_past_k4_bounds_launches_k4_xl(dev, small, k_max, c_max, backend):
    """Past K4's narrow builds (K > 1,024 slots, D > 128 detections) the
    track step launches K4 xl, and under ``assoc_backend="jnp"`` K4: one
    launch, no host sync, the CPU route's bits."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_batch
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state

    cfg, _, _ = small
    cfg = cfg.replace(assoc_backend=backend,
                      caps=dataclasses.replace(cfg.caps, k_max_tracks=k_max, c_max_clusters=c_max))
    st, dets, valid, t = track_scene(3, cfg, k_max, c_max, 1, 2, (), "cpu")
    kw = dict(config=cfg, gains_xy=Tracker(cfg, "cpu").gains_xy)
    want = track_batch(st, dets, valid, t, **kw)
    entry = "motl_track_step" if backend == "jnp" else "motl_track_step_xl"
    n0 = track_cuda.track_frames.launches_by[entry]
    syncs = track_cuda.track_step_plain.host_syncs
    got = track_batch(map_state(lambda x: x.to(dev), st), dets.to(dev), valid.to(dev),
                      t.to(dev), config=cfg, gains_xy=Tracker(cfg, dev).gains_xy)
    assert track_cuda.track_frames.launches_by[entry] == n0 + 1
    assert track_cuda.track_step_plain.host_syncs == syncs
    assert _same_tree(_nan_canonical(got), _nan_canonical(want))


def test_f2_accumulator_past_k1_bound_on_the_card(dev):
    """298,377 cells, past K1's and K5's 232,320-cell layouts: K1 and K5 in
    their wide layout (32 ranges) on the card, one launch each, no plain
    digit sums and no separate finalize, bit for bit the CPU route; 51,200
    points, so a point block tiles N and exact mode takes K5's route, not
    K6's."""
    from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
    from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid

    scene = SceneBounds(x_min=0.0, x_max=6.43, y_min=0.0, y_max=12.83, z_min=0.0, z_max=2.1)
    rng = np.random.default_rng(12)
    n = 51_200
    pts = np.stack([rng.uniform(-0.3, 6.7, n), rng.uniform(-0.3, 13.1, n),
                    rng.uniform(-0.2, 2.3, n)], 1).astype(np.float32)[None]
    mask = np.ones((1, n), bool)
    for quant in ("fast", "exact"):
        args = (scene, 0.05, 0.25)
        fin = (voxel_grid_cuda.finalize_fast_stacked if quant == "fast"
               else voxel_grid_cuda.finalize_exact_stacked)
        acc = (voxel_grid_cuda.accumulate_fast_stacked if quant == "fast"
               else voxel_grid_cuda.accumulate_exact_stacked)
        n_fin, n_acc = fin.launches, acc.launches
        routes = voxel_grid.digit_sums_stacked.plain_routes
        got = voxel_grid.voxel_accumulate_stacked(torch.from_numpy(pts).to(dev),
                                                  torch.from_numpy(mask).to(dev), *args, quant=quant)
        assert voxel_grid.digit_sums_stacked.plain_routes == routes
        want = voxel_grid.voxel_accumulate_stacked(torch.from_numpy(pts), torch.from_numpy(mask),
                                                   *args, quant=quant)
        assert _same_tree(got, want)
        assert got[0].shape[-1] == 298_377
        assert (fin.launches, acc.launches) == (n_fin, n_acc + 1)


@pytest.mark.parametrize("dims,leaf,leaf_z,cluster", [
    ((99, 226, 1), 0.06, 1.2, 2),           # F6: 22,374 cells, past one CTA, 2 CTAs
    ((128, 256, 1), 0.05, 2.0, None),       # the JAX fused CC's 32,768
    ((104, 225, 3), 0.05, 1.0, None),       # the CLI grid, 146 offsets
    ((96, 224, 9), 0.05, 1.0, None),        # the default scene: adjacency in global memory
])
def test_k2_clusters_match_plain(dev, dims, leaf, leaf_z, cluster):
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import k2_inputs

    accs, scal, br, bc, bits, kwin = k2_inputs(dims, leaf, leaf_z, 0.15, 1, dev)
    kw = dict(dims=dims, tol=0.15, leaf_xy=leaf, leaf_z=leaf_z, kwin=kwin, cluster=cluster)
    n0 = grid_cuda.fused_finalize_static_cc_stacked.launches
    got = grid_cuda.fused_finalize_static_cc_stacked(accs, scal, br, bc, bits, **kw)
    assert grid_cuda.fused_finalize_static_cc_stacked.launches == n0 + 1
    want = grid_cuda.fused_finalize_static_cc_stacked(accs.cpu(), scal.cpu(), br.cpu(), bc.cpu(),
                                                      bits.cpu(), **kw)
    assert _same_tree(got, want)


def test_f6_pallas_grid_cc_past_one_cta_on_the_card(dev, small):
    """``grid_cc="pallas"`` on a 22,374-cell grid plans K2 (a cluster of
    CTAs) on the card and its step matches the CPU route."""
    cfg, env, frames = small
    cfg = cfg.replace(grid_cc="pallas", voxel_leaf_size=0.06,
                      scene=dataclasses.replace(cfg.scene, x_max=3.5, y_max=12.0))
    env_cpu = headline_case()[1]
    outs = []
    for where, e in (("cpu", env_cpu), (dev, env)):
        tr = Tracker(cfg, where)
        assert tr.plan(e).k2
        step = tr.bind_env(e)
        st = tr.init_state()
        rows = []
        for buf, mask, t in frames[:3]:
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            rows.append(o)
        outs.append(rows)
    assert _same_tree(outs[0], outs[1])


@pytest.mark.parametrize("K,B,S,D", [(64, 1, 1, 16), (64, 1, 8, 32), (64, 8, 1, 16),
                                     (64, 1, 8, 128), (1024, 1, 4, 128), (1024, 4, 1, 32)])
def test_k4_ihgp_matches_plain(dev, small, K, B, S, D):
    """K4 under ``position_filter="ihgp"`` (a position pass chained before
    each velocity pass) against its plain version on the card: every state
    and output field bit for bit, one launch per call, at K = 64 (the
    128-thread build) and 1,024 (the 1,024-thread build)."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg = small[0].replace(position_filter="ihgp")
    gains = Tracker(cfg, dev).gains_xy
    st, dets, valid, t = track_scene(K + B + S + 1, cfg, K, D, B, S, (0,), dev)
    n0 = track_cuda.track_frames.launches
    got = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert track_cuda.track_frames.launches == n0 + 1
    want = track_cuda.track_frames_plain(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert _same_tree(got, want)
    lpf = track_cuda.track_frames(st, dets, valid, t, config=small[0], gains_xy=gains)[1]
    v = got[1].valid
    assert _bits(lpf.obj_id, got[1].obj_id) and _bits(lpf.valid, v)
    if bool(v.any()):                   # published lanes: ihgp positions are not LPF's
        assert not _bits(lpf.pos[v], got[1].pos[v])


def test_f7_k8a_at_a_ragged_m_on_the_card(dev):
    """F7: K8a takes M = 1,000 (the jnp CC's adjacency has no row rule):
    bit for bit its plain version, and the jnp CC through it gives the CPU's
    labels and sweeps; K8 at M = 1,000 raises, as the JAX Pallas wrapper."""
    import chip_smoke
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster

    pts, mask = chip_smoke.f7_points(np.random.default_rng(4), 2, 1000)
    p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    n0 = cluster_pallas.cc_adjacency.launches
    assert _bits(cluster_pallas.cc_adjacency(p, m, 0.15),
                 cluster_pallas.cc_adjacency_plain(p, m, 0.15))
    got = cluster.connected_components(p, m, 0.15, 32, 2)
    assert cluster_pallas.cc_adjacency.launches == n0 + 2
    assert _same_tree(got, cluster.connected_components(p.cpu(), m.cpu(), 0.15, 32, 2))
    with pytest.raises(ValueError, match="multiple of 256"):
        cluster_pallas.connected_components_pallas(p, m, 0.15)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_f7_past_max_rows_on_the_card(dev, backend):
    """F7: M = 8,448, past the 8,192 rows of the frame in shared memory: K8
    and K8a run with the frame in device memory, bit for bit their plain
    versions, and the point-list CC launches them once and gives the CPU
    route's clusters."""
    import chip_smoke
    from multiple_object_tracking_lidar_tpu_torch.ops import cluster

    pts, mask = chip_smoke.f7_points(np.random.default_rng(5), 1, cluster_pallas.MAX_ROWS + 256)
    p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    wrapper, plain = ((cluster_pallas.cc_adjacency, cluster_pallas.cc_adjacency_plain)
                      if backend == "jnp" else
                      (cluster_pallas.connected_components_pallas,
                       cluster_pallas.connected_components_pallas_plain))
    assert _bits(wrapper(p, m, 0.15), plain(p, m, 0.15))
    args = (0.15, 3, 300, 32, 384, 32, 2)
    n0 = wrapper.launches
    got = cluster.euclidean_cluster(p, m, *args, backend=backend)
    assert wrapper.launches == n0 + 1
    want = cluster.euclidean_cluster(torch.from_numpy(pts), torch.from_numpy(mask), *args,
                                     backend=backend)
    assert _same_tree(got, want) and int(want.n_clusters) >= 20


@pytest.mark.parametrize("golden", ["torch_cli_headline.json", "torch_cli_ihgp_headline.json"])
def test_cli_run_grid_on_the_card_matches_golden(dev, tmp_path, golden):
    """The port's CLI, ``run --backend grid`` on 16 headline frames replayed
    from an npz bag, on the card: its JSON lines within the JAX CLI's golden
    (``chip_smoke.cli_errors``), through K1, K2, K3f and K4."""
    import json
    import os

    import chip_smoke
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import SIM_MAP
    from multiple_object_tracking_lidar_tpu_torch.io.bag import record_bag

    sc = headline_case()[2]
    bag = str(tmp_path / "frames.npz")
    record_bag(bag, [sc.frame(k) for k in range(16)])
    argv = ["run", "--device", str(dev), "--map", SIM_MAP, "--backend", "grid", "--bag", bag,
            "--frames", "16"]
    if "ihgp" in golden:
        (tmp_path / "ihgp.yaml").write_text("position_filter: ihgp\n")
        argv += ["--config", str(tmp_path / "ihgp.yaml")]
    with open(os.path.join(os.path.dirname(__file__), "golden", golden), encoding="utf-8") as fh:
        ref = json.load(fh)
    chip_smoke.reset_counts()
    _, recs, _ = chip_smoke.run_cli(argv)
    counts = chip_smoke.read_counts()
    assert chip_smoke.cli_errors(recs, ref)[0] == []
    assert all(counts[k] > 0 for k in ("K1", "K2", "K3f", "K4")), counts
    assert counts["K4"] == 16 and counts[chip_smoke.PLAIN_SUMS] == 0


# ---------------------------------------------------------------------------
# association="hungarian": K12 and K4's Hungarian builds
# ---------------------------------------------------------------------------
def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("d,k,kind,max_iters", [
    (12, 10, "dense", 3000), (20, 6, "dense", 3000), (5, 30, "dense", 3000),
    (16, 16, "ties", 3000), (16, 16, "ties", 1), (32, 64, "sparse", 3000),
    (128, 1024, "sparse", 3000)])
def test_k12_matches_plain(dev, d, k, kind, max_iters):
    """K12 against ``auction_assign_plain`` on the card (on
    ``chip_smoke.auction_problem``'s dense, sparse and near-tie costs): the
    assigned columns, the saturated phases and every phase's iterations bit
    for bit, one launch per call; ``max_iters=1`` saturates; three stacked
    problems in one launch, each its own plain answer."""
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import auction_assign_plain

    rng = np.random.default_rng(d * 1000 + k + max_iters)
    eps, max_cost = (1e-4, 1.0) if kind == "ties" else (1e-3, 0.5)
    probs = [_chip_smoke().auction_problem(rng, d, k, kind) for _ in range(3 if k < 1024 else 1)]
    C = torch.from_numpy(np.stack([p[0] for p in probs])).to(dev)
    F = torch.from_numpy(np.stack([p[1] for p in probs])).to(dev)
    n0 = hungarian_cuda.auction_assign.launches
    a, sat, it = hungarian_cuda.auction_assign(C, F, eps, max_cost, max_iters, return_iters=True)
    assert hungarian_cuda.auction_assign.launches == n0 + 1
    for b in range(C.shape[0]):
        pa, ps, pit = auction_assign_plain(C[b], F[b], eps, max_cost, max_iters, return_iters=True)
        assert _bits(a[b], pa) and int(sat[b]) == int(ps) and it[b].tolist() == pit
    if max_iters == 1:
        assert int(sat.min()) > 0


@pytest.mark.parametrize("K,B,S,D,pf", [
    (64, 1, 1, 32, "lpf"), (64, 1, 8, 32, "lpf"), (64, 8, 1, 32, "lpf"), (64, 1, 8, 128, "lpf"),
    (64, 1, 8, 32, "ihgp"), (1024, 1, 1, 128, "lpf"), (1024, 1, 4, 32, "lpf"),
    (1024, 4, 1, 32, "lpf"), (1024, 1, 1, 128, "ihgp")])
def test_k4_hungarian_matches_plain(dev, small, K, B, S, D, pf):
    """K4's Hungarian builds against their plain version on the card:
    every state and output field bit for bit (``assoc_saturated`` among
    them), one launch per call, at K = 64 (the 128-thread build) and 1,024
    (the 1,024-thread build), 1 x 1, 1 x S and B x 1; the decisions differ
    from greedy's on these gated scenes, and one detection per track."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg = small[0].replace(association="hungarian", position_filter=pf)
    gains = Tracker(cfg, dev).gains_xy
    fresh = (0,) if B > 1 else ()       # an empty bank only registers: one of B, never a lone one
    st, dets, valid, t = track_scene(K + B + S + D, cfg, K, D, B, S, fresh, dev, gated=True)
    n0 = track_cuda.track_frames.launches
    got = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert track_cuda.track_frames.launches == n0 + 1
    want = track_cuda.track_frames_plain(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert _same_tree(_nan_canonical(got), _nan_canonical(want))
    greedy = track_cuda.track_frames(st, dets, valid, t, config=cfg.replace(association="greedy"),
                                     gains_xy=gains)[1]
    assert not _bits(greedy.obj_id, got[1].obj_id)
    ids, v = got[1].obj_id.cpu().numpy(), got[1].valid.cpu().numpy()
    assert all(len(ids[b, s][v[b, s]]) == len(set(ids[b, s][v[b, s]].tolist()))
               for b in range(B) for s in range(S))


def test_hungarian_route_ignores_assoc_backend_on_the_card(dev, small):
    """Under hungarian ``assoc_backend="jnp"`` still takes K4 (the JAX
    package passes the backend to greedy only); past K4's narrow builds
    (D = 256 detections) the Hungarian step launches K4 xl, bit for bit its
    plain version, and takes no plain route."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import track_batch

    cfg = small[0].replace(association="hungarian", assoc_backend="jnp")
    gains = Tracker(cfg, dev).gains_xy
    st, dets, valid, t = track_scene(9, cfg, 64, 32, 1, 2, (), dev, gated=True)
    n0 = track_cuda.track_frames.launches
    got = track_batch(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert track_cuda.track_frames.launches == n0 + 1
    want = track_cuda.track_frames_plain(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert _same_tree(_nan_canonical(got), _nan_canonical(want))
    cfg2 = cfg.replace(caps=dataclasses.replace(cfg.caps, c_max_clusters=256))
    st2, d2, v2, t2 = track_scene(10, cfg2, 64, 256, 1, 1, (), dev, gated=True)
    n0 = (track_cuda.track_frames.launches_by["motl_track_step_xl"],
          track_cuda.track_step_plain.host_syncs)
    got = track_batch(st2, d2, v2, t2, config=cfg2, gains_xy=gains)
    assert (track_cuda.track_frames.launches_by["motl_track_step_xl"],
            track_cuda.track_step_plain.host_syncs) == (n0[0] + 1, n0[1])
    want = track_cuda.track_frames_plain(st2, d2, v2, t2, config=cfg2, gains_xy=gains)
    assert _same_tree(_nan_canonical(got), _nan_canonical(want))


@pytest.mark.parametrize("case", ["hungarian", "dense_hungarian"])
def test_hungarian_bind_env_on_the_card_matches_golden(dev, case):
    """The headline and the dense scene under hungarian through
    ``bind_env`` on the card against their JAX goldens: decisions exact,
    floats within the goldens' tolerances in every lane, one K4 launch per
    frame."""
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import Frame

    chip_smoke = _chip_smoke()
    golden = dict(np.load(chip_smoke.GOLDEN_HUNGARIAN[case]))
    make = {"hungarian": bench_cases.hungarian_case,
            "dense_hungarian": bench_cases.dense_hungarian_case}[case]
    cfg, env, sc = make(device=dev)
    tracker = Tracker(cfg, dev)
    step, st = tracker.bind_env(env), tracker.init_state()
    n = golden["publish"].shape[0]
    n0 = track_cuda.track_frames.launches
    rows = []
    for k in range(n):
        pts, mask, t = bench_cases.padded_frame(sc, k, cfg.caps.n_max_points)
        st, out = step(st, Frame(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev),
                                 torch.tensor(t).to(dev)))
        rows.append(out)
    assert track_cuda.track_frames.launches == n0 + n
    got = {f: np.stack([getattr(r, f).cpu().numpy() for r in rows]) for f in golden}
    chip_smoke.compare(case, got, golden, chip_smoke.TOL_DETS, chip_smoke.TOL_VEL)


# ---------------------------------------------------------------------------
# dtype="float64": K2, K3f and K4 built for double
# ---------------------------------------------------------------------------
def test_k2_f64_matches_plain(dev, small):
    """K2's double build on K1's sums cast to f64 (and a frame of many
    components), every output bit for bit its plain version; one launch,
    counted as the double build's."""
    cfg, env, frames = small
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    accs, _ = voxel_grid_cuda.accumulate_fast_stacked(
        P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    accs = accs.double()
    coin = torch.from_numpy(np.random.default_rng(6).random(accs.shape[2]) < 0.5).to(dev)
    accs[6, 3] = torch.where(accs[6, 3] > 0, accs[6, 3], coin.double())
    plan = Tracker(cfg, dev).plan(env)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
              leaf_z=cfg.leaf_z, kwin=plan.table.k)
    w = grid_cuda.fused_finalize_static_cc_stacked
    n0, n64 = w.launches, w.launches_by["motl_grid_cc_f64"]
    k = w(accs, *tb, **kw)
    assert (w.launches, w.launches_by["motl_grid_cc_f64"]) == (n0, n64 + 1)
    assert k[0].dtype == torch.float64
    p = grid_cuda.fused_finalize_static_cc_stacked_plain(
        accs, *tb, dims=plan.dims, kwin=plan.table.k, max_sweeps=2 * sum(plan.dims),
        offsets=grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance,
                                         cfg.voxel_leaf_size, cfg.leaf_z),
        tol=cfg.cluster_tolerance)
    for a, b in zip(k, p):
        assert _bits(a, b)


@pytest.mark.parametrize("s,c,p", [(1, 32, 384), (8, 32, 384)])
def test_k3f_f64_matches_plain(dev, s, c, p):
    """K3f's double build on f64 member tables (random clusters, a lattice,
    a collinear slot, empty slots) bit for bit its plain version."""
    rng = np.random.default_rng(s * 100 + c)
    mp = rng.normal(0, 1, (s * c, p, 3))
    mm = np.zeros((s * c, p), bool)
    for i in range(s * c):
        mm[i, : int(rng.integers(0, p))] = i % 4 != 3
    mp[1, :9] = np.stack([0.25 * np.arange(9), 0.5 * np.arange(9), np.zeros(9)], 1)
    mm[1] = np.arange(p) < 9
    mp[2, :20] = np.round(mp[2, :20] * 10) / 10
    t = torch.arange(s, dtype=torch.float64, device=dev) * 0.1 + 1e-12
    MP, MM = torch.from_numpy(mp).to(dev), torch.from_numpy(mm).to(dev)
    n64 = centroid_cuda.circumcenter_features.launches_by["motl_circumcenter_features_f64"]
    got = centroid_cuda.circumcenter_features(MP, MM, t)
    assert centroid_cuda.circumcenter_features.launches_by["motl_circumcenter_features_f64"] == (
        n64 + 1)
    assert got.dtype == torch.float64
    assert _bits(got, centroid_cuda.circumcenter_features_plain(MP, MM, t))


@pytest.mark.parametrize("K,B,S,D,pf,assoc", [
    (64, 1, 1, 16, "lpf", "greedy"), (64, 1, 8, 32, "ihgp", "greedy"),
    (64, 8, 1, 16, "lpf", "greedy"), (1024, 1, 4, 128, "lpf", "greedy"),
    (64, 1, 8, 32, "lpf", "hungarian"), (64, 8, 1, 16, "ihgp", "hungarian"),
    (1024, 1, 1, 128, "ihgp", "hungarian")])
def test_k4_f64_matches_plain(dev, small, K, B, S, D, pf, assoc):
    """K4's double builds (greedy and Hungarian, lpf and ihgp) on f64
    inputs, every state and output field bit for bit their plain version,
    one launch per call."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg, _, _ = small
    cfg = cfg.replace(dtype="float64", position_filter=pf, association=assoc)
    gains = Tracker(cfg, dev).gains_xy
    st, dets, valid, t = track_scene(K + B + S, cfg, K, D, B, S, (0,), dev,
                                     gated=assoc == "hungarian")
    st = st._replace(bank=st.bank._replace(window=st.bank.window.double(),
                                           m0=st.bank.m0.double()))
    dets, t = dets.double(), t.double()
    by = track_cuda.track_frames.launches_by
    n0, n64 = track_cuda.track_frames.launches, by["motl_track_step_f64"]
    got = track_cuda.track_frames(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert (track_cuda.track_frames.launches, by["motl_track_step_f64"]) == (n0, n64 + 1)
    want = track_cuda.track_frames_plain(st, dets, valid, t, config=cfg, gains_xy=gains)
    assert got[0].bank.window.dtype == torch.float64 and _same_tree(got, want)


def test_k4_hungarian_f64_past_k4_bounds_matches_plain(dev, small):
    """As in f32, a Hungarian f64 step past K4's 128 detections launches K4
    xl's double build, bit for bit its plain version."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg, _, _ = small
    cfg = cfg.replace(dtype="float64", association="hungarian")
    st, dets, valid, t = track_scene(7, cfg, 64, 256, 1, 1, (), dev, gated=True)
    st = st._replace(bank=st.bank._replace(window=st.bank.window.double(),
                                           m0=st.bank.m0.double()))
    args = (st, dets.double(), valid, t.double())
    kw = dict(config=cfg, gains_xy=Tracker(cfg, dev).gains_xy)
    by = track_cuda.track_frames.launches_by
    n0 = by["motl_track_step_xl_f64"]
    got = track_cuda.track_frames(*args, **kw)
    assert by["motl_track_step_xl_f64"] == n0 + 1
    assert _same_tree(_nan_canonical(got), _nan_canonical(track_cuda.track_frames_plain(*args, **kw)))


def test_f64_slice_gpu_matches_cpu_plain_path(dev, small):
    """``bind_env`` under f64 on the card (K1, then K2, K3f and K4's double
    builds, no f32 build of them) against the CPU plain path: every field
    bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg, env, frames = small
    cfg = cfg.replace(dtype="float64")
    env_cpu = headline_case()[1]
    outs = {}
    counts = (grid_cuda.fused_finalize_static_cc_stacked, centroid_cuda.circumcenter_features,
              track_cuda.track_frames)
    for where, e in (("cpu", env_cpu), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        step, st = tr.bind_env(e), tr.init_state()
        f64_entries = ("motl_grid_cc_f64", "motl_circumcenter_features_f64", "motl_track_step_f64")
        before = [(w.launches, w.launches_by[e]) for w, e in zip(counts, f64_entries)]
        rows = []
        for buf, mask, t in frames[:7]:
            st, o = step(st, Frame(torch.from_numpy(buf), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([x.cpu() for x in o])
        outs[where] = rows
        if where == "gpu":
            after = [(w.launches, w.launches_by[e]) for w, e in zip(counts, f64_entries)]
            assert all(a[0] == b[0] and a[1] == b[1] + 7 for a, b in zip(after, before))
    for rc, rg in zip(outs["cpu"], outs["gpu"]):
        for name, a, b in zip(FrameOutput._fields, rc, rg):
            assert _bits(a, b), name


@pytest.mark.parametrize("route", ["grid_cc_jnp", "no_cell_table", "past_k2", "past_k1",
                                   "greedy_past_k4", "assoc_backend_jnp"])
def test_f64_plain_routes_run_kernels_on_the_card(dev, small, monkeypatch, route):
    """Every f64 stage on the card is a kernel where a plain route once ran
    or raised: the stencil CC without K2 (K14's double build), the digit
    sums past K1's 232,320-cell layouts (K1 wide), the greedy step past K4's
    narrow builds (K4 xl's double build) or under assoc_backend="jnp" (K4):
    bit for bit the CPU's plain versions."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import stencil_cc_cuda, track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker import pipeline
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state

    cfg, env, frames = small
    cfg = cfg.replace(dtype="float64")
    by = track_cuda.track_frames.launches_by
    if route in ("greedy_past_k4", "assoc_backend_jnp"):
        k, d = (1025, 16) if route == "greedy_past_k4" else (64, 16)
        entry = "motl_track_step_xl_f64" if route == "greedy_past_k4" else "motl_track_step_f64"
        if route == "assoc_backend_jnp":
            cfg = cfg.replace(assoc_backend="jnp")
        st, dets, valid, t = track_scene(3, cfg, k, d, 1, 1, (), "cpu")
        st = st._replace(bank=st.bank._replace(window=st.bank.window.double(),
                                               m0=st.bank.m0.double()))
        args = (st, dets.double(), valid, t.double())
        want = pipeline.track_batch(*args, config=cfg, gains_xy=Tracker(cfg, "cpu").gains_xy)
        n0 = by[entry]
        got = pipeline.track_batch(map_state(lambda x: x.to(dev), args[0]),
                                   *(x.to(dev) for x in args[1:]), config=cfg,
                                   gains_xy=Tracker(cfg, dev).gains_xy)
        assert by[entry] == n0 + 1
        assert _same_tree(_nan_canonical(got), _nan_canonical(want))
        return
    if route == "past_k1":
        from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
        from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid

        scene = SceneBounds(x_min=0.0, x_max=6.43, y_min=0.0, y_max=12.83, z_min=0.0, z_max=2.1)
        rng = np.random.default_rng(13)
        pts = torch.from_numpy(np.stack([rng.uniform(-0.3, 6.7, 51_200),
                                         rng.uniform(-0.3, 13.1, 51_200),
                                         rng.uniform(-0.2, 2.3, 51_200)], 1).astype(np.float32))
        mask = torch.ones(51_200, dtype=torch.bool)
        n0 = voxel_grid_cuda.accumulate_fast_stacked.launches
        got = voxel_grid.voxel_accumulate_stacked(pts[None].to(dev), mask[None].to(dev), scene,
                                                  0.05, 0.25, quant="fast")
        assert voxel_grid_cuda.accumulate_fast_stacked.launches == n0 + 1
        assert _same_tree(got, voxel_grid.voxel_accumulate_stacked(pts[None], mask[None], scene,
                                                                  0.05, 0.25, quant="fast"))
        return
    kw = {}
    if route == "grid_cc_jnp":
        cfg = cfg.replace(grid_cc="jnp")
    elif route == "no_cell_table":
        kw = {"cell_table": False}
    else:
        monkeypatch.setattr(pipeline, "fused_cc_fits", lambda *a: False)
    outs = {}
    k14 = stencil_cc_cuda.stencil_cc.launches_by
    for where, e in (("cpu", headline_case()[1]), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        plan = tr.plan(e, **kw)
        assert not plan.k2
        n0 = k14["motl_stencil_cc_f64"]
        fr = Frame(*(torch.stack([torch.as_tensor(np.asarray(f[i])) for f in frames[:3]])
                     for i in range(3)))
        p = tr.perceive(tr._frame(fr), plan)
        outs[where] = [x.cpu() for x in p]
        if where == "gpu":
            assert k14["motl_stencil_cc_f64"] == n0 + 1
    for a, b in zip(outs["cpu"], outs["gpu"]):
        assert _bits(a, b)


# ---------------------------------------------------------------------------
# dtype="float64" off the dense grid's fast digits: K6f, K8a and K2 fed f32
# sums built for double
# ---------------------------------------------------------------------------
def _f64(a, seed):
    """f64 copy of f32 points with noise below f32's resolution."""
    return torch.from_numpy(a.astype(np.float64)
                            + np.random.default_rng(seed).normal(0, 1e-9, a.shape))


def test_k6f_double_build_matches_plain(dev, small):
    """K6f's double build on f64 points (the adversarial frame 7 included)
    and on configuration G's grid: bit for bit its plain version, counted
    in ``.launches_by["motl_voxel_sums_f64"]``."""
    cfg, _, frames = small
    P = _f64(np.stack([f[0] for f in frames]), 1).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    w = voxel_grid_cuda.accumulate_f32_stacked
    by = w.launches_by
    gcfg, _, gsc = bench_cases.default_case()
    gp = np.stack([gsc.frame_arrays(s)[0][::3][:32768] for s in range(2)])
    GP, GM = _f64(gp, 2).to(dev), torch.ones((2, 32768), dtype=torch.bool, device=dev)
    for P_, M_, c in ((P, M, cfg), (GP, GM, gcfg)):
        kw = (c.scene, c.voxel_leaf_size, c.leaf_z)
        n0, n64 = w.launches, by["motl_voxel_sums_f64"]
        k = w(P_, M_, *kw)
        assert (w.launches, by["motl_voxel_sums_f64"]) == (n0, n64 + 1)
        assert k[0].dtype == torch.float64
        p = voxel_grid_cuda.accumulate_f32_stacked_plain(P_.cpu(), M_.cpu(), *kw)
        assert _bits(k[0], p[0]) and _bits(k[1], p[1])


def test_k8a_double_build_matches_plain(dev, small):
    """K8a's double build on f64 point lists: C's M = 1,024 rows of the
    small frames, G's M = 2,048, and M = 6,144 past 4,096 rows (the f64
    frame in device memory, where the f32 one stays in shared memory), bit
    for bit its plain version; one launch each."""
    rng = np.random.default_rng(14)
    w = cluster_pallas.cc_adjacency
    for s, m, spread in ((8, 1024, 0.8), (2, 2048, 1.5), (1, 6144, 2.0)):
        pts = torch.from_numpy(rng.normal(0, spread, (s, m, 3))).to(dev)
        pts[..., 2] *= 0.1
        msk = torch.from_numpy(rng.random((s, m)) < 0.8).to(dev)
        n64 = w.launches_by["motl_cc_adjacency_f64"]
        got = w(pts, msk, 0.15)
        assert w.launches_by["motl_cc_adjacency_f64"] == n64 + 1
        assert cluster_pallas._layout(m, None, dev, torch.float64)[2] == (m > 4096)
        want = cluster_pallas.cc_adjacency_plain(pts.cpu(), msk.cpu(), 0.15)
        assert torch.equal(got.cpu(), want) and int(want.sum()) > s * m


def test_k2_double_build_fed_f32_sums_matches_plain(dev, small):
    """K2 fed the runs' f32 sums under f64 (finalize in f32, widen, f64
    d^2): bit for bit its plain version, counted in
    ``.launches_by["motl_grid_cc_f64_f32sums"]``, and not the f64
    division's centroids."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_pallas import (
        voxel_accumulate_runs_stacked)

    cfg, env, frames = small
    cfg = cfg.replace(voxel_mode="runs", dtype="float64")
    plan = Tracker(cfg, dev).plan(env)
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    acc, _ = voxel_accumulate_runs_stacked(P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
              leaf_z=cfg.leaf_z, kwin=plan.table.k)
    w = grid_cuda.fused_finalize_static_cc_stacked
    by = w.launches_by
    n0, n64, nfs = w.launches, by["motl_grid_cc_f64"], by["motl_grid_cc_f64_f32sums"]
    k = w(acc, *tb, dtype=torch.float64, **kw)
    assert (w.launches, by["motl_grid_cc_f64"], by["motl_grid_cc_f64_f32sums"]) == (
        n0, n64, nfs + 1)
    cpu_tb = tuple(t.cpu() for t in tb)
    p = grid_cuda.fused_finalize_static_cc_stacked(acc.cpu(), *cpu_tb, dtype=torch.float64, **kw)
    assert k[0].dtype == torch.float64 and all(_bits(a, b) for a, b in zip(k, p))
    wide = w(acc.double(), *tb, **kw)[0]
    assert not torch.equal(wide, k[0])


F64_PATHS = {   # fields: the double builds (and the f32 kernels) each must launch
    "dense-jnp": ({"voxel_mode": "dense", "cluster_backend": "jnp"},
                  ("K6f f64", "K8a f64")),
    "dense-pallas": ({"voxel_mode": "dense", "cluster_backend": "pallas"},
                     ("K6f f64", "K8")),
    "scan-jnp": ({"voxel_mode": "scan", "cluster_backend": "jnp"}, ("K8a f64",)),
    "runs-pallas": ({"voxel_mode": "runs", "cluster_backend": "pallas"}, ("K7", "K8")),
    "exact-grid": ({"voxel_mode": "onehot", "cluster_backend": "grid", "voxel_quant": "exact"},
                   ("K6f f64", "K2 f64")),
    "runs-grid": ({"voxel_mode": "runs", "cluster_backend": "grid"},
                  ("K7", "K2 f64 f32-sums")),
}


@pytest.mark.parametrize("name", list(F64_PATHS))
def test_f64_pointlist_and_modes_gpu_match_cpu_plain_path(dev, small, name):
    """``bind_env`` under f64 on the card for the point list and the exact
    and runs modes against the CPU plain path, every field bit for bit,
    with the double builds launched (K7 and K8 in f32 where the JAX route
    is f32) and no f32 build of K2, K3f, K4, K6f or K8a."""
    chip_smoke = _chip_smoke()
    fields, need = F64_PATHS[name]
    cfg, env, frames = small
    cfg = cfg.replace(dtype="float64", **fields)
    if cfg.cluster_backend != "grid":
        cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, m_max_voxels=2048,
                                                   m_max_dynamic=1024))
    outs = {}
    for where, e in (("cpu", headline_case()[1]), ("gpu", env)):
        tr = Tracker(cfg, "cpu" if where == "cpu" else dev)
        step, st = tr.bind_env(e), tr.init_state()
        if where == "gpu":
            chip_smoke.reset_counts()
        rows = []
        for buf, mask, t in frames[:6]:
            st, o = step(st, Frame(_f64(buf, 3), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([x.cpu() for x in o])
        outs[where] = rows
    counts = chip_smoke.read_counts()
    assert all(counts[k] > 0 for k in need + ("K3f f64", "K4 f64")), counts
    assert not any(counts[k] for k in chip_smoke.F32_BUILDS), counts
    for rc, rg in zip(outs["cpu"], outs["gpu"]):
        for f, a, b in zip(FrameOutput._fields, rc, rg):
            assert _bits(a, b), (name, f)


def test_f64_vmap_fleet_on_a_grid_config_runs_on_the_card(dev, small):
    """The f64 vmap fleet (JAX's kernel fleet is f32 only) plans the dense
    grid with no per-cell table: on the card its stencil CC is K14's double
    build, one launch a step for both streams, and each step is bit for
    bit the fleet's route on the CPU (K6f's f64 sums, the finalize, the
    per-point static drop, the stencil CC, K3f and K4)."""
    from multiple_object_tracking_lidar_tpu_torch.ops import stencil_cc_cuda
    from multiple_object_tracking_lidar_tpu_torch.parallel import ShardedTracker, make_mesh
    from multiple_object_tracking_lidar_tpu_torch.tracker.pipeline import (
        perceive_from_acc_stacked, track_batch)
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import voxel_accumulate_stacked

    cfg, env, frames = small
    cfg = cfg.replace(dtype="float64")
    fleet = ShardedTracker(Tracker(cfg, dev), make_mesh(1, 1))
    assert not fleet._use_kernel_fleet
    step = fleet.bind_env(env)
    state = fleet.init_state(2)
    tcpu = Tracker(cfg, "cpu")
    plan = tcpu.plan(headline_case()[1], cell_table=False)
    cstate = tcpu.init_state(batch=2)
    by = stencil_cc_cuda.stencil_cc.launches_by
    for k in range(2):
        P = torch.from_numpy(np.stack([frames[k][0], frames[k + 2][0]]))
        M = torch.from_numpy(np.stack([frames[k][1], frames[k + 2][1]]))
        T = torch.tensor([frames[k][2], frames[k + 2][2]])
        n0 = by["motl_stencil_cc_f64"]
        state, o = step(state, P.to(dev), M.to(dev), T.to(dev))
        assert by["motl_stencil_cc_f64"] == n0 + 1
        accs, npts = voxel_accumulate_stacked(P.double(), M, cfg.scene, cfg.voxel_leaf_size,
                                              cfg.leaf_z)
        p = perceive_from_acc_stacked(accs, T.double(), npts, plan, config=cfg)
        cstate, co = track_batch(cstate, p.dets[:, None], p.det_valid[:, None], p.t[:, None],
                                 config=cfg, gains_xy=tcpu.gains_xy)
        for f in ("valid", "obj_id", "pos", "vel", "new_track", "n_alive"):
            assert _bits(getattr(o, f).cpu(), getattr(co, f)[:, 0]), f
        assert _bits(o.raw_centroid.cpu(), p.dets) and _bits(o.n_clusters.cpu(), p.n_clusters)


# ---------------------------------------------------------------------------
# the learning mode: K13
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["headline node", "tune default", "wide node", "wide tune",
                                   "one window", "half mask", "edges", "W + 1", "nine CTAs"])
def test_k13_matches_plain(dev, shape, monkeypatch):
    """K13 against ``learning_step_plain`` on the card at
    ``chip_smoke.K13_SHAPES``: the new log-parameters and the NLL bit for
    bit (every product, sum and FMA spelled on both sides; exp and log are
    the same polynomials, no transcendental of the card's library), one
    launch per call; ``learning_step`` / ``learning_step_stacked`` on CUDA
    tensors launch it and never the plain version."""
    from multiple_object_tracking_lidar_tpu_torch.models import learning as TL
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda

    cs = _chip_smoke()
    label, a, b, t, mask, lls = next(s for s in cs.K13_SHAPES if s[0] == shape)
    L, Y, M = cs.k13_inputs(np.random.default_rng(a * 100000 + b * 100 + t), dev, a, b, t,
                            mask, lls)
    pn, pl = TL.learning_step_plain(L, Y, M, cs.K13_DT)

    def no_plain(*args, **kw):
        raise AssertionError("the plain learning step ran on the card")

    monkeypatch.setattr(TL, "learning_step_plain", no_plain)
    n0 = learning_cuda.learning_step_cuda.launches
    new, nll = TL.learning_step_stacked(L, Y, M, cs.K13_DT)
    assert learning_cuda.learning_step_cuda.launches == n0 + 1
    assert _bits(new, pn) and _bits(nll, pl)
    n1, l1 = TL.learning_step(L[0], Y[0], M[0], cs.K13_DT)
    assert _bits(n1, pn[0]) and _bits(l1, pl[0])
    if lls is not None:
        assert torch.isnan(nll[0]) and new[0].tolist() == [-5.5, 0.0, 0.0]


def test_k13_raises_past_its_bounds(dev):
    """The wrapper raises ValueError past its bounds (no window, no step,
    more than MAX_WINDOWS windows), on f64 inputs and on tensors off the
    card; no plain route on the card."""
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda

    lp = torch.zeros(1, 3, device=dev)
    cases = [(torch.zeros(1, 0, 5, device=dev), torch.ones(1, 0, dtype=torch.bool, device=dev)),
             (torch.zeros(1, 4, 0, device=dev), torch.ones(1, 4, dtype=torch.bool, device=dev)),
             (torch.zeros(1, learning_cuda.MAX_WINDOWS + 1, 1, device=dev),
              torch.ones(1, learning_cuda.MAX_WINDOWS + 1, dtype=torch.bool, device=dev))]
    for y, m in cases:
        with pytest.raises(ValueError, match="K13"):
            learning_cuda.learning_step_cuda(lp, y, m, 0.1)
    y, m = torch.zeros(1, 4, 5, device=dev), torch.ones(1, 4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="float32"):
        learning_cuda.learning_step_cuda(lp.double(), y.double(), m, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        learning_cuda.learning_step_cuda(lp, y, m.cpu(), 0.1)


def test_learning_node_matches_golden(dev):
    """The headline TrackerNode with ``param_fix=False`` on the card
    against tests/golden/torch_learning_headline.npz (chip_smoke's
    tolerances), one K13 launch per update."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    cs = _chip_smoke()
    golden = dict(np.load(cs.GOLDEN_LEARNING))
    cfg, _, sc = headline_case(device=dev)
    node = TrackerNode(cfg.replace(param_fix=False, learn_period=0.2), dev, keep_outputs=True)
    node.on_map(load_sim_grid())
    n0 = learning_cuda.learning_step_cuda.launches
    upd, lps = [], []
    for k in range(golden["publish"].shape[0]):
        h = len(node.nll_history)
        node.on_pointcloud(sc.frame(k))
        if len(node.nll_history) > h:
            upd.append(k)
            lps.append(np.stack([node.log_params["x"], node.log_params["y"]]))
    assert learning_cuda.learning_step_cuda.launches - n0 == len(upd)
    assert upd == golden["update_frame"].tolist()
    np.testing.assert_allclose(np.asarray(lps), golden["log_params"], rtol=0,
                               atol=cs.TOL_LEARN_LP)
    np.testing.assert_allclose(np.asarray(node.nll_history), golden["nll_history"], rtol=0,
                               atol=cs.TOL_LEARN_NLL)
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
    for f in ("obj_id", "valid", "n_alive", "publish"):
        np.testing.assert_array_equal(got[f], golden[f], err_msg=f)
    v = golden["valid"]
    np.testing.assert_allclose(got["pos"][v], golden["pos"][v], rtol=0, atol=cs.TOL_DETS)
    np.testing.assert_allclose(got["vel"][v], golden["vel"][v], rtol=0, atol=cs.TOL_VEL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plain_auction_graph_chunks_match_the_host(dev, dtype):
    """The plain auction on CUDA tensors replays each full chunk of
    ``CHECK_EVERY`` iterations as one CUDA graph: its assignment, saturated
    phases, iterations per phase and dummy-only ones equal the same
    auction's on a host copy, on the scenes' own problems, converged and
    capped mid-chunk."""
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian as th

    cs = _chip_smoke()
    sc = np.load(cs.AUCTION_PROBLEMS_NPZ)
    for scene in ("headline", "dense"):
        C = torch.from_numpy(sc[f"{scene}_cost"][0]).to(dtype)
        F = torch.from_numpy(sc[f"{scene}_feas"][0])
        for max_iters in (3000, 70):
            args = (th.EPS, float(sc[f"{scene}_thr"]), max_iters)
            g = th.auction_assign_plain(C.to(dev), F.to(dev), *args, return_split=True)
            h = th.auction_assign_plain(C, F, *args, return_split=True)
            assert torch.equal(g[0].cpu(), h[0]) and int(g[1]) == int(h[1])
            assert g[2] == h[2] and g[3] == h[3]


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_half_learning_node_matches_golden(dev, h):
    """The headline TrackerNode with ``param_fix=False`` under bf16 / f16 on
    the card against tests/golden/torch_{bf16,f16}_learning_headline.npz,
    bit for bit (every frame, the update frames, the log-parameters, the
    NLL); one K13 launch per update and one K4 half build per frame."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import load_sim_grid
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda, track_cuda
    from multiple_object_tracking_lidar_tpu_torch.runtime.node import TrackerNode

    cs = _chip_smoke()
    golden = dict(np.load(cs.GOLDEN_HALF_LEARNING[h]))
    cfg, _, sc = headline_case(device=dev)
    cfg = cfg.replace(param_fix=False, learn_period=0.2,
                      dtype={"bf16": "bfloat16", "f16": "float16"}[h])
    node = TrackerNode(cfg, dev, keep_outputs=True)
    node.on_map(load_sim_grid())
    n0 = learning_cuda.learning_step_cuda.launches
    k0 = track_cuda.track_frames.launches_by[f"motl_track_step_{h}"]
    upd, lps = [], []
    n = golden["publish"].shape[0]
    for k in range(n):
        c = len(node.nll_history)
        node.on_pointcloud(sc.frame(k))
        if len(node.nll_history) > c:
            upd.append(k)
            lps.append(np.stack([node.log_params["x"], node.log_params["y"]]))
    assert learning_cuda.learning_step_cuda.launches - n0 == len(upd)
    assert track_cuda.track_frames.launches_by[f"motl_track_step_{h}"] - k0 == n
    assert upd == golden["update_frame"].tolist()
    np.testing.assert_array_equal(np.asarray(lps), golden["log_params"])
    np.testing.assert_array_equal(np.asarray(node.nll_history), golden["nll_history"])
    got = {f: np.stack([getattr(o, f) for o in node.outputs]) for f in node.outputs[0]._fields}
    v = golden["valid"]
    for f, r in golden.items():
        if f in cs.LEARN_FIELDS:
            continue
        g = got[f][v] if f in ("pos", "vel") else got[f]
        np.testing.assert_array_equal(g, r[v] if f in ("pos", "vel") else r, err_msg=f)


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_half_tune_matches_golden(dev, h, tmp_path):
    """The CLI's ``tune`` at its defaults with a config file setting bf16 /
    f16, on the card, against tests/golden/torch_cli_{bf16,f16}_tune.json:
    every record exactly, one K13 launch per step."""
    import json
    import os

    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda

    cs = _chip_smoke()
    with open(cs.GOLDEN_HALF_TUNE[h], encoding="utf-8") as fh:
        gt = json.load(fh)
    cfg_file = tmp_path / "config.yaml"
    cfg_file.write_text(gt["argv"][-1][1:-1] + "\n")
    argv = [os.path.join(cs.HERE, a) if a.endswith(".yaml") else a
            for a in gt["argv"][:-1]] + [str(cfg_file), "--device", "cuda"]
    n0 = learning_cuda.learning_step_cuda.launches
    _, recs, _ = cs.run_cli(argv)
    assert recs == gt["records"]
    assert learning_cuda.learning_step_cuda.launches - n0 == len(recs)


# ---------------------------------------------------------------------------
# the auction's kept summaries and dummy-only iterations; K14's cluster sizes
# ---------------------------------------------------------------------------
def test_k12_split_net_ties_and_stretches_match_plain(dev):
    """K12 on the net-tie problem (distinct f32 prices of one dummy net)
    and on dummy-only stretches cut by evictions (D = 8, K = 300): the
    assignment, saturated phases, iterations per phase and the dummy-only
    ones among them equal the plain version's count."""
    from multiple_object_tracking_lidar_tpu_torch.ops import hungarian_cuda
    from multiple_object_tracking_lidar_tpu_torch.ops.hungarian import auction_assign_plain

    cs = _chip_smoke()
    rng = np.random.default_rng(17)
    for cost, feas in (cs.net_tie_costs(), cs.stretch_costs(rng, 8, 300, 0.01)):
        C, F = torch.from_numpy(cost).to(dev), torch.from_numpy(feas).to(dev)
        a, sat, it, fast = hungarian_cuda.auction_assign(C, F, 1e-3, 0.5, return_split=True)
        pa, ps, pit, pfast = auction_assign_plain(C, F, 1e-3, 0.5, return_split=True)
        assert _bits(a, pa) and int(sat) == int(ps)
        assert it.tolist() == pit and fast.tolist() == pfast and sum(pfast) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k14_every_cluster_size_matches_plain(dev, dtype):
    """K14 at 1, 2, 4, 8 and 16 CTAs per frame (those the card grants) on
    two frames of blobs over a 37 x 23 x 3 grid, converged and at
    max_iters = 1: labels, n_sweeps and saturated bit for bit the plain
    version, one launch each."""
    from multiple_object_tracking_lidar_tpu_torch.ops import stencil_cc_cuda as k14
    from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import kernel_offsets
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel import in_dtype

    dims, tol = (37, 23, 3), 0.15
    cent, dyn = _chip_smoke().k14_grid_frames(np.random.default_rng(5), dims, 2)
    C, D = torch.from_numpy(cent).to(dev).to(dtype), torch.from_numpy(dyn).to(dev)
    offs = kernel_offsets(dims, tol, 0.05, 1.0)
    for mi in (32, 1):
        ref = k14.stencil_cc_plain(C, D, dims, offs, in_dtype(tol * tol, dtype), mi, 2, 2)
        for cl in (1, 2, 4, 8, 16):
            if cl > k14.cluster_size(1 << 30, dev):
                continue
            n0 = sum(k14.stencil_cc.launches_by.values())
            got = k14.stencil_cc(C, D, dims, tol, 0.05, 1.0, mi, 2, 2, cluster=cl)
            assert sum(k14.stencil_cc.launches_by.values()) == n0 + 1
            assert all(torch.equal(x, y) for x, y in zip(got, ref)), (cl, mi)


# ---------------------------------------------------------------------------
# dtype="bfloat16" / "float16": K2, K14, K3f, K4 and K4 xl built for half
# ---------------------------------------------------------------------------
HALF_CUDA = {"bf16": torch.bfloat16, "f16": torch.float16}


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_k2_and_k14_half_match_plain(dev, small, h):
    """K2's half build on K1's sums rounded to the half dtype, then K14's
    half build on its centroids, every output bit for bit its plain
    version; one launch each, counted as the half build's."""
    from multiple_object_tracking_lidar_tpu_torch.ops import stencil_cc_cuda

    cfg, env, frames = small
    dt = HALF_CUDA[h]
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev).to(dt).float()
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    accs, _ = voxel_grid_cuda.accumulate_fast_stacked(
        P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    accs = accs.to(dt)
    plan = Tracker(cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[h]), dev).plan(env)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
              leaf_z=cfg.leaf_z, kwin=plan.table.k)
    w = grid_cuda.fused_finalize_static_cc_stacked
    n0 = w.launches_by[f"motl_grid_cc_{h}"]
    k = w(accs, *tb, **kw)
    assert w.launches_by[f"motl_grid_cc_{h}"] == n0 + 1 and k[0].dtype == dt
    p = grid_cuda.fused_finalize_static_cc_stacked_plain(
        accs.cpu(), *(x.cpu() for x in tb), dims=plan.dims, kwin=plan.table.k,
        max_sweeps=2 * sum(plan.dims), tol=cfg.cluster_tolerance,
        offsets=grid_cuda.kernel_offsets(plan.dims, cfg.cluster_tolerance,
                                         cfg.voxel_leaf_size, cfg.leaf_z))
    for a, b in zip(k, p):
        assert _bits(a.float() if a.is_floating_point() else a,
                     b.float() if b.is_floating_point() else b)
    caps = cfg.caps
    args = (plan.dims, cfg.cluster_tolerance, cfg.voxel_leaf_size, cfg.leaf_z,
            caps.label_prop_iters, caps.grid_sweeps_per_iter, caps.grid_jumps_per_iter)
    s = stencil_cc_cuda.stencil_cc
    n0 = s.launches_by[f"motl_stencil_cc_{h}"]
    got = s(k[0], k[1], *args)
    assert s.launches_by[f"motl_stencil_cc_{h}"] == n0 + 1
    want = s(k[0].cpu(), k[1].cpu(), *args)
    for a, b in zip(got, want):
        assert _bits(a, b)


@pytest.mark.parametrize("h", ["bf16", "f16"])
@pytest.mark.parametrize("s,c,p", [(1, 32, 384), (8, 32, 64)])
def test_k3f_half_matches_plain(dev, h, s, c, p):
    """K3f's half build on half member tables (random clusters, a lattice,
    a collinear slot, empty slots) bit for bit its plain version
    (``circumcenter_features_half_plain``)."""
    dt = HALF_CUDA[h]
    rng = np.random.default_rng(s * 100 + c + p)
    mp = rng.normal(0, 1, (s * c, p, 3))
    mm = np.zeros((s * c, p), bool)
    for i in range(s * c):
        mm[i, : int(rng.integers(0, p))] = i % 4 != 3
    mp[1, :9] = np.stack([0.25 * np.arange(9), 0.5 * np.arange(9), np.zeros(9)], 1)
    mm[1] = np.arange(p) < 9
    MP = torch.from_numpy(mp).to(dt).to(dev)
    MM = torch.from_numpy(mm).to(dev)
    t = (torch.arange(s, device=dev) * 0.1 + 100.0).to(dt)
    by = centroid_cuda.circumcenter_features.launches_by
    n0 = by[f"motl_circumcenter_features_{h}"]
    got = centroid_cuda.circumcenter_features(MP, MM, t)
    assert by[f"motl_circumcenter_features_{h}"] == n0 + 1 and got.dtype == dt
    want = centroid_cuda.circumcenter_features_half_plain(MP.cpu(), MM.cpu(), t.cpu())
    assert _bits(got.float(), want.float())


@pytest.mark.parametrize("h", ["bf16", "f16"])
@pytest.mark.parametrize("K,B,S,D,pf", [
    (64, 1, 1, 16, "lpf"), (64, 1, 8, 32, "ihgp"), (64, 8, 1, 16, "lpf"),
    (1024, 1, 4, 128, "lpf"), (2048, 1, 2, 32, "ihgp")])
def test_k4_half_matches_plain(dev, small, h, K, B, S, D, pf):
    """K4's half builds (K4 xl's past 1,024 slots), lpf and ihgp, on half
    inputs: every state and output field bit for bit the plain version on
    the CPU; one launch per call."""
    from multiple_object_tracking_lidar_tpu_torch.bench_cases import track_scene
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda
    from multiple_object_tracking_lidar_tpu_torch.tracker.state import map_state

    cfg, _, _ = small
    dt = HALF_CUDA[h]
    cfg = cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[h], position_filter=pf)
    gains = Tracker(cfg, dev).gains_xy
    st, dets, valid, t = track_scene(K + B + S, cfg, K, D, B, S, (0,), dev)
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


def _widen_canonical(x: torch.Tensor) -> torch.Tensor:
    """A half tensor widened to f32 (exactly), every NaN one bit pattern
    (``_nan_canonical``'s reason: the NaN lane's det * 0)."""
    x = x.cpu()
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x) \
        if x.is_floating_point() else x


def _leaves(tree):
    """The tensors of a (TrackerState, TrackOutputs) pair, flattened."""
    st, out = tree
    return (*st.bank, *st[1:], *out)


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_half_slice_gpu_matches_cpu_plain_path(dev, small, h):
    """``bind_env`` under bf16 / f16 on the card (K1, then K2, K3f and K4's
    half builds, no other build of them) against the CPU plain path: every
    field bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg, env, frames = small
    cfg = cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[h])
    outs = {}
    for d in ("cpu", dev):
        tr = Tracker(cfg, d)
        step, st = tr.bind_env(env), tr.init_state()
        rows = []
        for pts, mask, t in frames:
            st, o = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([_widen_canonical(x) for x in o])
        outs[str(d)] = rows
    assert track_cuda.track_frames.launches_by[f"motl_track_step_{h}"] > 0
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        for x, y in zip(a, b):
            assert _bits(x, y)


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_k6f_half_builds_match_plain(dev, small, h):
    """K6f's half builds (the point list's scatter sums under bf16 / f16)
    on the small frames' points rounded to the half dtype (the adversarial
    frame 7 included, a cell of 300 points whose bf16 count stops at 256)
    and on configuration G's grid: bit for bit their plain version, one
    call counted as the half build's."""
    cfg, _, frames = small
    dt = HALF_CUDA[h]
    pts = np.stack([f[0] for f in frames])
    pts[6, :300] = np.float32([0.31, 1.27, 0.5])
    P = torch.from_numpy(pts).to(dev).to(dt).float()
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    gcfg, _, gsc = bench_cases.default_case()
    gp = np.stack([gsc.frame_arrays(s)[0][::3][:32768] for s in range(2)])
    GP = torch.from_numpy(gp).to(dev).to(dt).float()
    GM = torch.ones((2, 32768), dtype=torch.bool, device=dev)
    w = voxel_grid_cuda.accumulate_f32_stacked
    entry = f"motl_voxel_sums_{h}"
    for P_, M_, c in ((P, M, cfg), (GP, GM, gcfg)):
        kw = (c.scene, c.voxel_leaf_size, c.leaf_z)
        n0, nh = w.launches, w.launches_by[entry]
        k = w(P_, M_, *kw, dtype=dt)
        assert (w.launches, w.launches_by[entry]) == (n0, nh + 1) and k[0].dtype == dt
        p = voxel_grid_cuda.accumulate_f32_stacked_plain(P_.cpu(), M_.cpu(), *kw, dtype=dt)
        assert _bits(_widen_canonical(k[0]), _widen_canonical(p[0])) and _bits(k[1], p[1])
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    top = float(w(P[6:7], M[6:7], *kw, dtype=dt)[0][0, 3].max())
    exact = float(w(P[6:7], M[6:7], *kw)[0][0, 3].max())
    assert exact >= 300 and top == min(exact, voxel_grid_cuda.COUNT_SAT[dt])


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_k8a_half_builds_match_plain(dev, h):
    """K8a's half builds on half point lists: C's M = 1,024 (S = 8), G's M
    = 2,048 (S = 2) and M = 8,448 past the shared-memory frame (S = 1), bit
    for bit ``cc_adjacency_half_plain``; one launch each."""
    dt = HALF_CUDA[h]
    rng = np.random.default_rng(20)
    w = cluster_pallas.cc_adjacency
    for s, m, spread in ((8, 1024, 0.8), (2, 2048, 1.5), (1, 8448, 2.5)):
        pts = torch.from_numpy(rng.normal(0, spread, (s, m, 3))).to(dt).to(dev)
        pts[..., 2] *= 0.1
        msk = torch.from_numpy(rng.random((s, m)) < 0.8).to(dev)
        n0 = w.launches_by[f"motl_cc_adjacency_{h}"]
        got = w(pts, msk, 0.15)
        assert w.launches_by[f"motl_cc_adjacency_{h}"] == n0 + 1
        want = cluster_pallas.cc_adjacency_half_plain(pts.cpu(), msk.cpu(), 0.15)
        assert torch.equal(got.cpu(), want) and int(want.sum()) > s * m


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_k2_half_builds_fed_f32_sums_match_plain(dev, small, h):
    """K2's half builds fed the runs' f32 sums (the f32 finalize, the static
    drop on that centroid, the centroid rounded for the half d^2): bit for
    bit their plain version, counted as the f32-sums builds."""
    from multiple_object_tracking_lidar_tpu_torch.ops.voxel_pallas import (
        voxel_accumulate_runs_stacked)

    cfg, env, frames = small
    dt = HALF_CUDA[h]
    cfg = cfg.replace(voxel_mode="runs", dtype={"bf16": "bfloat16", "f16": "float16"}[h])
    plan = Tracker(cfg, dev).plan(env)
    P = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev).to(dt).float()
    M = torch.from_numpy(np.stack([f[1] for f in frames])).to(dev)
    acc, _ = voxel_accumulate_runs_stacked(P, M, cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    tb = (plan.scal, plan.table.base_row, plan.table.base_col, plan.table.bits)
    kw = dict(dims=plan.dims, tol=cfg.cluster_tolerance, leaf_xy=cfg.voxel_leaf_size,
              leaf_z=cfg.leaf_z, kwin=plan.table.k)
    w = grid_cuda.fused_finalize_static_cc_stacked
    entry = f"motl_grid_cc_{h}_f32sums"
    n0 = w.launches_by[entry]
    k = w(acc, *tb, dtype=dt, **kw)
    assert w.launches_by[entry] == n0 + 1 and k[0].dtype == dt
    p = w(acc.cpu(), *(t.cpu() for t in tb), dtype=dt, **kw)
    assert all(_bits(_widen_canonical(a), _widen_canonical(b)) for a, b in zip(k, p))


@pytest.mark.parametrize("h", ["bf16", "f16"])
def test_k3f_half_sorted_list_at_p_512_matches_plain(dev, h):
    """K3f's half build on the cluster-sorted point list at G's P = 512
    (clusters of 1-512 members), bit for bit its plain version."""
    from multiple_object_tracking_lidar_tpu_torch.ops.centroid import circumcenter_features_sorted

    dt = HALF_CUDA[h]
    rng = np.random.default_rng(512)
    p, c = 512, 24
    sizes = rng.integers(1, p + 1, c)
    sizes[:3] = [p, 300, 33]
    m = int(sizes.sum())
    centre = np.repeat(rng.uniform(-20, 20, (c, 3)), sizes, axis=0)
    pts = np.concatenate([centre + rng.normal(0, 0.4, (m, 3)), np.zeros((p, 3))])
    starts = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)[:-1]]))[None]
    args = (torch.from_numpy(pts).to(dt)[None], starts, torch.from_numpy(sizes)[None],
            torch.ones((1, c), dtype=torch.bool), torch.tensor([1.5]).to(dt))
    by = centroid_cuda.circumcenter_features.launches_by
    n0 = by[f"motl_circumcenter_features_{h}"]
    got = circumcenter_features_sorted(*(a.to(dev) for a in args), p)
    assert by[f"motl_circumcenter_features_{h}"] == n0 + 1 and got.dtype == dt
    want = circumcenter_features_sorted(*args, p)
    assert _bits(_widen_canonical(got), _widen_canonical(want))


HALF_FRONT_ENDS = {   # fields: the builds each must launch on the card
    "C": ({"voxel_mode": "dense", "cluster_backend": "pallas"}, ("K6f", "K8", "K3f")),
    "D": ({"voxel_mode": "dense", "cluster_backend": "jnp"}, ("K6f", "K8a", "K3f")),
    "E": ({"voxel_mode": "scan", "cluster_backend": "jnp"}, ("K8a", "K3f")),
    "F": ({"voxel_mode": "runs", "cluster_backend": "pallas"}, ("K7", "K8")),
    "B": ({"voxel_mode": "runs", "cluster_backend": "grid"}, ("K7", "K2 f32-sums", "K3f")),
    "dense-grid": ({"voxel_mode": "dense", "cluster_backend": "grid"}, ("K6f", "K2", "K3f")),
}


@pytest.mark.parametrize("h", ["bf16", "f16"])
@pytest.mark.parametrize("name", list(HALF_FRONT_ENDS))
def test_half_front_ends_gpu_match_cpu_plain_path(dev, small, name, h):
    """``bind_env`` under bf16 / f16 on each perception front end on the
    card (its half builds, K4's half build) against the CPU plain path:
    every field bit for bit."""
    from multiple_object_tracking_lidar_tpu_torch.ops import track_cuda

    cfg, env, frames = small
    fields, _ = HALF_FRONT_ENDS[name]
    cfg = cfg.replace(dtype={"bf16": "bfloat16", "f16": "float16"}[h], **fields)
    outs = {}
    for d in ("cpu", dev):
        tr = Tracker(cfg, d)
        step, st = tr.bind_env(env), tr.init_state()
        rows = []
        for pts, mask, t in frames:
            st, o = step(st, Frame(torch.from_numpy(pts), torch.from_numpy(mask), torch.tensor(t)))
            rows.append([_widen_canonical(x) for x in o])
        outs[str(d)] = rows
    assert track_cuda.track_frames.launches_by[f"motl_track_step_{h}"] > 0
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        for x, y in zip(a, b):
            assert _bits(x, y)
