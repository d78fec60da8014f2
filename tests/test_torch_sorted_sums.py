"""K6's stable radix sort and scratch plan (``csrc/voxel_bf16x3.cu``,
``ops/voxel_grid_cuda.py::sorted_sums_plan``) on the CPU, where no kernel
runs:

- a rehearsal of the kernel's LSD digit passes in plain torch -- per
  8-bit digit, each tile of ``SORT_TILE`` keys placed at its (digit, tile)
  offset from the frame's histogram plus its stable rank within the tile,
  the dropped keys (-1) never entering -- held equal to one stable sort of
  the kept keys, at the headline's 5,500 cells and configuration G's
  193,536, with every key in one cell, keys at n_cells - 1, and every key
  dropped;
- the scratch plan: O(N + digits x tiles + n_cells) bytes per frame, no
  array growing with n_cells x tiles, the passes the kernel checks;
- the f32 and bf16x3 plain versions on a frame whose points all fall in
  one cell, an all-dropped frame and NaN points, against numpy's
  unbuffered ``add.at`` (which adds in ascending point index).
"""

import numpy as np
import pytest
import torch

from multiple_object_tracking_lidar_tpu_torch import bench_cases
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as vg


def _radix_order(keys: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The kernel's passes over one frame's (N,) keys: the point indices of
    the kept keys in sorted order."""
    plan = vg.sorted_sums_plan(1, keys.numel(), n_cells)
    tile = vg.SORT_TILE
    key, val = keys, torch.arange(keys.numel())
    n_in = keys.numel()
    for p in range(plan["passes"]):
        live = key[:n_in] >= 0
        k_in, v_in = key[:n_in][live], val[:n_in][live]
        pos_in = torch.nonzero(live).flatten()          # positions in this pass's input
        digit = (k_in >> (8 * p)) & 255
        t_of = pos_in // tile
        n_tiles = plan["n_tiles"]
        hist = torch.zeros((n_tiles, 256), dtype=torch.int64)
        hist.index_put_((t_of, digit), torch.ones_like(digit), accumulate=True)
        # offset of (tile, digit): every earlier digit, then this digit in the earlier tiles
        digit_base = torch.cumsum(hist.sum(0), 0) - hist.sum(0)
        tile_before = torch.cumsum(hist, 0) - hist
        off = digit_base[None, :] + tile_before
        # the stable rank within (tile, digit): input order
        group = t_of * 256 + digit
        order = torch.sort(group, stable=True).indices
        start = torch.cumsum(torch.bincount(group, minlength=n_tiles * 256), 0) - \
            torch.bincount(group, minlength=n_tiles * 256)
        rank = torch.empty_like(group)
        rank[order] = torch.arange(len(group)) - start[group[order]]
        dest = off[t_of, digit] + rank
        assert torch.equal(torch.sort(dest).values, torch.arange(len(dest)))   # a permutation
        key = torch.full_like(keys, -1)
        val = torch.zeros_like(keys)
        key[dest], val[dest] = k_in, v_in
        n_in = len(dest)
    return val[:n_in]


def _keys(case, n_cells, n, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_cells, n)
    if case == "hot":
        k[rng.random(n) < 0.7] = rng.integers(0, n_cells)
    elif case == "one_cell":
        k[:] = n_cells - 1
    k[rng.random(n) < 0.1] = -1
    k[:50] = n_cells - 1                                  # the last cell's key
    if case == "all_dropped":
        k[:] = -1
    return torch.from_numpy(k.astype(np.int64))


@pytest.mark.parametrize("n_cells", [5500, 193536])
@pytest.mark.parametrize("case", ["uniform", "hot", "one_cell", "all_dropped"])
def test_lsd_passes_equal_one_stable_sort(n_cells, case):
    keys = _keys(case, n_cells, 9000, n_cells % 97)
    got = _radix_order(keys, n_cells)
    kept = torch.nonzero(keys >= 0).flatten()
    want = kept[torch.sort(keys[kept], stable=True).indices]
    assert torch.equal(got, want)


@pytest.mark.parametrize("case,s", [("headline_case", 1), ("headline_case", 8),
                                    ("default_case", 1), ("default_case", 8)])
def test_scratch_plan_is_linear(case, s):
    cfg = getattr(bench_cases, case)()[0]
    n = cfg.caps.n_max_points
    nc = vg.kernel_params(cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)["n_cells"]
    plan = vg.sorted_sums_plan(s, n, nc)
    assert plan["n_tiles"] == -(-n // vg.SORT_TILE)
    assert plan["passes"] == (2 if nc == 5500 else 3)
    sz = plan["sizes"]
    assert sz["cells"] == 2 * s * nc
    assert sz["keys"] == s * n and sz["sorted"] == 3 * s * n
    assert sz["pairs"] <= 4 * s * n
    assert sz["hist"] == plan["passes"] * s * plan["n_tiles"] * 256
    per_frame = plan["bytes"] / s
    assert per_frame <= 4 * (8 * n + 2 * nc + 3 * 256 * plan["n_tiles"]) + 4096
    # the count matrix it replaces: n_cells x chunks of 2,048 points, twice
    assert per_frame < 0.1 * 2 * 4 * nc * -(-n // 2048) or nc < 10_000
    # doubling the cells grows only the cell array (and at most one pass)
    wider = vg.sorted_sums_plan(s, n, 2 * nc)["sizes"]
    assert wider["cells"] == 2 * sz["cells"] and wider["keys"] == sz["keys"]


def _np_sums(pts, mask, k, parts):
    """Per cell, the values of the kept points added one at a time in
    ascending point index (numpy's unbuffered add.at), in f32."""
    ok, lin, _ = vg.kept_cells(torch.from_numpy(pts)[None], torch.from_numpy(mask)[None], k)
    ok, lin = ok[0].numpy(), lin[0].numpy()
    vals = parts(torch.from_numpy(pts[ok])).numpy().astype(np.float32)
    acc = np.zeros((k["n_cells"],) + vals.shape[1:], np.float32)
    np.add.at(acc, lin[ok], vals)
    return acc, np.bincount(lin[ok], minlength=k["n_cells"]).astype(np.float32)


@pytest.mark.parametrize("frame", ["one_cell", "all_dropped", "nan_points"])
def test_plain_versions_on_edge_frames(frame):
    cfg, _, sc = bench_cases.headline_case()
    kw = (cfg.scene, cfg.voxel_leaf_size, cfg.leaf_z)
    k = vg.kernel_params(*kw)
    rng = np.random.default_rng(5)
    n = 6000
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                    rng.uniform(0.2, 1.5, n)], 1).astype(np.float32)
    mask = rng.random(n) < 0.95
    if frame == "one_cell":
        pts[:] = np.asarray([0.05, 2.05, 0.5]) + rng.uniform(-0.04, 0.04, (n, 3))
    elif frame == "all_dropped":
        mask[:] = False
    else:
        pts[::7, 0] = np.nan
        pts[3::11, 2] = np.nan
    P, M = torch.from_numpy(pts)[None], torch.from_numpy(mask)[None]
    f32, n32 = vg.accumulate_f32_stacked(P, M, *kw)
    bf, nbf = vg.accumulate_bf16x3_stacked(P, M, *kw)
    assert int(n32[0]) == int(nbf[0]) == int(mask.sum())
    acc, cnt = _np_sums(pts, mask, k, lambda v: v)
    np.testing.assert_array_equal(f32[0, :3].numpy().T, acc)
    np.testing.assert_array_equal(f32[0, 3].numpy(), cnt)
    acc3, _ = _np_sums(pts, mask, k, vg.bf16x3_parts)
    np.testing.assert_array_equal(bf[0, :3].numpy().T, (acc3[..., 0] + acc3[..., 1]) + acc3[..., 2])
    np.testing.assert_array_equal(bf[0, 3].numpy(), cnt)
    if frame == "one_cell":
        assert int(cnt.max()) == int(mask.sum())
