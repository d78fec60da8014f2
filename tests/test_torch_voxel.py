"""K1's plain version (ops/voxel_grid_cuda.py) against the JAX package's
fast-digit voxel accumulation: its jnp route (which test_grid.py pins to
the Pallas kernels) and, once, the stacked Pallas kernel in interpret mode.

Integer digit sums, counts, the point count and the finalized f32 sums
must match exactly.  The jnp route is held to under ``jax.jit``, the
program every tracking path runs: XLA's CPU code contracts its quantize's
``p - cell0`` and its finalize's ``(base + i) * leaf + half`` and
``cnt * centre + s * 2^-k`` into FMAs, and K1 spells the same FMAs (run op
by op, eagerly, JAX rounds each product apart).  Where a program leaves a
few cells' finalize unfused (``_assert_fused``), those cells must equal the
unfused spelling bit for bit instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.config import SceneBounds as JScene
from multiple_object_tracking_lidar_tpu.ops.voxel_grid import (
    _accumulate_pallas_v5_stacked,
    voxel_accumulate_onehot_cm,
)
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds as TScene
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid as tvg
from multiple_object_tracking_lidar_tpu_torch.ops import voxel_grid_cuda as k1

SCENE = dict(x_min=-2.0, x_max=2.0, y_min=-1.0, y_max=5.0, z_min=0.0, z_max=2.0)
HEADLINE = dict(x_min=-2.4, x_max=2.5, y_min=-1.5, y_max=9.4, z_min=0.0, z_max=1.0)


def _digit_sums(acc, k):
    """Invert the finalize in f64: the exact integer digit sums per cell."""
    acc = np.asarray(acc, np.float64)
    lin = np.arange(k["n_cells"])
    ix, iyz = lin % k["gx"], lin // k["gx"]
    iy, iz = iyz % k["gy"], iyz // k["gy"]
    cx = np.float32(k["bx"] + ix) * np.float32(k["leaf_xy"])
    cy = np.float32(k["by"] + iy) * np.float32(k["leaf_xy"])
    cz = np.float32(k["bz"] + iz) * np.float32(k["leaf_z"])
    cnt = acc[3]
    out = []
    for ch, (c, half, sq) in enumerate(
        ((cx, k["half_xy"], k["sq_xy"]), (cy, k["half_xy"], k["sq_xy"]), (cz, k["half_z"], k["sq_z"]))
    ):
        out.append(np.round((acc[ch] - cnt * (np.float64(c) + half)) * sq))
    return np.stack(out + [cnt]).astype(np.int64)


def _assert_fused(got, ref, k):
    """``got`` (K1's FMA spelling) equals ``ref`` wherever XLA's CPU code
    contracted the finalize; a few cells of some programs (the remainder of
    a vectorized loop: the jnp route's last cells at 5,500, the v4 kernel's
    8-cell grid) keep ``cnt * (cell0 + half) + s * 2^-k`` unfused, and
    there ``ref`` must be that spelling's value bit for bit."""
    got, ref = np.asarray(got), np.asarray(ref)
    sums = _digit_sums(got, k).astype(np.float32)
    lin = np.arange(k["n_cells"])
    ix, iyz = lin % k["gx"], lin // k["gx"]
    f32 = np.float32
    cell0 = [f32(k["bx"] + ix) * f32(k["leaf_xy"]), f32(k["by"] + iyz % k["gy"]) * f32(k["leaf_xy"]),
             f32(k["bz"] + iyz // k["gy"]) * f32(k["leaf_z"])]
    for ch, (half, invq) in enumerate([(k["half_xy"], k["invq_xy"])] * 2 + [(k["half_z"], k["invq_z"])]):
        unfused = sums[3] * (cell0[ch] + f32(half)) + sums[ch] * f32(invq)
        same = got[ch] == ref[ch]
        assert (same | (unfused == ref[ch])).all(), ch
        assert (~same).sum() <= 16, ch
    np.testing.assert_array_equal(got[3], ref[3])


def _points(rng, n, scene, leaf):
    pts = np.stack(
        [
            rng.uniform(scene["x_min"] - 0.5, scene["x_max"] + 0.5, n),
            rng.uniform(scene["y_min"] - 0.5, scene["y_max"] + 0.5, n),
            rng.uniform(scene["z_min"] - 0.5, scene["z_max"] + 0.5, n),
        ],
        axis=1,
    ).astype(np.float32)
    q = n // 8
    pts[:q, :2] = (np.round(pts[:q, :2] / leaf) * leaf).astype(np.float32)  # leaf boundaries
    pts[q : q + 7, 0] = np.nan
    pts[q + 7 : q + 11, 2] = np.inf
    pts[q + 11] = [-999.0, 999.0, 0.0]
    pts[2 * q : 3 * q] = (np.float32([0.05, 1.05, 0.5]) + rng.normal(0, 0.01, (q, 3))).astype(
        np.float32
    )
    mask = rng.random(n) < 0.85
    return pts, mask


@pytest.mark.parametrize(
    "scene,leaf,n",
    [(SCENE, 0.1, 1024), (SCENE, 0.05, 4096), (HEADLINE, 0.1, 8192)],
    ids=["leaf0.1", "leaf0.05", "headline-geometry"],
)
def test_plain_k1_matches_jnp_fast_route(scene, leaf, n):
    rng = np.random.default_rng(int(leaf * 1000) + n)
    pts, mask = _points(rng, n, scene, leaf)
    js, ts = JScene(**scene), TScene(**scene)
    ref, n_ref = jax.jit(lambda p, m: voxel_accumulate_onehot_cm(
        p, m, js, leaf, 20 * leaf, use_pallas=False, quant="fast", with_npts=True,
    ))(jnp.asarray(pts), jnp.asarray(mask))
    got, n_got = tvg.voxel_accumulate_onehot_cm(
        torch.from_numpy(pts), torch.from_numpy(mask), ts, leaf, 20 * leaf,
        quant="fast", with_npts=True,
    )
    ref, got = np.asarray(ref), got.numpy()
    k = k1.kernel_params(ts, leaf, 20 * leaf)
    assert int(n_ref) == int(n_got) == int(mask.sum())
    assert got.shape == ref.shape == (4, k["n_cells"])
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(_digit_sums(got, k), _digit_sums(ref, k))
    _assert_fused(got, ref, k)


def test_plain_k1_matches_stacked_pallas_interpret():
    scene = SCENE
    rng = np.random.default_rng(11)
    frames = [_points(rng, 2048, scene, 0.1) for _ in range(2)]
    pts = np.stack([f[0] for f in frames])
    mask = np.stack([f[1] for f in frames])
    js, ts = JScene(**scene), TScene(**scene)
    ref, n_ref = _accumulate_pallas_v5_stacked(
        jnp.asarray(pts), jnp.asarray(mask), js, 0.1, 2.0, block=512, interpret=True
    )
    got, n_got = k1.accumulate_fast_stacked(
        torch.from_numpy(pts), torch.from_numpy(mask), ts, 0.1, 2.0
    )
    k = k1.kernel_params(ts, 0.1, 2.0)
    np.testing.assert_array_equal(np.asarray(n_ref), n_got.numpy())
    for s in range(2):
        np.testing.assert_array_equal(
            _digit_sums(got[s].numpy(), k), _digit_sums(np.asarray(ref[s]), k)
        )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_finalize_dense_cm_matches():
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import finalize_dense_cm as jfin

    rng = np.random.default_rng(2)
    acc = rng.normal(0, 3, (4, 300)).astype(np.float32)
    acc[3] = rng.integers(0, 4, 300).astype(np.float32)
    jc, jo, jn = jfin(jnp.asarray(acc))
    tc, to, tn = tvg.finalize_dense_cm(torch.from_numpy(acc))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    assert int(jn) == int(tn)


def test_k1_wrapper_cpu_route_and_limits():
    """On a CPU tensor each accumulator wrapper runs its plain version and
    launches nothing; an unknown quant raises."""
    ts = TScene(**SCENE)
    wrappers = (k1.accumulate_fast_stacked, k1.accumulate_exact_stacked,
                k1.accumulate_bf16x3_stacked)
    before = [w.launches for w in wrappers]
    pts = torch.zeros((1, 16, 3))
    for w in wrappers:
        w(pts, torch.ones((1, 16), dtype=torch.bool), ts, 0.1, 2.0)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="voxel_quant"):
        tvg.voxel_accumulate_onehot_cm(pts[0], torch.ones(16, dtype=torch.bool), ts, 0.1, 2.0, quant="int4")
    assert k1.max_cells() == 232_320                      # 16 CTAs x 14,520 cells


@pytest.mark.parametrize("n_cells,s,groups", [
    (1, 1, 1), (5_500, 1, 1), (5_500, 8, 1), (5_500, 1, 3), (5_500, 8, 3), (14_520, 1, 1),
    (14_521, 1, 1), (32_768, 8, 1), (70_200, 1, 1), (70_200, 8, 3), (193_536, 1, 1),
    (193_536, 8, 3), (232_320, 64, 3),
])
def test_k1_layout_rule(n_cells, s, groups):
    """The layout K1 (one channel group) and K5 (three) launch with
    (``digit_layout``): the fewest cell ranges whose CTAs hold their range
    (``CTA_CELLS`` = 14,520 cells at 16 B each), then as many point chunks
    (the cluster size) and then ranges as keep S x groups x ranges x chunks
    within ``CTA_BUDGET`` CTAs, both powers of two up to the H100's 16;
    pure Python, no card."""
    ranges, chunks = k1.digit_layout(n_cells, s, groups)
    assert ranges in (1, 2, 4, 8, 16) and chunks in (1, 2, 4, 8, 16)
    assert k1._span(n_cells, ranges) <= k1.CTA_CELLS and k1._span(n_cells, ranges) % 4 == 0
    fewest = 1
    while -(-n_cells // fewest) > k1.CTA_CELLS:
        fewest *= 2
    assert ranges >= fewest
    ctas = s * groups * ranges * chunks
    assert ctas <= k1.CTA_BUDGET or (ranges == fewest and chunks == 1)
    assert 2 * ctas > k1.CTA_BUDGET or (ranges == 16 and chunks == 16)


def test_k1_layouts_on_the_measured_grids():
    """The rule's layouts on the grids it was timed on (PERF.md, PR 8):
    the headline takes one range at S = 8 (the whole grid per CTA) and a
    cluster of 16 chunks at S = 1; the default scene 16 ranges."""
    assert k1.digit_layout(5_500, 1, 1) == (4, 16)
    assert k1.digit_layout(5_500, 8, 1) == (1, 8)
    assert k1.digit_layout(5_500, 8, 3) == (1, 4)
    assert k1.digit_layout(70_200, 1, 3) == (8, 4)
    assert k1.digit_layout(193_536, 1, 1) == (16, 4)
    assert k1.digit_layout(193_536, 8, 1) == (16, 1)


def test_k1_capacity_and_dispatch_bound():
    """``max_cells`` is 16 ranges of ``CTA_CELLS`` (16 from
    ``grid_cuda.max_cluster``: the H100's without a card), the largest
    grid of PR 8's layouts.  One cell past it the layout takes more ranges
    (32, of two point chunks; 128 of one chunk at the floor's 1,119,963
    cells, every CTA reading all its frame's points), and so at any size:
    no bound is left, the dispatcher takes the kernel on the card at every
    grid."""
    assert k1.CTA_CELLS == (232_448 - 128) // 16 == 14_520
    assert k1.max_cells() == k1.max_cells("cpu") == 16 * k1.CTA_CELLS
    for gx, layout in ((k1.CTA_CELLS, (16, 4)), (k1.CTA_CELLS + 1, (32, 2))):
        ts = TScene(x_min=0.0, x_max=(gx - 0.5) * 0.05, y_min=0.0, y_max=15.5 * 0.05,
                    z_min=0.0, z_max=0.05)
        nc = k1.kernel_params(ts, 0.05, 0.1)["n_cells"]
        assert nc == gx * 16
        assert k1.digit_layout(nc, 1) == layout
        assert k1._span(nc, layout[0]) <= k1.CTA_CELLS
    assert k1.digit_layout(1_119_963, 1) == k1.digit_layout(1_119_963, 8) == (128, 1)
    assert k1.digit_layout(1_119_963, 1, 3) == (128, 1)
    assert not hasattr(tvg, "digit_kernels_fit") and not hasattr(k1, "_check_cells")


def test_plain_k1_matches_v4_kernel_past_the_f32_bound():
    """At N * 127 >= 2^24 the TPU's fast route leaves v5 for the
    i32-accumulating v4 (voxel_grid.py:129-133).  K1 covers that regime
    too: its plain version equals the v4 kernel in interpret mode at
    N = 133,120 on a tiny grid, with 99% of the points in one cell at the
    top of the digit range (digit sums near 2^24)."""
    from multiple_object_tracking_lidar_tpu.ops.voxel_grid import (
        _accumulate_pallas_v4,
        _v5_exact_n,
    )

    n = 133_120
    assert not _v5_exact_n(n)
    scene = dict(x_min=0.0, x_max=0.35, y_min=0.0, y_max=0.15, z_min=0.0, z_max=1.0)
    rng = np.random.default_rng(133)
    pts = np.stack([rng.uniform(-0.05, 0.4, n), rng.uniform(-0.05, 0.2, n),
                    rng.uniform(0.0, 1.0, n)], axis=1).astype(np.float32)
    blob = int(0.99 * n)
    pts[:blob] = [0.1999, 0.0999, 0.5]          # one cell at the digit's top edge
    pts[blob: blob + 5, 1] = np.nan
    mask = rng.random(n) < 0.95
    mask[:blob] = True
    js, ts = JScene(**scene), TScene(**scene)
    ref, n_ref = _accumulate_pallas_v4(
        jnp.asarray(pts), jnp.asarray(mask), js, 0.1, 2.0, block=2048, interpret=True
    )
    got, n_got = k1.accumulate_fast_stacked(
        torch.from_numpy(pts)[None], torch.from_numpy(mask)[None], ts, 0.1, 2.0
    )
    k = k1.kernel_params(ts, 0.1, 2.0)
    sums = _digit_sums(got[0].numpy(), k)
    assert int(n_ref) == int(n_got[0]) == int(mask.sum())
    assert sums[0].max() > 13_000_000 and sums[3].max() >= blob
    np.testing.assert_array_equal(sums, _digit_sums(np.asarray(ref), k))
    _assert_fused(got[0].numpy(), ref, k)


@pytest.mark.parametrize("case,n_frames", [("headline_case", 12), ("dense_case", 8),
                                            ("default_grid_case", 2)])
def test_plain_k1_equals_the_jitted_jax_route_on_the_golden_frames(case, n_frames):
    """F8's repair on the scenes the goldens hold: K1's plain version (its
    quantize, cell centre and finalize as XLA's FMAs) equals the JAX
    package's jitted fast-digit route bit for bit, every cell of every
    golden frame -- the headline's 12 and the dense scene's 8 -- and of
    the G-grid's first two (193,536 cells, 131,072-point frames)."""
    import dataclasses

    from multiple_object_tracking_lidar_tpu_torch import bench_cases

    cfg, _, sc = getattr(bench_cases, case)()
    leaf, leaf_z = cfg.voxel_leaf_size, cfg.leaf_z
    js = JScene(**dataclasses.asdict(cfg.scene))
    route = jax.jit(lambda p, m: voxel_accumulate_onehot_cm(p, m, js, leaf, leaf_z, quant="fast"))
    for k in range(n_frames):
        pts, mask, _ = bench_cases.padded_frame(sc, k, cfg.caps.n_max_points)
        ref = np.asarray(route(jnp.asarray(pts), jnp.asarray(mask)))
        got, _ = k1.accumulate_fast_stacked_plain(torch.from_numpy(pts)[None],
                                                  torch.from_numpy(mask)[None], cfg.scene,
                                                  leaf, leaf_z)
        np.testing.assert_array_equal(got[0].numpy(), ref, err_msg=f"frame {k}")
