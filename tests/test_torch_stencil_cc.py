"""K14's plain version -- the dense grid's stencil connected components
(``ops/stencil_cc_cuda.py::stencil_cc_plain``, the CPU route of
``ops/cluster_grid.py::connected_components_grid``) -- against the jitted
JAX ``connected_components_grid``, bit for bit, in f32 and f64:

- converged, and cut at ``max_iters`` = 1 and 2 (``saturated`` set, the
  labels the capped schedule leaves);
- a batch of frames that stop at different iterations, each its own
  single-frame result (as under ``jax.vmap``);
- a grid one cell thick (gz = 1: no z offsets fit), and a 0.05 m leaf's
  146 offsets over three z slabs (five adjacency words);
- no host sync (``connected_components_grid.host_syncs`` stays 0).

K14 itself (``csrc/stencil_cc.cu``) runs only on the card, where
chip_smoke.py and tests/test_torch_cuda.py hold it to this plain version.
Its steps are rehearsed here in numpy against the plain version, bit for
bit (``_rehearse_k14``): the flags read in 16-byte chunks from a frame
that starts anywhere in a chunk, split over the cluster's CTAs and their
warps, the dynamic cells listed in ascending order across the CTAs; the
adjacency words built one warp per cell, lane b testing offset 32 w + b
(cells on the grid's edges, offsets past the grid, words past the
offsets); the Jacobi passes split over the CTAs with the cluster-wide vote
(rank 0's word raised to 1 + the iteration).  Words, list, labels,
``n_sweeps`` and ``saturated``, f32 and f64, converged and capped, at 1, 4
and 16 CTAs per frame.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from multiple_object_tracking_lidar_tpu.ops.cluster_grid import (
    connected_components_grid as jax_ccg,
)
from multiple_object_tracking_lidar_tpu_torch.ops import stencil_cc_cuda as k14
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_grid import connected_components_grid
from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import kernel_offsets

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# (name, dims, leaf_xy, leaf_z, tol): the headline's 0.1 m grid one cell
# thick, and a 0.05 m leaf over three z slabs (146 offsets)
GRIDS = {"flat": ((40, 30, 1), 0.1, 2.0, 0.15), "slabs": ((36, 28, 3), 0.05, 1.0, 0.15)}


def _frame(rng, dims, leaf, leaf_z, dtype, blobs=12, density=0.55, snake=False):
    """(cent (3, n), dyn (n,)): ``blobs`` blobs of dynamic cells, centroids
    jittered inside their cells; with ``snake``, instead a path over every
    few rows of the bottom slab (rows farther apart than the tolerance,
    joined at alternate ends, centroids at the cell centres) that no capped
    schedule of a few iterations finishes."""
    gx, gy, gz = dims
    n = gx * gy * gz
    lin = np.arange(n)
    ix, iy, iz = lin % gx, (lin // gx) % gy, lin // (gx * gy)
    cent = np.stack([(ix + rng.uniform(0.1, 0.9, n)) * leaf, (iy + rng.uniform(0.1, 0.9, n)) * leaf,
                     (iz + rng.uniform(0.1, 0.9, n)) * leaf_z])
    dyn = np.zeros(n, bool)
    for _ in range(blobs):
        cx, cy = rng.integers(0, gx), rng.integers(0, gy)
        r = int(rng.integers(1, 5))
        near = (abs(ix - cx) <= r) & (abs(iy - cy) <= r)
        dyn |= near & (rng.random(n) < density)
    if snake:
        step = int(0.15 / leaf) + 2
        rows = list(range(0, gy, step))
        path = (iz == 0) & np.isin(iy, rows)
        for j, y in enumerate(rows[:-1]):        # the joint to the next row
            x = gx - 1 if j % 2 == 0 else 0
            path |= (iz == 0) & (ix == x) & (iy > y) & (iy < rows[j + 1])
        dyn |= path
        cent[0, path] = (ix[path] + 0.5) * leaf
        cent[1, path] = (iy[path] + 0.5) * leaf
        cent[2, path] = 0.5 * leaf_z
    return cent.astype(dtype), dyn


@functools.lru_cache(maxsize=None)
def _jitted(args):
    return jax.jit(lambda c, d: jax_ccg(c, d, *args))


def _jax(cent, dyn, args):
    return tuple(np.asarray(x) for x in _jitted(args)(jnp.asarray(cent), jnp.asarray(dyn)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("max_iters", [32, 1, 2])
def test_plain_matches_jax(grid, dtype, max_iters):
    dims, leaf, leaf_z, tol = GRIDS[grid]
    rng = np.random.default_rng(hash((grid, max_iters)) % 2**32)
    cent, dyn = _frame(rng, dims, leaf, leaf_z, dtype, blobs=0, snake=True)
    args = (dims, tol, leaf, leaf_z, max_iters, 2, 2)
    syncs = connected_components_grid.host_syncs
    tl, tn, ts = connected_components_grid(torch.from_numpy(cent), torch.from_numpy(dyn), *args)
    jl, jn, js = _jax(cent, dyn, args)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert (int(tn), int(ts)) == (int(jn), int(js))
    assert connected_components_grid.host_syncs == syncs
    n = dyn.size
    assert tl.dtype == torch.int32 and int((tl < n).sum()) == int(dyn.sum()) > 50
    if max_iters < 32:
        assert int(ts) == 1 and int(tn) == 2 * max_iters       # cut at the cap, flagged
    else:
        assert int(ts) == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batch_frames_stop_on_their_own(dtype):
    """Three stacked frames -- one empty, one of blobs, one snake -- stop
    at different iterations; each equals its own JAX run."""
    dims, leaf, leaf_z, tol = GRIDS["slabs"]
    rng = np.random.default_rng(7)
    frames = [_frame(rng, dims, leaf, leaf_z, dtype, blobs=0, density=0.0),
              _frame(rng, dims, leaf, leaf_z, dtype),
              _frame(rng, dims, leaf, leaf_z, dtype, blobs=0, snake=True)]
    args = (dims, tol, leaf, leaf_z, 32, 2, 2)
    cent = torch.from_numpy(np.stack([f[0] for f in frames]))
    dyn = torch.from_numpy(np.stack([f[1] for f in frames]))
    tl, tn, ts = connected_components_grid(cent, dyn, *args)
    assert tl.shape == dyn.shape and tn.shape == ts.shape == (3,)
    iters = []
    for s, (c, d) in enumerate(frames):
        jl, jn, js = _jax(c, d, args)
        np.testing.assert_array_equal(tl[s].numpy(), jl)
        assert (int(tn[s]), int(ts[s])) == (int(jn), int(js))
        iters.append(int(jn))
    assert len(set(iters)) == 3, iters


def test_plain_packs_the_offsets_the_kernel_takes():
    """The 0.05 m leaf over three slabs: 146 offsets fit the grid, five
    adjacency words; the plain version with those offsets (the kernel's)
    equals the dispatcher, which the JAX tests above pin."""
    dims, leaf, leaf_z, tol = GRIDS["slabs"]
    offs = kernel_offsets(dims, tol, leaf, leaf_z)
    assert len(offs) == 146 and (len(offs) + 31) // 32 == 5
    assert all(dz == 0 for dz, _, _ in kernel_offsets(GRIDS["flat"][0], 0.15, 0.1, 2.0))
    rng = np.random.default_rng(3)
    cent, dyn = _frame(rng, dims, leaf, leaf_z, np.float32)
    C, D = torch.from_numpy(cent)[None], torch.from_numpy(dyn)[None]
    got = k14.stencil_cc_plain(C, D, dims, offs, float(np.float32(tol * tol)), 32, 2, 2)
    ref = connected_components_grid(C, D, dims, tol, leaf, leaf_z, 32, 2, 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[1][0]) > 0


# ---------------------------------------------------------------------------
# K14's steps (csrc/stencil_cc.cu) rehearsed in numpy
# ---------------------------------------------------------------------------
def _rehearse_k14(cent, dyn, dims, offs, tol2, max_iters, sweeps, jumps, C, lead):
    """csrc/stencil_cc.cu on one frame, step by step: the frame's flags at
    byte ``lead`` of a 16-byte chunk, C CTAs of 32 warps.  Returns (list,
    words (nd, W), labels, n_sweeps, saturated)."""
    gx, gy, gz = dims
    n = gx * gy * gz
    W = (len(offs) + 31) // 32
    n_warps = 32
    # 1. chunk q holds cells 16 q - lead + b; CTA shares, warp parts, 32 a step
    nq = (lead + n + 15) // 16
    qc = -(-nq // C)

    def mask(q):
        c0 = 16 * q - lead
        return sum(1 << b for b in range(16) if 0 <= c0 + b < n and dyn[c0 + b])

    parts = []
    for rank in range(C):
        cq0 = min(nq, rank * qc)
        cq1 = min(nq, cq0 + qc)
        qw = -(-(cq1 - cq0) // n_warps)
        parts.append([(min(cq1, cq0 + w * qw), min(cq1, min(cq1, cq0 + w * qw) + qw))
                      for w in range(n_warps)])
    counts = [[sum(bin(mask(q)).count("1") for q in range(a, b)) for a, b in p] for p in parts]
    cta = [sum(c) for c in counts]
    nd = sum(cta)
    lst = np.full(nd, -1, np.int64)
    lab = np.full(n, -1, np.int64)
    for rank in range(C):
        for w, (a, b) in enumerate(parts[rank]):
            at = sum(cta[:rank]) + sum(counts[rank][:w])
            for q0 in range(a, b, 32):            # one step: 32 lanes, a warp scan
                ms = [mask(q) if q < b else 0 for q in range(q0, q0 + 32)]
                for lane, m in enumerate(ms):
                    c0 = 16 * (q0 + lane) - lead
                    k = at + sum(bin(x).count("1") for x in ms[:lane])
                    for bit in range(16):
                        if (m >> bit) & 1:
                            lst[k] = c0 + bit
                            k += 1
                    if q0 + lane < b:
                        for bit in range(16):
                            if 0 <= c0 + bit < n:
                                lab[c0 + bit] = c0 + bit if (m >> bit) & 1 else n
                at += sum(bin(x).count("1") for x in ms)
    assert (lst >= 0).all() and (lab >= 0).all()
    # 2. one warp per cell: lane b of word w tests offset 32 w + b (all the
    #    list's (cell, word, lane) at once; the FMA spelled as the kernel's)
    O = np.asarray(offs, np.int64).reshape(-1, 3)
    o = np.arange(32 * W).reshape(W, 32)                      # (word, lane) -> offset
    valid_o = o < len(offs)
    oc = np.minimum(o, max(len(offs) - 1, 0))
    dz, dy, dx = (O[oc, a] if len(offs) else np.zeros_like(oc) for a in range(3))
    x, y, z = (lst % gx)[:, None, None], ((lst // gx) % gy)[:, None, None], \
        (lst // (gx * gy))[:, None, None]
    inside = (valid_o & (x + dx >= 0) & (x + dx < gx) & (y + dy >= 0) & (y + dy < gy)
              & (z + dz >= 0) & (z + dz < gz))
    j = np.where(inside, lst[:, None, None] + dx + gx * (dy + gy * dz), 0)
    cand = inside & dyn[j]
    c = torch.from_numpy(cent)
    d = [c[a][torch.from_numpy(lst)][:, None, None] - c[a][torch.from_numpy(j)] for a in range(3)]
    d2 = k14.fma(d[2], d[2], k14.fma(d[0], d[0], d[1] * d[1])).numpy()
    hit = cand & (d2 <= tol2)
    words = (hit.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    # 3. the passes, each CTA its share of the list; the vote
    qs = -(-nd // C)
    src, dst = lab.copy(), lab.copy()
    fell, it, changed = 0, 0, True
    deltas = [dx + gx * (dy + gy * dz) for dz, dy, dx in offs]
    while changed and it < max_iters:
        moved = [False] * C
        for p in range(sweeps + jumps):
            for rank in range(C):
                for q in range(min(nd, rank * qs), min(nd, min(nd, rank * qs) + qs)):
                    i = lst[q]
                    v = src[i]
                    if p < sweeps:
                        for w in range(W):
                            for bit in range(32):
                                if (int(words[q, w]) >> bit) & 1:
                                    v = min(v, src[i + deltas[32 * w + bit]])
                    else:
                        v = src[src[i]]
                    moved[rank] |= v != src[i]
                    dst[i] = v
            if p == sweeps + jumps - 1 and any(moved):
                fell = max(fell, it + 1)
            src, dst = dst, src
        changed = fell >= it + 1
        it += 1
    sat = int(changed and it >= max_iters)
    return lst, words, src, it * sweeps, sat



@pytest.mark.parametrize("cluster,lead", [(1, 0), (4, 7), (16, 13)])
@pytest.mark.parametrize("max_iters", [32, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_steps_rehearsed_match_plain(dtype, max_iters, cluster, lead):
    """K14's three steps on a 37 x 23 x 3 grid (2,553 cells: no multiple of
    16; the 0.05 m leaf's offsets, many past the grid at its edges) with
    blobs, a snake no capped schedule finishes and the grid's corners and
    edges dynamic: the list is the dynamic cells in order, the words the
    plain version's, the labels, n_sweeps and saturated the plain
    version's, at every cluster size and frame alignment."""
    dims, leaf, leaf_z, tol = (37, 23, 3), 0.05, 1.0, 0.15
    gx, gy, gz = dims
    rng = np.random.default_rng(17)
    cent, dyn = _frame(rng, dims, leaf, leaf_z, dtype, blobs=6, snake=True)
    lin = np.arange(dyn.size)
    ix, iy = lin % gx, (lin // gx) % gy
    dyn |= ((ix == 0) | (ix == gx - 1)) & ((iy < 3) | (iy > gy - 4))
    offs = kernel_offsets(dims, tol, leaf, leaf_z)
    tol2 = np.asarray(tol * tol, dtype)[()]
    lst, words, lab, n_sw, sat = _rehearse_k14(cent, dyn, dims, offs, tol2, max_iters, 2, 2,
                                                cluster, lead)
    np.testing.assert_array_equal(lst, np.flatnonzero(dyn))
    C, D = torch.from_numpy(cent)[None], torch.from_numpy(dyn)[None]
    pw = k14.adjacency_words_plain(C, D, dims, offs, tol2)[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(words, pw[:, lst].T)
    assert words.shape[1] == 5 and words.any()
    pl, pn, ps = k14.stencil_cc_plain(C, D, dims, offs, tol2, max_iters, 2, 2)
    np.testing.assert_array_equal(lab, pl[0].numpy())
    assert (n_sw, sat) == (int(pn[0]), int(ps[0]))
    assert sat == (1 if max_iters == 1 else 0)
