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
