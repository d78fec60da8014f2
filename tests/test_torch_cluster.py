"""The point-list clustering of the port against the JAX package on the CPU.

- K8's plain version (ops/cluster_pallas.py) against
  ``connected_components_pallas`` in interpret mode, labels exact: blobs at
  M = 256 and M = 1,024, a 40-point chain (transitivity), an empty mask,
  and a chain longer than a small ``n_sweeps``, where the cut-short labels
  are the Jacobi sweeps' own.  Its adjacency is held against the JAX
  ``_pairwise_adjacency`` on a lattice at the tolerance's spacing, where
  thousands of pairs sit within 1e-6 of the boundary: exact.
- The "jnp" CC (``connected_components``): labels and ``n_iters`` exact,
  including a chain that reaches ``max_iters``; both port backends give
  equal labels on converged inputs; a batch gives each frame's own result.
- ``euclidean_cluster`` / ``cluster_postprocess``: every integer and copied
  field exact, with more components than C and components below
  ``min_size`` and above ``max_size``, for both backends.
- K9's plain version against ``segment_totals_pallas`` (interpret mode),
  bit for bit: N < 2,048, N = 2,048 and N = 3 * 2,048, runs across block
  edges, length-1 runs and one run over everything; one block of a ragged
  T = N = 1,001 and 7 rows, with inf and -0.0 in the rows the cyclic roll
  wraps onto and in the rows that read them.
- ``fma32`` against an exact rational reference.

The JAX functions run under ``jax.jit``, as the pipeline runs them: called
op by op, XLA compiles the squared norms without the FMA contraction it
applies inside a jitted program, and the adjacency moves by an ulp of
sq_i + sq_j on some lattice pairs.
"""

import fractions

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multiple_object_tracking_lidar_tpu.ops import cluster as jcl
from multiple_object_tracking_lidar_tpu.ops.cluster_pallas import (
    connected_components_pallas as j_cc_pallas,
)
from multiple_object_tracking_lidar_tpu.ops.voxel_pallas import segment_totals_pallas
from multiple_object_tracking_lidar_tpu_torch.ops import cluster as tcl
from multiple_object_tracking_lidar_tpu_torch.ops import cluster_pallas as tcp
from multiple_object_tracking_lidar_tpu_torch.ops import segsum_cuda


def _blobs(seed, m, n_valid, n_blobs=6, spread=0.06):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3, 3, (n_blobs, 3)) * np.array([1, 1, 0.1])
    which = rng.integers(0, n_blobs, m)
    pts = (centres[which] + rng.normal(0, spread, (m, 3))).astype(np.float32)
    mask = np.zeros(m, bool)
    mask[rng.permutation(m)[:n_valid]] = True
    return pts, mask


def _chain(m, n, step=0.1, offset=(0.3, 1.7, 0.5)):
    pts = np.zeros((m, 3), np.float32)
    pts[:n, 0] = np.arange(n) * step
    pts[:n] += np.asarray(offset, np.float32)
    pts[n:] = np.float32([50.0, 50.0, 50.0])
    mask = np.zeros(m, bool)
    mask[:n] = True
    return pts, mask


def _lattice(m, seed):
    """A 64 x 64 lattice at the 0.15 m tolerance's spacing, 1e-6 m noise:
    d2 of thousands of neighbour pairs lands within an ulp or two of tol2."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(64), np.arange(64), indexing="ij"), -1).reshape(-1, 2)[:m]
    pts = np.zeros((m, 3), np.float32)
    pts[:, :2] = (g * 0.15 + np.array([-2.0, 1.0])).astype(np.float32)
    pts[:, 2] = 0.5
    pts += rng.normal(0, 1e-6, pts.shape).astype(np.float32)
    return pts, rng.random(m) < 0.9


def _t(a):
    return torch.from_numpy(np.asarray(a))


CC_CASES = {
    "blobs-256": lambda: (*_blobs(1, 256, 200), 0.15, 64),
    "blobs-1024": lambda: (*_blobs(2, 1024, 900, n_blobs=12), 0.15, 64),
    "chain-40": lambda: (*_chain(256, 40), 0.12, 64),
    "empty": lambda: (np.zeros((256, 3), np.float32), np.zeros(256, bool), 0.15, 64),
    "chain-cut-short": lambda: (*_chain(256, 60), 0.12, 7),
    "boundary-lattice-1024": lambda: (*_lattice(1024, 3), 0.15, 256),
}


@pytest.mark.parametrize("name", list(CC_CASES))
def test_k8_plain_matches_pallas_interpret(name):
    pts, mask, tol, n_sweeps = CC_CASES[name]()
    # the chain's points are a reversed index order, so the min label
    # travels one hop per sweep: a chain of 60 needs 60 sweeps
    if name.startswith("chain"):
        pts[: mask.sum()] = pts[: mask.sum()][::-1].copy()
    ref = np.asarray(j_cc_pallas(jnp.asarray(pts), jnp.asarray(mask), tol,
                                 n_sweeps=n_sweeps, interpret=True))
    got, sweeps = tcp.connected_components_pallas(_t(pts), _t(mask), tol, n_sweeps,
                                                  with_sweeps=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "chain-cut-short":
        assert sweeps == n_sweeps and len(np.unique(ref[mask])) > 1
    if name == "chain-40":
        assert (ref[mask] == ref[mask].min()).all()


def test_k8_wrapper_cpu_route_and_shape_rule():
    before = tcp.connected_components_pallas.launches
    pts, mask = _blobs(3, 512, 400)
    lab = tcp.connected_components_pallas(_t(pts), _t(mask), 0.15)
    assert tcp.connected_components_pallas.launches == before and lab.dtype == torch.int32
    with pytest.raises(ValueError, match="multiple of 256"):
        tcp.connected_components_pallas(torch.zeros((300, 3)), torch.ones(300, dtype=torch.bool), 0.15)
    # stacked frames: each frame's result is its own
    p2, m2 = _blobs(4, 512, 300)
    both = tcp.connected_components_pallas(_t(np.stack([pts, p2])), _t(np.stack([mask, m2])), 0.15)
    one = tcp.connected_components_pallas(_t(p2), _t(m2), 0.15)
    assert torch.equal(both[1], one)


@pytest.mark.parametrize("m,want", [(100, (2, True)), (256, (4, True)), (512, (8, True)),
                                    (1024, (16, True)), (2048, (16, True)), (4096, (16, True)),
                                    (6144, (16, False)), (8192, (16, False))])
def test_cc_layout_choices(m, want):
    """K8's CTAs per frame on the H100 (a 16-CTA cluster at most): at most
    ROWS_PER_CTA rows each, the adjacency words in shared memory up to
    M = 4,096; past that they go to device memory on the largest cluster."""
    assert tcp.cc_layout(m) == want
    c, in_smem = want
    assert -(-m // c) <= tcp.ROWS_PER_CTA or c == 16
    assert tcp.fits_smem(m, c) == in_smem
    # the row bound of the layout: words of 4,096 rows fit 16 CTAs, not 8
    assert tcp.fits_smem(4096, 16) and not tcp.fits_smem(4096, 8)
    assert tcp.fits_smem(1024, 1) and tcp.fits_smem(2048, 4) and not tcp.fits_smem(2048, 2)


def test_cc_layout_raises_past_its_bound():
    assert tcp.cc_layout(tcp.MAX_ROWS)[0] == 16
    for m in (tcp.MAX_ROWS + 256, 0):
        with pytest.raises(ValueError, match="rows per frame"):
            tcp.cc_layout(m)


@pytest.mark.parametrize("tol", [0.15, 3.0, 1e15])
@pytest.mark.parametrize("poison", ["copies", "nonfinite"])
def test_invalid_rows_adjacent_to_nothing(tol, poison):
    """What K8's skipping of invalid rows and columns rests on: with
    tol2 < 3e38, no pair that holds an invalid row passes the d2 test,
    whatever that row holds: copies of valid points, or NaN and inf (which
    make the centre, and so every d2, NaN)."""
    pts, mask = _blobs(5, 256, 180)
    inv = np.flatnonzero(~mask)
    if poison == "copies":
        pts[inv[:6]] = pts[np.flatnonzero(mask)[:6]]
    else:
        pts[inv[:3], 0] = [np.nan, np.inf, -np.inf]
    adj = tcp.cc_adjacency_plain(_t(pts)[None], _t(mask)[None], tol)[0].numpy()
    assert not adj[~mask].any() and not adj[:, ~mask].any()
    assert adj[mask][:, mask].any() == (poison == "copies")


@pytest.mark.parametrize("m", [256, 2048])
def test_adjacency_matches_jax_on_boundary_lattice(m):
    """Any difference in the centring sum, sq or the gram would flip some
    of the lattice's boundary pairs."""
    pts, mask = _lattice(m, m)
    ref = np.asarray(jax.jit(jcl._pairwise_adjacency, static_argnums=2)(
        jnp.asarray(pts), jnp.asarray(mask), 0.15))
    got = tcl._pairwise_adjacency(_t(pts), _t(mask), 0.15).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.sum() > m                            # the lattice edges are in


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(9)
    a, b, c = (rng.normal(0, 1, 4000).astype(np.float32) for _ in range(3))
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)  # cancellations
    got = tcp.fma32(_t(a), _t(b), _t(c)).numpy()
    for i in range(0, 4000, 7):
        exact = fractions.Fraction(float(a[i])) * fractions.Fraction(float(b[i])) \
            + fractions.Fraction(float(c[i]))
        lo = np.float32(float(exact))          # nearest f64, then its f32 neighbours
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(fractions.Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best, i


def _jnp_cc(pts, mask, tol, max_iters, jumps):
    lab, it = jax.jit(jcl.connected_components, static_argnums=(2, 3, 4))(
        jnp.asarray(pts), jnp.asarray(mask), tol, max_iters, jumps)
    return np.asarray(lab), int(it)


@pytest.mark.parametrize("case", ["blobs", "chain-saturates", "empty"])
def test_jnp_cc_labels_and_iterations_exact(case):
    if case == "blobs":
        pts, mask = _blobs(5, 512, 420, n_blobs=10)
        tol, max_iters, jumps = 0.15, 32, 2
    elif case == "chain-saturates":
        pts, mask = _chain(256, 200, step=0.1)
        pts[:200] = pts[:200][::-1].copy()
        tol, max_iters, jumps = 0.12, 3, 1
    else:
        pts, mask = np.zeros((256, 3), np.float32), np.zeros(256, bool)
        tol, max_iters, jumps = 0.15, 32, 2
    ref_lab, ref_it = _jnp_cc(pts, mask, tol, max_iters, jumps)
    lab, it = tcl.connected_components(_t(pts), _t(mask), tol, max_iters, jumps)
    np.testing.assert_array_equal(lab.numpy(), ref_lab)
    assert int(it) == ref_it
    if case == "chain-saturates":
        assert ref_it == max_iters


def test_jnp_cc_batch_and_backends_agree():
    frames = [_blobs(s, 512, 380, n_blobs=9) for s in (6, 7, 8)]
    frames[1] = _chain(512, 120, step=0.1)            # converges later than the blobs
    P = _t(np.stack([f[0] for f in frames]))
    M = _t(np.stack([f[1] for f in frames]))
    lab, it = tcl.connected_components(P, M, 0.12, 32, 2)
    for s, (pts, mask) in enumerate(frames):
        ref_lab, ref_it = _jnp_cc(pts, mask, 0.12, 32, 2)
        np.testing.assert_array_equal(lab[s].numpy(), ref_lab)
        assert int(it[s]) == ref_it
    assert len(set(it.tolist())) > 1                  # frames stopped at different sweeps
    pal = tcp.connected_components_pallas(P, M, 0.12, n_sweeps=256)
    assert torch.equal(pal, lab)


def _assert_clusters_equal(got, ref):
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_euclidean_cluster_matches_jax(backend):
    """18 blobs of various sizes for C = 8 slots: more components than C,
    blobs below min_size (5) and one above max_size (60)."""
    rng = np.random.default_rng(11)
    m = 512
    sizes = [70, 3, 2, 40, 12, 25, 8, 5, 31, 4, 19, 9, 6, 14, 22, 1, 17, 11]
    pts = np.full((m, 3), 40.0, np.float32)
    row = 0
    for k, n in enumerate(sizes):
        c = np.array([(k % 6) * 1.5 - 4, (k // 6) * 1.5, 0.5])
        pts[row:row + n] = c + rng.normal(0, 0.04, (n, 3))
        row += n
    mask = np.zeros(m, bool)
    mask[:row] = True
    perm = rng.permutation(m)
    pts, mask = pts[perm], mask[perm]
    args = (0.15, 5, 60, 8, 64, 32, 2)
    ref = jax.jit(jcl.euclidean_cluster, static_argnums=tuple(range(2, 9)),
                  static_argnames="backend")(jnp.asarray(pts), jnp.asarray(mask), *args,
                                             backend=backend)
    got = tcl.euclidean_cluster(_t(pts), _t(mask), *args, backend=backend)
    _assert_clusters_equal(got, ref)
    assert int(ref.n_clusters) > 8 and int(ref.cluster_valid.sum()) == 8
    stacked = tcl.euclidean_cluster(_t(np.stack([pts, pts[::-1].copy()])),
                                    _t(np.stack([mask, mask[::-1].copy()])), *args, backend=backend)
    _assert_clusters_equal(type(got)(*(f[0] for f in stacked)), ref)


@pytest.mark.parametrize(
    "n,kind", [(1000, "runs"), (2048, "length-1"), (3 * 2048, "block-edges"), (3 * 2048, "one-run"),
               (1001, "wrap"), (7, "wrap")]
)
def test_plain_k9_matches_segment_totals_pallas(n, kind):
    rng = np.random.default_rng(n + len(kind))
    if kind == "length-1":
        ks = np.arange(n, dtype=np.int32) * 2
    elif kind == "one-run":
        ks = np.full(n, 9, np.int32)
    else:
        ks = np.repeat(np.arange(n), rng.integers(1, 30, n))[:n].astype(np.int32)
        if kind == "block-edges":
            ks[2000:2100] = ks[2000]                  # across the first block edge
            ks[4000:6144] = ks[4000]                  # over all of block 2's end and past
            ks = np.maximum.accumulate(ks)
    if n < 2048:                                      # N < 2048: one block of N rows
        ks = ks[:n]
    vals = rng.normal(0, 3, (len(ks), 4)).astype(np.float32)
    if kind == "wrap":                                # T = N, not a multiple of 8
        ks[: n // 2] = ks[0]                          # rows 0 .. 3 in one run
        vals[n - 1, 3] = np.inf                       # inf * 0 -> NaN into row 0 at sh = 1
        vals[n - 3:, 1] = -0.0                        # -0.0 * 0 added to rows 0 .. 2
        vals[:4, 2] = -0.0                            # -0.0 + (+0.0 or -0.0) from the wrap
        vals[n - 4:, 2] = np.where(np.arange(4) % 2 == 0, 1.5, -1.5)
    ref = np.asarray(segment_totals_pallas(jnp.asarray(ks), jnp.asarray(vals), interpret=True))
    before = segsum_cuda.segment_totals_rows.launches
    got = segsum_cuda.segment_totals_rows(_t(ks), _t(vals)).numpy()
    assert segsum_cuda.segment_totals_rows.launches == before        # the CPU route
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    with pytest.raises(ValueError, match="multiple of 2048"):
        segsum_cuda.segment_totals_rows(torch.zeros(3000, dtype=torch.int32), torch.zeros((3000, 4)))
