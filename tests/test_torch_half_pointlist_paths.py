"""``dtype="bfloat16"`` and ``"float16"`` on the perception front ends
through ``Tracker.bind_env``, against the JAX package under ``jax.jit`` on
the CPU: the point list under each voxel mode with the jnp CC and with
the Pallas CC (configurations C, D -- G's form --, E and F) and the dense
grid fed by the scatter sums and by the sorted runs (B), on 12 cut
headline frames.  ``FRONT_ENDS`` also names the one-hot point list and the
runs with the jnp CC, which tests/test_torch_half_pointlist_more.py runs,
with ``bind_env_multi`` and the nodes.  The helpers and the comparisons
are tests/test_torch_half.py's: every output bit for bit."""

import numpy as np
import pytest

from test_torch_golden import one_intra_op_thread  # noqa: F401  (the fixture)
from test_torch_half import (
    N_FRAMES,
    TORCH,
    _check_outputs,
    _configs,
    _frames,
    _jax_entry,
    _jax_exact_from_k5,
    _port_entry,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# bench_cases / make_torch_golden.py names; "onehot_*" the one-hot point list
FRONT_ENDS = {
    "C": dict(voxel_mode="dense", cluster_backend="pallas"),
    "D": dict(voxel_mode="dense", cluster_backend="jnp"),
    "E": dict(voxel_mode="scan", cluster_backend="jnp"),
    "F": dict(voxel_mode="runs", cluster_backend="pallas"),
    "runs_jnp": dict(voxel_mode="runs", cluster_backend="jnp"),
    "B": dict(voxel_mode="runs", cluster_backend="grid"),
    "dense_grid": dict(voxel_mode="dense", cluster_backend="grid"),
    "onehot_jnp": dict(voxel_mode="onehot", cluster_backend="jnp"),
    "onehot_pallas_exact": dict(voxel_mode="onehot", cluster_backend="pallas",
                                voxel_quant="exact"),
}


def run_front_end(name, dtype, entry, n=N_FRAMES, **extra):
    """The port's and the JAX package's outputs of front end ``name`` under
    ``dtype`` through ``entry`` over n cut headline frames, compared field
    by field; returns the tracks published.  Exact digits are held to the
    JAX route from the exact digits' sums (``_jax_exact_from_k5``)."""
    fields = {**FRONT_ENDS[name], **extra}
    jcfg, jenv, tcfg, tenv, sc = _configs(dtype, **fields)
    frames = _frames(sc, n=n)
    want = (_jax_exact_from_k5(jcfg, jenv, tcfg, frames) if fields.get("voxel_quant") == "exact"
            else _jax_entry(jcfg, jenv, frames, entry))
    got = _port_entry(tcfg, tenv, frames, entry)
    published = 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.raw_centroid.dtype == TORCH[dtype] and g.pos.dtype == TORCH[dtype]
        _check_outputs(f"{name}/{dtype}/{entry} frame {k}", g, w)
        published += int(np.asarray(w.valid).sum())
    return published


@pytest.mark.parametrize("name", ["C", "D", "E", "F", "B", "dense_grid"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_front_ends_match_jax_through_bind_env(name, dtype):
    assert run_front_end(name, dtype, "bind_env") >= 2 * (N_FRAMES - 2)
