"""K3f's half builds (bf16, f16) and its f32 table build on the card against
their plain version, ``circumcenter_features_half_plain`` (GPU only:
marked ``cuda``, skipped without one; no JAX is imported, so it runs on
the GPU machine):

- on ``bench_cases.k3f_edge_tables`` at P = 100 (not a multiple of 32),
  384 and 1,100 (members with gaps, a NaN and an inf in non-member lanes,
  empty slots on a non-finite row 0, d2 ties, f16 squared norms past its
  range) and on ``chip_smoke.py::k3f_tables`` (S = 8 x C = 32, P = 384
  and 512), two frames a table so that the table build's epilogue slots
  come up; each build and, for the half builds, the mesh spelling of cy
  (``cy_alt``), one launch a call;
- against the plain version on the card bit for bit, and on the CPU bit for
  bit but for NaN payloads (the CPU makes other NaNs);
- P past ``HALF_P_MAX`` raising, naming it; P at it running.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import _bits, _chip_smoke, _widen_canonical, dev  # noqa: F401  (fixtures)

from multiple_object_tracking_lidar_tpu_torch.bench_cases import k3f_edge_tables
from multiple_object_tracking_lidar_tpu_torch.ops import centroid_cuda

pytestmark = pytest.mark.cuda
BUILDS = {"bf16": (torch.bfloat16, "motl_circumcenter_features_bf16"),
          "f16": (torch.float16, "motl_circumcenter_features_f16"),
          "table": (torch.float32, "motl_circumcenter_features_table")}


def _tables(kind, p):
    """(mpts (C, P, 3) f64, mask (C, P), frames S) on the CPU."""
    if kind == "edge":
        mp, mm = k3f_edge_tables(2300 + p, p)
        return torch.from_numpy(mp), torch.from_numpy(mm), 2
    mp, mm = _chip_smoke().k3f_tables(np.random.default_rng(p), 8, 32, p, "cpu")
    return mp.double(), mm, 8


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("cy_alt", [False, True])
@pytest.mark.parametrize("kind,p", [("edge", 100), ("edge", 384), ("edge", 1100),
                                    ("k3f_tables", 384), ("k3f_tables", 512)])
def test_k3f_half_and_table_builds_match_plain(dev, build, cy_alt, kind, p):
    dt, entry = BUILDS[build]
    table = build == "table"
    if cy_alt and table:
        pytest.skip("the mesh spelling of cy is the half builds'")
    mp64, mm, s = _tables(kind, p)
    mp = mp64.to(dt)
    t = (torch.arange(s, dtype=torch.float64) * 0.1 + 100.0).to(dt)
    c = mp.shape[0]
    by = centroid_cuda.circumcenter_features.launches_by
    with centroid_cuda.mesh_program(cy_alt):
        n0 = by[entry]
        got = centroid_cuda.circumcenter_features(mp.to(dev), mm.to(dev), t.to(dev), table=table)
        assert by[entry] == n0 + 1 and got.dtype == dt
        on_card = centroid_cuda.circumcenter_features_half_plain(
            mp.to(dev), mm.to(dev), t.to(dev), c // s, cy_alt)
        on_cpu = centroid_cuda.circumcenter_features_half_plain(mp, mm, t, c // s, cy_alt)
    assert _bits(got.float(), on_card.float())
    assert _bits(_widen_canonical(got), _widen_canonical(on_cpu))


@pytest.mark.parametrize("build", list(BUILDS))
def test_k3f_half_p_past_bound_raises(dev, build):
    dt, _ = BUILDS[build]
    table = build == "table"
    t = torch.zeros(1, dtype=dt, device=dev)
    p = centroid_cuda.HALF_P_MAX + 1
    with pytest.raises(ValueError, match="HALF_P_MAX"):
        centroid_cuda.circumcenter_features(torch.zeros((1, p, 3), dtype=dt, device=dev),
                                            torch.zeros((1, p), dtype=torch.bool, device=dev),
                                            t, table=table)
    p = centroid_cuda.HALF_P_MAX
    rng = np.random.default_rng(p)
    mp = torch.from_numpy(rng.normal(0, 2, (2, p, 3))).to(dt).to(dev)
    mm = torch.from_numpy(rng.random((2, p)) < 0.05).to(dev)
    got = centroid_cuda.circumcenter_features(mp, mm, t, table=table)
    want = centroid_cuda.circumcenter_features_half_plain(mp, mm, t, 2)
    assert _bits(got.float(), want.float())
