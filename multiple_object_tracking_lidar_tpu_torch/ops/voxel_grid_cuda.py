"""K1: the single-digit ("fast") voxel histogram with its finalize.

Replaces the Pallas kernels ``multiple_object_tracking_lidar_tpu/ops/
voxel_grid.py::_accumulate_pallas_v5`` and ``_accumulate_pallas_v5_stacked``
(one CUDA kernel; the single-frame call is S = 1).  CUDA source:
``csrc/voxel_grid.cu``, whose header says what bounds it on the H100 and
how its design answers that: per-CTA int32 shared-memory histograms merged
with integer atomics, so the sums are exact and deterministic.

``accumulate_fast_stacked`` launches the kernel for CUDA tensors and runs
``accumulate_fast_stacked_plain`` for CPU tensors; ``.launches`` counts
kernel launches.  Both return ``((S, 4, n_cells) f32 [sum_x, sum_y, sum_z,
count], (S,) i32 mask-nonzero point count)``.
"""

from __future__ import annotations

import math

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import f32, grid_shape

# Points per CTA: 13 CTAs per 106,496-point frame, each zeroing and merging
# one (4, n_cells) shared histogram.
PTS_PER_CTA = 8192
SMEM_BYTES = 232448  # what one H100 block may use (227 KB)


def v4_shifts(leaf_xy: float, leaf_z: float) -> tuple[int, int]:
    """Largest power-of-two digit scales with leaf/2 * 2^k <= 126
    (voxel_grid.py::_v4_shifts)."""
    kx = int(math.floor(math.log2(252.0 / leaf_xy)))
    kz = int(math.floor(math.log2(252.0 / leaf_z)))
    return kx, kz


def kernel_params(scene: SceneBounds, leaf_xy: float, leaf_z: float) -> dict:
    """Grid geometry and the f32 constants of the quantize and finalize:
    f64 values cast to f32, as ``_v5_kernel_params`` hands them to Pallas."""
    gx, gy, gz = grid_shape(scene, leaf_xy, leaf_z)
    kx, kz = v4_shifts(leaf_xy, leaf_z)
    return dict(
        gx=gx, gy=gy, gz=gz, n_cells=gx * gy * gz,
        bx=math.floor(scene.x_min / leaf_xy),
        by=math.floor(scene.y_min / leaf_xy),
        bz=math.floor(scene.z_min / leaf_z),
        inv_xy=f32(1.0 / leaf_xy), inv_z=f32(1.0 / leaf_z),
        leaf_xy=f32(leaf_xy), leaf_z=f32(leaf_z),
        half_xy=f32(0.5 * leaf_xy), half_z=f32(0.5 * leaf_z),
        sq_xy=f32(2.0**kx), sq_z=f32(2.0**kz),
        invq_xy=f32(2.0**-kx), invq_z=f32(2.0**-kz),
    )


def _digit(p, fl, leaf, half, sq):
    """round-half-even((p - fl*leaf) - half) * 2^k), clipped to +-127."""
    frac = (p - fl * leaf) - half
    return torch.clamp(torch.round(frac * sq), -127, 127).to(torch.int64)


def accumulate_fast_stacked_plain(points, mask, scene, leaf_xy, leaf_z):
    """Plain PyTorch version of K1: same f32 quantize, exact integer sums
    (index_add_ on int64), same finalize products."""
    k = kernel_params(scene, leaf_xy, leaf_z)
    s, n = points.shape[0], points.shape[1]
    nc = k["n_cells"]
    dev = points.device
    p = points.to(torch.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    fx = torch.floor(x * k["inv_xy"])
    fy = torch.floor(y * k["inv_xy"])
    fz = torch.floor(z * k["inv_z"])
    m = mask.reshape(s, n) != 0
    # bounds on the float floor, before any cast: NaN fails every compare
    ok = (
        m
        & (fx >= k["bx"]) & (fx < k["bx"] + k["gx"])
        & (fy >= k["by"]) & (fy < k["by"] + k["gy"])
        & (fz >= k["bz"]) & (fz < k["bz"] + k["gz"])
    )
    fx = torch.where(ok, fx, float(k["bx"]))
    fy = torch.where(ok, fy, float(k["by"]))
    fz = torch.where(ok, fz, float(k["bz"]))
    ix = fx.to(torch.int64) - k["bx"]
    iy = fy.to(torch.int64) - k["by"]
    iz = fz.to(torch.int64) - k["bz"]
    lin = ix + k["gx"] * (iy + k["gy"] * iz)
    frame = torch.arange(s, device=dev)[:, None]
    dump = s * nc
    tgt = torch.where(ok, frame * nc + lin, dump).reshape(-1)
    digits = torch.stack(
        [
            _digit(x, fx, k["leaf_xy"], k["half_xy"], k["sq_xy"]),
            _digit(y, fy, k["leaf_xy"], k["half_xy"], k["sq_xy"]),
            _digit(z, fz, k["leaf_z"], k["half_z"], k["sq_z"]),
            torch.ones_like(ix),
        ],
        dim=-1,
    ).reshape(-1, 4)
    sums = torch.zeros((dump + 1, 4), dtype=torch.int64, device=dev)
    sums.index_add_(0, tgt, digits)
    sums = sums[:dump].reshape(s, nc, 4).permute(0, 2, 1).to(torch.int32)
    npts = m.sum(dim=1).to(torch.int32)
    return finalize_fast_digits(sums, k), npts


def finalize_fast_digits(sums: torch.Tensor, k: dict) -> torch.Tensor:
    """(S, 4, n_cells) i32 digit sums -> f32 [sum_x, sum_y, sum_z, count]:
    cnt * (cell0 + half) + digit_sum * 2^-k (``_v4_finalize_into``)."""
    lin = torch.arange(k["n_cells"], device=sums.device)
    ix = lin % k["gx"]
    iyz = lin // k["gx"]
    iy = iyz % k["gy"]
    iz = iyz // k["gy"]
    cx = (k["bx"] + ix).to(torch.float32) * k["leaf_xy"]
    cy = (k["by"] + iy).to(torch.float32) * k["leaf_xy"]
    cz = (k["bz"] + iz).to(torch.float32) * k["leaf_z"]
    sf = sums.to(torch.float32)
    cnt = sf[:, 3]
    return torch.stack(
        [
            cnt * (cx + k["half_xy"]) + sf[:, 0] * k["invq_xy"],
            cnt * (cy + k["half_xy"]) + sf[:, 1] * k["invq_xy"],
            cnt * (cz + k["half_z"]) + sf[:, 2] * k["invq_z"],
            cnt,
        ],
        dim=1,
    )


def max_cells() -> int:
    """Largest grid K1's per-CTA (4, n_cells) int32 histogram holds."""
    return SMEM_BYTES // 16


def accumulate_fast_stacked(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if points.device.type == "cpu":
        return accumulate_fast_stacked_plain(points, mask, scene, leaf_xy, leaf_z)
    if points.dim() != 3 or points.shape[2] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points must be (S, N, 3) float32, got {tuple(points.shape)} {points.dtype}")
    s, n = points.shape[0], points.shape[1]
    if mask.shape != (s, n) or mask.device != points.device:
        raise ValueError(f"mask must be ({s}, {n}) on {points.device}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    k = kernel_params(scene, leaf_xy, leaf_z)
    nc = k["n_cells"]
    if nc > max_cells():
        raise ValueError(
            f"{nc} grid cells exceed K1's shared-memory histogram "
            f"({max_cells()} cells at 16 B/cell); a global-memory variant is "
            "still to be ported (ROADMAP)"
        )
    m8 = (mask != 0).to(torch.uint8).contiguous()
    dev = points.device
    acc_i = torch.zeros((s, 4, nc), dtype=torch.int32, device=dev)
    out = torch.empty((s, 4, nc), dtype=torch.float32, device=dev)
    npts = torch.zeros((s,), dtype=torch.int32, device=dev)
    lib = _build.load()
    err = lib.motl_voxel_accumulate(
        points.data_ptr(), m8.data_ptr(), s, n, PTS_PER_CTA,
        acc_i.data_ptr(), out.data_ptr(), npts.data_ptr(), nc,
        k["gx"], k["gy"], k["gz"], k["bx"], k["by"], k["bz"],
        k["inv_xy"], k["inv_z"], k["leaf_xy"], k["leaf_z"],
        k["half_xy"], k["half_z"], k["sq_xy"], k["sq_z"],
        k["invq_xy"], k["invq_z"], _build.stream_ptr(dev),
    )
    _build.check(err, "motl_voxel_accumulate")
    accumulate_fast_stacked.launches += 1
    return out, npts


accumulate_fast_stacked.launches = 0
