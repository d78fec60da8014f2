"""The dense voxel accumulators: K1 (fast digits), K5 (exact digits) and
K6 (bf16x3 sums).

- K1 replaces the Pallas kernels ``multiple_object_tracking_lidar_tpu/ops/
  voxel_grid.py::_accumulate_pallas_v5`` / ``_v5_stacked`` and their i32
  twins ``_accumulate_pallas_v4`` / ``_v4_stacked`` (``csrc/voxel_grid.cu``):
  one int8 digit per axis.
- K5 replaces ``_accumulate_pallas_v6`` / ``_v6_stacked`` and their i32
  twins ``_accumulate_pallas_v3`` / ``_v3_stacked`` (``csrc/voxel_exact.cu``):
  two balanced int8 digits per axis, seven channels.
- K6 replaces ``_accumulate_pallas_v2`` and the jnp bf16x3 lowering
  (``csrc/voxel_bf16x3.cu``): f32 sums of three bf16 parts per coordinate,
  in the fixed order its header writes down.  Its key entry
  (``accumulate_bf16x3_keys``) replaces ``_accumulate_pallas``, the TPU's
  first accumulator, which takes precomputed grid indices.  Its f32 mode
  sums the plain coordinates in the same order: the point-list dense
  accumulator (``voxel_mode="dense"``), whose JAX form is an XLA
  scatter-add, not a Pallas kernel; on f64 points its double build
  (K6f f64, ``dtype="float64"``) sums them in f64, the cells from the
  points rounded to f32; its half builds (K6f bf16 / f16, the half
  dtypes) sum f32 points holding half values in the half dtype, each add
  rounded, the count saturating (``half_count``).  K1, K5 and K6's bf16x3
  mode have f32 builds alone: the one-hot routes sum in f32 under every
  dtype, and the caller rounds the sums.

Each CUDA header says what bounds the kernel on the H100 and how its design
answers that.  K1 and K5 sum integer digits with integer atomics, so their
sums are exact and deterministic; K6 sums floats in a fixed order with no
float atomics.  One kernel call covers S stacked frames; a single frame is
S = 1.

Each wrapper (``accumulate_fast_stacked``, ``accumulate_exact_stacked``,
``accumulate_bf16x3_stacked``, ``accumulate_f32_stacked``) launches its
kernel for CUDA tensors and runs its ``*_plain`` version for CPU tensors;
``.launches`` counts kernel launches (``accumulate_f32_stacked.launches_by``
counts its f32 and double builds' by C entry).  All return ``((S, 4, n_cells) [sum_x, sum_y, sum_z,
count]`` in f32 (f64 from the double build), ``(S,) i32 mask-nonzero point
count)``.

K1-cm (``accumulate_fast_stacked_cm`` and ``_cm_raw``) is K1 reading
(S, 3, N) channel-major points, the layout of the TPU's accumulator
probes in ``scripts/micro_acc_v5.py`` and ``micro_acc_v7.py``.

K1 and K5 are one launch per call (``csrc/digit_cluster.cuh``): the
grid's cells in ranges, each held in one CTA's shared memory, the frame's
points in chunks, the chunks of a range one thread-block cluster
(``digit_layout``), at any grid size: up to ``max_cells`` cells the
ranges of PR 8's layouts, past it more ranges ("K1 wide", "K5 wide"), each
CTA reading every point of its frame and keeping its own range.
The kernel fleet (``parallel/sharding.py``) runs their histograms and
finalizes apart: ``accumulate_*_stacked_raw`` gives the int32 digit sums,
the fleet all-reduces them over its point shards, and
``finalize_*_stacked`` finalizes once -- the TPU's
``_accumulate_pallas_v{5,4,6,3}_stacked_raw`` with ``finalize_*_digits``.
These four wrappers count their launches too.
"""

from __future__ import annotations

import collections
import functools
import math

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.config import SceneBounds
from multiple_object_tracking_lidar_tpu_torch.ops.cluster_pallas import fma32
from multiple_object_tracking_lidar_tpu_torch.ops.grid_cuda import max_cluster
from multiple_object_tracking_lidar_tpu_torch.ops.voxel import f32, grid_shape

SMEM_BYTES = 232448  # what one H100 block may use (227 KB)
_STATIC_SMEM = 128   # K1's / K5's static shared words, rounded up
# cells one CTA of K1 holds: four int32 channels, 16 B per cell (K5's
# groups hold three, so they hold at least as many); a multiple of 4
CTA_CELLS = (SMEM_BYTES - _STATIC_SMEM) // 16
# Layout rule (``digit_layout``): CTAs per K1 / K5 launch to aim for.  On
# an H100 (700 W), scripts/micro_torch_digits.py --sweep timed every layout
# at S = 1 and 8 on the headline's 5,500 cells, the CLI's 70,200 and the
# default scene's 193,536: the best took 32-128 CTAs per launch (all channel
# groups), e.g. K1 at the headline S = 1 10.3 us at 1 x 16 x 4 (frames x
# chunks x ranges) against 15.3 at 1 x 16 x 1, at S = 8 15.6 us at 8 x 8 x 1
# against 29.8 at 8 x 16 x 1; more CTAs wait on cluster scheduling.
CTA_BUDGET = 96
# K6: points per CTA of its radix-sort stages (csrc/voxel_bf16x3.cu kTile)
SORT_TILE = 2048

FXP_XY = 19  # exact mode's digit scales (voxel_grid.py::_FXP_XY, _FXP_Z)
FXP_Z = 14


def v4_shifts(leaf_xy: float, leaf_z: float) -> tuple[int, int]:
    """Largest power-of-two digit scales with leaf/2 * 2^k <= 126
    (voxel_grid.py::_v4_shifts)."""
    kx = int(math.floor(math.log2(252.0 / leaf_xy)))
    kz = int(math.floor(math.log2(252.0 / leaf_z)))
    return kx, kz


def kernel_params(
    scene: SceneBounds, leaf_xy: float, leaf_z: float, quant: str = "fast"
) -> dict:
    """Grid geometry and the f32 constants of the quantize and finalize:
    f64 values cast to f32, as ``_v5_kernel_params`` / ``_v6_kernel_params``
    hand them to Pallas.  ``quant`` picks the digit scales: the per-leaf
    single-digit shifts ("fast") or the fixed 2^19 / 2^14 ("exact")."""
    gx, gy, gz = grid_shape(scene, leaf_xy, leaf_z)
    kx, kz = v4_shifts(leaf_xy, leaf_z) if quant == "fast" else (FXP_XY, FXP_Z)
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


def kept_cells(p: torch.Tensor, mask: torch.Tensor, k: dict):
    """The kernels' drop test and cell index, for (S, N, 3) f32 points.
    Returns (ok (S, N) bool, lin (S, N) int64, floors (fx, fy, fz) f32):
    bounds are tested on the float floor before any cast, so NaN fails every
    compare; dropped points get lin 0 and floors at the grid base."""
    fx = torch.floor(p[..., 0] * k["inv_xy"])
    fy = torch.floor(p[..., 1] * k["inv_xy"])
    fz = torch.floor(p[..., 2] * k["inv_z"])
    ok = (
        (mask.reshape(p.shape[:-1]) != 0)
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
    return ok, ix + k["gx"] * (iy + k["gy"] * iz), (fx, fy, fz)


def _frac_scaled(p, fl, leaf, half, sq, ok):
    """(fma(-fl, leaf, p) - half) * 2^k in f32, zero where dropped, before
    rounding: ``p - cell0 - half`` with ``p - fl * leaf`` rounded once, as
    XLA's CPU code contracts ``_v5_quant_cm`` / ``_v6_quant_cm``."""
    frac = fma32(-fl, torch.full_like(fl, leaf), p) - half
    return torch.where(ok, frac, 0.0) * sq


def _digit_sums(digits: torch.Tensor, ok: torch.Tensor, lin: torch.Tensor, nc: int):
    """(S, N, C) int64 per-point digits -> (S, C, nc) int32 exact sums."""
    s = ok.shape[0]
    frame = torch.arange(s, device=ok.device)[:, None]
    dump = s * nc
    tgt = torch.where(ok, frame * nc + lin, dump).reshape(-1)
    sums = torch.zeros((dump + 1, digits.shape[-1]), dtype=torch.int64, device=ok.device)
    sums.index_add_(0, tgt, digits.reshape(-1, digits.shape[-1]))
    return sums[:dump].reshape(s, nc, -1).permute(0, 2, 1).to(torch.int32)


def _cell_centres(k: dict, n: int, device):
    """The centre cell0 + half of each of the first n flat cells, f32: the
    integer decomposition of ``_v4_finalize_into`` and its
    ``(base + i) * leaf + half`` rounded once, as XLA's CPU code contracts
    it."""
    lin = torch.arange(n, device=device)
    ix = lin % k["gx"]
    iyz = lin // k["gx"]
    iy = iyz % k["gy"]
    iz = iyz // k["gy"]

    def centre(i, leaf, half):
        i = i.to(torch.float32)
        return fma32(i, torch.full_like(i, leaf), torch.full_like(i, half))

    return (centre(k["bx"] + ix, k["leaf_xy"], k["half_xy"]),
            centre(k["by"] + iy, k["leaf_xy"], k["half_xy"]),
            centre(k["bz"] + iz, k["leaf_z"], k["half_z"]))


def _finalize_axis(cnt, centre, s, invq):
    """cnt * centre + s * 2^-k rounded once (the finalize's FMA)."""
    return fma32(cnt, centre.expand_as(cnt), s * invq)


def _npts(mask: torch.Tensor, s: int) -> torch.Tensor:
    return (mask.reshape(s, -1) != 0).sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# K1: fast digits
# ---------------------------------------------------------------------------
def fast_digit_sums(points, mask, scene, leaf_xy, leaf_z) -> torch.Tensor:
    """(S, 4, n_cells) int32 raw one-digit sums of K1 before its finalize
    (x, y, z digit, count): ``_v5_quant_cm``'s f32 quantize, exact integer
    sums (index_add_ on int64)."""
    k = kernel_params(scene, leaf_xy, leaf_z)
    p = points.to(torch.float32)
    ok, lin, (fx, fy, fz) = kept_cells(p, mask, k)

    def digit(c, fl, leaf, half, sq):
        q = torch.round(_frac_scaled(p[..., c], fl, leaf, half, sq, ok))
        return torch.clamp(q, -127, 127).to(torch.int64)

    digits = torch.stack(
        [
            digit(0, fx, k["leaf_xy"], k["half_xy"], k["sq_xy"]),
            digit(1, fy, k["leaf_xy"], k["half_xy"], k["sq_xy"]),
            digit(2, fz, k["leaf_z"], k["half_z"], k["sq_z"]),
            torch.ones_like(lin),
        ],
        dim=-1,
    )
    return _digit_sums(digits, ok, lin, k["n_cells"])


def accumulate_fast_stacked_plain(points, mask, scene, leaf_xy, leaf_z):
    """Plain PyTorch version of K1: ``fast_digit_sums`` finalized by
    ``finalize_fast_digits`` (the kernel's finalize products)."""
    sums = fast_digit_sums(points, mask, scene, leaf_xy, leaf_z)
    k = kernel_params(scene, leaf_xy, leaf_z)
    return finalize_fast_digits(sums, k), _npts(mask, points.shape[0])


def finalize_fast_digits(sums: torch.Tensor, k: dict) -> torch.Tensor:
    """(S, 4, n_cells) i32 digit sums -> f32 [sum_x, sum_y, sum_z, count]:
    fma(cnt, cell0 + half, digit_sum * 2^-k) (``_v4_finalize_into`` as
    XLA's CPU code contracts it)."""
    cx, cy, cz = _cell_centres(k, k["n_cells"], sums.device)
    sf = sums.to(torch.float32)
    cnt = sf[:, 3]
    return torch.stack(
        [
            _finalize_axis(cnt, cx, sf[:, 0], k["invq_xy"]),
            _finalize_axis(cnt, cy, sf[:, 1], k["invq_xy"]),
            _finalize_axis(cnt, cz, sf[:, 2], k["invq_z"]),
            cnt,
        ],
        dim=1,
    )


def max_cells(device=None) -> int:
    """Largest grid of ``max_cluster`` ranges (16 on the H100) of
    ``CTA_CELLS`` cells each, 232,320 cells: PR 8's layouts.  Past it K1
    and K5 take more ranges (``digit_layout``), the CTAs of a range reading
    their chunks of the frame's points: at the floor's 1,119,963 cells 128
    ranges of one chunk, i.e. 128 reads of each point, ~200 MB of L2
    traffic per frame at N = 131,072, spread over 128 SMs -- where one pass
    of int32 atomicAdds into a zeroed device histogram would move the 18
    MB histogram through device memory twice (zero, then finalize) in two
    more launches, and its atomics would leave the SM."""
    return max_cluster(device) * CTA_CELLS


def _span(n_cells: int, ranges: int) -> int:
    """Cells a CTA holds: ceil(n_cells / ranges), rounded up to 4."""
    per = -(-n_cells // ranges)
    return (per + 3) // 4 * 4


def digit_layout(n_cells: int, s: int, groups: int = 1, device=None) -> tuple[int, int]:
    """(ranges, chunks) of a K1 (``groups`` 1) or K5 (3) launch over S
    frames: the fewest cell ranges C (a power of two, any number) whose
    CTAs hold their range in shared memory (``CTA_CELLS``); then the most
    point chunks R (the cluster size, a power of two up to
    ``max_cluster``), and then the most ranges, that keep S x groups x C x R
    within ``CTA_BUDGET`` CTAs."""
    top = max_cluster(device)
    ranges = 1
    while _span(n_cells, ranges) > CTA_CELLS:
        ranges *= 2
    chunks = 1
    while chunks < top and s * groups * ranges * chunks * 2 <= CTA_BUDGET:
        chunks *= 2
    while ranges < top and s * groups * ranges * chunks * 2 <= CTA_BUDGET:
        ranges *= 2
    return ranges, chunks


def _check_points(points, mask, name, channel_major=False, dtypes=None):
    """(S, N) of (S, N, 3) points, or of (S, 3, N) ones where
    ``channel_major``, of a dtype in ``dtypes`` (f32 by default);
    ValueError where they or the mask do not fit."""
    axis, layout = (1, "(S, 3, N)") if channel_major else (2, "(S, N, 3)")
    dtypes = dtypes or (torch.float32,)
    if points.dim() != 3 or points.shape[axis] != 3 or points.dtype not in dtypes:
        kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(
            f"{name}: points must be {layout} {kinds}, got {tuple(points.shape)} {points.dtype}"
        )
    s, n = points.shape[0], points.shape[3 - axis]
    if mask.shape != (s, n) or mask.device != points.device:
        raise ValueError(f"{name}: mask must be ({s}, {n}) on {points.device}")
    if not points.is_contiguous():
        raise ValueError(f"{name}: points must be contiguous")
    return s, n


@functools.lru_cache(maxsize=64)
def _launch_geometry(scene: SceneBounds, leaf_xy: float, leaf_z: float, quant: str) -> tuple:
    """``kernel_params`` in the order the K1 / K5 entries take them
    (n_cells, the grid's six ints, ten f32 constants), once per (scene,
    leaf, quant)."""
    k = kernel_params(scene, leaf_xy, leaf_z, quant=quant)
    return tuple(k[key] for key in (
        "n_cells", "gx", "gy", "gz", "bx", "by", "bz", "inv_xy", "inv_z", "leaf_xy", "leaf_z",
        "half_xy", "half_z", "sq_xy", "sq_z", "invq_xy", "invq_z"))


def _launch_digits(name, entry, quant, n_ch, points, mask, scene, leaf_xy, leaf_z,
                   raw=False, channel_major=False, ranges=None, chunks=None):
    """Launch K1 or K5 once (the same C signatures): ((S, 4, n_cells) f32,
    (S,) i32); with ``raw`` the ``*_raw`` entry, ((S, n_ch, n_cells) int32
    digit sums, (S,) i32); with ``channel_major`` K1-cm's ``*_cm`` entries
    on (S, 3, N) points.  ``ranges`` / ``chunks`` (default
    ``digit_layout``) split the cells and the points over the CTAs."""
    s, n = _check_points(points, mask, name, channel_major)
    geom = _launch_geometry(scene, leaf_xy, leaf_z, quant)
    nc = geom[0]
    dev = points.device
    auto = digit_layout(nc, s, 1 if quant == "fast" else 3, dev)
    ranges = auto[0] if ranges is None else ranges
    chunks = auto[1] if chunks is None else chunks
    top = max_cluster(dev)
    if (ranges < 1 or ranges & (ranges - 1) or chunks not in (1, 2, 4, 8, 16)
            or chunks > top or _span(nc, ranges) > CTA_CELLS):
        raise ValueError(f"{name}: {ranges} ranges x {chunks} chunks cannot hold {nc} cells "
                         f"({CTA_CELLS} per CTA, ranges a power of two, at most {top} "
                         "chunks)")
    m8 = _build.byte_mask(mask)
    out = (torch.empty((s, n_ch, nc), dtype=torch.int32, device=dev) if raw
           else torch.empty((s, 4, nc), dtype=torch.float32, device=dev))
    npts = torch.empty((s,), dtype=torch.int32, device=dev)
    entry += ("_cm" if channel_major else "") + ("_raw" if raw else "")
    err = getattr(_build.load(), entry)(
        points.data_ptr(), m8.data_ptr(), s, n, ranges, chunks, out.data_ptr(),
        npts.data_ptr(), *geom, _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    return out, npts


def _launch_finalize(entry, quant, n_ch, sums, scene, leaf_xy, leaf_z):
    """Launch K1's or K5's finalize alone on (S, n_ch, n_cells) int32 digit
    sums: (S, 4, n_cells) f32."""
    (nc, gx, gy, _, bx, by, bz, _, _, leaf_xy32, leaf_z32, half_xy, half_z, _, _,
     invq_xy, invq_z) = _launch_geometry(scene, leaf_xy, leaf_z, quant)
    s = sums.shape[0]
    if sums.shape != (s, n_ch, nc) or sums.dtype != torch.int32:
        raise ValueError(f"{entry}: sums must be (S, {n_ch}, {nc}) int32, "
                         f"got {tuple(sums.shape)} {sums.dtype}")
    sums = sums.contiguous()
    out = torch.empty((s, 4, nc), dtype=torch.float32, device=sums.device)
    err = getattr(_build.load(), entry)(
        sums.data_ptr(), out.data_ptr(), s, nc, gx, gy, bx, by, bz, leaf_xy32, leaf_z32,
        half_xy, half_z, invq_xy, invq_z, _build.stream_ptr(sums.device),
    )
    _build.check(err, entry)
    return out


def accumulate_fast_stacked(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    *,
    ranges: int | None = None,
    chunks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors.  ``ranges`` and
    ``chunks`` split the grid's cells and the frame's points over the CTAs
    (default ``digit_layout``); the results are the same bits whatever they
    are, and a CPU tensor ignores them (as every K1 / K5 wrapper below
    does)."""
    if points.device.type == "cpu":
        return accumulate_fast_stacked_plain(points, mask, scene, leaf_xy, leaf_z)
    out = _launch_digits("K1", "motl_voxel_accumulate", "fast", 4,
                         points, mask, scene, leaf_xy, leaf_z,
                         ranges=ranges, chunks=chunks)
    accumulate_fast_stacked.launches += 1
    return out


accumulate_fast_stacked.launches = 0


def accumulate_fast_stacked_raw(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    *,
    ranges: int | None = None,
    chunks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's histogram without its finalize, the kernel fleet's accumulator:
    ((S, 4, n_cells) int32 digit sums [x, y, z, count], (S,) i32
    mask-nonzero counts), to be summed over point shards and finalized once
    (``finalize_fast_stacked``).  Replaces ``_accumulate_pallas_v5_stacked_raw``
    and ``_v4_stacked_raw`` (voxel_grid.py:1642, :1778), whose (S, 4, w1,
    128) layout is this one padded to a multiple of 128 cells.  The TPU
    takes v5 (f32 sums) while the global point count keeps them under 2^24
    (``_v5_exact_n``) and v4 (int32) beyond; both give the same integers,
    and this kernel sums in int32 with no 2^24 bound, so that choice picks
    the same kernel either way.  Kernel on CUDA tensors, ``fast_digit_sums``
    on CPU tensors."""
    if points.device.type == "cpu":
        return fast_digit_sums(points, mask, scene, leaf_xy, leaf_z), _npts(mask, points.shape[0])
    out = _launch_digits("K1 raw", "motl_voxel_accumulate", "fast", 4,
                         points, mask, scene, leaf_xy, leaf_z, raw=True,
                         ranges=ranges, chunks=chunks)
    accumulate_fast_stacked_raw.launches += 1
    return out


accumulate_fast_stacked_raw.launches = 0


def finalize_fast_stacked(sums: torch.Tensor, scene: SceneBounds, leaf_xy: float,
                          leaf_z: float) -> torch.Tensor:
    """K1's finalize alone: (S, 4, n_cells) int32 digit sums -> (S, 4,
    n_cells) f32 accumulator, the kernel fleet's counterpart of
    ``finalize_fast_digits`` (voxel_grid.py:1900).  Kernel on CUDA tensors,
    ``finalize_fast_digits`` on CPU tensors."""
    if sums.device.type == "cpu":
        return finalize_fast_digits(sums, kernel_params(scene, leaf_xy, leaf_z))
    out = _launch_finalize("motl_voxel_finalize_fast", "fast", 4, sums, scene, leaf_xy, leaf_z)
    finalize_fast_stacked.launches += 1
    return out


finalize_fast_stacked.launches = 0


# ---------------------------------------------------------------------------
# K1-cm: K1 reading channel-major points
# ---------------------------------------------------------------------------
def accumulate_fast_stacked_cm_plain(points_cm, mask, scene, leaf_xy, leaf_z):
    """Plain PyTorch version of K1-cm: K1's on the transposed points."""
    return accumulate_fast_stacked_plain(points_cm.transpose(1, 2), mask, scene, leaf_xy, leaf_z)


def accumulate_fast_stacked_cm(
    points_cm: torch.Tensor,   # (S, 3, N) f32
    mask: torch.Tensor,        # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    *,
    ranges: int | None = None,
    chunks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-cm: K1's function on channel-major points, the layout of the
    TPU's accumulator probes (``scripts/micro_acc_v5.py``' ``make_v5``,
    ``make_v4bf16``, ``make_v5_stacked``; ``micro_acc_v7.py::
    make_v7_stacked``), bit for bit K1's result.  Kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if points_cm.device.type == "cpu":
        return accumulate_fast_stacked_cm_plain(points_cm, mask, scene, leaf_xy, leaf_z)
    out = _launch_digits("K1-cm", "motl_voxel_accumulate", "fast", 4, points_cm, mask,
                         scene, leaf_xy, leaf_z, channel_major=True,
                         ranges=ranges, chunks=chunks)
    accumulate_fast_stacked_cm.launches += 1
    return out


accumulate_fast_stacked_cm.launches = 0


def accumulate_fast_stacked_cm_raw(
    points_cm: torch.Tensor,   # (S, 3, N) f32
    mask: torch.Tensor,        # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    *,
    ranges: int | None = None,
    chunks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1-cm's histogram alone: ((S, 4, n_cells) int32 digit sums, (S,)
    i32), as ``accumulate_fast_stacked_raw`` gives for the (S, N, 3)
    points; finalized by ``finalize_fast_stacked``.  Kernel on CUDA
    tensors, ``fast_digit_sums`` of the transposed points on CPU tensors."""
    if points_cm.device.type == "cpu":
        pts = points_cm.transpose(1, 2)
        return fast_digit_sums(pts, mask, scene, leaf_xy, leaf_z), _npts(mask, pts.shape[0])
    out = _launch_digits("K1-cm raw", "motl_voxel_accumulate", "fast", 4, points_cm, mask,
                         scene, leaf_xy, leaf_z, raw=True, channel_major=True,
                         ranges=ranges, chunks=chunks)
    accumulate_fast_stacked_cm_raw.launches += 1
    return out


accumulate_fast_stacked_cm_raw.launches = 0


# ---------------------------------------------------------------------------
# K5: exact digits
# ---------------------------------------------------------------------------
def split_exact_digits(fq: torch.Tensor):
    """fq (int64) -> two balanced int8 digits: d0 = ((fq+128)&255)-128,
    d1 = (fq-d0) >> 8, so fq = d0 + 256*d1 (``_v6_quant_cm``)."""
    d0 = ((fq + 128) & 255) - 128
    return d0, (fq - d0) >> 8


def exact_digit_sums(points, mask, scene, leaf_xy, leaf_z) -> torch.Tensor:
    """(S, 7, n_cells) int32 raw two-digit sums of K5 before its finalize
    (x d0, x d1, y d0, y d1, z d0, z d1, count): ``_v6_quant_cm``'s f32
    quantize, exact integer sums (index_add_ on int64)."""
    k = kernel_params(scene, leaf_xy, leaf_z, quant="exact")
    p = points.to(torch.float32)
    ok, lin, (fx, fy, fz) = kept_cells(p, mask, k)
    chans = []
    for c, fl, leaf, half, sq in (
        (0, fx, k["leaf_xy"], k["half_xy"], k["sq_xy"]),
        (1, fy, k["leaf_xy"], k["half_xy"], k["sq_xy"]),
        (2, fz, k["leaf_z"], k["half_z"], k["sq_z"]),
    ):
        fq = torch.round(_frac_scaled(p[..., c], fl, leaf, half, sq, ok)).to(torch.int64)
        chans.extend(split_exact_digits(fq))
    chans.append(torch.ones_like(lin))
    return _digit_sums(torch.stack(chans, dim=-1), ok, lin, k["n_cells"])


def accumulate_exact_stacked_plain(points, mask, scene, leaf_xy, leaf_z):
    """Plain PyTorch version of K5: ``exact_digit_sums`` finalized by
    ``finalize_exact_digits`` (``_v3_finalize_into``'s f32 ops)."""
    sums = exact_digit_sums(points, mask, scene, leaf_xy, leaf_z)
    acc = finalize_exact_digits(sums, scene, leaf_xy, leaf_z)
    return acc, _npts(mask, points.shape[0])


def finalize_exact_digits(acc: torch.Tensor, scene, leaf_xy, leaf_z) -> torch.Tensor:
    """(..., 7, m) raw two-digit sums (v3/v6 scheme, m >= n_cells flat
    cells; the JAX (..., 7, w1, 128) layout reshaped) -> (..., 4, n_cells)
    f32 accumulator, with ``_v3_finalize_into``'s f32 ops as XLA's CPU code
    contracts them: fma(cnt, cell0 + half, (s0 + 256 * s1) * 2^-k)
    (voxel_grid.py:1918; 256 * s1 is exact, so its sum has one rounding
    either way)."""
    k = kernel_params(scene, leaf_xy, leaf_z, quant="exact")
    cx, cy, cz = _cell_centres(k, acc.shape[-1], acc.device)
    a = acc.to(torch.float32)
    cnt = a[..., 6, :]
    out = torch.stack(
        [
            _finalize_axis(cnt, cx, a[..., 0, :] + 256.0 * a[..., 1, :], k["invq_xy"]),
            _finalize_axis(cnt, cy, a[..., 2, :] + 256.0 * a[..., 3, :], k["invq_xy"]),
            _finalize_axis(cnt, cz, a[..., 4, :] + 256.0 * a[..., 5, :], k["invq_z"]),
            cnt,
        ],
        dim=-2,
    )
    return out[..., : k["n_cells"]]


def accumulate_exact_stacked(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    *,
    ranges: int | None = None,
    chunks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if points.device.type == "cpu":
        return accumulate_exact_stacked_plain(points, mask, scene, leaf_xy, leaf_z)
    out = _launch_digits("K5", "motl_voxel_exact", "exact", 7,
                         points, mask, scene, leaf_xy, leaf_z,
                         ranges=ranges, chunks=chunks)
    accumulate_exact_stacked.launches += 1
    return out


accumulate_exact_stacked.launches = 0


def accumulate_exact_stacked_raw(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    *,
    ranges: int | None = None,
    chunks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's histogram without its finalize: ((S, 7, n_cells) int32
    two-digit sums [x d0, x d1, y d0, y d1, z d0, z d1, count], (S,) i32),
    finalized once after the fleet's all-reduce (``finalize_exact_stacked``).
    Replaces ``_accumulate_pallas_v6_stacked_raw`` and ``_v3_stacked_raw``
    (voxel_grid.py:1686, :1830; their (S, 7, w1, 128) layout padded to a
    multiple of 128 cells).  The TPU picks v6 (f32 sums) or v3 (int32) by
    the global point count (``_v6_exact_n``); both give the same integers,
    and this kernel sums in int32 with no 2^24 bound, so that choice picks
    the same kernel either way.  Kernel on CUDA tensors,
    ``exact_digit_sums`` on CPU tensors."""
    if points.device.type == "cpu":
        return exact_digit_sums(points, mask, scene, leaf_xy, leaf_z), _npts(mask, points.shape[0])
    out = _launch_digits("K5 raw", "motl_voxel_exact", "exact", 7,
                         points, mask, scene, leaf_xy, leaf_z, raw=True,
                         ranges=ranges, chunks=chunks)
    accumulate_exact_stacked_raw.launches += 1
    return out


accumulate_exact_stacked_raw.launches = 0


def finalize_exact_stacked(sums: torch.Tensor, scene: SceneBounds, leaf_xy: float,
                           leaf_z: float) -> torch.Tensor:
    """K5's finalize alone: (S, 7, n_cells) int32 digit sums -> (S, 4,
    n_cells) f32, the kernel fleet's counterpart of ``finalize_exact_digits``
    (voxel_grid.py:1918).  Kernel on CUDA tensors, ``finalize_exact_digits``
    on CPU tensors."""
    if sums.device.type == "cpu":
        return finalize_exact_digits(sums, scene, leaf_xy, leaf_z)
    out = _launch_finalize("motl_voxel_finalize_exact", "exact", 7, sums, scene, leaf_xy, leaf_z)
    finalize_exact_stacked.launches += 1
    return out


finalize_exact_stacked.launches = 0


# ---------------------------------------------------------------------------
# K6: bf16x3 sums in ascending point index
# ---------------------------------------------------------------------------
def bf16_rne(v: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), as f32: K6's bit
    rounding, u + 0x7FFF + ((u >> 16) & 1) with the low 16 bits cleared
    (finite inputs)."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


def bf16x3_parts(v: torch.Tensor) -> torch.Tensor:
    """(..., ) f32 -> (..., 3) bf16 parts h1, h2, h3 as f32
    (voxel_grid.py::_split3_bf16)."""
    h1 = bf16_rne(v)
    r1 = v - h1
    h2 = bf16_rne(r1)
    return torch.stack([h1, h2, bf16_rne(r1 - h2)], dim=-1)


def _sums_in_key_order(p, key, n_bins, parts):
    """K6's order in plain PyTorch: per bin, each sum starts at +0.0 and
    adds the bin's points in ascending point index, one rounded f32 add at
    a time.  ``p`` (M, 3) f32 points, ``key`` (M,) int64 their bins, with
    ``n_bins`` for a dropped point; ``parts`` maps the kept (m, 3)
    coordinates to the (m, 3, k) values summed.  A stable sort groups the
    points by bin; round r then adds every bin's r-th point at once (one
    point per bin, so the index_put has unique indices).  Returns the
    (n_bins, 3, k) sums and the (n_bins,) counts; f64 points sum in f64
    (the JAX package's f64 scatter-add)."""
    dev = p.device
    n_kept = int((key < n_bins).sum())
    order = torch.sort(key, stable=True).indices[:n_kept]
    sk = key[order]
    vals = parts(p[order])                                          # (m, 3, k)
    counts = torch.bincount(sk, minlength=n_bins)
    rank = torch.arange(n_kept, device=dev) - (torch.cumsum(counts, 0) - counts)[sk]
    by_rank = torch.sort(rank, stable=True).indices
    acc = torch.zeros((n_bins,) + vals.shape[1:], dtype=vals.dtype, device=dev)
    lo = 0
    for m in torch.bincount(rank).tolist():
        sel = by_rank[lo:lo + m]
        idx = sk[sel]
        acc[idx] = acc[idx] + vals[sel]
        lo += m
    return acc, counts


def _ordered_sums_plain(points, mask, scene, leaf_xy, leaf_z, parts, dtype=None):
    """``_sums_in_key_order`` over the S frames' cells (bin frame * nc +
    lin): the (S * nc, 3, k) sums and the (S * nc,) counts.  The cells come
    from the f32 points (the JAX quantize is f32 in every dtype); f64
    points are summed as they are, and a half ``dtype`` sums the points
    (f32 holding half values) in that dtype, each add rounded to it (torch's
    CPU half add computes in f32 and rounds once)."""
    k = kernel_params(scene, leaf_xy, leaf_z)
    s = points.shape[0]
    nc = k["n_cells"]
    p = points.to(torch.float32)
    ok, lin, _ = kept_cells(p, mask, k)
    frame = torch.arange(s, device=p.device)[:, None]
    key = torch.where(ok, frame * nc + lin, s * nc).reshape(-1)
    vals = points if points.dtype == torch.float64 else p.to(dtype or torch.float32)
    return _sums_in_key_order(vals.reshape(-1, 3), key, s * nc, parts)


# a count summed in a half dtype, 0 + 1 + 1 + ..., stops where adding 1
# rounds back: 2^8 in bf16, 2^11 in f16
COUNT_SAT = {torch.bfloat16: 256, torch.float16: 2048}


def half_count(counts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer counts as the JAX half route sums them (``w`` added in the
    half dtype): exact up to ``COUNT_SAT``, then stuck there."""
    return torch.clamp(counts, max=COUNT_SAT[dtype]).to(dtype)


def _cell_major(sums, counts, s):
    """(S * nc, 3) sums and (S * nc,) counts -> (S, 4, nc) of the sums'
    dtype (a half count saturates as ``half_count``)."""
    cnt = half_count(counts, sums.dtype) if sums.dtype in COUNT_SAT else counts.to(sums.dtype)
    out = torch.cat([sums, cnt[:, None]], dim=1)
    return out.reshape(s, -1, 4).permute(0, 2, 1).contiguous()


def accumulate_bf16x3_stacked_plain(points, mask, scene, leaf_xy, leaf_z):
    """Plain PyTorch version of K6's bf16x3 mode: the three bf16 parts of
    every coordinate summed in K6's order, combined as (S1 + S2) + S3."""
    acc, counts = _ordered_sums_plain(points, mask, scene, leaf_xy, leaf_z, bf16x3_parts)
    sums = (acc[..., 0] + acc[..., 1]) + acc[..., 2]                 # (S*nc, 3)
    s = points.shape[0]
    return _cell_major(sums, counts, s), _npts(mask, s)


def accumulate_f32_stacked_plain(points, mask, scene, leaf_xy, leaf_z, dtype=None):
    """Plain PyTorch version of K6's f32 mode: the coordinates themselves
    summed in K6's order -- the order in which XLA's CPU scatter-add
    (``ops/voxel.py::voxel_accumulate`` of the JAX package) applies them;
    in ``dtype`` where it is bf16 or f16 (K6f's half builds)."""
    acc, counts = _ordered_sums_plain(points, mask, scene, leaf_xy, leaf_z,
                                      lambda v: v[..., None], dtype)
    s = points.shape[0]
    return _cell_major(acc[..., 0], counts, s), _npts(mask, s)


def sorted_sums_plan(s: int, n: int, n_cells: int, itemsize: int = 4) -> dict:
    """K6's scratch for S frames of N points over n_cells cells, in one
    int32 buffer: the radix sort's tiles (``SORT_TILE`` points each) and
    8-bit passes (ceil(bits(n_cells) / 8)), and the word offset and size of
    each array -- the keys (N per frame), up to two (key, index) buffers
    (2N each), the (pass, tile, digit) histograms, the tiles' mask counts,
    the cells' first and end positions (2 n_cells) and the sorted
    coordinates (3N values of ``itemsize`` bytes: 4, or 8 for the double
    build).  O(N + digits x tiles + n_cells) per frame; nothing scales
    with n_cells x tiles."""
    n_tiles = -(-n // SORT_TILE)
    passes = -(-max(1, (n_cells - 1).bit_length()) // 8)
    sizes = {
        "keys": s * n,
        "pairs": min(2, passes - 1) * 2 * s * n,
        "hist": passes * s * n_tiles * 256,
        "tilecnt": s * n_tiles,
        "cells": 2 * s * n_cells,
        "sorted": 3 * s * n * itemsize // 4,
    }
    offsets, words = {}, 0
    for name, size in sizes.items():
        offsets[name] = words
        words += -(-size // 64) * 64                 # 256-byte aligned arrays
    return {"n_tiles": n_tiles, "passes": passes, "sizes": sizes, "offsets": offsets,
            "words": words, "bytes": 4 * words}


def _sorted_sums_scratch(s: int, n: int, nc: int, dev, dtype=torch.float32):
    """K6's plan, its scratch buffer (kept alive by the caller until the
    launch is queued), the arrays' addresses in the entries' order, and the
    (S, 4, n_cells) output of ``dtype`` (f32, or f64 for the double
    build)."""
    plan = sorted_sums_plan(s, n, nc, torch.empty((), dtype=dtype).element_size())
    buf = torch.empty(plan["words"], dtype=torch.int32, device=dev)
    ptrs = [buf.data_ptr() + 4 * plan["offsets"][k]
            for k in ("keys", "pairs", "hist", "tilecnt", "cells", "sorted")]
    out = torch.empty((s, 4, nc), dtype=dtype, device=dev)
    return plan, buf, ptrs, out


# K6f's builds by the sums' dtype (mode 1)
_SUMS_ENTRY = {torch.float32: "motl_voxel_bf16x3", torch.float64: "motl_voxel_sums_f64",
               torch.bfloat16: "motl_voxel_sums_bf16", torch.float16: "motl_voxel_sums_f16"}


def _launch_sorted_sums(points, mask, scene, leaf_xy, leaf_z, mode: int, dtype=None):
    """Launch K6 (mode 0 bf16x3, mode 1 f32; mode 1 on f64 points its
    double build, ``motl_voxel_sums_f64``; mode 1 on f32 points with a half
    ``dtype`` its half builds): ((S, 4, n_cells) of the sums' dtype, (S,)
    i32), and the C entry launched; the kernels zero their own counters and
    count the mask."""
    f64 = points.dtype == torch.float64 and mode == 1
    s, n = _check_points(points, mask, "K6", dtypes=(torch.float64,) if f64 else None)
    k = kernel_params(scene, leaf_xy, leaf_z)
    nc = k["n_cells"]
    m8 = _build.byte_mask(mask)
    dev = points.device
    plan, buf, ptrs, out = _sorted_sums_scratch(s, n, nc, dev, points.dtype)
    sums = dtype if mode == 1 and dtype is not None else points.dtype
    if sums != points.dtype:
        out = torch.empty((s, 4, nc), dtype=sums, device=dev)
    npts = torch.empty((s,), dtype=torch.int32, device=dev)
    entry = _SUMS_ENTRY[sums] if mode == 1 else "motl_voxel_bf16x3"
    err = getattr(_build.load(), entry)(
        points.data_ptr(), m8.data_ptr(), s, n, plan["n_tiles"], plan["passes"], *ptrs,
        out.data_ptr(), npts.data_ptr(), nc,
        k["gx"], k["gy"], k["gz"], k["bx"], k["by"], k["bz"],
        k["inv_xy"], k["inv_z"], *((mode,) if entry == "motl_voxel_bf16x3" else ()),
        _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    return out, npts, entry


def accumulate_bf16x3_stacked(
    points: torch.Tensor,   # (S, N, 3) f32
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 (bf16x3 mode) on CUDA tensors, its plain version on CPU tensors."""
    if points.device.type == "cpu":
        return accumulate_bf16x3_stacked_plain(points, mask, scene, leaf_xy, leaf_z)
    out, npts, _ = _launch_sorted_sums(points, mask, scene, leaf_xy, leaf_z, 0)
    accumulate_bf16x3_stacked.launches += 1
    return out, npts


accumulate_bf16x3_stacked.launches = 0


def accumulate_f32_stacked(
    points: torch.Tensor,   # (S, N, 3) f32 or f64
    mask: torch.Tensor,     # (S, N) bool / nonzero = keep
    scene: SceneBounds,
    leaf_xy: float,
    leaf_z: float,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 (f32 mode) on CUDA tensors, its plain version on CPU tensors.
    f64 points sum in f64: on the card K6f's double build
    (``motl_voxel_sums_f64``, counted in ``.launches_by``), the JAX f64
    scatter-add's sums (the point list's and the vmap fleet's accumulator
    under dtype="float64", and the exact route's there).  ``dtype`` bf16 or
    f16 on f32 points holding half values sums them in that dtype, each add
    rounded, the count saturating (``half_count``): the JAX half
    scatter-add's sums, K6f's half builds (``motl_voxel_sums_bf16`` /
    ``_f16``) on the card."""
    if points.device.type == "cpu":
        return accumulate_f32_stacked_plain(points, mask, scene, leaf_xy, leaf_z, dtype)
    out, npts, entry = _launch_sorted_sums(points, mask, scene, leaf_xy, leaf_z, 1, dtype)
    _build.count(accumulate_f32_stacked, entry, "motl_voxel_bf16x3")
    return out, npts


accumulate_f32_stacked.launches = 0                   # the f32 build's
accumulate_f32_stacked.launches_by = collections.Counter()   # by C entry


# ---------------------------------------------------------------------------
# K6's key entry: bf16x3 sums over precomputed grid indices
# ---------------------------------------------------------------------------
def accumulate_bf16x3_keys_plain(points, ix, iyz, in_bounds, gx: int, gyz: int):
    """Plain PyTorch version of K6's key entry: the bf16x3 parts of every
    kept point's coordinates summed per bin iyz * gx + ix in K6's order,
    combined as (S1 + S2) + S3.  A point is dropped where not in bounds,
    or where ix lies outside [0, gx) or iyz outside [0, gyz): no one-hot
    row of the TPU kernel matches it.  (S, 4, gyz * gx) f32."""
    s, nc = points.shape[0], gx * gyz
    ix, iyz = ix.to(torch.int64), iyz.to(torch.int64)
    ok = (in_bounds != 0) & (ix >= 0) & (ix < gx) & (iyz >= 0) & (iyz < gyz)
    frame = torch.arange(s, device=points.device)[:, None]
    key = torch.where(ok, frame * nc + iyz * gx + ix, s * nc).reshape(-1)
    acc, counts = _sums_in_key_order(points.to(torch.float32).reshape(-1, 3), key, s * nc,
                                     bf16x3_parts)
    return _cell_major((acc[..., 0] + acc[..., 1]) + acc[..., 2], counts, s)


def accumulate_bf16x3_keys(
    points: torch.Tensor,     # (S, N, 3) f32
    ix: torch.Tensor,         # (S, N) int: x cell index
    iyz: torch.Tensor,        # (S, N) int: iy + gy * iz
    in_bounds: torch.Tensor,  # (S, N) bool
    gx: int,
    gyz: int,
) -> torch.Tensor:
    """K6's key entry on CUDA tensors, its plain version on CPU tensors:
    (S, 4, gyz * gx) f32 [sum_x, sum_y, sum_z, count] in iyz-major cell
    order (the TPU kernel's (gyz, gx) layout flattened)."""
    if points.device.type == "cpu":
        return accumulate_bf16x3_keys_plain(points, ix, iyz, in_bounds, gx, gyz)
    if points.dim() != 3 or points.shape[2] != 3 or points.dtype != torch.float32:
        raise ValueError(f"K6 keys: points must be (S, N, 3) float32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    s, n = points.shape[0], points.shape[1]
    for name, t in (("ix", ix), ("iyz", iyz), ("in_bounds", in_bounds)):
        if t.shape != (s, n) or t.device != points.device:
            raise ValueError(f"K6 keys: {name} must be ({s}, {n}) on {points.device}")
    dev = points.device
    points = points.contiguous()
    ix32 = ix.to(torch.int32).contiguous()
    iyz32 = iyz.to(torch.int32).contiguous()
    inb8 = _build.byte_mask(in_bounds)
    plan, buf, ptrs, out = _sorted_sums_scratch(s, n, gx * gyz, dev)
    err = _build.load().motl_voxel_bf16x3_keys(
        points.data_ptr(), ix32.data_ptr(), iyz32.data_ptr(), inb8.data_ptr(), s, n,
        plan["n_tiles"], plan["passes"], *ptrs, out.data_ptr(), gx, gyz, _build.stream_ptr(dev),
    )
    _build.check(err, "motl_voxel_bf16x3_keys")
    accumulate_bf16x3_keys.launches += 1
    return out


accumulate_bf16x3_keys.launches = 0


# ---------------------------------------------------------------------------
# K6f's key entry: f32 (or f64) sums over given bins
# ---------------------------------------------------------------------------
def accumulate_sums_keys_plain(points, bins, n_bins: int):
    """Plain PyTorch version of K6f's key entry: each bin's points summed
    from +0.0 in ascending point index, one rounded add at a time, in the
    points' dtype (f32, or f64), and its count; a point whose bin lies
    outside [0, n_bins) is dropped.  (S, 4, n_bins)."""
    s = points.shape[0]
    bins = bins.to(torch.int64)
    ok = (bins >= 0) & (bins < n_bins)
    frame = torch.arange(s, device=points.device)[:, None]
    key = torch.where(ok, frame * n_bins + bins, s * n_bins).reshape(-1)
    vals = points if points.dtype == torch.float64 else points.to(torch.float32)
    acc, counts = _sums_in_key_order(vals.reshape(-1, 3), key, s * n_bins,
                                     lambda v: v[..., None])
    return _cell_major(acc[..., 0], counts, s)


def accumulate_sums_keys(
    points: torch.Tensor,   # (S, N, 3) f32 or f64
    bins: torch.Tensor,     # (S, N) int: each point's bin, outside [0, n_bins) = dropped
    n_bins: int,
) -> torch.Tensor:
    """K6f's key entry on CUDA tensors (``motl_voxel_sums_keys``; f64
    points its double build ``motl_voxel_sums_keys_f64``, counted in
    ``.launches_by``), its plain version on CPU tensors: (S, 4, n_bins) of
    the points' dtype, [sum_x, sum_y, sum_z, count], each sum K6f's (its
    radix sort groups the bins stably, so a bin's points add in ascending
    point index; no float atomics).  Memory O(N + n_bins)."""
    if points.device.type == "cpu":
        return accumulate_sums_keys_plain(points, bins, n_bins)
    if (points.dim() != 3 or points.shape[2] != 3
            or points.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"K6f keys: points must be (S, N, 3) float32 or float64, got "
                         f"{tuple(points.shape)} {points.dtype}")
    s, n = points.shape[0], points.shape[1]
    if bins.shape != (s, n) or bins.device != points.device:
        raise ValueError(f"K6f keys: bins must be ({s}, {n}) on {points.device}")
    dev = points.device
    points = points.contiguous()
    b32 = bins.to(torch.int32).contiguous()
    zero = torch.zeros((s, n), dtype=torch.int32, device=dev)      # iyz: one row of bins
    inb = torch.ones((s, n), dtype=torch.uint8, device=dev)
    plan, buf, ptrs, out = _sorted_sums_scratch(s, n, n_bins, dev, points.dtype)
    entry = ("motl_voxel_sums_keys_f64" if points.dtype == torch.float64
             else "motl_voxel_sums_keys")
    err = getattr(_build.load(), entry)(
        points.data_ptr(), b32.data_ptr(), zero.data_ptr(), inb.data_ptr(), s, n,
        plan["n_tiles"], plan["passes"], *ptrs, out.data_ptr(), n_bins, 1,
        _build.stream_ptr(dev),
    )
    _build.check(err, entry)
    _build.count(accumulate_sums_keys, entry, "motl_voxel_sums_keys")
    return out


accumulate_sums_keys.launches = 0                   # the f32 build's
accumulate_sums_keys.launches_by = collections.Counter()   # by C entry
