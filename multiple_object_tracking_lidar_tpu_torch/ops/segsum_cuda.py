"""K7 and K9: segmented prefix totals over key-sorted rows.

K7 replaces the Pallas kernel ``multiple_object_tracking_lidar_tpu/ops/
voxel_pallas.py::segment_totals_raster`` (CUDA source ``csrc/segsum.cu``,
whose header says what bounds it on the H100 and how its design answers
that: one launch per call, 8 rows per thread in registers, warp shuffles
for the short shifts, and the carry across blocks as a chained scan in the
same launch).  It computes the Pallas kernel's float tree, so the result is
bit-identical: per block of T = rb * 128 rows (rb = min(64, N / 128)),
Hillis-Steele passes at sh = 1, 2, ..., T/2 of
``c_i + c_{(i-sh) mod T} * [k_{(i-sh) mod T} == k_i and i >= sh]``, then for
every block b > 0 ``c + [k == carry_key] * carry`` with block b-1's last key
and last output.  It reads the values through the sort's permutation
(``perm``), so the runs front end gathers nothing.

K9 replaces K7's predecessor, ``voxel_pallas.py::segment_totals_pallas``,
with the same tree over flat blocks of T = min(2048, N) rows (any N below
2,048: one block of N rows) and the four channels of one (N, 4) array
(``segment_totals_rows``).  It is the second instantiation of K7's kernel
body: one launch per call, each row one 16-byte load and store, the carry
the same chained scan over the same per-stream scratch.  No path of the
JAX package reaches it.

K7 has f32 builds alone: under ``dtype="float64"`` and the half dtypes the
runs front ends feed it f32 values, as the JAX runs route casts its values
to f32 (voxel_pallas.py:128, :350-352).

``segment_totals`` / ``segment_totals_rows`` launch the kernel for CUDA
tensors and run ``segment_totals_plain`` / ``segment_totals_rows_plain``
for CPU tensors; ``.launches`` counts kernel launches.  Rows are (N,) or
(S, N), one independent sorted row per frame.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch import _build

LANES = 128
RASTER_ROWS = 64  # voxel_pallas.py::_RB: rows of 128 per block
ROW_BLOCK = 2048  # voxel_pallas.py::_BLOCK: K9's rows per block


def block_rows(n: int) -> int:
    """T, the flat rows per block, with the Pallas wrapper's checks."""
    if n % LANES != 0:
        raise ValueError(f"N must be a multiple of {LANES}, got {n}")
    r = n // LANES
    rb = min(RASTER_ROWS, r)
    if r % rb != 0:
        raise ValueError(f"N/128 must be a multiple of {rb}, got {r}")
    return rb * LANES


def _tree_plain(ks, chans, t):
    """The kernels' tree over blocks of t rows: Hillis-Steele passes of
    ``c + roll(c, sh) * same`` (``torch.roll`` is the cyclic shift), then
    the carry chain ``c + [k == carry_key] * carry``, as separate f32 ops.
    ``ks`` (..., n); each channel (..., n) f32."""
    shape = ks.shape
    n = shape[-1]
    k = ks.reshape(-1, n // t, t)
    cs = [c.to(torch.float32).reshape(k.shape) for c in chans]
    i = torch.arange(t, device=ks.device)
    sh = 1
    while sh < t:
        same = ((torch.roll(k, sh, dims=-1) == k) & (i >= sh)).to(torch.float32)
        cs = [c + torch.roll(c, sh, dims=-1) * same for c in cs]
        sh *= 2
    for b in range(1, k.shape[1]):
        m = (k[:, b] == k[:, b - 1, -1:]).to(torch.float32)
        for c in cs:
            c[:, b] = c[:, b] + m * c[:, b - 1, -1:]
    return tuple(c.reshape(shape) for c in cs)


def segment_totals_plain(ks, xs, ys, zs, perm=None):
    """Plain PyTorch version of K7: the same passes and the same carry
    chain over blocks of ``block_rows(N)``, on the rows ``xs[perm]`` (the
    rows as given when ``perm`` is None)."""
    chans = (xs, ys, zs)
    if perm is not None:
        chans = tuple(torch.gather(c, -1, perm) for c in chans)
    return _tree_plain(ks, chans, block_rows(ks.shape[-1]))


_CHAIN: dict = {}   # (device, stream) -> K7's and K9's chained-scan scratch
_BLOCK_WORDS = 6    # per block: its flag, then (last key, up to 4 channels)


def _chain_scratch(device, stream: int, blocks: int) -> tuple[torch.Tensor, int]:
    """(scratch, cap): the ticket, done count, flags and published carries
    of K7's and K9's launches on ``stream``, for up to ``cap`` blocks per
    launch: zeroed once (and again only when a call needs more blocks than
    it holds); every launch leaves it zero."""
    key = (device, stream)
    buf = _CHAIN.get(key)
    cap = 0 if buf is None else (buf.numel() - 2) // _BLOCK_WORDS
    if cap < blocks:
        cap = max(blocks, 2 * cap, 64)
        buf = torch.zeros(2 + _BLOCK_WORDS * cap, dtype=torch.int32, device=device)
        _CHAIN[key] = buf
    return buf, cap


def _channel_stride(chans, n: int):
    """The element stride that places row r of frame s of every channel at
    ``(s * n + r) * stride`` from its data pointer (1 for contiguous rows,
    3 for the channels of one (S, N, 3) tensor), or None."""
    st = chans[0].stride(-1)
    for c in chans:
        if c.stride(-1) != st or (c.dim() == 2 and c.shape[0] > 1 and c.stride(0) != n * st):
            return None
    return st if st >= 1 else None


def segment_totals(
    ks: torch.Tensor,   # (N,) or (S, N) int32, sorted ascending per row
    xs: torch.Tensor,   # same shape, f32 (unsorted when perm is given)
    ys: torch.Tensor,
    zs: torch.Tensor,
    perm: torch.Tensor | None = None,  # same shape, int64: row r's source row in its frame
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 on CUDA tensors, its plain version on CPU tensors: the run
    prefixes of the rows ``xs[perm]``, ``ys[perm]``, ``zs[perm]`` (the rows
    as given without ``perm``).  The channels may be views of one (S, N, 3)
    tensor; the kernel reads them where they lie."""
    if ks.device.type == "cpu":
        return segment_totals_plain(ks, xs, ys, zs, perm)
    shape = ks.shape
    n = shape[-1]
    t = block_rows(n)
    if ks.dtype != torch.int32 or ks.dim() not in (1, 2):
        raise ValueError(f"ks must be (N,) or (S, N) int32, got {tuple(shape)} {ks.dtype}")
    chans = (xs, ys, zs)
    for c in chans:
        if c.shape != shape or c.dtype != torch.float32 or c.device != ks.device:
            raise ValueError("xs, ys, zs must be float32 of ks's shape, on its device")
    if perm is not None and (perm.shape != shape or perm.dtype != torch.int64
                             or perm.device != ks.device):
        raise ValueError("perm must be int64 of ks's shape, on its device")
    st = _channel_stride(chans, n)
    if st is None:
        chans, st = tuple(c.contiguous() for c in chans), 1
    s = ks.numel() // n
    ks_c = ks.contiguous()
    perm_ptr = None if perm is None else perm.contiguous().data_ptr()
    outs = [torch.empty(shape, dtype=torch.float32, device=ks.device) for _ in range(3)]
    stream = _build.stream_ptr(ks.device)
    chain, cap = _chain_scratch(ks.device, stream, s * (n // t))
    err = _build.load().motl_segment_totals(
        ks_c.data_ptr(), *(c.data_ptr() for c in chans), st, perm_ptr, s, n, t,
        *(o.data_ptr() for o in outs), chain.data_ptr(), cap, stream,
    )
    _build.check(err, "motl_segment_totals")
    segment_totals.launches += 1
    return tuple(outs)


segment_totals.launches = 0


def row_block(n: int) -> int:
    """K9's rows per block, min(2048, N), with the Pallas wrapper's check."""
    t = min(ROW_BLOCK, n)
    if n % t != 0:
        raise ValueError(f"N must be a multiple of {t}, got {n}")
    return t


# K9's look-back keeps the (last key, 4 channels) of a frame's blocks
# 0 .. nb-2 in one of its 4 x 2,048-float channel buffers
K9_MAX_ROWS = (1 + 4 * ROW_BLOCK // 5) * ROW_BLOCK


def segment_totals_rows_plain(ks, vals):
    """Plain PyTorch version of K9: ``vals`` (..., N, 4) through the same
    tree over blocks of ``row_block(N)`` rows."""
    out = _tree_plain(ks, vals.unbind(-1), row_block(ks.shape[-1]))
    return torch.stack(out, dim=-1)


def segment_totals_rows(
    ks: torch.Tensor,     # (N,) or (S, N) int32, sorted ascending per row
    vals: torch.Tensor,   # (N, 4) or (S, N, 4) f32, co-sorted
) -> torch.Tensor:
    """K9 on CUDA tensors, its plain version on CPU tensors: (..., N, 4)
    f32, row i the sum of its run's rows up to and including i."""
    if ks.device.type == "cpu":
        return segment_totals_rows_plain(ks, vals)
    shape = ks.shape
    n = shape[-1]
    t = row_block(n)
    if ks.dtype != torch.int32 or ks.dim() not in (1, 2):
        raise ValueError(f"ks must be (N,) or (S, N) int32, got {tuple(shape)} {ks.dtype}")
    if vals.shape != shape + (4,) or vals.dtype != torch.float32 or vals.device != ks.device:
        raise ValueError(f"vals must be float32 {tuple(shape) + (4,)} on ks's device")
    if n > K9_MAX_ROWS:
        raise ValueError(f"K9 holds N <= {K9_MAX_ROWS} rows per frame, got {n}")
    s = ks.numel() // n
    ks_c, vals_c = ks.contiguous(), vals.contiguous()
    out = torch.empty(vals.shape, dtype=torch.float32, device=ks.device)
    stream = _build.stream_ptr(ks.device)
    chain, cap = _chain_scratch(ks.device, stream, s * (n // t))
    err = _build.load().motl_segment_totals_rows(
        ks_c.data_ptr(), vals_c.data_ptr(), s, n, t, out.data_ptr(), chain.data_ptr(), cap,
        stream,
    )
    _build.check(err, "motl_segment_totals_rows")
    segment_totals_rows.launches += 1
    return out


segment_totals_rows.launches = 0
