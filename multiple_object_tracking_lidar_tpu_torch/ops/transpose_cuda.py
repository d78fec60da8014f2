"""K11: batched transpose of 32-bit words, (S, R, C) -> (S, C, R).

Replaces the Pallas probes of ``scripts/micro_transpose.py::run``, the
TPU's in-kernel (1, B) -> (B, 1) int32 transposes (direct, and tiled
through (16, 128)), which no tracking path of the JAX package runs.  On the
card the same layout question is the (S, N, 3) -> (S, 3, N) conversion of
the points that K1-cm reads; ``scripts/micro_torch_acc.py`` times both.
CUDA source: ``csrc/transpose.cu``, whose header says what bounds it on the
H100 (bytes) and how its design answers that: one launch per call; for the
points' C = 3 (any C <= 4) each thread moves groups of 4 rows with 16-byte
loads and one 16-byte store per output plane, no shared memory; R == 1 or
C == 1 is a copy; wider rows go through 32 x 32 tiles in shared memory.

``transpose_words`` launches the kernel for CUDA tensors and runs
``transpose_words_plain`` for CPU tensors; ``.launches`` counts kernel
launches.  Both return a new contiguous (S, C, R) tensor holding the
input's words bit for bit (float32 or int32).
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch import _build

MAX_GRID_YZ = 65535   # CUDA's grid limit on y (column tiles) and z (frames)
_WORDS = (torch.float32, torch.int32)


def transpose_words_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11."""
    return x.transpose(1, 2).contiguous()


def transpose_words(x: torch.Tensor) -> torch.Tensor:
    """K11 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return transpose_words_plain(x)
    if x.dim() != 3 or x.dtype not in _WORDS or min(x.shape) < 1:
        raise ValueError(
            f"K11 takes a non-empty (S, R, C) float32 or int32 tensor, got "
            f"{tuple(x.shape)} {x.dtype}")
    s, r, c = x.shape
    if s > MAX_GRID_YZ or -(-c // 32) > MAX_GRID_YZ:
        raise ValueError(f"K11 holds S <= {MAX_GRID_YZ} and C <= {32 * MAX_GRID_YZ} "
                         f"(one grid), got S={s}, C={c}")
    x = x.contiguous()
    out = torch.empty((s, c, r), dtype=x.dtype, device=x.device)
    launch = _build.load().motl_transpose32
    err = launch(x.data_ptr(), out.data_ptr(), s, r, c, _build.stream_ptr(x.device))
    _build.check(err, "motl_transpose32")
    transpose_words.launches += 1
    return out


transpose_words.launches = 0
