"""K13: one SGD step of the IHGP hyperparameter learning on the card, one
launch for A stacked problems (``csrc/learning.cu``).

The JAX package's learning step (models/learning.py::learning_step :121,
with ihgp.py::ihgp_nll_grad :312) is one jitted jnp program and has no TPU
kernel; as plain eager torch on the card it would be tens of thousands of
small launches (``models/learning.py::learning_step_plain``, its plain
version).  K13 runs a grid of ceil(B / ``WINDOWS_PER_CTA``) x A CTAs of 512
threads: in each, warp 0 the model, expm and the DARE while lane 0 of
warps 1-3 run the three hyperparameters' Van Loan expms, then their
Lyapunov recursions; the windows' recursions, their divisions over every
thread and their sums in step order, a block of steps at a time; the sum
of each 32-window chunk, then over the chunks by the problem's last CTA
(an integer ticket per problem, kept here per stream), and the update (the
source's header says how).  It is f32 whatever the tracker's dtype, as the
JAX package's step is.

``learning_step_cuda`` launches it on CUDA tensors (``.launches`` counts
the launches) and raises ``ValueError`` on anything else or past its
bounds: A >= 1 problems, 1 <= B <= ``MAX_WINDOWS`` windows, T >= 1 steps
per window (L - 1 >= 1).  ``models/learning.py::learning_step_stacked``
takes it for CUDA tensors and the plain version for CPU tensors; no path
on the card takes the plain version.
"""

from __future__ import annotations

import torch

from multiple_object_tracking_lidar_tpu_torch import _build
from multiple_object_tracking_lidar_tpu_torch.models.learning import SUM_CHUNK

MAX_WINDOWS = 1 << 24    # the f32 count of masked windows stays exact
WINDOWS_PER_CTA = 32     # csrc/learning.cu::kW, one 32-window chunk per CTA

_TICKETS: dict = {}      # (device, stream) -> K13's ticket words, one per problem


def _tickets(device, stream: int, a: int) -> torch.Tensor:
    """One 64-bit word per problem (the windows on, the CTAs arrived) for
    K13's launches on ``stream``: zeroed once (and again only when a call
    has more problems than it holds); every launch leaves them zero."""
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < a:
        buf = torch.zeros(max(a, 8), dtype=torch.int64, device=device)
        _TICKETS[key] = buf
    return buf


def learning_step_cuda(log_params: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       dt: float, lr_magn: float = 0.1, lr_ls: float = 0.01):
    """K13 on log_params (A, 3) f32, y (A, B, T) f32, mask (A, B) -> (new
    log-parameters (A, 3), mean NLL (A,)), both f32 on y's device."""
    if y.dim() != 3 or log_params.shape != (y.shape[0], 3) or mask.shape != y.shape[:2]:
        raise ValueError(f"K13 takes log_params (A, 3), y (A, B, T), mask (A, B); got "
                         f"{tuple(log_params.shape)}, {tuple(y.shape)}, {tuple(mask.shape)}")
    a, b, t = y.shape
    if a < 1 or not 1 <= b <= MAX_WINDOWS or t < 1:
        raise ValueError(f"K13 holds A >= 1 problems, 1 <= B <= {MAX_WINDOWS} windows and "
                         f"T >= 1 steps (got A={a}, B={b}, T={t})")
    dev = y.device
    if dev.type != "cuda" or log_params.device != dev or mask.device != dev:
        raise ValueError(f"K13 runs on CUDA tensors on one device (got {log_params.device}, "
                         f"{dev}, {mask.device})")
    if y.dtype != torch.float32 or log_params.dtype != torch.float32:
        raise ValueError(f"K13 takes float32 log_params and y (got {log_params.dtype}, "
                         f"{y.dtype})")
    lp, y = log_params.contiguous(), y.contiguous()
    m = _build.byte_mask(mask)
    n_chunks = -(-b // SUM_CHUNK)
    stream = _build.stream_ptr(dev)
    chunk_sums = torch.empty((a, n_chunks, 4), dtype=torch.float32, device=dev)
    tickets = _tickets(dev, stream, a)
    new = torch.empty((a, 3), dtype=torch.float32, device=dev)
    nll = torch.empty((a,), dtype=torch.float32, device=dev)
    err = _build.load().motl_learning_step(
        lp.data_ptr(), y.data_ptr(), m.data_ptr(), a, b, t, float(dt), float(lr_magn),
        float(lr_ls), chunk_sums.data_ptr(), tickets.data_ptr(), new.data_ptr(), nll.data_ptr(),
        stream,
    )
    _build.check(err, "motl_learning_step")
    learning_step_cuda.launches += 1
    return new, nll


learning_step_cuda.launches = 0
