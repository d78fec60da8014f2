"""Tracing/profiling — what the reference stubbed out, made real.

The reference declares RUNTIME DEBUG clock_t variables and never uses them
(ref: ...lidar.h:145-147; SURVEY §5.a); its only performance note is a code
comment marking clustering as the hot spot (cpp:488).  Here:

* ``StageTimer`` — lightweight wall-clock stage timers for the host loop
  (decode / H2D / step / D2H / emit), with percentile summaries.
* ``device_trace`` — context manager around torch.profiler for
  kernel-level traces of the host and the card, written as a Chrome trace
  (chrome://tracing, Perfetto).

Port of ``multiple_object_tracking_lidar_tpu.runtime.profiler``:
``StageStats`` and ``StageTimer`` are verbatim copies (pinned by
tests/test_torch_host.py); ``device_trace`` replaces ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import numpy as np


@dataclasses.dataclass
class StageStats:
    count: int
    mean_ms: float
    p50_ms: float
    p99_ms: float
    total_ms: float


class StageTimer:
    def __init__(self) -> None:
        self._samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append((time.perf_counter() - t0) * 1e3)

    def record(self, name: str, ms: float) -> None:
        self._samples[name].append(ms)

    def summary(self, skip_warmup: int = 3) -> dict[str, StageStats]:
        out = {}
        for name, xs in self._samples.items():
            use = xs[skip_warmup:] if len(xs) > skip_warmup else xs
            arr = np.asarray(use)
            out[name] = StageStats(
                count=len(xs),
                mean_ms=float(arr.mean()),
                p50_ms=float(np.percentile(arr, 50)),
                p99_ms=float(np.percentile(arr, 99)),
                total_ms=float(np.asarray(xs).sum()),
            )
        return out

    def report(self) -> str:
        lines = [f"{'stage':24s} {'count':>6s} {'mean':>9s} {'p50':>9s} {'p99':>9s}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:24s} {s.count:6d} {s.mean_ms:8.3f}m {s.p50_ms:8.3f}m {s.p99_ms:8.3f}m"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the host and, where CUDA is
    available, the card: ``with device_trace('/tmp/trace') as prof: ...``.
    On exit the trace is written to ``logdir/trace_<pid>_<n>.json``
    (Chrome trace format); the path is ``prof.trace_path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(prof.trace_path)
