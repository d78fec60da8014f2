"""How often a torch.profiler trace on the GPU loses device events, under
each CUPTI setting PyTorch reads from the environment.

Each setting runs in a process of its own (the variables are read when the
profiler first starts): the environment as it is, ``TEARDOWN_CUPTI=0``
(CUPTI kept set up between traces, as PyTorch itself sets it for CUDA
graphs), and that with ``DISABLE_CUPTI_LAZY_REINIT=1``.  A process takes
``--traces`` traces the way ``micro_torch_digits.whole_trace`` takes one:
``MARKS`` marker kernels, ``--ops`` calls, ``MARKS`` markers, each trace a
profiler session of its own.  A call is one small PyTorch kernel
(``--op add``) or one K13 launch at ``chip_smoke.py``'s "half mask" shape
(``--op k13``: A = 2 problems of 64 windows of 39 steps, every other one
masked; the port's kernels are built first).  Per setting it prints the traces
whose device events fell short (markers kept before and after the run,
run ops kept), and the host time of one small kernel by CUDA events
before the first trace and after the last (what a setting that keeps
CUPTI set up costs every later launch).

    python scripts/probe_torch_trace_loss.py [--traces 400] [--ops 20] [--op add|k13]

Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SETTINGS = (
    ("as is", {}),
    ("TEARDOWN_CUPTI=0", {"TEARDOWN_CUPTI": "0"}),
    ("TEARDOWN_CUPTI=0 DISABLE_CUPTI_LAZY_REINIT=1",
     {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}),
)


def k13_call():
    """One K13 launch at the "half mask" shape, as a closure."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from multiple_object_tracking_lidar_tpu_torch.ops import learning_cuda

    rng = np.random.default_rng(15)
    lp = torch.tensor([[-5.5, -3.5, 0.75]] * 2, device="cuda")
    y = torch.from_numpy(rng.normal(0, 0.3, (2, 64, 39)).astype(np.float32)).cuda()
    m = torch.ones(2, 64, dtype=torch.bool, device="cuda")
    m[:, ::2] = False
    return lambda: learning_cuda.learning_step_cuda(lp, y, m, 0.1)


def child(n_traces: int, n_ops: int, op: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from micro_torch_digits import MARK_CYCLES, MARKS

    x = torch.zeros(1024, device="cuda")
    call = k13_call() if op == "k13" else (lambda: x.add_(1))
    call()

    def launch_us(reps=2000):
        for _ in range(100):
            x.add_(1)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            x.add_(1)
        e1.record()
        e1.synchronize()
        return 1e3 * e0.elapsed_time(e1) / reps

    before = launch_us()
    short = []
    for i in range(n_traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKS):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            for _ in range(n_ops):
                call()
            torch.cuda.synchronize()
            for _ in range(MARKS):
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        marks = ["spin_kernel" in e.name for e in dev]
        n_run = len(marks) - sum(marks)
        first_run = marks.index(False) if n_run else len(marks)
        head = sum(marks[:first_run])
        tail = sum(marks) - head
        if (head, n_run, tail) != (MARKS, n_ops, MARKS):
            short.append((i, head, n_run, tail))
    return {"traces": n_traces, "short": short, "launch_us_before": before,
            "launch_us_after": launch_us()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=400)
    ap.add_argument("--ops", type=int, default=20)
    ap.add_argument("--op", choices=("add", "k13"), default="add")
    ap.add_argument("--child", action="store_true")
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.traces, a.ops, a.op)))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for label, env in SETTINGS:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--traces", str(a.traces),
             "--ops", str(a.ops), "--op", a.op],
            env={**os.environ, **env}, capture_output=True, text=True, timeout=900)
        if out.returncode:
            print(f"{a.op} {label}: rc {out.returncode}\n{out.stderr[-2000:]}")
            continue
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{a.op} {label}: {len(r['short'])} of {r['traces']} traces short "
              f"(trace, markers before, run ops, markers after) {r['short'][:20]}; "
              f"host us per small launch {r['launch_us_before']:.3f} before the first "
              f"trace, {r['launch_us_after']:.3f} after the last")
        warn = [ln for ln in out.stderr.splitlines() if "CUPTI" in ln or "kineto" in ln.lower()]
        if warn:
            print(f"  {len(warn)} CUPTI / Kineto lines on stderr, the last: {warn[-3:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
