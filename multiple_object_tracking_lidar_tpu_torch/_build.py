"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` compiles every source into an object, all sources at once
in parallel processes, and links them into one shared library with a plain
C interface, loaded with ``ctypes`` -- no PyTorch headers in the build, so
it takes seconds, not minutes.  The library lands in ``build/torch_kernels/``
beside the package (``.gitignore`` lists ``build/``), named by a hash of the
sources, their headers and the flags, so an edited source never loads a
stale build.  Nothing is downloaded and no library kernel is linked.

``--fmad=false`` is belt and braces: the sources already spell every f32
and f64 product and sum (``__fmul_rn``/``__fadd_rn``/``__fsub_rn``, their
``__d*_rn`` twins, and ``__fmaf_rn``/``__fma_rn`` exactly where the JAX
package's CPU code contracts an FMA) so that no contraction of nvcc's can
change a bit against the plain PyTorch versions.  There
is no ``--use_fast_math``: division and ``sqrtf`` stay IEEE.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# pts, mask, S, N, ranges, chunks, out, npts, 7 grid ints, 10 floats, stream
_DIGITS = [_P, _P, _I, _I, _I, _I, _P, _P, *[_I] * 7, *[_F] * 10, _P]

# C signatures of the kernels' entry points (each returns a cudaError_t)
SIGNATURES = {
    # K1 and K5 (fused, raw; rows and channel-major): one signature
    "motl_voxel_accumulate": _DIGITS,
    "motl_voxel_accumulate_raw": _DIGITS,
    "motl_voxel_accumulate_cm": _DIGITS,
    "motl_voxel_accumulate_cm_raw": _DIGITS,
    "motl_voxel_finalize_fast": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                 _F, _F, _F, _F, _P],
    "motl_voxel_exact_raw": _DIGITS,
    "motl_voxel_finalize_exact": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                                  _F, _F, _F, _F, _P],
    "motl_grid_cc": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P],
    "motl_grid_cc_f64": [_P, _P, _P, _P, _P, _I, _P, _D, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P],
    "motl_grid_cc_f64_f32sums": [_P, _P, _P, _P, _P, _I, _P, _D, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P, _P],
    "motl_grid_cc_bf16": [_P, _P, _P, _P, _P, _I, _P, _F, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P],
    "motl_grid_cc_f16": [_P, _P, _P, _P, _P, _I, _P, _F, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P],
    **{f"motl_grid_cc_{h}_f32sums": [_P, _P, _P, _P, _P, _I, _P, _F, _I, _I, _I, _I, _I, _I,
                                     _I, _P, _P, _P, _P, _P, _P] for h in ("bf16", "f16")},
    "motl_grid_cc_max_cluster": [_I, _P],
    "motl_pair_stats": [_P, _P, _I, _I, _P, _P, _P],
    "motl_circumcenter": [_P, _P, _I, _I, _P, _P],
    "motl_circumcenter_features": [_P, _P, _P, _I, _I, _I, _P, _P],
    "motl_circumcenter_features_f64": [_P, _P, _P, _I, _I, _I, _P, _P],
    "motl_circumcenter_features_bf16": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "motl_circumcenter_features_f16": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "motl_circumcenter_features_table": [_P, _P, _P, _I, _I, _I, _P, _P],
    "motl_assoc_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P,
                        _P, _P],
    "motl_track_step": [*[_P] * 20, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, *[_F] * 7, _I,
                        *[_P] * 17],
    "motl_track_step_f64": [*[_P] * 20, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, *[_D] * 7, _I,
                            *[_P] * 17],
    "motl_track_step_xl": [*[_P] * 20, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, *[_F] * 7, _I,
                           *[_P] * 18],
    "motl_track_step_xl_f64": [*[_P] * 20, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, *[_D] * 7,
                               _I, *[_P] * 18],
    "motl_track_step_xl_scratch": [_I, _I, _I, _I, _I, _I, _P],
    **{f"motl_track_step{xl}_{h}": [*[_P] * 20, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                                    *[_F] * 7, _I, *[_P] * (18 if xl else 17)]
       for xl in ("", "_xl") for h in ("bf16", "f16")},
    **{f"motl_auction_assign{h}": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
       for h in ("", "_bf16", "_f16")},
    "motl_voxel_exact": _DIGITS,
    "motl_voxel_bf16x3": [_P, _P, _I, _I, _I, _I, *[_P] * 8, _I, _I, _I, _I,
                          _I, _I, _I, _F, _F, _I, _P],
    "motl_voxel_sums_f64": [_P, _P, _I, _I, _I, _I, *[_P] * 8, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _P],
    **{f"motl_voxel_sums_{h}": [_P, _P, _I, _I, _I, _I, *[_P] * 8, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _P] for h in ("bf16", "f16")},
    "motl_voxel_bf16x3_keys": [_P, _P, _P, _P, _I, _I, _I, _I, *[_P] * 7, _I,
                               _I, _P],
    "motl_voxel_sums_keys": [_P, _P, _P, _P, _I, _I, _I, _I, *[_P] * 7, _I, _I, _P],
    "motl_voxel_sums_keys_f64": [_P, _P, _P, _P, _I, _I, _I, _I, *[_P] * 7, _I, _I, _P],
    "motl_segment_totals": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P,
                            _P, _I, _P],
    "motl_segment_totals_rows": [_P, _P, _I, _I, _I, _P, _P, _I, _P],
    "motl_cc_adjacency": [_P, _I, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P],
    "motl_cc_adjacency_f64": [_P, _I, _P, _I, _I, _I, _D, _I, _P, _P, _P, _P],
    **{f"motl_cc_adjacency_{h}": [_P, _I, _P, _I, _I, _I, _F, _I, _P, _P, _P, _P]
       for h in ("bf16", "f16")},
    "motl_cc_labels": [_P, _I, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P, _P],
    "motl_stencil_cc": [_P, _P, _I, _I, _I, _I, _P, _I, _F, _I, _I, _I, _I, _P, _P, _P, _P],
    "motl_stencil_cc_f64": [_P, _P, _I, _I, _I, _I, _P, _I, _D, _I, _I, _I, _I, _P, _P, _P,
                            _P],
    "motl_stencil_cc_bf16": [_P, _P, _I, _I, _I, _I, _P, _I, _F, _I, _I, _I, _I, _P, _P, _P,
                             _P],
    "motl_stencil_cc_f16": [_P, _P, _I, _I, _I, _I, _P, _I, _F, _I, _I, _I, _I, _P, _P, _P,
                            _P],
    "motl_stencil_cc_max_cluster": [_P],
    "motl_transpose32": [_P, _P, _I, _I, _I, _P],
    "motl_learning_step": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P],
}


class KernelBuildError(RuntimeError):
    pass


class _Loaded:
    lib: ctypes.CDLL | None = None
    path: str | None = None
    build_seconds: float | None = None
    log: str = ""


_state = _Loaded()
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH or $CUDA_HOME/bin)")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(srcs: list[str]) -> str:
    """A hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once, wait for all; their joined output, or
    KernelBuildError naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile_and_link(srcs: list[str], so: str) -> str:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    objs = [f"{so}.{os.path.basename(s)}.o" for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)])
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]])
    for o in objs:
        os.remove(o)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process (or reused
    from an earlier build of the same sources).  Once loaded it is returned
    without taking the lock: every wrapper calls this on every launch."""
    lib = _state.lib
    if lib is not None:
        return lib
    with _lock:
        if _state.lib is not None:
            return _state.lib
        srcs = sources()
        so = os.path.join(BUILD_DIR, f"libmotl_kernels_{_digest(srcs)}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            _state.log = _compile_and_link(srcs, tmp)
            _state.build_seconds = time.perf_counter() - t0
            os.replace(tmp, so)
            with open(so + ".log", "w", encoding="utf-8") as f:
                f.write(_state.log)
        lib = ctypes.CDLL(so)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state.lib, _state.path = lib, so
        return lib


def build_info() -> dict:
    """Path, build seconds (None when an earlier build was reused) and the
    compiler's ``-Xptxas -v`` report of the loaded library."""
    load()
    return {"path": _state.path, "seconds": _state.build_seconds, "log": _state.log}


def count(wrapper, entry: str, base: str) -> None:
    """One launch of the C entry ``entry`` by ``wrapper``:
    ``wrapper.launches_by[entry]`` counts it, and ``wrapper.launches`` too
    where ``entry`` is ``base``, the wrapper's f32 build."""
    wrapper.launches_by[entry] += 1
    if entry == base:
        wrapper.launches += 1


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: cudaError_t {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, where every kernel launches.
    Temporaries a wrapper frees right after its launch stay safe: the
    caching allocator hands their memory only to work queued later on the
    same stream.  Read as the raw handle (``torch._C._cuda_getCurrentRawStream``
    of PyTorch's CUDA build, what its own generated code calls): the same
    stream as ``torch.cuda.current_stream(device).cuda_stream`` without
    building a ``torch.cuda.Stream`` object, ~3 us less host time per
    launch (PERF.md §6, K11)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def byte_mask(mask):
    """A mask as the kernels read it, one byte per element, nonzero = set:
    a bool or uint8 tensor as it is (no launch), any other dtype compared
    with zero."""
    import torch

    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return mask.contiguous()
