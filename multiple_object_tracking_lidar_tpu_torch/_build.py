"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` compiles every source into one shared library with a plain
C interface, loaded with ``ctypes`` -- no PyTorch headers in the build, so
it takes seconds, not minutes.  The library lands in ``build/torch_kernels/``
beside the package (``.gitignore`` lists ``build/``), named by a hash of the
sources and flags, so an edited source never loads a stale build.  Nothing
is downloaded and no library kernel is linked.

``--fmad=false`` is belt and braces: the sources already spell every f32
product and sum with ``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` so that FMA
contraction cannot change a bit against the plain PyTorch versions.  There
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

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures of the kernels' entry points (each returns a cudaError_t)
SIGNATURES = {
    "motl_voxel_accumulate": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,
                              _F, _P],
    "motl_grid_cc": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P,
                     _P, _P, _P, _P],
    "motl_pair_stats": [_P, _P, _I, _I, _P, _P, _P],
    "motl_assoc_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P,
                        _P, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process (or reused
    from an earlier build of the same sources)."""
    with _lock:
        if _state.lib is not None:
            return _state.lib
        srcs = sources()
        so = os.path.join(BUILD_DIR, f"libmotl_kernels_{_digest(srcs)}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            _state.build_seconds = time.perf_counter() - t0
            _state.log = res.stdout + res.stderr
            if res.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{_state.log}"
                )
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


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: cudaError_t {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, where every kernel launches.
    Temporaries a wrapper frees right after its launch stay safe: the
    caching allocator hands their memory only to work queued later on the
    same stream."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
