"""ctypes bindings to the native host runtime (native/motl_host.cpp).

Port of ``multiple_object_tracking_lidar_tpu/io/native.py`` with one
difference: the library is not read prebuilt.  At first use it is compiled
from ``native/motl_host.cpp`` with ``g++`` into ``build/native/`` beside the
kernels' ``build/torch_kernels/`` (``.gitignore`` lists ``build/``), named by
a digest of the source and the flags, so an edited source never loads a
stale build.  A library that fails to build or load raises: a caller that
asked for the native decoder never gets the numpy one quietly in its place
(``decode_pointcloud2(..., use_native=False)`` asks for numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "motl_host.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LIB = None
_LOCK = threading.Lock()


def lib_path(source: str | None = None) -> str:
    """Where the library built from ``source`` (default ``SOURCE``) lands:
    keyed by the source's and the flags' digest."""
    with open(source or SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmotl_host-{h.hexdigest()[:16]}.so")


def build_native(source: str | None = None) -> str:
    """Compile ``source`` (default ``SOURCE``) with g++ (once per digest) and return the
    library's path.  The output is written to a temporary name and renamed,
    so processes building at once never load a half-written file.  Raises
    RuntimeError where the compiler is missing or fails."""
    source = source or SOURCE
    path = lib_path(source)
    if os.path.exists(path):
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native decoder needs g++ to build native/motl_host.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_native():
    """The loaded library (built at first use, then cached).  Raises
    RuntimeError where it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = build_native()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"cannot load the native decoder {path}: {e}") from e
        lib.motl_decode_pc2_f32.restype = ctypes.c_long
        lib.motl_decode_pc2_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long, ctypes.POINTER(ctypes.c_long),
        ]
        lib.motl_glibc_colors.restype = None
        lib.motl_glibc_colors.argtypes = [
            ctypes.c_uint, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_native()
    except RuntimeError:
        return False
    return True


def decode_pc2_native(msg, n_max: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Native decode of the canonical float32 XYZ layout; None where the
    layout is not that one or the message is malformed (the numpy decoder
    then decodes it, or raises).  Raises where the library cannot be built
    or loaded."""
    lib = load_native()
    offs = {}
    for f in msg.fields:
        offs[f.name] = (f.offset, f.datatype)
    try:
        (xo, xdt), (yo, ydt), (zo, zdt) = offs["x"], offs["y"], offs["z"]
    except KeyError:
        return None
    if not (xdt == ydt == zdt == 7):  # FLOAT32 only in the native path
        return None
    # Bounds validation before handing raw pointers to C: the native decoder
    # reads data + i*point_step + off with no checks of its own, so a malformed
    # or truncated message must go to the (raising) NumPy path instead
    # of reading out of bounds on the host.
    if msg.n_points < 0 or msg.point_step <= 0:
        return None
    if max(xo, yo, zo) + 4 > msg.point_step:
        return None
    if len(msg.data) < msg.n_points * msg.point_step:
        return None

    out = np.empty((n_max, 3), dtype=np.float32)
    mask = np.empty(n_max, dtype=np.uint8)
    seen = ctypes.c_long(0)
    lib.motl_decode_pc2_f32(
        msg.data,
        msg.n_points,
        msg.point_step,
        xo, yo, zo,
        1 if msg.is_bigendian else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_max,
        ctypes.byref(seen),
    )
    return out, mask.astype(bool)


def glibc_colors_native(seed: int, n: int) -> np.ndarray:
    """glibc ``rand()`` RGBA colours (utils/colors.py's), natively."""
    lib = load_native()
    out = np.empty((n, 4), dtype=np.float32)
    lib.motl_glibc_colors(seed, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
