"""The ctypes signatures of the port's kernel library (``_build.SIGNATURES``)
against the ``extern "C"`` entry points of ``csrc/*.cu``, parameter by
parameter: a pointer is ``c_void_p``, an int ``c_int``, a float
``c_float``, a double ``c_double``.  A wrong list would pass Python ints of the wrong width to
the kernels on the card, where nothing here can check it; the sources are
read as text, so no compiler is needed."""

import ctypes
import glob
import os
import re

import pytest

from multiple_object_tracking_lidar_tpu_torch import _build

_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _entries() -> dict:
    out = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path, encoding="utf-8") as f:
            for name, params in _DECL.findall(f.read()):
                out[name] = [p.strip() for p in params.split(",")]
    return out


def _kind(param: str):
    if "*" in param:
        return ctypes.c_void_p
    if param.split()[0] == "float":
        return ctypes.c_float
    if param.split()[0] == "double":
        return ctypes.c_double
    assert param.split()[0] == "int", param
    return ctypes.c_int


def test_every_entry_point_has_a_signature():
    assert set(_entries()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_source(name):
    params = _entries()[name]
    assert [_kind(p) for p in params] == _build.SIGNATURES[name], name


def test_digest_covers_headers(tmp_path, monkeypatch):
    """The library's name hashes the shared headers too, so an edited
    header never loads a stale build."""
    srcs = _build.sources()
    before = _build._digest(srcs)
    heads = glob.glob(os.path.join(_build.CSRC, "*.cuh"))
    assert heads
    copy = tmp_path / "csrc"
    copy.mkdir()
    for p in srcs + heads:
        (copy / os.path.basename(p)).write_bytes(open(p, "rb").read())
    (copy / os.path.basename(heads[0])).write_bytes(open(heads[0], "rb").read() + b"\n")
    monkeypatch.setattr(_build, "CSRC", str(copy))
    assert _build._digest([str(copy / os.path.basename(p)) for p in srcs]) != before
