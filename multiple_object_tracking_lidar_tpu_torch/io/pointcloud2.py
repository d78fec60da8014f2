"""sensor_msgs/PointCloud2 byte-layout codec (ROS-free).

The reference receives PointCloud2 over ROS and converts with
``pcl::fromROSMsg`` (ref: src/multiple_object_tracking_lidar.cpp:448-449).
We implement the wire layout directly: a flat byte buffer of ``point_step``-
strided records with typed fields at byte offsets.  Decoding produces the
TPU-side frame contract: a fixed-size ``(n_max, 3) float32`` tensor plus a
validity mask (padding, never dynamic shapes).

A C++ fast path (native/motl_host.cpp, ``io/native.py``, built from
source at first use) implements the same decode for the production ingest
loop; the numpy decode is the reference implementation.

Copy of ``multiple_object_tracking_lidar_tpu.io.pointcloud2`` (the JAX
package cannot be imported without JAX); tests/test_torch_host.py pins this
copy against the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# sensor_msgs/PointField datatype enum
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_DTYPES = {
    INT8: np.int8, UINT8: np.uint8, INT16: np.int16, UINT16: np.uint16,
    INT32: np.int32, UINT32: np.uint32, FLOAT32: np.float32, FLOAT64: np.float64,
}


@dataclasses.dataclass(frozen=True)
class PointField:
    name: str
    offset: int
    datatype: int = FLOAT32
    count: int = 1


@dataclasses.dataclass
class PointCloud2:
    """Header + layout + data, mirroring sensor_msgs/PointCloud2."""

    stamp: float                 # header.stamp.toSec()
    frame_id: str
    height: int
    width: int
    fields: tuple[PointField, ...]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool = True

    @property
    def n_points(self) -> int:
        return self.height * self.width


def make_pointcloud2(
    xyz: np.ndarray,
    stamp: float,
    frame_id: str = "map",
    extra_padding: int = 0,
) -> PointCloud2:
    """Encode an (N, 3) float array as a canonical XYZ PointCloud2
    (16-byte stride like common Velodyne drivers when extra_padding=4)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    point_step = 12 + extra_padding
    buf = np.zeros((n, point_step), dtype=np.uint8)
    buf[:, :12] = xyz.view(np.uint8).reshape(n, 12)
    fields = (
        PointField("x", 0, FLOAT32, 1),
        PointField("y", 4, FLOAT32, 1),
        PointField("z", 8, FLOAT32, 1),
    )
    return PointCloud2(
        stamp=stamp,
        frame_id=frame_id,
        height=1,
        width=n,
        fields=fields,
        is_bigendian=False,
        point_step=point_step,
        row_step=point_step * n,
        data=buf.tobytes(),
    )


def _field_offset(msg: PointCloud2, name: str) -> tuple[int, int]:
    for f in msg.fields:
        if f.name == name:
            return f.offset, f.datatype
    raise KeyError(f"PointCloud2 has no field {name!r}")


def decode_pointcloud2(
    msg: PointCloud2,
    n_max: int,
    drop_nonfinite: bool = True,
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode to a padded ``(n_max, 3) float32`` array + ``(n_max,) bool`` mask.

    Non-finite points are dropped (PCL's NaN handling for not-dense clouds).
    Overflow beyond ``n_max`` is truncated (reported by the runtime's stats).
    Uses the native C++ decoder (native/motl_host.cpp) for the canonical
    float32 XYZ layout, NumPy otherwise (``decode_pointcloud2_named``).
    """
    pts, mask, _ = decode_pointcloud2_named(msg, n_max, drop_nonfinite, use_native)
    return pts, mask


def decode_pointcloud2_named(
    msg: PointCloud2,
    n_max: int,
    drop_nonfinite: bool = True,
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray, str]:
    """``decode_pointcloud2`` and the name of the decoder that ran:
    "native" or "numpy".  With ``use_native`` the native library is built
    at first use and a failure to build or load it raises; a layout it does
    not take (not float32 XYZ, a malformed message) and
    ``drop_nonfinite=False`` decode with NumPy, as in the JAX package."""
    if use_native and drop_nonfinite:
        from multiple_object_tracking_lidar_tpu_torch.io import native as _native

        res = _native.decode_pc2_native(msg, n_max)
        if res is not None:
            return res[0], res[1], "native"
    return (*_decode_numpy(msg, n_max, drop_nonfinite), "numpy")


def _decode_numpy(
    msg: PointCloud2, n_max: int, drop_nonfinite: bool
) -> tuple[np.ndarray, np.ndarray]:
    n = msg.n_points
    raw = np.frombuffer(msg.data, dtype=np.uint8)
    raw = raw[: n * msg.point_step].reshape(n, msg.point_step)

    cols = []
    for name in ("x", "y", "z"):
        off, dt = _field_offset(msg, name)
        npdt = _DTYPES[dt]
        width = np.dtype(npdt).itemsize
        col = raw[:, off : off + width].copy().view(npdt).reshape(n)
        if msg.is_bigendian:
            col = col.byteswap()
        cols.append(col.astype(np.float32))
    xyz = np.stack(cols, axis=1)

    if drop_nonfinite:
        finite = np.isfinite(xyz).all(axis=1)
        xyz = xyz[finite]
    n_valid = min(xyz.shape[0], n_max)

    out = np.zeros((n_max, 3), dtype=np.float32)
    out[:n_valid] = xyz[:n_valid]
    mask = np.zeros(n_max, dtype=bool)
    mask[:n_valid] = True
    return out, mask
