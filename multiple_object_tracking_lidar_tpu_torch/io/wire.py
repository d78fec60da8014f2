"""Length-prefixed wire format for live PointCloud2 streams.

The reference is a ROS node with 2 subscriptions and 3 publications over
TCPROS (ref src/multiple_object_tracking_lidar.cpp:61-72).  This module is
the framework's transport-neutral equivalent: a trivial framing —

    [4-byte LE header length][JSON header][binary payload]

— carrying PointCloud2 frames in, and typed output records (ObstacleArray /
MarkerArray / pose cloud, ref publishObstacles cpp:253-295, publishMarkers
cpp:297-421) as JSON out.  A rosbridge adapter only needs to rewrap the JSON
header; the payload bytes are already sensor_msgs/PointCloud2.data.

Works over any file-like byte stream: TCP sockets (runtime/stream.py), unix
pipes, or files.

Copy of ``multiple_object_tracking_lidar_tpu.io.wire`` (the JAX package
cannot be imported without JAX) over this package's PointCloud2;
tests/test_torch_host.py pins it against the original.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import BinaryIO

from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import PointCloud2, PointField

_LEN = struct.Struct("<I")
MAX_HEADER = 1 << 20
MAX_PAYLOAD = 1 << 30


def write_frame(stream: BinaryIO, msg: PointCloud2) -> None:
    """Serialize one PointCloud2 onto a byte stream."""
    header = {
        "type": "pointcloud2",
        "stamp": msg.stamp,
        "frame_id": msg.frame_id,
        "height": msg.height,
        "width": msg.width,
        "fields": [
            {"name": f.name, "offset": f.offset, "datatype": f.datatype, "count": f.count}
            for f in msg.fields
        ],
        "is_bigendian": msg.is_bigendian,
        "point_step": msg.point_step,
        "row_step": msg.row_step,
        "is_dense": msg.is_dense,
        "payload_len": len(msg.data),
    }
    hb = json.dumps(header).encode()
    stream.write(_LEN.pack(len(hb)))
    stream.write(hb)
    stream.write(msg.data)


def write_record(stream: BinaryIO, record) -> None:
    """Serialize a typed output record (dataclass tree) as a payload-less
    JSON message."""
    write_json(stream, type(record).__name__, dataclasses.asdict(record))


def write_json(stream: BinaryIO, msg_type: str, data) -> None:
    hb = json.dumps({"type": msg_type, "data": data}).encode()
    stream.write(_LEN.pack(len(hb)))
    stream.write(hb)


def write_map(stream: BinaryIO, grid) -> None:
    """Serialize an OccupancyGrid (the /map subscription, ref cpp:235-251)."""
    write_json(
        stream,
        "map",
        {
            "data": [[int(v) for v in row] for row in grid.data],
            "info": dataclasses.asdict(grid.info),
        },
    )


def _read_exact(stream: BinaryIO, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_message(stream: BinaryIO):
    """Read one framed message.  Returns a PointCloud2, a (type, dict) tuple
    for output records, or None at EOF.  Raises ValueError on malformed
    framing (oversized header/payload, bad JSON) — never reads unbounded."""
    raw = _read_exact(stream, 4)
    if raw is None:
        return None
    (hlen,) = _LEN.unpack(raw)
    if not 0 < hlen <= MAX_HEADER:
        raise ValueError(f"bad header length {hlen}")
    hb = _read_exact(stream, hlen)
    if hb is None:
        return None
    header = json.loads(hb)
    if header.get("type") != "pointcloud2":
        return header.get("type", "?"), header.get("data")
    plen = int(header["payload_len"])
    if not 0 <= plen <= MAX_PAYLOAD:
        raise ValueError(f"bad payload length {plen}")
    data = _read_exact(stream, plen) if plen else b""
    if data is None:
        return None
    return PointCloud2(
        stamp=float(header["stamp"]),
        frame_id=header["frame_id"],
        height=int(header["height"]),
        width=int(header["width"]),
        fields=tuple(
            PointField(f["name"], int(f["offset"]), int(f["datatype"]), int(f["count"]))
            for f in header["fields"]
        ),
        is_bigendian=bool(header["is_bigendian"]),
        point_step=int(header["point_step"]),
        row_step=int(header["row_step"]),
        data=data,
        is_dense=bool(header.get("is_dense", True)),
    )
