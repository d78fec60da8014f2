"""Pure-Python ROS1 ``.bag`` (format v2.0) reader/writer for PointCloud2.

The reference's validation workflow is literally ``rosbag play
bag/gazebo_sim_01.bag`` (ref: README.md:37-43) — the rosbag container is the
input artifact the robotics world actually produces.  This module implements
the documented ROS1 bag v2.0 record stream with no ROS installation:

  http://wiki.ros.org/Bags/Format/2.0

* **Reader** (`read_rosbag`): streams the record sequence — bag header,
  chunk records (compression ``none`` and ``bz2``; ``lz4`` needs the
  non-baked lz4 wheel and raises a clear error), connection records, message
  records — and yields decoded `PointCloud2` messages for every connection
  whose type is ``sensor_msgs/PointCloud2`` (optionally filtered by topic).
  Index/chunk-info records are skipped: streaming the chunks needs no index
  and tolerates unindexed (crashed-recorder) bags that ``rosbag reindex``
  would otherwise have to repair.

* **Writer** (`write_rosbag`): emits a fully indexed, uncompressed v2.0 bag
  (bag header with index_pos / conn_count / chunk_count, one chunk holding
  the connection + message records, per-connection index data records, and
  the trailing connection + chunk-info section) so standard ROS tooling
  (``rosbag info/play``, rqt_bag) accepts it.

Message payloads use the standard ROS serialization of
``sensor_msgs/PointCloud2`` (little-endian, length-prefixed strings/arrays),
mirrored from the message definition; the md5sum is the well-known constant
registered for the type.

Copy of ``multiple_object_tracking_lidar_tpu.io.rosbag`` (the JAX package
cannot be imported without JAX); tests/test_torch_host.py pins it against
the original.
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterable, Iterator

from multiple_object_tracking_lidar_tpu_torch.io.pointcloud2 import (
    PointCloud2,
    PointField,
)

_MAGIC = b"#ROSBAG V2.0\n"

# record op codes (Bags/Format/2.0)
_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

PC2_TYPE = "sensor_msgs/PointCloud2"
PC2_MD5 = "1158d486dd51d683ce2f1be655c3c181"
# gendeps --cat output for sensor_msgs/PointCloud2 (the concatenated
# definition rosbag stores on the connection; separators are part of the
# wire format)
PC2_DEFINITION = """\
# This message holds a collection of N-dimensional points, which may
# contain additional information such as normals, intensity, etc. The
# point data is stored as a binary blob, its layout described by the
# contents of the "fields" array.

Header header
uint32 height
uint32 width
PointField[] fields
bool    is_bigendian
uint32  point_step
uint32  row_step
uint8[] data
bool is_dense

================================================================================
MSG: std_msgs/Header
uint32 seq
time stamp
string frame_id

================================================================================
MSG: sensor_msgs/PointField
uint8 INT8    = 1
uint8 UINT8   = 2
uint8 INT16   = 3
uint8 UINT16  = 4
uint8 INT32   = 5
uint8 UINT32  = 6
uint8 FLOAT32 = 7
uint8 FLOAT64 = 8
string name
uint32 offset
uint8  datatype
uint32 count
"""


# ---------------------------------------------------------------------------
# record-level primitives


def _header_bytes(fields: dict[str, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        kv = k.encode() + b"=" + v
        out += struct.pack("<I", len(kv)) + kv
    return out


def _parse_header(buf: bytes) -> dict[str, bytes]:
    fields: dict[str, bytes] = {}
    pos = 0
    while pos < len(buf):
        (flen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        kv = buf[pos : pos + flen]
        pos += flen
        k, _, v = kv.partition(b"=")
        fields[k.decode()] = v
    return fields


def _record(fields: dict[str, bytes], data: bytes) -> bytes:
    h = _header_bytes(fields)
    return (
        struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data
    )


def _read_record(buf: bytes, pos: int) -> tuple[dict[str, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    fields = _parse_header(buf[pos : pos + hlen])
    pos += hlen
    (dlen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    data = buf[pos : pos + dlen]
    pos += dlen
    return fields, data, pos


def _pack_time(stamp: float) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs += 1
        nsecs -= 1_000_000_000
    return struct.pack("<II", secs, nsecs)


def _unpack_time(raw: bytes) -> float:
    secs, nsecs = struct.unpack("<II", raw)
    return secs + nsecs * 1e-9


# ---------------------------------------------------------------------------
# sensor_msgs/PointCloud2 serialization


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def serialize_pointcloud2(msg: PointCloud2, seq: int = 0) -> bytes:
    """Standard ROS serialization of sensor_msgs/PointCloud2."""
    out = [struct.pack("<I", seq), _pack_time(msg.stamp), _string(msg.frame_id)]
    out.append(struct.pack("<II", msg.height, msg.width))
    out.append(struct.pack("<I", len(msg.fields)))
    for f in msg.fields:
        out.append(_string(f.name))
        out.append(struct.pack("<IBI", f.offset, f.datatype, f.count))
    out.append(struct.pack("<B", 1 if msg.is_bigendian else 0))
    out.append(struct.pack("<II", msg.point_step, msg.row_step))
    out.append(struct.pack("<I", len(msg.data)))
    out.append(msg.data)
    out.append(struct.pack("<B", 1 if msg.is_dense else 0))
    return b"".join(out)


def deserialize_pointcloud2(buf: bytes) -> PointCloud2:
    pos = 4  # seq
    stamp = _unpack_time(buf[pos : pos + 8])
    pos += 8
    (flen,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    frame_id = buf[pos : pos + flen].decode()
    pos += flen
    height, width, n_fields = struct.unpack_from("<III", buf, pos)
    pos += 12
    fields = []
    for _ in range(n_fields):
        (nlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        name = buf[pos : pos + nlen].decode()
        pos += nlen
        offset, datatype, count = struct.unpack_from("<IBI", buf, pos)
        pos += 9
        fields.append(PointField(name, offset, datatype, count))
    (is_bigendian,) = struct.unpack_from("<B", buf, pos)
    pos += 1
    point_step, row_step, dlen = struct.unpack_from("<III", buf, pos)
    pos += 12
    data = bytes(buf[pos : pos + dlen])
    pos += dlen
    (is_dense,) = struct.unpack_from("<B", buf, pos)
    return PointCloud2(
        stamp=stamp,
        frame_id=frame_id,
        height=height,
        width=width,
        fields=tuple(fields),
        is_bigendian=bool(is_bigendian),
        point_step=point_step,
        row_step=row_step,
        data=data,
        is_dense=bool(is_dense),
    )


# ---------------------------------------------------------------------------
# writer


def write_rosbag(
    path: str,
    frames: Iterable[PointCloud2],
    topic: str = "/scan_matched_points2",
) -> int:
    """Write PointCloud2 frames to a fully indexed, uncompressed ROS1 v2.0
    bag on ``topic`` (default = the reference's remapped input topic,
    ref: launch/simTracker.launch:40).  Returns the frame count."""
    conn_header = {
        "op": bytes([_OP_CONNECTION]),
        "conn": struct.pack("<I", 0),
        "topic": topic.encode(),
    }
    conn_data = _header_bytes(
        {
            "topic": topic.encode(),
            "type": PC2_TYPE.encode(),
            "md5sum": PC2_MD5.encode(),
            "message_definition": PC2_DEFINITION.encode(),
        }
    )
    conn_record = _record(conn_header, conn_data)

    # chunk payload: the connection record, then every message record;
    # remember each message's offset within the chunk for the index
    chunk_parts = [conn_record]
    chunk_pos_in = len(conn_record)
    index_entries: list[tuple[bytes, int]] = []
    times: list[bytes] = []
    n = 0
    for seq, msg in enumerate(frames):
        t = _pack_time(msg.stamp)
        rec = _record(
            {
                "op": bytes([_OP_MSG]),
                "conn": struct.pack("<I", 0),
                "time": t,
            },
            serialize_pointcloud2(msg, seq=seq),
        )
        index_entries.append((t, chunk_pos_in))
        times.append(t)
        chunk_parts.append(rec)
        chunk_pos_in += len(rec)
        n += 1
    chunk_payload = b"".join(chunk_parts)

    with open(path, "wb") as f:
        f.write(_MAGIC)
        # bag header record, padded to 4096 bytes total (spec)
        bag_header_pos = f.tell()

        def _bag_header(index_pos: int) -> bytes:
            h = {
                "op": bytes([_OP_BAG_HEADER]),
                "index_pos": struct.pack("<Q", index_pos),
                "conn_count": struct.pack("<I", 1),
                "chunk_count": struct.pack("<I", 1),
            }
            hb = _header_bytes(h)
            pad = 4096 - 8 - len(hb)
            return (
                struct.pack("<I", len(hb))
                + hb
                + struct.pack("<I", pad)
                + b" " * pad
            )

        f.write(_bag_header(0))  # placeholder; rewritten below
        chunk_pos = f.tell()
        f.write(
            _record(
                {
                    "op": bytes([_OP_CHUNK]),
                    "compression": b"none",
                    "size": struct.pack("<I", len(chunk_payload)),
                },
                chunk_payload,
            )
        )
        # index data record for the chunk (ver 1: count * (time, offset))
        f.write(
            _record(
                {
                    "op": bytes([_OP_INDEX]),
                    "ver": struct.pack("<I", 1),
                    "conn": struct.pack("<I", 0),
                    "count": struct.pack("<I", n),
                },
                b"".join(
                    t + struct.pack("<I", off) for t, off in index_entries
                ),
            )
        )
        # index section: connection records, then chunk infos
        index_pos = f.tell()
        f.write(conn_record)
        start = times[0] if times else _pack_time(0.0)
        end = times[-1] if times else _pack_time(0.0)
        f.write(
            _record(
                {
                    "op": bytes([_OP_CHUNK_INFO]),
                    "ver": struct.pack("<I", 1),
                    "chunk_pos": struct.pack("<Q", chunk_pos),
                    "start_time": start,
                    "end_time": end,
                    "count": struct.pack("<I", 1),
                },
                struct.pack("<II", 0, n),
            )
        )
        f.seek(bag_header_pos)
        f.write(_bag_header(index_pos))
    return n


# ---------------------------------------------------------------------------
# reader


def _decompress(compression: bytes, data: bytes, size: int) -> bytes:
    if compression == b"none":
        return data
    if compression == b"bz2":
        out = bz2.decompress(data)
        if len(out) != size:
            raise ValueError(
                f"bz2 chunk decompressed to {len(out)} bytes, header says {size}"
            )
        return out
    if compression == b"lz4":
        raise ValueError(
            "lz4-compressed rosbag chunks need the 'lz4' package (ROS uses "
            "lz4 frame format); re-record with compression none/bz2 or "
            "install lz4"
        )
    raise ValueError(f"unknown rosbag chunk compression {compression!r}")


def read_rosbag(
    path: str, topic: str | None = None
) -> Iterator[PointCloud2]:
    """Yield PointCloud2 messages from a ROS1 v2.0 bag, in stream order.

    Every connection typed ``sensor_msgs/PointCloud2`` matches; pass
    ``topic`` to restrict to one topic.  Chunked and unchunked (record-level)
    layouts both stream; indexes are ignored."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_MAGIC):
        head = bytes(buf[:13])
        if head.startswith(b"#ROSBAG V"):
            raise ValueError(
                f"unsupported rosbag version {head!r} (only 2.0 is "
                "implemented; run `rosbag fix` to migrate v1.x)"
            )
        raise ValueError(f"{path}: not a ROS1 bag (magic {head!r})")

    conn_types: dict[int, str] = {}
    conn_topics: dict[int, str] = {}

    def _want(conn: int) -> bool:
        if conn_types.get(conn) != PC2_TYPE:
            return False
        return topic is None or conn_topics.get(conn) == topic

    def _scan(records: bytes, pos: int, end: int) -> Iterator[PointCloud2]:
        while pos < end:
            fields, data, pos = _read_record(records, pos)
            op = fields["op"][0]
            if op == _OP_CONNECTION:
                (conn,) = struct.unpack("<I", fields["conn"])
                info = _parse_header(data)
                conn_types[conn] = info.get("type", b"").decode()
                conn_topics[conn] = info.get(
                    "topic", fields.get("topic", b"")
                ).decode()
            elif op == _OP_CHUNK:
                payload = _decompress(
                    fields.get("compression", b"none"),
                    data,
                    struct.unpack("<I", fields["size"])[0],
                )
                yield from _scan(payload, 0, len(payload))
            elif op == _OP_MSG:
                (conn,) = struct.unpack("<I", fields["conn"])
                if _want(conn):
                    msg = deserialize_pointcloud2(data)
                    if msg.stamp == 0.0:
                        # bare recorders may leave header.stamp zero; fall
                        # back to the record (receipt) time
                        msg.stamp = _unpack_time(fields["time"])
                    yield msg
            # ops 3 (bag header), 4 (index), 6 (chunk info): skip

    yield from _scan(buf, len(_MAGIC), len(buf))


def rosbag_info(path: str) -> dict:
    """Summary of a bag's PointCloud2 content (frame count, time span,
    topics) — the `bag_info` analog for the ROS container."""
    topics: dict[str, int] = {}
    t0 = t1 = None
    n = 0
    for msg in read_rosbag(path):
        n += 1
        t0 = msg.stamp if t0 is None else min(t0, msg.stamp)
        t1 = msg.stamp if t1 is None else max(t1, msg.stamp)
    return {"frames": n, "t0": t0 or 0.0, "t1": t1 or 0.0}
