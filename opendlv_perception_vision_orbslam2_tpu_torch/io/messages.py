"""OpenDLV message schema + libcluon-compatible wire encoding.

Message contract parity with the reference's ODVD set (reference:
src/opendlv-standard-message-set-v0.9.1.odvd): the three messages the SLAM
service touches are re-declared here as dataclasses with the exact field ids,
and encoded in libcluon's protobuf-compatible format (varint/zigzag ints,
fixed32 floats, length-delimited bytes) wrapped in an OD4 envelope
(``0x0D`` + 3-byte little-endian length + cluon.data.Envelope payload —
reference: include/cluon-complete-v0.0.77.hpp ToProtoVisitor/OD4Session).

A C++ consumer running libcluon can decode these envelopes directly; see
io/od4.py for the UDP-multicast session shim.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Minimal protobuf-compatible encoder (libcluon ToProtoVisitor semantics)
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    v = value & 0xFFFFFFFFFFFFFFFF
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def _key(field_id: int, wire_type: int) -> bytes:
    return _varint((field_id << 3) | wire_type)


def encode_int(field_id: int, value: int) -> bytes:
    """libcluon encodes all integer types as zigzag varints."""
    if value == 0:
        return b""
    return _key(field_id, 0) + _varint(_zigzag(int(value)))


def encode_float(field_id: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return _key(field_id, 5) + struct.pack("<f", value)


def encode_double(field_id: int, value: float) -> bytes:
    if value == 0.0:
        return b""
    return _key(field_id, 1) + struct.pack("<d", value)


def encode_bytes(field_id: int, value: bytes) -> bytes:
    if not value:
        return b""
    if isinstance(value, str):
        value = value.encode()
    return _key(field_id, 2) + _varint(len(value)) + value


# ---------------------------------------------------------------------------
# Messages (field ids match the ODVD exactly)
# ---------------------------------------------------------------------------


@dataclass
class Geolocation:
    """opendlv.logic.sensation.Geolocation [id=1116] (reference ODVD :250)."""

    ID = 1116
    latitude: float = 0.0    # id 1
    longitude: float = 0.0   # id 2
    altitude: float = 0.0    # id 3
    heading: float = 0.0     # id 4

    def encode(self) -> bytes:
        return (
            encode_float(1, self.latitude)
            + encode_float(2, self.longitude)
            + encode_float(3, self.altitude)
            + encode_float(4, self.heading)
        )


@dataclass
class OrbslamMap:
    """opendlv.proxy.OrbslamMap [id=1193] (reference ODVD :350): camera pose
    + ':'-separated map coordinates in 2500-coordinate chunks with running
    indices (chunking contract, reference: src/selflocalization.cpp:136-262)."""

    ID = 1193
    camera_coordinates: bytes = b""   # id 1
    camera_rotation: bytes = b""      # id 2
    map_coordinate_index: int = 0     # id 3
    camera_coordinate_index: int = 0  # id 4
    map_coordinates: bytes = b""      # id 5

    def encode(self) -> bytes:
        return (
            encode_bytes(1, self.camera_coordinates)
            + encode_bytes(2, self.camera_rotation)
            + encode_int(3, self.map_coordinate_index)
            + encode_int(4, self.camera_coordinate_index)
            + encode_bytes(5, self.map_coordinates)
        )


@dataclass
class PointCloudReading:
    """opendlv.proxy.PointCloudReading [id=49] (reference ODVD :152; the
    reference only stubs it, src/selflocalization.cpp:582-590)."""

    ID = 49
    start_azimuth: float = 0.0   # id 1
    end_azimuth: float = 0.0     # id 2
    entries_per_azimuth: int = 0  # id 3
    distances: bytes = b""        # id 4
    number_of_bits_for_intensity: int = 0  # id 5

    def encode(self) -> bytes:
        return (
            encode_float(1, self.start_azimuth)
            + encode_float(2, self.end_azimuth)
            + encode_int(3, self.entries_per_azimuth)
            + encode_bytes(4, self.distances)
            + encode_int(5, self.number_of_bits_for_intensity)
        )


# ---------------------------------------------------------------------------
# Envelope (cluon.data.Envelope, message id 1)
# ---------------------------------------------------------------------------


def _timestamp(seconds: float) -> bytes:
    s = int(seconds)
    us = int((seconds - s) * 1e6)
    return encode_int(1, s) + encode_int(2, us)


def encode_envelope(message, sender_stamp: int = 0,
                    timestamp: float | None = None) -> bytes:
    """Serialize a message into an OD4 wire envelope.

    Layout (reference: cluon::OD4Session::send): magic ``0x0D`` + ``0xA4``
    marker + little-endian 24-bit length, then the protobuf-encoded
    cluon.data.Envelope {dataType=1, serializedData=2, sent=3, received=4,
    sampleTimeStamp=5, senderStamp=6}.
    """
    ts = time.time() if timestamp is None else timestamp
    payload = message.encode()
    env = (
        encode_int(1, message.ID)
        + encode_bytes(2, payload)
        + encode_bytes(3, _timestamp(ts))
        + encode_bytes(4, _timestamp(ts))
        + encode_bytes(5, _timestamp(ts))
        + encode_int(6, sender_stamp)
    )
    header = bytes([0x0D, 0xA4]) + struct.pack("<I", len(env))[:3]
    return header + env


# ---------------------------------------------------------------------------
# Map chunking (contract of Selflocalization::sendMap)
# ---------------------------------------------------------------------------

CHUNK_COORDS = 2500  # coordinates per message (reference: src/selflocalization.cpp:156)


def format_coords(points) -> str:
    """':'-separated coordinate string (reference packs x:y:z:x:y:z...)."""
    flat = []
    for p in points:
        flat.extend((f"{p[0]:.3f}", f"{p[1]:.3f}", f"{p[2]:.3f}"))
    return ":".join(flat)


def chunk_map_messages(camera_pose, map_points, trajectory=None):
    """Build the OrbslamMap message sequence for one frame: camera pose +
    map points split into CHUNK_COORDS-coordinate chunks with running
    indices (message contract of reference: src/selflocalization.cpp:136-262,
    reproduced without the reference's index bookkeeping convolution per
    SURVEY.md section 7)."""
    import numpy as np

    T = np.asarray(camera_pose)
    R = T[:3, :3]
    c = (-R.T @ T[:3, 3]).tolist()
    cam_coord = format_coords([c]).encode()
    cam_rot = ":".join(f"{v:.6f}" for v in R.reshape(-1)).encode()

    msgs = []
    pts = list(map_points)
    n_chunks = max(1, (len(pts) * 3 + CHUNK_COORDS - 1) // CHUNK_COORDS)
    per_chunk = CHUNK_COORDS // 3
    for i in range(n_chunks):
        chunk = pts[i * per_chunk : (i + 1) * per_chunk]
        msgs.append(
            OrbslamMap(
                camera_coordinates=cam_coord,
                camera_rotation=cam_rot,
                map_coordinate_index=i,
                camera_coordinate_index=0,
                map_coordinates=format_coords(chunk).encode(),
            )
        )
    return msgs
