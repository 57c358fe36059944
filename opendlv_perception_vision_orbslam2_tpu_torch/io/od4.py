"""OD4 session: UDP-multicast pub/sub compatible with libcluon conferences.

Host-side replacement for cluon::OD4Session (reference:
include/cluon-complete-v0.0.77.hpp:7712; send sites reference:
src/opendlv-perception-vision-orbslam2.cpp:114, src/selflocalization.cpp:85,
191, 243).  A conference id ``cid`` maps to multicast group ``225.0.0.<cid>``
port 12175, exactly like libcluon, so the reference's web visualizer (or any
OpenDLV microservice) can consume poses and map chunks from this engine
unchanged.
"""

from __future__ import annotations

import socket
import struct
import threading

from .messages import encode_envelope

OD4_PORT = 12175


class OD4Session:
    def __init__(self, cid: int, sender_stamp: int = 0):
        if not 1 <= cid <= 254:
            raise ValueError("conference id must be in [1, 254]")
        self.cid = cid
        self.group = f"225.0.0.{cid}"
        self.sender_stamp = sender_stamp
        self._sock = socket.socket(
            socket.AF_INET, socket.SOCK_DGRAM, socket.IPPROTO_UDP
        )
        self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        self._lock = threading.Lock()
        self._running = True

    def send(self, message, timestamp: float | None = None) -> None:
        data = encode_envelope(
            message, sender_stamp=self.sender_stamp, timestamp=timestamp
        )
        with self._lock:
            self._sock.sendto(data, (self.group, OD4_PORT))

    def is_running(self) -> bool:
        return self._running

    def close(self) -> None:
        self._running = False
        self._sock.close()


class NullSession:
    """Drop-in no-op publisher for offline/dataset runs."""

    def send(self, message, timestamp: float | None = None) -> None:
        pass

    def is_running(self) -> bool:
        return True

    def close(self) -> None:
        pass
