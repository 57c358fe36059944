"""Selflocalization orchestrator: SLAM engine + publishing + file dumps.

Capability parity with the reference orchestrator class
(reference: src/selflocalization.cpp / include/selflocalization.hpp:43-104):
owns the SLAM engine, converts poses to ENU/WGS84 Geolocation messages
(sendPose, reference: :301-328), publishes the map in 2500-coordinate chunks
(sendMap, reference: :136-262), and writes poses.txt / map.txt / fps.txt at
shutdown (reference: :95-134).

What a frame publishes is read on the device when the frame is tracked and
reaches the host through a ``HostFetch`` (pinned buffers and an event), so
``track`` never waits for the device: a frame's messages go out, in frame
order, at the first ``track`` after its fetch has landed, and at most two
frames late (``track`` waits on the event then).  ``shutdown`` sends what is
left, so the message sequence is the one the reference package sends.

Two faults of the reference package are not carried over: ``shutdown``
settles the engine's in-flight work (``finish()``, the reference's Shutdown
joining its threads, :560-570) before it writes anything, and poses.txt
holds the trajectory re-chained through each frame's reference keyframe
(``corrected_trajectory()``, SaveTrajectoryKITTI, reference:
src/tracking.cpp:1449-1536) instead of the raw online poses.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque

import numpy as np

from ..io.messages import (
    Geolocation,
    OrbslamMap,
    PointCloudReading,
    chunk_map_messages,
)
from ..io.od4 import NullSession
from ..utils import trajectory as traj_utils
from ..utils import wgs84
from ..utils.config import SystemConfig
from ..utils.host import HostFetch
from .slam import StereoSlam

#: a frame's messages go out at most this many frames after it
MAX_PUBLISH_LAG = 2
#: the map is resent with the frame whose count is a multiple of this
#: (reference: src/selflocalization.cpp:88-99)
MAP_EVERY = 20


def pose_to_geolocation(T, ref_latitude: float, ref_longitude: float,
                        start_heading: float) -> Geolocation:
    """Camera pose [4,4] -> WGS84 Geolocation (sendPose, reference:
    src/selflocalization.cpp:301-328): rotate the camera centre into ENU by
    the start heading, then offset the WGS84 reference point."""
    T = np.asarray(T, dtype=np.float64)
    R, t = T[:3, :3], T[:3, 3]
    c = -R.T @ t  # camera centre in SLAM world (x right, y down, z fwd)
    h = start_heading
    east = c[2] * math.sin(h) + c[0] * math.cos(h)
    north = c[2] * math.cos(h) - c[0] * math.sin(h)
    lat, lon = wgs84.from_cartesian(
        (ref_latitude, ref_longitude), (east, north)
    )
    yaw = math.atan2(R[0, 2], R[2, 2])
    return Geolocation(
        latitude=lat, longitude=lon, altitude=float(-c[1]), heading=h + yaw
    )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class FramePublisher:
    """The messages of tracked frames, in frame order, each sent once its
    device values have reached the host: the latest pose (Geolocation, with
    the WGS84 reference ``ref``), and with ``with_map`` the map's valid
    points (OrbslamMap chunks).  ``post`` queues a frame's fetch; ``drain``
    sends every landed frame at the head of the queue and waits for those
    more than ``MAX_PUBLISH_LAG`` frames old; ``flush`` sends the rest."""

    def __init__(self, od4, ref=(0.0, 0.0, 0.0)):
        self.od4 = od4
        self.ref = ref
        self.map_sizes: list[int] = []  # each sent frame's map-point count
        self.lags: list[int] = []       # frames between a frame and its send
        self._queue: deque = deque()

    def post(self, frame: int, slam, with_map: bool) -> None:
        """Queue frame ``frame``'s fetch: the map-point count (an engine
        with a map), the latest pose and, ``with_map``, the map's points and
        their valid mask, as they are on the device now."""
        m = getattr(slam, "map", None)
        pose = slam.trajectory[-1] if slam.trajectory else None
        tensors = [] if m is None else [m.pt_valid.sum()]
        if pose is not None:
            tensors.append(pose)
            if with_map and m is not None:
                tensors += [m.pt_pos, m.pt_valid]
        if tensors:
            self._queue.append((frame, HostFetch(*tensors), m is not None, pose is not None))

    def drain(self, frame: int) -> None:
        """At frame ``frame``: send the landed frames at the head of the
        queue, waiting for any more than ``MAX_PUBLISH_LAG`` frames old."""
        while self._queue and (self._queue[0][1].done()
                               or self._queue[0][0] <= frame - MAX_PUBLISH_LAG):
            self._send(frame)

    def flush(self, frame: int) -> None:
        while self._queue:
            self._send(frame)

    def _send(self, now: int) -> None:
        frame, fetch, has_map, has_pose = self._queue.popleft()
        host = fetch.result()
        host = host if isinstance(host, list) else [host]
        self.lags.append(now - frame)
        if has_map:
            self.map_sizes.append(int(host.pop(0)))
        if not has_pose:
            return
        T = host[0]
        self.od4.send(pose_to_geolocation(T, *self.ref))
        if len(host) == 3:
            pos, valid = host[1:]
            for msg in chunk_map_messages(T, pos[valid].tolist()):
                self.od4.send(msg)


class Selflocalization:
    def __init__(self, config: SystemConfig, od4=None, vocab=None,
                 tracking_only: bool = False, device="cuda"):
        self.config = config
        self.od4 = od4 or NullSession()
        if config.camera_type == "mono":
            from .mono_slam import MonocularSlam
            self.slam = MonocularSlam(config, vocab=vocab, device=device)
        else:
            # tracking_only maps to the reference's localization-only mode
            # (mbOnlyTracking with the mbVO dual hypothesis,
            # reference: src/tracking.cpp:1538-1640): frozen map +
            # per-frame relocalization, NOT the map-less VO slice
            # (StereoVisualOdometry remains available for benchmarks).
            self.slam = StereoSlam(config, vocab=vocab,
                                   tracking_only=tracking_only, device=device)
        self.frame_count = 0
        self.latencies: list[float] = []
        self.publisher = FramePublisher(
            self.od4, (config.ref_latitude, config.ref_longitude, config.start_heading))
        self.map_sizes = self.publisher.map_sizes   # fps.txt's second column

    # ------------------------------------------------------------------
    # Frame ingestion (Track, reference: src/selflocalization.cpp:533-558)
    # ------------------------------------------------------------------

    def track(self, img_left, img_right=None, timestamp: float = 0.0):
        """Mode-dispatched frame ingestion (Track, reference:
        src/selflocalization.cpp:533-558): stereo takes (L, R), RGB-D takes
        (gray, depth-map), monocular takes a single image."""
        t0 = time.time()
        mode = self.config.camera_type
        if mode == "rgbd":
            T = self.slam.process_rgbd(img_left, img_right, timestamp)
        elif mode == "mono":
            T = self.slam.process(img_left, timestamp)
        else:
            T = self.slam.process(img_left, img_right, timestamp)
        self.latencies.append(time.time() - t0)
        self.frame_count += 1
        self.publisher.post(self.frame_count, self.slam,
                            with_map=self.frame_count % MAP_EVERY == 0)
        self.publisher.drain(self.frame_count)
        return T

    # ------------------------------------------------------------------
    # Publishing (sendPose/sendMap, reference: :136-328)
    # ------------------------------------------------------------------

    def send_to_webb(self) -> OrbslamMap:
        """One-shot web-visualizer message (sendToWebb, reference:
        src/selflocalization.cpp:592-636): the camera centre plus ALL map
        points as ':'-joined 4-decimal strings in a single OrbslamMap —
        the unchunked channel next to the chunked map messages."""
        cam_txt = ""
        map_txt = ""
        m = self.slam.map
        if self.slam.trajectory:
            T = _host(self.slam.trajectory[-1]).astype(np.float64)
            c = -T[:3, :3].T @ T[:3, 3]
            cam_txt = "".join(f"{v:.4f}:" for v in c)
            pts = _host(m.pt_pos)[_host(m.pt_valid)]
            map_txt = "".join(
                f"{x:.4f}:{y:.4f}:{z:.4f}:" for x, y, z in pts
            )
        return OrbslamMap(
            camera_coordinates=cam_txt.encode(),
            map_coordinates=map_txt.encode(),
        )

    def create_point_cloud_from_map(self) -> PointCloudReading:
        """Stub parity with CreatePointCloudFromMap (reference:
        src/selflocalization.cpp:582-590 — the reference hard-codes these
        placeholder values too)."""
        return PointCloudReading(
            start_azimuth=0.0, end_azimuth=0.0, entries_per_azimuth=12,
            distances=b"hello", number_of_bits_for_intensity=0,
        )

    # ------------------------------------------------------------------
    # Dumps (reference: :95-134 + src/tracking.cpp:1449-1536)
    # ------------------------------------------------------------------

    def write_pose_file(self, directory: str):
        traj_utils.write_pose_file(os.path.join(directory, "poses.txt"),
                                   self.slam.corrected_trajectory())

    def write_map_file(self, directory: str):
        m = self.slam.map
        pts = _host(m.pt_pos)[_host(m.pt_valid)]
        with open(os.path.join(directory, "map.txt"), "w") as f:
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")

    def write_fps_file(self, directory: str):
        traj_utils.write_fps_file(
            os.path.join(directory, "fps.txt"), self.latencies, self.map_sizes
        )

    def shutdown(self, directory: str | None = None):
        """Send what is left, settle the engine's in-flight work, then write
        the dumps and close the session."""
        self.publisher.flush(self.frame_count)
        self.slam.finish()
        if directory:
            self.write_pose_file(directory)
            self.write_map_file(directory)
            self.write_fps_file(directory)
        close = getattr(self.od4, "close", None)
        if close is not None:
            close()
