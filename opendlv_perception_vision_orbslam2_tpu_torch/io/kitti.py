"""KITTI odometry dataset runner (the benchmarkable path).

Host re-design of KittiRunner (reference: src/kittirunner.cpp): load
``times.txt`` plus 6-digit PNGs from ``image_0/`` / ``image_1/``
(reference: loadImages :42-77), feed each stereo pair to the SLAM engine
with optional real-time pacing (reference: ProcessImage :99-173, pacing
:163-170), and report median/mean tracking time at shutdown (reference:
ShutDown :83-97).

The decode pipeline prefetches the next pairs on a worker thread so PNG
decoding overlaps the device's work (SURVEY.md section 7 hard-part 7); the
C++ decoder in native/ is used when it builds, else PIL.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from queue import Queue

import numpy as np

from ..utils import trace


def load_times(kitti_path: str) -> list[float]:
    with open(os.path.join(kitti_path, "times.txt")) as f:
        return [float(line) for line in f if line.strip()]


def image_paths(kitti_path: str, index: int) -> tuple[str, str]:
    name = f"{index:06d}.png"
    return (
        os.path.join(kitti_path, "image_0", name),
        os.path.join(kitti_path, "image_1", name),
    )


def decode_png(path: str) -> tuple[np.ndarray, str]:
    """Grayscale float32 [H, W] and the decoder that read it: the native
    one if it builds here, else PIL."""
    from ..native import png_native

    arr = png_native.decode_gray(path)
    if arr is not None:
        return arr, "native"
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), dtype=np.float32), "PIL"


def decode_png_gray(path: str) -> np.ndarray:
    """Grayscale float32 [H, W]; native decoder if it builds, else PIL."""
    return decode_png(path)[0]


class KittiRunner:
    """Drives a SLAM target over a KITTI sequence directory.

    ``slam`` is either a :class:`..models.selflocalization.Selflocalization`
    pipeline (preferred: its ``track`` publishes pose+map per frame and
    collects the fps.txt series itself, matching the reference's
    runKitti -> Track -> sendPose/sendMap flow,
    reference: src/selflocalization.cpp:65-99) or a bare engine exposing
    ``process`` (tests/bench), in which case this runner publishes, through
    the same deferred ``FramePublisher``, and at the end of ``run`` settles
    the engine (``finish``) and returns its re-chained trajectory
    (``corrected_trajectory``) where the engine has them."""

    def __init__(self, kitti_path: str, slam, real_time: bool = False,
                 publisher=None, prefetch: int = 4):
        self.kitti_path = kitti_path
        self.slam = slam
        self.real_time = real_time
        self.publisher = publisher
        self.times = load_times(kitti_path)
        self.track_times: list[float] = []
        self._queue: Queue = Queue(maxsize=prefetch)
        self._n = len(self.times)
        self.decoder = None     # the PNG decoder that read the frames
        self._frames = None
        if publisher is not None and not hasattr(slam, "track"):
            from ..models.selflocalization import FramePublisher

            self._frames = FramePublisher(publisher)

    @property
    def _trajectory(self):
        inner = getattr(self.slam, "slam", None)
        return (inner or self.slam).trajectory

    def _producer(self):
        try:
            for i in range(self._n):
                left_path, right_path = image_paths(self.kitti_path, i)
                (left, self.decoder), (right, _) = decode_png(left_path), decode_png(right_path)
                self._queue.put((i, left, right))
        except Exception as exc:   # handed to run(), which raises it
            self._queue.put(exc)
            return
        self._queue.put(None)

    def run(self, max_frames: int | None = None):
        """Process the sequence; returns the trajectory list."""
        t = threading.Thread(target=self._producer, daemon=True)
        t.start()
        processed = 0
        while True:
            item = self._queue.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            i, left, right = item
            if hasattr(self.slam, "track"):
                # Selflocalization pipeline: publishes + records fps series
                # (its span ``service.track``)
                self.slam.track(left, right, timestamp=self.times[i])
                dt = self.slam.latencies[-1]
            else:
                with trace.span("runner.track") as span:
                    self.slam.process(left, right, timestamp=self.times[i])
                    if self._frames is not None:
                        # a REAL pose per frame (sendPose contract, reference:
                        # src/selflocalization.cpp:83-86, 301-328) and the full
                        # map every 20 frames (:88-99)
                        self._frames.post(i, self.slam, with_map=i % 20 == 0)
                        self._frames.drain(i)
                dt = span.seconds
            self.track_times.append(dt)
            processed += 1

            if self.real_time and i + 1 < self._n:
                budget = self.times[i + 1] - self.times[i]
                if dt < budget:  # real-time pacing (reference :163-170)
                    time.sleep(budget - dt)
            if max_frames is not None and processed >= max_frames:
                break
        if hasattr(self.slam, "track"):
            return self._trajectory
        if self._frames is not None:
            self._frames.flush(processed)
        if hasattr(self.slam, "finish"):
            self.slam.finish()
            return self.slam.corrected_trajectory()
        return self._trajectory

    def shutdown_stats(self) -> dict:
        """Median/mean tracking time (reference: src/kittirunner.cpp:88-96)."""
        if not self.track_times:
            return {"median_s": 0.0, "mean_s": 0.0, "fps": 0.0}
        med = statistics.median(self.track_times)
        mean = sum(self.track_times) / len(self.track_times)
        return {
            "median_s": med,
            "mean_s": mean,
            "fps": 1.0 / mean if mean > 0 else 0.0,
        }
