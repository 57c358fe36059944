"""Live camera ingest from POSIX shared memory.

Host replacement for the shared-memory frame loop (reference:
src/opendlv-perception-vision-orbslam2.cpp:78-118: attach by ``--name``,
``wait()`` for the camera proxy's notify, lock/copy/unlock, convert to a
grayscale frame).  Uses the C++ cluon-compatible client (native/) so an
unmodified OpenDLV camera proxy can feed this engine; frames arrive as ARGB
(``--bpp=32``) or RGB24 per the reference's cvarrToMat usage.
"""

from __future__ import annotations

import time

import numpy as np

from ..utils.config import SystemConfig


def _to_gray(raw: np.ndarray, config: SystemConfig) -> np.ndarray:
    h, w, bpp = config.height, config.width, config.bpp
    ch = bpp // 8
    img = raw[: h * w * ch].reshape(h, w, ch).astype(np.float32)
    if ch == 1:
        return img[:, :, 0]
    if ch == 4:  # ARGB
        r, g, b = img[:, :, 1], img[:, :, 2], img[:, :, 3]
    else:        # RGB/BGR (reference treats buffers as BGR via OpenCV)
        b, g, r = img[:, :, 0], img[:, :, 1], img[:, :, 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def shared_memory_frames(config: SystemConfig):
    """Generator of (grayscale frame [H, W] float32, timestamp)."""
    from ..native import SharedMemoryClient

    client = SharedMemoryClient(config.name)
    try:
        while True:
            client.wait()
            raw = client.read()
            yield _to_gray(raw, config), time.time()
    finally:
        client.close()
