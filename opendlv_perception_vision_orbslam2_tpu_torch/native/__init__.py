"""ctypes bindings for the C++ host runtime (the repo's ``native/src/native.cpp``).

The library is built at first use, never at import: ``make -C native
OUT=<path>`` writes it into the package's git-ignored ``_build/`` directory
under a name that carries a hash of the source, so an edited source rebuilds.
A failed build is tried once per process; every consumer then has a
pure-Python path (PIL for PNG decode, sockets for UDP), except the
shared-memory camera ingest, which needs the library.  The native paths are
the production ones: fast PNG decode, shared-memory camera ingest compatible
with unmodified OpenDLV camera proxies, a native UDP publisher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library built from ``native/src/native.cpp`` lives."""
    digest = hashlib.sha256((NATIVE_DIR / "src" / "native.cpp").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liborbslam2_native_{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")   # absent: make builds it
    subprocess.run(["make", "-C", str(NATIVE_DIR), f"OUT={tmp}"], capture_output=True,
                   check=False)
    if tmp.exists():
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file


def get_lib():
    """The loaded library, built on the first call; None if it cannot be
    built here (no compiler or no libpng headers)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not (NATIVE_DIR / "src" / "native.cpp").exists():
            return None
        out = library_path()
        if not out.exists():
            _build(out)
        if not out.exists():
            return None
        lib = ctypes.CDLL(str(out))
        lib.png_decode_gray.restype = ctypes.c_int
        lib.png_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.shm_attach.restype = ctypes.c_void_p
        lib.shm_attach.argtypes = [ctypes.c_char_p]
        lib.shm_size.restype = ctypes.c_uint32
        lib.shm_size.argtypes = [ctypes.c_void_p]
        lib.shm_wait.argtypes = [ctypes.c_void_p]
        lib.shm_read.restype = ctypes.c_int64
        lib.shm_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.shm_detach.argtypes = [ctypes.c_void_p]
        lib.udp_multicast_open.restype = ctypes.c_void_p
        lib.udp_multicast_open.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
        lib.udp_send.restype = ctypes.c_int64
        lib.udp_send.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.udp_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class png_native:
    """Namespace-style accessor used by io/kitti.py."""

    _MAX_BYTES = 4096 * 2048 * 4

    @staticmethod
    def decode_gray(path: str):
        """Grayscale float32 ``[H, W]``, or None without the library or on a
        decode error."""
        lib = get_lib()
        if lib is None:
            return None
        buf = np.empty(png_native._MAX_BYTES // 4, dtype=np.float32)
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        rc = lib.png_decode_gray(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            buf.nbytes, ctypes.byref(w), ctypes.byref(h),
        )
        if rc != 0:
            return None
        return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class SharedMemoryClient:
    """cluon-compatible shared-memory frame source (native path)."""

    def __init__(self, name: str):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError(f"native library not built (make -C native OUT={library_path()})")
        self._handle = self._lib.shm_attach(name.encode())
        if not self._handle:
            raise FileNotFoundError(f"shared memory '{name}' not found")
        self.size = self._lib.shm_size(self._handle)

    def wait(self) -> None:
        self._lib.shm_wait(self._handle)

    def read(self) -> np.ndarray:
        buf = np.empty(self.size, dtype=np.uint8)
        self._lib.shm_read(self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           buf.nbytes)
        return buf

    def close(self) -> None:
        if self._handle:
            self._lib.shm_detach(self._handle)
            self._handle = None


class UdpMulticastSender:
    def __init__(self, group: str, port: int):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library not built")
        self._handle = self._lib.udp_multicast_open(group.encode(), port)

    def send(self, data: bytes) -> int:
        arr = np.frombuffer(data, dtype=np.uint8)
        return self._lib.udp_send(self._handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  len(data))

    def close(self) -> None:
        if self._handle:
            self._lib.udp_close(self._handle)
            self._handle = None
