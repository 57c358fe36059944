"""Build and load the package's CUDA kernels (``csrc/*.cu``) with nvcc + ctypes.

Each source compiles on first use into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under the package's
``_build/`` directory, which is git-ignored.  The library name carries a hash
of the source and the flags, so an edited source rebuilds and a stale
library is never loaded.  ``ctypes`` and the toolkit are looked up only here,
inside the loader, so the CPU-only tests import every module without a CUDA
toolkit.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


@functools.lru_cache(maxsize=None)
def load(name: str):
    """Build ``csrc/<name>.cu`` if needed and return it as a ``ctypes.CDLL``.

    The compiler's register/shared-memory report (``-Xptxas -v``) is kept
    beside the library as ``<lib>.log``."""
    import ctypes

    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}"
            )
        Path(str(out) + ".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    lib = ctypes.CDLL(str(out))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
