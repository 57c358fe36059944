"""Batched window gather: CUDA kernel wrappers and plain versions.

Replaces the Pallas TPU kernel ``gather_patches`` of the reference package
(``ops/gather_pallas.py:42``).  The CUDA source is ``csrc/gather_patches.cu``.
It only copies, so it is bound by memory traffic: the ORB gather writes
4000 x 45 x 45 x 4 B = ~32 MB per stereo frame, the two stereo SAD gathers
~2.9 MB.  On the card there is no VMEM limit, so the ORB path is one launch
over the two-eye atlas (:func:`gather_patches`), and the two SAD gathers are
one more (:func:`gather_patches_multi`): 2 launches a frame.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import cuda_build

# Output floats one block writes (csrc/gather_patches.cu, checked at load),
# and the most jobs one launch takes.
BLOCK_FLOATS = 2048
MAX_JOBS = 4


def gather_patches_plain(img, y0, x0, ph: int, pw: int):
    """Index-arithmetic version: starts clipped to ``[0, H-ph] x [0, W-pw]``."""
    H, W = img.shape
    y = torch.clamp(y0.long(), 0, H - ph)
    x = torch.clamp(x0.long(), 0, W - pw)
    ar_h = torch.arange(ph, device=img.device)
    ar_w = torch.arange(pw, device=img.device)
    return img[y[:, None, None] + ar_h[:, None], x[:, None, None] + ar_w]


def gather_patches_multi_plain(jobs):
    """One :func:`gather_patches_plain` per job ``(img, y0, x0, ph, pw)``."""
    return [gather_patches_plain(*job) for job in jobs]


def gather_job_table(sizes):
    """The launch table for jobs of ``sizes`` output floats: per job ``(out
    offset, first block)`` in one output buffer, each offset a multiple of 4
    floats (16 bytes), and ``(buffer floats, block count)``."""
    rows, offset, first = [], 0, 0
    for n in sizes:
        padded = -(-n // 4) * 4
        rows.append((offset, first))
        offset += padded
        first += -(-padded // BLOCK_FLOATS)
    return rows, offset, first


def block_span(flat: int, rows, sizes):
    """``(job, start, stop)``: the job and the range of its output floats
    (padding included) that block ``flat`` writes, as the kernel maps it."""
    k = 0
    while k + 1 < len(rows) and flat >= rows[k + 1][1]:
        k += 1
    padded = -(-sizes[k] // 4) * 4
    start = (flat - rows[k][1]) * BLOCK_FLOATS
    return k, start, min(start + BLOCK_FLOATS, padded)


def _check_job(img, y0, x0, ph: int, pw: int):
    H, W = img.shape
    if ph > H or pw > W:
        raise ValueError(f"gather_patches: window {ph}x{pw} exceeds image {H}x{W}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_patches: unsupported device {img.device}")
    if y0.shape != x0.shape or y0.dim() != 1:
        raise ValueError("gather_patches: need [N] starts")


def _load():
    lib = cuda_build.load("gather_patches")
    if lib.gather_block_floats() != BLOCK_FLOATS:
        raise RuntimeError(f"gather_patches.cu writes {lib.gather_block_floats()} floats "
                           f"a block, the table assumes {BLOCK_FLOATS}")
    return lib


def _launch(jobs):
    """One kernel launch over ``jobs`` on one CUDA device; returns the
    ``[N, ph, pw]`` outputs, views of one buffer."""
    import ctypes

    if not jobs or len(jobs) > MAX_JOBS:
        raise ValueError(f"gather_patches: need 1-{MAX_JOBS} jobs, got {len(jobs)}")
    dev = jobs[0][0].device
    args = []
    for img, y0, x0, ph, pw in jobs:
        if img.device != dev or img.dtype != torch.float32:
            raise ValueError(f"gather_patches: need float32 images on {dev}")
        if y0.device != dev or x0.device != dev:
            raise ValueError("gather_patches: starts must be on the image's device")
        args.append((img.contiguous(), y0.to(torch.int32).contiguous(),
                     x0.to(torch.int32).contiguous(), ph, pw))
    sizes = [y.shape[0] * ph * pw for _, y, _, ph, pw in args]
    rows, n_floats, n_blocks = gather_job_table(sizes)
    if n_floats >= 2 ** 31:
        raise ValueError(f"gather_patches: {n_floats} output floats exceed int32 indexing")
    buf = torch.empty(n_floats, dtype=torch.float32, device=dev)
    outs = [buf[off:off + n].view(y.shape[0], ph, pw)
            for (off, _), n, (_, y, _, ph, pw) in zip(rows, sizes, args)]
    if n_blocks == 0:       # every job empty: nothing to launch
        return outs, False
    table = (ctypes.c_longlong * (10 * len(args)))(*[
        v for (img, y, x, ph, pw), (off, first) in zip(args, rows)
        for v in (img.data_ptr(), y.data_ptr(), x.data_ptr(), buf.data_ptr() + 4 * off,
                  y.shape[0], *img.shape, ph, pw, first)])
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gather_patches_launch(table, ctypes.c_int(len(args)), ctypes.c_int(n_blocks),
                                        ctypes.c_void_p(stream))
    cuda_build.check(lib, err, "gather_patches")
    return outs, True


def gather_patches(img, y0, x0, ph: int, pw: int):
    """``img [H, W]`` float32, ``y0/x0 [N]`` integer top-left corners ->
    ``[N, ph, pw]`` float32 windows; starts are clipped into the image."""
    _check_job(img, y0, x0, ph, pw)
    if img.device.type == "cpu":
        return gather_patches_plain(img, y0, x0, ph, pw)
    (out,), launched = _launch([(img, y0, x0, ph, pw)])
    gather_patches.launches += launched
    return out


def gather_patches_multi(jobs):
    """:func:`gather_patches` of every job ``(img, y0, x0, ph, pw)``, in ONE
    kernel launch on the card (the images may differ): a list of outputs."""
    for job in jobs:
        _check_job(*job)
    devices = {job[0].device.type for job in jobs}
    if devices == {"cpu"}:
        return gather_patches_multi_plain(jobs)
    if devices != {"cuda"}:
        raise ValueError(f"gather_patches_multi: mixed devices {devices}")
    outs, launched = _launch(list(jobs))
    gather_patches_multi.launches += launched
    return outs


gather_patches.launches = 0
gather_patches_multi.launches = 0
