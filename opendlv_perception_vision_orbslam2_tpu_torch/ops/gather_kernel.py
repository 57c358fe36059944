"""Batched window gather: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``gather_patches`` of the reference package
(``ops/gather_pallas.py:42``).  The CUDA source is ``csrc/gather_patches.cu``.
It only copies, so it is bound by memory traffic: the ORB gather writes
4000 x 45 x 45 x 4 B = ~32 MB per stereo frame, the two stereo SAD gathers
~2.9 MB.  On the card there is no VMEM limit, so the ORB path is one launch
over the two-eye atlas, and with the two SAD gathers a frame makes 3
launches.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import cuda_build


def gather_patches_plain(img, y0, x0, ph: int, pw: int):
    """Index-arithmetic version: starts clipped to ``[0, H-ph] x [0, W-pw]``."""
    H, W = img.shape
    y = torch.clamp(y0.long(), 0, H - ph)
    x = torch.clamp(x0.long(), 0, W - pw)
    ar_h = torch.arange(ph, device=img.device)
    ar_w = torch.arange(pw, device=img.device)
    return img[y[:, None, None] + ar_h[:, None], x[:, None, None] + ar_w]


def gather_patches(img, y0, x0, ph: int, pw: int):
    """``img [H, W]`` float32, ``y0/x0 [N]`` integer top-left corners ->
    ``[N, ph, pw]`` float32 windows; starts are clipped into the image."""
    H, W = img.shape
    if ph > H or pw > W:
        raise ValueError(f"gather_patches: window {ph}x{pw} exceeds image {H}x{W}")
    if img.device.type == "cpu":
        return gather_patches_plain(img, y0, x0, ph, pw)
    if img.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img.device}")
    if img.dtype != torch.float32 or y0.shape != x0.shape or y0.dim() != 1:
        raise ValueError("gather_patches: need float32 img and [N] starts")
    if y0.device != img.device or x0.device != img.device:
        raise ValueError("gather_patches: starts must be on the image's device")
    import ctypes

    lib = cuda_build.load("gather_patches")
    src = img.contiguous()
    ys = y0.to(torch.int32).contiguous()
    xs = x0.to(torch.int32).contiguous()
    n = ys.shape[0]
    out = torch.empty((n, ph, pw), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.gather_patches_launch(
            ctypes.c_void_p(src.data_ptr()), ctypes.c_void_p(ys.data_ptr()),
            ctypes.c_void_p(xs.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(n), ctypes.c_int(H), ctypes.c_int(W),
            ctypes.c_int(ph), ctypes.c_int(pw), ctypes.c_void_p(stream),
        )
    cuda_build.check(lib, err, "gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
