"""Fused FAST-9/16 V-score + 3x3 NMS: CUDA kernel wrapper and plain version.

Replaces the Pallas TPU kernel ``fast_nms`` of the reference package
(``ops/fast_pallas.py:98``, body ``_fast_nms_kernel``).  The CUDA source is
``csrc/fast_nms.cu``.  Its memory traffic is one image read and one
score-map write, ~2 x 1.44 Mpx x 8 B = ~23 MB per KITTI stereo frame over 8
levels; the ~300 subtract/min/max per pixel stay in registers and, on an
H100, take longer than the bytes (see the source).  The two eyes of a level
go through one launch (8 launches per frame).

Unlike the Pallas kernel (zero padding, exact only >= 4 px inside), the CUDA
kernel reproduces the plain chain over the whole image.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .fast import fast_score_map, nms_scores


def fast_nms_plain(img, threshold: float):
    """``nms_scores(fast_score_map(img, threshold))`` on ``[..., H, W]``."""
    return nms_scores(fast_score_map(img, threshold))


def fast_nms(img, threshold: float):
    """Dense FAST-9/16 score (0 below ``threshold``) after 3x3 NMS, for one
    ``[H, W]`` or a batch ``[B, H, W]`` of float32 images."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, threshold)
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"fast_nms: need float32 [H, W] or [B, H, W], got "
                         f"{img.dtype} {tuple(img.shape)}")
    import ctypes

    lib = cuda_build.load("fast_nms")
    x = img.contiguous()
    B = 1 if x.dim() == 2 else x.shape[0]
    H, W = x.shape[-2:]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fast_nms_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(B), ctypes.c_int(H), ctypes.c_int(W),
            ctypes.c_float(float(threshold)), ctypes.c_void_p(stream),
        )
    cuda_build.check(lib, err, "fast_nms")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0
