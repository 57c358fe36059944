"""Fused FAST-9/16 V-score + 3x3 NMS: CUDA kernel wrappers and plain versions.

Replaces the Pallas TPU kernel ``fast_nms`` of the reference package
(``ops/fast_pallas.py:98``, body ``_fast_nms_kernel``).  The CUDA source is
``csrc/fast_nms.cu``.  Its memory traffic is one image read and one
score-map write, ~2 x 1.44 Mpx x 8 B = ~23 MB per KITTI stereo frame over 8
levels, and it is bound by those bytes: the kernel runs the 9-arc tree only
on the pixels that pass FAST's compass test (``ops/fast.py::compass_test``).
The whole pyramid of both eyes goes through one launch
(:func:`fast_nms_pyramid`, one launch per frame); :func:`fast_nms` is the
same kernel on one image or batch.

Unlike the Pallas kernel (zero padding, exact only >= 4 px inside), the CUDA
kernel reproduces the plain chain over the whole image.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .fast import fast_score_map, nms_scores

# The kernel's output tile (csrc/fast_nms.cu TH, TW; checked at load) and
# the most levels one launch takes.
TILE_H, TILE_W = 32, 62
MAX_LEVELS = 16


def fast_nms_plain(img, threshold: float):
    """``nms_scores(fast_score_map(img, threshold))`` on ``[..., H, W]``."""
    return nms_scores(fast_score_map(img, threshold))


def pyramid_tile_table(shapes):
    """The launch table over levels ``(B, H, W)``: per level ``(H, W, tiles
    across, tiles per image, first flat tile)``, and the flat tile count.
    Levels follow one another; within a level, eye-major then row-major
    tiles of ``TILE_H x TILE_W`` output pixels."""
    rows, first = [], 0
    for B, H, W in shapes:
        tx, ty = -(-W // TILE_W), -(-H // TILE_H)
        rows.append((H, W, tx, tx * ty, first))
        first += B * tx * ty
    return rows, first


def tile_of(flat: int, rows):
    """``(level, eye, y0, x0)`` of flat tile ``flat``: the kernel's own
    mapping of its block index."""
    lvl = 0
    while lvl + 1 < len(rows) and flat >= rows[lvl + 1][4]:
        lvl += 1
    H, W, tx, per_image, first = rows[lvl]
    t = flat - first
    eye, rem = divmod(t, per_image)
    ty, tx_ = divmod(rem, tx)
    return lvl, eye, ty * TILE_H, tx_ * TILE_W


def _load():
    import ctypes

    lib = cuda_build.load("fast_nms")
    th, tw = ctypes.c_int(), ctypes.c_int()
    lib.fast_nms_tile(ctypes.byref(th), ctypes.byref(tw))
    if (th.value, tw.value) != (TILE_H, TILE_W):
        raise RuntimeError(f"fast_nms.cu tile {th.value}x{tw.value} != {TILE_H}x{TILE_W}")
    return lib


def _launch(levels, threshold: float):
    """One kernel launch over ``levels`` (each ``[H, W]`` or ``[B, H, W]``
    float32 on one CUDA device); returns the maps, views of one buffer."""
    import ctypes

    if not levels or len(levels) > MAX_LEVELS:
        raise ValueError(f"fast_nms: need 1-{MAX_LEVELS} levels, got {len(levels)}")
    dev = levels[0].device
    for lv in levels:
        if lv.device != dev or lv.dtype != torch.float32 or lv.dim() not in (2, 3):
            raise ValueError(f"fast_nms: need float32 [H, W] or [B, H, W] on {dev}, got "
                             f"{lv.dtype} {tuple(lv.shape)} on {lv.device}")
    xs = [lv.contiguous() for lv in levels]
    shapes = [(1 if x.dim() == 2 else x.shape[0], *x.shape[-2:]) for x in xs]
    rows, n_blocks = pyramid_tile_table(shapes)
    sizes = [x.numel() for x in xs]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs = list(torch.split(buf, sizes))
    table = (ctypes.c_longlong * (7 * len(xs)))(*[
        v for x, out, row in zip(xs, outs, rows)
        for v in (x.data_ptr(), out.data_ptr(), *row)])
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fast_nms_pyramid_launch(table, ctypes.c_int(len(xs)), ctypes.c_int(n_blocks),
                                          ctypes.c_float(float(threshold)),
                                          ctypes.c_void_p(stream))
    cuda_build.check(lib, err, "fast_nms")
    return [out.view(x.shape) for out, x in zip(outs, xs)]


def fast_nms_pyramid(levels, threshold: float):
    """:func:`fast_nms` of every level in ``levels`` (each ``[H, W]`` or
    ``[B, H, W]`` float32), in ONE kernel launch on the card: a list of
    maps, views of one output buffer."""
    if all(lv.device.type == "cpu" for lv in levels):
        return [fast_nms_plain(lv, threshold) for lv in levels]
    if any(lv.device.type != "cuda" for lv in levels):
        raise ValueError(f"fast_nms_pyramid: unsupported devices {[lv.device for lv in levels]}")
    maps = _launch(levels, threshold)
    fast_nms_pyramid.launches += 1
    return maps


def fast_nms(img, threshold: float):
    """Dense FAST-9/16 score (0 below ``threshold``) after 3x3 NMS, for one
    ``[H, W]`` or a batch ``[B, H, W]`` of float32 images."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, threshold)
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    (out,) = _launch([img], threshold)
    fast_nms.launches += 1
    return out


fast_nms.launches = 0
fast_nms_pyramid.launches = 0
