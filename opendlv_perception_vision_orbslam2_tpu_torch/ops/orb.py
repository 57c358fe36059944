"""ORB orientation + binned steered BRIEF from raw 45x45 patches.

Counterpart of the production functions of the reference package's
``ops/orb.py`` (IC_Angle reference: src/orbextractor.cpp:136-163;
computeOrbDescriptor reference: src/orbextractor.cpp:166-203).  The constant
tables are rebuilt with numpy from the same seed, so they equal the
reference package's.

Descriptor layout: 256 bits packed into ``int32 [N, 8]`` (same bits as the
reference package's ``uint32 [N, 8]``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .image import edge_pad

PATCH_SIZE = 31
HALF_PATCH_SIZE = 15
N_BITS = 256
DESC_WORDS = 8  # 256 bits / 32

BRIEF_HALF = 19     # max reach of a rotated pattern point (13*sqrt(2) < 19)
BLUR_MARGIN = 3     # 7x7 Gaussian
PATCH_HALF = BRIEF_HALF + BLUR_MARGIN          # 22 -> 45x45 raw patches
PATCH_SIDE = 2 * PATCH_HALF + 1
BRIEF_SIDE = 2 * BRIEF_HALF + 1                # 39x39 blurred interior
N_ANGLE_BINS = 30                              # 2*pi/30 = 12 deg (ORB paper)


@functools.lru_cache(maxsize=None)
def brief_pattern():
    """Deterministic 256-pair sampling pattern, ``int32 [256, 4]`` (x1,y1,x2,y2):
    iid Gaussian(0, (PATCH/5)^2) clipped to the 13-px disc, fixed seed."""
    rng = np.random.default_rng(0x0B5E55ED)
    sigma = PATCH_SIZE / 5.0
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(0.0, sigma, size=(N_BITS * 4, 2))
        cand = np.round(cand).astype(np.int32)
        keep = (np.abs(cand[:, 0]) <= 13) & (np.abs(cand[:, 1]) <= 13)
        pts.extend(cand[keep].tolist())
    pts = np.asarray(pts[: N_BITS * 2], dtype=np.int32)
    return np.concatenate([pts[0::2], pts[1::2]], axis=1)  # [256, 4]


@functools.lru_cache(maxsize=None)
def _moment_matrix():
    """[961, 2] float32: flattened disc-masked (dx, dy) weights."""
    ys, xs = np.mgrid[-HALF_PATCH_SIZE : HALF_PATCH_SIZE + 1,
                      -HALF_PATCH_SIZE : HALF_PATCH_SIZE + 1]
    disc = (ys * ys + xs * xs) <= HALF_PATCH_SIZE * HALF_PATCH_SIZE
    return np.stack(
        [(xs * disc).reshape(-1), (ys * disc).reshape(-1)], -1
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _patch_blur_matrix():
    """[39, 45] float32 rows of the 7x7-sigma2 Gaussian: blurred valid
    interior of a 45-wide raw patch."""
    half = BLUR_MARGIN
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * 2.0 * 2.0))
    k /= k.sum()
    m = np.zeros((BRIEF_SIDE, PATCH_SIDE), np.float32)
    for i in range(BRIEF_SIDE):
        m[i, i : i + 2 * half + 1] = k
    return m


@functools.lru_cache(maxsize=None)
def _binned_sample_indices():
    """[30, 512] int32 flat indices into a 39x39 patch: the rotated (a, b)
    sample positions of all 256 pairs for each 12-deg angle bin."""
    pat = brief_pattern()
    out = np.zeros((N_ANGLE_BINS, 2 * N_BITS), np.int32)
    for b in range(N_ANGLE_BINS):
        th = (b + 0.5) * 2.0 * np.pi / N_ANGLE_BINS - np.pi
        c, s = np.cos(th), np.sin(th)

        def rot(px, py):
            rx = np.round(px * c - py * s).astype(np.int64)
            ry = np.round(px * s + py * c).astype(np.int64)
            return (np.clip(rx, -BRIEF_HALF, BRIEF_HALF),
                    np.clip(ry, -BRIEF_HALF, BRIEF_HALF))

        ax, ay = rot(pat[:, 0], pat[:, 1])
        bx, by = rot(pat[:, 2], pat[:, 3])
        out[b, :N_BITS] = (ay + BRIEF_HALF) * BRIEF_SIDE + (ax + BRIEF_HALF)
        out[b, N_BITS:] = (by + BRIEF_HALF) * BRIEF_SIDE + (bx + BRIEF_HALF)
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """Moment matrix, blur matrix and binned indices on ``device``."""
    return (torch.from_numpy(_moment_matrix()).to(device),
            torch.from_numpy(_patch_blur_matrix()).to(device),
            torch.from_numpy(_binned_sample_indices()).long().to(device))


def build_patch_atlas(levels, half: int = PATCH_HALF):
    """Stack edge-padded pyramid levels ``[..., H_l, W_l]`` into one tall
    image ``[..., sum(H_l+2h), W0+2h]`` plus numpy per-level row offsets.

    Each level is replicate-padded by ``half`` (patch gathers never clamp at
    level borders) and zero-extended to the widest padded level.  A patch
    centred at level coords ``(x, y)`` of level ``l`` starts at
    ``(round(y) + row_offsets[l], round(x))``.  With a leading eye axis,
    reshaping to ``[-1, W0+2h]`` gives the eyes' atlases stacked vertically.
    """
    w0 = levels[0].shape[-1] + 2 * half
    padded, offsets, row = [], [], 0
    for im in levels:
        p = edge_pad(im, half, half, half, half)
        p = torch.nn.functional.pad(p, (0, w0 - p.shape[-1]))
        padded.append(p)
        offsets.append(row)
        row += p.shape[-2]
    return torch.cat(padded, dim=-2), np.asarray(offsets, np.int32)


def ic_angles_from_patches(patches):
    """IC orientation from raw patches ``[N, S, S]`` (S >= 31, centered):
    one [N, 961] @ [961, 2] matmul + atan2."""
    moment, _, _ = _device_tables(patches.device)
    s = patches.shape[-1]
    lo = s // 2 - HALF_PATCH_SIZE
    inner = patches[:, lo : lo + PATCH_SIZE, lo : lo + PATCH_SIZE]
    m = inner.reshape(-1, PATCH_SIZE * PATCH_SIZE) @ moment
    return torch.atan2(m[:, 1], m[:, 0])


def blur_patches(patches):
    """7x7 sigma-2 Gaussian blur of raw patches ``[N, 45, 45]`` -> their valid
    ``[N, 39, 39]`` interior, as two batched matmuls.

    Float32 sums in another order than XLA:CPU's: where a pair of BRIEF
    samples ties in exact arithmetic (flat image regions), the rounding
    decides the bit, so such bits can differ from the reference package's.
    """
    _, bm, _ = _device_tables(patches.device)
    return bm @ patches @ bm.T


def brief_from_blurred(blurred, angles):
    """Steered binned BRIEF from blurred patches ``[N, 39, 39]``: each angle
    bin's rotated sample pairs are read with one index gather and compared,
    then packed to ``int32 [N, 8]``.  This is the reference's exact gather
    branch; its bf16 difference-matrix branch can flip bits and has no
    counterpart here."""
    _, _, bin_idx = _device_tables(blurred.device)
    flat = blurred.reshape(blurred.shape[0], BRIEF_SIDE * BRIEF_SIDE)
    # 12-degree bin of each angle, in float32 with a true division (a tensor
    # divisor: a Python-scalar one becomes a reciprocal multiply on CUDA)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=angles.device)
    bins = torch.floor((angles + math.pi) / two_pi * N_ANGLE_BINS).to(torch.int64)
    idx = bin_idx[torch.remainder(bins, N_ANGLE_BINS)]          # [N, 512]
    vals = torch.take_along_dim(flat, idx, dim=1)
    return pack_bits(vals[:, :N_BITS] < vals[:, N_BITS:])


def brief_from_patches(patches, angles):
    """Steered binned BRIEF from raw patches ``[N, 45, 45]`` -> ``int32 [N, 8]``."""
    return brief_from_blurred(blur_patches(patches), angles)


def unpack_bits(descs):
    """``int32 [..., 8]`` -> ``int32 [..., 256]`` of 0/1 bits (the arithmetic
    shift of a negative word is masked by ``& 1``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=descs.device)
    bits = (descs[..., :, None] >> shifts) & 1
    return bits.reshape(*descs.shape[:-1], N_BITS)


def pack_bits(bits):
    """Inverse of :func:`unpack_bits`: sums in int64 so bit 31 cannot
    overflow, then wraps to the int32 with the same bits."""
    b = bits.reshape(*bits.shape[:-1], DESC_WORDS, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    words = words - ((words >> 31) & 1) * (1 << 32)
    return words.to(torch.int32)
