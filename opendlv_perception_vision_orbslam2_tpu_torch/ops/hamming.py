"""Hamming distances over packed 256-bit ORB descriptors + rotation filter.

Counterpart of the reference package's ``ops/hamming.py`` (DescriptorDistance
SWAR popcount, reference: src/orbmatcher.cpp:1662-1676).  Torch has no
popcount op, so distances use the exact bit-dot identity
``ham(a, b) = popcnt(a) + popcnt(b) - 2 <a_bits, b_bits>``: the products are
0/1 and sums <= 256, exact in float32.
"""

from __future__ import annotations

import math

import torch

from .orb import unpack_bits

TH_LOW = 50
TH_HIGH = 100
MAX_DIST = 256


def hamming_matrix(a, b):
    """``int32 [N, 8] x int32 [M, 8] -> int32 [N, M]`` exact distances."""
    ab = unpack_bits(a).to(torch.float32)          # [N, 256]
    bb = unpack_bits(b).to(torch.float32)          # [M, 256]
    dot = ab @ bb.T
    pa = ab.sum(dim=1)[:, None]
    pb = bb.sum(dim=1)[None, :]
    return (pa + pb - 2.0 * dot).to(torch.int32)


def rotation_consistency_mask(angle_a, angle_b, matched, valid,
                              histo_len: int = 30, window_bins: int = 2):
    """Keep only matches whose angle difference lies within ``+-window_bins``
    (circular) of the dominant bin of a 30-bin rotation histogram
    (ComputeThreeMaxima + rot-hist filter, reference:
    src/orbmatcher.cpp:1618-1660).  Returns bool ``[N]``."""
    two_pi = 2.0 * math.pi
    rot = angle_a - angle_b[matched]
    rot = torch.remainder(rot, two_pi)
    bin_idx = torch.floor(rot * (histo_len / two_pi)).to(torch.int64)
    bin_idx = torch.clamp(bin_idx, 0, histo_len - 1)
    counts = torch.zeros(histo_len, dtype=torch.int64, device=rot.device)
    counts.index_add_(0, bin_idx, valid.to(torch.int64))
    peak = torch.argmax(counts)
    d = torch.abs(bin_idx - peak)
    circ = torch.minimum(d, histo_len - d)
    return valid & (circ <= window_bins)
