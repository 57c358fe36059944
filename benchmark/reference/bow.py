"""The plain reference of the keyframes' BoW rows, and the vocabulary tree
that the benchmark's vocabulary file is written from.

The tree is made from a fixed seed (``harness/vocab.py`` writes it as a
DBoW2 text file, which the program loads): every level is made from its
parent by flipping ``16 + 8 * (L - depth)`` distinct bits (16 at the
leaves), from a random root, and the leaves' weights are DBoW2's idf,
``ln(N / n_i)``, over ``N`` random training descriptors pushed through the
finished tree.  The reference makes the same tree again from the seed, so
it reads nothing that the program made.

A keyframe's row is DBoW2's transform of its valid descriptors: each
descends the tree to the child at the least Hamming distance (the first
among equals), and the row is the L1-normalised sum of the reached words'
weights (tf-idf).  The program's rows are judged by their L1 distance from
these: 0 for equal rows, 2 for rows with no word in common.

The control (``bf16``) puts these rows, rounded to bfloat16, in the
program's place: the keyframe database in the next precision below its
float32, which would halve its 10^6-word rows.
"""

from __future__ import annotations

import numpy as np

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _flip_masks(rng, n: int, n_bits: int, chunk: int = 1 << 16) -> np.ndarray:
    """``[n, 32]`` uint8 masks with ``n_bits`` distinct bits set each."""
    out = np.empty((n, 32), np.uint8)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        pos = np.argpartition(rng.random((m, 256), dtype=np.float32), n_bits, axis=1)[:, :n_bits]
        bits = np.zeros((m, 256), np.uint8)
        np.put_along_axis(bits, pos, 1, axis=1)
        out[s:s + m] = np.packbits(bits, axis=1, bitorder="little")
    return out


def descend(level_desc, descs: np.ndarray, branching: int, chunk: int = 1 << 14) -> np.ndarray:
    """Leaf index of each descriptor ``[M, 32]`` uint8; among children at
    equal Hamming distance the first wins."""
    out = np.empty(len(descs), np.int64)
    lane = np.arange(branching)
    for s in range(0, len(descs), chunk):
        d_part = descs[s:s + chunk]
        cur = np.zeros(len(d_part), np.int64)
        for nodes in level_desc:
            kids = cur[:, None] * branching + lane[None, :]
            d = _POPCOUNT8[d_part[:, None, :] ^ nodes[kids]].sum(axis=-1, dtype=np.int32)
            cur = kids[np.arange(len(d_part)), np.argmin(d, axis=1)]
        out[s:s + chunk] = cur
    return out


def tree(branching: int, levels: int, seed: int, n_train: int):
    """``(level_desc, idf)``: each level's node descriptors ``[k^d, 32]``
    uint8 in breadth-first order, and the leaves' idf weights as the text
    file writes them (six decimals)."""
    rng = np.random.default_rng(seed)
    parent = rng.integers(0, 256, (1, 32), dtype=np.uint8)
    level_desc = []
    for depth in range(1, levels + 1):
        n = len(parent) * branching
        parent = np.repeat(parent, branching, axis=0) ^ _flip_masks(
            rng, n, 16 + 8 * (levels - depth))
        level_desc.append(parent)
    train = rng.integers(0, 256, (n_train, 32), dtype=np.uint8)
    word = descend(level_desc, train, branching)
    reached = np.bincount(word, minlength=branching ** levels)
    idf = np.round(np.log(n_train / np.maximum(reached, 1)), 6)
    return level_desc, idf


def rows(level_desc, idf, branching: int, descs, valid) -> list:
    """The reference's row of each keyframe, ``[(words, weights)]``: its
    distinct words in increasing order and their L1-normalised tf-idf.
    ``descs [K, F, 8]`` are the features' descriptors as int32 words (the
    bytes of each in little-endian order), ``valid [K, F]`` bool."""
    descs = np.ascontiguousarray(descs, np.int32)
    k, f = descs.shape[:2]
    flat = descs.view(np.uint8).reshape(k * f, 32)
    valid = np.asarray(valid, bool).reshape(k * f)
    leaf = np.full(k * f, -1, np.int64)
    leaf[valid] = descend(level_desc, flat[valid], branching)
    out = []
    for r in leaf.reshape(k, f):
        words, tf = np.unique(r[r >= 0], return_counts=True)
        v = tf * idf[words]
        out.append((words, v / v.sum() if v.sum() > 0 else v))
    return out


def l1(words_a, values_a, words_b, values_b) -> float:
    """The L1 distance of two sparse rows."""
    both = np.union1d(words_a, words_b)
    a = np.zeros(len(both))
    b = np.zeros(len(both))
    a[np.searchsorted(both, words_a)] = values_a
    b[np.searchsorted(both, words_b)] = values_b
    return float(np.abs(a - b).sum())


def bf16(x) -> np.ndarray:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def bow_numbers(program_rows, reference_rows, ids) -> dict:
    """``{"bow_row_l1", "bow_keyframes", "bow_worst"}``: the largest L1
    distance between a keyframe's row in the program's database and the
    reference's, over the keyframes ``ids``; a keyframe without a row in
    the database (``None``) reads 2."""
    dist = [2.0 if p is None else l1(p[0], p[1], *r)
            for p, r in zip(program_rows, reference_rows)]
    worst = int(np.argmax(dist)) if dist else 0
    return {"bow_row_l1": max(dist, default=0.0), "bow_keyframes": len(dist),
            "bow_worst": (int(ids[worst]), dist[worst]) if dist else None}
