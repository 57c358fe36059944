"""Binary-descriptor vocabulary: k-ary Hamming tree + batched transform.

Counterpart of the reference package's ``models/vocabulary.py`` (capability
parity with OrbVocabulary, reference: src/orbvocabulary.cpp, the DBoW2
rewrite that loads ``ORBvoc.txt`` and descends a k<=20-ary, L<=10 tree per
descriptor, transform4/5, src/orbvocabulary.cpp:168-242).  No vocabulary
file ships, so besides the text-format loader there is a trainer:
hierarchical k-means over binary descriptors with bitwise-majority
centroids, the classic DBoW2 build.

The trainer and the loader are numpy (``train_vocabulary_np`` returns plain
arrays, so a worker thread can train without touching the device); with the
same descriptors and seed they return the reference package's arrays bit for
bit.
The transform descends the tree for all features of all keyframes at once:
L rounds of gather + Hamming + first-minimum; BoW vectors are dense ``[W]``
rows (tf-idf, L1-normalized), so database scoring is an elementwise min-sum
and common-word counting a matrix product (``kfdb.py``).

Scoring is the correct DBoW2 L1 similarity, not the reference C++'s GetScore
with its iterator bug (src/orbvocabulary.cpp:129).

Descriptors are ``int32`` holding the reference's ``uint32`` bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.hamming import MAX_DIST, popcount32


class Vocabulary(NamedTuple):
    node_desc: torch.Tensor    # [N, 8] int32 node centroid descriptors
    children: torch.Tensor     # [N, k] int32 child node ids (-1 pad)
    node_word: torch.Tensor    # [N] int32 word id for leaves (-1 internal)
    word_weight: torch.Tensor  # [W] float32 idf weights
    levels: int                # tree depth L
    branching: int             # k
    n_words: int               # W


def _as_uint32(descs) -> np.ndarray:
    """Packed descriptors ``[M, 8]`` as contiguous uint32 (int32 input keeps
    its bits)."""
    a = np.ascontiguousarray(descs)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(np.uint32, copy=False)


def _unpack_bits_np(descs: np.ndarray) -> np.ndarray:
    """uint32 [M, 8] -> uint8 bits [M, 256]."""
    b = descs.view(np.uint8).reshape(len(descs), 32)
    return np.unpackbits(b, axis=1, bitorder="little")


def _pack_bits_np(bits: np.ndarray) -> np.ndarray:
    b = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    return b.view(np.uint32).reshape(len(bits), 8)


def _majority(bits: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid (OrbDescriptor::meanValue semantics,
    reference: src/orbdescriptor.cpp:24-73)."""
    return (bits.sum(axis=0) * 2 >= len(bits)).astype(np.uint8)


def _kmeans_binary(bits: np.ndarray, k: int, rng, iters: int = 8):
    """k-means over binary descriptors with Hamming assignment + majority
    update.  Returns (centers_bits [k', 256], assign [M])."""
    M = len(bits)
    k = min(k, M)
    idx = rng.choice(M, k, replace=False)
    centers = bits[idx].copy()
    assign = None
    for _ in range(iters):
        d = (bits[:, None, :] != centers[None, :, :]).sum(axis=2)
        new_assign = d.argmin(axis=1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for c in range(k):
            members = bits[assign == c]
            if len(members):
                centers[c] = _majority(members)
    # drop empty clusters
    used = np.unique(assign)
    remap = -np.ones(k, np.int64)
    remap[used] = np.arange(len(used))
    return centers[used], remap[assign]


def train_vocabulary_np(descs, branching: int = 8, levels: int = 3, seed: int = 0):
    """Hierarchical k-means vocabulary from packed descriptors ``[M, 8]``,
    numpy in and out: ``(node_desc uint32 [N, 8], children, node_word,
    word_weight, levels, branching, n_words)``."""
    rng = np.random.default_rng(seed)
    bits = _unpack_bits_np(_as_uint32(descs))

    node_desc = [np.zeros(256, np.uint8)]   # root (unused descriptor)
    children: list[list[int]] = [[]]
    node_word = [-1]
    leaf_sizes = []

    def split(indices: np.ndarray, level: int, node_id: int):
        if level == levels or len(indices) <= branching:
            node_word[node_id] = len(leaf_sizes)
            leaf_sizes.append(len(indices))
            return
        centers, assign = _kmeans_binary(bits[indices], branching, rng)
        for c in range(len(centers)):
            cid = len(node_desc)
            node_desc.append(centers[c])
            children.append([])
            node_word.append(-1)
            children[node_id].append(cid)
            split(indices[assign == c], level + 1, cid)

    split(np.arange(len(bits)), 0, 0)

    # leaves may exist above max depth; every leaf got a word id
    n_nodes = len(node_desc)
    W = len(leaf_sizes)
    ch = -np.ones((n_nodes, branching), np.int32)
    for i, c in enumerate(children):
        ch[i, : len(c)] = c
    # idf weights (DBoW2 TF_IDF default)
    sizes = np.maximum(np.asarray(leaf_sizes, np.float64), 1.0)
    idf = np.log(len(bits) / sizes).astype(np.float32)
    # Padded to the full tree's shape, as the reference package pads: every
    # vocabulary of one (branching, levels) has the same arrays' shapes, so
    # the database keeps its [K, W] shape across a retrain.  Padding is
    # inert: padded nodes are unreachable (children = -1), padded words have
    # weight 0 and no feature maps to them.
    n_full = sum(branching ** i for i in range(levels + 1))
    w_full = branching ** levels
    node_arr = _pack_bits_np(np.stack(node_desc))
    node_pad = np.zeros((n_full, node_arr.shape[1]), node_arr.dtype)
    node_pad[:n_nodes] = node_arr
    ch_pad = -np.ones((n_full, branching), np.int32)
    ch_pad[:n_nodes] = ch
    nw_pad = -np.ones((n_full,), np.int32)
    nw_pad[:n_nodes] = np.asarray(node_word, np.int32)
    idf_pad = np.zeros((w_full,), np.float32)
    idf_pad[:W] = idf
    return node_pad, ch_pad, nw_pad, idf_pad, levels, branching, w_full


def vocabulary_from_numpy(arrays, device="cpu") -> Vocabulary:
    """``train_vocabulary_np``'s tuple as a :class:`Vocabulary` on ``device``."""
    node_desc, children, node_word, word_weight, levels, branching, n_words = arrays
    tensors = (_as_uint32(node_desc).view(np.int32), children, node_word, word_weight)
    return Vocabulary(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in tensors),
                      int(levels), int(branching), int(n_words))


def vocabulary_to(vocab: Vocabulary, device) -> Vocabulary:
    return Vocabulary(*(t.to(device) for t in vocab[:4]), *vocab[4:])


def train_vocabulary(descs, branching: int = 8, levels: int = 3, seed: int = 0,
                     device="cpu") -> Vocabulary:
    return vocabulary_from_numpy(train_vocabulary_np(descs, branching, levels, seed), device)


def load_text_vocabulary(path: str, device="cpu") -> Vocabulary:
    """Load the DBoW2/ORB-SLAM2 text format (parity with loadFromTextFile,
    reference: src/orbvocabulary.cpp:39-118): header ``k L s1 s2`` then one
    node per line: ``parent_id is_leaf d0..d31 weight``.  ORBvoc.txt (k = 10,
    L = 6: 1,111,110 lines, 10^6 words, 146 MB) loads onto the host; the
    engine copies the four arrays (about 88 MB) to its device once."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        rows = [line.split() for line in f if line.strip()]
    n = len(rows) + 1
    node_desc = np.zeros((n, 32), np.uint8)
    children: list[list[int]] = [[] for _ in range(n)]
    node_word = -np.ones(n, np.int32)
    weights = []
    for i, row in enumerate(rows):
        nid = i + 1
        parent = int(row[0])
        is_leaf = int(row[1])
        node_desc[nid] = np.asarray(row[2:34], np.uint16).astype(np.uint8)
        children[parent].append(nid)
        if is_leaf:
            node_word[nid] = len(weights)
            weights.append(float(row[34]))
    ch = -np.ones((n, k), np.int32)
    for i, c in enumerate(children):
        ch[i, : min(len(c), k)] = c[:k]
    return vocabulary_from_numpy(
        (node_desc.view(np.uint32).reshape(n, 8), ch, node_word,
         np.asarray(weights, np.float32), L, k, len(weights)), device)


# ---------------------------------------------------------------------------
# Transform + scoring
# ---------------------------------------------------------------------------


def transform(vocab: Vocabulary, desc, valid):
    """Descend the tree for all features at once; ``desc [..., F, 8]`` and
    ``valid [..., F]`` may carry leading (keyframe) axes.

    Returns ``(word_ids int32, node_l2 int32)``, shaped like ``valid``: the
    word id per feature (-1 invalid) and the node at depth 2 used for
    BoW-gated matching: the reference gates at level L-4 of its 6-deep ORBvoc
    (src/orbvocabulary.cpp:224-230), which is depth 2, so with a file of
    ORBvoc's shape the table sits at the reference's own gating level; the
    trained 4-deep trees gate at the same depth.  Among children at the same
    (integer) distance the first one wins, on every device."""
    k = vocab.children.shape[1]
    n_nodes = vocab.node_desc.shape[0]
    lane = torch.arange(k, device=desc.device)
    cur = torch.zeros(valid.shape, dtype=torch.int64, device=desc.device)
    node_at = [cur]
    for _ in range(vocab.levels):
        ch = vocab.children[cur]                                   # [..., F, k]
        has_child = ch >= 0
        ch_safe = ch.clamp(0, n_nodes - 1).long()
        d = popcount32(desc[..., None, :] ^ vocab.node_desc[ch_safe]).sum(dim=-1)
        d = torch.where(has_child, d, MAX_DIST + 1)
        # first minimum: the lane rides in the low digits of the key
        first = torch.min(d.to(torch.int64) * k + lane, dim=-1).values % k
        nxt = torch.gather(ch_safe, -1, first[..., None])[..., 0]
        # leaves stop descending (keep the current node)
        cur = torch.where(torch.any(has_child, dim=-1), nxt, cur)
        node_at.append(cur)
    word = torch.where(valid, vocab.node_word[cur], -1)
    node_l2 = torch.where(valid, node_at[min(2, vocab.levels)].to(torch.int32), -1)
    return word, node_l2


def transform_all(vocab: Vocabulary, descs, valids, kf_chunk: int = 64):
    """:func:`transform` over a keyframe axis, ``[K, F, 8]`` + ``[K, F]`` ->
    ``(word_ids [K, F], node_l2 [K, F])``, ``kf_chunk`` keyframes at a time
    (the ``[K, F, k, 8]`` child gather of one level is 42 MB at 64 x 2048 x
    10)."""
    parts = [transform(vocab, descs[s:s + kf_chunk], valids[s:s + kf_chunk])
             for s in range(0, descs.shape[0], kf_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def bow_vector(vocab: Vocabulary, word_ids):
    """Dense L1-normalized tf-idf vectors ``[..., W]`` from per-feature word
    ids ``[..., F]``.  The term counts are integers, so their sum is exact in
    any order."""
    ok = word_ids >= 0
    tf = torch.zeros(word_ids.shape[:-1] + (vocab.n_words,), dtype=torch.float32,
                     device=word_ids.device)
    tf = tf.scatter_add(-1, torch.where(ok, word_ids, 0).long(), ok.to(torch.float32))
    v = tf * vocab.word_weight
    s = v.sum(dim=-1, keepdim=True)
    return v / torch.where(s > 0, s, 1.0)


bow_vectors = bow_vector   # the keyframe axis is a leading axis


def bow_score(v1, v2):
    """DBoW2 L1 score: sum of elementwise minima of L1-normalized vectors
    (== 1 - 0.5 * ||v1 - v2||_1)."""
    return torch.sum(torch.minimum(v1, v2), dim=-1)
