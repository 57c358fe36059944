"""Keyframe database: place-recognition index over dense BoW rows.

Counterpart of the reference package's ``models/kfdb.py``, which re-designs
OrbKeyFrameDatabase's inverted file (reference:
src/orbkeyframedatabase.cpp:27-31: word id -> keyframe list) as a dense
``[K, W]`` BoW matrix: common-word counting is a 0/1 matrix product and L1
scoring a broadcast min-sum, so the candidate scan the reference does with
per-word list walks (DetectLoopCandidates / DetectRelocalizationCandidates,
src/orbkeyframedatabase.cpp:70-314) is a handful of dense ops.  Updates are
out of place, like the map's (``ops/indexing.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.indexing import set_row, topk_stable


class KeyFrameDatabase(NamedTuple):
    bow: torch.Tensor        # [K, W] float32 L1-normalized tf-idf rows
    has_row: torch.Tensor    # [K] bool

    @property
    def capacity(self):
        return self.bow.shape[0]


def empty_kfdb(kf_capacity: int, n_words: int, device="cpu") -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=torch.zeros((kf_capacity, n_words), dtype=torch.float32, device=device),
        has_row=torch.zeros((kf_capacity,), dtype=torch.bool, device=device),
    )


def add_keyframe(db: KeyFrameDatabase, kf_slot, bow_row) -> KeyFrameDatabase:
    """``kf_slot``: a host integer or a 0-d integer tensor."""
    return KeyFrameDatabase(bow=set_row(db.bow, kf_slot, bow_row),
                            has_row=set_row(db.has_row, kf_slot, True))


def erase_keyframe(db: KeyFrameDatabase, kf_slot) -> KeyFrameDatabase:
    return KeyFrameDatabase(bow=set_row(db.bow, kf_slot, 0.0),
                            has_row=set_row(db.has_row, kf_slot, False))


def query_scores(db: KeyFrameDatabase, query_bow):
    """L1 similarity of the query against every stored keyframe: ``[K]``."""
    s = torch.sum(torch.minimum(db.bow, query_bow[None, :]), dim=1)
    return torch.where(db.has_row, s, -1.0)


def common_word_counts(db: KeyFrameDatabase, query_bow):
    """Number of shared words per keyframe, the inverted file's sharing count
    (reference: src/orbkeyframedatabase.cpp:82-106), as one product of the
    0/1 masks: the sums are integers <= W, exact in float32."""
    qb = (query_bow > 0).to(torch.float32)
    kb = (db.bow > 0).to(torch.float32)
    return torch.where(db.has_row, (kb @ qb).to(torch.int32), 0)


def detect_candidates(db: KeyFrameDatabase, query_bow, exclude_mask, min_score, covis,
                      n_candidates: int = 8):
    """Loop/relocalization candidates ``(slots [n] (-1 none), scores [n])``.

    The reference's gating chain (src/orbkeyframedatabase.cpp:70-198):
    shared-word count > 0.8 * max, score >= min_score, then each candidate's
    score accumulated over its top-10 covisible group, groups kept above
    0.75 * the best accumulated score; the returned slots are each group's
    best member.  ``exclude_mask`` removes the query's own covisible
    keyframes (loop detection) or nothing (relocalization, min_score = 0).
    Both rankings are stable: among ties the lower slot comes first."""
    counts = common_word_counts(db, query_bow)
    counts = torch.where(exclude_mask, 0, counts)
    min_common = torch.clamp(0.8 * counts.max().to(torch.float32), min=1.0)

    scores = query_scores(db, query_bow)
    ok = ((counts.to(torch.float32) >= min_common) & (scores >= min_score)
          & ~exclude_mask & db.has_row)
    base = torch.where(ok, scores, 0.0)

    # covisibility-group accumulation: top-10 neighbours by covis weight
    top_w, top_idx = topk_stable(covis, 10)                       # [K, 10]
    nb_scores = torch.where(top_w > 0, base[top_idx], 0.0)
    acc = torch.where(ok, base + nb_scores.sum(dim=1), -1.0)

    acc = torch.where(acc >= 0.75 * acc.max(), acc, -1.0)
    cand_scores, cand = topk_stable(acc, n_candidates)
    return torch.where(cand_scores > 0, cand, -1), cand_scores
