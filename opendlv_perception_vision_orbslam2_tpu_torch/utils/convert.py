"""Carry tracker state between the reference package and the port.

The system has no learned weights: its state is the numpy-built constant
tables (rebuilt identically on both sides), the tracker state
``TrackState(T_cw, velocity, last_frame: FrameState, n_inliers)``, the map
``MapState``, the place-recognition state ``Vocabulary`` /
``KeyFrameDatabase``, the loop slice's solver inputs ``BAProblem``,
``PoseGraphProblem``, ``LoopMatch`` and the GBA carry ``(T, pts, lam,
cost)`` (a plain tuple), and the monocular initializer's ``InitResult`` (a
monocular map is a ``MapState`` like any other).  These two functions move that state across as
numpy arrays, so a test can start the port from the reference's state and
compare step by step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.frame import Features, FrameState
from ..models.initializer import InitResult
from ..models.kfdb import KeyFrameDatabase
from ..models.loop_closing import LoopMatch
from ..models.map_state import MapState
from ..models.tracking import TrackState
from ..models.vocabulary import Vocabulary
from ..optim.ba import BAProblem
from ..optim.pose_graph import PoseGraphProblem

_TYPES = {cls.__name__: cls for cls in (Features, FrameState, TrackState, MapState,
                                        Vocabulary, KeyFrameDatabase, BAProblem,
                                        PoseGraphProblem, LoopMatch, InitResult)}
_DESC_FIELDS = {"Features": ("desc",), "MapState": ("kf_desc", "pt_desc"),
                "Vocabulary": ("node_desc",)}


def from_jax_numpy(tree, device="cpu"):
    """Reference-package ``Features`` / ``FrameState`` / ``TrackState`` /
    ``MapState`` / ``Vocabulary`` / ``KeyFrameDatabase`` / ``BAProblem`` /
    ``PoseGraphProblem`` / ``LoopMatch`` / ``InitResult`` or a plain tuple of arrays (numpy or
    array-like leaves, None passes through) -> the port's NamedTuples of
    tensors on ``device``.  ``uint32``
    leaves (descriptors) become the ``int32`` tensors with the same bits; a
    Python integer (the vocabulary's ``levels``, ``branching``, ``n_words``)
    passes through."""
    if tree is None or isinstance(tree, int):
        return tree
    if hasattr(tree, "_fields"):
        cls = _TYPES[type(tree).__name__]
        return cls(*(from_jax_numpy(getattr(tree, f), device) for f in cls._fields))
    if isinstance(tree, tuple):
        return tuple(from_jax_numpy(x, device) for x in tree)
    a = np.array(tree)  # a writable copy: torch.from_numpy shares its memory
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(tree):
    """Inverse of :func:`from_jax_numpy`: the same NamedTuples with numpy
    leaves; descriptors (``Features.desc``, ``MapState.kf_desc/pt_desc``
    and ``Vocabulary.node_desc``) come back as ``uint32``."""
    if tree is None or isinstance(tree, int):
        return tree
    if hasattr(tree, "_fields"):
        out = {f: to_numpy(getattr(tree, f)) for f in tree._fields}
        for f in _DESC_FIELDS.get(type(tree).__name__, ()):
            out[f] = out[f].view(np.uint32)
        return type(tree)(**out)
    if isinstance(tree, tuple):
        return tuple(to_numpy(x) for x in tree)
    return tree.detach().cpu().numpy()
