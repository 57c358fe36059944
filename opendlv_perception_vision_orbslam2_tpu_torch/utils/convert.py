"""Carry tracker state between the reference package and the port.

The system has no learned weights: its state is the numpy-built constant
tables (rebuilt identically on both sides) and the tracker state
``TrackState(T_cw, velocity, last_frame: FrameState, n_inliers)``.  These two
functions move that state across as numpy arrays, so a test can start the
port from the reference tracker's state and compare frame by frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.frame import Features, FrameState
from ..models.tracking import TrackState

_TYPES = {cls.__name__: cls for cls in (Features, FrameState, TrackState)}


def from_jax_numpy(tree, device="cpu"):
    """Reference-package ``Features`` / ``FrameState`` / ``TrackState``
    (numpy or array-like leaves) -> the port's NamedTuples of
    tensors on ``device``.  ``uint32`` leaves (descriptors) become the
    ``int32`` tensors with the same bits."""
    if hasattr(tree, "_fields"):
        cls = _TYPES[type(tree).__name__]
        return cls(*(from_jax_numpy(getattr(tree, f), device) for f in cls._fields))
    a = np.array(tree)  # a writable copy: torch.from_numpy shares its memory
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def to_numpy(tree):
    """Inverse of :func:`from_jax_numpy`: the same NamedTuples with numpy
    leaves; ``Features.desc`` comes back as ``uint32``."""
    if hasattr(tree, "_fields"):
        out = {f: to_numpy(getattr(tree, f)) for f in tree._fields}
        if isinstance(tree, Features):
            out["desc"] = out["desc"].view(np.uint32)
        return type(tree)(**out)
    return tree.detach().cpu().numpy()
