"""Map checkpoint save/resume.

The reference has write-only dumps and cannot reload a map (SURVEY.md
section 5: "No map serialization/reload").  The map is one NamedTuple of
tensors, so save/resume is a flat npz of its fields, the same file as the
reference package's: a map either package saves loads in the other.
Descriptors are stored as ``uint32`` and come back as the port's ``int32``
tensors with the same bits.
"""

from __future__ import annotations

import numpy as np

from ..models.map_state import LOOP_EDGE_CAP, MapState
from ..utils.convert import from_jax_numpy, to_numpy


def save_map(path: str, m: MapState) -> None:
    np.savez_compressed(path, **to_numpy(m)._asdict())


def load_map(path: str, device="cuda") -> MapState:
    """The map saved at ``path``, on ``device``."""
    data = np.load(path)
    m = MapState(**{name: data[name] for name in MapState._fields if name in data})
    if m.loop_valid is None:   # checkpoint predates persistent loop edges
        m = m._replace(
            loop_i=np.zeros((LOOP_EDGE_CAP,), np.int32),
            loop_j=np.zeros((LOOP_EDGE_CAP,), np.int32),
            loop_T=np.tile(np.eye(4, dtype=np.float32), (LOOP_EDGE_CAP, 1, 1)),
            loop_s=np.ones((LOOP_EDGE_CAP,), np.float32),
            loop_valid=np.zeros((LOOP_EDGE_CAP,), bool),
        )
    return from_jax_numpy(m, device)
