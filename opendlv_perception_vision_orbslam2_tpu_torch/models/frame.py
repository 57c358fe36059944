"""Fixed-capacity frame containers (the tensor analogue of OrbFrame).

Counterpart of the reference package's ``models/frame.py`` (reference:
include/orbframe.hpp:60-238): every frame is a NamedTuple of fixed-shape
tensors with a validity mask.

Descriptors are ``int32 [K, 8]`` holding the same bits as the reference's
``uint32 [K, 8]`` (torch's uint32 support is thin); ``utils/convert.py``
reinterprets at the boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Features(NamedTuple):
    """Per-frame ORB features, padded to a static keypoint capacity K
    (OrbFrame's parallel vectors, reference: include/orbframe.hpp:150-171).
    ``u_right``/``depth`` are -1 where unavailable."""

    xy: torch.Tensor        # [K, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # [K] float32 FAST score
    octave: torch.Tensor    # [K] int32 pyramid level
    angle: torch.Tensor     # [K] float32 radians
    desc: torch.Tensor      # [K, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [K] bool
    u_right: torch.Tensor   # [K] float32, right-image x (stereo) or -1
    depth: torch.Tensor     # [K] float32, metric depth or -1

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class FrameState(NamedTuple):
    """A tracked frame: features + camera pose + the camera-frame 3D of its
    stereo features (z <= 0 where invalid; UnprojectStereo, reference:
    src/orbframe.cpp:730-744)."""

    features: Features
    T_cw: torch.Tensor       # [4, 4] world->camera
    point_cam: torch.Tensor  # [K, 3]
    timestamp: torch.Tensor  # [] float32 seconds


def features_scale_sigma2(features: Features, scale_factor: float):
    """Per-feature sigma^2 = scale^(2*octave) (reference keeps per-level
    tables, include/orbframe.hpp:176-181)."""
    base = torch.tensor(scale_factor, dtype=torch.float32,
                        device=features.octave.device)
    return torch.pow(base, 2.0 * features.octave.to(torch.float32))
