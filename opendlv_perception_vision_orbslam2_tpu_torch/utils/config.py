"""Typed configuration mirroring the reference's full flag inventory.

The reference threads an untyped ``std::map<string,string>`` of ``--key=value``
flags through every constructor (cluon::getCommandlineArguments; flag uses at
reference: src/opendlv-perception-vision-orbslam2.cpp:36-68,
src/selflocalization.cpp:333-482, src/tracking.cpp:45-150).  Here the same
keys become frozen dataclasses plus a ``from_flags`` parser accepting the
identical ``--key=value`` CLI surface, so reference launch commands (e.g. the
docker-compose service line, reference: docker-compose.yml:43) port verbatim.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Sequence


@dataclass(frozen=True)
class CameraConfig:
    """Intrinsics/extrinsics flags ``--Camera.*`` (reference: src/tracking.cpp:46-95,
    src/selflocalization.cpp:441-482)."""

    fx: float = 718.856          # KITTI 00 defaults (reference: docker-compose.yml:43)
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    fps: float = 15.0
    bf: float = 386.1448         # baseline * fx  (stereo)
    rgb: bool = True
    baseline: float = 0.0
    # relative rotation (rodrigues vector) of the right camera w.r.t. the
    # left, for live stereo rectification (``--Camera.rx/cv/rz``,
    # reference: src/selflocalization.cpp:477-487)
    rx: float = 0.0
    cv_rot: float = 0.0
    rz: float = 0.0
    width: int = 1241
    height: int = 376

    @property
    def baseline_m(self) -> float:
        return self.bf / self.fx if self.fx else 0.0


@dataclass(frozen=True)
class OrbConfig:
    """``--ORBextractor.*`` flags (reference: src/tracking.cpp:104-108)."""

    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # TPU-side static capacity: per-frame keypoint slots (padded; masked).
    max_keypoints: int = 2048
    # Grid for O(1) area queries (reference: include/orbframe.hpp:51-52).
    grid_rows: int = 48
    grid_cols: int = 64
    # Detection cell size in pixels (reference: src/orbextractor.cpp:908 W=30).
    cell_size: int = 30

    @property
    def scale_factors(self):
        return [self.scale_factor ** i for i in range(self.n_levels)]

    @property
    def level_sigma2(self):
        return [s * s for s in self.scale_factors]


@dataclass(frozen=True)
class TrackingConfig:
    """Depth/keyframe/bounding-box flags (reference: src/tracking.cpp:111-149,
    src/selflocalization.cpp:380-415)."""

    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    bbox_min_x: float = -1.0  # negative => disabled (reference semantics)
    bbox_max_x: float = -1.0
    bbox_min_y: float = -1.0
    bbox_max_y: float = -1.0
    # Keyframe windows derived from fps (reference: src/tracking.cpp:74-80).
    min_frames: int = 0
    max_frames: int = 15


@dataclass(frozen=True)
class SystemConfig:
    """Top-level system flags (reference: src/opendlv-perception-vision-orbslam2.cpp:36-68,
    src/selflocalization.cpp:333-415)."""

    cid: int = 111
    name: str = "img.argb"
    width: int = 1241
    height: int = 376
    bpp: int = 24
    id: int = 0
    verbose: bool = False
    kitti_path: str = ""
    camera_type: str = "stereo"   # "stereo" | "mono" | "rgbd"
    voc_file_path: str = ""
    rectify: bool = False
    # image scale factor applied at ingest (reference --resize is a float
    # scale < 1, src/selflocalization.cpp:279-294, 415)
    resize: float = 1.0
    ref_latitude: float = 0.0
    ref_longitude: float = 0.0
    start_heading: float = 0.0
    camera: CameraConfig = field(default_factory=CameraConfig)
    camera_right: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    # TPU static map capacities (no reference analogue: the reference map grows
    # unboundedly on the heap; here slots are fixed and recycled).
    max_keyframes: int = 512
    max_map_points: int = 65536
    # Capacity-bucket ladder: the map starts at the initial bucket and the
    # host scheduler grows it (grow_map) as occupancy rises — every
    # [P]-scatter / [K,P] incidence / [K,K] Gram in the per-frame programs
    # scales with the live bucket, the TPU answer to the reference's
    # grow-per-allocation heap map.  Growth multiplies by 4 until max_*.
    initial_keyframes: int = 64
    initial_map_points: int = 8192


_CAMERA_KEYS = {
    "fx": "fx", "fy": "fy", "cx": "cx", "cy": "cy",
    "k1": "k1", "k2": "k2", "k3": "k3", "p1": "p1", "p2": "p2",
    "fps": "fps", "bf": "bf", "RGB": "rgb", "baseline": "baseline",
    "rx": "rx", "cv": "cv_rot", "rz": "rz",
}


def _parse_scalar(text: str, target_type):
    if target_type is bool:
        return text.strip() not in ("0", "false", "False", "")
    return target_type(text)


def parse_flags(argv: Sequence[str]) -> dict:
    """``--key=value`` list -> dict (cluon::getCommandlineArguments parity,
    reference: include/cluon-complete-v0.0.77.hpp:4673)."""
    out = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        body = arg[2:]
        if "=" in body:
            k, v = body.split("=", 1)
        else:
            k, v = body, "1"
        out[k] = v
    return out


def _camera_from_flags(flags: Mapping[str, str], prefix: str, base: CameraConfig) -> CameraConfig:
    updates = {}
    for flag_key, field_name in _CAMERA_KEYS.items():
        full = f"{prefix}.{flag_key}"
        if full in flags:
            ftype = type(getattr(base, field_name))
            updates[field_name] = _parse_scalar(flags[full], ftype)
    if "width" in flags:
        updates["width"] = int(flags["width"])
    if "height" in flags:
        updates["height"] = int(flags["height"])
    return dataclasses.replace(base, **updates)


def config_from_flags(argv_or_flags) -> SystemConfig:
    """Build a SystemConfig from argv list or pre-parsed flag dict."""
    flags = (
        dict(argv_or_flags)
        if isinstance(argv_or_flags, Mapping)
        else parse_flags(argv_or_flags)
    )
    base = SystemConfig()
    cam = _camera_from_flags(flags, "Camera", base.camera)
    cam_r = _camera_from_flags(flags, "CameraR", cam)

    orb_updates = {}
    for k, name, t in (
        ("ORBextractor.nFeatures", "n_features", int),
        ("ORBextractor.scaleFactor", "scale_factor", float),
        ("ORBextractor.nLevels", "n_levels", int),
        ("ORBextractor.iniThFAST", "ini_th_fast", int),
        ("ORBextractor.minThFAST", "min_th_fast", int),
    ):
        if k in flags:
            orb_updates[name] = t(flags[k])
    orb = dataclasses.replace(base.orb, **orb_updates)

    tr_updates = {}
    for k, name, t in (
        ("ThDepth", "th_depth", float),
        ("DepthMapFactor", "depth_map_factor", float),
        ("BoundingBox.MinX", "bbox_min_x", float),
        ("BoundingBox.MaxX", "bbox_max_x", float),
        ("BoundingBox.MinY", "bbox_min_y", float),
        ("BoundingBox.MaxY", "bbox_max_y", float),
    ):
        if k in flags:
            tr_updates[name] = t(flags[k])
    # m_maxFrames = fps (reference: src/tracking.cpp:74-80).
    tr_updates.setdefault("max_frames", int(cam.fps) if cam.fps > 0 else 30)
    tracking = dataclasses.replace(base.tracking, **tr_updates)

    sys_updates = {"camera": cam, "camera_right": cam_r, "orb": orb, "tracking": tracking}
    for k, name, t in (
        ("cid", "cid", int),
        ("name", "name", str),
        ("width", "width", int),
        ("height", "height", int),
        ("bpp", "bpp", int),
        ("id", "id", int),
        ("verbose", "verbose", bool),
        ("kittiPath", "kitti_path", str),
        ("cameraType", "camera_type", str),
        ("vocFilePath", "voc_file_path", str),
        ("rectify", "rectify", bool),
        ("resize", "resize", float),
        ("refLatitude", "ref_latitude", float),
        ("refLongitude", "ref_longitude", float),
        ("startHeading", "start_heading", float),
    ):
        if k in flags:
            sys_updates[name] = _parse_scalar(flags[k], t)
    return dataclasses.replace(base, **sys_updates)
