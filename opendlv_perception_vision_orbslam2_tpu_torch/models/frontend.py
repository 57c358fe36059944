"""Frame front ends: images in, FrameState out.

Counterpart of the reference package's ``models/frontend.py`` (the OrbFrame
constructors, reference: src/orbframe.cpp:61-88, 90-147): ``process_stereo``
runs one batched pyramid for both eyes, joint extraction, stereo matching
and unprojection; ``process_rgbd`` extracts from one image and reads depth
from the registered depth map; ``process_mono`` only extracts.
"""

from __future__ import annotations

import torch

from ..ops import image as image_ops
from ..ops import lie
from ..ops import stereo as stereo_ops
from ..utils import trace
from ..utils.config import SystemConfig
from .extractor import extract_from_pyramid, extract_from_pyramid_pair
from .frame import Features, FrameState


def _bbox_filter(feats: Features, config: SystemConfig) -> Features:
    """Invalidate keypoints inside the configured BoundingBox (FilterKeyPoints,
    reference: src/orbframe.cpp:403-445; enabled when MaxX > 2)."""
    tr = config.tracking
    if tr.bbox_max_x <= 2:
        return feats
    x, y = feats.xy[:, 0], feats.xy[:, 1]
    inside = (
        (x > tr.bbox_min_x) & (x < tr.bbox_max_x)
        & (y > tr.bbox_min_y) & (y < tr.bbox_max_y)
    )
    return feats._replace(valid=feats.valid & ~inside)


def _undistort_features(feats: Features, config: SystemConfig,
                        shift_uright: bool = False) -> Features:
    """Undistort keypoint coordinates when the camera carries distortion
    (UndistortKeyPoints, reference: src/orbframe.cpp:448-479; gated on
    |k1| >= 1e-4).  With ``shift_uright`` the stereo right coordinate moves
    by the same horizontal correction, preserving the measured disparity."""
    cam = config.camera
    if abs(cam.k1) < 1e-4:
        return feats
    from ..ops.undistort import undistort_points

    xy_u = undistort_points(
        feats.xy, cam.fx, cam.fy, cam.cx, cam.cy,
        cam.k1, cam.k2, cam.p1, cam.p2, cam.k3,
    )
    out = feats._replace(xy=torch.where(feats.valid[:, None], xy_u, feats.xy))
    if shift_uright:
        du = out.xy[:, 0] - feats.xy[:, 0]
        out = out._replace(
            u_right=torch.where(out.u_right > 0, out.u_right + du, out.u_right)
        )
    return out


@trace.traced("frontend.process")
def process_stereo(img_left, img_right, config: SystemConfig, timestamp=0.0):
    """Grayscale stereo pair ``[H, W]`` float32 tensors -> :class:`FrameState`
    on the images' device.  Pose initializes to identity."""
    cam = config.camera
    orb = config.orb
    dev = img_left.device

    both = torch.stack([img_left, img_right]).to(torch.float32)
    levels_lr = image_ops.build_pyramid(both, orb.n_levels, orb.scale_factor)
    feat_l, feat_r = extract_from_pyramid_pair(levels_lr, orb)
    # FilterKeyPoints/UndistortKeyPoints run before ComputeStereoMatches
    # (reference: src/orbframe.cpp:77-78, 149-173); the bbox applies to both eyes
    feat_l = _bbox_filter(feat_l, config)
    feat_r = _bbox_filter(feat_r, config)

    with trace.span("frontend.stereo_match"):
        atlas_l, offsets = stereo_ops.build_atlas([lv[0] for lv in levels_lr])
        atlas_r, _ = stereo_ops.build_atlas([lv[1] for lv in levels_lr])
        u_right, depth = stereo_ops.stereo_match(
            feat_l, feat_r, atlas_l, atlas_r, offsets,
            orb.scale_factor, cam.fx, cam.bf,
        )
    feat_l = feat_l._replace(u_right=u_right, depth=depth)
    feat_l = _undistort_features(feat_l, config, shift_uright=True)

    point_cam = lie.backproject(
        feat_l.xy, torch.clamp(depth, min=1e-6), cam.fx, cam.fy, cam.cx, cam.cy
    )
    point_cam = torch.where(depth[:, None] > 0, point_cam, torch.zeros_like(point_cam))

    return FrameState(
        features=feat_l,
        T_cw=torch.eye(4, dtype=torch.float32, device=dev),
        point_cam=point_cam,
        timestamp=torch.full((), timestamp, dtype=torch.float32, device=dev),
    )


@trace.traced("frontend.process")
def process_rgbd(img, depth_map, config: SystemConfig, timestamp=0.0):
    """Grayscale image + registered depth map ``[H, W]`` tensors ->
    :class:`FrameState` (GrabImageRGBD + ComputeStereoFromRGBD, reference:
    src/tracking.cpp:202-230, src/orbframe.cpp:707-728).  The depth is read
    at the raw (distorted) keypoint pixel, truncated to int and clipped; the
    keypoints are then undistorted and a virtual right coordinate
    ``u_right = x - bf / d`` is set from the undistorted x, after which the
    frame is a stereo frame to the rest of the system."""
    cam = config.camera
    orb = config.orb
    dev = img.device

    levels = image_ops.build_pyramid(img.to(torch.float32), orb.n_levels, orb.scale_factor)
    feats = _bbox_filter(extract_from_pyramid(levels, orb), config)
    raw_xy = feats.xy
    feats = _undistort_features(feats, config)

    # DepthMapFactor (reference: src/tracking.cpp:136-149): metric = raw /
    # factor, a factor near 0 means the map is already metric
    f = float(config.tracking.depth_map_factor)
    scale = 1.0 if abs(f) < 1e-5 else 1.0 / f
    dm = depth_map.to(torch.float32) * scale
    h, w = dm.shape
    u = torch.clamp(raw_xy[:, 0].to(torch.int32), 0, w - 1).long()
    v = torch.clamp(raw_xy[:, 1].to(torch.int32), 0, h - 1).long()
    d = dm[v, u]
    ok = (d > 0) & feats.valid
    minus_one = torch.full_like(d, -1.0)
    depth = torch.where(ok, d, minus_one)
    # a tensor dividend: ``float / tensor`` is a reciprocal and a multiply
    bf = torch.full((), cam.bf, dtype=torch.float32, device=dev)
    u_right = torch.where(ok, feats.xy[:, 0] - bf / torch.clamp(d, min=1e-6), minus_one)
    feats = feats._replace(u_right=u_right, depth=depth)

    point_cam = lie.backproject(
        feats.xy, torch.clamp(depth, min=1e-6), cam.fx, cam.fy, cam.cx, cam.cy
    )
    point_cam = torch.where(depth[:, None] > 0, point_cam, torch.zeros_like(point_cam))
    return FrameState(
        features=feats,
        T_cw=torch.eye(4, dtype=torch.float32, device=dev),
        point_cam=point_cam,
        timestamp=torch.full((), timestamp, dtype=torch.float32, device=dev),
    )


@trace.traced("frontend.process")
def process_mono(img, config: SystemConfig, timestamp=0.0):
    """Grayscale image ``[H, W]`` tensor -> :class:`FrameState`: extraction,
    the bounding-box filter and undistortion, no depth (GrabImageMonocular,
    reference: src/tracking.cpp:233-260)."""
    orb = config.orb
    dev = img.device
    levels = image_ops.build_pyramid(img.to(torch.float32), orb.n_levels, orb.scale_factor)
    feats = _undistort_features(_bbox_filter(extract_from_pyramid(levels, orb), config), config)
    return FrameState(
        features=feats,
        T_cw=torch.eye(4, dtype=torch.float32, device=dev),
        point_cam=torch.zeros((feats.capacity, 3), dtype=torch.float32, device=dev),
        timestamp=torch.full((), timestamp, dtype=torch.float32, device=dev),
    )
