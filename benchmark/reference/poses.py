"""The plain reference that decides ``correct``: what each published pose
should say, from the generator's ground truth.

It imports numpy only, and nothing of the program.  It reads the program's
outputs only to judge them: each frame's Geolocation as the benchmark's OD4
sink received it, and the pose of the newest keyframe of the program's map
as each frame's pose was published.

The numbers:

- ``pose_rel_m``: the largest distance, over every frame handed in the
  window, between the camera centre its Geolocation carries and the true
  one, both taken in the camera frame of the newest keyframe of the map as
  that frame's pose was published (the program's keyframe pose then,
  against the true pose of the frame the keyframe was made from).  Measured
  against the map of the moment and not against the first frame, so the
  drift that grows with the number of frames tracked, and so with the
  program's speed, drops out, and so does a later refinement of the map;
  what stays is the tracking error of one frame against its map, and
  whether the pose is that frame's at all.
- ``pose_rel_deg``: the largest heading error the same way: the heading
  each Geolocation carries, relative to that keyframe's, against the truth.
- ``pose_rel_m_p90``, ``pose_rel_deg_p90``: the 90th percentiles of the
  same errors over the window's frames.
- ``pose_scale_err``: ``|s - 1|`` for the least-squares scale ``s`` that
  takes the true centres relative to their keyframes to the published
  ones: the metric scale that the depth maps or the baseline state.
- ``kf_rel_m``, ``kf_rel_deg``, ``kf_scale_err``: the same of each
  keyframe of the map at the window's end against the keyframe before it
  (by id): the centre of the older in the camera frame of the newer, and
  the rotation between them (its whole angle), against the truth of their
  frames.  This holds the map itself, which the frames' numbers measure
  against, so that a keyframe moved with the frames tracked from it shows.

A configuration's ``limits`` name the numbers that decide ``correct``.

The controls put this reference in the program's place with one stated
guarantee broken:

- ``stale``: frame ``i`` publishes the true pose of frame ``i - 1``, which a
  change that sends the newest pose at hand, to cut the latency to a
  published pose, would send: each Geolocation is no longer its own
  frame's pose;
- ``scale``: every pose is true in rotation, with its centre 1.1 times the
  true one, as the depth maps read 1.1 times too deep give: the metric
  scale is broken.
"""

from __future__ import annotations

import math

import numpy as np

# WGS84, and the local flat-earth approximation around a reference point
# that the reference deployment's WGS84toCartesian.hpp uses
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = 2.0 * _F - _F * _F


def _radii(lat_rad: float):
    """Meridional and prime-vertical radii of curvature at a latitude."""
    s = math.sin(lat_rad)
    w = math.sqrt(1.0 - _E2 * s * s)
    return _A * (1.0 - _E2) / w ** 3, _A / w


def geolocation_to_centre(lat, lon, alt, heading, ref_lat, ref_lon, start_heading):
    """``(centre [3], yaw)`` in the SLAM world (x right, y down, z forward)
    of a Geolocation: east/north metres from the reference point, rotated
    back by the start heading; altitude is -y; yaw is heading - start."""
    m, n = _radii(math.radians(ref_lat))
    north = math.radians(lat - ref_lat) * m
    east = math.radians(lon - ref_lon) * n * math.cos(math.radians(ref_lat))
    h = start_heading
    # east = z sin h + x cos h, north = z cos h - x sin h
    x = east * math.cos(h) - north * math.sin(h)
    z = east * math.sin(h) + north * math.cos(h)
    return np.array([x, -alt, z]), heading - h


def yaw_of(T_cw) -> float:
    """The heading angle the service publishes for a pose ``T_cw``."""
    R = np.asarray(T_cw)[:3, :3]
    return math.atan2(R[0, 2], R[2, 2])


def centre_of(T_cw) -> np.ndarray:
    T = np.asarray(T_cw, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def _wrap_deg(a: float) -> float:
    return abs((math.degrees(a) + 180.0) % 360.0 - 180.0)


def _angle_deg(R) -> float:
    """The whole angle of a rotation matrix, in degrees."""
    return math.degrees(math.acos(max(-1.0, min(1.0, (np.trace(R) - 1.0) / 2.0))))


def _scale_err(est, true) -> float:
    """``|s - 1|`` for the least-squares ``s`` with ``s * true ~ est``."""
    est, true = np.asarray(est, np.float64), np.asarray(true, np.float64)
    den = float(np.sum(true * true))
    return abs(float(np.sum(est * true)) / den - 1.0) if den > 0.0 else math.inf


def _in_camera(T_cw, c) -> np.ndarray:
    T = np.asarray(T_cw, np.float64)
    return T[:3, :3] @ c + T[:3, 3]


def pose_numbers(published, anchors: dict, truth) -> dict:
    """``{"pose_rel_m", "pose_rel_deg", "pose_scale_err", ...}``.

    ``published``: ``[(frame, centre [3], yaw)]`` of the frames to judge;
    ``anchors[frame]``: ``(keyframe's frame, its T_cw)``, the newest keyframe
    of the program's map as that frame's pose was published; ``truth(i)``:
    the true ``T_cw`` of frame ``i``.  A frame without an anchor reads
    infinity."""
    err_m, err_deg, rel_e, rel_t = [], [], [], []
    for frame, c_est, yaw_est in published:
        if frame not in anchors:
            err_m.append(math.inf)
            err_deg.append(math.inf)
            continue
        kf_frame, T_kf = anchors[frame]
        T_kf_true, T_true = truth(kf_frame), truth(frame)
        rel_est = _in_camera(T_kf, c_est)
        rel_true = _in_camera(T_kf_true, centre_of(T_true))
        rel_e.append(rel_est)
        rel_t.append(rel_true)
        err_m.append(float(np.linalg.norm(rel_est - rel_true)))
        d_yaw = (yaw_est - yaw_of(T_kf)) - (yaw_of(T_true) - yaw_of(T_kf_true))
        err_deg.append(_wrap_deg(d_yaw))
    out = {"frames": len(published),
           "keyframes": len({anchors[f][0] for f, _, _ in published if f in anchors})}
    worst = np.argsort(err_m)[::-1][:3]
    out["worst"] = [(published[k][0], err_m[k], err_deg[k]) for k in worst]
    for name, e in (("pose_rel_m", err_m), ("pose_rel_deg", err_deg)):
        out[name] = max(e, default=math.inf)
        # the 90th percentile, by numpy's linear rule
        out[name + "_p90"] = float(np.percentile(e, 90)) if e else math.inf
    out["pose_scale_err"] = _scale_err(rel_e, rel_t) if rel_e else math.inf
    return out


def keyframe_numbers(keyframes, truth) -> dict:
    """``{"kf_rel_m", "kf_rel_deg", "kf_scale_err", "kf_pairs"}``.

    ``keyframes``: ``[(frame, T_cw)]`` of the map's keyframes at the window's
    end in the order of their ids, each with the frame it was made from."""
    err_m, err_deg, rel_e, rel_t = [], [], [], []
    for (fa, Ta), (fb, Tb) in zip(keyframes, keyframes[1:]):
        Ta_t, Tb_t = truth(fa), truth(fb)
        e = _in_camera(Tb, centre_of(Ta))
        t = _in_camera(Tb_t, centre_of(Ta_t))
        rel_e.append(e)
        rel_t.append(t)
        err_m.append(float(np.linalg.norm(e - t)))
        R_est = np.asarray(Tb, np.float64)[:3, :3] @ np.asarray(Ta, np.float64)[:3, :3].T
        R_true = Tb_t[:3, :3] @ Ta_t[:3, :3].T
        err_deg.append(_angle_deg(R_est @ R_true.T))
    return {"kf_rel_m": max(err_m, default=math.inf),
            "kf_rel_deg": max(err_deg, default=math.inf),
            "kf_scale_err": _scale_err(rel_e, rel_t) if rel_e else math.inf,
            "kf_pairs": len(err_m)}


def control_poses(name: str, frames, anchors: dict, keyframes, truth):
    """``(published, anchors, keyframes)`` of the control ``name``
    (``stale``, ``scale``, or another that keeps the poses true), on the
    frames and keyframes of the program's run."""
    def scaled(T, s):
        T = np.array(T, np.float64)
        T[:3, 3] *= s       # the centre -R^T t scales with t
        return T

    s = 1.1 if name == "scale" else 1.0
    lag = 1 if name == "stale" else 0
    published = [(i, s * centre_of(truth(i - lag)), yaw_of(truth(i - lag))) for i in frames]
    true_anchors = {f: (k, scaled(truth(k), s)) for f, (k, _) in anchors.items()}
    true_kfs = [(k, scaled(truth(k), s)) for k, _ in keyframes]
    return published, true_anchors, true_kfs


def stale_control(frames, anchors: dict, truth) -> dict:
    """:func:`pose_numbers` of the stale control."""
    published, true_anchors, _ = control_poses("stale", frames, anchors, [], truth)
    return pose_numbers(published, true_anchors, truth)


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: each number that has a limit, beside it, and
    whether every one is within it (a missing or non-finite number fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
