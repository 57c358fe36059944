"""Trajectory bookkeeping: KITTI-format dumps + ATE metrics.

Output parity with the reference's end-of-run dumps
(poses.txt KITTI 3x4 rows, reference: src/tracking.cpp:1496-1536 +
src/selflocalization.cpp:95; fps.txt per-frame series,
reference: src/selflocalization.cpp:101-110) plus the ATE RMSE evaluation the
reference delegates to external tools (SURVEY.md section 6).
"""

from __future__ import annotations

import numpy as np


def poses_to_kitti(poses_T_cw) -> str:
    """World->camera poses -> KITTI rows of T_wc (camera-to-world 3x4),
    matching the reference's export convention (inverse pose per row,
    reference: src/tracking.cpp:1516-1529)."""
    lines = []
    for T_cw in poses_T_cw:
        T_wc = np.linalg.inv(np.asarray(T_cw, dtype=np.float64))
        lines.append(" ".join(f"{v:.6e}" for v in T_wc[:3].reshape(-1)))
    return "\n".join(lines) + "\n"


def write_pose_file(path: str, poses_T_cw) -> None:
    with open(path, "w") as f:
        f.write(poses_to_kitti(poses_T_cw))


def write_fps_file(path: str, latencies_s, map_sizes) -> None:
    """Per-frame (fps, map-size) series (reference format:
    src/selflocalization.cpp:101-110)."""
    with open(path, "w") as f:
        for lat, ms in zip(latencies_s, map_sizes):
            fps = 1.0 / lat if lat > 0 else 0.0
            f.write(f"{fps:.3f} {int(ms)}\n")


def trajectory_positions(poses_T_cw) -> np.ndarray:
    """Camera centers in world frame, [N, 3]."""
    out = []
    for T_cw in poses_T_cw:
        T = np.asarray(T_cw, dtype=np.float64)
        R, t = T[:3, :3], T[:3, 3]
        out.append(-R.T @ t)
    return np.stack(out)


def ate_rmse(poses_est, poses_gt, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE in meters.

    With ``align``, applies the standard SE(3) Umeyama alignment (no scale —
    stereo has metric scale) before computing the RMSE, like evo/KITTI devkit
    which the reference defers to (SURVEY.md section 6).  ``with_scale``
    switches to the Sim(3) Umeyama alignment — the monocular convention
    (evo ``-as``): a mono trajectory's global scale is unobservable, so
    accuracy is judged after solving it."""
    p_est = trajectory_positions(poses_est)
    p_gt = trajectory_positions(poses_gt)
    assert p_est.shape == p_gt.shape
    if align and len(p_est) >= 3:
        mu_e, mu_g = p_est.mean(0), p_gt.mean(0)
        E, G = p_est - mu_e, p_gt - mu_g
        U, sv, Vt = np.linalg.svd(E.T @ G)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        s = 1.0
        if with_scale:
            var_e = (E ** 2).sum() / len(E)
            s = float(np.trace(np.diag(sv) @ S) / len(E) / var_e)
        p_est = s * (p_est - mu_e) @ R.T + mu_g
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
