"""Stereo left<->right descriptor matching + SAD sub-pixel refinement.

Counterpart of the reference package's ``ops/stereo.py`` (batched
OrbFrame::ComputeStereoMatches, reference: src/orbframe.cpp:511-705):
candidate gating is a boolean [KL, KR] mask, the best match per row comes
from the Hamming matrix, the 11x11 SAD slide reads all left windows and all
right strips from edge-padded pyramid atlases in one launch of the
window-gather kernel, and the outlier cut is a masked median.

Depth convention matches the reference: ``depth = bf / disparity``; invalid
entries hold -1 (reference: src/orbframe.cpp:668-676).
"""

from __future__ import annotations

import numpy as np
import torch

from .gather_kernel import gather_patches_multi
from .hamming import MAX_DIST, TH_HIGH, TH_LOW, hamming_matrix
from .image import edge_pad

SAD_HALF = 5          # w in the reference (11x11 window)
SLIDE = 5             # L in the reference (+-5 px slide)
TH_ORB = (TH_HIGH + TH_LOW) // 2   # 75 (reference: src/orbframe.cpp:540)
MIN_DISPARITY = 0.05  # reference clamps <=0 to 0.01; we invalidate instead


def build_atlas(levels):
    """Stack pyramid levels ``[H_l, W_l]`` into one ``[sum(H_l), W0]`` image
    (zero-extended on the right) plus per-level row offsets."""
    w0 = levels[0].shape[-1]
    padded = [torch.nn.functional.pad(im, (0, w0 - im.shape[-1])) for im in levels]
    offsets = np.cumsum([0] + [im.shape[-2] for im in levels[:-1]]).astype(np.int32)
    return torch.cat(padded, dim=-2), torch.from_numpy(offsets).to(levels[0].device)


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def stereo_match(feat_left, feat_right, atlas_left, atlas_right, row_offsets,
                 scale_factor: float, fx: float, bf: float):
    """Returns ``(u_right [KL], depth [KL])`` with -1 for unmatched slots."""
    KL = feat_left.xy.shape[0]
    dev = feat_left.xy.device
    uL, vL = feat_left.xy[:, 0], feat_left.xy[:, 1]
    uR, vR = feat_right.xy[:, 0], feat_right.xy[:, 1]
    octL, octR = feat_left.octave, feat_right.octave

    sf = torch.tensor(scale_factor, dtype=torch.float32, device=dev)
    scaleR = torch.pow(sf, octR.to(torch.float32))
    max_d = fx          # maxD = bf / baseline = fx (reference: src/orbframe.cpp:534)
    min_d = 0.0

    # Candidate gating (reference: src/orbframe.cpp:544-575).
    row_ok = torch.abs(vR[None, :] - vL[:, None]) <= 2.0 * scaleR[None, :]
    oct_ok = torch.abs(octR[None, :] - octL[:, None]) <= 1
    u_ok = (uR[None, :] >= (uL[:, None] - max_d)) & (uR[None, :] <= (uL[:, None] - min_d))
    mask = row_ok & oct_ok & u_ok & feat_left.valid[:, None] & feat_right.valid[None, :]

    dist = hamming_matrix(feat_left.desc, feat_right.desc)
    big = MAX_DIST + 1
    d = torch.where(mask, dist, big)
    best_r = torch.argmin(d, dim=1)
    best_d = _take(d, best_r)
    matched = best_d < TH_ORB

    # --- SAD sub-pixel refinement on the matched octave level -------------
    inv_sf = torch.tensor(1.0 / scale_factor, dtype=torch.float32, device=dev)
    inv_scale_l = torch.pow(inv_sf, octL.to(torch.float32))
    su = torch.round(uL * inv_scale_l).to(torch.int32)
    sv = torch.round(vL * inv_scale_l).to(torch.int32)
    sur0 = torch.round(uR[best_r] * inv_scale_l).to(torch.int32)
    row_base = row_offsets[octL.long()]

    win = 2 * SAD_HALF + 1

    # Atlases are edge-padded so starts never clamp-shift for valid
    # keypoints; the few out-of-band starts produce junk SAD that the
    # interior/disparity/median gates already reject.
    yl = sv + row_base
    lp = edge_pad(atlas_left, SAD_HALF, SAD_HALF, SAD_HALF, SAD_HALF)
    strip_w = win + 2 * SLIDE
    rp = edge_pad(atlas_right, SAD_HALF, SAD_HALF, SAD_HALF + SLIDE, SAD_HALF + SLIDE)
    patch_l, strip_r = gather_patches_multi(              # [KL, 11, 11], [KL, 11, 21]
        [(lp, yl, su, win, win), (rp, yl, sur0, win, strip_w)])
    patch_l = patch_l.reshape(KL, win * win)
    center_l = patch_l[:, (win * win) // 2]
    patch_l = patch_l - center_l[:, None]

    patches_r = torch.stack(
        [strip_r[:, :, i : i + win] for i in range(2 * SLIDE + 1)], dim=1
    ).reshape(KL, 2 * SLIDE + 1, win * win)
    centers_r = patches_r[:, :, (win * win) // 2]
    patches_r = patches_r - centers_r[:, :, None]

    sad = torch.sum(torch.abs(patches_r - patch_l[:, None, :]), dim=-1)   # [KL, 11]
    best_inc_idx = torch.argmin(sad, dim=1)
    best_sad = _take(sad, best_inc_idx)
    interior = (best_inc_idx > 0) & (best_inc_idx < 2 * SLIDE)

    # Parabola fit over (dist1, dist2, dist3) (reference: src/orbframe.cpp:641-649).
    d1 = _take(sad, torch.clamp(best_inc_idx - 1, 0, 2 * SLIDE))
    d3 = _take(sad, torch.clamp(best_inc_idx + 1, 0, 2 * SLIDE))
    denom = 2.0 * (d1 + d3 - 2.0 * best_sad)
    delta = torch.where(torch.abs(denom) > 1e-6, (d1 - d3) / denom,
                        torch.full_like(denom, 2.0))
    delta_ok = torch.abs(delta) <= 1.0
    delta = torch.where(delta_ok, delta, torch.zeros_like(delta))

    scale_l = torch.pow(sf, octL.to(torch.float32))
    # The SAD slide aligns the right strip to the left window centred at the
    # integer level pixel su: carry the left keypoint's sub-pixel offset
    # (uL - su*scale) onto u_right so the disparity stays the SAD-aligned one.
    frac_u = uL - su.to(torch.float32) * scale_l
    best_ur = frac_u + scale_l * (
        sur0.to(torch.float32) + (best_inc_idx - SLIDE).to(torch.float32) + delta
    )
    disparity = uL - best_ur
    disp_ok = (disparity >= MIN_DISPARITY) & (disparity < max_d)
    good = matched & interior & delta_ok & disp_ok

    # Median SAD outlier cut (reference: src/orbframe.cpp:684-704, with the
    # empty-median guard).
    n_good = torch.sum(good)
    sad_sorted = torch.sort(torch.where(good, best_sad, torch.full_like(best_sad, float("inf")))).values
    median_idx = torch.clamp(n_good // 2, 0, KL - 1)
    median = sad_sorted.gather(0, median_idx[None])[0]   # no host sync
    th_dist = 1.5 * 1.4 * torch.where(torch.isfinite(median), median, torch.zeros_like(median))
    good = good & (best_sad < th_dist) & (n_good > 0)

    u_right = torch.where(good, best_ur, torch.full_like(best_ur, -1.0))
    depth = torch.where(good, bf / torch.clamp(disparity, min=MIN_DISPARITY),
                        torch.full_like(disparity, -1.0))
    return u_right, depth
