"""ORB feature extraction for one image or a stereo pair (pyramid -> FAST ->
select -> describe).

Counterpart of the reference package's ``models/extractor.py``
(OrbExtractor::ExtractFeatures, reference: src/orbextractor.cpp:582-642):

- every pyramid level of the image (or of both eyes) goes through ONE
  launch of the fused FAST+NMS kernel (``ops/fast_kernel.py::fast_nms_pyramid``);
- DistributeOctTree becomes a per-cell top-k + breadth-first global
  selection (every cell's best corner before any cell's second best);
- the ini/min FAST threshold fallback is kept: strong corners outrank weak
  ones inside each cell;
- every keypoint of all levels (of both eyes) gets its 45x45 patch from one
  edge-padded atlas in one launch of the window-gather kernel, then
  orientation and steered BRIEF run over all patches at once.

Ties are broken as the reference package breaks them: ``lax.top_k`` puts the
lower index first, so selection uses a stable descending sort; the iterated
per-cell argmax takes the first occurrence, as ``torch.argmax`` does.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fast as fast_ops
from ..ops import orb as orb_ops
from ..ops.fast_kernel import fast_nms_pyramid
from ..ops.gather_kernel import gather_patches
from ..utils.config import OrbConfig
from .frame import Features

EDGE_BORDER = 16  # detection border, reference EDGE_THRESHOLD-3 (src/orbextractor.cpp:916)
CANDIDATES_PER_CELL = 4


def per_level_budgets(n_features: int, scale_factor: float, n_levels: int) -> list[int]:
    """Geometric per-level feature budgets (reference ctor,
    src/orbextractor.cpp:497-510: last level absorbs the remainder)."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1.0 - factor) / (1.0 - factor ** n_levels)
    budgets = []
    acc = 0
    for _ in range(n_levels - 1):
        b = int(round(n_desired))
        budgets.append(b)
        acc += b
        n_desired *= factor
    budgets.append(max(n_features - acc, 0))
    return budgets


def _select_level_keypoints(scores, strong, budget: int, cell: int):
    """Spatially-uniform top-``budget`` selection from dense score maps
    ``[B, H, W]``.  Returns (xy [B, budget, 2] float32 level coords,
    response [B, budget], valid [B, budget])."""
    B, H, W = scores.shape
    ncy = math.ceil(H / cell)
    ncx = math.ceil(W / cell)
    pad_y, pad_x = ncy * cell - H, ncx * cell - W
    s = F.pad(scores, (0, pad_x, 0, pad_y))
    st = F.pad(strong.to(torch.float32), (0, pad_x, 0, pad_y))

    def cells_of(x):  # [B, ncy*ncx, cell*cell] per-cell flattening
        return (x.reshape(B, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4)
                .reshape(B, ncy * ncx, cell * cell))

    cells = cells_of(s)
    # Strong corners dominate within the cell (threshold-fallback semantics).
    in_cell_key = torch.where(cells > 0, cells + 1e6 * cells_of(st),
                              torch.full_like(cells, -1.0))
    k = min(CANDIDATES_PER_CELL, cell * cell)
    cur = in_cell_key
    tv, ti = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        tv.append(torch.gather(cur, -1, i)[..., 0])
        ti.append(i[..., 0])
        cur = cur.scatter(-1, i, -1.0)
    top_vals = torch.stack(tv, dim=-1)                      # [B, C, k]
    top_idx = torch.stack(ti, dim=-1)

    # Global breadth-first key: slot rank beats response.
    zero = torch.zeros_like(top_vals)
    resp = torch.where(top_vals > 0, torch.clamp(top_vals, max=1e6 - 1.0), zero)
    resp = torch.where(resp >= 1e6 - 1.0, top_vals - 1e6, resp)  # strip strong bonus
    slot = torch.arange(k, device=scores.device).expand(top_vals.shape)
    global_key = torch.where(
        top_vals > 0, (k - 1 - slot).to(torch.float32) * 1e4 + resp,
        torch.full_like(top_vals, -1.0),
    )

    flat_key = global_key.reshape(B, -1)
    flat_resp = resp.reshape(B, -1)
    flat_idx = top_idx.reshape(B, -1)
    cell_id = torch.arange(flat_key.shape[1], device=scores.device) // k
    cell_id = cell_id.expand(B, -1)
    if flat_key.shape[1] < budget:  # tiny images: pad the candidate pool
        deficit = budget - flat_key.shape[1]
        flat_key = F.pad(flat_key, (0, deficit), value=-1.0)
        flat_resp = F.pad(flat_resp, (0, deficit))
        flat_idx = F.pad(flat_idx, (0, deficit))
        cell_id = F.pad(cell_id, (0, deficit))
    # lax.top_k order: descending, lower index first among equal keys.
    sel_key, sel = torch.sort(flat_key, dim=-1, descending=True, stable=True)
    sel_key, sel = sel_key[:, :budget], sel[:, :budget]

    sel_cell = torch.gather(cell_id, 1, sel)
    sel_local = torch.gather(flat_idx, 1, sel)
    y = ((sel_cell // ncx) * cell + sel_local // cell).to(torch.float32)
    x = ((sel_cell % ncx) * cell + sel_local % cell).to(torch.float32)
    response = torch.gather(flat_resp, 1, sel)
    valid = sel_key > 0
    return torch.stack([x, y], dim=-1), response, valid


def _select_pyramid_keypoints(levels: Sequence, config: OrbConfig):
    """FAST + NMS + selection over all levels ``[B, H_l, W_l]``: one kernel
    launch computes every level's map for all B images, then selection runs
    level by level.  ``strong`` comes from the post-NMS map: it is only read
    at NMS survivors, where the two maps agree.

    Returns per-level-concatenated ``(xy [B, N, 2], response, octave, valid,
    y0, x0)`` with ``(y0, x0)`` the border-clipped level-local patch centres.
    """
    budgets = per_level_budgets(config.n_features, config.scale_factor, config.n_levels)
    maps = fast_nms_pyramid(levels, float(config.min_th_fast))
    xs, resps, octs, valids, y0s, x0s = [], [], [], [], [], []
    for lvl, (nmsed, budget) in enumerate(zip(maps, budgets)):
        B, H, W = nmsed.shape
        strong = nmsed > float(config.ini_th_fast)
        scores = fast_ops.mask_border(nmsed, EDGE_BORDER)
        xy, response, valid = _select_level_keypoints(scores, strong, budget,
                                                      config.cell_size)
        y0s.append(torch.clamp(torch.round(xy[..., 1]).to(torch.int32), 0, H - 1))
        x0s.append(torch.clamp(torch.round(xy[..., 0]).to(torch.int32), 0, W - 1))
        xs.append(xy)
        resps.append(response)
        octs.append(torch.full((B, budget), lvl, dtype=torch.int32, device=xy.device))
        valids.append(valid)
    cat = lambda parts: torch.cat(parts, dim=1)  # noqa: E731
    return cat(xs), cat(resps), cat(octs), cat(valids), cat(y0s), cat(x0s)


def patch_atlas_starts(levels: Sequence, y0, x0, config: OrbConfig):
    """The edge-padded atlas of both eyes ``[B*rows, W0+2h]`` and the patch
    starts ``ys, xs [B*N]`` (eye-major) of every keypoint in it.

    ``levels``: list of ``[B, H_l, W_l]``; ``y0/x0 [B, N]`` level-local
    centres.  A centre c maps to top-left c - half + half = c in the
    half-padded level."""
    B = levels[0].shape[0]
    budgets = per_level_budgets(config.n_features, config.scale_factor,
                                config.n_levels)
    atlas, offsets = orb_ops.build_patch_atlas(levels)       # [B, rows, W]
    eye_rows = atlas.shape[1]
    lvl_off = _level_offsets(tuple(int(o) for o in offsets), tuple(budgets), y0.device)
    eye_off = torch.arange(B, device=y0.device, dtype=torch.int32)[:, None] * eye_rows
    ys = (y0 + lvl_off[None, :] + eye_off).reshape(-1)
    return atlas.reshape(B * eye_rows, -1), ys, x0.reshape(-1)


@functools.lru_cache(maxsize=16)
def _level_offsets(offsets: tuple, budgets: tuple, device):
    """Each keypoint slot's level row offset in the atlas, copied to
    ``device`` once (a copy per frame would wait for the stream)."""
    return torch.from_numpy(np.repeat(np.asarray(offsets, np.int32), budgets)).to(device)


def _gather_all_patches(levels: Sequence, y0, x0, config: OrbConfig):
    """One 45x45 raw patch per keypoint for every eye and level, from the
    two-eye atlas in ONE window-gather launch: ``[B*N, 45, 45]``."""
    atlas, ys, xs = patch_atlas_starts(levels, y0, x0, config)
    return gather_patches(atlas, ys, xs, orb_ops.PATCH_SIDE, orb_ops.PATCH_SIDE)


def _to_features(config, xy_lvl, response, octave, angle, desc, valid) -> Features:
    """Scale level coords to level-0 pixels and pad to the static capacity
    (reference: src/orbextractor.cpp:630-641)."""
    sf = torch.full((), config.scale_factor, dtype=torch.float32, device=xy_lvl.device)
    scale = torch.pow(sf, octave.to(torch.float32))
    xy = xy_lvl * scale[:, None]

    cap = config.max_keypoints
    n = xy.shape[0]
    if n > cap:
        raise ValueError(f"n_features {n} exceeds max_keypoints {cap}")
    pad = cap - n

    def padded(a, fill=0):
        widths = (0, 0) * (a.dim() - 1) + (0, pad)
        return F.pad(a, widths, value=fill)

    minus_one = torch.full((n,), -1.0, dtype=torch.float32, device=xy.device)
    return Features(
        xy=padded(xy),
        response=padded(response),
        octave=padded(octave),
        angle=padded(angle),
        desc=padded(desc),
        valid=padded(valid, False),
        u_right=padded(minus_one, -1),
        depth=padded(minus_one, -1),
    )


def extract_from_pyramid(levels: Sequence, config: OrbConfig) -> Features:
    """One-eye extraction from levels ``[H_l, W_l]`` (the RGB-D and
    monocular front ends): each level stacked as ``[1, H_l, W_l]`` through
    the same path as the pair, one FAST+NMS and one patch-gather launch."""
    stacked = [lv[None] for lv in levels]
    xy, response, octave, valid, y0, x0 = _select_pyramid_keypoints(stacked, config)
    patches = _gather_all_patches(stacked, y0, x0, config)
    xy = xy + fast_ops.subpixel_peak_from_patches(patches, orb_ops.PATCH_HALF)[None]
    angle = orb_ops.ic_angles_from_patches(patches)
    desc = orb_ops.brief_from_patches(patches, angle)
    return _to_features(config, xy[0], response[0], octave[0], angle, desc, valid[0])


def extract_from_pyramid_pair(levels_lr: Sequence, config: OrbConfig):
    """Joint L/R extraction from levels ``[2, H_l, W_l]``: selection per
    level for both eyes, then one patch gather and one describe stage over
    both eyes' keypoints (reference: src/orbframe.cpp:73-76)."""
    xy, response, octave, valid, y0, x0 = _select_pyramid_keypoints(levels_lr, config)
    n = xy.shape[1]
    patches = _gather_all_patches(levels_lr, y0, x0, config)
    xy = xy + fast_ops.subpixel_peak_from_patches(
        patches, orb_ops.PATCH_HALF
    ).reshape(xy.shape)
    angle = orb_ops.ic_angles_from_patches(patches)
    desc = orb_ops.brief_from_patches(patches, angle)

    def feats(e):
        sl = slice(e * n, (e + 1) * n)
        return _to_features(config, xy[e], response[e], octave[e],
                            angle[sl], desc[sl], valid[e])

    return feats(0), feats(1)
