"""New map-point triangulation against covisible keyframes.

Counterpart of the reference package's ``models/triangulation.py``
(Mapping::CreateNewMapPoints + ORBmatcher::SearchForTriangulation,
reference: src/mapping.cpp:280-525, src/orbmatcher.cpp:665-832): for the new
keyframe and each of its best covisible neighbours, match unbound features
under an epipolar gate, DLT-triangulate the matches and keep those passing
the cheirality, reprojection, parallax and scale gates.  Each pair is one
dense masked pass; the neighbour loop is a Python loop over its static
count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import lie
from ..ops.hamming import MAX_DIST, TH_LOW, hamming_matrix
from ..ops.indexing import row, scatter_max, scatter_min, scatter_set, set_row, topk_stable
from ..utils.config import SystemConfig
from .map_state import MapState, _alloc_point_slots, _write_points, recompute_covisibility

N_TRI_NEIGHBORS = 10   # stereo (mono uses 20, reference: src/mapping.cpp:286)
TRI_CAND_CAP = 512     # matched candidates triangulated per pair


@functools.lru_cache(maxsize=8)
def _intrinsics(fx, fy, cx, cy, device):
    """K and its inverse as float32 tensors on ``device`` (K^-1 by LAPACK,
    as the reference's ``jnp.linalg.inv``), copied to the device once."""
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float32)
    return (torch.from_numpy(K).to(device),
            torch.from_numpy(np.linalg.inv(K).astype(np.float32)).to(device))


def _fundamental_from_poses(T1_cw, T2_cw, K_inv):
    """F12 such that x2^T F12 x1 = 0 (ComputeF12, reference:
    src/mapping.cpp:712-724)."""
    T12 = T1_cw @ lie.inv_T(T2_cw)
    E = lie.hat(T12[:3, 3]) @ T12[:3, :3]
    return K_inv.T @ E @ K_inv


def _triangulate_pair(m: MapState, kf1, kf2, config: SystemConfig, enabled,
                      counts=None):
    """Create new points from unmatched features of ``kf1``/``kf2``;
    ``enabled=False`` makes the pass a masked no-op.  With ``counts``
    returns ``(m, counts)`` with the new points' counts set to 2."""
    cam = config.camera
    P, F = m.pt_capacity, m.feat_capacity
    dev = m.kf_T_cw.device
    sf = torch.full((), config.orb.scale_factor, dtype=torch.float32, device=dev)
    Kmat, K_inv = _intrinsics(cam.fx, cam.fy, cam.cx, cam.cy, dev)

    T1 = row(m.kf_T_cw, kf1)
    T2 = row(m.kf_T_cw, kf2)
    c1 = lie.inv_T(T1)[:3, 3]
    c2 = lie.inv_T(T2)[:3, 3]
    baseline = torch.linalg.vector_norm(c2 - c1)

    obs1, obs2 = row(m.kf_obs_point, kf1), row(m.kf_obs_point, kf2)
    unb1 = row(m.kf_feat_valid, kf1) & (obs1 < 0)
    unb2 = row(m.kf_feat_valid, kf2) & (obs2 < 0)
    xy1, xy2 = row(m.kf_xy, kf1), row(m.kf_xy, kf2)
    oct1, oct2 = row(m.kf_octave, kf1), row(m.kf_octave, kf2)

    # epipolar gate: distance of kp2 to the epipolar line of kp1
    F12 = _fundamental_from_poses(T1, T2, K_inv)
    x1h = torch.cat([xy1, torch.ones((F, 1), device=dev)], dim=1)
    lines2 = x1h @ F12.T                                     # [F, 3]
    num = (lines2[:, None, 0] * xy2[None, :, 0] + lines2[:, None, 1] * xy2[None, :, 1]
           + lines2[:, None, 2]) ** 2
    den = lines2[:, None, 0] ** 2 + lines2[:, None, 1] ** 2
    sigma2_2 = torch.pow(sf, 2.0 * oct2.to(torch.float32))
    epi_ok = num / den.clamp(min=1e-9) < 3.84 * sigma2_2[None, :]
    # not too close to the epipole (reference: src/orbmatcher.cpp:740-756)
    ep2 = lie.project(lie.transform_points(T2, c1[None, :]), cam.fx, cam.fy, cam.cx, cam.cy)[0]
    d_ep = torch.sum((xy2 - ep2[None, :]) ** 2, dim=1)
    epipole_ok = d_ep >= 100.0 * torch.pow(sf, oct2.to(torch.float32))

    oct_ok = torch.abs(oct1[:, None] - oct2[None, :]) <= 1
    gate = epi_ok & oct_ok & unb1[:, None] & (unb2 & epipole_ok)[None, :]
    dist = hamming_matrix(row(m.kf_desc, kf1), row(m.kf_desc, kf2))
    big = MAX_DIST + 1
    d = torch.where(gate, dist, big)
    best2 = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best2[:, None])[:, 0]
    matched = best_d <= TH_LOW

    # one kf1 feature per kf2 feature (lowest distance, then lowest index)
    dd = torch.where(matched, best_d, big)
    best_per_2 = scatter_min(torch.full((F,), big, dtype=dd.dtype, device=dev), best2, dd)
    keep = matched & (dd <= best_per_2[best2])
    order = torch.arange(F, device=dev)
    first = scatter_min(torch.full((F,), F, dtype=torch.int64, device=dev), best2,
                        torch.where(keep, order, F))
    keep = keep & (first[best2] == order)

    # --- compress matched candidates to TRI_CAND_CAP rows ----------------
    C = TRI_CAND_CAP
    crank = torch.cumsum(keep.to(torch.int64), 0) - 1
    cdst = torch.where(keep & (crank < C), crank, C)
    c_src = scatter_max(torch.zeros((C + 1,), dtype=torch.int64, device=dev), cdst, order)[:C]
    c_ok = scatter_set(torch.zeros((C + 1,), dtype=torch.bool, device=dev), cdst, keep)[:C]

    xy1_c = xy1[c_src]
    oct1_c = oct1[c_src]
    ur1_c = row(m.kf_uright, kf1)[c_src]
    b2_c = best2[c_src]
    uv2_c = xy2[b2_c]
    oct2_c = oct2[b2_c]
    ur2_c = row(m.kf_uright, kf2)[b2_c]

    X = lie.triangulate_linear(Kmat @ T1[:3, :], Kmat @ T2[:3, :], xy1_c, uv2_c)   # [C, 3]

    # gates: cheirality, reprojection (+ right-u for stereo features, 3-DoF
    # chi2 7.815, reference: src/mapping.cpp:434-470), parallax, scale
    pc1 = lie.transform_points(T1, X)
    pc2 = lie.transform_points(T2, X)
    z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)
    uv1_hat = lie.project(pc1, cam.fx, cam.fy, cam.cx, cam.cy)
    uv2_hat = lie.project(pc2, cam.fx, cam.fy, cam.cx, cam.cy)
    sigma2_1 = torch.pow(sf, 2.0 * oct1_c.to(torch.float32))
    sigma2_2c = torch.pow(sf, 2.0 * oct2_c.to(torch.float32))
    e1 = torch.sum((uv1_hat - xy1_c) ** 2, dim=1)
    e2 = torch.sum((uv2_hat - uv2_c) ** 2, dim=1)
    ur1_hat = uv1_hat[:, 0] - cam.bf / pc1[:, 2].clamp(min=1e-6)
    ur2_hat = uv2_hat[:, 0] - cam.bf / pc2[:, 2].clamp(min=1e-6)
    e1_tot = torch.where(ur1_c >= 0, e1 + (ur1_c - ur1_hat) ** 2, e1)
    e2_tot = torch.where(ur2_c >= 0, e2 + (ur2_c - ur2_hat) ** 2, e2)
    th1 = torch.where(ur1_c >= 0, 7.815, 5.991)
    th2 = torch.where(ur2_c >= 0, 7.815, 5.991)
    reproj_ok = (e1_tot <= th1 * sigma2_1) & (e2_tot <= th2 * sigma2_2c)

    r1 = X - c1
    r2 = X - c2
    d1 = torch.linalg.vector_norm(r1, dim=1) + 1e-9
    d2 = torch.linalg.vector_norm(r2, dim=1) + 1e-9
    parallax_ok = torch.sum(r1 * r2, dim=1) / (d1 * d2) < 0.9998
    ratio_dist = d2 / d1
    ratio_octave = torch.pow(sf, (oct2_c - oct1_c).to(torch.float32))
    rf = 1.5 * config.orb.scale_factor
    scale_ok = (ratio_dist < ratio_octave * rf) & (ratio_dist > ratio_octave / rf)

    want = c_ok & z_ok & reproj_ok & parallax_ok & scale_ok & (baseline > 0.01) & enabled

    slots = _alloc_point_slots(m.pt_valid, want)
    created = slots >= 0
    view = X - c1
    normal = view / (torch.linalg.vector_norm(view, dim=1, keepdim=True) + 1e-9)
    max_dist = d1 * torch.pow(sf, oct1_c.to(torch.float32))
    min_dist = max_dist / torch.pow(sf, float(config.orb.n_levels - 1))
    m = _write_points(m, created, slots, pos=X, desc=row(m.kf_desc, kf1)[c_src],
                      normal=normal, min_dist=min_dist, max_dist=max_dist, ref_kf=kf1,
                      first_kf_id=row(m.kf_id, kf1))
    # bind in both keyframes
    row1 = scatter_max(obs1, torch.where(created, c_src, 0), torch.where(created, slots, -1))
    row2 = scatter_max(obs2, torch.where(created, b2_c, 0), torch.where(created, slots, -1))
    m = m._replace(kf_obs_point=set_row(set_row(m.kf_obs_point, kf1, row1), kf2, row2))
    if counts is None:
        return m
    safe = torch.where(created, slots, P - 1).to(torch.int64)
    counts = counts.index_put((safe,), torch.where(created, 2, counts[safe]).to(counts.dtype))
    return m, counts


def triangulate_with_neighbor(m: MapState, kf1, kf2, config: SystemConfig) -> MapState:
    """Triangulate one keyframe pair (slots as host or 0-d integers) and
    rebuild the covisibility (the reference package's single-pair entry
    point)."""
    dev = m.kf_T_cw.device
    kf1, kf2 = (k if isinstance(k, torch.Tensor)
                else torch.full((), k, dtype=torch.int64, device=dev) for k in (kf1, kf2))
    m = _triangulate_pair(m, kf1, kf2, config, torch.ones((), dtype=torch.bool, device=dev))
    return m._replace(covis=recompute_covisibility(m))


def create_new_map_points(m: MapState, new_kf_slot, config: SystemConfig,
                          n_neighbors: int = N_TRI_NEIGHBORS,
                          update_covis: bool = True, counts=None):
    """Triangulate the new keyframe against its best covisible neighbours
    (top-k on the device, no host read).  ``update_covis=False`` skips the
    tail covisibility rebuild; with ``counts`` returns ``(m, counts)``."""
    w = row(m.covis, new_kf_slot)
    wv, nbrs = topk_stable(w, n_neighbors)
    for i in range(n_neighbors):
        out = _triangulate_pair(m, new_kf_slot, nbrs[i], config, wv[i] > 0, counts)
        m, counts = out if counts is not None else (out, None)
    if update_covis:
        m = m._replace(covis=recompute_covisibility(m))
    return (m, counts) if counts is not None else m
