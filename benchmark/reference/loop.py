"""A plain reference of the loop correction: the essential-graph solve and
the point update that ORB-SLAM2 runs once a loop is verified
(``OptimizeEssentialGraph``, src/orboptimizer.cpp:875-1000, and
``CorrectLoop``, src/loopclosing.cpp:400-585).

Plain numpy in float64 on the CPU, as the benchmark's other references
are: it imports nothing of the program, no JAX and no torch (so no TF32 or
other reduced-precision matmul can enter it).  It is given what the
program's correction was given, as numpy arrays or as anything with
``.cpu().numpy()``, and judges what it did with it:

- the vertices: every keyframe's pose ``T_cw`` before the correction and
  whether it is live;
- the edges, as the program built them (``build_essential_edges``: the
  temporal chain, the strong covisibility edges, the stored loop edges and
  the new one), each with its measured relative similarity ``S_ij`` (a
  rigid ``T_ij`` and a scale ``s_ij``) and its weight;
- the fixed vertex (the loop's candidate keyframe) and ``fix_scale``;
- the map points: position, reference keyframe, whether live.

The edge set is an input: this reference judges the solve and the point
update, not the choice of edges.

The solve.  Each live vertex is a similarity ``S_i(x) = s_i R_i x + t_i``
(world to camera), started at its rigid pose with ``s_i = 1``.  An edge
``(i, j)`` says ``S_i = S_ij o S_j``; its error is the Sim(3) logarithm of
``S_ij o S_j o S_i^-1`` (g2o's ``EdgeSim3``: ``Sim3::log``, rotation,
translation through the inverse of the left Jacobian ``W``, log scale),
and the cost is the sum over live edges of ``w^2 |error|^2``.  The solve is
Levenberg-Marquardt on the dense normal equations of the live vertices,
with each step accepted only where it lowers the cost, run until a step no
longer lowers it by a relative ``1e-15`` (or ``MAX_ITERS`` steps).
``fix_scale`` holds every ``s_i`` at 1, as stereo does.  The Jacobians are
central differences (step ``1e-6``) of the exact error: at that step their
error is near ``1e-10`` of their size, so the minimum found is the cost's.
Each pose is then ``[R_i | t_i / s_i]`` (src/orboptimizer.cpp:1044-1052).

The point update: a live point moves through its reference keyframe's old
and new pose, ``p' = S_new^-1(T_old p)`` (src/orboptimizer.cpp:1054-1060).

Where this departs from the program's ``correct_loop``
(``models/loop_closing.py``):

- the program runs 15 Gauss-Newton steps with a damping of ``1e-6`` of the
  diagonal (``optim/pose_graph.py::LM_DAMPING``) and no test of the cost,
  in float32 on the card; this runs to convergence in float64;
- the program's error takes the error similarity's translation as it is;
  g2o (and this) take it through ``W^-1``.  The two agree to second order
  in the error, which is small at the minimum;
- the program reverts the whole solve when a pose is non-finite or lies
  beyond 100 times the map's extent (its divergence guard); this has none;
- the program starts every vertex at its old pose; ORB-SLAM2 starts the
  current keyframe's neighbours at their loop-corrected poses
  (src/loopclosing.cpp:430-465).  A solve run to convergence does not
  depend on the start unless the cost has more than one minimum;
- ORB-SLAM2 gives every edge the identity information; the program weights
  the loop edges by 5, and this takes the weights it is given;
- the edge set is the program's and has the program's departures: the
  temporal chain for the spanning tree, at most ``4 K`` covisibility
  edges (the first in row-major order), and no new links of the loop's
  fused points (src/loopclosing.cpp:520-560).  This judges none of them;
- a point whose reference keyframe is not a live vertex stays where it is,
  as in the program; ORB-SLAM2 hands a culled keyframe's points to another.
"""

from __future__ import annotations

import math

import numpy as np

MAX_ITERS = 200
DIFF_STEP = 1e-6


# ---------------------------------------------------------------------------
# SO(3) and Sim(3), batched over leading axes
# ---------------------------------------------------------------------------

def _hat(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_so3(w):
    """Rodrigues: ``[..., 3]`` -> ``[..., 3, 3]``."""
    w = np.asarray(w, np.float64)
    th2 = (w * w).sum(-1)
    th = np.sqrt(th2)
    small = th2 < 1e-12
    th_s = np.where(small, 1.0, th)
    a = np.where(small, 1.0 - th2 / 6.0, np.sin(th_s) / th_s)
    b = np.where(small, 0.5 - th2 / 24.0, (1.0 - np.cos(th_s)) / (th_s * th_s))
    K = _hat(w)
    return np.eye(3) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R):
    """The rotation vector of ``[..., 3, 3]`` rotations (angles below pi)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    v = 0.5 * np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)
    sn = np.linalg.norm(v, axis=-1)
    th = np.arctan2(sn, c)
    small = sn < 1e-9
    k = np.where(small, 1.0 + th * th / 6.0, th / np.where(small, 1.0, sn))
    return v * k[..., None]


def log_sim3(R, t, s):
    """g2o's ``Sim3::log`` as ``[..., 7]``: (rotation vector, ``W^-1 t``,
    ``log s``), with the small-angle and small-scale limits of ``W``'s
    coefficients (g2o's four cases)."""
    sigma = np.log(s)
    w = log_so3(R)
    th = np.sqrt((w * w).sum(-1))
    eps = 1e-5
    small_s = np.abs(sigma) < eps
    small_t = th < eps
    th_ = np.where(small_t, 1.0, th)
    sg_ = np.where(small_s, 1.0, sigma)
    with np.errstate(divide="ignore", invalid="ignore"):
        # C, A, B of W = A Omega + B Omega^2 + C I
        C = np.where(small_s, 1.0, (s - 1.0) / sg_)
        A_ss = np.where(small_t, 0.5, (1.0 - np.cos(th_)) / (th_ * th_))
        B_ss = np.where(small_t, 1.0 / 6.0, (th_ - np.sin(th_)) / (th_ * th_ * th_))
        A_st = ((sg_ - 1.0) * s + 1.0) / (sg_ * sg_)
        B_st = ((0.5 * sg_ * sg_ - sg_ + 1.0) * s) / (sg_ * sg_ * sg_)
        a, b = s * np.sin(th_), s * np.cos(th_)
        cc = th_ * th_ + sg_ * sg_
        A_g = (a * sg_ + (1.0 - b) * th_) / (th_ * cc)
        B_g = (C - ((b - 1.0) * sg_ + a * th_) / cc) / (th_ * th_)
    A = np.where(small_s, A_ss, np.where(small_t, A_st, A_g))
    B = np.where(small_s, B_ss, np.where(small_t, B_st, B_g))
    Om = _hat(w)
    W = A[..., None, None] * Om + B[..., None, None] * (Om @ Om) + C[..., None, None] * np.eye(3)
    u = np.linalg.solve(W, t[..., None])[..., 0]
    return np.concatenate([w, u, sigma[..., None]], -1)


def compose(Ra, ta, sa, Rb, tb, sb):
    """``(a o b)(x) = sa Ra (sb Rb x + tb) + ta``."""
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def inverse(R, t, s):
    Rt = np.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0] / s[..., None], 1.0 / s


def retract(dx, R, t, s):
    """The step ``dx = (phi, rho, sigma)`` applied to vertices ``(R, t, s)``."""
    return exp_so3(dx[..., :3]) @ R, t + dx[..., 3:6], s * np.exp(dx[..., 6])


def edge_error(R_i, t_i, s_i, R_j, t_j, s_j, R_m, t_m, s_m):
    """``log(S_ij o S_j o S_i^-1)`` of each edge, ``[E, 7]``."""
    a = compose(R_m, t_m, s_m, R_j, t_j, s_j)
    return log_sim3(*compose(*a, *inverse(R_i, t_i, s_i)))


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------

def _np(x, dtype=np.float64):
    """``x`` as a numpy array: numpy as is, a tensor through ``.cpu()``."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _live_edges(kf_valid, e_i, e_j, e_T, e_s, e_w, e_valid):
    """The edges between live vertices: ``(i, j, R_ij, t_ij, s_ij, w)``."""
    live = _np(kf_valid, bool)
    e_i, e_j = _np(e_i, np.int64), _np(e_j, np.int64)
    eT, es, ew = _np(e_T), _np(e_s), _np(e_w)
    ev = _np(e_valid, bool) & live[e_i] & live[e_j]
    return e_i[ev], e_j[ev], eT[ev, :3, :3], eT[ev, :3, 3], es[ev], ew[ev]


def _cost(R, t, s, edges):
    e_i, e_j, R_m, t_m, es, ew = edges
    r = edge_error(R[e_i], t[e_i], s[e_i], R[e_j], t[e_j], s[e_j], R_m, t_m, es) * ew[:, None]
    return float((r * r).sum())


def graph_cost(state: dict, inputs: dict) -> float:
    """The cost of the similarities ``state`` (``"R"``, ``"t"``, ``"s"``)
    on the graph of ``inputs`` (:func:`correct`'s)."""
    return _cost(state["R"], state["t"], state["s"],
                 _live_edges(inputs["kf_valid"], inputs["e_i"], inputs["e_j"], inputs["e_T"],
                             inputs["e_s"], inputs["e_w"], inputs["e_valid"]))


def essential_graph(T_cw, kf_valid, fixed, e_i, e_j, e_T, e_s, e_w, e_valid, fix_scale=True):
    """Solve the essential graph to convergence.  Returns ``{"R", "t", "s"}``
    (the similarities, ``[K, ...]``, the non-live vertices at their rigid
    pose), ``"T_cw"`` ``[K, 4, 4]`` (``[R | t / s]``), ``"cost0"``,
    ``"cost"`` and ``"iters"``."""
    T = _np(T_cw)
    K = T.shape[0]
    live = _np(kf_valid, bool)
    edges = _live_edges(kf_valid, e_i, e_j, e_T, e_s, e_w, e_valid)
    e_i, e_j, R_m, t_m, es, ew = edges

    R, t, s = T[:, :3, :3].copy(), T[:, :3, 3].copy(), np.ones(K)
    free = live.copy()
    free[int(fixed)] = False
    idx = np.nonzero(free)[0]
    n = len(idx)
    col = np.full(K, -1, np.int64)
    col[idx] = np.arange(n)
    cost = cost0 = _cost(R, t, s, edges)
    lam, iters, ar7 = 1e-4, 0, np.arange(7)
    while iters < MAX_ITERS and n:
        iters += 1
        r = edge_error(R[e_i], t[e_i], s[e_i], R[e_j], t[e_j], s[e_j], R_m, t_m,
                       es) * ew[:, None]                          # [E, 7]
        # central differences: each of the 7 directions at vertex i and at j
        J = np.zeros(r.shape + (14,))
        for side in (0, 1):
            for d in range(7):
                step = np.zeros(7)
                step[d] = DIFF_STEP
                out = []
                for sign in (1.0, -1.0):
                    Ri, ti, si = R[e_i], t[e_i], s[e_i]
                    Rj, tj, sj = R[e_j], t[e_j], s[e_j]
                    if side == 0:
                        Ri, ti, si = retract(sign * step, Ri, ti, si)
                    else:
                        Rj, tj, sj = retract(sign * step, Rj, tj, sj)
                    out.append(edge_error(Ri, ti, si, Rj, tj, sj, R_m, t_m, es))
                J[..., 7 * side + d] = (out[0] - out[1]) / (2 * DIFF_STEP) * ew[:, None]
        H = np.zeros((n * 7, n * 7))
        g = np.zeros(n * 7)
        for a, va in ((0, e_i), (1, e_j)):
            Ja = J[..., 7 * a:7 * a + 7]
            ca = col[va]
            ok_a = ca >= 0
            ga = (np.swapaxes(Ja, 1, 2) @ r[..., None])[..., 0]
            np.add.at(g, (7 * ca[ok_a, None] + ar7).reshape(-1), ga[ok_a].reshape(-1))
            for b, vb in ((0, e_i), (1, e_j)):
                Jb = J[..., 7 * b:7 * b + 7]
                cb = col[vb]
                ok = ok_a & (cb >= 0)
                blk = np.swapaxes(Ja[ok], 1, 2) @ Jb[ok]               # [E', 7, 7]
                rows = np.broadcast_to(7 * ca[ok, None, None] + ar7[None, :, None], blk.shape)
                cols = np.broadcast_to(7 * cb[ok, None, None] + ar7[None, None, :], blk.shape)
                np.add.at(H, (rows.reshape(-1), cols.reshape(-1)), blk.reshape(-1))
        keep = np.ones(n * 7, bool)
        if fix_scale:
            keep[6::7] = False
        Hk, gk = H[np.ix_(keep, keep)], g[keep]
        improved, rel = False, 0.0
        while lam < 1e12:
            A = Hk + lam * np.diag(np.maximum(np.diagonal(Hk), 1e-12))
            dx = np.zeros(n * 7)
            dx[keep] = np.linalg.solve(A, -gk)
            step = np.zeros((K, 7))
            step[idx] = dx.reshape(n, 7)
            R2, t2, s2 = retract(step, R, t, s)
            c2 = _cost(R2, t2, s2, edges)
            if c2 < cost:
                improved = True
                rel = (cost - c2) / max(cost, 1e-300)
                R, t, s, cost = R2, t2, s2, c2
                lam = max(lam / 3.0, 1e-12)
                break
            lam *= 4.0
        if not improved or rel < 1e-15:
            break
    T_new = T.copy()
    T_new[:, :3, :3] = R
    T_new[:, :3, 3] = t / s[:, None]
    return {"R": R, "t": t, "s": s, "T_cw": T_new, "cost0": cost0, "cost": cost,
            "iters": iters}


def correct_points(T_old, solved, kf_valid, pt_pos, pt_ref_kf, pt_valid):
    """``[P, 3]``: each live point through its reference keyframe's old pose
    and new similarity, ``p' = S_new^-1(T_old p)``; the others as they were."""
    T_old, p = _np(T_old), _np(pt_pos)
    K = T_old.shape[0]
    ref = _np(pt_ref_kf, np.int64)
    ref_c = np.clip(ref, 0, K - 1)
    ok = _np(pt_valid, bool) & (ref >= 0) & (ref < K) & _np(kf_valid, bool)[ref_c]
    x = (T_old[ref_c, :3, :3] @ p[..., None])[..., 0] + T_old[ref_c, :3, 3]
    R, t, s = solved["R"][ref_c], solved["t"][ref_c], solved["s"][ref_c]
    p_new = (np.swapaxes(R, 1, 2) @ (x - t)[..., None])[..., 0] / s[:, None]
    return np.where(ok[:, None], p_new, p)


def correct(inputs: dict) -> dict:
    """The correction of one loop.  ``inputs``: ``T_cw``, ``kf_valid``,
    ``fixed`` (the candidate's slot), the edges ``e_i``, ``e_j``, ``e_T``,
    ``e_s``, ``e_w``, ``e_valid``, ``fix_scale``, and the points ``pt_pos``,
    ``pt_ref_kf``, ``pt_valid``.  Returns :func:`essential_graph`'s dict
    with ``"pt_pos"`` added."""
    out = essential_graph(inputs["T_cw"], inputs["kf_valid"], inputs["fixed"], inputs["e_i"],
                          inputs["e_j"], inputs["e_T"], inputs["e_s"], inputs["e_w"],
                          inputs["e_valid"], inputs.get("fix_scale", True))
    out["pt_pos"] = correct_points(inputs["T_cw"], out, inputs["kf_valid"], inputs["pt_pos"],
                                   inputs["pt_ref_kf"], inputs["pt_valid"])
    return out


# ---------------------------------------------------------------------------
# The comparison and its controls
# ---------------------------------------------------------------------------

def _centres(T):
    return -(np.swapaxes(T[:, :3, :3], 1, 2) @ T[:, :3, 3:])[..., 0]


def compare(T_cw, pt_pos, ref: dict, kf_valid, pt_valid) -> dict:
    """A corrected map (``T_cw [K, 4, 4]``, ``pt_pos [P, 3]``) against the
    reference's correction ``ref``, over the live keyframes and points:

    - ``rot_deg``: the largest angle between a keyframe's rotation and the
      reference's;
    - ``trans_rel``: the largest distance between a keyframe's centre and
      the reference's, over the graph's extent (the largest distance between
      two of the reference's keyframe centres);
    - ``point_m``: the largest distance between a point and the
      reference's, in metres; ``point_m_median`` the median."""
    live = _np(kf_valid, bool)
    T, T_ref = _np(T_cw)[live], ref["T_cw"][live]
    ang = np.linalg.norm(log_so3(T[:, :3, :3] @ np.swapaxes(T_ref[:, :3, :3], 1, 2)), axis=-1)
    c, c_ref = _centres(T), _centres(T_ref)
    extent = (float(np.linalg.norm(c_ref[:, None] - c_ref[None], axis=-1).max())
              if len(c_ref) > 1 else 0.0)
    ok = _np(pt_valid, bool)
    d_pt = np.linalg.norm(_np(pt_pos)[ok] - ref["pt_pos"][ok], axis=-1)
    return {
        "rot_deg": math.degrees(float(ang.max())) if len(ang) else 0.0,
        "trans_rel": (float(np.linalg.norm(c - c_ref, axis=-1).max()) / extent
                      if extent > 0 else 0.0),
        "point_m": float(d_pt.max()) if len(d_pt) else 0.0,
        "point_m_median": float(np.median(d_pt)) if len(d_pt) else 0.0,
        "extent_m": extent,
        "keyframes": int(live.sum()),
        "points": int(ok.sum()),
    }


def judge(numbers: dict, limits: dict):
    """``(ok, checks)``: each number with a limit beside it, and whether
    every one is within it (a missing or non-finite number fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        checks[name] = {"value": v, "limit": limit, "ok": good}
        ok = ok and good
    return ok, checks


def bf16(x):
    """``x`` rounded to bfloat16 (to nearest, ties to even) and back, in
    float64."""
    f = _np(x).astype(np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def control(name: str, inputs: dict) -> dict:
    """The reference's correction with one stated guarantee broken, for the
    comparison to refuse: ``bf16``, every edge's measurement (``e_T``,
    ``e_s``) rounded to bfloat16, the precision that would halve the edge
    table; ``no_loop``, the new loop edge (the last) dropped, so the loop
    is never closed."""
    inputs = dict(inputs)
    if name == "bf16":
        inputs["e_T"], inputs["e_s"] = bf16(inputs["e_T"]), bf16(inputs["e_s"])
    elif name == "no_loop":
        v = _np(inputs["e_valid"], bool).copy()
        v[-1] = False
        inputs["e_valid"] = v
    else:
        raise ValueError(f"unknown control {name!r}")
    return correct(inputs)
