"""Horn 1987 closed-form absolute orientation (quaternion method), batched.

Counterpart of the reference package's ``ops/horn.py`` (Sim3Solver::
ComputeSim3, reference: src/sim3solver.cpp:240-351): centroids, the 3x3
correlation matrix, Horn's 4x4 N matrix, its dominant eigenvector as the
rotation quaternion, then scale and translation, batched over RANSAC
hypotheses.

The reference takes the eigenvector from ``eigh``.  ``torch.linalg.eigh``
reads its error flags back to the host on CUDA (it has no ``_ex`` form), so
here the eigenvector comes from repeated squaring of the shifted matrix
``N + ||N||_F I``, whose eigenvalues are those of N moved to be >= 0 with
the order kept: 24 squarings raise it to the power 2^24, which leaves only
the top eigenvector's direction unless the top two eigenvalues tie (then
the reference's ``eigh`` picks a direction by rounding as well).
"""

from __future__ import annotations

import torch

N_SQUARINGS = 24


def quat_to_rot(q):
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.where(n > 1e-12, n, torch.ones_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], dim=-2)


def top_eigenvector(N):
    """Unit eigenvector of the largest eigenvalue of symmetric ``[..., 4, 4]``
    by repeated squaring (no host read); the sign is arbitrary."""
    fro = torch.linalg.matrix_norm(N)
    M = N + fro[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)
    for _ in range(N_SQUARINGS):
        M = M / (torch.linalg.matrix_norm(M)[..., None, None] + 1e-30)
        M = M @ M
    # M is ~ v v^T: its largest column is v times its largest component
    col = torch.argmax(torch.linalg.vector_norm(M, dim=-2), dim=-1)
    v = torch.gather(M, -1, col[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]
    v = N @ v[..., None] + fro[..., None, None] * v[..., None]   # one power step
    v = v[..., 0]
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
    # a zero matrix (no weight at all): the last basis vector, as LAPACK's
    # eigh returns for it (built by comparison: a scalar written into a CUDA
    # tensor is a synced host copy)
    e4 = (torch.arange(4, device=v.device) == 3).to(v.dtype)
    return torch.where((fro > 0)[..., None], v, e4)


def horn_align(a, b, w=None, fix_scale: bool = False):
    """Least-squares similarity aligning ``a -> b``: ``(R, t, s)`` with
    ``b ~ s R a + t``.  ``a, b [..., N, 3]``; ``w [..., N]`` optional weights
    (masked points get weight 0); ``fix_scale`` pins s = 1 (stereo loop
    closing, reference: src/sim3solver.cpp:45-47 mbFixScale)."""
    if w is None:
        w = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-12
    mu_a = torch.sum(a * w[..., None], dim=-2) / wsum
    mu_b = torch.sum(b * w[..., None], dim=-2) / wsum
    ac = a - mu_a[..., None, :]
    bc = b - mu_b[..., None, :]
    M = torch.einsum("...n,...ni,...nj->...ij", w, ac, bc)    # correlation a b^T

    S = lambda i, j: M[..., i, j]  # noqa: E731
    N = torch.stack([
        torch.stack([S(0, 0) + S(1, 1) + S(2, 2), S(1, 2) - S(2, 1), S(2, 0) - S(0, 2),
                     S(0, 1) - S(1, 0)], -1),
        torch.stack([S(1, 2) - S(2, 1), S(0, 0) - S(1, 1) - S(2, 2), S(0, 1) + S(1, 0),
                     S(2, 0) + S(0, 2)], -1),
        torch.stack([S(2, 0) - S(0, 2), S(0, 1) + S(1, 0), -S(0, 0) + S(1, 1) - S(2, 2),
                     S(1, 2) + S(2, 1)], -1),
        torch.stack([S(0, 1) - S(1, 0), S(2, 0) + S(0, 2), S(1, 2) + S(2, 1),
                     -S(0, 0) - S(1, 1) + S(2, 2)], -1),
    ], dim=-2)
    R = quat_to_rot(top_eigenvector(N))
    Ra = ac @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device)
    else:
        num = torch.sum(w * torch.sum(bc * Ra, dim=-1), dim=-1)
        den = torch.sum(w * torch.sum(ac * ac, dim=-1), dim=-1) + 1e-12
        s = num / den
    t = mu_b - s[..., None] * (R @ mu_a[..., None])[..., 0]
    return R, t, s
