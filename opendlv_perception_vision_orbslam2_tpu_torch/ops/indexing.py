"""Out-of-place indexed updates with the reference's semantics.

The reference package updates arrays with ``x.at[idx].set/min/max/add``,
which never modify ``x``.  The port keeps that contract: every helper here
returns a new tensor, so a map snapshot held elsewhere stays intact.

- ``x.at[i].set(v)`` for a device scalar index ``i`` -> :func:`set_row`;
  reading ``x[i]`` -> :func:`row`.  Both go through ``index_select`` /
  ``index_put`` so a CUDA index never becomes a host integer (no sync).
- ``x.at[idx].set(vals)`` with repeated targets -> :func:`scatter_set`: the
  LAST write in index order wins, deterministically, on every device.  That
  is the order XLA:CPU applies a scatter in, which the reference's dump-slot
  writes (``P-1``, ``K-1``, ``PL-1``) rely on.
- ``lax.top_k`` -> :func:`topk_stable`: on ties the lower index comes first
  (``torch.topk`` promises no order on CUDA).
- ``x[i] = scalar`` on a CUDA tensor copies a host scalar and waits for the
  stream; :func:`fill_at` writes it with a device fill instead.
"""

from __future__ import annotations

import torch


def _long(i):
    return i.reshape(1).to(torch.int64)


def as_like(v, like):
    """``v`` as a tensor of ``like``'s dtype and device; a Python scalar
    becomes a fill (a host->device copy of it would sync the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), v, dtype=like.dtype, device=like.device)


def fill_at(x, i: int, value):
    """Set ``x[i]`` (dim 0, a host integer) to the Python scalar ``value`` in
    place by a device fill, with no host->device copy; returns ``x``."""
    x.select(0, i).fill_(value)
    return x


def row(x, i):
    """``x[i]`` for a 0-d integer tensor ``i``."""
    return x.index_select(0, _long(i))[0]


def set_row(x, i, v):
    """``x.at[i].set(v)`` for a 0-d integer tensor or a host integer ``i``
    (a host integer indexes a copy: no host->device transfer)."""
    v = as_like(v, x)
    if not isinstance(i, torch.Tensor):
        out = x.clone()
        out[int(i)] = v
        return out
    return x.index_put((_long(i),), v.expand(x.shape[1:])[None])


def scatter_set(base, idx, vals):
    """``base.at[idx].set(vals)`` along dim 0 with last-write-wins on
    repeated targets; ``vals`` is ``[N, *base.shape[1:]]`` or broadcastable."""
    n = idx.shape[0]
    idx = idx.to(torch.int64)
    order = torch.arange(n, device=base.device)
    last = torch.full((base.shape[0],), -1, dtype=torch.int64, device=base.device)
    last = last.scatter_reduce(0, idx, order, "amax", include_self=True)
    vals = as_like(vals, base).expand((n,) + tuple(base.shape[1:]))
    src = vals.index_select(0, last.clamp(min=0))
    hit = (last >= 0).reshape((-1,) + (1,) * (base.dim() - 1))
    return torch.where(hit, src, base)


def scatter_min(base, idx, vals):
    """``base.at[idx].min(vals)`` along dim 0 (1-D)."""
    return base.scatter_reduce(0, idx.to(torch.int64), vals.to(base.dtype), "amin",
                               include_self=True)


def scatter_max(base, idx, vals):
    """``base.at[idx].max(vals)`` along dim 0 (1-D)."""
    return base.scatter_reduce(0, idx.to(torch.int64), vals.to(base.dtype), "amax",
                               include_self=True)


def scatter_add(base, idx, vals):
    """``base.at[idx].add(vals)`` along dim 0."""
    return base.index_add(0, idx.to(torch.int64), vals.to(base.dtype))


def topk_stable(x, k: int):
    """``lax.top_k`` along the last axis: ``(values, indices)``, descending,
    the lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
