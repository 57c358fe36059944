"""Edge-sharded global bundle adjustment over a process group.

Counterpart of the reference package's ``parallel/sharded_ba.py``: the BA
edges split across the ranks in contiguous blocks (the layout
``NamedSharding(P(axis))`` gives), poses and points are replicated, and every
edge reduction of ``optim/gba.py::gba_core`` (the cost, the gradient and
diagonal blocks, the W / W^T products inside CG) ends in one
``all_reduce_sum`` on the caller's group: its ``reduce_fn`` hook.  Each rank
sums its own edges in the fixed order of its ``EdgeSums``, and the all-reduce
gives every rank the same bits, so the carry stays replicated.

These are the SPMD primitives: every rank of the group calls them with its
own shard.  ``models/global_ba.py::IncrementalGBA`` drives them from the one
engine on rank 0 while the other ranks serve (``serve.py``).
"""

from __future__ import annotations

import torch

from ..optim.ba import BAProblem
from ..optim.gba import EdgeSums, gba_core
from .collectives import reducer

EDGE_FIELDS = ("e_kf", "e_pt", "e_uv", "e_ur", "e_sigma2", "e_valid")
# the fills of padded edges: a monocular (u_right < 0), unit-weight, invalid
# edge on pose 0 and point 0
_EDGE_FILL = {"e_ur": -1, "e_sigma2": 1, "e_valid": False}


def pad_edges_to_multiple(prob: BAProblem, n: int) -> BAProblem:
    """``prob`` with invalid edges appended until the edge count divides
    ``n``."""
    rem = (-prob.e_kf.shape[0]) % n
    if rem == 0:
        return prob

    def pad(name):
        a = getattr(prob, name)
        return torch.cat([a, torch.full((rem,) + a.shape[1:], _EDGE_FILL.get(name, 0),
                                        dtype=a.dtype, device=a.device)])

    return prob._replace(**{f: pad(f) for f in EDGE_FIELDS})


def shard_problem(prob: BAProblem, rank: int, world: int) -> BAProblem:
    """Rank ``rank``'s block of the (padded) edges; the other fields are
    replicated."""
    e = prob.e_kf.shape[0]
    if e % world:
        raise ValueError(f"{e} edges do not split over {world} ranks: pad them first")
    lo, hi = rank * (e // world), (rank + 1) * (e // world)
    return prob._replace(**{f: getattr(prob, f)[lo:hi] for f in EDGE_FIELDS})


def make_sharded_gba(group, *, fx, fy, cx, cy, bf, n_outer: int = 8, cg_iters: int = 30,
                     fix_first_pose: bool = True):
    """The edge-sharded one-shot solve: ``fn(prob_shard, sums=None) -> (T_opt,
    pts, cost)``, replicated on every rank of ``group``."""
    red = reducer(group)

    def run(prob_shard: BAProblem, sums: EdgeSums | None = None):
        return gba_core(prob_shard, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, n_outer=n_outer,
                        cg_iters=cg_iters, fix_first_pose=fix_first_pose, sums=sums,
                        reduce_fn=red)

    return run


def make_sharded_gba_chunk(group, *, fx, fy, cx, cy, bf, n_outer: int = 1,
                           cg_iters: int = 40, fix_first_pose: bool = True):
    """The chunked variant that ``IncrementalGBA`` runs between frames:
    ``fn(prob_shard, carry, sums=None) -> carry``, ``n_outer`` LM iterations
    from the replicated ``(T, pts, lam, cost)`` carry."""
    red = reducer(group)

    def chunk(prob_shard: BAProblem, carry, sums: EdgeSums | None = None):
        return gba_core(prob_shard, fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, n_outer=n_outer,
                        cg_iters=cg_iters, fix_first_pose=fix_first_pose, init_carry=carry,
                        return_carry=True, sums=sums, reduce_fn=red)

    return chunk
