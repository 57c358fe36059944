"""A DBoW2 text vocabulary of ORBvoc.txt's shape, written once per checkout.

ORBvoc.txt is not in the repository.  The reference deployment passes it with
``--vocFilePath`` and loads it on every start, so the benchmark writes a file
of its shape (k = 10, L = 6: 1,111,110 nodes, 10^6 words, about 145 MB) from
a fixed seed that is not a run's ``--seed``: the same file for every run and
both sides of a comparison.  It is a frozen copy of the port's
``utils/synthetic.py::write_orbvoc_text`` without its trained levels: those
were k-means over descriptors from the port's own front end, and the
benchmark takes no input from the program.  The tree and its weights are
``reference/bow.py``'s, which makes them again to judge the keyframes' BoW
rows.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

from reference import bow


def write_text(path, branching: int, levels: int, seed: int, n_train: int) -> dict:
    """Write the vocabulary: header ``k L 0 0`` (TF-IDF, L1), then one line
    per node below the root, ``parent_id is_leaf d0..d31 weight``, in
    breadth-first order.  Returns ``{"nodes", "words", "bytes"}``."""
    level_desc, idf = bow.tree(branching, levels, seed, n_train)

    fmt = "%d %d " + " ".join(["%d"] * 32) + " %s\n"
    n_lines = 0
    with open(path, "w") as f:
        f.write(f"{branching} {levels} 0 0\n")
        for depth, desc in enumerate(level_desc, start=1):
            leaf = int(depth == levels)
            first_parent = n_lines - len(desc) // branching + 1     # 0 at depth 1: the root
            for s in range(0, len(desc), 1 << 16):
                part = desc[s:s + (1 << 16)]
                ids = np.arange(s, s + len(part))
                rows = np.concatenate([(first_parent + ids // branching)[:, None],
                                       np.full((len(part), 1), leaf), part], axis=1).tolist()
                weights = ([f"{w:.6f}" for w in idf[s:s + len(part)]] if leaf
                           else ["0"] * len(part))
                f.writelines(fmt % (*r, w) for r, w in zip(rows, weights))
            n_lines += len(desc)
        n_bytes = f.tell()
    return {"nodes": n_lines, "words": len(idf), "bytes": n_bytes}


def ensure(cache_dir: Path, spec: dict):
    """``(path, seconds or None)`` of the vocabulary ``spec`` describes
    (``branching``, ``levels``, ``seed``, ``train``), written into
    ``cache_dir`` when missing (``seconds`` then says how long that took).
    The name is keyed by the spec and the writer's sources, so a changed
    writer never reuses an old file."""
    key = hashlib.sha1((json.dumps(spec, sort_keys=True) + Path(__file__).read_text()
                        + Path(bow.__file__).read_text()).encode()).hexdigest()[:12]
    path = Path(cache_dir) / f"orbvoc_k{spec['branching']}_L{spec['levels']}_{key}.txt"
    if path.exists():
        return path, None
    import time

    t = time.perf_counter()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    write_text(tmp, spec["branching"], spec["levels"], spec["seed"], spec["train"])
    os.replace(tmp, path)
    return path, time.perf_counter() - t
