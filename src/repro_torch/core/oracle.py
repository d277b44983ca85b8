"""Sequential MSF oracle (Kruskal + union-find), host-side numpy.

Used as the ground truth for every correctness test and to validate the
engines.  Tie-breaking matches the engines: lexicographic on (weight,
edge index) which yields a unique MSF.  A numpy-only copy of
``repro/core/oracle.py``, so the port runs without the reference
installed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[max(ra, rb)] = min(ra, rb)
        return True


def kruskal(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int
            ) -> Tuple[np.ndarray, float]:
    """Return (mask over input edges, total MSF weight)."""
    m = len(u)
    finite = np.isfinite(w)
    idx = np.arange(m)
    order = np.lexsort((idx, w))  # (w, idx) lexicographic
    uf = UnionFind(n)
    mask = np.zeros(m, bool)
    total = 0.0
    for e in order:
        if not finite[e] or u[e] == v[e]:
            continue
        if uf.union(int(u[e]), int(v[e])):
            mask[e] = True
            total += float(w[e])
    return mask, total


def msf_weight(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int) -> float:
    return kruskal(u, v, w, n)[1]


def component_labels(u: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """Connected-component representative for each vertex (min vertex id)."""
    uf = UnionFind(n)
    for a, b in zip(u, v):
        uf.union(int(a), int(b))
    return np.array([uf.find(i) for i in range(n)], np.int32)


def is_forest(u: np.ndarray, v: np.ndarray, n: int) -> bool:
    uf = UnionFind(n)
    for a, b in zip(u, v):
        if not uf.union(int(a), int(b)):
            return False
    return True
