"""Graph generators mirroring the paper's benchmark families (KaGen analog).

All generators are host-side numpy (the data pipeline layer), deterministic
given a seed, and return canonical undirected edges (u < v, no self loops)
plus the vertex count.  Weights are drawn uniformly from [1, 255) as in the
paper's experimental setup (Section VII).

Families (Section VII): 2D grid, 2D/3D random geometric (RGG), random
hyperbolic (RHG), Erdős-Renyi (GNM), RMAT (Graph500 probabilities).

A numpy-only copy of ``repro/data/generators.py``: the same seed gives
the same graph in both packages.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

Edges = Tuple[np.ndarray, np.ndarray, np.ndarray, int]  # u, v, w, n


def assign_weights(m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 0x9E3779B9)
    return rng.uniform(1.0, 255.0, size=m).astype(np.float32)


def _finish(u: np.ndarray, v: np.ndarray, n: int, seed: int,
            dedup: bool = True) -> Edges:
    lo = np.minimum(u, v).astype(np.int64)
    hi = np.maximum(u, v).astype(np.int64)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    if dedup and len(lo):
        key = lo * np.int64(n) + hi
        _, idx = np.unique(key, return_index=True)
        lo, hi = lo[idx], hi[idx]
    w = assign_weights(len(lo), seed)
    return lo.astype(np.int32), hi.astype(np.int32), w, n


def grid2d(rows: int, cols: int, seed: int = 0) -> Edges:
    """2D grid with 4-neighbourhoods (maximal locality)."""
    n = rows * cols
    ids = np.arange(n).reshape(rows, cols)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    e = np.concatenate([right, down], axis=0)
    return _finish(e[:, 0], e[:, 1], n, seed, dedup=False)


def gnm(n: int, m: int, seed: int = 0) -> Edges:
    """Erdős-Renyi G(n, m): m uniform random edges (parallel ones deduped)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=int(m * 1.1) + 16, dtype=np.int64)
    v = rng.integers(0, n, size=int(m * 1.1) + 16, dtype=np.int64)
    eu, ev, w, _ = _finish(u, v, n, seed)
    if len(eu) > m:
        eu, ev, w = eu[:m], ev[:m], w[:m]
    return eu, ev, w, n


def rmat(scale: int, m: int, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Edges:
    """RMAT with Graph500 default probabilities (skewed degrees)."""
    n = 1 << scale
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    probs = np.array([a, b, c, d])
    cum = np.cumsum(probs)
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        quad = np.searchsorted(cum, r)
        u = (u << 1) | (quad >> 1)
        v = (v << 1) | (quad & 1)
    return _finish(u, v, n, seed)


def rgg2d(n: int, avg_degree: float = 8.0, seed: int = 0) -> Edges:
    """2D random geometric graph via cell binning (high locality)."""
    rng = np.random.default_rng(seed)
    r = math.sqrt(avg_degree / (math.pi * n))
    pts = rng.random((n, 2))
    return _rgg(pts, r, n, seed)


def rgg3d(n: int, avg_degree: float = 8.0, seed: int = 0) -> Edges:
    rng = np.random.default_rng(seed)
    r = (3.0 * avg_degree / (4.0 * math.pi * n)) ** (1.0 / 3.0)
    pts = rng.random((n, 3))
    return _rgg(pts, r, n, seed)


def _rgg(pts: np.ndarray, r: float, n: int, seed: int) -> Edges:
    """Neighbour search on a uniform grid of cell size r."""
    dim = pts.shape[1]
    ncell = max(1, int(1.0 / r))
    cell = np.minimum((pts * ncell).astype(np.int64), ncell - 1)
    key = cell[:, 0]
    for d in range(1, dim):
        key = key * ncell + cell[:, d]
    order = np.argsort(key, kind="stable")
    # vertex ids follow spatial order => locality in the edge list, the
    # property the paper's local preprocessing exploits.
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    pts_s = pts[order]
    key_s = key[order]
    starts = np.searchsorted(key_s, np.arange(ncell ** dim))
    ends = np.searchsorted(key_s, np.arange(ncell ** dim), side="right")
    us, vs = [], []
    offsets = np.array(np.meshgrid(*([[-1, 0, 1]] * dim))).T.reshape(-1, dim)
    cell_s = cell[order]
    for ci in np.unique(key_s):
        i0, i1 = starts[ci], ends[ci]
        if i0 >= i1:
            continue
        mine = np.arange(i0, i1)
        base = cell_s[i0]
        neigh = [mine]
        for off in offsets:
            if (off == 0).all():
                continue
            nb = base + off
            if (nb < 0).any() or (nb >= ncell).any():
                continue
            nk = nb[0]
            for d in range(1, dim):
                nk = nk * ncell + nb[d]
            j0, j1 = starts[nk], ends[nk]
            if j0 < j1:
                neigh.append(np.arange(j0, j1))
        cand = np.concatenate(neigh)
        d2 = ((pts_s[mine][:, None, :] - pts_s[cand][None, :, :]) ** 2).sum(-1)
        ii, jj = np.nonzero(d2 <= r * r)
        a, b = mine[ii], cand[jj]
        keep = a < b
        us.append(a[keep])
        vs.append(b[keep])
    u = np.concatenate(us) if us else np.zeros(0, np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)
    return _finish(u, v, n, seed, dedup=True)


def rhg(n: int, avg_degree: float = 8.0, gamma: float = 3.0,
        seed: int = 0) -> Edges:
    """Random hyperbolic graph (power-law degrees, partial locality).

    Threshold model on the hyperbolic disk of radius R; simplified KaGen:
    R tuned so that the expected degree is roughly ``avg_degree``.
    """
    rng = np.random.default_rng(seed)
    alpha = (gamma - 1.0) / 2.0
    R = 2.0 * math.log(n) + math.log(8.0 * alpha ** 2
                                     / (math.pi * avg_degree * (alpha - .5) ** 2))
    R = max(R, 1.0)
    # radial CDF: cosh(alpha r) growth
    uu = rng.random(n)
    rad = np.arccosh(1.0 + uu * (np.cosh(alpha * R) - 1.0)) / alpha
    ang = rng.random(n) * 2.0 * math.pi
    # sort by angle => vertex ids follow the disk => locality
    order = np.argsort(ang, kind="stable")
    rad, ang = rad[order], ang[order]
    # blocked pairwise check (fine for benchmark sizes)
    us, vs = [], []
    block = 2048
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        for j0 in range(i0, n, block):
            j1 = min(j0 + block, n)
            dphi = np.abs(ang[i0:i1, None] - ang[None, j0:j1])
            dphi = np.minimum(dphi, 2.0 * math.pi - dphi)
            ch = (np.cosh(rad[i0:i1, None]) * np.cosh(rad[None, j0:j1])
                  - np.sinh(rad[i0:i1, None]) * np.sinh(rad[None, j0:j1])
                  * np.cos(dphi))
            d = np.arccosh(np.maximum(ch, 1.0))
            ii, jj = np.nonzero(d <= R)
            a, b = ii + i0, jj + j0
            keep = a < b
            us.append(a[keep])
            vs.append(b[keep])
    u = np.concatenate(us) if us else np.zeros(0, np.int64)
    v = np.concatenate(vs) if vs else np.zeros(0, np.int64)
    return _finish(u, v, n, seed, dedup=True)


FAMILIES = {
    "grid2d": lambda n, deg, seed: grid2d(int(math.sqrt(n)),
                                          int(math.sqrt(n)), seed),
    "rgg2d": lambda n, deg, seed: rgg2d(n, deg, seed),
    "rgg3d": lambda n, deg, seed: rgg3d(n, deg, seed),
    "rhg": lambda n, deg, seed: rhg(n, deg, seed=seed),
    "gnm": lambda n, deg, seed: gnm(n, int(n * deg / 2), seed),
    "rmat": lambda n, deg, seed: rmat(max(1, int(math.log2(n))),
                                      int(n * deg / 2), seed),
}


def generate(family: str, n: int, avg_degree: float = 8.0,
             seed: int = 0) -> Edges:
    return FAMILIES[family](n, avg_degree, seed)
