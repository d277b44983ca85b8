"""The plain reference against a brute-force Kruskal, and the frozen
generators: small GNM and RMAT graphs on the CPU, ties in w included."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from msfbench.gen import graphs  # noqa: E402
from msfbench.reference import msf as reference  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def kruskal(u, v, w, n):
    """The MSF by Kruskal over the (w, index) order, one edge at a time."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    mask = np.zeros(len(u), bool)
    order = sorted((float(w[i]), i) for i in range(len(u))
                   if np.isfinite(w[i]))
    for _, i in order:
        a, b = find(int(u[i])), find(int(v[i]))
        if a != b:
            parent[a] = b
            mask[i] = True
    return mask


def _solve(u, v, w, n, dtype=None):
    mask, weight = reference.msf(torch.as_tensor(u), torch.as_tensor(v),
                                 torch.as_tensor(w), n, weight_dtype=dtype)
    return mask.numpy(), weight


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", ["gnm", "rmat"])
def test_reference_equals_kruskal(family, seed):
    cfg = ({"family": "gnm", "n": 300, "m": 1500} if family == "gnm"
           else {"family": "rmat", "scale": 8, "edgefactor": 6})
    g = graphs.make(cfg, seed, CPU)
    u, v, w = g.u.numpy(), g.v.numpy(), g.w.numpy()
    mask, weight = _solve(u, v, w, g.n)
    want = kruskal(u, v, w, g.n)
    assert np.array_equal(mask, want)
    assert weight == pytest.approx(float(w[want].astype(np.float64).sum()),
                                   rel=1e-12)


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_breaks_ties_by_index(seed):
    """Weights from four levels, parallel edges, self-loops and
    non-finite weights: the forest is still Kruskal's in (w, index)."""
    rng = np.random.default_rng(seed)
    n, m = 120, 900
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = rng.integers(1, 5, m).astype(np.float32)
    w[rng.integers(0, m, 20)] = np.inf
    w[rng.integers(0, m, 5)] = np.nan
    mask, _ = _solve(u, v, w, n)
    want = kruskal(u, v, w, n)
    assert np.array_equal(mask, want)
    assert not mask[u == v].any()


def test_control_differs_on_close_weights():
    """In bfloat16 weights that differ in float32 tie, so the control's
    forest is another, and its weight is summed in bfloat16."""
    g = graphs.make({"family": "gnm", "n": 2000, "m": 16000}, 5, CPU)
    mask, weight = _solve(g.u, g.v, g.w, g.n)
    cmask, cweight = _solve(g.u, g.v, g.w, g.n, torch.bfloat16)
    assert not np.array_equal(mask, cmask)
    assert cmask.sum() == mask.sum()  # a spanning forest all the same
    assert abs(cweight - weight) / weight > 1e-4


def test_generators_are_seeded_and_shaped():
    a = graphs.make({"family": "gnm", "n": 1024, "m": 4096}, 7, CPU)
    b = graphs.make({"family": "gnm", "n": 1024, "m": 4096}, 7, CPU)
    c = graphs.make({"family": "gnm", "n": 1024, "m": 4096}, 8, CPU)
    assert all(torch.equal(x, y) for x, y in ((a.u, b.u), (a.v, b.v),
                                              (a.w, b.w)))
    assert not torch.equal(a.w, c.w)
    assert a.m == 4096 and a.u.dtype == torch.int32
    assert bool((a.u < a.v).all()) and a.w.dtype == torch.float32
    assert float(a.w.min()) >= 1.0 and float(a.w.max()) <= 255.0
    key = a.u.long() * a.n + a.v.long()
    assert bool((key[1:] > key[:-1]).all())  # merged, in (u, v) order
    r = graphs.make({"family": "rmat", "scale": 10, "edgefactor": 16}, 7, CPU)
    assert r.n == 1024 and 0 < r.m <= 16 * 1024
    deg = torch.bincount(torch.cat([r.u, r.v]).long(), minlength=r.n)
    assert int(deg.max()) > 8 * float(deg.float().mean())  # skewed


def test_seed_above_32_bits():
    g = graphs.make({"family": "gnm", "n": 64, "m": 128}, 2 ** 33 + 5, CPU)
    assert g.m == 128
