"""The port's replicated-label engine and sample sort against the JAX
reference, bit for bit.

One module-scoped fixture runs the reference once, in a subprocess with
8 virtual CPU devices: ``distributed_msf`` at n = 256 on gnm and rgg2d
under every algorithm with local preprocessing, and on gnm without it;
``sample_sort`` on tests/test_comm.py's ``(4, 2)`` case at a capacity
factor that fits and at one that overflows; ``splitters_from_sorted``.
It writes everything to one ``.npz``; the tests run ``repro_torch`` on
the CPU over the same slot layout and demand identical masks, weights,
counts, labels and every ``CommStats`` field, and every sort output,
the overflowed garbage included.  The public API, the step builder and
the empty graph are held to the Kruskal oracle without the reference.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import oracle
from repro_torch.comm.sorting import sample_sort, splitters_from_sorted
from repro_torch.core.distributed import (DistGraph, build_dist_graph,
                                          distributed_msf, make_mst_step)
from repro_torch.core.graph import from_numpy
from repro_torch.core.mst import minimum_spanning_forest
from tests.helpers.graph_families import FAMILIES
from tests.test_torch_sharded import run_reference

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
P = 8
N = 256
ALGOS = ("boruvka", "boruvka_shrink", "boruvka_shrink_srconly",
         "filter_boruvka")
CELLS = ([(fam, algo, True) for fam in ("gnm", "rgg2d") for algo in ALGOS]
         + [("gnm", algo, False) for algo in ALGOS])
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")
SORT_FACTORS = (3.0, 0.5)
SORT_L = 256

REFERENCE = """
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm.sorting import sample_sort, splitters_from_sorted
from repro.core.distributed import build_dist_graph, distributed_msf
from repro.data import generators

mesh = Mesh(np.array(jax.devices()), ("data",))
out = {}
graphs = {}
raw = {fam: generators.generate(fam, N, avg_degree=8.0, seed=0)
       for fam in ("gnm", "rgg2d")}
# one slot count for both graphs, so both run the same compiled programs
cap = max(build_dist_graph(*raw[fam], 8)[1] for fam in raw)
for fam in ("gnm", "rgg2d"):
    u, v, w, n = raw[fam]
    g, _ = build_dist_graph(u, v, w, n, 8, cap=cap)
    graphs[fam] = g
    for k, x in (("u", u), ("v", v), ("w", w)):
        out[f"{fam}/in_{k}"] = np.asarray(x)
    for k in ("u", "v", "w", "eid"):
        out[f"{fam}/g_{k}"] = np.asarray(getattr(g, k))
    out[f"{fam}/n"] = np.asarray(n)
for fam, algo, lp in CELLS:
    n = int(out[f"{fam}/n"])
    mask, weight, count, lab, comm = distributed_msf(
        graphs[fam], n, mesh, algorithm=algo, local_preprocessing=lp)
    pre = f"{fam}/{algo}/{int(lp)}/"
    for nm, x in (("mask", mask), ("weight", weight), ("count", count),
                  ("labels", lab)):
        out[pre + nm] = np.asarray(x)
    for f in STATS:
        out[pre + "stat_" + f] = np.asarray(getattr(comm, f))

# tests/test_comm.py's sample-sort case
grid = Mesh(np.array(jax.devices()).reshape(4, 2), ("row", "col"))
p, L = 8, SORT_L
rng = np.random.default_rng(1)
keys = rng.uniform(0, 1000, (p * L,)).astype(np.float32)
vals = np.arange(p * L, dtype=np.int32)
valid = rng.random(p * L) < 0.85
out["sort/keys"], out["sort/vals"], out["sort/valid"] = keys, vals, valid
spec = P(("row", "col"))
for cf in SORT_FACTORS:
    def body(k, v, va, cf=cf):
        r = sample_sort(k, (v,), va, ("row", "col"), capacity_factor=cf)
        return (r.key, r.payload, r.ok, r.overflow)

    f = shard_map(body, mesh=grid, in_specs=(spec,) * 3,
                  out_specs=(spec, (spec,), spec, P()))
    rk, (rv,), rok, ovf = f(jnp.asarray(keys), jnp.asarray(vals),
                            jnp.asarray(valid))
    for nm, x in (("key", rk), ("val", rv), ("ok", rok), ("overflow", ovf)):
        out[f"sort/{cf}/{nm}"] = np.asarray(x)

srt = np.sort(keys.reshape(p, L), axis=1).reshape(-1)
out["sort/sorted"] = srt
f = shard_map(
    lambda k: splitters_from_sorted(k, p, 32, ("row", "col"))[None],
    mesh=grid, in_specs=(spec,), out_specs=spec)
spl = np.asarray(f(jnp.asarray(srt)))
assert (spl == spl[:1]).all()
out["sort/splitters"] = spl[0]
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_distributed") / "reference.npz"
    body = (f"OUT = {str(path)!r}\nN = {N}\nCELLS = {CELLS!r}\n"
            f"STATS = {STATS!r}\nSORT_FACTORS = {SORT_FACTORS!r}\n"
            f"SORT_L = {SORT_L}\n" + REFERENCE)
    assert "OK" in run_reference(body, ndev=8, timeout=600)
    with np.load(path) as data:
        return dict(data)


def _graph(ref, fam):
    g = DistGraph.from_numpy(*(ref[f"{fam}/g_{k}"]
                               for k in ("u", "v", "w", "eid")), device=CPU)
    return g, int(ref[f"{fam}/n"])


def _assert_equal(exp, got, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.dtype == exp.dtype, (what, got.dtype, exp.dtype)
    np.testing.assert_array_equal(got, exp, err_msg=what)


@pytest.mark.parametrize("family,algorithm,lp", CELLS)
def test_distributed_msf_matches_reference(ref, family, algorithm, lp):
    g, n = _graph(ref, family)
    res = distributed_msf(g, n, P, algorithm=algorithm,
                          local_preprocessing=lp)
    pre = f"{family}/{algorithm}/{int(lp)}/"
    mask, weight, count, lab, comm = res
    for nm, x in (("mask", mask), ("weight", weight), ("count", count),
                  ("labels", lab)):
        _assert_equal(ref[pre + nm], x, pre + nm)
    for f in STATS:
        _assert_equal(ref[pre + "stat_" + f], getattr(comm, f),
                      pre + "stat_" + f)
    # and the unique (w, eid) MSF of the Kruskal oracle
    u, v, w = (ref[f"{family}/in_{k}"] for k in ("u", "v", "w"))
    kmask, kweight = oracle.kruskal(u, v, w, n)
    sel = np.unique(g.eid.numpy()[mask.numpy()])
    np.testing.assert_array_equal(sel, np.nonzero(kmask)[0])
    assert abs(float(weight) - kweight) < 1e-3 * max(1.0, kweight)


def _sort_inputs(ref):
    p, L = P, SORT_L
    return (torch.from_numpy(ref["sort/keys"]).view(p, L),
            torch.from_numpy(ref["sort/vals"]).view(p, L),
            torch.from_numpy(ref["sort/valid"]).view(p, L))


@pytest.mark.parametrize("capacity_factor", SORT_FACTORS)
def test_sample_sort_matches_reference(ref, capacity_factor):
    """Every output equals the reference's on the ``(4, 2)`` grid
    layout: at 3.0 the keys arrive sorted across shard boundaries with
    the (key, payload) multiset kept; at 0.5 the exchange overflows, and
    the count and the garbage left behind are the reference's."""
    keys, vals, valid = _sort_inputs(ref)
    res = sample_sort(keys, (vals,), valid, (4, 2),
                      capacity_factor=capacity_factor)
    pre = f"sort/{capacity_factor}/"
    for nm, x in (("key", res.key), ("val", res.payload[0]),
                  ("ok", res.ok), ("overflow", res.overflow)):
        _assert_equal(ref[pre + nm], x.reshape(-1) if x.dim() else x,
                      pre + nm)
    ovf = int(res.overflow)
    if capacity_factor == 3.0:
        assert ovf == 0
        rk, rok = res.key.numpy(), res.ok.numpy()
        np.testing.assert_array_equal(
            np.sort(rk[rok]), np.sort(ref["sort/keys"][ref["sort/valid"]]))
        got = sorted(zip(rk[rok].tolist(), res.payload[0].numpy()[rok]
                         .tolist()))
        k, v, va = (ref[f"sort/{x}"] for x in ("keys", "vals", "valid"))
        assert got == sorted(zip(k[va].tolist(), v[va].tolist()))
        fin = [row[np.isfinite(row)] for row in rk]
        for s, row in enumerate(fin):
            assert (np.diff(row) >= 0).all()
            if s and len(fin[s - 1]) and len(row):
                assert fin[s - 1].max() <= row.min()
    else:
        assert ovf > 0
    # a bare payload tensor comes back bare
    bare = sample_sort(keys, vals, valid, (4, 2),
                       capacity_factor=capacity_factor)
    assert torch.equal(bare.payload, res.payload[0])


def test_splitters_from_sorted_matches_reference(ref):
    srt = torch.from_numpy(ref["sort/sorted"]).view(P, SORT_L)
    _assert_equal(ref["sort/splitters"], splitters_from_sorted(srt, P, 32),
                  "splitters")
    with pytest.raises(ValueError, match="do not match"):
        splitters_from_sorted(srt, 4, 32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_public_api_distributed_matches_oracle(family):
    u, v, w, n = FAMILIES[family](1)
    kmask, kweight = oracle.kruskal(u, v, w, n)
    edges = from_numpy(u, v, w, n, device=CPU)
    for algo in ALGOS:
        for num_shards in (P, (4, 2)):
            mask, wt = minimum_spanning_forest(
                edges, algorithm=algo, engine="distributed",
                num_shards=num_shards)
            np.testing.assert_array_equal(mask.numpy(), kmask,
                                          err_msg=f"{family} {algo}")
            assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)
    with pytest.raises(ValueError, match="needs num_shards"):
        minimum_spanning_forest(edges, engine="distributed")


def test_make_mst_step_matches_distributed_msf():
    u, v, w, n = FAMILIES["dup_weights"](2)
    g, cap = build_dist_graph(u, v, w, n, P, device=CPU)
    for algo in ("boruvka", "boruvka_shrink"):
        step, specs = make_mst_step(n, g.cap_total, P, algorithm=algo,
                                    local_preprocessing=False)
        assert [s[0] for s in specs] == [(g.cap_total,)] * 4
        assert [s[1] for s in specs] == [torch.int32, torch.int32,
                                         torch.float32, torch.int32]
        got = step(g.u, g.v, g.w, g.eid)
        exp = distributed_msf(g, n, P, algorithm=algo,
                              local_preprocessing=False)
        for a, b in zip(got[:4], exp[:4]):
            assert torch.equal(a, b)
        assert tuple(got[4]) == tuple(exp[4])
    with pytest.raises(ValueError, match="bogus"):
        distributed_msf(g, n, P, algorithm="bogus")


def test_empty_graph_and_single_vertex():
    """m = 0: every algorithm returns an empty forest over one padding
    slot a shard, the identity labels and one round; n = 1 likewise."""
    e = np.zeros(0, np.int32)
    for n in (5, 1):
        g, cap = build_dist_graph(e, e, np.zeros(0, np.float32), n, P,
                                  device=CPU)
        assert cap == 1
        for algo in ALGOS:
            mask, weight, count, lab, comm = distributed_msf(
                g, n, P, algorithm=algo)
            assert not mask.any() and int(count) == 0
            assert float(weight) == 0.0
            assert torch.equal(lab, torch.arange(n, dtype=torch.int32))
            rounds = (math.ceil(math.log2(n)) + 1
                      if algo.startswith("boruvka_shrink") else
                      (4 if algo == "filter_boruvka" else 1))
            assert int(comm.rounds) == rounds, (n, algo)
