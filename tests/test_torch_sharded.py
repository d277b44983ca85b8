"""The port's sharded engine and routed exchange against the JAX
reference, bit for bit.

One module-scoped fixture runs the reference once, in a subprocess with
8 virtual CPU devices: the flat baseline (the ``OFF`` lever combo of
tests/test_engine_equivalence.py) on every graph family × both
algorithms, two undersized-capacity runs whose overflow garbage must be
reproduced exactly, and a few ``routed_exchange``/``reply`` cases.  It
writes everything to one ``.npz``; the tests then run ``repro_torch`` on
the CPU over the same slot layout (``DistGraph.from_numpy``) and demand
identical masks, weights, counts, labels, overflow and every
``CommStats``/``ExchangeStats`` field.  The reference runs with
``pallas_minedges=False`` (its kernel path does not run under this JAX,
ROADMAP.md queue 3); the port runs both ways against it.
"""
import inspect

import numpy as np
import pytest
import torch

from repro.core import oracle
from repro.core.distributed import build_dist_graph as jax_build_dist_graph
from repro_torch.comm.exchange import (ExchangeStats, reply, request_reply,
                                       routed_exchange)
from repro_torch.core.distributed import DistGraph, build_dist_graph
from repro_torch.core.distributed_sharded import (distributed_sharded_msf,
                                                  execute_plan)
from repro_torch.core.graph import from_numpy
from repro_torch.core.mst import minimum_spanning_forest
from repro_torch.core.plan import synthetic_plan
from tests.helpers import graph_families
from tests.helpers.graph_families import FAMILIES
from tests.helpers.subproc import run_multidevice

CPU = torch.device("cpu")
P = 8
OFF = dict(local_preprocessing=False, coalesce=False, src_only=False,
           adaptive_doubling=False, shrink_capacities=False,
           ghost_cache=False, relabel_skip=False)
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")
ALGOS = ("boruvka", "filter_boruvka")
# (items per shard, capacity, seed); odd seeds also route to invalid
# destinations (-2..-1, p..p+1), which must be counted as overflow
EXCHANGE_CASES = [(40, 8, 1), (40, 3, 2), (17, 1, 3), (64, 64, 4),
                  (33, 16, 6)]
OVERFLOW_FAMILY = "random"

REFERENCE = inspect.getsource(graph_families) + """
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm.exchange import ExchangeStats, reply, routed_exchange
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import distributed_sharded_msf

mesh = Mesh(np.array(jax.devices()), ("data",))
OFF = dict(local_preprocessing=False, coalesce=False, src_only=False,
           adaptive_doubling=False, shrink_capacities=False,
           ghost_cache=False, relabel_skip=False)
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")
out = {}


def put(prefix, res):
    mask, weight, count, lab, ovf, comm = res
    for nm, x in (("mask", mask), ("weight", weight), ("count", count),
                  ("labels", lab), ("overflow", ovf)):
        out[prefix + nm] = np.asarray(x)
    for f in STATS:
        out[prefix + "stat_" + f] = np.asarray(getattr(comm, f))


for fam, make in sorted(FAMILIES.items()):
    u, v, w, n = make(0)
    g, cap = build_dist_graph(u, v, w, n, 8)
    for k in ("u", "v", "w", "eid"):
        out[f"{fam}/g_{k}"] = np.asarray(getattr(g, k))
    out[f"{fam}/n"] = np.asarray(n)
    for algo in ("boruvka", "filter_boruvka"):
        put(f"{fam}/{algo}/",
            distributed_sharded_msf(g, n, mesh, algorithm=algo, **OFF))
        if fam == OVERFLOW_FAMILY:
            put(f"{fam}/{algo}/cap1/", distributed_sharded_msf(
                g, n, mesh, algorithm=algo, edge_capacity=1, **OFF))

p = 8
for case, (L, cap, seed) in enumerate(EXCHANGE_CASES):
    dest, valid, a, b = exchange_inputs(L, seed)

    def fn(dest, valid, a, b):
        ex = routed_exchange((a, b), dest, valid, cap, ("data",),
                             stats=ExchangeStats.zeros())
        ans = jnp.where(ex.recv_ok, ex.recv[0] * 3 + 1, -7)
        back, st = reply(ex, ans, ("data",), stats=ex.stats)
        return (ex.recv[0][None], ex.recv[1][None], ex.recv_ok[None],
                ex.sent_ok[None], ex.slot[None], back[None], ex.overflow,
                tuple(st))

    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("data"),) * 4,
                          out_specs=(P("data"),) * 6 + (P(), P())))
    res = f(dest.reshape(-1), valid.reshape(-1), a.reshape(-1),
            b.reshape(-1))
    for nm, x in zip(EXCHANGE_OUT, res[:7]):
        out[f"ex{case}/{nm}"] = np.asarray(x)
    for nm, x in zip(ExchangeStats._fields, res[7]):
        out[f"ex{case}/stat_{nm}"] = np.asarray(x)
np.savez(OUT, **out)
print("OK")
"""

EXCHANGE_OUT = ("recv_a", "recv_b", "recv_ok", "sent_ok", "slot", "reply",
                "overflow")


def exchange_inputs(L, seed, p=8):
    rng = np.random.default_rng(seed)
    lo, hi = (-2, p + 2) if seed % 2 else (0, p)
    dest = rng.integers(lo, hi, (p, L)).astype(np.int32)
    valid = rng.random((p, L)) < 0.8
    a = rng.integers(0, 1000, (p, L)).astype(np.int32)
    b = rng.uniform(0, 1, (p, L)).astype(np.float32)
    return dest, valid, a, b


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_reference") / "reference.npz"
    body = (f"OUT = {str(path)!r}\n"
            f"OVERFLOW_FAMILY = {OVERFLOW_FAMILY!r}\n"
            f"EXCHANGE_CASES = {EXCHANGE_CASES!r}\n"
            f"EXCHANGE_OUT = {EXCHANGE_OUT!r}\n"
            + inspect.getsource(exchange_inputs) + REFERENCE)
    out = run_multidevice(body, ndev=8, timeout=600)
    assert "OK" in out
    with np.load(path) as data:
        return dict(data)


def _graph(ref, fam):
    g = DistGraph.from_numpy(*(ref[f"{fam}/g_{k}"]
                               for k in ("u", "v", "w", "eid")), device=CPU)
    return g, int(ref[f"{fam}/n"])


def _assert_same(ref, prefix, res):
    mask, weight, count, lab, ovf, comm = res
    got = dict(mask=mask, weight=weight, count=count, labels=lab,
               overflow=ovf)
    got.update({"stat_" + f: getattr(comm, f) for f in STATS})
    for name, x in got.items():
        exp = ref[prefix + name]
        x = x.cpu().numpy()
        assert x.dtype == exp.dtype, (prefix, name, x.dtype, exp.dtype)
        np.testing.assert_array_equal(x, exp, err_msg=f"{prefix}{name}")


@pytest.mark.parametrize("pallas_minedges", [False, True])
@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_engine_matches_reference(ref, family, algorithm,
                                          pallas_minedges):
    g, n = _graph(ref, family)
    res = distributed_sharded_msf(g, n, P, algorithm=algorithm,
                                  pallas_minedges=pallas_minedges, **OFF)
    _assert_same(ref, f"{family}/{algorithm}/", res)
    assert int(res[4]) == 0
    # and the unique (w, eid) MSF of the Kruskal oracle
    u, v, w, n = FAMILIES[family](0)
    kmask, kweight = oracle.kruskal(u, v, w, n)
    sel = np.unique(g.eid.numpy()[res[0].numpy()])
    np.testing.assert_array_equal(sel, np.nonzero(kmask)[0])
    assert abs(float(res[1]) - kweight) < 1e-3 * max(1.0, kweight)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_public_api_matches_oracle(algorithm):
    """``minimum_spanning_forest`` end to end (its own layout build)."""
    for fam in sorted(FAMILIES):
        u, v, w, n = FAMILIES[fam](1)
        kmask, kweight = oracle.kruskal(u, v, w, n)
        mask, wt = minimum_spanning_forest(
            from_numpy(u, v, w, n, device=CPU), algorithm=algorithm,
            engine="distributed_sharded", num_shards=P,
            pallas_minedges=True, **OFF)
        np.testing.assert_array_equal(mask.numpy(), kmask, err_msg=fam)
        assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_edge_capacity_one_overflows_like_reference(ref, algorithm):
    """An undersized capacity reports the reference's overflow count,
    and the garbage it leaves behind (labels, counters) is the
    reference's too; the public API turns it into the overflow error."""
    g, n = _graph(ref, OVERFLOW_FAMILY)
    prefix = f"{OVERFLOW_FAMILY}/{algorithm}/cap1/"
    for pm in (False, True):
        res = distributed_sharded_msf(g, n, P, algorithm=algorithm,
                                      edge_capacity=1, pallas_minedges=pm,
                                      **OFF)
        _assert_same(ref, prefix, res)
    expected = int(ref[prefix + "overflow"])
    assert expected > 0
    u, v, w, n = FAMILIES[OVERFLOW_FAMILY](0)
    with pytest.raises(RuntimeError,
                       match=rf"exchange overflow \({expected} items\)"):
        minimum_spanning_forest(from_numpy(u, v, w, n, device=CPU),
                                algorithm=algorithm,
                                engine="distributed_sharded", num_shards=P,
                                edge_capacity=1, **OFF)


@pytest.mark.parametrize("case", range(len(EXCHANGE_CASES)))
def test_routed_exchange_and_reply_match_reference(ref, case):
    L, cap, seed = EXCHANGE_CASES[case]
    dest, valid, a, b = (torch.from_numpy(x)
                         for x in exchange_inputs(L, seed))
    ex = routed_exchange((a, b), dest, valid, cap, (P,),
                         stats=ExchangeStats.zeros(CPU))
    ans = torch.where(ex.recv_ok, ex.recv[0] * 3 + 1, -7)
    back, st = reply(ex, ans, (P,), stats=ex.stats)
    got = dict(zip(EXCHANGE_OUT, (ex.recv[0], ex.recv[1], ex.recv_ok,
                                  ex.sent_ok, ex.slot, back, ex.overflow)))
    got.update({"stat_" + f: getattr(st, f) for f in ExchangeStats._fields})
    for name, x in got.items():
        exp = ref[f"ex{case}/{name}"]
        assert x.numpy().dtype == exp.dtype, (case, name)
        np.testing.assert_array_equal(x.numpy(), exp,
                                      err_msg=f"case {case}: {name}")
    # the one-call round trip gives the same answers and admission
    out, answered, ovf = request_reply(
        (a, b), dest, valid, lambda recv, ok: torch.where(
            ok, recv[0] * 3 + 1, -7), cap, (P,))
    np.testing.assert_array_equal(out.numpy(), ref[f"ex{case}/reply"])
    np.testing.assert_array_equal(answered.numpy(), ref[f"ex{case}/sent_ok"])
    assert int(ovf) == int(ref[f"ex{case}/overflow"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_dist_graph_layout_matches_reference(family):
    u, v, w, n = FAMILIES[family](2)
    for p in (1, 3, 8):
        jg, jcap = jax_build_dist_graph(u, v, w, n, p)
        tg, tcap = build_dist_graph(u, v, w, n, p, device=CPU)
        assert tcap == jcap
        for k in ("u", "v", "w", "eid"):
            exp = np.asarray(getattr(jg, k))
            got = getattr(tg, k).numpy()
            assert got.dtype == exp.dtype, (family, p, k)
            np.testing.assert_array_equal(got, exp,
                                          err_msg=f"{family} p={p} {k}")


def test_unported_levers_raise():
    """The port's boundary: every lever runs, the ghost cache included
    (also on the reference's defaults); a ghost push the layout cannot
    take raises, never downgraded; a plan replays, but one of another
    shape raises; a replay verifies, and the driver takes and resumes
    from checkpoints, but the fused engine refuses them; the replicated
    engine raises naming its ROADMAP item."""
    u, v, w, n = FAMILIES["random"](0)
    g, _ = build_dist_graph(u, v, w, n, P, device=CPU)
    res = distributed_sharded_msf(g, n, P)  # the reference's defaults
    assert int(res[4]) == 0 and float(res[5].hits) > 0
    for kw in (dict(OFF, ghost_cache=True),
               dict(shrink_capacities=False),
               dict(OFF, ghost_cache=True, ghost_push="flat",
                    push_capacity=4)):
        res = distributed_sharded_msf(g, n, P, **kw)
        assert float(res[5].hits) > 0, kw
    for lever in OFF:
        res = distributed_sharded_msf(g, n, P, **dict(OFF, **{lever: True}))
        assert int(res[4]) == 0, lever
    with pytest.raises(ValueError, match="needs an \\(R, C\\) layout"):
        distributed_sharded_msf(g, n, P, ghost_push="grid")
    with pytest.raises(ValueError, match="needs p <= 31"):
        distributed_sharded_msf(g, n, (8, 4), ghost_push="flat")
    with pytest.raises(ValueError, match="unknown ghost_push"):
        distributed_sharded_msf(g, n, P, ghost_push="ring")
    with pytest.raises(ValueError, match="plans only transfer"):
        distributed_sharded_msf(g, n, P, plan=synthetic_plan(
            n + 1, g.cap_total, P))
    base = distributed_sharded_msf(g, n, P)
    res = execute_plan(g, n, P, synthetic_plan(n, g.cap_total, P),
                       verify=True)
    assert int(res[4]) == 0 and torch.equal(res[0], base[0])
    cks = []
    res = distributed_sharded_msf(g, n, P, ckpt_every=2, ckpt_out=cks)
    assert cks and all(c.plan_pos is None for c in cks)
    assert torch.equal(res[0], base[0])
    res = distributed_sharded_msf(g, n, P, resume_from=cks[-1])
    assert torch.equal(res[0], base[0]) and torch.equal(res[3], base[3])
    for ckpt in (dict(ckpt_every=2), dict(ckpt_out=[]),
                 dict(resume_from=cks[0])):
        with pytest.raises(ValueError, match="shrinking-capacity"):
            distributed_sharded_msf(g, n, P, shrink_capacities=False, **ckpt)
    edges = from_numpy(u, v, w, n, device=CPU)
    with pytest.raises(NotImplementedError, match="item 6"):
        minimum_spanning_forest(edges, engine="distributed",
                                algorithm="boruvka", num_shards=P)
