"""The port's sharded engine with its communication levers, and its
shrinking-capacity driver, against the JAX reference bit for bit.

One module-scoped fixture runs the reference once, with 8 virtual CPU
devices, over every lever combination without the ghost cache: each
lever alone (the ``COMBOS`` rows of tests/test_engine_equivalence.py
minus the cache rows), all levers but the cache with the v column
coalesced in slot order, all levers but the cache with the shrinking
driver and with flat capacities, and undersized ``edge_capacity`` runs
whose overflow garbage must be reproduced too.  The reference is split over a few subprocesses that
run one after another.  Each result — mask, weight,
count, labels, overflow, every ``CommStats`` field and every
``round_trace`` row — must come out of ``repro_torch`` on the CPU
identical, with ``pallas_minedges`` False and True (K1's plain version
on the CPU).  The reference runs with ``pallas_minedges=False``: its
kernel path does not run under this JAX (ROADMAP.md queue 3).

The host bounds of the shrinking driver are held against the
reference's numpy functions on the same arrays, and the stacked
LOCALPREPROCESSING loop is checked to leave a stopped shard as it is.
"""
import inspect
import itertools
import json

import numpy as np
import pytest
import torch

from repro.core import distributed as jax_distributed
from repro.core import distributed_sharded as jax_sharded
from repro.core import oracle
from repro.core.distributed import build_dist_graph as jax_build_dist_graph
from repro_torch.core import distributed as torch_distributed
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import DistGraph, build_dist_graph
from repro_torch.core.graph import from_numpy
from repro_torch.core.mst import minimum_spanning_forest
from tests.helpers import graph_families
from tests.helpers.graph_families import FAMILIES
from tests.test_torch_sharded import run_reference

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
P = 8
OFF = dict(local_preprocessing=False, coalesce=False, src_only=False,
           adaptive_doubling=False, shrink_capacities=False,
           ghost_cache=False, relabel_skip=False)
ROWS = {
    "prep": dict(OFF, local_preprocessing=True),
    "coalesce": dict(OFF, coalesce=True),  # incl. the v-sorted index
    "coalesce_slot_v": dict(OFF, coalesce=True, vsorted_index=False),
    "src_only": dict(OFF, src_only=True),
    "adaptive": dict(OFF, adaptive_doubling=True),
    "shrink": dict(OFF, shrink_capacities=True),
    "relabel_skip": dict(OFF, relabel_skip=True),
    "all_slot_v": dict(ghost_cache=False, vsorted_index=False),
    "all": dict(ghost_cache=False),  # all levers minus the cache
    "all_flat": dict(ghost_cache=False, shrink_capacities=False),
    # undersized: the overflow count and the garbage behind it
    "all_cap1": dict(ghost_cache=False, edge_capacity=1),
    "all_flat_cap1": dict(ghost_cache=False, shrink_capacities=False,
                          edge_capacity=1),
}
# each lever alone, then all but the cache with slot-order v runs, and
# all but the cache at flat capacities
LEVER_ROWS = ("prep", "coalesce", "coalesce_slot_v", "src_only",
              "adaptive", "shrink", "relabel_skip", "all_slot_v", "all_flat")
ALGOS = ("boruvka", "filter_boruvka")
# (row, family, algorithm) reference runs, in groups of about equal cost,
# one subprocess each
GROUPS = [
    [("all", f, a) for f in ("random", "clustered") for a in ALGOS],
    [("all", f, a) for f in ("disconnected", "dup_weights") for a in ALGOS]
    + [("all_cap1", "random", "boruvka"),
       ("all_flat_cap1", "random", "boruvka")],
    [(r, "random", "boruvka") for r in LEVER_ROWS]
    + [("all", "selfloops", "boruvka")],
    [(r, "dup_weights", "boruvka") for r in LEVER_ROWS[:7]]
    + [("all", "selfloops", "filter_boruvka")],
]
RUNS = [run for group in GROUPS for run in group]
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")

REFERENCE = inspect.getsource(graph_families) + """
import json
from jax.sharding import Mesh
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import distributed_sharded_msf

mesh = Mesh(np.array(jax.devices()), ("data",))
out = {}
graphs = {}
for row, fam, algo in RUNS:
    if fam not in graphs:
        u, v, w, n = FAMILIES[fam](0)
        graphs[fam] = build_dist_graph(u, v, w, n, 8)[0], n
    g, n = graphs[fam]
    trace = []
    res = distributed_sharded_msf(g, n, mesh, algorithm=algo,
                                  round_trace=trace, **ROWS[row])
    prefix = f"{row}/{fam}/{algo}/"
    mask, weight, count, lab, ovf, comm = res
    for nm, x in (("mask", mask), ("weight", weight), ("count", count),
                  ("labels", lab), ("overflow", ovf)):
        out[prefix + nm] = np.asarray(x)
    for f in STATS:
        out[prefix + "stat_" + f] = np.asarray(getattr(comm, f))
    out[prefix + "trace"] = np.asarray(json.dumps(trace))
for fam, (g, n) in graphs.items():
    for k in ("u", "v", "w", "eid"):
        out[f"{fam}/g_{k}"] = np.asarray(getattr(g, k))
    out[f"{fam}/n"] = np.asarray(n)
np.savez(OUT, **out)
print("OK")
"""


def _run_group(path, group):
    body = (f"OUT = {str(path)!r}\n"
            f"RUNS = {group!r}\n"
            f"ROWS = {ROWS!r}\n"
            f"STATS = {STATS!r}\n" + REFERENCE)
    assert "OK" in run_reference(body, ndev=8, timeout=900)
    with np.load(path) as data:
        return dict(data)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    # one subprocess after another: forked all at once they cost about
    # a third more CPU, which the whole suite pays
    tmp = tmp_path_factory.mktemp("jax_reference_levers")
    out = {}
    for i, group in enumerate(GROUPS):
        out.update(_run_group(tmp / f"group{i}.npz", group))
    return out


def _graph(ref, fam):
    g = DistGraph.from_numpy(*(ref[f"{fam}/g_{k}"]
                               for k in ("u", "v", "w", "eid")), device=CPU)
    return g, int(ref[f"{fam}/n"])


def _assert_same(ref, prefix, res, trace):
    mask, weight, count, lab, ovf, comm = res
    got = dict(mask=mask, weight=weight, count=count, labels=lab,
               overflow=ovf)
    got.update({"stat_" + f: getattr(comm, f) for f in STATS})
    for name, x in got.items():
        exp = ref[prefix + name]
        x = x.cpu().numpy()
        assert x.dtype == exp.dtype, (prefix, name, x.dtype, exp.dtype)
        np.testing.assert_array_equal(x, exp, err_msg=f"{prefix}{name}")
    exp_trace = json.loads(str(ref[prefix + "trace"]))
    assert len(trace) == len(exp_trace), prefix
    for got_row, exp_row in zip(trace, exp_trace):
        assert got_row == exp_row, (prefix, got_row, exp_row)


@pytest.mark.parametrize("pallas_minedges", [False, True])
@pytest.mark.parametrize("row,family,algorithm", RUNS)
def test_levers_match_reference(ref, row, family, algorithm,
                                pallas_minedges):
    g, n = _graph(ref, family)
    trace = []
    res = ds.distributed_sharded_msf(g, n, P, algorithm=algorithm,
                                     pallas_minedges=pallas_minedges,
                                     round_trace=trace, **ROWS[row])
    prefix = f"{row}/{family}/{algorithm}/"
    _assert_same(ref, prefix, res, trace)
    if ROWS[row].get("edge_capacity") is not None:
        assert int(res[4]) > 0, "an undersized capacity must overflow"
        return
    assert int(res[4]) == 0
    # and the unique (w, eid) MSF of the Kruskal oracle
    u, v, w, n = FAMILIES[family](0)
    kmask, kweight = oracle.kruskal(u, v, w, n)
    sel = np.unique(g.eid.numpy()[res[0].numpy()])
    np.testing.assert_array_equal(sel, np.nonzero(kmask)[0])
    assert int(res[2]) == int(kmask.sum())
    if ROWS[row].get("shrink_capacities", True):
        assert len(trace) == int(res[5].rounds)
    else:
        assert trace == []


@pytest.mark.parametrize("algorithm", ALGOS)
def test_public_api_with_levers_matches_oracle(algorithm):
    """``minimum_spanning_forest`` with the reference's defaults minus the
    cache, through K1's plain version, on its own layout build."""
    for fam in sorted(FAMILIES):
        u, v, w, n = FAMILIES[fam](1)
        kmask, kweight = oracle.kruskal(u, v, w, n)
        mask, wt = minimum_spanning_forest(
            from_numpy(u, v, w, n, device=CPU), algorithm=algorithm,
            engine="distributed_sharded", num_shards=P,
            pallas_minedges=True, ghost_cache=False)
        np.testing.assert_array_equal(mask.numpy(), kmask, err_msg=fam)
        assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)


# ---------------------------------------------------------------------------
# the host bounds against the reference's numpy functions
# ---------------------------------------------------------------------------

def _host_state(fam, seed, p=P):
    """A layout of ``fam`` and a plausible mid-solve host state: a
    coarsened label table, live and settled masks."""
    u, v, w, n = FAMILIES[fam](0)
    jg, cap = jax_build_dist_graph(u, v, w, n, p)
    tg, _ = build_dist_graph(u, v, w, n, p, device=CPU)
    vps = ds.vertices_per_shard(n, p)
    rng = np.random.default_rng(seed)
    lab = np.arange(p * vps)
    if seed:
        lab = np.minimum(rng.integers(0, p * vps, p * vps), lab)
        for _ in range(6):
            lab = lab[lab]
    u_h, v_h, w_h = (np.asarray(getattr(jg, k)) for k in ("u", "v", "w"))
    valid = np.isfinite(w_h)
    live = valid & (rng.random(valid.shape) < (1.0 if seed == 0 else 0.6))
    settled = rng.random(p * vps) < 0.3 * seed
    return dict(jg=jg, tg=tg, cap=cap, n=n, vps=vps, p=p,
                lab=lab.astype(np.int32), u=u_h, v=v_h, w=w_h, valid=valid,
                live=live, settled=settled)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_bounds_match_reference(family, seed):
    s = _host_state(family, seed)
    p, vps, n, cap = s["p"], s["vps"], s["n"], s["cap"]
    u, v, w, valid, live = s["u"], s["v"], s["w"], s["valid"], s["live"]
    lab = s["lab"]
    shard = np.repeat(np.arange(p), cap)
    ru, rv = lab[u], lab[v]
    alive = live & (ru != rv)
    J, T = jax_sharded, ds
    for a in (u, v):
        np.testing.assert_array_equal(T._host_run_starts(a, p),
                                      np.flatnonzero(J._host_run_heads(a,
                                                                       p)[0]))
    heads, rid = J._host_run_heads(u, p)
    run_alive = np.bincount(rid[alive], minlength=int(rid[-1]) + 1) > 0
    np.testing.assert_array_equal(
        T._live_heads(np.flatnonzero(heads), alive),
        np.flatnonzero(heads & run_alive[rid]))
    cand = T._live_heads(T._host_run_starts(u, p), alive)
    for src_only in (False, True):
        assert (T._minedges_capacity_bound(ru, rv, alive, shard, cand, p,
                                           vps, src_only)
                == J._minedges_capacity_bound(ru, rv, alive, shard, heads,
                                              rid, p, vps, src_only))
    assert (T._endpoint_lookup_bound(u, v, live, shard, p, vps)
            == J._endpoint_lookup_bound(u, v, live, shard, p, vps))
    assert (T._relabel_capacity_bound(lab, s["settled"], p, vps)
            == J._relabel_capacity_bound(lab, s["settled"], p, vps))
    choosing = np.zeros(p * vps, bool)
    choosing[ru[alive]] = True
    assert (T._contract_capacity_bound(choosing, rv, alive, vps)
            == J._contract_capacity_bound(ru, rv, alive, vps))
    # the v-sorted index, sorted on the device, is the reference's
    hg = T._HostGraph(s["tg"], p, n)
    vindex = J._host_v_perm(v, valid, n, p)
    for x, y in zip(hg.vindex, vindex):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    for vsorted in (False, True):
        for alive_arg in (None, live):
            exp = J.default_lookup_capacity(s["jg"], p, n, alive=alive_arg,
                                            vsorted=vsorted)
            assert T._lookup_bound(hg, alive_arg, vsorted) == exp
            for vi in (None, vindex):
                assert T.default_lookup_capacity(
                    s["tg"], p, n, alive=alive_arg, vsorted=vsorted,
                    vindex=vi) == exp, (vsorted, alive_arg is None)
    for levels in (2, 4, 7):
        np.testing.assert_array_equal(
            T._host_weight_pivots(w, valid, levels, p, cap),
            J._host_weight_pivots(w, valid, levels, p, cap))
    for c in (0, 1, 7, cap):
        for hops in (1, 2):
            for src_only in (False, True):
                assert (T.minedges_buffer_bytes(p, c, hops, src_only)
                        == J.minedges_buffer_bytes(p, c, hops, src_only))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_round_caps_match_reference_driver(family, seed):
    """``_host_round_caps`` against the bounds the reference's driver
    computes for a round, for every lever setting it depends on, and on
    a state with nothing live."""
    s = _host_state(family, seed)
    p, vps, n, cap = s["p"], s["vps"], s["n"], s["cap"]
    J, q = jax_sharded, jax_distributed.quantize_capacity
    u, v, lab = s["u"], s["v"], s["lab"]
    shard = np.repeat(np.arange(p), cap)
    heads, rid = J._host_run_heads(u, p)
    vindex = J._host_v_perm(v, s["valid"], n, p)
    hg = ds._HostGraph(s["tg"], p, n)
    lk_full = J.default_lookup_capacity(s["jg"], p, n)
    for live in (s["live"], np.zeros_like(s["live"])):
        ru, rv = lab[u], lab[v]
        alive = live & (ru != rv)
        choosing = np.zeros(p * vps, bool)
        choosing[np.unique(ru[alive])] = True
        for coalesce, src_only, relabel_skip, vsorted in (
                itertools.product((False, True), repeat=4)):
            caps = ds._host_round_caps(hg, lab, live, s["settled"], cap,
                                       vps, lk_full, coalesce, src_only,
                                       relabel_skip, vsorted)
            bound = J._minedges_capacity_bound(ru, rv, alive, shard, heads,
                                               rid, p, vps, src_only)
            lk = (J.default_lookup_capacity(s["jg"], p, n, alive=live,
                                            vsorted=vsorted, vindex=vindex)
                  if coalesce else
                  J._endpoint_lookup_bound(u, v, live, shard, p, vps))
            rl = (q(J._relabel_capacity_bound(lab, s["settled"], p, vps),
                    vps) if relabel_skip else vps)
            assert caps[:5] == (
                bound, q(bound, cap), q(lk, lk_full),
                q(J._contract_capacity_bound(ru, rv, alive, vps), vps),
                rl), (coalesce, src_only, relabel_skip, vsorted)
            np.testing.assert_array_equal(caps.choosing, choosing)


@pytest.mark.parametrize("full", [1, 2, 3, 5, 8, 100, 1000, 2 ** 17 + 3])
def test_capacity_ladder_matches_reference(full):
    for floor in (1, 2, 7):
        assert (torch_distributed.shrink_schedule(full, floor)
                == jax_distributed.shrink_schedule(full, floor))
        for bound in sorted({0, 1, 2, full // 3, full // 2, full - 1, full,
                             full + 1, floor}):
            assert (torch_distributed.quantize_capacity(bound, full, floor)
                    == jax_distributed.quantize_capacity(bound, full,
                                                         floor))


# ---------------------------------------------------------------------------
# LOCALPREPROCESSING's stacked stop condition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prep_round_on_stopped_shard_changes_nothing(family):
    """The reference loops each shard until its own stop; the port loops
    every shard until all have stopped.  A round on a shard with no
    eligible component must be a fixed point, on its first idle round
    and after."""
    u, v, w, n = FAMILIES[family](0)
    g, cap = build_dist_graph(u, v, w, n, P, device=CPU)
    u, v, w, eid = (x.view(P, cap) for x in g)
    sp = ds._prep_space(u, v, w, eid, torch.isfinite(w), n)
    lab = torch.arange(cap, dtype=torch.int32).repeat(P, 1)
    mst = torch.zeros((P, cap), dtype=torch.int32)
    stopped = torch.zeros(P, dtype=torch.bool)
    idle_checked = 0
    for _ in range(ds._doubling_iters(sp.nloc) + 3):
        nlab, nmst, eligible = ds._prep_round(sp, lab, mst)
        idle = ~eligible
        assert torch.equal(nlab[idle], lab[idle])
        assert torch.equal(nmst[idle], mst[idle])
        # once a shard stops it stays stopped
        assert not bool((stopped & eligible).any())
        idle_checked += int(idle.sum())
        stopped |= idle
        lab, mst = nlab, nmst
    assert bool(stopped.all()) and idle_checked > P
