"""The port's ghost-vertex label cache against the JAX reference, bit for
bit: the ghost rows of the lever matrix.

One module-scoped fixture runs the reference in a few subprocesses, one
after another (8 virtual CPU devices), over the ghost rows of ``COMBOS``
(tests/test_engine_equivalence.py: the ``OFF`` + cache sub-matrix, flat
capacities, and the defaults, the last with both algorithms) on four
families; the two rows that differ only in ``coalesce``, which the
cache makes moot, run once in the reference on one family (``TWIN``).
Each result — mask, weight, count, labels, overflow, every
``CommStats`` field, every ``round_trace`` row — must come out of
``repro_torch`` on the CPU identical, with ``pallas_minedges`` False and
True (K1's plain version on the CPU); the reference runs with
``pallas_minedges=False`` (its kernel path does not run under this JAX,
ROADMAP.md queue 3).  The push-mode ladder and the ghost host bounds are
held to the reference's functions, and the public API with no lever
arguments to Kruskal on every family.  The push ladder on ``(R, C)``
layouts and the reference's cache contracts are in
tests/test_torch_ghost_contracts.py, which shares this file's runner.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from repro.core import distributed_sharded as jax_sharded
from repro.core import oracle
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import DistGraph
from repro_torch.core.graph import from_numpy
from repro_torch.core.mst import minimum_spanning_forest
from tests.helpers import graph_families
from tests.helpers.graph_families import FAMILIES
from tests.test_torch_sharded import run_reference
from tests.test_torch_sharded_levers import _assert_same, _host_state

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
OFF = dict(local_preprocessing=False, coalesce=False, src_only=False,
           adaptive_doubling=False, shrink_capacities=False,
           ghost_cache=False, relabel_skip=False)
ROWS = {
    # the ghost rows of COMBOS
    "ghost": dict(OFF, ghost_cache=True),
    "ghost_coalesce": dict(OFF, ghost_cache=True, coalesce=True),
    "ghost_shrink": dict(OFF, ghost_cache=True, shrink_capacities=True),
    "ghost_coalesce_shrink": dict(OFF, ghost_cache=True, coalesce=True,
                                  shrink_capacities=True),
    "flat": dict(shrink_capacities=False),
    "defaults": dict(),
    # the push ladder and the contracts
    "push_flat": dict(ghost_push="flat"),
    "push_grid": dict(ghost_push="grid"),
    "limit31": dict(ghost_shard_limit=31),
    "limit7": dict(ghost_shard_limit=7),
    "limit1": dict(ghost_shard_limit=1),
    "limit4": dict(ghost_shard_limit=4),
    "limit4_flat": dict(ghost_shard_limit=4, shrink_capacities=False),
    "limit8": dict(ghost_shard_limit=8),
    "no_ghost": dict(ghost_cache=False),
    "no_ghost_flat": dict(ghost_cache=False, shrink_capacities=False),
    "push1_flat": dict(shrink_capacities=False, push_capacity=1),
    "push1": dict(push_capacity=1),
    "lookup1_flat": dict(shrink_capacities=False, lookup_capacity=1),
    "grid_flat": dict(ghost_push="grid", shrink_capacities=False),
}
COMBO_ROWS = ("ghost", "ghost_coalesce", "ghost_shrink",
              "ghost_coalesce_shrink", "flat", "defaults")
COMBO_FAMILIES = ("random", "clustered", "dup_weights", "disconnected")
ALGOS = ("boruvka", "filter_boruvka")
# (graph, layout, algorithm, row) reference runs, one subprocess a group
RUNS = ([(f, (8,), "boruvka", r) for f in COMBO_FAMILIES for r in COMBO_ROWS]
        + [(f, (8,), "filter_boruvka", "defaults") for f in COMBO_FAMILIES])
# With the cache on, ``coalesce`` changes no step of either engine: every
# round reads the ghost tables, and the lookup capacity defaults to the
# same bound.  So a coalesce row runs in the reference on one family,
# where test_coalesce_twins_are_one_run_in_the_reference holds it to
# its twin, and elsewhere the port's coalesce row is held to the twin's
# reference run.
TWIN = {"ghost_coalesce": "ghost", "ghost_coalesce_shrink": "ghost_shrink"}
WITNESS = "random"
REF_RUNS = [r for r in RUNS if r[3] not in TWIN or r[0] == WITNESS]
# interleaved, so the costlier shrinking-driver rows spread over groups
GROUPS = [REF_RUNS[i::3] for i in range(3)]
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")


def make_graph(name):
    """(u, v, w, n) of a named test graph: a ``FAMILIES`` entry
    (``family:seed``), the reference tests' rgg2d and gnm graphs
    (``rgg2d:n``, ``gnm:n``), or ``settle``, the strided path beside
    pairs of GHOST_CACHE (2b)."""
    from repro.data import generators
    fam, _, arg = name.partition(":")
    if fam in ("rgg2d", "gnm"):
        return generators.generate(fam, int(arg), avg_degree=8.0, seed=7)
    if fam == "settle":
        ns = 212
        path_ids = np.arange(10, dtype=np.int32) * 21
        rest = np.setdiff1d(np.arange(ns, dtype=np.int32), path_ids)
        m2 = len(rest) // 2 * 2
        su = np.concatenate([path_ids[:-1], rest[:m2:2]]).astype(np.int32)
        sv = np.concatenate([path_ids[1:], rest[1:m2:2]]).astype(np.int32)
        sw = np.random.default_rng(0).uniform(1, 9, len(su)).astype(
            np.float32)
        return su, sv, sw, ns
    return FAMILIES[fam](int(arg or 0))


def run_key(gname, layout, algo, row):
    return f"{gname}/{'x'.join(map(str, layout))}/{algo}/{row}/"


REFERENCE = inspect.getsource(graph_families) + """
import json
import math
from jax.sharding import Mesh
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import distributed_sharded_msf

out = {}
built = {}
for gname, layout, algo, row in RUNS:
    p = math.prod(layout)
    if (gname, p) not in built:
        u, v, w, n = make_graph(gname)
        built[(gname, p)] = (build_dist_graph(u, v, w, n, p)[0], n)
        for k, x in (("u", u), ("v", v), ("w", w), ("n", n)):
            out[f"{gname}/raw_{k}"] = np.asarray(x)
        for k in ("u", "v", "w", "eid"):
            out[f"{gname}/{p}/g_{k}"] = np.asarray(
                getattr(built[(gname, p)][0], k))
    g, n = built[(gname, p)]
    devs = np.array(jax.devices()[:p])
    if len(layout) == 1:
        mesh, ax = Mesh(devs, ("data",)), ("data",)
    else:
        mesh, ax = Mesh(devs.reshape(layout), ("row", "col")), ("row", "col")
    trace = []
    res = distributed_sharded_msf(g, n, mesh, axis_names=ax, algorithm=algo,
                                  round_trace=trace, **ROWS[row])
    prefix = run_key(gname, layout, algo, row)
    for nm, x in zip(("mask", "weight", "count", "labels", "overflow"),
                     res[:5]):
        out[prefix + nm] = np.asarray(x)
    for f in STATS:
        out[prefix + "stat_" + f] = np.asarray(getattr(res[5], f))
    out[prefix + "trace"] = np.asarray(json.dumps(trace))
np.savez(OUT, **out)
print("OK")
"""


def _run_group(path, group, script=REFERENCE):
    ndev = max(math.prod(run[1]) for run in group)
    body = (f"OUT = {str(path)!r}\nRUNS = {group!r}\nROWS = {ROWS!r}\n"
            f"STATS = {STATS!r}\n" + inspect.getsource(make_graph)
            + inspect.getsource(run_key) + script)
    assert "OK" in run_reference(body, ndev=ndev, timeout=900)
    with np.load(path) as data:
        return dict(data)


def reference(tmp, groups, script=REFERENCE):
    """The reference's runs of ``groups``, one subprocess a group, one
    after another, as one dict.  (Forked all at once they cost about a
    third more CPU, which the whole suite pays.)  ``script`` is the body
    each subprocess runs over its ``RUNS`` (this module's ``REFERENCE``
    by default); it writes its arrays to ``OUT``."""
    out = {}
    for i, group in enumerate(groups):
        out.update(_run_group(tmp / f"group{i}.npz", group, script))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("jax_reference_ghost"), GROUPS)


def _solve(ref, gname, layout, algo, row, **kw):
    """The port on the reference's slot layout.  Returns (result, trace,
    graph)."""
    p = math.prod(layout)
    g = DistGraph.from_numpy(*(ref[f"{gname}/{p}/g_{k}"]
                               for k in ("u", "v", "w", "eid")), device=CPU)
    n = int(ref[f"{gname}/raw_n"])
    trace = []
    shards = layout if len(layout) > 1 else p
    res = ds.distributed_sharded_msf(g, n, shards, algorithm=algo,
                                     round_trace=trace,
                                     **dict(ROWS[row], **kw))
    return res, trace, g


def _kruskal_sel(ref, gname):
    u, v, w, n = (ref[f"{gname}/raw_{k}"] for k in ("u", "v", "w", "n"))
    return np.nonzero(oracle.kruskal(u, v, w, int(n))[0])[0]


def _check_exact(ref, gname, res, g):
    assert int(res[4]) == 0, (gname, int(res[4]))
    sel = np.unique(g.eid.numpy()[res[0].numpy()])
    np.testing.assert_array_equal(sel, _kruskal_sel(ref, gname))


@pytest.mark.parametrize("pallas_minedges", [False, True])
@pytest.mark.parametrize("run", RUNS, ids=[run_key(*r) for r in RUNS])
def test_ghost_matches_reference(ref, run, pallas_minedges):
    res, trace, g = _solve(ref, *run, pallas_minedges=pallas_minedges)
    gname, layout, algo, row = run
    if run not in REF_RUNS:
        row = TWIN[row]
    _assert_same(ref, run_key(gname, layout, algo, row), res, trace)
    row = run[3]
    if row in ("push1_flat", "lookup1_flat"):
        return  # undersized on purpose: see the contract tests
    _check_exact(ref, run[0], res, g)
    if ROWS[row].get("shrink_capacities", True):
        assert len(trace) == int(res[5].rounds)
    else:
        assert trace == []


@pytest.mark.parametrize("row", sorted(TWIN))
def test_coalesce_twins_are_one_run_in_the_reference(ref, row):
    """The reference itself gives a coalesce row with the cache on and
    its twin without ``coalesce`` the same outputs, trace included."""
    a = run_key(WITNESS, (8,), "boruvka", row)
    b = run_key(WITNESS, (8,), "boruvka", TWIN[row])
    keys = [k[len(a):] for k in ref if k.startswith(a)]
    assert len(keys) == 14
    for k in keys:
        np.testing.assert_array_equal(ref[a + k], ref[b + k], err_msg=k)


# ---------------------------------------------------------------------------
# the push ladder, the host bounds and the public API
# ---------------------------------------------------------------------------

LADDER_CASES = [(mode, sizes, limit)
                for mode in (None, "flat", "grid", "ring")
                for sizes in ((8,), (4, 2), (8, 4), (31,), (32,), (31, 31),
                              (32, 2), (2, 2, 2))
                for limit in (None, 1, 4, 7, 8, 31, 40)]


@pytest.mark.parametrize("ghost", [False, True])
def test_push_mode_ladder_matches_reference(ghost):
    """flat → grid → off, and an explicit push the layout cannot take
    raises, as the reference's ``_ghost_push_mode`` does."""
    for mode, sizes, limit in LADDER_CASES:
        try:
            exp = jax_sharded._ghost_push_mode(ghost, mode, sizes, limit)
        except ValueError:
            with pytest.raises(ValueError):
                ds._ghost_push_mode(ghost, mode, sizes, limit)
            continue
        assert ds._ghost_push_mode(ghost, mode, sizes, limit) == exp, (
            mode, sizes, limit)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ghost_host_bounds_match_reference(family, seed):
    """Each ghost bound against the reference's numpy function on the
    same arrays, on one-axis and (R, C) layouts."""
    s = _host_state(family, seed)
    p, vps, n = s["p"], s["vps"], s["n"]
    u, v, live, lab = s["u"], s["v"], s["live"], s["lab"]
    J = jax_sharded
    hg = ds._HostGraph(s["tg"], p, n)
    heads, _ = J._host_run_heads(u, p)
    perm, skey = J._host_v_perm(v, s["valid"], n, p)
    assert hg.ghost_table_sizes() == (
        J._host_run_count_max(heads, p),
        J._host_run_count_max(J._host_run_heads(skey, p)[0], p))
    assert ds._ghost_fill_bounds(hg, live) == J._ghost_fill_bounds(
        u, live, perm, skey, n, p, vps)
    ghosts = J._host_ghost_lists(u, v, live, p)
    table = ds._host_ghost_table(hg, live)
    for sh in range(p):
        np.testing.assert_array_equal(np.flatnonzero(table[sh]), ghosts[sh])
    roots = ds._root_table(table, lab)
    assert ds._subscribe_capacity_bound(roots, p, vps) == \
        J._subscribe_capacity_bound(lab, ghosts, p, vps)
    rng = np.random.default_rng(seed)
    for frac in (0.0, 0.3, 1.0):
        choosing = rng.random(p * vps) < frac
        dirty = roots & choosing
        assert ds._push_capacity_bound(dirty, p, vps) == \
            J._push_capacity_bound(lab, ghosts, choosing, p, vps), frac
        for R, C in ((4, 2), (2, 4), (8, 1), (1, 8)):
            assert ds._push_capacity_bound_grid(dirty, R, C, vps) == \
                J._push_capacity_bound_grid(lab, ghosts, choosing, p, R, C,
                                            vps), (frac, R, C)
    # the driver maps each round's root table from the last one's: with
    # labels that are fixpoints, merging roots gives the same table
    # whether taken from the roots or from the cached vertices
    fix = _fixpoint(lab)
    merge = _fixpoint(np.minimum(np.arange(p * vps), rng.permutation(p * vps)))
    coarser = merge[fix]
    np.testing.assert_array_equal(
        ds._root_table(ds._root_table(table, fix), coarser),
        ds._root_table(table, coarser))


def _fixpoint(parent):
    """Pointer jumping until every label is a root."""
    while not np.array_equal(parent, parent[parent]):
        parent = parent[parent]
    return parent


@pytest.mark.parametrize("shards", [8, (4, 2)])
@pytest.mark.parametrize("algorithm", ALGOS)
def test_public_api_defaults_match_oracle(algorithm, shards):
    """``minimum_spanning_forest`` with no lever argument runs the
    reference's defaults — the cache on, the grid push on (4, 2) only if
    asked — and equals Kruskal on every family."""
    for fam in sorted(FAMILIES):
        u, v, w, n = FAMILIES[fam](1)
        kmask, kweight = oracle.kruskal(u, v, w, n)
        mask, wt = minimum_spanning_forest(
            from_numpy(u, v, w, n, device=CPU), algorithm=algorithm,
            engine="distributed_sharded", num_shards=shards)
        np.testing.assert_array_equal(mask.numpy(), kmask, err_msg=fam)
        assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)
    mask, _ = minimum_spanning_forest(
        from_numpy(u, v, w, n, device=CPU), algorithm=algorithm,
        engine="distributed_sharded", num_shards=(4, 2), ghost_push="grid")
    np.testing.assert_array_equal(mask.numpy(), kmask)


@pytest.mark.parametrize("num_shards,sizes", [
    (8, (8,)), ((4, 2), (4, 2)), ([2, 3], (2, 3)), ((2, 2, 2), (2, 2, 2))])
def test_shard_layout(num_shards, sizes):
    assert ds.shard_layout(num_shards) == sizes
    for bad in (0, (4, 0), ()):
        with pytest.raises(ValueError):
            ds.shard_layout(bad)
