"""Round plans and planned replay, the port against the JAX reference.

In process, ``repro_torch.core.plan`` is held to ``repro.core.plan``:
the same JSON bytes, each package loading the other's JSON, the same
broken plans rejected, and equal ``pad``, ``synthetic_plan`` and cache
keys.

One module-scoped fixture runs the reference (the runner of
tests/test_torch_ghost.py, three 8-device subprocesses one after another):
``plan_sharded_msf`` with ``pallas_minedges=False`` (its kernel path
does not run under this JAX, ROADMAP.md queue 3) on gnm and rgg2d at
n = 512, average degree 8, seed 7, with both algorithms, and a grid plan
on a ``(4, 2)`` mesh (``ghost_push="grid"``, gnm, boruvka), then the
strict replay of each plan's JSON.  On the reference's slot layout the
port must measure the same JSON bytes, and its strict replay of the
reference's JSON — with ``pallas_minedges`` False and flipped to True
(K1's plain version on the CPU) — must equal the reference's replay on
every output and ``CommStats`` field; its mask must equal its driven
solve's and its edge set Kruskal's.

The rest is the port's alone, as the reference's tests/test_plan.py
checks its own: a padded replay on a graph with shuffled weights, plans
that do not fit (too few rounds, ``cap_edge=1``, a ghost table of one
entry) raising under ``replan=False`` and exact under ``replan=True``,
the shape checks, and ``make_sharded_mst_step``.
"""
import inspect
import json
import math
import warnings

import numpy as np
import pytest
import torch

import repro.core.plan as jax_plan
import repro_torch.core.plan as port_plan
from repro.core import oracle
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import DistGraph, build_dist_graph
from repro_torch.core.graph import from_numpy
from repro_torch.core.mst import minimum_spanning_forest
from tests.helpers import graph_families
from tests.test_torch_ghost import (STATS, _check_exact, make_graph,
                                    reference, run_key)
from tests.test_torch_sharded_levers import _assert_same

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
INF = math.inf

# ---------------------------------------------------------------------------
# the plan module, in process
# ---------------------------------------------------------------------------


def _toy(mod, ghost=True, levels=1, rounds_per_level=3, grid=False,
         pallas=False):
    """A hand-made plan built from ``mod``'s classes."""
    specs = tuple(
        mod.RoundSpec(level=lvl, cap_edge=32 >> r, cap_lookup=16,
                      cap_contract=8, cap_relabel=64, cap_push=4 + r,
                      ghost=ghost, sentinel=(r == rounds_per_level - 1),
                      cap_push_col=(24 >> r) if grid else 0)
        for lvl in range(levels) for r in range(rounds_per_level))
    bounds = [(-INF, INF)]
    if levels > 1:
        cuts = [0.5 * i - 0.125 for i in range(1, levels)]
        bounds = list(zip([-INF] + cuts, cuts + [INF]))
    return mod.RoundPlan(
        n=512, num_shards=8, cap_per_shard=100, algorithm="boruvka"
        if levels == 1 else "filter_boruvka",
        schedule="grid", local_preprocessing=True, coalesce=True,
        src_only=True, adaptive_doubling=True, relabel_skip=True,
        vsorted_index=True, cap_prep=64, edge_capacity_full=100,
        label_capacity_full=64, lookup_capacity_full=77,
        ghost=mod.GhostPlan(40, 33, 16, 13, 29) if ghost else None,
        level_bounds=tuple(bounds), rounds=specs, pallas_minedges=pallas,
        grid_push=grid)


TOYS = {
    "cached": dict(),
    "no_cache": dict(ghost=False),
    "levels3": dict(levels=3),
    "levels3_no_cache": dict(levels=3, ghost=False, rounds_per_level=1),
    "grid": dict(grid=True, pallas=True),
}


@pytest.mark.parametrize("toy", sorted(TOYS))
def test_to_json_bytes_match_reference(toy):
    jp, tp = _toy(jax_plan, **TOYS[toy]), _toy(port_plan, **TOYS[toy])
    assert tp.to_json() == jp.to_json()
    assert tp.to_json(indent=2) == jp.to_json(indent=2)
    d = json.loads(tp.to_json())
    assert next(iter(d)) == "version" and d["version"] == 1
    if toy.startswith("levels3"):
        assert d["level_bounds"][0][0] == "-inf"
        assert d["level_bounds"][-1][1] == "inf"


@pytest.mark.parametrize("toy", sorted(TOYS))
def test_from_json_cross_loads(toy):
    jp, tp = _toy(jax_plan, **TOYS[toy]), _toy(port_plan, **TOYS[toy])
    back = port_plan.RoundPlan.from_json(jp.to_json())
    assert back == tp and isinstance(back, port_plan.RoundPlan)
    assert isinstance(back.rounds[0], port_plan.RoundSpec)
    assert jax_plan.RoundPlan.from_json(tp.to_json()) == jp
    assert back.num_rounds == jp.num_rounds
    # version-1 JSON from before the trailing levers still loads
    d = json.loads(jp.to_json())
    for k in ("pallas_minedges", "grid_push"):
        d.pop(k)
    for r in d["rounds"]:
        r.pop("cap_push_col")
    old = json.dumps(d)
    assert (port_plan.RoundPlan.from_json(old).to_json()
            == jax_plan.RoundPlan.from_json(old).to_json())


def _broken(mod):
    plan = _toy(mod, levels=2)
    r = plan.rounds
    return {
        "level_without_rounds": plan._replace(
            rounds=tuple(x for x in r if x.level == 0)),
        "cap_edge_0": plan._replace(rounds=(r[0]._replace(cap_edge=0),)
                                    + r[1:]),
        "cap_push_0": plan._replace(rounds=r[:-1]
                                    + (r[-1]._replace(cap_push=0),)),
        "not_grouped": plan._replace(rounds=r[::-1]),
        "no_rounds": plan._replace(rounds=()),
        "no_levels": plan._replace(level_bounds=()),
        "n_0": plan._replace(n=0),
        "ghost_0": plan._replace(ghost=plan.ghost._replace(cap_fill_v=0)),
    }


@pytest.mark.parametrize("case", sorted(_broken(port_plan)))
def test_validate_rejects_the_same_plans(case):
    with pytest.raises(ValueError) as jexc:
        _broken(jax_plan)[case].validate()
    with pytest.raises(ValueError) as texc:
        _broken(port_plan)[case].validate()
    assert str(texc.value) == str(jexc.value)
    assert "version" in str(pytest.raises(
        ValueError, port_plan.RoundPlan.from_json, '{"version": 7}').value)


@pytest.mark.parametrize("margin", [0.0, 0.25, 0.5, 1.0])
def test_pad_matches_reference(margin):
    for kw in TOYS.values():
        jp, tp = _toy(jax_plan, **kw), _toy(port_plan, **kw)
        assert tp.pad(margin).to_json() == jp.pad(margin).to_json(), kw
    with pytest.raises(ValueError):
        _toy(port_plan).pad(-0.1)


@pytest.mark.parametrize("family", [None, "gnm", "rgg2d"])
def test_synthetic_plan_matches_reference(family):
    for n, cap_total, p in ((1 << 12, 8 * 4096, 8), (512, 8 * 100, 8),
                            (1000, 3 * 700, 3), (7, 16, 4), (1, 1, 1)):
        kw = dict(family=family, algorithm="filter_boruvka",
                  local_preprocessing=False)
        assert (port_plan.synthetic_plan(n, cap_total, p, **kw).to_json()
                == jax_plan.synthetic_plan(n, cap_total, p, **kw).to_json())
    with pytest.raises(ValueError, match="no calibrated decay model"):
        port_plan.synthetic_plan(512, 800, 8, family="rmat")


def test_plan_cache_key_matches_reference():
    levers = ("local_preprocessing", "coalesce", "src_only",
              "adaptive_doubling", "relabel_skip", "vsorted_index",
              "pallas_minedges", "grid_push")
    for i, off in enumerate((None,) + levers):
        kw = {} if off is None else {off: off in ("pallas_minedges",
                                                  "grid_push")}
        args = ("gnm", 512 + i, 8, 128, "filter_boruvka")
        assert (port_plan.plan_cache_key(*args, schedule="direct", **kw)
                == jax_plan.plan_cache_key(*args, schedule="direct", **kw))
    for kw in TOYS.values():
        assert (_toy(port_plan, **kw).cache_key("rgg2d")
                == _toy(jax_plan, **kw).cache_key("rgg2d"))


# ---------------------------------------------------------------------------
# measured plans and strict replays against the reference
# ---------------------------------------------------------------------------

ALGOS = ("boruvka", "filter_boruvka")
RUNS = ([(g, (8,), a, "defaults") for g in ("gnm:512", "rgg2d:512")
         for a in ALGOS]
        + [("gnm:512", (4, 2), "boruvka", "push_grid")])
# the costlier filter_boruvka replays apart, the grid plan on its own
GROUPS = [[RUNS[0], RUNS[3]], [RUNS[1], RUNS[2]], [RUNS[4]]]

PLAN_REFERENCE = inspect.getsource(graph_families) + """
import json
import math
from jax.sharding import Mesh
from repro.core.distributed import build_dist_graph
from repro.core.distributed_sharded import execute_plan, plan_sharded_msf
from repro.core.plan import RoundPlan

out = {}
for gname, layout, algo, row in RUNS:
    p = math.prod(layout)
    u, v, w, n = make_graph(gname)
    g = build_dist_graph(u, v, w, n, p)[0]
    for k, x in (("u", u), ("v", v), ("w", w), ("n", n)):
        out[f"{gname}/raw_{k}"] = np.asarray(x)
    for k in ("u", "v", "w", "eid"):
        out[f"{gname}/{p}/g_{k}"] = np.asarray(getattr(g, k))
    devs = np.array(jax.devices()[:p])
    if len(layout) == 1:
        mesh, ax = Mesh(devs, ("data",)), ("data",)
    else:
        mesh, ax = Mesh(devs.reshape(layout), ("row", "col")), ("row", "col")
    plan = plan_sharded_msf(g, n, mesh, axis_names=ax, algorithm=algo,
                            pallas_minedges=False, **ROWS[row])
    text = plan.to_json()
    trace = []
    res = execute_plan(g, n, mesh, RoundPlan.from_json(text), axis_names=ax,
                       replan=False, round_trace=trace)
    prefix = run_key(gname, layout, algo, row)
    out[prefix + "plan"] = np.asarray(text)
    for nm, x in zip(("mask", "weight", "count", "labels", "overflow"),
                     res[:5]):
        out[prefix + nm] = np.asarray(x)
    for f in STATS:
        out[prefix + "stat_" + f] = np.asarray(getattr(res[5], f))
    out[prefix + "trace"] = np.asarray(json.dumps(trace))
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("jax_reference_plan"), GROUPS,
                     PLAN_REFERENCE)


def _layout(ref, run):
    """(graph, n, num_shards) of the reference's slot layout of ``run``."""
    gname, layout, _, _ = run
    p = math.prod(layout)
    g = DistGraph.from_numpy(*(ref[f"{gname}/{p}/g_{k}"]
                               for k in ("u", "v", "w", "eid")), device=CPU)
    return g, int(ref[f"{gname}/raw_n"]), layout if len(layout) > 1 else p


def _levers(run):
    return dict(ghost_push="grid") if run[3] == "push_grid" else {}


def _ref_plan(ref, run) -> str:
    return str(ref[run_key(*run) + "plan"])


@pytest.mark.parametrize("pallas_minedges", [False, True])
@pytest.mark.parametrize("run", RUNS, ids=[run_key(*r) for r in RUNS])
def test_measured_plan_bytes_match_reference(ref, run, pallas_minedges):
    g, n, shards = _layout(ref, run)
    trace = []
    plan = ds.plan_sharded_msf(g, n, shards, algorithm=run[2],
                               pallas_minedges=pallas_minedges,
                               round_trace=trace, **_levers(run))
    exp = port_plan.RoundPlan.from_json(_ref_plan(ref, run))
    assert plan.to_json() == exp._replace(
        pallas_minedges=pallas_minedges).to_json()
    # the driven rounds are the plan's, less the sentinels it skipped
    assert len(trace) == sum(not r.sentinel for r in plan.rounds)
    assert plan.ghost is not None
    assert plan.grid_push == (run[3] == "push_grid")


@pytest.mark.parametrize("pallas_minedges", [False, True])
@pytest.mark.parametrize("run", RUNS, ids=[run_key(*r) for r in RUNS])
def test_strict_replay_matches_reference(ref, run, pallas_minedges):
    g, n, shards = _layout(ref, run)
    plan = port_plan.RoundPlan.from_json(_ref_plan(ref, run))._replace(
        pallas_minedges=pallas_minedges)
    trace = []
    res = ds.execute_plan(g, n, shards, plan, replan=False,
                          round_trace=trace)
    _assert_same(ref, run_key(*run), res, trace)
    assert trace == [] and int(res[5].rounds) == plan.num_rounds
    _check_exact(ref, run[0], res, g)
    driven = ds.distributed_sharded_msf(g, n, shards, algorithm=run[2],
                                        pallas_minedges=pallas_minedges,
                                        **_levers(run))
    assert torch.equal(res[0], driven[0])
    assert torch.equal(res[3], driven[3])


# ---------------------------------------------------------------------------
# the port's own replay contract
# ---------------------------------------------------------------------------

P = 8


def _port_graph(fam="rgg2d", w_seed=None, shards=P):
    """The port's layout of a reference-test graph, optionally with its
    weights shuffled by ``default_rng(w_seed)``.  Returns (graph, n,
    Kruskal's eid set)."""
    u, v, w, n = make_graph(f"{fam}:512")
    if w_seed is not None:
        w = np.asarray(w).copy()
        np.random.default_rng(w_seed).shuffle(w)
    g, _ = build_dist_graph(u, v, w, n, math.prod(ds.shard_layout(shards)),
                            device=CPU)
    return g, n, np.nonzero(oracle.kruskal(u, v, w, n)[0])[0]


def _eids(g, mask):
    return np.unique(g.eid.numpy()[mask.numpy()])


def test_padded_replay_on_a_shuffled_twin_is_exact():
    """The same u, v with shuffled weights: another MSF and another merge
    order.  The padded plan fits or replans, never a wrong forest."""
    g, n, _ = _port_graph()
    plan = ds.plan_sharded_msf(g, n, P)
    g2, _, ksel2 = _port_graph(w_seed=1)
    assert g2.cap_total == g.cap_total
    res = ds.execute_plan(g2, n, P, plan.pad(0.5), replan=True)
    assert int(res[4]) == 0
    np.testing.assert_array_equal(_eids(g2, res[0]), ksel2)


def _unfit(plan, kind):
    if kind == "short":
        # each level cut to its first two rounds, and short of its last
        levels = [[r for r in plan.rounds if r.level == lvl]
                  for lvl in range(len(plan.level_bounds))]
        return plan._replace(rounds=tuple(
            r for rs in levels for r in rs[:max(1, min(2, len(rs) - 1))]
        )).validate()
    if kind == "cap_edge_1":
        return plan._replace(rounds=tuple(r._replace(cap_edge=1)
                                          for r in plan.rounds))
    return plan._replace(ghost=plan.ghost._replace(table_u=1))


@pytest.mark.parametrize("kind,match", [
    ("short", "residual levels=[1-9]"),
    ("cap_edge_1", "overflow=[1-9]"),
    ("table_u_1", "overflow=[1-9]")], ids=["short", "cap_edge_1",
                                           "table_u_1"])
@pytest.mark.parametrize("algorithm", ALGOS)
def test_unfit_plans_are_never_silent(kind, match, algorithm):
    g, n, ksel = _port_graph("gnm")
    driven = ds.distributed_sharded_msf(g, n, P, algorithm=algorithm)
    plan = _unfit(ds.plan_sharded_msf(g, n, P, algorithm=algorithm), kind)
    with pytest.raises(RuntimeError, match=match):
        ds.execute_plan(g, n, P, plan, replan=False)
    trace = []
    res = ds.execute_plan(g, n, P, plan, replan=True, round_trace=trace)
    assert int(res[4]) == 0
    assert torch.equal(res[0], driven[0])
    np.testing.assert_array_equal(_eids(g, res[0]), ksel)
    # the replan is a driven pass, so it fills the trace
    assert len(trace) == int(res[5].rounds) > 0


def test_ghost_table_guard_counts_the_excess():
    """A table of one entry: the overflow is at least the runs it lacks
    on the fullest shard."""
    g, n, _ = _port_graph()
    plan = ds.plan_sharded_msf(g, n, P)
    small = plan._replace(ghost=plan.ghost._replace(table_u=1, table_v=2))
    out = ds._run_plan(g, n, (P,), small)
    need = (plan.ghost.table_u - 1) + (plan.ghost.table_v - 2)
    assert int(out[4]) >= need > 0
    assert int(ds._run_plan(g, n, (P,), plan)[4]) == 0


def test_plan_shape_and_layout_are_checked():
    g, n, _ = _port_graph("gnm")
    plan = ds.plan_sharded_msf(g, n, P)
    for bad in (dict(n=n + 1), dict(num_shards=4), dict(cap_per_shard=7)):
        with pytest.raises(ValueError, match="plans only transfer"):
            ds.execute_plan(g, n, P, plan._replace(**bad))
    g4, _, _ = _port_graph("gnm", shards=4)
    with pytest.raises(ValueError, match="plans only transfer"):
        ds.distributed_sharded_msf(g4, n, 4, plan=plan)
    with pytest.raises(ValueError, match="rounds"):
        ds.execute_plan(g, n, P, plan._replace(rounds=()))
    grid = ds.plan_sharded_msf(g, n, (4, 2), ghost_push="grid")
    assert grid.grid_push and all(r.cap_push_col > 0 for r in grid.rounds
                                  if not r.sentinel)
    with pytest.raises(ValueError, match="needs an \\(R, C\\) layout"):
        ds.execute_plan(g, n, P, grid)
    res = ds.execute_plan(g, n, (4, 2), grid, replan=False)
    assert torch.equal(res[0], ds.distributed_sharded_msf(
        g, n, (4, 2), ghost_push="grid")[0])
    # without the cache the grid push is not a plan bit
    assert not ds.plan_sharded_msf(g, n, (4, 2), ghost_push="grid",
                                   ghost_cache=False).grid_push


def test_plan_measurement_refuses_a_lossy_pass():
    g, n, _ = _port_graph("gnm")
    with pytest.raises(RuntimeError, match="measurement pass overflowed"):
        ds.plan_sharded_msf(g, n, P, edge_capacity=1)


def test_replay_boundaries_raise_naming_their_item():
    """The replay's verify and checkpoint arguments run; beside ``plan=``
    the checkpoint arguments still raise, pointing at execute_plan."""
    g, n, _ = _port_graph("gnm")
    plan = ds.plan_sharded_msf(g, n, P)
    base = ds.execute_plan(g, n, P, plan, replan=False)
    res = ds.execute_plan(g, n, P, plan, replan=False, verify=True)
    for a, b in zip(res[:5], base[:5]):
        assert torch.equal(a, b)
    cks = []
    res = ds.execute_plan(g, n, P, plan, replan=False, ckpt_every=2,
                          ckpt_out=cks)
    assert torch.equal(res[0], base[0]) and torch.equal(res[3], base[3])
    assert [c.plan_pos for c in cks] == list(range(2, plan.num_rounds, 2))
    res = ds.execute_plan(g, n, P, plan, replan=False, resume_from=cks[-1])
    assert torch.equal(res[0], base[0]) and int(res[2]) == int(base[2])
    for ckpt in (dict(ckpt_every=2), dict(ckpt_out=[]),
                 dict(resume_from=cks[0])):
        with pytest.raises(ValueError, match="execute_plan"):
            ds.distributed_sharded_msf(g, n, P, plan=plan, **ckpt)


def test_make_sharded_mst_step():
    g, n, _ = _port_graph()
    cap_total = g.cap_total
    with pytest.raises(ValueError, match="plan"):
        ds.make_sharded_mst_step(n, cap_total, P, shrink_capacities=True)
    with pytest.warns(UserWarning, match="flat-capacity"):
        step, specs = ds.make_sharded_mst_step(n, cap_total, P)
    assert specs == (((cap_total,), torch.int32), ((cap_total,), torch.int32),
                     ((cap_total,), torch.float32),
                     ((cap_total,), torch.int32))
    flat = step(*g)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the explicit opt-out is silent
        step, _ = ds.make_sharded_mst_step(n, cap_total, P,
                                           shrink_capacities=False)
    assert torch.equal(step(*g)[0], flat[0])
    plan = ds.plan_sharded_msf(g, n, P)
    for bad in (dict(n=n + 1), dict(cap_total=cap_total + P),
                dict(num_shards=4)):
        kw = dict(dict(n=n, cap_total=cap_total, num_shards=P), **bad)
        with pytest.raises(ValueError, match="shape"):
            ds.make_sharded_mst_step(plan=plan, **kw)
    step, _ = ds.make_sharded_mst_step(n, cap_total, P, plan=plan)
    out = step(*g)
    assert len(out) == 6 and int(out[4]) == 0
    assert torch.equal(out[0], flat[0])
    # a short plan's step reports the residual as overflow, and does not
    # replan: it ran the plan's two rounds
    sstep, _ = ds.make_sharded_mst_step(n, cap_total, P,
                                        plan=_unfit(plan, "short"))
    sout = sstep(*g)
    assert int(sout[4]) > 0 and int(sout[5].rounds) == 2


@pytest.mark.parametrize("algorithm", ALGOS)
def test_public_api_replays_a_plan(algorithm):
    """``minimum_spanning_forest(plan=...)`` reaches the executor through
    the dispatch, which builds the layout the plan was measured on."""
    u, v, w, n = make_graph("rgg2d:512")
    g, _ = build_dist_graph(u, v, w, n, P, device=CPU)
    plan = ds.plan_sharded_msf(g, n, P, algorithm=algorithm)
    kmask, kweight = oracle.kruskal(u, v, w, n)
    calls = []
    run_plan = ds._run_plan

    def spy(*args):
        calls.append(args[-1])
        return run_plan(*args)

    ds._run_plan = spy
    try:
        mask, wt = minimum_spanning_forest(
            from_numpy(u, v, w, n, device=CPU), algorithm=algorithm,
            engine="distributed_sharded", num_shards=P, plan=plan,
            replan=False)
    finally:
        ds._run_plan = run_plan
    assert calls == [plan]
    np.testing.assert_array_equal(mask.numpy(), kmask)
    assert abs(float(wt) - kweight) < 1e-3 * max(1.0, kweight)


def test_plan_measured_by_the_port_replays_in_the_port_on_both_paths():
    """The port's plan JSON, replayed strictly with K1's path and the
    plain scatters, gives equal outputs and the driven mask."""
    g, n, ksel = _port_graph("gnm")
    plan = port_plan.RoundPlan.from_json(ds.plan_sharded_msf(
        g, n, P, algorithm="filter_boruvka").to_json())
    a = ds.execute_plan(g, n, P, plan, replan=False)
    b = ds.execute_plan(g, n, P, plan._replace(pallas_minedges=True),
                        replan=False)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    for f in STATS:
        assert torch.equal(getattr(a[5], f), getattr(b[5], f)), f
    np.testing.assert_array_equal(_eids(g, a[0]), ksel)
