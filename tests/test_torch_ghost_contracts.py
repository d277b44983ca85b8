"""The ghost cache's push ladder and contracts, the port against the JAX
reference.

The module-scoped fixture runs the reference (the runner of
tests/test_torch_ghost.py) over the runs of the reference's ghost
tests: the flat/grid/auto push and the ``ghost_shard_limit`` ladder on a
``(4, 2)`` layout (``SHARDED_GRID_PUSH`` of
tests/test_engine_equivalence.py, without plans), the cache-free engine
on ``(4, 2)``, the ghost runs of ``GHOST_CACHE``
(tests/test_distributed_sharded.py) and the p = 32 cell of
``SHARDED_GRID_P32`` on ``(8, 4)`` (32 virtual devices).  The port must
reproduce each run bit for bit.  The other runs of those tests are the
port's alone, to hold its runs to each other: the cache-free engine
(held to the reference in tests/test_torch_sharded_levers.py), and
settings that resolve to a path already run (a shard limit that picks a
rung, the flat push where the auto ladder picks it).  Then each
contract of the reference's tests is checked on the port's results.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_ghost import (ALGOS, STATS, _assert_same,
                                    _check_exact, _solve, reference,
                                    run_key)

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

LADDER_FAMILIES = ("random", "dup_weights", "disconnected")
RGG = "rgg2d:512"
ONE_AXIS_AND_GRID = (
    [(RGG, (8,), "boruvka", r)
     for r in ("defaults", "push1_flat", "push1", "lookup1_flat")]
    + [("settle", (8,), "boruvka", "defaults"),
       ("random", (4, 2), "boruvka", "defaults")]
    + [(f, (4, 2), "boruvka", "push_grid") for f in LADDER_FAMILIES]
    + [("random:1", (4, 2), "boruvka", "limit7")]
    + [("clustered", (4, 2), a, r) for a in ALGOS
       for r in ("grid_flat", "no_ghost")])
GROUPS = [ONE_AXIS_AND_GRID[0::2], ONE_AXIS_AND_GRID[1::2],
          [("rgg2d:1024", (8, 4), "boruvka", "defaults")]]
RUNS = [run for group in GROUPS for run in group]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("jax_reference_ghost_contracts"),
                     GROUPS)


def _same_results(a, b):
    """Two of the port's runs agree on every output and trace row."""
    (ra, ta), (rb, tb) = a, b
    for x, y in zip(ra[:5], rb[:5]):
        assert torch.equal(x, y)
    for f in STATS:
        assert torch.equal(getattr(ra[5], f), getattr(rb[5], f)), f
    assert ta == tb


@pytest.mark.parametrize("pallas_minedges", [False, True])
@pytest.mark.parametrize("run", RUNS, ids=[run_key(*r) for r in RUNS])
def test_contract_runs_match_reference(ref, run, pallas_minedges):
    res, trace, g = _solve(ref, *run, pallas_minedges=pallas_minedges)
    _assert_same(ref, run_key(*run), res, trace)
    if run[3] not in ("push1_flat", "lookup1_flat"):
        _check_exact(ref, run[0], res, g)


@pytest.mark.parametrize("family", LADDER_FAMILIES)
def test_flat_and_grid_push_agree(ref, family):
    """``SHARDED_GRID_PUSH``: on (4, 2) the auto, flat and grid pushes
    give one mask, the oracle's; the grid rounds say so in the trace.
    The auto ladder picks the flat push here, so ``ghost_push="flat"``
    is the same run."""
    runs = {}
    for row in ("defaults", "push_flat", "push_grid"):
        res, trace, g = _solve(ref, family, (4, 2), "boruvka", row)
        _check_exact(ref, family, res, g)
        runs[row] = (res, trace)
        assert trace and all(t["ghost"] for t in trace)
        assert all(t["grid_push"] == (row == "push_grid") for t in trace)
        assert all((t["cap_push_col"] > 0) == (row == "push_grid")
                   for t in trace)
    _same_results(runs["defaults"], runs["push_flat"])
    assert torch.equal(runs["defaults"][0][0], runs["push_grid"][0][0])


def test_shard_limit_ladder(ref):
    """``ghost_shard_limit`` on (4, 2): 31 takes the flat push, 7 the
    grid push, 1 no cache — one mask, the oracle's."""
    base = None
    for row, hits, grid in (("limit31", True, False), ("limit7", True, True),
                            ("limit1", False, False)):
        res, trace, g = _solve(ref, "random:1", (4, 2), "boruvka", row)
        _check_exact(ref, "random:1", res, g)
        base = res[0] if base is None else base
        assert torch.equal(res[0], base), row
        assert (float(res[5].hits) > 0) == hits, row
        assert any(t["grid_push"] for t in trace) == grid, row


def test_ghost_cache_cuts_lookups_and_push_decays(ref):
    """``GHOST_CACHE`` (1) and (2): the cache keeps the result, serves
    hits, and ships less than the lookups it replaces; every round is a
    ghost round and the push decays."""
    gres, trace, g = _solve(ref, RGG, (8,), "boruvka", "defaults")
    cres, _, _ = _solve(ref, RGG, (8,), "boruvka", "no_ghost")
    _check_exact(ref, RGG, gres, g)
    assert torch.equal(gres[0], cres[0])
    gst, cst = gres[5], cres[5]
    assert float(gst.hits) > 0 and float(gst.pushed) > 0
    assert float(cst.hits) == 0 and float(cst.pushed) == 0
    assert float(gst.misses) + float(gst.pushed) < float(cst.misses)
    assert all(t["ghost"] for t in trace)
    pushes = [t["pushed_items"] for t in trace]
    assert pushes[-1] < pushes[0], pushes


def test_settled_vertices_shrink_relabel(ref):
    """``GHOST_CACHE`` (2b): with most components done after round 1 the
    RELABEL capacity drops below vps, the cache on."""
    res, trace, g = _solve(ref, "settle", (8,), "boruvka", "defaults")
    _check_exact(ref, "settle", res, g)
    caps = [t["cap_relabel"] for t in trace]
    assert len(caps) >= 2 and caps[-1] < -(-212 // 8), caps


def test_pinned_push_capacity(ref):
    """``GHOST_CACHE`` (3) and (4): push capacity 1 overflows in the fused
    engine, reported; the driver drops the cache and stays exact, with
    no ghost round in its trace."""
    res, _, _ = _solve(ref, RGG, (8,), "boruvka", "push1_flat")
    assert int(res[4]) > 0
    res, trace, g = _solve(ref, RGG, (8,), "boruvka", "push1")
    cres, _, _ = _solve(ref, RGG, (8,), "boruvka", "no_ghost")
    _check_exact(ref, RGG, res, g)
    assert torch.equal(res[0], cres[0])
    assert trace and not any(t["ghost"] for t in trace)


def test_undersized_fill_overflows(ref):
    """``GHOST_CACHE`` (5): lookup capacity 1 starves the ghost fills,
    reported as overflow."""
    res, _, _ = _solve(ref, RGG, (8,), "boruvka", "lookup1_flat")
    assert int(res[4]) > 0


@pytest.mark.parametrize("flat", [False, True])
def test_shard_limit_below_p_turns_the_cache_off(ref, flat):
    """``GHOST_LIMIT``: a limit below p runs exactly as
    ``ghost_cache=False`` on both engines — every output, no hits or
    pushes; a limit of p keeps the cache."""
    sfx = "_flat" if flat else ""
    off, off_trace, g = _solve(ref, RGG, (8,), "boruvka", "no_ghost" + sfx)
    lim, lim_trace, _ = _solve(ref, RGG, (8,), "boruvka", "limit4" + sfx)
    _check_exact(ref, RGG, lim, g)
    _same_results((lim, lim_trace), (off, off_trace))
    assert float(lim[5].hits) == 0 and float(lim[5].pushed) == 0
    on, on_trace, _ = _solve(ref, RGG, (8,), "boruvka", "limit8")
    assert float(on[5].hits) > 0
    _same_results((on, on_trace),
                  _solve(ref, RGG, (8,), "boruvka", "defaults")[:2])


def test_p32_takes_the_grid_rung(ref):
    """``SHARDED_GRID_P32``: 32 shards on (8, 4) are too many for one
    mask, so the auto ladder takes the grid push and the cache stays
    live; exact."""
    res, trace, g = _solve(ref, "rgg2d:1024", (8, 4), "boruvka",
                           "defaults")
    _check_exact(ref, "rgg2d:1024", res, g)
    assert float(res[5].hits) > 0
    assert trace and all(t["grid_push"] for t in trace)
    assert np.all([t["cap_push_col"] > 0 for t in trace])
