"""The sharded engine's local-preprocessing span and counters
(``sharded.prep``, ``prep.rounds``, ``prep.forest_edges``,
``sharded.forest_edges``) on every path that preprocesses: the
shrinking-capacity solve, the fused engine, the planned replay and its
checkpointed segments.  Each answer is the same with the recorder on
and off; on, one span a solve, the counters equal
``_sharded_preprocess``'s own ``pre_mst`` slots and the returned mask's
count; off, nothing."""
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.distributed import build_dist_graph
from repro_torch.comm.exchange import ExchangeStats
from repro_torch.data import generators

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
P = 4


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def rgg():
    u, v, w, n = generators.rgg2d(1024, 16.0, seed=4)
    g, cap = build_dist_graph(u, v, w, n, P, device=CPU)
    vps = ds.vertices_per_shard(n, P)
    x = [t.view(P, cap) for t in g]
    pre = ds._sharded_preprocess(*x, torch.isfinite(x[2]), n, vps, vps,
                                 (P,), "grid", ExchangeStats.zeros(CPU))
    plan = ds.plan_sharded_msf(g, n, P)
    return g, n, int(pre[1].sum()), plan


def _solve(path, g, n, plan):
    if path == "shrinking":
        return ds.distributed_sharded_msf(g, n, P)
    if path == "fused":
        return ds.distributed_sharded_msf(g, n, P, shrink_capacities=False)
    if path == "replay":
        return ds.execute_plan(g, n, P, plan, replan=False)
    return ds.execute_plan(g, n, P, plan, replan=False, ckpt_every=2,
                           ckpt_out=[])


@pytest.mark.parametrize("path", ["shrinking", "fused", "replay",
                                  "replay_checkpointed"])
def test_prep_span_and_counters(path, rgg):
    g, n, pre_slots, plan = rgg
    off = _solve(path, g, n, plan)
    trace = tracing.disable()
    assert trace.records == [] and trace.counters == {}
    tracing.enable()
    on = _solve(path, g, n, plan)
    trace = tracing.disable()
    for a, b in zip(off[:5], on[:5]):
        assert torch.equal(a, b)
    prep = [r for r in trace.records if r[0] == "sharded.prep"]
    assert len(prep) == 1
    c = trace.counters
    assert c["prep.rounds"] >= 2
    assert c["prep.forest_edges"] == pre_slots > 0
    assert c["sharded.forest_edges"] == int(on[0].sum()) == int(on[2])
    assert pre_slots < int(on[2])
    # the preprocessing's flag reads lie inside its span
    t0, t1 = prep[0][1:]
    syncs = [r for r in trace.records if r[0] == "sharded.sync"
             and t0 <= r[1] <= t1]
    assert len(syncs) == c["prep.rounds"]
    assert trace.events == {}
