"""The port's span-and-counter recorder (``repro_torch.tracing``): off by
default and then free of records, events and allocations; on, nested
spans on ``time.time_ns()`` and counters; and every answer of the
static and sharded engines the same with it on and off."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import distributed_sharded as ds
from repro_torch.core.boruvka import boruvka_msf
from repro_torch.core.distributed import build_dist_graph
from repro_torch.core.filter_boruvka import filter_boruvka_msf
from repro_torch.core.graph import EdgeList
from repro_torch.core.mst import minimum_spanning_forest
from repro_torch.data import generators

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def _no_event(*a, **kw):
    raise AssertionError("torch.cuda.Event called while tracing is off")


def _rmat(scale=9, seed=3):
    u, v, w, n = generators.rmat(scale, 16 << scale, seed=seed)
    return (torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(w),
            n)


def test_off_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    cuda = torch.device("cuda")
    assert tracing.span("x") is tracing.OFF
    assert tracing.span("y", cuda) is tracing.span("z", CPU) is tracing.OFF
    with tracing.span("x", cuda):
        tracing.count("n", 5)
    u, v, w, n = _rmat(7)
    boruvka_msf(u, v, w, n)
    filter_boruvka_msf(u, v, w, n)
    trace = tracing.disable()
    assert trace.records == [] and trace.events == {}
    assert trace.counters == {}
    assert tracing._REC.trace.records == []


def test_on_records_nested_spans_and_counters(monkeypatch):
    clock = iter(range(100, 10_000, 10))
    monkeypatch.setattr(tracing.time, "time_ns", lambda: next(clock))
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            tracing.count("k")
        with tracing.span("outer"):  # one label nested in itself
            tracing.count("k", 2)
    tracing.enable()  # on already: keeps what it holds
    with tracing.span("cpu", CPU):  # no card: no events
        pass
    trace = tracing.disable()
    assert trace.records == [("inner", 110, 120), ("outer", 130, 140),
                             ("outer", 100, 150), ("cpu", 160, 170)]
    assert trace.counters == {"k": 3} and trace.events == {}
    assert tracing.disable().records == []  # off: an empty trace
    tracing.enable()  # a fresh stretch starts empty
    assert tracing.disable().records == []


def test_device_span_records_an_event_pair(monkeypatch):
    recorded = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream=None):
            recorded.append((self, stream))

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("s", d))
    monkeypatch.setattr(tracing.time, "time_ns", lambda: 7)
    cuda = torch.device("cuda")
    tracing.enable()
    with tracing.span("k", cuda):
        pass
    trace = tracing.disable()
    (t0, start, end), = trace.events["k"]
    assert t0 == 7 and [e for e, _ in recorded] == [start, end]
    assert all(s == ("s", cuda) for _, s in recorded)
    assert trace.records == [("k", 7, 7)]


def _within(inner, outers):
    return all(any(o0 <= i0 and i1 <= o1 for o0, o1 in outers)
               for i0, i1 in inner)


@pytest.mark.parametrize("solver", ["boruvka", "filter_boruvka"])
def test_static_engine_same_with_tracing_on(solver):
    fn = boruvka_msf if solver == "boruvka" else filter_boruvka_msf
    u, v, w, n = _rmat()
    mask0, lab0 = fn(u, v, w, n)
    tracing.enable()
    mask1, lab1 = fn(u, v, w, n)
    trace = tracing.disable()
    assert torch.equal(mask0, mask1) and torch.equal(lab0, lab1)
    by = {}
    for label, t0, t1 in trace.records:
        by.setdefault(label, []).append((t0, t1))
    assert len(by["static.solve"]) == 1
    rounds = trace.counters["static.rounds"]
    assert rounds >= 2
    for label in ("static.round", "static.minedges", "static.contract",
                  "static.relabel", "static.sync"):
        assert len(by[label]) == rounds, label
        assert _within(by[label], by["static.solve"])
    for label in ("static.minedges", "static.contract", "static.relabel",
                  "static.sync"):
        assert _within(by[label], by["static.round"]), label
    assert len(by.get("static.sort", ())) == (2 if solver != "boruvka"
                                              else 0)
    assert trace.events == {}  # on the CPU no span is timed on a card


@pytest.mark.parametrize("algorithm", ["boruvka", "filter_boruvka"])
def test_sharded_engine_same_with_tracing_on(algorithm, monkeypatch):
    """The public API at p = 4 and the engine's whole 6-tuple (overflow
    and ``CommStats`` included), with the recorder off and on; on, one
    ``host_bounds`` span per round's bounds plus the solve's set-up and
    the ghost cache's."""
    u, v, w, n = generators.gnm(256, 1024, seed=5)
    edges = EdgeList(*(torch.from_numpy(x) for x in (u, v, w)), n)
    caps = []
    real_caps = ds._host_round_caps
    monkeypatch.setattr(ds, "_host_round_caps",
                        lambda *a, **kw: caps.append(1) or real_caps(*a,
                                                                     **kw))

    def solve():
        rt = []
        mask, weight = minimum_spanning_forest(
            edges, engine="distributed_sharded", num_shards=4,
            algorithm=algorithm, round_trace=rt)
        g, _ = build_dist_graph(u, v, w, n, 4, device=CPU)
        res = ds.distributed_sharded_msf(g, n, 4, algorithm=algorithm)
        return mask, weight, rt, res

    off = solve()
    caps.clear()
    tracing.enable()
    on = solve()
    trace = tracing.disable()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert off[2] == on[2] and len(on[2]) >= 2
    for a, b in zip(off[3][:5] + tuple(off[3][5]),
                    on[3][:5] + tuple(on[3][5])):
        assert torch.equal(a, b)
    labels = [r[0] for r in trace.records]
    assert labels.count("layout") == 2
    assert labels.count("host_bounds") == len(caps) + 2 * 2
    assert len(caps) >= 2 * len(on[2])
    assert labels.count("sharded.sync") > 2 * len(on[2])
    assert trace.events == {}


def test_layout_span_and_copies_counter():
    """One build of m edges: one ``layout`` span and 2m ``layout.copies``
    with the recorder on; nothing with it off."""
    u, v, w = generators.gnm(64, 300, seed=2)[:3]
    build_dist_graph(u, v, w, 64, 3, device=CPU)
    assert tracing.disable().records == []
    tracing.enable()
    build_dist_graph(u, v, w, 64, 3, device=CPU)
    trace = tracing.disable()
    assert [r[0] for r in trace.records] == ["layout"]
    assert trace.counters == {"layout.copies": 2 * len(u)}
    assert trace.events == {}


@pytest.mark.cuda
def test_cuda_layout_matches_cpu_and_is_timed_on_the_card():
    """The layout built on the card (CUB's radix sorts at this size) is
    the CPU build's slot for slot, signed zeros and ties included, and
    its ``layout`` span carries a CUDA event pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(11)
    n, m = 1 << 12, 1 << 15
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = rng.choice(np.array([-0.0, 0.0, 1.0, np.inf, -np.inf], np.float32),
                   m)
    for p in (1, 8):
        cg, ccap = build_dist_graph(u, v, w, n, p, device=CPU)
        tracing.enable()
        dg, dcap = build_dist_graph(torch.from_numpy(u).cuda(),
                                    torch.from_numpy(v).cuda(),
                                    torch.from_numpy(w).cuda(), n, p,
                                    device="cuda")
        trace = tracing.disable()
        assert dcap == ccap
        for k, a, b in zip(cg._fields, cg, dg):
            assert b.device.type == "cuda" and b.dtype == a.dtype, k
            assert torch.equal(a.view(torch.int32),
                               b.cpu().view(torch.int32)), (p, k)
        (_, start, end), = trace.events["layout"]
        torch.cuda.synchronize()
        assert start.elapsed_time(end) > 0
        assert trace.counters == {"layout.copies": 2 * m}
