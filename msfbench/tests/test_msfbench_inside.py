"""The readers of the program's own spans (``harness/inside.py`` and the
five metrics that use it): their arithmetic on synthetic records, None
where there is nothing to read, and a small traced run on the CPU read
beside the outside spans.  One test needs the card and skips without
it."""
import contextlib
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import msfbench  # noqa: E402
from msfbench.harness import bench, inside  # noqa: E402
from msfbench.harness.devtrace import DeviceTrace  # noqa: E402
from repro_torch import tracing  # noqa: E402

torch.set_num_threads(1)
SPAN_SHARES = {"layout_share.inside": "layout",
               "host_bounds_share.inside": "host_bounds",
               "sync_share.sharded": "sharded.sync"}
STATIC = ("minedges_share.static", "engine_idle_share.static")


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def fake_run(trace, lo=0, hi=1000, devtrace=None):
    window = SimpleNamespace(done=[object()], start_ns=lo, end_ns=hi,
                             seconds=(hi - lo) / 1e9)
    return SimpleNamespace(window=window, counters={inside.KEY: trace},
                           devtrace=devtrace, note=lambda line: None)


class FakeEvent:
    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.mark.parametrize("metric", sorted(SPAN_SHARES))
def test_span_share_is_the_union_within_the_window(metric):
    label = SPAN_SHARES[metric]
    trace = tracing.Trace(records=[
        (label, 100, 300), (label, 150, 250),  # nested: counted once
        ("other", 0, 1000), (label, 900, 1100),  # clipped at the end
        (label, -50, 50)])  # clipped at the start
    run = fake_run(trace)
    assert msfbench.by_name("metrics", metric).read(run) == pytest.approx(
        100.0 * (200 + 100 + 50) / 1000)


def test_idle_under_the_solve_by_innermost_span():
    trace = tracing.Trace(
        records=[("static.minedges", 110, 140), ("static.sync", 150, 190),
                 ("static.round", 100, 195), ("static.solve", 100, 200),
                 ("static.solve", 300, 400), ("static.sort", 310, 330)],
        counters={"static.rounds": 3})
    ops = [("k", 0, 105), ("k", 115, 135), ("k", 145, 180),
           ("k", 200, 305), ("k", 320, 500)]
    dev = SimpleNamespace(events=ops, start_ns=0, stop_ns=500,
                          window_s=500 / 1e9)
    by = inside.idle_under(trace, dev, "static.solve")
    # gaps 105-115 (minedges), 135-145 (round), 180-200 (middle 190:
    # sync's end, the round's rest), 305-320 (sort); none outside a solve
    assert by == pytest.approx({"static.minedges": 10e-9,
                                "static.round": 30e-9,
                                "static.sort": 15e-9})
    run = fake_run(trace, 0, 500, dev)
    value = msfbench.by_name("metrics", "engine_idle_share.static").read(run)
    assert value == pytest.approx(100.0 * 55 / 500)
    # never above the card's whole idle share (105 + 75 of 500 ns)
    assert value <= 100.0 * (10 + 10 + 20 + 15) / 500


def test_minedges_share_sums_the_window_event_pairs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ev = [(10, FakeEvent(0.0), FakeEvent(0.25)),
          (20, FakeEvent(1.0), FakeEvent(1.5)),
          (2000, FakeEvent(3.0), FakeEvent(4.0))]  # after the window
    trace = tracing.Trace(records=[("static.minedges", t, t + 1)
                                   for t, _, _ in ev],
                          events={"static.minedges": ev})
    run = fake_run(trace, 0, 1000)
    value = msfbench.by_name("metrics", "minedges_share.static").read(run)
    assert value == pytest.approx(100.0 * 0.75e-3 / 1e-6)


@pytest.mark.parametrize("metric", sorted(SPAN_SHARES) + list(STATIC))
@pytest.mark.parametrize("case", ["no_recorder", "no_spans", "cpu"])
def test_nothing_to_read_is_none(metric, case):
    if case == "no_recorder":
        trace = None
    elif case == "no_spans":
        trace = tracing.Trace()
    else:  # spans on the CPU: no events, no device trace
        trace = tracing.Trace(records=[(lab, 0, 10) for lab in
                                       list(SPAN_SHARES.values())
                                       + ["static.solve", "static.minedges"]])
    value = msfbench.by_name("metrics", metric).read(fake_run(trace))
    if case == "cpu" and metric in SPAN_SHARES:
        assert value == pytest.approx(1.0)
    else:
        assert value is None


def test_a_program_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    run = SimpleNamespace(counters={})
    inside.install(run)  # nothing to turn on
    assert inside.recorded(run) is None


def test_traced_oneshot_on_the_cpu_reads_as_the_outside_spans():
    r = bench.run_cell("gnm20-p8.oneshot", 2 ** 31 + 5, 0.5, True,
                       device="cpu",
                       overrides={"config": {"n": 1024, "m": 8192,
                                             "warm_shrink": 4}})
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert abs(m["layout_share.inside"] - m["layout_share"]) <= 0.5
    assert abs(m["host_bounds_share.inside"]
               - m["host_bounds_share"]) <= 1.0
    assert 0 < m["sync_share.sharded"] < 100
    assert not set(STATIC) & set(m)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_minedges_events_and_the_shared_clock(card, monkeypatch):
    """On RMAT scale 16, three solves with the recorder on: the
    ``static.minedges`` events against the host clock around the same
    phases of the same solves, each with ``torch.cuda.synchronize()`` on
    both sides (the card is idle there anyway, after the round's read of
    ``changed``); then every ``static.sync`` span ends after the device
    operation that last started before it began (the read waits for the
    round), on the profiler's clock."""
    from repro_torch.core import boruvka
    from repro_torch.data import generators
    dev = torch.device("cuda")
    u, v, w, n = generators.rmat(16, 16 << 16, seed=7)
    u, v, w = (torch.from_numpy(x).to(dev) for x in (u, v, w))
    boruvka.boruvka_msf(u, v, w, n)  # warm
    real_span = tracing.span
    host = []

    @contextlib.contextmanager
    def synced(label, device=None):
        if label != "static.minedges":
            with real_span(label, device):
                yield
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with real_span(label, device):
            yield
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)

    monkeypatch.setattr(tracing, "span", synced)
    tracing.enable()
    for _ in range(3):
        boruvka.boruvka_msf(u, v, w, n)
    trace = tracing.disable()
    monkeypatch.setattr(tracing, "span", real_span)
    event_s = inside.event_seconds(trace, "static.minedges", 0, 1 << 63)
    assert len(trace.events["static.minedges"]) == len(host) >= 6
    print(f"minedges: events {event_s:.6f} s, host {sum(host):.6f} s over "
          f"{len(host)} rounds")
    assert abs(event_s - sum(host)) <= 0.05 * sum(host)

    dt = DeviceTrace()
    dt.start()
    tracing.enable()
    boruvka.boruvka_msf(u, v, w, n)
    trace = tracing.disable()
    dt.stop()
    ops = sorted((s, e) for _, s, e in dt.events)
    syncs = inside.spans_of(trace, "static.sync")
    assert syncs and ops
    for _, a, b in syncs:
        before = [e for s, e in ops if s < a]
        assert before and b >= before[-1] - 50_000, (a, b, before[-1])
