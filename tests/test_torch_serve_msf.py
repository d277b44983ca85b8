"""The port's MSF serving gateway and its launcher.

No reference subprocess: the gateway is host logic over primitives the
other test files hold to the reference bit for bit (plans, batched
replay, checkpoints, the verifier), and the reference's own gateway
scenarios compile a program per plan.  So:

* ``validate_graph`` and ``make_traffic`` are numpy code and are held
  to the reference's in process;
* the reference tests' gateway scenarios (tests/test_serve_msf.py,
  tests/test_faults.py) run here at p = 8, n = 256 on the CPU, with
  every served forest the Kruskal edge set and every ``GatewayStats``
  field, ``served_via`` and error fragment those tests assert;
* every batched result equals the port's own ``execute_plan`` of the
  cached plan on that request's layout, a failed checkpointing rung is
  resumed by the next, and ``pallas_minedges=True`` serves what False
  does.

The gateway reads its module's ``time``; the deadline scenarios replace
it with a fake clock, so no assertion depends on the machine's speed.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro.core import oracle
from repro.launch.serve_msf import make_traffic as jax_make_traffic
from repro.serve.msf_gateway import AdmissionError as JaxAdmissionError
from repro.serve.msf_gateway import validate_graph as jax_validate_graph
from repro_torch.comm import faults
from repro_torch.core.distributed_sharded import execute_plan
from repro_torch.launch import serve_msf
from repro_torch.launch.serve_msf import make_traffic
from repro_torch.serve import msf_gateway
from repro_torch.serve.msf_gateway import (AdmissionError, GatewayError,
                                           GatewayStats, MSFGateway,
                                           MSFRequest, validate_graph)

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = "cpu"
P = 8
N = 256
STATS = ("calls", "items", "bytes", "rounds", "hits", "misses", "pushed",
         "injected")


class FakeClock:
    """Stands in for the gateway module's ``time``: ``monotonic`` reads
    ``t``, ``sleep`` advances it."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(msf_gateway, "time", fake)
    return fake


def gateway(**kw):
    return MSFGateway(P, device=CPU, **kw)


def star(seed, rid, n=N):
    rng = np.random.default_rng(seed)
    return MSFRequest(rid=rid, family="syn", u=np.zeros(n - 1, np.int32),
                      v=np.arange(1, n, dtype=np.int32),
                      w=rng.uniform(1, 10, n - 1).astype(np.float32), n=n)


def path(seed, rid, n=N):
    rng = np.random.default_rng(seed)
    return MSFRequest(rid=rid, family="syn",
                      u=np.arange(0, n - 1, dtype=np.int32),
                      v=np.arange(1, n, dtype=np.int32),
                      w=rng.uniform(1, 10, n - 1).astype(np.float32), n=n)


def check(reqs):
    """Every served forest is the Kruskal edge set, with its weight and
    edge count."""
    for r in reqs:
        assert r.served_via in ("batched", "replanned"), (r.rid, vars(r))
        kmask, kweight = oracle.kruskal(r.u, r.v, r.w, r.n)
        np.testing.assert_array_equal(r.edges, np.nonzero(kmask)[0],
                                      err_msg=f"request {r.rid}")
        assert abs(r.weight - kweight) < 1e-3 * max(1.0, kweight), r.rid
        assert r.count == int(kmask.sum())


def serve(gw, reqs, **run_kw):
    for r in reqs:
        gw.submit(r)
    gw.run(**run_kw)
    assert all(r.done for r in reqs)


# -- admission control against the reference (in process) ----------------

OK_U = np.asarray([0, 1], np.int32)
OK_V = np.asarray([1, 2], np.int32)
OK_W = np.asarray([1.0, 2.0], np.float32)
# tests/test_faults.py's hostile cases: (u, v, w, n, kwargs, fragment)
HOSTILE = [
    (OK_U, OK_V, OK_W, 3, {}, None),
    (OK_U, OK_V, OK_W, 0, {}, "n must be"),
    (OK_U, OK_V[:1], OK_W, 3, {}, "length"),
    (OK_U, OK_V, np.asarray([1.0, np.nan], np.float32), 3, {}, "NaN"),
    (OK_U, OK_V, np.asarray([np.inf, 1.0], np.float32), 3, {}, "NaN"),
    (OK_U, np.asarray([1, 3], np.int32), OK_W, 3, {}, "outside"),
    (np.asarray([-1, 1], np.int32), OK_V, OK_W, 3, {}, "outside"),
    (OK_U, OK_V, OK_W, 3, {"max_edges": 1}, "max_edges"),
    (OK_U.astype(np.float32), OK_V, OK_W, 3, {}, "integer"),
    (np.asarray([0, 0], np.int32), np.asarray([0, 1], np.int32), OK_W, 3,
     {}, None),
    (np.asarray([0, 0], np.int32), np.asarray([1, 1], np.int32), OK_W, 3,
     {}, None),
    (np.asarray([], np.int64), np.asarray([], np.int64),
     np.asarray([], np.float32), 1, {}, None),
    (OK_U, OK_V, OK_W, 3, {"rid": 7}, None),
    (OK_U, OK_V, np.asarray([-np.inf, 1.0], np.float32), 3, {"rid": 4},
     "NaN"),
]


def outcome(fn, err, *args, **kw):
    try:
        fn(*args, **kw)
    except err as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", range(len(HOSTILE)))
def test_validate_graph_matches_reference(case):
    u, v, w, n, kw, frag = HOSTILE[case]
    got = outcome(validate_graph, AdmissionError, u, v, w, n, **kw)
    exp = outcome(jax_validate_graph, JaxAdmissionError, u, v, w, n, **kw)
    assert got == exp
    if frag is None:
        assert got is None
    else:
        assert frag in got
        # a typed gateway error that old ValueError handlers still catch
        with pytest.raises(ValueError):
            validate_graph(u, v, w, n, **kw)
        with pytest.raises(GatewayError):
            validate_graph(u, v, w, n, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_validate_graph_random_sweep_matches_reference(seed):
    """Random edge lists over hostile ids and weights: the same accept or
    reject, with the same message, as the reference."""
    rng = np.random.default_rng(seed)
    pool = np.asarray([1.0, 2.5, 0.0, -1.0, np.nan, np.inf, -np.inf],
                      np.float32)
    rejected = 0
    for trial in range(200):
        m = int(rng.integers(0, 12))
        n = int(rng.integers(0, 10))
        u = rng.integers(-2, 10, m).astype(np.int32)
        v = rng.integers(-2, 10, m).astype(rng.choice([np.int32, np.int64]))
        w = pool[rng.integers(0, len(pool) - 3 * (trial % 2), m)]
        if trial % 7 == 0 and m:
            v = v[:-1]
        kw = {}
        if trial % 5 == 0:
            kw["max_edges"] = int(rng.integers(0, 8))
        if trial % 3 == 0:
            kw["rid"] = trial
        got = outcome(validate_graph, AdmissionError, u, v, w, n, **kw)
        exp = outcome(jax_validate_graph, JaxAdmissionError, u, v, w, n,
                      **kw)
        assert got == exp, (trial, got, exp)
        rejected += got is not None
    assert 0 < rejected < 200


@pytest.mark.parametrize("families,sizes,requests,seed", [
    (("gnm", "rgg2d"), (256,), 6, 0),
    (("gnm",), (384, 512), 3, 50),
    (("rgg2d", "rmat"), (300,), 4, 7),
])
def test_make_traffic_matches_reference(families, sizes, requests, seed):
    got = make_traffic(families, sizes, requests, seed=seed)
    exp = jax_make_traffic(families, sizes, requests, seed=seed)
    assert len(got) == len(exp) == requests
    for a, b in zip(got, exp):
        assert (a.rid, a.family, a.n) == (b.rid, b.family, b.n)
        for k in ("u", "v", "w"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y)


def test_percentile_and_stats_rates():
    assert serve_msf.percentile([], 0.5) == 0.0
    assert serve_msf.percentile([3.0, 1.0, 2.0], 0.5) == 2.0
    assert serve_msf.percentile([3.0, 1.0, 2.0], 0.99) == 3.0
    s = GatewayStats()
    assert s.hit_rate == 0.0 and s.replan_rate == 0.0
    s.hits, s.misses, s.served, s.replans = 3, 1, 8, 2
    assert s.hit_rate == 0.75 and s.replan_rate == 0.25


# -- the reference tests' serving scenarios on the CPU ---------------------

def test_hit_miss_evict_and_lru_order():
    """tests/test_serve_msf.py (1): 16 requests over 2 keys in 4 batches
    of 4, then a third key evicts the least recently used entry."""
    gw = gateway(cache_size=2, batch_slots=4)
    reqs = make_traffic(("gnm", "rgg2d"), (N,), 16, seed=0)
    serve(gw, reqs)
    check(reqs)
    s = gw.stats
    assert s.served == 16 and s.batches == 4, vars(s)
    assert (s.hits, s.misses, s.evictions) == (2, 2, 0), vars(s)
    assert len(gw.cache) == 2
    gnm_key = gw._key(reqs[0])
    assert list(gw.cache) == [gnm_key, gw._key(reqs[1])]

    extra = make_traffic(("gnm",), (384,), 2, seed=50)
    serve(gw, extra)
    check(extra)
    assert s.misses == 3 and s.evictions == 1 and len(gw.cache) == 2
    assert gnm_key not in gw.cache  # the gnm/256 entry was least recent
    again = make_traffic(("gnm",), (N,), 2, seed=60)
    serve(gw, again)
    check(again)
    assert s.misses == 4 and s.hits == 2 and s.evictions == 2, vars(s)
    assert list(gw.cache) == [gw._key(extra[0]), gnm_key]
    assert s.submitted == s.served == 20 and s.rejected == 0


def test_star_to_path_replan_and_drift_refresh():
    """tests/test_serve_msf.py (2): a plan measured on stars does not fit
    same-key path traffic; each path replans alone, the replan rate
    crosses the threshold and refreshes the entry off a path graph, and
    identical paths then ride the refreshed plan batched."""
    gw = gateway(cache_size=4, batch_slots=4, replan_threshold=0.34,
                 min_samples=4)
    stars = [star(seed, seed) for seed in range(4)]
    serve(gw, stars)
    check(stars)
    assert gw.stats.misses == 1 and gw.stats.replans == 0
    key = gw._key(stars[0])

    paths = [path(100 + i, 4 + i) for i in range(4)]
    serve(gw, paths)
    check(paths)
    assert all(r.served_via == "replanned" for r in paths)
    assert gw.stats.hits == 1 and gw.stats.replans == 4, vars(gw.stats)
    assert gw.stats.refreshes == 1, vars(gw.stats)
    assert key in gw.cache and len(gw.cache) == 1
    entry = gw.cache[key]
    assert (entry.served, entry.replans) == (0, 0)  # fresh counters

    paths2 = [path(103, 8 + i) for i in range(4)]
    serve(gw, paths2)
    check(paths2)
    assert all(r.served_via == "batched" for r in paths2)
    assert gw.stats.replans == 4 and gw.stats.refreshes == 1


def test_rung_deadline_recheck(clock, monkeypatch):
    """tests/test_serve_msf.py:289-354: the measurement pass takes the
    batch past the path request's 1 s deadline (the fake clock advances
    5 s inside it), so the path's retry rung rejects it instead of
    serving late; with budget to spare the rung serves."""
    measure = msf_gateway.plan_sharded_msf

    def slow_measure(*a, **kw):
        clock.sleep(5.0)
        return measure(*a, **kw)

    monkeypatch.setattr(msf_gateway, "plan_sharded_msf", slow_measure)
    gw = gateway(batch_slots=4, max_retries_per_request=3,
                 breaker_threshold=99, min_samples=99)
    s0 = star(0, 0)
    p0 = path(1, 1)
    p0.deadline = 1.0
    gw.submit(s0)
    gw.submit(p0)
    gw.run()
    assert s0.done and s0.served_via == "batched"
    check([s0])
    assert p0.done and p0.served_via == "rejected", vars(p0)
    assert "before retry dispatch" in p0.error, p0.error
    assert gw.stats.deadline_missed == 1 and gw.stats.rejected == 1
    assert gw.stats.retried == 1 and not gw.queue
    assert gw.stats.replans == 0 and gw.stats.resumed == 0

    p1 = path(2, 2)
    p1.deadline = 600.0
    serve(gw, [p1])
    assert p1.served_via == "replanned", vars(p1)
    check([p1])
    assert gw.stats.deadline_missed == 1, vars(gw.stats)


def test_admission_and_deadlines(clock):
    """tests/test_faults.py (1)-(2): typed admission rejections, counted
    and marked on the request; a request queued past its deadline
    rejects, never serves late."""
    gw = gateway(max_edges=4096)
    bad_w = star(0, 0)
    bad_w.w[3] = np.nan
    bad_ids = star(0, 1)
    bad_ids.v[0] = N + 7
    huge = MSFRequest(rid=2, family="syn", u=np.zeros(5000, np.int32),
                      v=np.ones(5000, np.int32),
                      w=np.ones(5000, np.float32), n=N)
    for req, frag in ((bad_w, "NaN"), (bad_ids, "outside"),
                      (huge, "max_edges")):
        with pytest.raises(AdmissionError, match=frag):
            gw.submit(req)
        assert req.served_via == "rejected" and frag in req.error
        assert req.done
    assert gw.stats.rejected == 3 and not gw.queue
    ok = star(1, 3)
    serve(gw, [ok])
    assert ok.served_via == "batched"
    check([ok])
    assert gw.stats.served == 1 and gw.stats.rejected == 3
    assert gw.stats.submitted == 1

    gw2 = gateway()
    late = star(2, 0)
    late.deadline = 1e-6
    fine = star(3, 1)
    fine.deadline = 300.0
    gw2.submit(late)
    gw2.submit(fine)
    clock.sleep(0.01)
    gw2.run()
    assert late.done and late.served_via == "rejected", vars(late)
    assert "deadline" in late.error
    assert fine.done and fine.served_via == "batched"
    check([fine])
    assert gw2.stats.deadline_missed == 1 and gw2.stats.rejected == 1
    assert fine.latency == pytest.approx(0.01)  # the fake clock's wait


def test_zero_retry_budget_rejects():
    """tests/test_faults.py (3): with max_retries_per_request=0, path
    traffic on a star plan rejects instead of replanning, and never
    requeues."""
    gw = gateway(cache_size=4, batch_slots=4, max_retries_per_request=0,
                 breaker_threshold=99, min_samples=99)
    s0 = star(4, 0)
    serve(gw, [s0])
    assert s0.served_via == "batched"
    check([s0])
    paths = [path(100 + i, 1 + i) for i in range(4)]
    serve(gw, paths)
    assert not gw.queue, "rejected requests must not requeue"
    for r in paths:
        assert r.served_via == "rejected", vars(r)
        assert "retry budget" in r.error, r.error
    assert gw.stats.rejected == 4 and gw.stats.retried == 4
    assert gw.stats.replans == 0 and gw.stats.breaker_trips == 0


def test_circuit_breaker_quarantines_entry():
    """tests/test_faults.py (4): consecutive failing steps trip the
    entry out of the LRU and reject the poisoners; fresh traffic then
    measures a plan that fits."""
    gw = gateway(batch_slots=1, max_retries_per_request=0,
                 breaker_threshold=3, min_samples=99)
    s1 = star(5, 0)
    serve(gw, [s1])
    check([s1])
    key = gw._key(s1)
    assert key in gw.cache
    poison = [path(200 + i, 1 + i) for i in range(3)]
    serve(gw, poison)
    assert all(r.served_via == "rejected" for r in poison)
    assert gw.stats.breaker_trips == 1, vars(gw.stats)
    assert key not in gw.cache
    fresh = path(300, 9)
    serve(gw, [fresh])
    assert fresh.served_via == "batched"
    check([fresh])
    assert gw.stats.misses == 2


def test_verify_under_clip_fault_never_serves_wrong(clock):
    """tests/test_faults.py (5): a verify=True gateway facing starved
    MINEDGES exchanges serves the exact forest or rejects, run()
    terminates, and clean traffic afterwards serves exactly."""
    gw = gateway(verify=True, max_retries_per_request=1,
                 breaker_threshold=5, backoff_base=0.01)
    warm = make_traffic(("gnm",), (N,), 1, seed=7)
    serve(gw, warm)
    assert warm[0].served_via == "batched"
    reqs = make_traffic(("gnm",), (N,), 2, seed=8)
    for r in reqs:
        gw.submit(r)
    clip = faults.FaultPlan(seed=3, specs=(
        faults.FaultSpec(kind="clip", site="minedges", cap_frac=0.125),))
    with faults.inject(clip):
        gw.run(max_steps=50)
    for r in reqs:
        assert r.done, vars(gw.stats)
        if r.served_via != "rejected":
            check([r])
    assert gw.stats.retried >= 1, vars(gw.stats)
    clean = make_traffic(("gnm",), (N,), 2, seed=17)
    serve(gw, clean)
    check(clean)


# -- the port's own contracts ---------------------------------------------

def test_batched_results_equal_execute_plan(monkeypatch):
    """Each batched result is the port's ``execute_plan`` of the cached
    plan on that request's layout: mask, weight, count, labels and every
    ``CommStats`` field."""
    seen = []
    batched = msf_gateway.execute_plan_batched

    def spy(graphs, n, num_shards, plan, **kw):
        out = batched(graphs, n, num_shards, plan, **kw)
        # a copy: the gateway fills a flagged request's slot in place
        seen.append((list(graphs), n, plan, (list(out[0]), out[1])))
        return out

    monkeypatch.setattr(msf_gateway, "execute_plan_batched", spy)
    gw = gateway(batch_slots=3)
    reqs = make_traffic(("gnm", "rgg2d"), (N,), 6, seed=3)
    serve(gw, reqs)
    check(reqs)
    assert len(seen) == gw.stats.batches == 2
    compared = 0
    for graphs, n, plan, (results, flagged) in seen:
        for i, (g, res) in enumerate(zip(graphs, results)):
            if i in flagged:
                assert res is None
                continue
            exp = execute_plan(g, n, P, plan, replan=False)
            for a, b in zip(res[:5], exp[:5]):
                assert torch.equal(a, b)
            for f in STATS:
                assert torch.equal(getattr(res[5], f), getattr(exp[5], f)), f
            compared += 1
    assert compared == 6 - gw.stats.replans > 0


def test_failed_rung_resumes_from_its_checkpoint(clock):
    """A ladder rung that takes certified checkpoints and then dies (an
    injected shard abort in its last round) leaves its last checkpoint
    on the request; the next rung resumes there, ``resumed`` and
    ``rounds_saved`` move, and the forest is exact."""
    gw = gateway(batch_slots=1, ckpt_every=1, max_retries_per_request=2,
                 breaker_threshold=99, min_samples=99)
    serve(gw, [star(0, 0)])
    req = path(7, 1)
    rounds = []
    msf_gateway._replan_with_plan(
        msf_gateway.build_dist_graph(req.u, req.v, req.w, N, P,
                                     cap=gw._cap_rung(req), device=CPU)[0],
        N, P, next(iter(gw.cache.values())).plan, round_trace=rounds)
    last = len(rounds)
    assert last >= 2
    abort = faults.FaultPlan(seed=0, specs=(
        faults.FaultSpec(kind="abort", site="minedges", rounds=(last,)),))
    gw.submit(req)
    with faults.inject(abort):
        done = gw.step()
    assert done == [] and gw.queue and req._ckpt is not None
    assert "aborted" in req.error and req.retries == 1
    saved = req._ckpt.round_index
    assert 0 < saved < last
    gw.run()
    assert req.served_via == "replanned", vars(req)
    check([req])
    s = gw.stats
    assert (s.resumed, s.rounds_saved, s.retried, s.replans) == \
        (1, saved, 2, 1), vars(s)


def test_pallas_minedges_serves_the_same():
    """``pallas_minedges=True`` (K1's plain version here) serves every
    request exactly as False does, with its own cache-key bit."""
    outs = []
    for pm in (False, True):
        gw = gateway(batch_slots=2, pallas_minedges=pm)
        reqs = make_traffic(("gnm", "rgg2d"), (N,), 6, seed=11)
        reqs.append(path(5, 6))
        serve(gw, reqs)
        check(reqs)
        outs.append((gw, reqs))
        assert all(e.plan.pallas_minedges is pm
                   for e in gw.cache.values())
    (g0, r0), (g1, r1) = outs
    assert vars(g0.stats) == vars(g1.stats)
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a.edges, b.edges)
        assert (a.weight, a.count, a.served_via) == \
            (b.weight, b.count, b.served_via)
    assert g0._key(r0[0]) != g1._key(r1[0])


def test_launcher_smoke_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_msf.main(["--smoke", "--device", "cpu"])
    out = buf.getvalue()
    assert "SMOKE OK" in out and "24 forests bit-identical" in out, out


def test_gateway_needs_a_device_or_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MSFGateway(P)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_msf.main(["--smoke"])
    gw = MSFGateway((4, 2), device=CPU)
    assert gw.p == 8 and gw.device == torch.device("cpu")
