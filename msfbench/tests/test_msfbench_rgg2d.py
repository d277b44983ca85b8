"""The ``rgg2d-p8.oneshot`` cell on the CPU at a small size: its
generator against a brute-force distance check of the same points, the
cell correct, its control and each fault planted in
``gnm20-p8.oneshot`` coming out not correct, the sharded engine with
and without local preprocessing held to the plain reference, the
program's ``sharded.prep`` span and its counters, and the two readers
of the local preprocessing layer."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import msfbench  # noqa: E402
from msfbench.gen import graphs, rgg2d  # noqa: E402
from msfbench.harness import bench, inside  # noqa: E402
from msfbench.reference import msf as reference  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.core import distributed_sharded as ds  # noqa: E402
from repro_torch.core.distributed import build_dist_graph  # noqa: E402
from repro_torch.core.graph import EdgeList  # noqa: E402
from repro_torch.core.mst import minimum_spanning_forest  # noqa: E402
from test_msfbench_control import FAULTS, _patch  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
CELL = "rgg2d-p8.oneshot"
SMALL = {"n": 4096, "warm_shrink": 4}
CONFIG = {"family": "rgg2d", "n": 4096, "avg_degree": 16}
P = 8


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def brute_force(pts: np.ndarray, r: float):
    """Every pair within ``r``, by all-pairs distances, ids in the stable
    order of the row-major cell keys."""
    cells = int(1.0 / r)
    cell = np.minimum((pts * cells).astype(np.int64), cells - 1)
    order = np.argsort(cell[:, 0] * cells + cell[:, 1], kind="stable")
    pts = pts[order]
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.nonzero(np.triu(d2 <= r * r, 1))


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_generator_equals_a_brute_force_check(seed):
    g = graphs.make(CONFIG, seed, CPU)
    pts = rgg2d.points(CONFIG["n"], graphs.generator(seed, CPU)).numpy()
    a, b = brute_force(pts, rgg2d.radius(CONFIG["n"], 16))
    assert np.array_equal(g.u.numpy(), a) and np.array_equal(g.v.numpy(), b)
    assert abs(2 * g.m / g.n - 16) <= 1.6
    # ids follow the cell order, so a shard's vertex range is a strip:
    # few edges join two of the eight ranges (a GNM graph: seven in 8)
    vps = g.n // P
    assert ((g.u // vps) != (g.v // vps)).float().mean() < 0.2
    assert g.w.dtype == torch.float32
    assert float(g.w.min()) >= 1.0 and float(g.w.max()) < 255.0


def test_same_seed_same_graph():
    one, two = (graphs.make(CONFIG, 5, CPU) for _ in range(2))
    other = graphs.make(CONFIG, 6, CPU)
    for x, y in zip((one.u, one.v, one.w), (two.u, two.v, two.w)):
        assert torch.equal(x, y)
    assert one.m != other.m or not torch.equal(one.u, other.u)
    warm = graphs.shrink({**CONFIG, "n": 1 << 16}, 16)
    assert warm == {**CONFIG, "n": 4096}


def run(seed=11, **kw):
    return bench.run_cell(CELL, seed, 1.0, False, device="cpu",
                          overrides={"config": SMALL}, **kw)


def test_sound_run_is_correct():
    r = run(2 ** 32 + 9)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_is_not_correct(seed):
    r = run(seed, control=True)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS["gnm20-p8.oneshot"]))
def test_fault_is_not_correct(fault):
    site, make = FAULTS["gnm20-p8.oneshot"][fault]
    r = run(on_window=_patch(site, make))
    assert not r["correct"], (fault, r["checks"])


def _pre_mst_slots(u, v, w, n):
    """The forest edges the local preprocessing contracts on the layout,
    from ``_sharded_preprocess`` itself."""
    g, cap = build_dist_graph(u, v, w, n, P, device=CPU)
    vps = ds.vertices_per_shard(n, P)
    x = [t.view(P, cap) for t in g]
    pre = ds._sharded_preprocess(*x, torch.isfinite(x[2]), n, vps, vps,
                                 (P,), "grid", ds.ExchangeStats.zeros(CPU))
    return int(pre[1].sum())


@pytest.mark.parametrize("prep", [True, False])
@pytest.mark.parametrize("seed", [2 ** 31 + 7, 12])
def test_sharded_engine_equals_the_reference(seed, prep):
    """The public API on a benchmark RGG with local preprocessing on and
    off: the reference's forest and weight; with the recorder on, one
    ``sharded.prep`` span a solve and counters equal to the
    preprocessing's slots and the mask's count; off, nothing."""
    g = graphs.make({**CONFIG, "n": 2048}, seed, CPU)
    ref_mask, ref_weight = reference.msf(g.u, g.v, g.w, g.n)

    def solve():
        return minimum_spanning_forest(
            EdgeList(g.u, g.v, g.w, g.n), engine="distributed_sharded",
            num_shards=P, local_preprocessing=prep)

    mask, weight = solve()
    assert torch.equal(mask, ref_mask)
    assert float(weight) == pytest.approx(ref_weight, rel=1e-6)
    assert tracing.disable().counters == {}
    assert tracing._REC.trace.records == []
    tracing.enable()
    mask_on, _ = solve()
    trace = tracing.disable()
    assert torch.equal(mask_on, mask)
    spans = inside.spans_of(trace, "sharded.prep")
    c = trace.counters
    assert c["sharded.forest_edges"] == int(mask.sum())
    if not prep:
        assert not spans and "prep.rounds" not in c
        return
    assert len(spans) == 1
    assert c["prep.rounds"] >= 2
    assert c["prep.forest_edges"] == _pre_mst_slots(g.u, g.v, g.w, g.n)
    assert 0.5 * c["sharded.forest_edges"] < c["prep.forest_edges"]
    assert trace.events == {}  # on the CPU no span is timed on a card


def fake_run(trace, lo=0, hi=1000):
    window = SimpleNamespace(done=[object()], start_ns=lo, end_ns=hi,
                             seconds=(hi - lo) / 1e9)
    notes = []
    return SimpleNamespace(window=window, counters={inside.KEY: trace},
                           devtrace=None, note=notes.append, notes=notes)


def test_prep_readers_arithmetic():
    trace = tracing.Trace(
        records=[("sharded.prep", 100, 300), ("sharded.sync", 150, 160),
                 ("sharded.prep", 900, 1100)],
        counters={"prep.rounds": 12, "prep.forest_edges": 970,
                  "sharded.forest_edges": 1000})
    run = fake_run(trace)
    share = msfbench.by_name("metrics", "prep_share.sharded").read(run)
    assert share == pytest.approx(100.0 * 300 / 1000)
    found = msfbench.by_name("metrics", "prep_forest_share.sharded")
    assert found.read(run) == pytest.approx(97.0)
    assert run.notes == [
        "prep_share.sharded: 2 preprocessings, 6.000 rounds each, not "
        "timed on a card",
        "prep_forest_share.sharded: 970 of 1000 forest edges contracted "
        "by the preprocessing"]


@pytest.mark.parametrize("metric", ["prep_share.sharded",
                                    "prep_forest_share.sharded"])
@pytest.mark.parametrize("case", ["no_recorder", "nothing_recorded",
                                  "no_forest"])
def test_prep_readers_nothing_to_read_is_none(metric, case):
    trace = {"no_recorder": None, "nothing_recorded": tracing.Trace(),
             "no_forest": tracing.Trace(counters={
                 "prep.forest_edges": 0, "sharded.forest_edges": 0})}[case]
    assert msfbench.by_name("metrics", metric).read(fake_run(trace)) is None
