"""The harness on the CPU: the result line, the metric arithmetic, the
whole-name import check, and cells, configurations and metrics found by
name from their files.  One test needs the card and skips without it."""
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import msfbench  # noqa: E402
from msfbench import run as run_py  # noqa: E402
from msfbench.harness import bench, cell, stats  # noqa: E402
from msfbench.harness.devtrace import (gaps, idle_by_host,  # noqa: E402
                                       union_seconds)
from msfbench.harness.spans import Spans  # noqa: E402

torch.set_num_threads(1)
SMALL = {"gnm20-p8": {"n": 1024, "m": 8192, "warm_shrink": 4},
         "rmat19-p1": {"scale": 10}}
CELLS = ("gnm20-p8.served", "rmat19-p1.boruvka", "gnm20-p8.oneshot",
         "rmat19-p1.filter")


def small(name):
    return {"config": SMALL[name.split(".")[0]]}


def test_rate_and_percentiles():
    assert stats.rate(3 * 2 ** 23, 60.0) == 3 * 2 ** 23 / 60.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    xs = list(range(1, 201))  # 1..200
    assert stats.percentile(xs, 0.95) == 190
    assert stats.beyond(xs, 0.95) == 10
    assert stats.percentile(xs, 0.5) == 100
    assert stats.percentile([7.0], 0.95) == 7.0


def test_p95_reader_reports_its_sample_count():
    class FakeRun:
        notes = []
        window = bench.drive.Window(start=0.0, end=10.0)

        def note(self, line):
            self.notes.append(line)
    r = FakeRun()
    r.window.done = [bench.drive.Done(i, 0, 100, (i + 1) / 1e3, i)
                     for i in range(400)]
    assert cell.reader("solve_p95_ms").read(r) == pytest.approx(380.0)
    assert r.notes == ["solve_p95_ms over 400 solves, 20 beyond it"]
    assert cell.reader("solve_edges_per_s").read(r) == 400 * 100 / 10.0


def test_forbidden_is_a_whole_top_level_name():
    found = bench.forbidden_modules(["repro_torch", "repro_torch.core.mst",
                                     "reprox", "repro", "repro.core",
                                     "jax.numpy", "jaxlib", "flax.linen",
                                     "jaxtyping", "torch"])
    assert found == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                     "repro.core"]


def test_a_run_loads_nothing_forbidden():
    """A whole run in a fresh process, then every loaded module's
    top-level name; the reference and the generators load nothing of the
    program at all."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        from msfbench.reference import msf
        from msfbench.gen import graphs
        assert not [m for m in sys.modules if m.split('.')[0]
                    in ('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]
        from msfbench.harness import bench
        r = bench.run_cell('gnm20-p8.oneshot', 5, 0.5, True, device='cpu',
                           overrides={{'config': {SMALL['gnm20-p8']!r}}})
        assert r['correct'], r
        assert 'repro_torch' in sys.modules
        print(bench.forbidden_modules())
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_metrics_follow_benchmark_json(bench_root):
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    for name in CELLS:
        c = cell.load_cell(name, bench_root)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e  # reported beside what it moves
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (ROOT / "msfbench" / "metrics" / f"{m['name']}.py").exists()
    for w in spec["workloads"]:
        assert (ROOT / "msfbench" / "workloads" / f"{w['name']}.json").exists()
        assert w["traffic"] in [p.stem for p in
                                (ROOT / "msfbench" / "traffic").glob("*.json")]
    # every traffic file's driver and every configuration's family is a
    # module of its own, found by name
    for p in (ROOT / "msfbench" / "traffic").glob("*.json"):
        entry = json.loads(p.read_text())["entry"]
        assert hasattr(msfbench.by_name("traffic", entry), "prepare")
    for p in (ROOT / "msfbench" / "configs").glob("*.json"):
        family = msfbench.by_name("gen", json.loads(p.read_text())["family"])
        assert hasattr(family, "draw") and hasattr(family, "shrink")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(trace, monkeypatch):
    """``run.py``'s last line and last error lines, with the card's
    checks stood in for and the cell run small on the CPU."""
    real = bench.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "run_cell", lambda *a, **kw: real(
        *a, device="cpu", overrides=small("rmat19-p1"),
        **{k: v for k, v in kw.items() if k != "root"}))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run_py.main(["--workload", "rmat19-p1.filter", "--seed",
                          str(2 ** 31 + 17), "--seconds", "0.5",
                          "--trace", str(trace)])
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = ({"solve_p50_ms"} if trace else
            {"solve_edges_per_s", "solve_p95_ms", "setup_s"})
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    tail = err.getvalue().strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    for t, (k, c) in zip(tail, line["checks"].items()):
        assert t == f"check {k} {c['value']!r} limit {c['limit']!r}"


def test_no_program_no_result(tmp_path):
    """A checkout of the benchmark's files alone exits non-zero and
    prints no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "msfbench", tmp_path / "msfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "msfbench/run.py", "--workload",
                          "rmat19-p1.boruvka", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "the program is not here" in out.stderr


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration of a new graph family, a traffic mix of a new
    driver, a cell and a metric, added as files and BENCHMARK.json
    entries only, run without an edit of the harness."""
    shutil.copytree(ROOT / "msfbench", tmp_path / "msfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "msfbench"
    cfg = json.loads((b / "configs" / "gnm20-p8.json").read_text())
    cfg.update(name="gnm12-p4", family="cycle", n=4096, m=16384,
               num_shards=4, warm_shrink=4)
    (b / "configs" / "gnm12-p4.json").write_text(json.dumps(cfg))
    (b / "gen" / "cycle.py").write_text(textwrap.dedent("""
        import torch
        from msfbench.gen.graphs import finish

        def draw(config, gen):
            n, m = int(config["n"]), int(config["m"])
            ring = torch.arange(n, device=gen.device)
            u = torch.randint(0, n, (m - n,), generator=gen,
                              device=gen.device)
            v = torch.randint(0, n, (m - n,), generator=gen,
                              device=gen.device)
            return finish(torch.cat([ring, u]),
                          torch.cat([(ring + 1) % n, v]), n, gen)

        def shrink(config, factor):
            return {**config, "n": config["n"] // factor,
                    "m": config["m"] // factor}
        """))
    (b / "traffic" / "solve_counted.py").write_text(textwrap.dedent("""
        import msfbench

        def prepare(run):
            loop = msfbench.by_name("traffic", "solve").prepare(run)
            run.note("solve_counted prepared")
            return loop
        """))
    trf = json.loads((b / "traffic" / "solve.json").read_text())
    trf.update(pool=3, entry="solve_counted")
    (b / "traffic" / "solve-pool3.json").write_text(json.dumps(trf))
    (b / "workloads" / "gnm12-p4.pool3.json").write_text(
        (b / "workloads" / "gnm20-p8.oneshot.json").read_text())
    (b / "metrics" / "solves_done.py").write_text(
        "def read(run):\n    return float(len(run.window.served()))\n")
    spec["configs"].append({"name": "gnm12-p4", "source": "test",
                            "file": "msfbench/configs/gnm12-p4.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "gnm12-p4.pool3", "config":
                              "gnm12-p4", "traffic": "solve-pool3",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "solves_done", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "setup_s"})
    for m in spec["end_to_end"]:
        if m["name"] == "sharded_edges_per_s":
            m["workloads"].append("gnm12-p4.pool3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(tmp_path)!r}]
        from msfbench.harness import bench
        for trace in (False, True):
            r = bench.run_cell('gnm12-p4.pool3', 3, 0.5, trace,
                               device='cpu', root=bench.cells.ROOT)
            assert 'solve_counted prepared' in r.pop('_notes')
            print(json.dumps(r))
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    plain, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"sharded_edges_per_s", "setup_s"}
    # the per-layer metrics that list their cells leave this one out
    assert set(traced["metrics"]) == {"solves_done"}
    assert traced["metrics"]["solves_done"]["value"] >= 1


def test_spans_and_idle_gaps():
    s = Spans()
    s.records = [("step", 0, 100), ("layout", 10, 40), ("replay", 60, 90),
                 ("solve", 200, 300)]
    label = s.labeller()
    assert [label(t) for t in (5, 20, 50, 70, 95, 150, 250, 400)] == [
        "step", "layout", "step", "replay", "step", "unwrapped", "solve",
        "unwrapped"]
    assert s.seconds("step") == 100 / 1e9
    assert s.seconds("layout", 30, 1000) == 10 / 1e9
    ev = [("k", 0, 20), ("k", 15, 30), ("c", 70, 80)]
    assert union_seconds(ev, 0, 100) == 40 / 1e9
    assert gaps(ev, 0, 100) == [(30, 70), (80, 100)]
    assert idle_by_host(ev, 0, 100, label) == [["step", 60 / 1e9]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_static_cell_on_the_card(card):
    r = bench.run_cell("rmat19-p1.boruvka", 2 ** 32 + 3, 2.0, True)
    assert r["correct"] and r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["device_idle.static"]["value"] < 100
