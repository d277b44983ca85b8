"""One run of one cell: set-up, the window, the comparison, the result.

``run_cell`` is what ``msfbench/run.py`` calls for the command line and
what the tests call on the CPU at small sizes.  In order:

1. set-up (``setup_s``, from process start): the pool of graphs from
   the seed on the device, the system, its warm-up;
2. the window: the traffic driver runs for ``seconds``; with ``trace``
   the per-layer readers' wrappers and the profiler are on;
3. the metrics: each reader of ``metrics/`` reads the window;
   ``memory_peak_bytes`` is read, and the program's state is freed;
4. the comparison: every kept answer against the plain reference of
   its graph (``reference/msf.py``), computed now on the same arrays;
5. the result: one JSON object, its ``checks`` last.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from msfbench.harness import cell as cells
from msfbench.harness import drive
from msfbench.harness.devtrace import DeviceTrace, idle_by_host, top_ops
from msfbench.harness.spans import Spans
from msfbench.reference import msf as reference

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_CHARS = 200  # a kernel's name in the breakdown, cut to this length
# The profiler stops at the first completion past TRACE_S seconds once the
# window holds TRACE_MIN_DONE completions, so that a window of hundreds of
# short solves keeps a trace it can read in seconds; a window of a few long
# requests never gets there and is traced whole.
TRACE_S, TRACE_MIN_DONE = 10.0, 16


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Run:
    """What the readers of ``metrics/`` read."""

    def __init__(self, cell: cells.Cell, seed: int, seconds: float,
                 trace: bool, device: torch.device, control: bool,
                 t_start: float) -> None:
        self.cell = cell
        self.config = cell.config
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.control = control
        self.t_start = t_start
        self.setup_s = 0.0
        self.spans = Spans()
        self.window = drive.Window()
        self.devtrace: Optional[DeviceTrace] = None
        self.system = None
        self.pool = []
        self.counters: Dict[str, dict] = {}
        self.window_peak_bytes: Optional[int] = None
        self.notes: List[str] = []

    def note(self, line: str) -> None:
        self.notes.append(line)


def _peak(device: torch.device) -> Optional[int]:
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def compare(run: Run) -> Dict[str, float]:
    """Each kept answer against the reference of its graph."""
    w = run.window
    wrong = 0
    gap = 0.0
    compared = 0
    refs = {}
    for d in w.done:
        if d.answer is None:
            continue
        if d.graph not in refs:
            g = run.pool[d.graph]
            mask, weight = reference.msf(g.u, g.v, g.w, g.n)
            refs[d.graph] = (mask.cpu().numpy(), weight)
        ref_mask, ref_weight = refs[d.graph]
        got, weight = d.answer
        if got.dtype == np.bool_:
            same = got.shape == ref_mask.shape and np.array_equal(got,
                                                                  ref_mask)
        else:
            same = np.array_equal(np.sort(got), np.flatnonzero(ref_mask))
        wrong += 0 if same else 1
        rel = abs(weight - ref_weight) / abs(ref_weight) if ref_weight \
            else abs(weight)
        gap = max(gap, rel if math.isfinite(rel) else 1e30)
        compared += 1
    missing = sum(1 for d in w.done if d.error)
    return {"compared": compared, "wrong_forests": wrong,
            "missing_answers": missing, "weight_rel_gap": gap}


CHECKS = ("wrong_forests", "missing_answers", "weight_rel_gap")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: Optional[str] = None, overrides: Optional[dict] = None,
             control: bool = False, t_start: Optional[float] = None,
             root=cells.ROOT, on_window: Optional[Callable] = None
             ) -> dict:
    """Run cell ``name`` once and return its result object.

    ``device`` and ``overrides`` (``{"config": {...}, "traffic": {...}}``)
    let the tests run a cell on the CPU at a small size; ``control`` puts
    the reference in bfloat16 in the program's place; ``on_window(run)``
    is called as the window opens, after the set-up (the tests plant a
    fault in the timed path there).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cells.load_cell(name, root)
    if overrides:
        cell.config = {**cell.config, **overrides.get("config", {})}
        cell.traffic = {**cell.traffic, **overrides.get("traffic", {})}
    dev = torch.device(device or "cuda")
    run = Run(cell, seed, seconds, trace, dev, control, t_start)
    readers = {m["name"]: cells.reader(m["name"])
               for m in cell.metrics(trace)}

    loop = drive.prepare(run)
    if trace:
        for mod in readers.values():
            if hasattr(mod, "install"):
                mod.install(run)
    setup_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    if trace and dev.type == "cuda":
        run.devtrace = DeviceTrace()
        run.devtrace.start()

        def tick():
            if (time.perf_counter() - run.window.start >= TRACE_S
                    and len(run.window.done) >= TRACE_MIN_DONE):
                run.devtrace.stop()
        run.window.tick = tick
    run.window.start = time.perf_counter()
    run.window.start_ns = time.time_ns()
    run.setup_s = run.window.start - t_start
    for mod in readers.values():
        if hasattr(mod, "begin"):
            mod.begin(run)
    if on_window is not None:
        on_window(run)
    loop(run.window, seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.window.end = max([d.t_done for d in run.window.done]
                         or [time.perf_counter()])
    run.window.end_ns = run.window.start_ns + int(
        (run.window.end - run.window.start) * 1e9)
    if run.devtrace is not None:
        run.devtrace.stop()  # where the tick did not stop it before
    run.window_peak_bytes = _peak(dev)
    run.spans.restore()

    metrics = {}
    for m in cell.metrics(trace):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peaks = [p for p in (setup_peak, run.window_peak_bytes) if p is not None]
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": cell.chips,
               "memory_peak_bytes": max(peaks) if peaks else 0}
    breakdown = None
    if run.devtrace is not None:
        t = run.devtrace
        devinfo["busy_s"] = t.busy_s()
        devinfo["window_s"] = t.window_s
        breakdown = {
            "device_ops": [[name[:NAME_CHARS], s] for name, s in
                           top_ops(t.events, t.start_ns, t.stop_ns)],
            "idle_gaps": idle_by_host(t.events, t.start_ns, t.stop_ns,
                                      run.spans.labeller())}
        if t.events:
            first = min(e[1] for e in t.events) - t.start_ns
            last = t.stop_ns - max(e[2] for e in t.events)
            run.note(f"trace: {len(t.events)} device events over "
                     f"{t.window_s:.6f} s, the first {first} ns after the "
                     f"start, the last ending {last} ns before the stop")

    # the program's state goes before the reference runs on the device
    run.system = None
    loop = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = compare(run)
    checks = {k: {"value": found[k], "limit": cell.limits[k]}
              for k in CHECKS}
    correct = (found["compared"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    served = run.window.served()
    run.note(f"window {run.window.seconds:.6f} s, {run.window.began} began, "
             f"{len(served)} served, {found['compared']} compared")
    if len(run.window.done) <= 16:
        run.note("completions (s after the start): " + ", ".join(
            f"{d.t_done - run.window.start:.3f}" for d in run.window.done))
    result = {"correct": bool(correct), "attempted": run.window.began,
              "failed": run.window.began - len(served), "metrics": metrics,
              "device": devinfo}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_notes"] = run.notes
    return result
