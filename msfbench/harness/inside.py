"""The program's own spans and counters (``repro_torch.tracing``), as the
per-layer readers that name them read them.

A reader's ``install(run)`` calls ``install`` here: it turns the
program's recorder on once the set-up is done (the harness installs
readers after it), so the warm-up is not recorded.  The first
``recorded(run)`` after the window turns it off and keeps what it
recorded on ``run.counters``; later readers read that.  Against a
program without the recorder both do nothing, and every reader returns
None.  A label's seconds are the union of its spans, so a span nested
in one of its own label counts once; times are ``time.time_ns()``, the
clock of the window and of the profiler's device events.
"""
from __future__ import annotations

import bisect
import importlib
from typing import Dict, List, Optional, Tuple

import torch

from msfbench.harness.devtrace import gaps, union_seconds
from msfbench.harness.spans import Spans

KEY = "inside"


def _tracing():
    try:
        return importlib.import_module("repro_torch.tracing")
    except ImportError:  # a program without the recorder
        return None


def install(run) -> None:
    tracing = _tracing()
    if tracing is not None:
        tracing.enable()


def recorded(run):
    """The program's ``Trace`` of the run (None without the recorder)."""
    if KEY not in run.counters:
        tracing = _tracing()
        run.counters[KEY] = None if tracing is None else tracing.disable()
    return run.counters[KEY]


def spans_of(trace, label: str) -> List[Tuple[str, int, int]]:
    return [r for r in trace.records if r[0] == label]


def span_share(run, label: str) -> Optional[float]:
    """The share of the window (%) under the program's span ``label``;
    None where the program recorded no such span."""
    w, trace = run.window, recorded(run)
    spans = [] if trace is None else spans_of(trace, label)
    if not (w.done and spans):
        return None
    return 100.0 * union_seconds(spans, w.start_ns, w.end_ns) / w.seconds


def event_seconds(trace, label: str, lo: int, hi: int) -> Optional[float]:
    """The card's seconds between the start and end events of each span
    ``label`` that began in ``[lo, hi]``; None where there are none (no
    card, or no such span)."""
    pairs = [] if trace is None else [
        (s, e) for t0, s, e in trace.events.get(label, ()) if lo <= t0 <= hi]
    if not pairs:
        return None
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / 1e3


def idle_under(trace, devtrace, outer: str) -> Optional[Dict[str, float]]:
    """The card's idle seconds in the traced window whose middle lies
    under a span ``outer``, by the innermost program span there; None
    without a device trace or without such spans."""
    if trace is None or devtrace is None or devtrace.window_s <= 0:
        return None
    solves = sorted((t0, t1) for _, t0, t1 in spans_of(trace, outer))
    if not solves:
        return None
    starts = [t0 for t0, _ in solves]
    ends, top = [], 0
    for _, t1 in solves:  # the furthest end of the spans begun so far
        top = max(top, t1)
        ends.append(top)
    inner = Spans()
    lo, hi = devtrace.start_ns, devtrace.stop_ns
    inner.records = [r for r in trace.records if r[2] >= lo and r[1] <= hi]
    label = inner.labeller()
    by: Dict[str, float] = {}
    for a, b in gaps(devtrace.events, lo, hi):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and ends[i] >= mid:
            name = label(mid)
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return by
