"""The benchmark's arithmetic: rates over a window, percentiles, shares."""
from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least a
    share ``q`` of the values at or below it."""
    ys = sorted(values)
    if not ys:
        raise ValueError("no values")
    if not 0 < q <= 1:
        raise ValueError(f"q={q} outside (0, 1]")
    return ys[max(0, math.ceil(q * len(ys)) - 1)]


def beyond(values: Sequence[float], q: float) -> int:
    """How many values lie above the ``q`` percentile."""
    cut = percentile(values, q)
    return sum(1 for x in values if x > cut)


def served_rate(run):
    """The input edges of every answer the window served over the time
    from its start to the last completion; None where none was served."""
    served = run.window.served()
    if not served:
        return None
    return rate(sum(d.edges for d in served), run.window.seconds)


def span_share(run, label: str):
    """The share of the window (%) spent under the span ``label``."""
    w = run.window
    if not w.done:
        return None
    return 100.0 * run.spans.seconds(label, w.start_ns, w.end_ns) / w.seconds


def idle_share(run):
    """The share of the traced window (%) in which no operation ran on
    the card."""
    t = run.devtrace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def peak_gib(run):
    """The card's allocated peak over the window, in GiB."""
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30
