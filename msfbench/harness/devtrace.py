"""The device's side of a traced window, from ``torch.profiler``.

``DeviceTrace`` profiles the card's activity (kernels, copies, memsets
through CUPTI; no host operators, so the trace stays small over a long
window) between ``start`` and ``stop``.  From the events it gives the
seconds in which any operation ran (the union of their intervals), the
operations that took the most time by name, and the idle gaps between
them, each named by the host span the benchmark recorded around it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

Interval = Tuple[str, int, int]  # name, start ns, end ns


def union_seconds(intervals: List[Interval], lo: int, hi: int) -> float:
    """Seconds of ``[lo, hi]`` covered by at least one interval."""
    total = 0
    cur_s = cur_e = None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals: List[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The idle stretches of ``[lo, hi]``: where no interval runs."""
    out = []
    cursor = lo
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def top_ops(intervals: List[Interval], lo: int, hi: int,
            k: int = 10) -> List[List]:
    """The ``k`` operation names with the most device seconds."""
    by: Dict[str, int] = {}
    for name, s, e in intervals:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by[name] = by.get(name, 0) + d
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_by_host(intervals: List[Interval], lo: int, hi: int,
                 label: Callable[[int], str], k: int = 10) -> List[List]:
    """The device's idle seconds summed by what the host was in at the
    middle of each gap (the innermost recorded span), the ``k`` largest."""
    by: Dict[str, int] = {}
    for a, b in gaps(intervals, lo, hi):
        name = label((a + b) // 2)
        by[name] = by.get(name, 0) + (b - a)
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in ranked]


class DeviceTrace:
    """``torch.profiler`` over the card's activity alone."""

    def __init__(self) -> None:
        self.start_ns = self.stop_ns = 0
        self.events: List[Interval] = []
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        """End the trace and read its events; a second call does nothing."""
        import torch
        if self._prof is None:
            return
        torch.cuda.synchronize()
        self.stop_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        self.events = []
        for ev in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(ev.device_type()):
                continue
            s = ev.start_ns() if hasattr(ev, "start_ns") \
                else int(ev.start_us() * 1000)
            d = ev.duration_ns() if hasattr(ev, "duration_ns") \
                else int(ev.duration_us() * 1000)
            self.events.append((ev.name(), int(s), int(s) + int(d)))
        self._prof = None

    @property
    def window_s(self) -> float:
        return (self.stop_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return union_seconds(self.events, self.start_ns, self.stop_ns)
