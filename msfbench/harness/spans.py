"""Host spans around named program functions, recorded from outside.

A site is ``"module:attr"`` or ``"module:Class.attr"``; ``Spans.wrap``
replaces the attribute with a wrapper that records the wall-clock
interval of each call under a label, and ``Spans.restore`` puts every
original back.  A call nested in another call of the same label is
counted once, so a label's seconds never exceed the wall time they
cover.  Times are ``time.time_ns()``, the clock the profiler's device
events are placed on, so an idle gap on the device can be named by the
span the host was in.
"""
from __future__ import annotations

import bisect
import functools
import importlib
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple


def resolve(site: str) -> Tuple[object, str]:
    """(owner object, attribute name) of ``"module:attr"`` or
    ``"module:Class.attr"``."""
    module, _, path = site.partition(":")
    if not path:
        raise ValueError(f"site {site!r} is not 'module:attr'")
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    if not hasattr(owner, attr):
        raise AttributeError(f"site {site!r}: no attribute {attr!r}")
    return owner, attr


class Spans:
    """Recorded intervals by label, and the wrappers that record them."""

    def __init__(self) -> None:
        # (label, start ns, end ns)
        self.records: List[Tuple[str, int, int]] = []
        self._open: Dict[str, int] = {}
        self._saved: List[Tuple[object, str, object]] = []

    def span(self, label: str, fn: Callable) -> Callable:
        """``fn`` wrapped to record its calls under ``label``."""

        @functools.wraps(fn)
        def run(*args, **kw):
            outer = self._open.get(label, 0) == 0
            self._open[label] = self._open.get(label, 0) + 1
            t0 = time.time_ns()
            try:
                return fn(*args, **kw)
            finally:
                t1 = time.time_ns()
                self._open[label] -= 1
                if outer:
                    self.records.append((label, t0, t1))
        return run

    def replace(self, site: str, make: Callable[[Callable], Callable]
                ) -> None:
        """Put ``make(original)`` at ``site`` until ``restore``."""
        owner, attr = resolve(site)
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        setattr(owner, attr, make(fn))

    def wrap(self, label: str, sites: Iterable[str]) -> None:
        for site in sites:
            self.replace(site, lambda fn: self.span(label, fn))

    def restore(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    def seconds(self, label: str, start_ns: int = 0,
                end_ns: Optional[int] = None) -> float:
        """Wall seconds spent under ``label`` within ``[start, end]``."""
        end_ns = end_ns if end_ns is not None else 1 << 63
        total = 0
        for name, t0, t1 in self.records:
            if name == label:
                total += max(0, min(t1, end_ns) - max(t0, start_ns))
        return total / 1e9

    def labeller(self) -> Callable[[int], str]:
        """A function from an instant (ns) to the label of the innermost
        span around it ("unwrapped" where there is none)."""
        # spans of one thread nest: flatten them into disjoint segments,
        # each carrying the label of the innermost span open over it
        bounds: List[int] = []
        labels: List[str] = []
        stack: List[Tuple[str, int]] = []
        cursor = None
        for name, t0, t1 in sorted(self.records,
                                   key=lambda r: (r[1], -r[2])):
            while stack and stack[-1][1] <= t0:
                done = stack.pop()
                bounds.append(cursor)
                labels.append(done[0])
                cursor = done[1]
            if stack:
                bounds.append(cursor)
                labels.append(stack[-1][0])
            else:
                if cursor is not None:
                    bounds.append(cursor)
                    labels.append("unwrapped")
            cursor = t0
            stack.append((name, t1))
        while stack:
            done = stack.pop()
            bounds.append(cursor)
            labels.append(done[0])
            cursor = done[1]
        if cursor is not None:
            bounds.append(cursor)
            labels.append("unwrapped")

        def label(t: int) -> str:
            i = bisect.bisect_right(bounds, t) - 1
            return labels[i] if i >= 0 else "unwrapped"
        return label
