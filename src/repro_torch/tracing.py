"""Spans and counters inside the program, off unless a caller turns them on.

One recorder per process.  ``enable()`` clears it and turns it on,
``disable()`` turns it off and hands back what it recorded as a
``Trace``.  While it is off, ``span`` returns one shared no-op context
and ``count`` returns at once: no record, no CUDA event, no host sync,
no allocation.

``span(label, device=None)`` records ``(label, start ns, end ns)`` on
``time.time_ns()``, the clock ``torch.profiler`` places the card's
events on, so a span and the device's activity line up with no
conversion.  Given a CUDA ``device``, the span also records a pair of
``torch.cuda.Event(enable_timing=True)`` on that device's current
stream around its body, with no host sync; the pair is resolved
(``torch.cuda.synchronize()``, then ``elapsed_time``) only by whoever
reads the ``Trace``.  Spans of one label may nest, and every span is
recorded: a reader that wants a label's wall time takes the union of
its intervals.

Usage::

    from repro_torch import tracing
    tracing.enable()
    ...                       # solves
    trace = tracing.disable()
    trace.records             # [(label, t0_ns, t1_ns), ...]
    trace.events["static.minedges"]   # [(t0_ns, start, end), ...]
    trace.counters["static.rounds"]

The labels the program records, and the metric that reads each, are
listed in ``PERF.md`` (section 3): among them the sharded engine's
``sharded.prep`` span (its local preprocessing, timed on the card too)
and the counters ``prep.rounds``, ``prep.forest_edges`` and
``sharded.forest_edges``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

Record = Tuple[str, int, int]          # label, start ns, end ns
EventPair = Tuple[int, object, object]  # start ns, start event, end event


@dataclasses.dataclass
class Trace:
    """What one ``enable()`` … ``disable()`` stretch recorded."""
    records: List[Record] = dataclasses.field(default_factory=list)
    events: Dict[str, List[EventPair]] = dataclasses.field(
        default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Off:
    """The context every span returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Recorder:
    def __init__(self) -> None:
        self.on = False
        self.trace = Trace()


_REC = _Recorder()


class _Span:
    __slots__ = ("label", "device", "t0", "start")

    def __init__(self, label: str, device: Optional[torch.device]) -> None:
        self.label = label
        self.device = device
        self.start = None

    def __enter__(self) -> None:
        if self.device is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        self.t0 = time.time_ns()

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        trace = _REC.trace
        trace.records.append((self.label, self.t0, t1))
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            trace.events.setdefault(self.label, []).append(
                (self.t0, self.start, end))
        return False


def span(label: str, device: Optional[torch.device] = None):
    """A context that records its body under ``label`` while the
    recorder is on; with a CUDA ``device``, timed on the card too."""
    if not _REC.on:
        return OFF
    if device is not None and device.type != "cuda":
        device = None
    return _Span(label, device)


def recording() -> bool:
    """Whether the recorder is on: a counter whose value needs a host read
    of a device tensor takes that read only then."""
    return _REC.on


def count(label: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``label`` while the recorder is on."""
    if not _REC.on:
        return
    counters = _REC.trace.counters
    counters[label] = counters.get(label, 0) + n


def enable() -> None:
    """Clear the recorder and turn it on; nothing if it is on already."""
    if _REC.on:
        return
    _REC.trace = Trace()
    _REC.on = True


def disable() -> Trace:
    """Turn the recorder off and return what it recorded (an empty
    ``Trace`` if it was off)."""
    trace = _REC.trace if _REC.on else Trace()
    _REC.on = False
    _REC.trace = Trace()
    return trace
