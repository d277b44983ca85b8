"""The ``"gateway"`` driver: a saturated queue into the serving gateway.

``MSFGateway.submit``/``step`` (``batch_slots``, ``verify``, the
configuration's ``engine_options``), topped up before each step so that
``queue_batches`` batches wait; requests cycle over the ``pool`` graphs
of one shape, each the host arrays of its graph.  Parameters:
``algorithm``, ``pool``, ``batch_slots``, ``queue_batches``, ``verify``.
Set-up serves one warm request of each pool graph; the first measures
and caches the plan, and a graph that the plan does not fit is served
through the gateway's replan, in set-up as in the window.  The window
finishes the step in flight and any request that step flagged for a
retry; requests still queued and never begun are withdrawn.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch

from msfbench.harness.drive import (DRAIN_S, Done, Keep, Window, make_pool,
                                    sync)
from msfbench.reference import msf as reference

SERVED = ("batched", "replanned")


@dataclasses.dataclass
class _Request:
    """The control's stand-in for ``MSFRequest``."""
    rid: int
    family: str
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    n: int
    edges: Optional[np.ndarray] = None
    weight: float = 0.0
    done: bool = False
    served_via: str = ""
    error: str = ""
    retries: int = 0
    latency: float = 0.0
    _t_submit: float = 0.0


class ControlGateway:
    """The reference in bfloat16 behind the gateway's submit/step: each
    step serves up to ``batch_slots`` queued requests."""

    def __init__(self, batch_slots: int, device: torch.device) -> None:
        self.batch_slots = batch_slots
        self.device = device
        self.queue: collections.deque = collections.deque()

    def submit(self, req) -> None:
        req._t_submit = time.monotonic()
        self.queue.append(req)

    def step(self):
        out = []
        for _ in range(min(self.batch_slots, len(self.queue))):
            r = self.queue.popleft()
            t = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            mask, weight = reference.msf(t(r.u), t(r.v), t(r.w), r.n,
                                         weight_dtype=torch.bfloat16)
            r.edges = np.flatnonzero(mask.cpu().numpy())
            r.weight = weight
            r.served_via = "batched"
            r.done = True
            out.append(r)
        now = time.monotonic()
        for r in out:
            r.latency = now - r._t_submit
        return out


def prepare(run) -> Callable:
    cfg, trf, dev = run.config, run.cell.traffic, run.device
    pool = make_pool(cfg, run.seed, int(trf["pool"]), dev)
    host = [(g.u.cpu().numpy(), g.v.cpu().numpy(), g.w.cpu().numpy(), g.n)
            for g in pool]
    run.pool = pool
    slots = int(trf["batch_slots"])
    if run.control:
        gw = ControlGateway(slots, dev)
        request = _Request
    else:
        from repro_torch.serve.msf_gateway import MSFGateway, MSFRequest
        gw = MSFGateway(cfg["num_shards"], device=dev,
                        algorithm=trf["algorithm"], batch_slots=slots,
                        verify=bool(trf["verify"]),
                        **cfg.get("engine_options", {}))
        request = MSFRequest
    run.system = gw
    family = cfg["family"]

    def make(rid: int):
        u, v, w, n = host[rid % len(host)]
        return request(rid=rid, family=family, u=u, v=v, w=w, n=n)

    for i in range(len(host)):
        warm = make(i)
        warm.rid = -1 - i
        gw.submit(warm)
        while not warm.done:
            gw.step()
        if warm.served_via not in SERVED:
            raise RuntimeError(
                f"the warm request was not served: {warm.error}")
    sync(dev)
    warm_stats = {k: getattr(gw.stats, k) for k in (
        "served", "batches", "hits", "misses", "replans", "refreshes",
        "rejected")} if hasattr(gw, "stats") else {}
    step = run.spans.span("gateway.step", gw.step)
    depth = slots * int(trf["queue_batches"])
    keep = Keep(run.seed)

    def record(window: Window, reqs, begun: dict) -> None:
        t = time.perf_counter()
        for r in reqs:
            if r.rid not in begun:
                continue
            d = Done(r.rid, r.rid % len(host), len(r.u), r.latency, t)
            if r.served_via not in SERVED:
                d.error = r.served_via + ": " + r.error
            elif keep(r.rid):
                d.answer = (r.edges, float(r.weight))
            window.done.append(d)

    def loop(window: Window, seconds: float) -> None:
        rid = 0
        begun = {}
        while time.perf_counter() - window.start < seconds:
            while len(gw.queue) < depth:
                gw.submit(make(rid))
                rid += 1
            # the step admits up to batch_slots requests of the head's key
            for r in list(gw.queue)[:slots]:
                begun[r.rid] = r
            try:
                finished = step()
            except Exception:
                traceback.print_exc(file=sys.stderr)
                break
            record(window, finished, begun)
            window.tick()
        # withdraw what never began; finish what a step flagged
        gw.queue = collections.deque(r for r in gw.queue if r.rid in begun)
        close = time.perf_counter()
        while gw.queue and time.perf_counter() - close < DRAIN_S:
            record(window, step(), begun)
        finished = {d.index for d in window.done}
        for rid_, r in begun.items():
            if rid_ not in finished:
                window.done.append(Done(rid_, rid_ % len(host), len(r.u),
                                        0.0, time.perf_counter(),
                                        error="never served"))
        window.began = len(begun)
        if hasattr(gw, "stats"):
            run.note("gateway, set-up + window: " + ", ".join(
                f"{k} {warm_stats[k]} + {getattr(gw.stats, k) - warm_stats[k]}"
                for k in warm_stats))
    return loop
