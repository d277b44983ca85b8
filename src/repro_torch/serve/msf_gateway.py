"""MSF serving gateway: plan-LRU, same-key batching and a retry ladder.

Port of ``repro/serve/msf_gateway.py``.  A stream of graph requests is
admitted into a queue; the gateway groups same-key requests into
batches and replays one measured ``RoundPlan`` on each batch
(``core/distributed_sharded.py: execute_plan_batched``), so a shape
that repeats pays its measurement pass once.  The reference serves on a
device mesh; here the shards are the stacked ``[p, ...]`` axis of the
port's engine, given as ``num_shards`` (an int ``p`` or an ``(R, C)``
pair), on ``device`` (the CUDA card unless the caller passes ``"cpu"``).

Request lifecycle::

    submit(req)
      ├─ ``validate_graph`` admission control: NaN/±inf weights,
      │  out-of-range vertex ids, mismatched arrays and over-cap edge
      │  lists are rejected with a typed ``AdmissionError`` here — a
      │  non-finite weight would alias the engine's padding sentinel
      └─ cache key = plan_cache_key(family, n, p, cap rung, algorithm)
         — the per-shard edge capacity is padded up to the next
         power-of-two rung, so same-family graphs of slightly
         different edge counts land on one shape and one plan
    step()
      ├─ deadline sweep: a request whose ``deadline`` (seconds from
      │  submit) already passed is rejected, not served late
      ├─ admit up to ``batch_slots`` queued ready requests sharing the
      │  queue head's key (backoff-deferred requests and other keys
      │  keep their queue order)
      ├─ plan-LRU lookup (hit → reuse; miss → measure + pad + insert,
      │  LRU-evict past ``cache_size``)
      ├─ batched planned replay with ``replan="defer"`` (and optionally
      │  ``verify=True``): a request the plan does not fit, or whose
      │  forest fails verification, comes back flagged, and the gateway
      │  runs the retry ladder:
      │    retry budget left → one measured replan (the driver, with
      │      certified checkpoints every ``ckpt_every`` rounds, resumed
      │      from the request's last one), verified again — success
      │      serves the request (``served_via="replanned"``)
      │    the rung fails → requeue with exponential backoff
      │      (``backoff_base * 2**retries``)
      │    budget exhausted → typed rejection: every flagged request
      │      serves or rejects within ``max_retries_per_request``
      ├─ circuit breaker: ``breaker_threshold`` consecutive steps with a
      │  still-failing request drop the entry from the LRU and reject
      │  its requeued requests
      └─ drift: past ``replan_threshold`` replans per served request
         (after ``min_samples``) the entry is re-measured off a graph
         that did not fit and padded by ``pad_margin``

Every served result has overflow 0 and reduces to the undirected input
edges through ``eid``; with ``verify=True`` it also passed
``core/verify.py``.  Rejections are never silent: the request is marked
``served_via="rejected"`` with ``error`` set and ``GatewayStats`` counts
them.  The clock is this module's ``time`` (``monotonic``, ``sleep``),
which a test may replace.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, List, Optional

import numpy as np

from repro_torch.core.distributed import build_dist_graph
from repro_torch.core.distributed_sharded import (DEFAULT_CKPT_EVERY,
                                                  _replan_with_plan,
                                                  execute_plan_batched,
                                                  plan_sharded_msf,
                                                  shard_layout)
from repro_torch.core.graph import CapacityError
from repro_torch.core.msf_checkpoint import CheckpointError, MSFCheckpoint
from repro_torch.core.plan import RoundPlan, plan_cache_key
from repro_torch.core.verify import VerifyFailure, verify_forest
from repro_torch.device import DeviceLike, resolve_device


class GatewayError(RuntimeError):
    """Base of the gateway's typed serving errors."""


class AdmissionError(GatewayError, ValueError):
    """A request failed admission control (``validate_graph``); also a
    ``ValueError``."""


def validate_graph(u, v, w, n: int, *, max_edges: Optional[int] = None,
                   rid: Optional[int] = None) -> None:
    """Admission control: reject graphs the engine cannot serve honestly.

    Raises ``AdmissionError`` for: ``n < 1``; mismatched edge-array
    lengths; non-integer endpoint arrays; NaN/±inf weights (``+inf`` is
    the engine's padding sentinel: admitting it would drop the edge, a
    wrong MSF with no signal); endpoint ids outside ``[0, n)``; more
    than ``max_edges`` edges (when given).  Self-loops and duplicate
    edges are tolerated: the engines handle both.
    """
    tag = f"request {rid}: " if rid is not None else ""
    if n < 1:
        raise AdmissionError(tag + "n must be >= 1")
    u = np.asarray(u)
    v = np.asarray(v)
    w = np.asarray(w)
    if not (len(u) == len(v) == len(w)):
        raise AdmissionError(
            tag + f"edge arrays disagree in length "
            f"({len(u)}/{len(v)}/{len(w)})")
    if max_edges is not None and len(u) > max_edges:
        raise AdmissionError(
            tag + f"{len(u)} edges exceed the admission cap "
            f"max_edges={max_edges}")
    if len(u) == 0:
        return
    if not (np.issubdtype(u.dtype, np.integer)
            and np.issubdtype(v.dtype, np.integer)):
        raise AdmissionError(tag + "endpoint arrays must be integer-"
                             f"typed (got {u.dtype}/{v.dtype})")
    nonfinite = int((~np.isfinite(np.asarray(w, np.float32))).sum())
    if nonfinite:
        raise AdmissionError(
            tag + f"{nonfinite} weights are NaN/±inf; finite float32 "
            "required (+inf is the engine's padding sentinel and would "
            "silently drop the edge)")
    oob = int(((u < 0) | (u >= n) | (v < 0) | (v >= n)).sum())
    if oob:
        raise AdmissionError(
            tag + f"{oob} endpoint ids outside [0, {n})")


@dataclasses.dataclass
class MSFRequest:
    """One graph to solve: undirected host edge arrays + vertex count.

    ``family`` is the traffic label of the plan-cache key (a wrong label
    can only cost replans, never correctness).  ``deadline`` optionally
    bounds serving latency (seconds from submit): a request still queued
    past it is rejected, never served late.  The gateway fills the
    results: ``edges`` are indices into the request's input arrays,
    ``weight``/``count`` the forest's weight and edge count,
    ``served_via`` is ``"batched"``, ``"replanned"`` or ``"rejected"``
    (``error`` says why; ``retries`` counts ladder attempts).
    """
    rid: int
    family: str
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    n: int
    deadline: Optional[float] = None
    edges: Optional[np.ndarray] = None
    weight: float = 0.0
    count: int = 0
    done: bool = False
    served_via: str = ""
    error: str = ""
    retries: int = 0
    latency: float = 0.0
    _t_submit: float = 0.0
    _not_before: float = 0.0   # backoff gate (monotonic clock)
    # the last certified checkpoint of a retry rung: the next rung
    # resumes there instead of re-executing from round 0
    _ckpt: Optional[MSFCheckpoint] = None


@dataclasses.dataclass
class GatewayStats:
    submitted: int = 0
    served: int = 0
    batches: int = 0
    hits: int = 0           # plan-cache lookups that found an entry
    misses: int = 0         # lookups that measured a fresh plan
    evictions: int = 0      # LRU entries dropped at capacity
    replans: int = 0        # requests served via a measured fallback
    refreshes: int = 0      # drift-triggered entry re-measurements
    rejected: int = 0       # admission / budget / breaker rejections
    retried: int = 0        # retry-ladder attempts (flagged requests)
    deadline_missed: int = 0  # ... of the rejections, past-deadline ones
    breaker_trips: int = 0  # cache entries dropped by the breaker
    verify_failures: int = 0  # self-check failures (verify=True only)
    resumed: int = 0        # ladder rungs resumed from a checkpoint
    rounds_saved: int = 0   # rounds not re-executed thanks to resume

    @property
    def hit_rate(self) -> float:
        lookups = self.hits + self.misses
        return self.hits / lookups if lookups else 0.0

    @property
    def replan_rate(self) -> float:
        return self.replans / self.served if self.served else 0.0


@dataclasses.dataclass
class _CacheEntry:
    plan: RoundPlan
    cap: int               # the padded per-shard capacity (ladder rung)
    served: int = 0        # requests executed under this entry
    replans: int = 0       # ... of which the plan did not fit
    fails: int = 0         # consecutive steps with a still-failing req


class MSFGateway:
    """Continuous-batching MSF server over ``num_shards`` stacked shards.

    ``pallas_minedges`` is the planner's lever: it routes both MINEDGES
    reductions of every measured, replayed and replanned round through
    K1, and it is a bit of the cache key.
    """

    def __init__(self, num_shards, *, device: DeviceLike = None,
                 algorithm: str = "boruvka",
                 cache_size: int = 8, batch_slots: int = 4,
                 pad_margin: float = 0.25,
                 replan_threshold: float = 0.34, min_samples: int = 6,
                 max_retries_per_request: int = 2,
                 breaker_threshold: int = 3,
                 backoff_base: float = 0.05,
                 verify: bool = False,
                 max_edges: Optional[int] = None,
                 ckpt_every: Optional[int] = DEFAULT_CKPT_EVERY,
                 pallas_minedges: bool = False):
        self.num_shards = num_shards
        self.p = math.prod(shard_layout(num_shards))
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.cache_size = int(cache_size)
        self.batch_slots = int(batch_slots)
        self.pad_margin = float(pad_margin)
        self.replan_threshold = float(replan_threshold)
        self.min_samples = int(min_samples)
        self.max_retries_per_request = int(max_retries_per_request)
        self.breaker_threshold = int(breaker_threshold)
        self.backoff_base = float(backoff_base)
        self.verify = bool(verify)
        self.max_edges = max_edges
        # checkpoint cadence of the retry rungs (None disables): a failed
        # rung leaves its last certified checkpoint on the request, and
        # the next rung resumes there
        self.ckpt_every = None if ckpt_every is None else int(ckpt_every)
        self.pallas_minedges = bool(pallas_minedges)
        self.queue: Deque[MSFRequest] = collections.deque()
        # key -> entry; the OrderedDict's order is the LRU order
        self.cache: "collections.OrderedDict[str, _CacheEntry]" = \
            collections.OrderedDict()
        self.stats = GatewayStats()

    # -- keying ------------------------------------------------------------

    def _cap_rung(self, req: MSFRequest) -> int:
        """Per-shard edge capacity padded up to the power-of-two ladder."""
        need = max(1, -(-2 * len(req.u) // self.p))
        return 1 << (need - 1).bit_length()

    def _key(self, req: MSFRequest) -> str:
        return plan_cache_key(req.family, req.n, self.p,
                              self._cap_rung(req), self.algorithm,
                              pallas_minedges=self.pallas_minedges)

    # -- admission ---------------------------------------------------------

    def submit(self, req: MSFRequest) -> None:
        """Admit one request, or reject it with a typed error.

        Raises ``AdmissionError`` (a ``ValueError``) on malformed input;
        the request is also marked ``served_via="rejected"`` with
        ``error`` set.
        """
        try:
            validate_graph(req.u, req.v, req.w, req.n,
                           max_edges=self.max_edges, rid=req.rid)
        except AdmissionError as e:
            req.error = str(e)
            req.served_via = "rejected"
            req.done = True
            self.stats.rejected += 1
            raise
        req._t_submit = time.monotonic()
        self.queue.append(req)
        self.stats.submitted += 1

    def _reject(self, req: MSFRequest, reason: str,
                deadline: bool = False) -> None:
        req.error = reason
        req.served_via = "rejected"
        req.done = True
        self.stats.rejected += 1
        if deadline:
            self.stats.deadline_missed += 1

    # -- serving -----------------------------------------------------------

    def step(self) -> List[MSFRequest]:
        """Serve one batch: admit same-key ready requests, replay, run
        the retry ladder, fill results.

        Returns the requests completed by this step, served or rejected;
        a backoff-requeued request completes in a later step.
        """
        now = time.monotonic()
        # deadline sweep: expired requests reject instead of serving late
        expired: List[MSFRequest] = []
        alive: Deque[MSFRequest] = collections.deque()
        while self.queue:
            r = self.queue.popleft()
            if r.deadline is not None and now - r._t_submit > r.deadline:
                self._reject(
                    r, f"deadline {r.deadline}s exceeded "
                    f"({now - r._t_submit:.3f}s queued)", deadline=True)
                expired.append(r)
            else:
                alive.append(r)
        self.queue = alive
        head = next((r for r in self.queue if r._not_before <= now), None)
        if head is None:
            if self.queue:  # everything is backoff-deferred: wait it out
                wait = min(r._not_before for r in self.queue) - now
                if wait > 0:
                    time.sleep(min(wait, 0.1))
            return expired
        key = self._key(head)
        batch: List[MSFRequest] = []
        rest: Deque[MSFRequest] = collections.deque()
        while self.queue:
            r = self.queue.popleft()
            if (len(batch) < self.batch_slots and r._not_before <= now
                    and self._key(r) == key):
                batch.append(r)
            else:
                rest.append(r)
        self.queue = rest

        cap = self._cap_rung(batch[0])
        n = batch[0].n
        graphs = []
        kept: List[MSFRequest] = []
        for r in batch:
            try:
                graphs.append(build_dist_graph(r.u, r.v, r.w, n, self.p,
                                               cap=cap,
                                               device=self.device)[0])
                kept.append(r)
            except CapacityError as e:
                # the rung covers 2m/p by construction; this guards
                # hostile capacity paths
                self._reject(r, f"capacity: {e}")
                expired.append(r)
        batch = kept
        if not batch:
            return expired

        entry = self.cache.get(key)
        if entry is not None:
            self.cache.move_to_end(key)
            self.stats.hits += 1
        else:
            self.stats.misses += 1
            try:
                entry = self._measure(key, graphs[0], n, cap)
            except (RuntimeError, CapacityError) as e:
                # a measurement pass that cannot complete (e.g. faulted
                # exchanges) rejects the batch instead of crashing run()
                for r in batch:
                    self._reject(r, f"plan measurement failed: {e}")
                    expired.append(r)
                return expired

        results, flagged = execute_plan_batched(
            graphs, n, self.num_shards, entry.plan, replan="defer",
            verify=self.verify, device=self.device)
        entry.served += len(batch)
        entry.replans += len(flagged)

        # retry ladder: every flagged request serves via one measured
        # replan, requeues with backoff, or rejects — bounded per
        # request by max_retries_per_request, so run() cannot loop
        replanned: List[int] = []
        requeued: List[MSFRequest] = []
        still_failing = False
        for i in flagged:
            req = batch[i]
            req.retries += 1
            self.stats.retried += 1
            if req.retries > self.max_retries_per_request:
                still_failing = True
                self._reject(
                    req, f"retry budget exhausted ({req.retries - 1} "
                    f"of {self.max_retries_per_request} retries used)")
                continue
            # deadline re-check per rung: the sweep ran before the
            # batched replay, which may have taken the request past it
            now_r = time.monotonic()
            if (req.deadline is not None
                    and now_r - req._t_submit > req.deadline):
                self._reject(
                    req, f"deadline {req.deadline}s exceeded before "
                    f"retry dispatch ({now_r - req._t_submit:.3f}s "
                    "since submit)", deadline=True)
                continue
            # past half the deadline a checkpoint costs more than a
            # resume could save
            ck_every = self.ckpt_every
            if (ck_every and req.deadline is not None
                    and now_r - req._t_submit > 0.5 * req.deadline):
                ck_every = None
            cks: List[MSFCheckpoint] = []
            res = None
            try:
                if req._ckpt is not None:
                    self.stats.resumed += 1
                    self.stats.rounds_saved += req._ckpt.round_index
                res = _replan_with_plan(graphs[i], n, self.num_shards,
                                        entry.plan, ckpt_every=ck_every,
                                        ckpt_out=cks if ck_every else None,
                                        resume_from=req._ckpt)
                ovf = int(res[4])
                if ovf != 0:
                    req.error = f"replan overflowed ({ovf})"
                    res = None
                elif self.verify:
                    verify_forest(graphs[i], n, self.num_shards, res[0],
                                  res[3], expected_weight=float(res[1]),
                                  expected_count=int(res[2]),
                                  device=self.device)
            except VerifyFailure as e:
                self.stats.verify_failures += 1
                req.error = str(e)
                res = None
            except CheckpointError as e:
                # a checkpoint that fails restore validation is dropped:
                # the next rung re-executes from round 0
                req._ckpt = None
                req.error = f"checkpoint restore failed: {e}"
                res = None
            except (RuntimeError, CapacityError) as e:
                req.error = f"replan failed: {e}"
                res = None
            if cks:
                # keep the furthest certified checkpoint for a later rung
                req._ckpt = cks[-1]
            if res is not None:
                results[i] = res
                replanned.append(i)
                continue
            still_failing = True
            if req.retries >= self.max_retries_per_request:
                self._reject(
                    req, f"failed after {req.retries} retries: "
                    + (req.error or "unrecoverable"))
            else:
                req._not_before = time.monotonic() \
                    + self.backoff_base * (2 ** (req.retries - 1))
                self.queue.append(req)
                requeued.append(req)

        # circuit breaker: consecutive failing steps drop the entry (the
        # next miss measures afresh) and reject the requeued requests
        if still_failing:
            entry.fails += 1
            if entry.fails >= self.breaker_threshold:
                if key in self.cache and self.cache[key] is entry:
                    self.cache.pop(key)
                self.stats.breaker_trips += 1
                for req in requeued:
                    try:
                        self.queue.remove(req)
                    except ValueError:
                        pass
                    self._reject(req, "circuit breaker tripped: entry "
                                 f"{key!r} quarantined after "
                                 f"{entry.fails} consecutive failing "
                                 "steps")
        else:
            entry.fails = 0

        # drift: a key whose traffic keeps outgrowing its plan gets one
        # fresh measurement (off a graph that did not fit) and new
        # pad() headroom, instead of replanning forever
        if (flagged and self.cache.get(key) is entry
                and entry.served >= self.min_samples
                and entry.replans / entry.served > self.replan_threshold):
            self._measure(key, graphs[flagged[-1]], n, cap)
            self.stats.refreshes += 1

        now = time.monotonic()
        completed: List[MSFRequest] = list(expired)
        for i, (req, res) in enumerate(zip(batch, results)):
            if res is None:
                if req.done:        # rejected by the ladder/breaker
                    completed.append(req)
                continue            # requeued: completes in a later step
            # one host copy of the mask and the scalars per request
            mask = res[0].cpu().numpy()
            eid = graphs[i].eid.cpu().numpy()
            req.edges = np.unique(eid[mask])
            req.weight = float(res[1])
            req.count = int(res[2])
            req.served_via = "replanned" if i in replanned else "batched"
            req.latency = now - req._t_submit
            req.done = True
            self.stats.served += 1
            completed.append(req)
        self.stats.replans += len(replanned)
        self.stats.batches += 1
        return completed

    def run(self, max_steps: int = 100_000) -> None:
        steps = 0
        while self.queue and steps < max_steps:
            self.step()
            steps += 1

    # -- plan lifecycle ----------------------------------------------------

    def _measure(self, key: str, graph, n: int, cap: int) -> _CacheEntry:
        """Measure a plan off ``graph``, pad it, (re)install the entry."""
        plan = plan_sharded_msf(graph, n, self.num_shards,
                                algorithm=self.algorithm,
                                pallas_minedges=self.pallas_minedges)
        assert plan.cache_key(key.split("|", 1)[0]) == key, \
            (plan.cache_key(key.split("|", 1)[0]), key)
        entry = _CacheEntry(plan=plan.pad(self.pad_margin), cap=cap)
        self.cache[key] = entry
        self.cache.move_to_end(key)
        while len(self.cache) > self.cache_size:
            self.cache.popitem(last=False)
            self.stats.evictions += 1
        return entry
