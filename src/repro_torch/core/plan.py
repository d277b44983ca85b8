"""Round plans for the sharded MSF engine.

Port of ``repro/core/plan.py``, kept as this package's own copy.  The
shrinking driver (``distributed_sharded.py: _shrinking_capacity_msf``)
sizes every round's exchanges from exact host bounds on the measured
dead mask and label table.  A ``RoundPlan`` makes that schedule a value:

  * ``plan_sharded_msf`` runs the driver once as its measurement pass
    and records, per round, the ladder-snapped capacities it chose, with
    the one-off preprocessing and ghost-setup capacities and the filter
    levels' weight windows;
  * the executor (``distributed_sharded.py: _planned_shard_fn``) runs
    the plan's rounds one after another at those capacities, with no
    host bound and no host copy between rounds;
  * ``pad(margin)`` returns a serving copy with headroom, still on the
    ``shrink_schedule`` ladder, and ``to_json``/``from_json`` make a
    plan durable: it is measured once and replayed in other processes.
    The JSON is byte for byte the reference's, so a plan written by
    either package loads in the other.

Replay contract: running a plan on a graph it does not fit is never
silent.  An undersized capacity shows in the overflow count, a plan with
too few rounds in the executor's residual count, and the entry points
either replan (one fresh measured pass) or raise.

This module is plain host data: it imports no ``torch``.
"""
from __future__ import annotations

import json
import math
from typing import NamedTuple, Optional, Tuple


class RoundSpec(NamedTuple):
    """The capacities of one planned Borůvka round.

    ``cap_edge`` bounds the MINEDGES candidate exchange, ``cap_lookup``
    the endpoint-label lookups, ``cap_contract`` the pointer-doubling
    hops, ``cap_relabel`` the RELABEL requests and ``cap_push`` the ghost
    root-delta push: the five sizes the driver derives every round.
    ``ghost`` records whether the round read the ghost tables (a pinned
    push capacity can drop the cache mid-solve).  ``sentinel`` marks a
    round the measurement pass bounded to zero candidates and so did not
    run: the executor runs it at floor capacities, so its ``go`` flag
    proves on every replay graph that the level is finished.

    ``cap_push_col`` sizes the deputy hop of the two-level grid push and
    is 0 on flat-push plans; it trails with its default so JSON written
    before the grid push still loads.
    """
    level: int
    cap_edge: int
    cap_lookup: int
    cap_contract: int
    cap_relabel: int
    cap_push: int
    ghost: bool
    sentinel: bool = False
    cap_push_col: int = 0


class GhostPlan(NamedTuple):
    """The ghost cache's one-off setup sizes: the two per-shard table
    sizes (the most distinct-endpoint runs of any shard) and the fill
    and root-subscription exchange capacities."""
    table_u: int
    table_v: int
    cap_fill_u: int
    cap_fill_v: int
    cap_subscribe: int


_CAP_FIELDS = ("cap_edge", "cap_lookup", "cap_contract", "cap_relabel",
               "cap_push")


class RoundPlan(NamedTuple):
    """A serialisable schedule for one sharded solve, bound to a shape.

    A plan is valid for any graph built with the same ``n``, shard count
    and per-shard edge capacity.  Its capacities were measured on one
    such graph and transfer to similar ones because they sit on the
    ``core/distributed.py: shrink_schedule`` ladder; whether a transfer
    fits is proved again on every run by the overflow and residual
    counts, and ``pad`` buys headroom first.

    The engine levers (``coalesce`` … ``vsorted_index``) are frozen in
    the plan: its capacities only hold for the exchanges they were
    measured on, so the executor follows the plan, not the caller.
    ``ghost is None`` means the cache was off at plan time.
    """
    n: int
    num_shards: int
    cap_per_shard: int
    algorithm: str
    schedule: str
    local_preprocessing: bool
    coalesce: bool
    src_only: bool
    adaptive_doubling: bool
    relabel_skip: bool
    vsorted_index: bool
    cap_prep: int
    edge_capacity_full: int
    label_capacity_full: int
    lookup_capacity_full: int
    ghost: Optional[GhostPlan]
    level_bounds: Tuple[Tuple[float, float], ...]
    rounds: Tuple[RoundSpec, ...]
    # trailing with defaults, so JSON from before these levers still
    # loads (an absent key means the plain scatter path and the flat push)
    pallas_minedges: bool = False
    grid_push: bool = False

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def validate(self) -> "RoundPlan":
        """Raise ValueError on a structurally broken plan (hand-edited
        or truncated JSON) before it reaches the executor."""
        if self.n < 1 or self.num_shards < 1 or self.cap_per_shard < 1:
            raise ValueError(f"bad plan dims: n={self.n} "
                             f"p={self.num_shards} cap={self.cap_per_shard}")
        if not self.level_bounds or not self.rounds:
            raise ValueError("plan has no levels or no rounds")
        levels = [r.level for r in self.rounds]
        if levels != sorted(levels):
            raise ValueError("plan rounds are not grouped by level")
        if set(levels) != set(range(len(self.level_bounds))):
            raise ValueError(
                f"plan levels {sorted(set(levels))} do not cover the "
                f"{len(self.level_bounds)} level windows (every level "
                "needs >= 1 round, sentinel included)")
        for r in self.rounds:
            for f in _CAP_FIELDS:
                if getattr(r, f) < 1:
                    raise ValueError(f"round {r} has {f} < 1")
        if self.ghost is not None and min(self.ghost) < 1:
            raise ValueError(f"bad ghost sizes: {self.ghost}")
        return self

    def pad(self, margin: float = 0.25) -> "RoundPlan":
        """A copy with every exchange capacity scaled by ``1 + margin``
        and snapped up onto the ladder (never past the flat full), for
        replaying one plan on similar graphs.  The ghost table sizes
        scale too, clamped to the per-shard slot count and not snapped.
        The rounds and weight windows stay: a graph that needs more
        rounds is caught by the residual count."""
        from repro_torch.core.distributed import quantize_capacity
        if margin < 0:
            raise ValueError(f"margin must be >= 0, got {margin}")

        def up(c: int, full: int) -> int:
            return quantize_capacity(
                min(int(math.ceil(c * (1.0 + margin))), full), full)

        fulls = {"cap_edge": self.edge_capacity_full,
                 "cap_lookup": self.lookup_capacity_full,
                 "cap_contract": self.label_capacity_full,
                 "cap_relabel": self.label_capacity_full,
                 "cap_push": self.label_capacity_full}
        # the deputy hop's ceiling is one copy of every owned root per
        # source column; the plan does not know the column count, so
        # label_full * num_shards is the safe ceiling
        col_full = self.label_capacity_full * self.num_shards
        rounds = tuple(
            r._replace(**{f: up(getattr(r, f), fulls[f])
                          for f in _CAP_FIELDS},
                       cap_push_col=(up(r.cap_push_col, col_full)
                                     if r.cap_push_col > 0 else 0))
            for r in self.rounds)
        ghost = self.ghost
        if ghost is not None:
            def up_table(c: int) -> int:
                return min(int(math.ceil(c * (1.0 + margin))),
                           self.cap_per_shard)

            ghost = GhostPlan(
                table_u=up_table(ghost.table_u),
                table_v=up_table(ghost.table_v),
                cap_fill_u=up(ghost.cap_fill_u, self.lookup_capacity_full),
                cap_fill_v=up(ghost.cap_fill_v, self.lookup_capacity_full),
                cap_subscribe=up(ghost.cap_subscribe,
                                 self.label_capacity_full))
        return self._replace(rounds=rounds, ghost=ghost)

    def cache_key(self, family: str = "") -> str:
        """The plan's serving-cache identity: ``plan_cache_key`` of its
        own shape, algorithm and levers, so a key made before a plan
        exists (from a request) and after (from the plan) agree.
        ``family`` is the traffic label the plan was measured under."""
        return plan_cache_key(
            family, self.n, self.num_shards, self.cap_per_shard,
            self.algorithm, schedule=self.schedule,
            local_preprocessing=self.local_preprocessing,
            coalesce=self.coalesce, src_only=self.src_only,
            adaptive_doubling=self.adaptive_doubling,
            relabel_skip=self.relabel_skip,
            vsorted_index=self.vsorted_index,
            pallas_minedges=self.pallas_minedges,
            grid_push=self.grid_push)

    def to_json(self, indent: Optional[int] = None) -> str:
        d = self._asdict()
        d["ghost"] = None if self.ghost is None else self.ghost._asdict()
        d["level_bounds"] = [[_enc(lo), _enc(hi)]
                             for lo, hi in self.level_bounds]
        d["rounds"] = [r._asdict() for r in self.rounds]
        return json.dumps({"version": 1, **d}, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "RoundPlan":
        d = json.loads(text)
        ver = d.pop("version", None)
        if ver != 1:
            raise ValueError(f"unsupported RoundPlan version: {ver!r}")
        d["ghost"] = None if d["ghost"] is None else GhostPlan(**d["ghost"])
        d["level_bounds"] = tuple((_dec(lo), _dec(hi))
                                  for lo, hi in d["level_bounds"])
        d["rounds"] = tuple(RoundSpec(**r) for r in d["rounds"])
        return cls(**d).validate()


def plan_cache_key(family: str, n: int, num_shards: int,
                   cap_per_shard: int, algorithm: str = "boruvka", *,
                   schedule: str = "grid",
                   local_preprocessing: bool = True,
                   coalesce: bool = True, src_only: bool = True,
                   adaptive_doubling: bool = True,
                   relabel_skip: bool = True,
                   vsorted_index: bool = True,
                   pallas_minedges: bool = False,
                   grid_push: bool = False) -> str:
    """Stable plan-cache key: family, n, shards, edge-capacity rung,
    algorithm, schedule and one bit per lever.

    The ghost cache is not a bit: whether a plan carries ghost tables
    follows from these inputs and the layout, so a bit would only split
    slots that run the same.  ``grid_push`` is one, since the flat and
    two-level pushes run different exchanges at the same shape.
    """
    levers = "".join(
        "1" if f else "0"
        for f in (local_preprocessing, coalesce, src_only,
                  adaptive_doubling, relabel_skip, vsorted_index,
                  pallas_minedges, grid_push))
    return (f"{family}|n{int(n)}|p{int(num_shards)}|c{int(cap_per_shard)}"
            f"|{algorithm}|{schedule}|{levers}")


def _enc(x: float):
    """±inf-safe JSON encoding of the level weight windows."""
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return float(x)


def _dec(x) -> float:
    return float(x)


# Per-family MINEDGES decay models, (the first round's rung, rungs
# descended per round):
#   gnm:   the candidate exchange holds at most one item per source
#          vertex per shard, so cap_edge plateaus at the
#          vertices-per-shard rung;
#   rgg2d: geometric graphs in locality order contract geometrically,
#          so cap_edge starts at the cap/p rung and halves each round.
_FAMILY_EDGE_DECAY = {
    "gnm": ("vps", 0),
    "rgg2d": ("cap_over_p", 1),
}


def synthetic_plan(n: int, cap_total: int, num_shards: int, *,
                   algorithm: str = "boruvka", schedule: str = "grid",
                   local_preprocessing: bool = True,
                   family: Optional[str] = None) -> RoundPlan:
    """An unmeasured plan on the geometric ladder, for costing.

    Borůvka at least halves the active components a round, so round
    ``r`` takes rung ``r`` of the halving ladder for every exchange,
    over ``log2(n) + 1`` rounds (the engines' round bound).  Replaying
    it on a real graph is legal and may report overflow or residual
    rounds and replan, like any plan that does not fit.

    ``family`` sets the MINEDGES trajectory from a family's decay model
    (``_FAMILY_EDGE_DECAY``); None keeps the generic halving ladder.
    The plan takes the conservative levers (no ghost cache, no settled
    skip): its capacities have no host bound behind them.
    """
    from repro_torch.core.distributed import (quantize_capacity,
                                              shrink_schedule)
    cap = max(1, cap_total // num_shards)
    vps = max(1, -(-n // num_shards))
    rounds_n = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    edge_l = shrink_schedule(cap)
    lab_l = shrink_schedule(vps)

    if family is None:
        start_idx, step = 0, 1
    else:
        if family not in _FAMILY_EDGE_DECAY:
            raise ValueError(
                f"no calibrated decay model for family {family!r} "
                f"(known: {sorted(_FAMILY_EDGE_DECAY)}); pass "
                "family=None for the generic halving ladder")
        anchor, step = _FAMILY_EDGE_DECAY[family]
        first = min(vps, cap) if anchor == "vps" \
            else max(1, -(-cap // num_shards))
        start_idx = edge_l.index(quantize_capacity(first, cap))

    def rung(ladder, r):
        return ladder[min(r, len(ladder) - 1)]

    def edge_rung(r):
        return edge_l[min(start_idx + step * r, len(edge_l) - 1)]

    rounds = tuple(
        RoundSpec(level=0, cap_edge=edge_rung(r),
                  cap_lookup=edge_rung(r),
                  cap_contract=rung(lab_l, r), cap_relabel=vps,
                  cap_push=1, ghost=False,
                  sentinel=(r == rounds_n - 1))
        for r in range(rounds_n))
    return RoundPlan(
        n=n, num_shards=num_shards, cap_per_shard=cap,
        algorithm=algorithm, schedule=schedule,
        local_preprocessing=local_preprocessing,
        coalesce=True, src_only=True, adaptive_doubling=True,
        relabel_skip=False, vsorted_index=True, cap_prep=vps,
        edge_capacity_full=cap, label_capacity_full=vps,
        lookup_capacity_full=cap, ghost=None,
        level_bounds=((-math.inf, math.inf),), rounds=rounds).validate()
