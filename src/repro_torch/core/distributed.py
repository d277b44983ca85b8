"""Distributed Borůvka / Filter-Borůvka (Sections IV+V): the graph
layout shared by both distributed engines, and the replicated-label
engine.

Port of ``repro/core/distributed.py``.  Graph representation (paper
Section II-B): both directions of every undirected edge,
lexicographically sorted, 1D-partitioned into equal padded shards;
every directed copy carries the undirected edge id ``eid`` so that
tie-breaking uses the direction-independent total order ``(w, eid)``.
``build_dist_graph`` lays it out on the device it is built for, with
stable device sorts, slot for slot the reference's numpy layout.
``shrink_schedule``/``quantize_capacity`` are the capacity ladder of
both engines' shrinking rounds.

The replicated-label engine (``distributed_msf``) keeps the labels as
one dense ``[n]`` vector that every shard sees.  The reference runs one
program per device and combines the per-shard ``[n]`` tables of each
round with ``pmin``/``pmax``; here the shards are the leading axis of
``[p, cap]`` edge tensors in one process, and one scatter over all
shards' slots gives the same table, since a min or max over the shards'
mins or maxes is the min or max over all slots.  Per round:

  MINEDGES   scatter-min of ``(w, eid)`` into ``[n]`` tables
  CONTRACT   replicated pointer doubling, ``_doubling_iters(n)`` hops
  mark       the canonical ``u < v`` copy of each chosen edge

``local_preprocessing`` first contracts provably-local MSF edges on
each shard without communication and sums the shards' label deviations
(the reference's one ``psum``); ``boruvka_shrink`` renumbers the active
components into a shrinking dense prefix each round.  ``CommStats``
counts what the reference's collectives would move, analytically.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.comm.exchange import psum_f32
from repro_torch.core.graph import (INVALID_W, CapacityError,
                                    reference_order_sum)
from repro_torch.device import DeviceLike, resolve_device

# "no chosen edge" sentinel in eid space, shared by every engine so the
# (w, eid) total orders can never diverge
ESENT = np.int32(2 ** 30)
_ESENT = int(ESENT)


class CommStats(NamedTuple):
    """Per-solve routed-traffic accounting, field for field the
    reference's: ``calls`` (int32 all-to-all invocations), ``items``,
    ``bytes`` (float32), ``rounds`` (int32 Borůvka rounds), the ghost
    cache's ``hits``/``misses``/``pushed`` and ``injected`` (float32).
    0-dim tensors on the solve's device."""
    calls: torch.Tensor
    items: torch.Tensor
    bytes: torch.Tensor
    rounds: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    pushed: torch.Tensor
    injected: torch.Tensor


class DistGraph(NamedTuple):
    """Shard-major padded directed edge tensors ([p * cap] each)."""
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    eid: torch.Tensor  # undirected edge id shared by both copies

    @property
    def cap_total(self) -> int:
        return int(self.u.shape[0])

    @classmethod
    def from_numpy(cls, u: np.ndarray, v: np.ndarray, w: np.ndarray,
                   eid: np.ndarray, device: DeviceLike = None
                   ) -> "DistGraph":
        """A graph from host arrays of an already-built slot layout —
        e.g. the reference's ``DistGraph`` (``np.asarray(g.u)``, …), so
        both engines run on identical slots."""
        dev = resolve_device(device)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return cls(put(u, np.int32), put(v, np.int32), put(w, np.float32),
                   put(eid, np.int32))


def _on(x, dev: torch.device) -> torch.Tensor:
    """A host array or a tensor, on ``dev`` in its own dtype."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev)


def build_dist_graph(u, v, w, n: int, num_shards: int,
                     cap: Optional[int] = None,
                     device: DeviceLike = None) -> Tuple[DistGraph, int]:
    """Canonical undirected edges -> doubled, sorted, padded, on ``device``.

    ``u``, ``v``, ``w`` are host arrays or tensors (ids in ``[0, n)``,
    weights not NaN); they are moved to ``device`` once and the layout is
    built there.  Returns (graph, cap) with the reference's exact slot
    layout: the 2m directed copies in ``np.lexsort((w, v, u))`` order,
    ties in their doubled-array order, shard s holding sorted slots
    ``[s * cap, (s + 1) * cap)`` and the tail padded with ``INVALID_W``.
    ``eid`` is the index into the *undirected* input arrays, so a result
    mask over slots reduces back to the input edges via eid.  ``cap``
    pins the per-shard slot count (>= ``ceil(2m/p)``, else
    ``CapacityError``).  Recorded as the span ``layout`` (on a card
    timed by CUDA events too) and the counter ``layout.copies`` (2m)
    (``repro_torch.tracing``).
    """
    dev = resolve_device(device)
    with tracing.span("layout", device=dev):
        m = len(u)
        dm = 2 * m
        need = max(1, -(-dm // num_shards))
        if cap is None:
            cap = need
        elif cap < need:
            raise CapacityError(
                f"cap={cap} cannot hold ceil(2m/p)={need} edge slots per "
                f"shard (m={m}, p={num_shards}; "
                f"{dm - cap * num_shards} directed copies would be silently "
                "dropped)", dropped=dm - cap * num_shards)
        tracing.count("layout.copies", dm)
        u = _on(u, dev).to(torch.int32)
        v = _on(v, dev).to(torch.int32)
        w = _on(w, dev).to(torch.float32)
        eid = torch.arange(m, dtype=torch.int32, device=dev)
        du, dv = torch.cat([u, v]), torch.cat([v, u])
        dw, de = torch.cat([w, w]), torch.cat([eid, eid])
        # np.lexsort((dw, dv, du)) as two stable sorts, least significant
        # key first: + 0.0 makes -0.0 tie with +0.0 as numpy compares
        # them, and (du, dv) fit one int64 key since ids are below n
        order = torch.sort(dw + 0.0, stable=True).indices
        key = (du.long() * n + dv)[order]
        order = order[torch.sort(key, stable=True).indices]
        pad = num_shards * cap - dm

        def lay(x: torch.Tensor, fill) -> torch.Tensor:
            return torch.cat([x[order], torch.full((pad,), fill,
                                                   dtype=x.dtype,
                                                   device=dev)])

        return DistGraph(lay(du, 0), lay(dv, 0), lay(dw, float(INVALID_W)),
                         lay(de, 0)), cap


def _doubling_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def shrink_schedule(full: int, floor: int = 1) -> Tuple[int, ...]:
    """Geometric halving ladder ``(full, ceil(full/2), ..., floor)``.

    Borůvka at least halves the active components per round, so a
    per-round quantity bounded by the active set can be sized from this
    ladder: the sharded engine's shrinking driver snaps its per-round
    exchange capacities onto it.  For ``full >= 2`` it has
    ``ceil(log2(full)) + 1`` rungs.
    """
    out = [max(int(full), floor)]
    while out[-1] > floor:
        out.append(max(-(-out[-1] // 2), floor))
    return tuple(out)


def quantize_capacity(bound: int, full: int, floor: int = 1) -> int:
    """Smallest ``shrink_schedule(full, floor)`` rung ``>= bound``.

    The rung is an upper bound on ``bound``; a ``bound`` above every rung
    returns ``full``, so an undersized user capacity stays undersized
    and its overflow is reported, not papered over.
    """
    best = max(int(full), floor)
    for rung in shrink_schedule(full, floor):
        if rung >= bound:
            best = rung
        else:
            break
    return best


def _weight_pivots(w: torch.Tensor, valid: torch.Tensor,
                   num_levels: int) -> torch.Tensor:
    """PIVOTSELECTION (Section V): global weight quantiles from a sample.

    ``w``/``valid`` are the stacked ``[p, cap]`` shards; each shard
    samples 64 evenly spaced slots, the samples are gathered shard-major
    and sorted.  Returns the ``[num_levels - 1]`` ascending pivots.
    """
    cap = w.shape[1]
    s = min(64, cap)
    idx = (torch.arange(s, device=w.device) * cap) // s
    samp = torch.where(valid[:, idx], w[:, idx], float("inf"))
    all_samp = torch.sort(samp.reshape(-1)).values
    nfin = max(int(torch.isfinite(all_samp).sum()), 1)
    pos = (torch.arange(1, num_levels, device=w.device) * nfin) // num_levels
    return all_samp[pos]


# --------------------------------------------------------------------------
# the replicated-label engine ([p, cap] edges, [n] labels)
# --------------------------------------------------------------------------

def _take(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``table[s, off[s, ...]]`` per shard; ``off`` in range."""
    p = table.shape[0]
    return table.gather(1, off.reshape(p, -1).long()).view(off.shape)


def _scatter_reduce(size: int, fill, idx: torch.Tensor, src: torch.Tensor,
                    reduce: str) -> torch.Tensor:
    """``full((p, size), fill).at[s, idx].{min,max}(src)`` per shard."""
    out = torch.full((idx.shape[0], size), fill, dtype=src.dtype,
                     device=src.device)
    return out.scatter_reduce_(1, idx.long(), src, reduce)


def _scatter(size: int, fill, idx: torch.Tensor, src: torch.Tensor,
             reduce: str) -> torch.Tensor:
    """``full((size,), fill).at[idx].{min,max}(src)`` over every shard's
    slots at once: the reference's per-shard tables combined by
    ``pmin``/``pmax``."""
    out = torch.full((size,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, idx.reshape(-1).long(), src.reshape(-1),
                               reduce)


def _pointer_jump(parent: torch.Tensor, hops: int) -> torch.Tensor:
    for _ in range(hops):
        parent = parent.gather(-1, parent.long())
    return parent


def _shared_vertex_root_mask(u: torch.Tensor, valid: torch.Tensor, n: int):
    """Dense ``[n]`` mask of shared vertices (edge runs straddling
    shards), plus each shard's first and last source (``[p]``; -1 and -2
    on an empty shard).

    A vertex whose edges live on two shards is declared a component root
    (Section IV-B) so that no shard contracts through it.  The
    reference's ``all_gather`` of firsts and lasts is a read of columns
    0 and ``cnt - 1`` of the stacked ``u``.
    """
    p, cap = u.shape
    cnt = valid.sum(1)
    has = cnt > 0
    first = torch.where(has, u[:, 0], -1)
    last = torch.where(has, u.gather(1, (cnt - 1).clamp(0, cap - 1)
                                     .view(p, 1)).view(p), -2)
    shared = (last[:-1] == first[1:]) & (last[:-1] >= 0)
    shared_ids = torch.where(shared, last[:-1], n)  # n -> dropped
    mask = torch.zeros(n + 1, dtype=torch.bool, device=u.device)
    mask[shared_ids.long()] = True
    return mask[:n], first, last


def _local_vertex_mask_for_edges(x: torch.Tensor, firsts: torch.Tensor,
                                 lasts: torch.Tensor,
                                 root_mask_at: torch.Tensor) -> torch.Tensor:
    """Is vertex ``x[s, i]`` home on shard s and not shared?"""
    lo = firsts.view(-1, 1)
    hi = lasts.view(-1, 1)
    inside = (x >= lo) & (x <= hi) & (lo >= 0)
    return inside & ~root_mask_at


def _local_preprocessing_core(u, v, w, eid, valid, n: int):
    """Section IV-A: contract local MST edges without communication.

    Returns each shard's contribution: labels ``[p, n]`` deviating from
    the identity only for vertices contracted on that shard (each vertex
    is contracted on at most one), and ``mst`` ``[p, cap]`` bool.  The
    reference runs one ``while_loop`` per shard with its own stop; here
    the stacked rounds run until every shard has stopped, which changes
    nothing, since a stopped shard is a fixed point of its round.
    """
    p, cap = u.shape
    dev = u.device
    root_mask, firsts, lasts = _shared_vertex_root_mask(u, valid, n)
    local_u = _local_vertex_mask_for_edges(u, firsts, lasts,
                                           root_mask[u.long()])
    local_v = _local_vertex_mask_for_edges(v, firsts, lasts,
                                           root_mask[v.long()])
    local_edge = local_u & local_v & valid
    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(p, n)
    slot = torch.arange(cap, dtype=torch.int32, device=dev).expand(p, cap)
    sent = cap
    inf = float("inf")
    labels = iota.clone()
    mst = torch.zeros((p, cap), dtype=torch.int32, device=dev)
    go, r = True, 0
    while go and r < _doubling_iters(n) + 1:
        ru = _take(labels, u)
        rv = _take(labels, v)
        alive = (ru != rv) & valid
        wk = torch.where(alive, w, inf)
        wmin = _scatter_reduce(n, inf, ru, wk, "amin")
        wmin.scatter_reduce_(1, rv.long(), wk, "amin")
        # tie-break by the global undirected eid, the order every engine
        # and the oracle use, so the contracted edges stay in the MSF
        fin = torch.isfinite(wk)
        at_min_u = fin & (wk == _take(wmin, ru))
        at_min_v = fin & (wk == _take(wmin, rv))
        eminid = _scatter_reduce(n, _ESENT, ru,
                                 torch.where(at_min_u, eid, _ESENT), "amin")
        eminid.scatter_reduce_(1, rv.long(),
                               torch.where(at_min_v, eid, _ESENT), "amin")
        cu = torch.where(at_min_u & (eid == _take(eminid, ru)), slot, sent)
        cv = torch.where(at_min_v & (eid == _take(eminid, rv)), slot, sent)
        emin = _scatter_reduce(n, sent, ru, cu, "amin")
        emin.scatter_reduce_(1, rv.long(), cv, "amin")
        has = emin < sent
        # contract only if the component's global-min edge is local
        eligible = (has & _take(local_edge, emin.clamp(0, cap - 1))
                    & ~root_mask)
        ce = torch.where(eligible, emin, sent).clamp(0, cap - 1)
        cru = _take(labels, _take(u, ce))
        crv = _take(labels, _take(v, ce))
        parent = torch.where(eligible, cru + crv - iota, iota)
        gp = _take(parent, parent)
        parent = torch.where((gp == iota) & (iota < parent), iota, parent)
        roots = _pointer_jump(parent, _doubling_iters(n))
        mst = mst.scatter_reduce(1, ce.long(), eligible.to(torch.int32),
                                 "amax")
        labels = _take(roots, labels)
        go = bool(eligible.any())
        r += 1
    return labels, mst.bool()


def _local_preprocessing(u, v, w, eid, valid, n: int):
    """The comm-free contraction, combined: (labels ``[n]``, mst
    ``[p, cap]`` bool).  Each vertex is contracted on at most one shard,
    so summing the deviations from the identity over the shards (the
    reference's one ``psum``) merges every shard's labels."""
    labels, mst = _local_preprocessing_core(u, v, w, eid, valid, n)
    iota = torch.arange(n, dtype=torch.int32, device=u.device)
    return (labels - iota).sum(0, dtype=torch.int32) + iota, mst


def _distributed_rounds(u, v, w, eid, valid, labels, mst, n: int,
                        active: Optional[torch.Tensor], max_rounds: int):
    """Borůvka rounds with replicated labels (Sections IV-B..IV-D).

    ``active`` optionally restricts the edge set (the filter levels).
    The canonical ``u < v`` copy of each chosen edge is marked, so each
    undirected MSF edge is marked exactly once across all shards.  The
    rounds stop when no component chose an edge or after
    ``max_rounds``: one flag read a round, the reference's loop
    condition.  Returns (labels, mst, rounds run).
    """
    dev = u.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    inf = float("inf")
    live = valid if active is None else (valid & active)
    go, r = True, 0
    while go and r < max_rounds:
        ru = labels[u.long()]
        rv = labels[v.long()]
        alive = (ru != rv) & live
        wk = torch.where(alive, w, inf)
        # MINEDGES: one scatter-min over every shard's slots
        wmin = _scatter(n, inf, ru, wk, "amin")
        wmin.scatter_reduce_(0, rv.reshape(-1).long(), wk.reshape(-1),
                             "amin")
        fin = torch.isfinite(wk)
        wmin_u = wmin[ru.long()]
        wmin_v = wmin[rv.long()]
        cu = torch.where(fin & (wk == wmin_u), eid, _ESENT)
        cv = torch.where(fin & (wk == wmin_v), eid, _ESENT)
        emin = _scatter(n, _ESENT, ru, cu, "amin")
        emin.scatter_reduce_(0, rv.reshape(-1).long(), cv.reshape(-1),
                             "amin")
        has = emin < _ESENT
        # the winning (w, eid) slot(s)
        win_u = alive & (wk == wmin_u) & (eid == emin[ru.long()])
        win_v = alive & (wk == wmin_v) & (eid == emin[rv.long()])
        # other-endpoint component of each component's chosen edge
        other = _scatter(n, -1, ru, torch.where(win_u, rv, -1), "amax")
        other.scatter_reduce_(0, rv.reshape(-1).long(),
                              torch.where(win_v, ru, -1).reshape(-1),
                              "amax")
        # CONTRACTCOMPONENTS: replicated pointer doubling
        parent = torch.where(has & (other >= 0), other, iota)
        gp = parent[parent.long()]
        parent = torch.where((gp == iota) & (iota < parent), iota, parent)
        roots = _pointer_jump(parent, _doubling_iters(n))
        mst = mst | ((win_u | win_v) & (u < v))
        labels = roots[labels.long()]
        go = bool(has.any())
        r += 1
    return labels, mst, r


def _distributed_rounds_shrink(u, v, w, eid, valid, labels, mst, n: int,
                               src_only: bool = False):
    """Geometrically shrinking dense rounds (``boruvka_shrink``).

    Borůvka at least halves the active components each round, so after
    every round the active components are renumbered into a dense prefix
    and the next round's tables have the next ``shrink_schedule(n)``
    rung's size: ``sum_r n / 2^r = 2n`` reduced items in all.  The rounds
    are unrolled over the ladder, each at its static size.  With
    ``src_only`` only the source side scatters: the directed both-copy
    layout shows every component all its incident edges as sources.
    Returns (labels, mst, rounds, reduced items).
    """
    dev = u.device
    inf = float("inf")
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    sizes = shrink_schedule(max(n, 1))
    rounds = len(sizes)
    cid = iota  # vertex label -> active slot (s: inactive)
    rep = iota  # slot -> representative vertex label (n-sized buffer)
    acc_items = 0
    for r, s in enumerate(sizes):
        acc_items += 3 * (s + 1)
        s_next = sizes[r + 1] if r + 1 < rounds else 1
        cl = cid[labels.long()]
        ru = torch.where(valid, cl[u.long()], s)
        rv = torch.where(valid, cl[v.long()], s)
        alive = (ru != rv) & valid & (ru < s) & (rv < s)
        wk = torch.where(alive, w, inf)
        fin = torch.isfinite(wk)
        wmin = _scatter(s + 1, inf, ru, wk, "amin")
        if not src_only:
            wmin.scatter_reduce_(0, rv.reshape(-1).long(), wk.reshape(-1),
                                 "amin")
        wmin_u = wmin[ru.long()]
        wmin_v = wmin[rv.long()]
        emin = _scatter(s + 1, _ESENT, ru,
                        torch.where(fin & (wk == wmin_u), eid, _ESENT),
                        "amin")
        if not src_only:
            cv = torch.where(fin & (wk == wmin_v), eid, _ESENT)
            emin.scatter_reduce_(0, rv.reshape(-1).long(), cv.reshape(-1),
                                 "amin")
        has = emin[:s] < _ESENT
        win_u = alive & (wk == wmin_u) & (eid == emin[ru.long()])
        win_v = alive & (wk == wmin_v) & (eid == emin[rv.long()])
        other = _scatter(s + 1, -1, ru, torch.where(win_u, rv, -1), "amax")
        if not src_only:
            other.scatter_reduce_(0, rv.reshape(-1).long(),
                                  torch.where(win_v, ru, -1).reshape(-1),
                                  "amax")
        other = other[:s]
        # contraction in slot space
        sid = torch.arange(s, dtype=torch.int32, device=dev)
        parent = torch.where(has & (other >= 0), other, sid)
        gp = parent[parent.long()]
        parent = torch.where((gp == sid) & (sid < parent), sid, parent)
        roots = _pointer_jump(parent, _doubling_iters(s))
        mst = mst | ((win_u | win_v) & (u < v))
        # active vertices point at their root slot's representative
        act = cl < s
        root_slot = roots[cl.clamp(0, s - 1).long()]
        labels = torch.where(act, rep[root_slot.long()], labels)
        # renumber the merged roots into [0, s_next); the clamp keeps an
        # overflowing id inactive instead of writing into a live slot
        merged_root = has & (roots == sid)
        newid = torch.cumsum(merged_root.to(torch.int32), 0,
                             dtype=torch.int32) - 1
        newid = torch.where(merged_root, newid, s_next).clamp(max=s_next)
        reps = rep[:s]
        keep = (reps >= 0) & (reps < n)  # the reference's mode="drop"
        cid = torch.full((n,), s_next, dtype=torch.int32, device=dev)
        cid.scatter_reduce_(0, reps[keep].long(),
                            torch.where(merged_root, newid, s_next)[keep],
                            "amin")
        rep = torch.zeros(n, dtype=torch.int32, device=dev)
        rep.scatter_reduce_(0, newid.clamp(0, s_next - 1).long(),
                            torch.where(merged_root, reps, 0), "amax")
    return labels, mst, rounds, acc_items


def _msf_shard_fn(u, v, w, eid, n: int, algorithm: str,
                  local_preprocessing: bool, num_levels: int,
                  max_rounds: Optional[int]):
    """The replicated engine on stacked ``[p, cap]`` shards.  Returns
    (mask [p, cap], weight, count, labels [n], CommStats)."""
    p = u.shape[0]
    dev = u.device
    valid = torch.isfinite(w)
    mr = max_rounds or (math.ceil(math.log2(max(n, 2))) + 1)
    # analytic collective accounting, in the reference's int32 and
    # float32 arithmetic: 3 allreduced n-vectors per round (wmin f32,
    # emin i32, other i32)
    f32 = np.float32
    calls, items, nbytes, rounds = 0, f32(0.0), f32(0.0), 0

    if local_preprocessing:
        labels, pre_mst = _local_preprocessing(u, v, w, eid, valid, n)
        # psum(n) label combine + the 2 tiny firsts/lasts all_gathers
        calls += 3
        items += f32(n + 2 * p)
        nbytes += f32(4 * (n + 2 * p))
    else:
        labels = torch.arange(n, dtype=torch.int32, device=dev)
        pre_mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)

    def dense(r):
        return f32(3.0 * n) * f32(r), f32(12.0 * n) * f32(r)

    mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)
    if algorithm == "boruvka":
        labels, mst, r = _distributed_rounds(u, v, w, eid, valid, labels,
                                             mst, n, None, mr)
        rounds += r
        calls += 3 * r
        it, by = dense(r)
        items += it
        nbytes += by
    elif algorithm in ("boruvka_shrink", "boruvka_shrink_srconly"):
        labels, mst, r, acc = _distributed_rounds_shrink(
            u, v, w, eid, valid, labels, mst, n,
            src_only=algorithm.endswith("srconly"))
        rounds += r
        calls += 3 * r
        items += f32(acc)
        nbytes += f32(4 * acc)
    elif algorithm == "filter_boruvka":
        pivots = _weight_pivots(w, valid, num_levels).tolist()
        calls += 1
        items += f32(64 * p)
        nbytes += f32(4 * 64 * p)
        lo = -math.inf
        for lvl in range(num_levels):
            hi = pivots[lvl] if lvl < num_levels - 1 else math.inf
            active = (w > lo) & (w <= hi)
            labels, mst, r = _distributed_rounds(u, v, w, eid, valid,
                                                 labels, mst, n, active, mr)
            rounds += r
            calls += 3 * r
            it, by = dense(r)
            items += it
            nbytes += by
            lo = hi
    else:
        raise ValueError(algorithm)

    # preprocessing marked its chosen slots, the rounds the canonical
    # copies: each undirected edge is marked once
    full_mask = mst | pre_mst
    weight = psum_f32(reference_order_sum(torch.where(full_mask, w, 0.0)))
    count = full_mask.sum(1, dtype=torch.int32).sum(dtype=torch.int32)

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    zero = scalar(0.0, torch.float32)
    stats = CommStats(scalar(calls, torch.int32),
                      scalar(items, torch.float32),
                      scalar(nbytes, torch.float32),
                      scalar(rounds, torch.int32), zero, zero, zero, zero)
    return full_mask, weight, count, labels, stats


def distributed_msf(graph: DistGraph, n: int, num_shards, *,
                    algorithm: str = "boruvka",
                    local_preprocessing: bool = True,
                    num_levels: int = 4,
                    max_rounds: Optional[int] = None):
    """Run the replicated-label distributed MSF over ``num_shards``
    stacked shards (an int ``p`` or an ``(R, C)`` pair, where the
    reference takes a mesh) on the graph's device.

    ``algorithm`` is ``boruvka``, ``filter_boruvka``, ``boruvka_shrink``
    or ``boruvka_shrink_srconly``.  Returns (mask, weight, count, labels,
    stats): ``mask`` ``[p * cap]`` is aligned with ``graph`` slots, one
    directed copy per MSF edge marked; ``labels`` is the replicated
    ``[n]`` label vector; ``stats`` a ``CommStats`` of the collective
    traffic the reference's program moves.
    """
    from repro_torch.core.distributed_sharded import shard_layout
    p = math.prod(shard_layout(num_shards))
    cap = graph.cap_total // p

    def shards(x):
        return x.view(p, cap)

    mask, weight, count, labels, stats = _msf_shard_fn(
        *(shards(x) for x in graph), n, algorithm, local_preprocessing,
        num_levels, max_rounds)
    return mask.reshape(-1), weight, count, labels, stats


def make_mst_step(n: int, cap_total: int, num_shards,
                  algorithm: str = "boruvka", **kw):
    """A replicated MSF step of fixed shape: the port's counterpart of
    the reference's AOT-lowerable step.  Returns (step, specs):
    ``step(u, v, w, eid)`` on ``[cap_total]`` tensors gives
    ``distributed_msf``'s 5-tuple, and ``specs`` are its inputs'
    ``(shape, dtype)`` pairs."""
    def step(u, v, w, eid):
        return distributed_msf(DistGraph(u, v, w, eid), n, num_shards,
                               algorithm=algorithm, **kw)

    specs = (((cap_total,), torch.int32), ((cap_total,), torch.int32),
             ((cap_total,), torch.float32), ((cap_total,), torch.int32))
    return step, specs
