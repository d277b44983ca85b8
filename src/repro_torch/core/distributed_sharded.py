"""Sharded-label distributed Borůvka / Filter-Borůvka (Section IV, the
scalable path for n >> memory/PE).

Port of ``repro/core/distributed_sharded.py`` with every communication
lever.  The label vector is 1D-sharded by vertex id (owner of ``vid`` is
shard ``vid // vps``) and every label access is a routed request/reply
through ``comm/exchange.py``, or a read of the ghost-vertex label cache.
The reference runs one program per device under ``shard_map``; here the
p shards are the leading axis of every tensor (``[p, cap]`` edges,
``[p, vps]`` labels) in one process, so ``axis_index`` is ``arange(p)``,
a ``psum`` a sum over dim 0 and an all-to-all a transpose.  The shards
may be laid out as ``(p,)`` or as an ``(R, C)`` grid, the reference's
two-axis mesh, shard s at ``(s // C, s % C)``: the grid schedule then
takes one hop per axis.

Per round (``_round_body``):

  MINEDGES   both endpoint labels are read from the local ghost tables
             (``ghost_cache``, the default), or looked up from their
             owners — one request per slot, or with ``coalesce`` one per
             contiguous equal-endpoint run (the v column through the
             v-sorted index ``VIndex`` unless ``vsorted_index=False``).
             Candidates go
             to the owners of both endpoint components, or with
             ``src_only`` one per source run to the source component's
             owner only, combined first per run (``_sharded_minedges_src``).
             The owners scatter-min in the ``(w, eid)`` order over their
             owned slots (``_owner_scatter_min``).  With
             ``pallas_minedges=True`` both reductions — the per-run
             combine and the owner-side scatter-min — go through K1.
  CONTRACT   pointer doubling over the sharded parent array, one routed
             lookup per step: ``_doubling_iters(n)`` steps, or with
             ``adaptive_doubling`` until no parent changes (a host loop
             reading one flag a step); the 2-cycle of mutually chosen
             components keeps the smaller id as root.
  RELABEL    every owned vertex re-resolves its label through one more
             lookup; with ``relabel_skip`` a vertex whose component chose
             nothing is settled and stops asking.  Slots whose endpoints
             share a component join the persistent ``dead`` mask.
  PUSH       with the cache, each owner multicasts its merged roots' new
             roots to the shards that cache them (flat, or in two hops
             over an ``(R, C)`` layout) and moves their subscriber masks
             to the surviving root.

``local_preprocessing`` contracts provably-local MSF edges without
communication first (``_sharded_preprocess``).  With
``shrink_capacities`` the host driver ``_shrinking_capacity_msf`` runs
the rounds one at a time, each exchange sized from exact numpy bounds on
the measured dead mask and label table, snapped to the ladder of
``core/distributed.py: shrink_schedule``; otherwise the fused engine
runs every round at the flat capacities (``edge_capacity`` =
edges/shard, ``label_capacity`` = vps).  Every exchange reports
overflow; results are exact iff it is 0.

A ``RoundPlan`` (``core/plan.py``) freezes the driver's schedule:
``plan_sharded_msf`` measures it with one driven pass, and
``execute_plan`` (or ``distributed_sharded_msf(plan=...)``) replays it
through ``_planned_shard_fn``, every planned round at its capacities with
no host bound between rounds; a plan that does not fit replans or
raises.  ``execute_plan_batched`` replays one plan on B graphs with
per-request overflow, ``verify=True`` checks a returned forest
(``core/verify.py``), and both the driver and the replay take and resume
from certified round checkpoints (``core/msf_checkpoint.py``).

Spans (``repro_torch.tracing``, off by default): ``host_bounds`` around
the numpy bounds at their call sites (the ``_HostGraph`` and the flat
capacities of a solve, the ghost set-up and each round's bounds in
``_shrinking_capacity_msf``); ``sharded.sync`` around every host read
of a device value on its path and the rounds' (its copies of labels,
dead mask, counters, overflow, ``go`` and the final mask; the
preprocessing's and adaptive doubling's flags; the fused engine's
``go``); ``sharded.prep`` (with CUDA events) around the body of
``_sharded_preprocess``, whoever calls it.  Counters: ``prep.rounds``
(the preprocessing's rounds), ``prep.forest_edges`` (the forest edges
it contracted, read with its round flags) and ``sharded.forest_edges``
(each finished forest's edges: the host mask of
``_shrinking_capacity_msf``, or one read of the fused engine's or the
replay's count).
"""
from __future__ import annotations

import functools
import math
import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.comm import faults
from repro_torch.comm.exchange import (ExchangeStats, _hops,
                                       _mask_to_copies, psum_f32, reply,
                                       routed_exchange, scatter_updates,
                                       scatter_updates_grid)
from repro_torch.core.distributed import (ESENT, CommStats, DistGraph,
                                          _doubling_iters, _scatter_reduce,
                                          _take, _weight_pivots,
                                          quantize_capacity)
from repro_torch.core.graph import reference_order_sum
from repro_torch.core.msf_checkpoint import CheckpointError, MSFCheckpoint
from repro_torch.core.plan import GhostPlan, RoundPlan, RoundSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.segmin.ops import run_metadata, scatter_min_tables

_ESENT = int(ESENT)

# the ghost push keeps subscriber sets as int32 bitmasks and bit 31 is
# the sign bit, so the flat push reaches at most 31 shards; the grid
# push keeps one mask per axis of an (R, C) layout, at most 31 x 31
MAX_GHOST_SHARDS = 31
MAX_GHOST_SHARDS_GRID = MAX_GHOST_SHARDS ** 2

# the reference's default checkpoint cadence (rounds between certified
# snapshots), which the serving gateway's retry ladder takes by default
DEFAULT_CKPT_EVERY = 8

Runs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def vertices_per_shard(n: int, num_shards: int) -> int:
    return max(1, -(-n // num_shards))


def _bases(p: int, vps: int, device: torch.device) -> torch.Tensor:
    """``[p, 1]`` first vertex id owned by each shard."""
    return (torch.arange(p, dtype=torch.int32, device=device) * vps).view(
        p, 1)


def _scatter_any(mask: torch.Tensor, idx: torch.Tensor,
                 size: int) -> torch.Tensor:
    """``zeros((p, size), bool).at[s, idx].max(mask)`` per shard: every
    write is True, the rest go to a drop column."""
    p = mask.shape[0]
    out = torch.zeros((p, size + 1), dtype=torch.bool, device=mask.device)
    out.scatter_(1, torch.where(mask, idx.long(), size), True)
    return out[:, :size]


# --------------------------------------------------------------------------
# lookups (stacked [p, ...] tensors)
# --------------------------------------------------------------------------

class VIndex(NamedTuple):
    """Per-shard v-sorted secondary index, ``[p, cap]`` each.

    The edge slice is (u, v)-sorted, so the v column's equal-value runs
    are short in slot order.  ``perm`` sorts each shard's slots by
    ``where(valid, v, n)`` (padding at the tail), ``runs`` is
    ``run_metadata`` over that permuted view (one run per distinct v),
    ``key`` the permuted key column and ``rank`` maps each slot to its
    distinct-v rank.  Static per solve.
    """
    perm: torch.Tensor
    rank: torch.Tensor
    runs: Runs
    key: torch.Tensor


def _build_v_index(v: torch.Tensor, valid: torch.Tensor, n: int,
                   perm: Optional[torch.Tensor] = None) -> VIndex:
    """Build the v-sorted index; ``perm`` lets the host driver pass its
    numpy argsort (any stable sort of the same keys gives the same runs
    and ranks)."""
    key0 = torch.where(valid, v, n)
    if perm is None:
        perm = torch.sort(key0, dim=1, stable=True).indices.to(torch.int32)
    runs = run_metadata(key0, perm=perm)
    rank = torch.zeros_like(key0).scatter_(1, perm.long(), runs[2])
    return VIndex(perm, rank, runs, _take(key0, perm))


def _sharded_lookup(table: torch.Tensor, vids: torch.Tensor,
                    valid: torch.Tensor, vps: int, capacity: int,
                    axis_sizes: Sequence[int], schedule: str,
                    stats: ExchangeStats, count_misses: bool = False,
                    site: str = "lookup"):
    """Resolve ``table[vids]`` where ``table`` ([p, vps]) is 1D-sharded
    by id and ``vids`` ([p, L]) are global ids: the request carries the
    id, the owner answers ``table[id - base]``, the answer is routed back
    (the paper's request/reply label exchange).  Returns (values [p, L],
    ok [p, L], overflow, stats) — entries with ``ok`` False overflowed
    and carry garbage.  ``count_misses`` books the request items under
    ``stats.misses`` (endpoint lookups only).

    The reference's ``_sharded_lookup`` and ``_lookup_request_reply`` in
    one: every caller threads ``stats``, so the reference's stats-less
    branch has no counterpart here."""
    p = table.shape[0]
    base = _bases(p, vps, table.device).view(p, 1, 1)
    items0 = stats.items
    ex = routed_exchange(vids, vids // vps, valid, capacity, axis_sizes,
                         schedule, stats=stats, site=site)
    off = (ex.recv - base).clamp(0, vps - 1)
    answers = torch.where(ex.recv_ok, _take(table, off), -1)
    out, st = reply(ex, answers, axis_sizes, schedule, stats=ex.stats)
    if count_misses:
        st = st._replace(misses=st.misses + (ex.stats.items - items0))
    return out, ex.sent_ok, ex.overflow, st


def _coalesced_lookup(table, vids, runs: Runs, valid, vps: int,
                      capacity: int, axis_sizes: Sequence[int],
                      schedule: str, stats: ExchangeStats):
    """``_sharded_lookup`` with one request per equal-vid run.

    ``runs`` is ``run_metadata`` over ``vids``: only run heads whose run
    holds a valid slot ask, and the answer fans back out through the
    head index.  A dropped head drops its whole run, reported through
    ``overflow``/``ok``."""
    head, head_idx, run_id = runs
    any_valid = _scatter_any(valid, run_id, valid.shape[1])
    req = head & _take(any_valid, run_id)
    out_h, ok_h, ovf, st = _sharded_lookup(
        table, vids, req, vps, capacity, axis_sizes, schedule, stats,
        count_misses=True)
    return (_take(out_h, head_idx), valid & _take(ok_h, head_idx), ovf, st)


def _vsorted_lookup(table, vidx: VIndex, valid, vps: int, capacity: int,
                    axis_sizes: Sequence[int], schedule: str,
                    stats: ExchangeStats):
    """Coalesced lookup of the v endpoint through the v-sorted index: one
    request per distinct-v run holding a valid slot, answers fanned out
    per run and back to slot order through ``vidx.rank``."""
    head, _, run_id = vidx.runs
    p, L = valid.shape
    run_live = _scatter_any(valid, vidx.rank, L)
    req = head & _take(run_live, run_id)
    out_h, ok_h, ovf, st = _sharded_lookup(
        table, vidx.key, req, vps, capacity, axis_sizes, schedule, stats,
        count_misses=True)
    idx = torch.where(head, run_id, L).long()  # answers live at run heads
    ra = torch.full((p, L + 1), -1, dtype=torch.int32, device=valid.device
                    ).scatter_(1, idx, out_h)
    okr = torch.zeros((p, L + 1), dtype=torch.bool, device=valid.device
                      ).scatter_(1, idx, ok_h)
    return (_take(ra, vidx.rank), valid & _take(okr, vidx.rank), ovf, st)


def _relabel_lookup(parent, has, lab, settled, vps: int, capacity: int,
                    axis_sizes: Sequence[int], schedule: str,
                    stats: ExchangeStats):
    """RELABEL with the settled-vertex skip.

    Unsettled owned vertices ask ``owner(lab[x])`` for the contracted
    parent and whether that component chose an edge this round.  A
    component that chose nothing has no alive incident edge, so nothing
    can merge into it either: its members' labels are final for the
    level and stop asking.  Returns (lab, settled, overflow, stats).
    """
    p = lab.shape[0]
    base = _bases(p, vps, lab.device).view(p, 1, 1)
    req = ~settled
    ex = routed_exchange(lab, lab // vps, req, capacity, axis_sizes,
                         schedule, stats=stats, site="relabel")
    off = (ex.recv - base).clamp(0, vps - 1)
    ans_lab = torch.where(ex.recv_ok, _take(parent, off), -1)
    ans_cho = ex.recv_ok & _take(has, off)
    (out_lab, out_cho), st = reply(ex, (ans_lab, ans_cho), axis_sizes,
                                   schedule, stats=ex.stats)
    okr = req & ex.sent_ok
    lab = torch.where(okr, out_lab, lab)
    settled = settled | (okr & ~out_cho)
    return lab, settled, ex.overflow, st


# --------------------------------------------------------------------------
# ghost-vertex label cache
# --------------------------------------------------------------------------

class GhostState(NamedTuple):
    """Per-shard ghost state, ``[p, ...]`` each: ``gu`` the cached label
    of each distinct source run (by run rank), ``gv`` of each distinct
    v (by v-sorted rank), -1 where unfilled; for each owned vertex the
    subscriber bitmask of the shards caching it as a root — ``rs_row``
    over all shards and ``rs_col`` zeros with the flat push, the row and
    column masks with the grid push."""
    gu: torch.Tensor
    gv: torch.Tensor
    rs_row: torch.Tensor
    rs_col: torch.Tensor


def _ghost_fill(table, vids, runs: Runs, valid, G: int, vps: int,
                capacity: int, axis_sizes: Sequence[int], schedule: str,
                stats: ExchangeStats):
    """Fill one ghost table: one request per distinct-value run holding
    a valid slot, booked under ``misses``.  Returns (ghost [p, G] by run
    rank, -1 where unanswered, overflow, stats)."""
    head, _, run_id = runs
    p, L = valid.shape
    req = head & _take(_scatter_any(valid, run_id, L), run_id)
    out, ok, ovf, st = _sharded_lookup(table, vids, req, vps, capacity,
                                       axis_sizes, schedule, stats,
                                       count_misses=True, site="fill")
    ghost = torch.full((p, G + 1), -1, dtype=torch.int32,
                       device=valid.device)
    # runs past a table of G entries are dropped, as the reference's
    # mode="drop" scatter does (a plan's tables can be too small for a
    # replay graph; the executor's guard reports it)
    ghost.scatter_(1, torch.where(ok & (run_id < G), run_id, G).long(), out)
    return ghost[:, :G].contiguous(), ovf, st


def _bit_or_scatter(mask: torch.Tensor, idx: torch.Tensor,
                    bits: torch.Tensor, ok: torch.Tensor,
                    width: int) -> torch.Tensor:
    """``mask[s, idx] |= bits`` for the ok items of each shard.  Torch has
    no bitwise-or scatter, so the masks are expanded to ``width`` bool
    lanes, the set bits written into them (a drop row takes the rest)
    and the lanes packed back; ``width <= 31``."""
    p, V = mask.shape
    lanes = torch.arange(width, dtype=torch.int32, device=mask.device)
    acc = torch.zeros((p, V + 1, width), dtype=torch.bool,
                      device=mask.device)
    acc[:, :V] = _mask_to_copies(mask, torch.ones_like(mask, dtype=torch.bool),
                                 width)
    add = _mask_to_copies(bits, ok, width)
    acc.scatter_(1, torch.where(add, idx.long().unsqueeze(-1), V), True)
    return (acc[:, :V].to(torch.int32) << lanes).sum(2, dtype=torch.int32)


def _ghost_setup(u, v, valid, live, lab, vperm: Optional[torch.Tensor],
                 n: int, vps: int, Gu: int, Gv: int, cap_fill_u: int,
                 cap_fill_v: int, cap_sub: int, axis_sizes: Sequence[int],
                 schedule: str, stats: ExchangeStats, grid_push: bool):
    """Build the ghost state once a solve, after LOCALPREPROCESSING.

    Two fills of live endpoints (u in slot order, v through the v-sorted
    index), then one subscription per distinct cached root: each shard
    sorts its cached labels and sends the run heads with its bit (with
    the grid push, its row bit and column bit) to the root's owner,
    which ORs them into the root's masks.  The subscription items count
    as ``pushed``.  Returns (GhostState, vidx, runs_u, overflow, stats).
    """
    p = u.shape[0]
    dev = u.device
    runs_u = run_metadata(u)
    vidx = _build_v_index(v, valid, n, perm=vperm)
    gu, o1, st = _ghost_fill(lab, torch.where(valid, u, n), runs_u, live, Gu,
                             vps, cap_fill_u, axis_sizes, schedule, stats)
    gv, o2, st = _ghost_fill(lab, vidx.key, vidx.runs, _take(live, vidx.perm),
                             Gv, vps, cap_fill_v, axis_sizes, schedule, st)
    cat = torch.cat([gu, gv], 1)
    cat = torch.sort(torch.where(cat >= 0, cat, _ESENT), dim=1).values
    req = torch.ones_like(cat, dtype=torch.bool)
    req[:, 1:] = cat[:, 1:] != cat[:, :-1]
    req &= cat < _ESENT
    items0 = st.items
    zeros = torch.zeros((p, vps), dtype=torch.int32, device=dev)
    base = _bases(p, vps, dev)
    shard = torch.arange(p, dtype=torch.int32, device=dev).view(p, 1)
    one = torch.ones_like(shard)
    if grid_push:
        R, C = axis_sizes
        bits = ((one << (shard // C)).expand_as(cat),
                (one << (shard % C)).expand_as(cat))
    else:
        bits = ((one << shard).expand_as(cat),)
    ex = routed_exchange((cat,) + bits, cat // vps, req, cap_sub, axis_sizes,
                         schedule, stats=st, site="subscribe")
    st = ex.stats
    # subscription upkeep rides the push counter, so misses + pushed is
    # everything the cache ships
    st = st._replace(pushed=st.pushed + (st.items - items0))
    rvid = ex.recv[0].reshape(p, -1) - base
    okr = ex.recv_ok.reshape(p, -1)
    if grid_push:
        rs_row = _bit_or_scatter(zeros, rvid, ex.recv[1].reshape(p, -1), okr,
                                 R)
        rs_col = _bit_or_scatter(zeros, rvid, ex.recv[2].reshape(p, -1), okr,
                                 C)
    else:
        rs_row = _bit_or_scatter(zeros, rvid, ex.recv[1].reshape(p, -1), okr,
                                 p)
        rs_col = zeros
    return (GhostState(gu, gv, rs_row, rs_col), vidx, runs_u,
            o1 + o2 + ex.overflow, st)


def _ghost_push(gs: GhostState, parent, vps: int, capacity: int,
                cap_col: int, axis_sizes: Sequence[int], schedule: str,
                stats: ExchangeStats, grid_push: bool):
    """Root-delta push after CONTRACT.

    The dirty roots are the subscribed owned vertices whose parent moved.
    Each owner multicasts ``(c, parent[c])`` to c's subscribers
    (``scatter_updates``, or the two-hop ``scatter_updates_grid``) and
    forwards c's masks to ``owner(parent[c])``, where they are ORed into
    the surviving root's.  Receivers rewrite the table entries whose
    value is an old root they were sent, by binary search over the
    received pairs sorted by old root, so the grid's over-delivery
    matches nothing.  Push and forward items count as ``pushed``.
    Returns (GhostState, overflow, stats).
    """
    p = parent.shape[0]
    dev = parent.device
    base = _bases(p, vps, dev)
    vid = base + torch.arange(vps, dtype=torch.int32, device=dev)
    dirty = (parent != vid) & (gs.rs_row != 0)
    items0 = stats.items
    if grid_push:
        R, C = axis_sizes
        upd = scatter_updates_grid((vid, parent), gs.rs_row, gs.rs_col,
                                   dirty, capacity, cap_col, axis_sizes,
                                   stats=stats, site_row="ghost_push_row",
                                   site_col="ghost_push_col")
        masks, widths = (gs.rs_row, gs.rs_col), (R, C)
    else:
        upd = scatter_updates((vid, parent), gs.rs_row, dirty, capacity,
                              axis_sizes, schedule, stats=stats, site="push")
        masks, widths = (gs.rs_row,), (p,)
    # the masks follow the merge to the surviving root's owner
    fx = routed_exchange((parent,) + masks, parent // vps, dirty, capacity,
                         axis_sizes, schedule, stats=upd.stats, site="push")
    st = fx.stats
    st = st._replace(pushed=st.pushed + (st.items - items0))
    fvid = fx.recv[0].reshape(p, -1) - base
    fok = fx.recv_ok.reshape(p, -1)
    merged = [_bit_or_scatter(torch.where(dirty, 0, m), fvid,
                              fx.recv[1 + k].reshape(p, -1), fok, wd)
              for k, (m, wd) in enumerate(zip(masks, widths))]
    rs_row = merged[0]
    rs_col = merged[1] if grid_push else gs.rs_col
    # apply the received (old root -> new root) pairs by value
    okp = upd.recv_ok.reshape(p, -1)
    rold = torch.where(okp, upd.recv[0].reshape(p, -1), _ESENT)
    sc, order = torch.sort(rold, dim=1, stable=True)
    sr = upd.recv[1].reshape(p, -1).gather(1, order)
    M = sc.shape[1]

    def apply(gt):
        if M == 0:
            return gt
        j = torch.searchsorted(sc, gt.contiguous()).clamp(0, M - 1)
        hit = sc.gather(1, j) == gt  # unfilled entries are -1: never hit
        return torch.where(hit, sr.gather(1, j), gt)

    return (GhostState(apply(gs.gu), apply(gs.gv), rs_row, rs_col),
            upd.overflow + fx.overflow, st)


# --------------------------------------------------------------------------
# LOCALPREPROCESSING
# --------------------------------------------------------------------------

class _PrepSpace(NamedTuple):
    """A shard's bucketed vertex space for LOCALPREPROCESSING, ``[p, cap]``
    each: the distinct sources of its sorted edge slice by run rank."""
    head: torch.Tensor        # slot starts a source run
    du: torch.Tensor          # slot -> rank of its source
    dv: torch.Tensor          # slot -> rank of its target (where found)
    uvals: torch.Tensor       # rank -> vertex id (n past the last rank)
    v_found: torch.Tensor     # the target is a source on this shard
    local_edge: torch.Tensor  # neither endpoint is shared with a neighbour
    shared_rank: torch.Tensor  # rank's vertex straddles a shard boundary
    valid: torch.Tensor
    w: torch.Tensor
    eid: torch.Tensor
    nloc: int                 # bound on distinct local vertices


def _prep_space(u, v, w, eid, valid, n: int) -> _PrepSpace:
    """The bucketed vertex space of each shard.  A vertex whose source run
    straddles a shard boundary is shared; the reference finds those from
    an ``all_gather`` of each shard's first and last source, here read
    off columns 0 and ``cnt - 1`` of the stacked ``u``."""
    p, cap = u.shape
    dev = u.device
    big = n  # > every vertex id; doubles as "no vertex"
    cnt = valid.sum(1)
    has_edges = cnt > 0
    first = torch.where(has_edges, u[:, 0], -1)
    last = torch.where(has_edges, _take(u, (cnt - 1).clamp(0, cap - 1)
                                        .view(p, 1)).view(p), -2)
    k = max(p - 1, 1)
    if p > 1:
        shared = (last[:-1] == first[1:]) & (last[:-1] >= 0)
        # searchsorted is side="left" in both frameworks: padding n sorts
        # to the end
        sh_ids = torch.sort(torch.where(shared, last[:-1], big)).values
    else:
        sh_ids = torch.full((k,), big, dtype=torch.int32, device=dev)

    def is_shared(x):
        j = torch.searchsorted(sh_ids, x.contiguous()).clamp(0, k - 1)
        return sh_ids[j] == x

    vu = torch.where(valid, u, big)  # valid slots are a sorted prefix
    head = torch.ones((p, cap), dtype=torch.bool, device=dev)
    head[:, 1:] = vu[:, 1:] != vu[:, :-1]
    du = torch.cumsum(head, 1, dtype=torch.int32) - 1
    uvals = torch.full((p, cap), big, dtype=torch.int32, device=dev
                       ).scatter_(1, du.long(), vu)
    dv = torch.searchsorted(uvals, v.contiguous()).clamp(0, cap - 1)
    v_found = (_take(uvals, dv) == v) & valid
    return _PrepSpace(head, du, dv.to(torch.int32), uvals, v_found,
                      valid & v_found & ~is_shared(u) & ~is_shared(v),
                      is_shared(uvals), valid, w, eid,
                      max(min(n, cap), 2))


def _prep_round(sp: _PrepSpace, lab, mst):
    """One contraction round in rank space on every shard.  Returns (lab,
    mst, eligible [p] — the shard contracted a component).  A shard with
    no eligible component comes back unchanged: ``parent`` is the
    identity, so ``lab`` and ``mst`` stay as they are."""
    p, cap = lab.shape
    iota = torch.arange(cap, dtype=torch.int32, device=lab.device).expand(
        p, cap)
    sent = cap  # drop column of the [cap + 1] scatter tables
    inf = float("inf")
    ru = _take(lab, sp.du)
    lv = _take(lab, sp.dv)
    rvx = torch.where(sp.v_found, lv, sent)
    alive = sp.valid & ~(sp.v_found & (ru == lv))
    wk = torch.where(alive, sp.w, inf)
    wmin = _scatter_reduce(cap + 1, inf, ru, wk, "amin")
    wmin.scatter_reduce_(1, rvx.long(), wk, "amin")
    # tie-break by the global undirected eid, the order every engine
    # uses, so the contracted edges stay in the unique MSF
    fin = torch.isfinite(wk)
    at_min_u = fin & (wk == _take(wmin, ru))
    at_min_v = fin & (wk == _take(wmin, rvx))
    eminid = _scatter_reduce(cap + 1, _ESENT, ru,
                             torch.where(at_min_u, sp.eid, _ESENT), "amin")
    eminid.scatter_reduce_(1, rvx.long(),
                           torch.where(at_min_v, sp.eid, _ESENT), "amin")
    cu = torch.where(at_min_u & (sp.eid == _take(eminid, ru)), iota, sent)
    cv = torch.where(at_min_v & (sp.eid == _take(eminid, rvx)), iota, sent)
    emin = _scatter_reduce(cap + 1, sent, ru, cu, "amin")
    emin.scatter_reduce_(1, rvx.long(), cv, "amin")
    e = emin[:, :cap]
    # contract only if the component's global-min edge is local
    eligible = ((e < sent) & _take(sp.local_edge, e.clamp(0, cap - 1))
                & ~sp.shared_rank)
    ce = torch.where(eligible, e, sent).clamp(0, cap - 1)
    cru = _take(lab, _take(sp.du, ce))
    crv = _take(lab, _take(sp.dv, ce))
    parent = torch.where(eligible, cru + crv - iota, iota)
    gp = _take(parent, parent)
    parent = torch.where((gp == iota) & (iota < parent), iota, parent)
    for _ in range(_doubling_iters(sp.nloc)):
        parent = _take(parent, parent)
    mst = mst.scatter_reduce(1, ce.long(), eligible.to(torch.int32), "amax")
    return _take(parent, lab), mst, eligible.any(1)


def _sharded_preprocess(u, v, w, eid, valid, n: int, vps: int,
                        capacity: int, axis_sizes: Sequence[int],
                        schedule: str, stats: ExchangeStats):
    """Sharded LOCALPREPROCESSING (Section IV-A) with O(edges/shard) peak.

    Each shard contracts in its bucketed vertex space (``_prep_space``):
    the distinct source ids of its sorted edge slice, indexed by run
    rank.  A shared vertex stays a root; a component contracts only if
    its global ``(w, eid)``-minimum edge is provably local, so the
    contracted edges are a subset of the unique MSF.  The reference runs
    one ``while_loop`` per shard, each with its own stop condition; here
    the stacked rounds run until every shard has stopped, which changes
    nothing, since a stopped shard is a fixed point of ``_prep_round``.

    Returns (lab [p, vps], pre_mst [p, cap] bool, dead0 [p, cap] bool,
    overflow, stats); the changed labels reach their owners in one
    routed ``(vid, root)`` scatter of capacity ``min(capacity, cap)``.

    The span ``sharded.prep`` (timed on the card too) covers the whole
    body, every caller's: ``_shrinking_capacity_msf``, the fused engine
    and the planned replay.  While the recorder is on, ``prep.rounds``
    counts the ``_prep_round`` calls and ``prep.forest_edges`` the
    ``pre_mst`` slots, read with each round's flag.
    """
    with tracing.span("sharded.prep", u.device):
        p, cap = u.shape
        dev = u.device
        sp = _prep_space(u, v, w, eid, valid, n)
        lab = torch.arange(cap, dtype=torch.int32, device=dev).repeat(p, 1)
        mst = torch.zeros((p, cap), dtype=torch.int32, device=dev)
        counting = tracing.recording()
        go, r, found = True, 0, 0
        while go and r < _doubling_iters(sp.nloc) + 1:
            lab, mst, eligible = _prep_round(sp, lab, mst)
            with tracing.span("sharded.sync"):
                if counting:  # the forest count rides on the flag's read
                    go, found = torch.stack([eligible.any().long(),
                                             mst.sum()]).tolist()
                else:
                    go = bool(eligible.any())
            r += 1
        tracing.count("prep.rounds", r)
        tracing.count("prep.forest_edges", found)

        # --- one routed (vid, root) scatter to the owners --------------
        root_slot = _take(_take(sp.uvals, lab), sp.du)  # each source's root
        changed = sp.head & valid & (root_slot != u)
        ex = routed_exchange((u, root_slot), u // vps, changed,
                             min(capacity, cap), axis_sizes, schedule,
                             stats=stats, site="prep")
        base = _bases(p, vps, dev)
        vid = base + torch.arange(vps, dtype=torch.int32, device=dev)
        ok = ex.recv_ok.reshape(p, -1)
        off = torch.where(ok, ex.recv[0].reshape(p, -1) - base, vps)
        lab_out = torch.cat([vid, torch.full((p, 1), -1, dtype=torch.int32,
                                             device=dev)], 1)
        lab_out = lab_out.scatter_(1, off.long(),
                                   ex.recv[1].reshape(p, -1))
        same = sp.v_found & (_take(lab, sp.du) == _take(lab, sp.dv))
        dead0 = (u == v) | same  # locally-internal edges incl. self-loops
        return (lab_out[:, :vps].contiguous(), mst.bool(), dead0,
                ex.overflow, ex.stats)


# --------------------------------------------------------------------------
# MINEDGES and CONTRACT
# --------------------------------------------------------------------------

def _owner_scatter_min(comp, wc, ec, oc, okc, base, vps: int,
                       use_pallas: bool = False):
    """Owner-side (w, eid)-ordered scatter-min over owned component slots.

    ``comp/wc/ec/oc/okc`` are the flat received candidates ([p, F]),
    ``base`` the shards' first owned ids ([p, 1]); slot ``vps`` is the
    drop row for unused buffer entries.  Returns (has [p, vps],
    other [p, vps], is_win [p, F], off [p, F]).

    The per-slot tables come from K1 with ``use_pallas=True`` (the
    ``pallas_minedges`` lever: the CUDA kernel, one launch over all
    shards) and from its plain version otherwise; the winners are then
    confirmed per candidate against the tables.  Both paths return
    identical values.
    """
    p = comp.shape[0]
    dev = comp.device
    off = torch.where(okc, comp - base, vps)
    # lanes that are not ok get idx 0; neither table builder reads them
    idx = torch.where(okc, comp - base, 0)
    wt, et, pt, _ = scatter_min_tables(idx, wc, ec, oc, oc, okc, vps,
                                       use_kernel=use_pallas)
    wmin = torch.cat([wt.to(wc.dtype),
                      torch.full((p, 1), float("inf"), dtype=wc.dtype,
                                 device=dev)], dim=1)
    emin = torch.cat([et, torch.full((p, 1), _ESENT, dtype=torch.int32,
                                     device=dev)], dim=1)
    at_min = okc & (wc == _take(wmin, off))
    is_win = at_min & (ec == _take(emin, off))
    return et < _ESENT, pt, is_win, off


def _sharded_minedges(ru, rv, wk, eid, alive, vps: int, capacity: int,
                      axis_sizes: Sequence[int], schedule: str,
                      stats: ExchangeStats, use_pallas: bool = False):
    """Owner-computes MINEDGES, 2-exchange variant (the flat baseline).

    Each *directed* edge copy ships a ``(comp, w, eid, other)`` candidate
    to the owner of both its source component (keyed ``ru``) and its
    destination component (keyed ``rv``).  The owners scatter-min with
    the (w, eid) order over their [vps] slots and confirm winners back
    to the submitting slots, so the caller can mark the canonical copy.

    Returns (has [p, vps], other [p, vps], win [p, L], overflow, stats).
    """
    p = ru.shape[0]
    base = _bases(p, vps, ru.device)
    ex_u = routed_exchange((ru, wk, eid, rv), ru // vps, alive, capacity,
                           axis_sizes, schedule, stats=stats,
                           site="minedges")
    ex_v = routed_exchange((rv, wk, eid, ru), rv // vps, alive, capacity,
                           axis_sizes, schedule, stats=ex_u.stats,
                           site="minedges")

    def flat(ex):
        comp, w_, e_, o_ = ex.recv
        return (comp.reshape(p, -1), w_.reshape(p, -1), e_.reshape(p, -1),
                o_.reshape(p, -1), ex.recv_ok.reshape(p, -1))

    ku, wu, eu, ou, oku = flat(ex_u)
    kv, wv, ev, ov, okv = flat(ex_v)
    comp = torch.cat([ku, kv], dim=1)
    wc = torch.cat([wu, wv], dim=1)
    ec = torch.cat([eu, ev], dim=1)
    oc = torch.cat([ou, ov], dim=1)
    okc = torch.cat([oku, okv], dim=1)
    has, other, is_win, _ = _owner_scatter_min(comp, wc, ec, oc, okc, base,
                                               vps, use_pallas)
    # confirm winners to the submitting slots (both exchanges carry the
    # same (w, eid) for the two copies of an undirected edge, so a slot
    # wins iff either of its endpoint components chose it)
    nu = ku.shape[1]
    win_u, st = reply(ex_u, is_win[:, :nu].reshape(ex_u.recv_ok.shape),
                      axis_sizes, schedule, stats=ex_v.stats)
    win_v, st = reply(ex_v, is_win[:, nu:].reshape(ex_v.recv_ok.shape),
                      axis_sizes, schedule, stats=st)
    win = (win_u & ex_u.sent_ok) | (win_v & ex_v.sent_ok)
    return has, other, win, ex_u.overflow + ex_v.overflow, st


def _sharded_minedges_src(ru, rv, wk, eid, alive, runs: Runs, vps: int,
                          capacity: int, axis_sizes: Sequence[int],
                          schedule: str, stats: ExchangeStats,
                          use_pallas: bool = False):
    """Owner-computes MINEDGES, src-only variant with per-run candidate
    aggregation.

    Both directed copies of every edge exist, so the owner of component
    ``c`` already receives every edge incident to ``c`` through the
    ``ru``-keyed exchange alone.  Candidates are first combined per
    source run (the edge slice is sorted by source, so a run shares its
    source component): each alive run ships its local ``(w, eid)``-argmin,
    and min-of-mins keeps the chosen edge set exact.

    With ``use_pallas`` the combine is one K1 launch over the ``[p, L]``
    rows with ``idx = run_id`` (non-decreasing), ``size = L`` and the
    payloads ``rv`` (the chosen other endpoint component) and ``ru``
    (the run's own component, constant within the run); otherwise the
    plain scatter passes of the reference's comparator.  Dead runs come
    back ``(inf, ESENT, -1, -1)`` both ways.

    The confirmation is deferred: the caller replies through the
    returned ``ex`` once the contraction's first lookup has shown which
    winners are the larger side of a 2-cycle.  Returns (has [p, vps],
    other [p, vps], is_win [p, F], off [p, F], ex, loc_win [p, L] — the
    run's argmin slot, head_idx [p, L] — each slot's run head).
    """
    p, L = ru.shape
    base = _bases(p, vps, ru.device)
    head, head_idx, run_id = runs
    if use_pallas:
        wtbl, etbl, otbl, ctbl = scatter_min_tables(
            run_id, wk, eid, rv, ru, alive, L, use_kernel=True)
        wrun = _take(wtbl.to(wk.dtype), run_id)
        at_min = alive & (wk == wrun)
        erun = _take(etbl, run_id)
        loc_win = at_min & (eid == erun)
        send = head & torch.isfinite(wrun)
        comp_c = _take(ctbl, run_id)
        payload = (comp_c, wrun, erun, _take(otbl, run_id))
    else:
        wtbl = _scatter_reduce(L, float("inf"), run_id, wk, "amin")
        at_min = alive & (wk == _take(wtbl, run_id))
        etbl = _scatter_reduce(L, _ESENT, run_id,
                               torch.where(at_min, eid, _ESENT), "amin")
        loc_win = at_min & (eid == _take(etbl, run_id))
        otbl = _scatter_reduce(L, -1, run_id, torch.where(loc_win, rv, -1),
                               "amax")
        ctbl = _scatter_reduce(L, -1, run_id, torch.where(alive, ru, -1),
                               "amax")
        send = head & _take(_scatter_any(alive, run_id, L), run_id)
        comp_c = _take(ctbl, run_id)
        payload = (comp_c, _take(wtbl, run_id), _take(etbl, run_id),
                   _take(otbl, run_id))
    ex = routed_exchange(payload, comp_c // vps, send, capacity, axis_sizes,
                         schedule, stats=stats, site="minedges")
    comp, w_, e_, o_ = (x.reshape(p, -1) for x in ex.recv)
    okc = ex.recv_ok.reshape(p, -1)
    has, other, is_win, off = _owner_scatter_min(comp, w_, e_, o_, okc,
                                                 base, vps, use_pallas)
    return has, other, is_win, off, ex, loc_win, head_idx


def _sharded_contract(has, other, n: int, vps: int, capacity: int,
                      axis_sizes: Sequence[int], schedule: str,
                      adaptive: bool, stats: ExchangeStats):
    """Pointer doubling over the sharded parent array (request/reply).

    Roots with a chosen edge point at the other endpoint's component,
    everything else at itself; the 2-cycle of mutually chosen components
    keeps the smaller id as root.  Then doubling steps of one routed
    lookup each: ``_doubling_iters(n)`` of them, or with ``adaptive``
    until a step changes no parent, read on the host one flag a step
    (the reference's in-program ``while_loop`` on a psummed flag), and
    capped at ``_doubling_iters(n)`` either way.  Only ``parent[x] != x``
    rows enter the exchange.

    Returns (parent [p, vps] fully contracted, keep [p, vps] — winner
    and not the larger side of a 2-cycle, the exact-once marking of
    src-only MINEDGES, overflow, stats).
    """
    p = has.shape[0]
    vid = _bases(p, vps, has.device) + torch.arange(
        vps, dtype=torch.int32, device=has.device)
    parent0 = torch.where(has, other, vid)

    def hop(par, st):
        req = par != vid
        nxt, _, o, st = _sharded_lookup(par, par, req, vps, capacity,
                                        axis_sizes, schedule, st,
                                        site="contract")
        return torch.where(req, nxt, par), o, st

    gp, ov, stats = hop(parent0, stats)
    # a 2-cycle (mutually chosen components) necessarily chose the SAME
    # edge, so `keep` marks every winning pair on exactly one owner
    mutual = gp == vid
    keep = has & (~mutual | (vid < parent0))
    parent = torch.where(mutual & (vid < parent0), vid, parent0)
    for _ in range(_doubling_iters(n)):
        nxt, o, stats = hop(parent, stats)
        ov = ov + o
        with tracing.span("sharded.sync"):
            done = adaptive and not bool((nxt != parent).any())
        parent = nxt
        if done:
            break
    return parent, keep, ov, stats


def _ghost_read(gs: GhostState, runs_u: Runs, vidx: VIndex, live,
                stats: ExchangeStats):
    """Both endpoint labels from the local ghost tables: u by source-run
    rank, v by v-sorted rank.  Each run head of either column whose run
    holds a live slot is one hit.  Returns (ru, rv, stats)."""
    head_u, _, run_id_u = runs_u
    head_v, _, run_id_v = vidx.runs
    L = live.shape[1]
    au = _scatter_any(live, run_id_u, L)
    # the v side's run liveness is keyed by rank, never by perm
    av = _scatter_any(live, vidx.rank, L)
    hits = ((head_u & _take(au, run_id_u)).sum(1).to(torch.float32)
            + (head_v & _take(av, run_id_v)).sum(1).to(torch.float32))
    ru = _take(gs.gu, run_id_u.clamp(0, gs.gu.shape[1] - 1))
    rv = _take(gs.gv, vidx.rank.clamp(0, gs.gv.shape[1] - 1))
    return ru, rv, stats._replace(hits=stats.hits + psum_f32(hits))


def _endpoint_lookups(lab, u, v, live, runs_u, runs_v, vidx, vps: int,
                      capacity: int, axis_sizes: Sequence[int],
                      schedule: str, coalesce: bool, stats: ExchangeStats):
    """Both endpoint labels looked up from their owners: per slot, or
    with ``coalesce`` per equal-vid run (the u column in slot order, the
    v column through ``vidx``, or in slot order through ``runs_v`` when
    the v-sorted index is off).  Returns (ru, rv, looked, overflow,
    stats)."""
    if coalesce and runs_u is not None:
        ru, ok_u, o1, st = _coalesced_lookup(lab, u, runs_u, live, vps,
                                             capacity, axis_sizes,
                                             schedule, stats)
    else:
        ru, ok_u, o1, st = _sharded_lookup(lab, u, live, vps, capacity,
                                           axis_sizes, schedule, stats,
                                           count_misses=True)
    if coalesce and vidx is not None:
        rv, ok_v, o2, st = _vsorted_lookup(lab, vidx, live, vps, capacity,
                                           axis_sizes, schedule, st)
    elif coalesce and runs_v is not None:
        rv, ok_v, o2, st = _coalesced_lookup(lab, v, runs_v, live, vps,
                                             capacity, axis_sizes,
                                             schedule, st)
    else:
        rv, ok_v, o2, st = _sharded_lookup(lab, v, live, vps, capacity,
                                           axis_sizes, schedule, st,
                                           count_misses=True)
    return ru, rv, ok_u & ok_v, o1 + o2, st


def _round_body(u, v, w, eid, live0, lab, mst, dead, runs_u, runs_v, vidx,
                ghost: Optional[GhostState], settled, n: int, vps: int,
                axis_sizes: Sequence[int], cap_edge: int, cap_label: int,
                cap_lookup: int, cap_contract: int, cap_push: int,
                cap_push_col: int, schedule: str, coalesce: bool,
                src_only: bool, adaptive: bool, relabel_skip: bool,
                pallas_minedges: bool, grid_push: bool,
                stats: ExchangeStats):
    """One MINEDGES → CONTRACT → RELABEL round over 1D-sharded labels.

    Shared by the fused flat-capacity engine and the shrinking driver,
    which differ only in the capacities each round gets.  With the ghost
    cache (``ghost`` given) the endpoint labels are read from the ghost
    tables (``_ghost_read``) and the round ends with the root-delta push
    (``_ghost_push``); otherwise they are looked up from their owners
    (``_endpoint_lookups``).

    Returns (lab, mst, dead, ghost, settled, go, overflow_delta, stats);
    ``go`` is a 0-dim bool tensor (some component chose an edge).
    """
    live = live0 & ~dead
    if ghost is not None:
        ru, rv, st = _ghost_read(ghost, runs_u, vidx, live, stats)
        looked = live
        o12 = torch.zeros((), dtype=torch.int32, device=live.device)
    else:
        ru, rv, looked, o12, st = _endpoint_lookups(
            lab, u, v, live, runs_u, runs_v, vidx, vps, cap_lookup,
            axis_sizes, schedule, coalesce, stats)
    # dead-edge retirement: same component now => same forever
    dead = dead | (looked & (ru == rv))
    alive = looked & (ru != rv) & live
    wk = torch.where(alive, w, float("inf"))
    if src_only:
        has, other, is_win, off, ex, loc_win, head_idx = \
            _sharded_minedges_src(ru, rv, wk, eid, alive, runs_u, vps,
                                  cap_edge, axis_sizes, schedule, st,
                                  pallas_minedges)
        parent, keep, o4, st = _sharded_contract(
            has, other, n, vps, cap_contract, axis_sizes, schedule,
            adaptive, ex.stats)
        keep_ext = torch.cat([keep, torch.zeros_like(keep[:, :1])], 1)
        confirm = (is_win & _take(keep_ext, off)).reshape(
            ex.recv_ok.shape)
        win, st = reply(ex, confirm, axis_sizes, schedule, stats=st)
        # the run's confirmation lands on its argmin slot only: exactly
        # one directed slot per MSF edge
        mst = mst | (loc_win & _take(win & ex.sent_ok, head_idx))
        o3 = ex.overflow
    else:
        has, other, win, o3, st = _sharded_minedges(
            ru, rv, wk, eid, alive, vps, cap_edge, axis_sizes, schedule, st,
            pallas_minedges)
        # both directed copies are confirmed; mark only the canonical one
        # so the global mask is exact-once
        mst = mst | (win & (u < v))
        parent, _, o4, st = _sharded_contract(
            has, other, n, vps, cap_contract, axis_sizes, schedule,
            adaptive, st)
    if relabel_skip:
        lab, settled, o5, st = _relabel_lookup(
            parent, has, lab, settled, vps, cap_label, axis_sizes, schedule,
            st)
    else:
        lab, _, o5, st = _sharded_lookup(
            parent, lab, torch.ones_like(lab, dtype=torch.bool), vps,
            cap_label, axis_sizes, schedule, st, site="relabel")
    ovf = o12 + o3 + o4 + o5
    if ghost is not None:
        ghost, o6, st = _ghost_push(ghost, parent, vps, cap_push,
                                    cap_push_col, axis_sizes, schedule, st,
                                    grid_push)
        ovf = ovf + o6
    return lab, mst, dead, ghost, settled, has.any(), ovf, st


class _Static(NamedTuple):
    """Per-solve run structure the round body reads (None where its lever
    is off): source runs, slot-order v runs, the v-sorted index."""
    runs_u: Optional[Runs]
    runs_v: Optional[Runs]
    vidx: Optional[VIndex]


def _static_runs(u, v, valid, n: int, coalesce: bool, src_only: bool,
                 vsorted: bool, vperm: Optional[torch.Tensor] = None
                 ) -> _Static:
    return _Static(
        run_metadata(u) if (coalesce or src_only) else None,
        run_metadata(v) if (coalesce and not vsorted) else None,
        _build_v_index(v, valid, n, perm=vperm) if (coalesce and vsorted)
        else None)


def _sharded_rounds(u, v, w, eid, valid, lab, mst, dead,
                    ghost: Optional[GhostState], static: _Static, n: int,
                    vps: int, axis_sizes: Sequence[int],
                    active: Optional[torch.Tensor], max_rounds: int,
                    cap_edge: int, cap_label: int, cap_lookup: int,
                    cap_push: int, cap_push_col: int, overflow,
                    stats: ExchangeStats, rounds, schedule: str,
                    coalesce: bool, src_only: bool, adaptive: bool,
                    relabel_skip: bool, pallas_minedges: bool,
                    grid_push: bool):
    """Borůvka rounds with 1D-sharded labels (flat capacities).

    ``active`` optionally restricts the edge set (the filter levels);
    ``dead`` persists across rounds and levels (labels only coarsen), and
    so does the ghost state (its tables follow the whole label vector);
    ``settled`` is per level (a new weight window revives edges).  Runs
    until no component chooses an edge or ``max_rounds``.
    """
    live0 = valid if active is None else (valid & active)
    settled = torch.zeros(lab.shape, dtype=torch.bool, device=lab.device)
    r = 0
    go = True
    while go and r < max_rounds:
        lab, mst, dead, ghost, settled, go_t, o, stats = _round_body(
            u, v, w, eid, live0, lab, mst, dead, static.runs_u,
            static.runs_v, static.vidx, ghost, settled, n, vps, axis_sizes,
            cap_edge, cap_label, cap_lookup, cap_label, cap_push,
            cap_push_col, schedule, coalesce, src_only, adaptive,
            relabel_skip, pallas_minedges, grid_push, stats)
        overflow = overflow + o
        r += 1
        with tracing.span("sharded.sync"):
            go = bool(go_t)
    return lab, mst, dead, ghost, overflow, stats, rounds + r


def _count_forest(count) -> None:
    """The counter ``sharded.forest_edges`` of a forest formed on the
    device: one host read of ``count``, only while the recorder is on."""
    if tracing.recording():
        with tracing.span("sharded.sync"):
            tracing.count("sharded.forest_edges", int(count))


def _sharded_shard_fn(u, v, w, eid, n: int, vps: int,
                      axis_sizes: Sequence[int], algorithm: str,
                      num_levels: int, max_rounds: Optional[int],
                      cap_edge: int, cap_label: int, cap_lookup: int,
                      cap_push: int, cap_push_col: int, schedule: str,
                      local_preprocessing: bool, coalesce: bool,
                      src_only: bool, adaptive: bool, ghost: bool,
                      relabel_skip: bool, vsorted: bool,
                      pallas_minedges: bool, grid_push: bool):
    """The fused flat-capacity solve over stacked shards (``u/v/w/eid``
    are [p, cap]).  With ``ghost`` the ghost tables have one entry per
    slot, the fills run at ``cap_lookup``, the subscription at
    ``cap_label`` and the push at ``cap_push`` (the grid's second hop at
    ``cap_push_col``).

    Returns (mask [p, cap], weight, count, lab [p, vps], overflow,
    CommStats) — the reference's per-shard program, all shards at once.
    """
    p = u.shape[0]
    dev = u.device
    valid = torch.isfinite(w)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    stats = ExchangeStats.zeros(dev)
    rounds = 0
    mr = (math.ceil(math.log2(max(n, 2))) + 1) if max_rounds is None \
        else max_rounds
    if local_preprocessing:
        lab, pre_mst, dead, ovf, stats = _sharded_preprocess(
            u, v, w, eid, valid, n, vps, cap_label, axis_sizes, schedule,
            stats)
        overflow = overflow + ovf
    else:
        lab = _bases(p, vps, dev) + torch.arange(vps, dtype=torch.int32,
                                                 device=dev)
        pre_mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)
        dead = u == v  # self-loops can never be MSF candidates
    mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)
    gs = None
    if ghost:
        cap = u.shape[1]
        gs, vidx, runs_u, ovf, stats = _ghost_setup(
            u, v, valid, valid & ~dead, lab, None, n, vps, cap, cap,
            cap_lookup, cap_lookup, cap_label, axis_sizes, schedule, stats,
            grid_push)
        overflow = overflow + ovf
        static = _Static(runs_u, None, vidx)
    else:
        static = _static_runs(u, v, valid, n, coalesce, src_only, vsorted)

    common = dict(n=n, vps=vps, axis_sizes=axis_sizes, max_rounds=mr,
                  cap_edge=cap_edge, cap_label=cap_label,
                  cap_lookup=cap_lookup, cap_push=cap_push,
                  cap_push_col=cap_push_col, schedule=schedule,
                  coalesce=coalesce, src_only=src_only, adaptive=adaptive,
                  relabel_skip=relabel_skip, pallas_minedges=pallas_minedges,
                  grid_push=grid_push)
    if algorithm == "boruvka":
        lab, mst, dead, gs, overflow, stats, rounds = _sharded_rounds(
            u, v, w, eid, valid, lab, mst, dead, gs, static, active=None,
            overflow=overflow, stats=stats, rounds=rounds, **common)
    elif algorithm == "filter_boruvka":
        pivots = _weight_pivots(w, valid, num_levels)
        lo = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
        for lvl in range(num_levels):
            hi = pivots[lvl] if lvl < num_levels - 1 else torch.tensor(
                float("inf"), dtype=torch.float32, device=dev)
            active = (w > lo) & (w <= hi)
            lab, mst, dead, gs, overflow, stats, rounds = _sharded_rounds(
                u, v, w, eid, valid, lab, mst, dead, gs, static,
                active=active, overflow=overflow, stats=stats,
                rounds=rounds, **common)
            lo = hi
    else:
        raise ValueError(algorithm)

    full_mask = mst | pre_mst
    weight = psum_f32(reference_order_sum(torch.where(full_mask, w, 0.0)))
    count = full_mask.sum(dtype=torch.int32)
    _count_forest(count)
    comm = CommStats(stats.calls, stats.items, stats.bytes,
                     torch.tensor(rounds, dtype=torch.int32, device=dev),
                     stats.hits, stats.misses, stats.pushed, stats.injected)
    return full_mask, weight, count, lab, overflow, comm


# --------------------------------------------------------------------------
# host-side capacity bounds (numpy; the shrinking driver's per-round sizes)
# --------------------------------------------------------------------------

def _host_weight_pivots(w_h: np.ndarray, valid_h: np.ndarray,
                        num_levels: int, p: int, cap: int) -> np.ndarray:
    """Host replica of ``_weight_pivots`` (same per-shard stride-64
    sample, gather order and quantile positions), so the shrinking
    driver buckets the filter levels exactly like the fused engine."""
    s = min(64, cap)
    idx = (np.arange(s) * cap) // s
    samp = []
    for sh in range(p):
        ws = w_h[sh * cap:(sh + 1) * cap]
        vs = valid_h[sh * cap:(sh + 1) * cap]
        samp.append(np.where(vs[idx], ws[idx], np.inf))
    all_samp = np.sort(np.concatenate(samp).astype(np.float32))
    nfin = max(int(np.isfinite(all_samp).sum()), 1)
    pos = (np.arange(1, num_levels) * nfin) // num_levels
    return all_samp[pos]


def minedges_buffer_bytes(p: int, capacity: int, hops: int,
                          src_only: bool) -> int:
    """Static buffer bytes one MINEDGES phase ships at ``capacity``: four
    ``[p, C]`` payload buffers (i32/f32/i32/i32) and the 1-byte validity
    mask per exchange and hop, one ``[p, C]`` bool confirmation buffer
    per reply; src-only pays that once, the 2-exchange baseline twice."""
    per_exchange = (4 * 4 + 1) * p * capacity * hops
    per_reply = 1 * p * capacity * hops
    k = 1 if src_only else 2
    return k * (per_exchange + per_reply)


def _per_pair_max(shard: np.ndarray, owner: np.ndarray, p: int) -> int:
    """Max count over (source shard, destination owner) pairs."""
    if owner.size == 0:
        return 0
    return int(np.bincount(shard * p + owner, minlength=p * p).max())


def _host_run_starts(a: np.ndarray, num_shards: int) -> np.ndarray:
    """First slots of the per-shard contiguous equal-value runs of a
    shard-major array (a run starts at every shard start): the host
    mirror of ``run_metadata``'s heads, the reference's
    ``_host_run_heads`` as positions."""
    a2 = a.reshape(num_shards, -1)
    head = np.ones(a2.shape, bool)
    head[:, 1:] = a2[:, 1:] != a2[:, :-1]
    return np.flatnonzero(head)


def _live_heads(starts: np.ndarray, mask: Optional[np.ndarray]
                ) -> np.ndarray:
    """The starts of the runs (starting at ``starts``) that hold a slot
    of ``mask``, every start where ``mask`` is None: the reference's
    ``heads & run_any[rid]``, one ``logical_or.reduceat`` over the runs
    in place of a ``bincount`` over the slots."""
    if mask is None:
        return starts
    return starts[np.logical_or.reduceat(mask, starts)]


def _minedges_capacity_bound(ru: np.ndarray, rv: np.ndarray,
                             alive: np.ndarray, shard: np.ndarray,
                             cand: np.ndarray, p: int, vps: int,
                             src_only: bool) -> int:
    """Exact MINEDGES candidate-exchange capacity for the coming round:
    the most candidates any shard sends any owner.  In src-only mode a
    candidate is an alive source run, given by its first slot in
    ``cand``, keyed by its component's owner; otherwise every alive slot
    under both endpoint keys.  0 when no candidate exists (the round
    could choose nothing)."""
    if not cand.size:
        return 0
    if src_only:
        return _per_pair_max(shard[cand], ru[cand] // vps, p)
    sa = shard[alive]
    return max(_per_pair_max(sa, ru[alive] // vps, p),
               _per_pair_max(sa, rv[alive] // vps, p))


def _endpoint_lookup_bound(u_h: np.ndarray, v_h: np.ndarray,
                           live_h: np.ndarray, shard: np.ndarray,
                           p: int, vps: int) -> int:
    """Exact per-(shard, owner) bound for the uncoalesced endpoint
    lookups: every live slot requests both its endpoints' owners."""
    sl = shard[live_h]
    if sl.size == 0:
        return 1
    return max(1, _per_pair_max(sl, u_h[live_h] // vps, p),
               _per_pair_max(sl, v_h[live_h] // vps, p))


def _relabel_capacity_bound(lab_h: np.ndarray, settled_h: np.ndarray,
                            p: int, vps: int) -> int:
    """Exact per-(shard, owner) RELABEL request count under the
    settled-vertex skip: vertex x asks ``owner(lab[x])`` iff it is not
    settled (``settled_h`` mirrors the device mask's update rule)."""
    x = np.nonzero(~settled_h)[0]
    if x.size == 0:
        return 1
    return max(1, _per_pair_max(x // vps, lab_h[x] // vps, p))


def _contract_capacity_bound(choosing: np.ndarray, rv: np.ndarray,
                             alive: np.ndarray, vps: int) -> int:
    """Max per-owner count of distinct components incident to candidate
    edges: only a component with a chosen edge has a non-self parent, so
    this bounds the CONTRACT exchange rows exactly.  ``choosing`` marks
    the source components of the alive slots; the targets' are marked
    on top (a table of marks where the reference takes ``np.unique``)."""
    if not alive.any():
        return 1
    comp = choosing.copy()
    comp[rv[alive]] = True
    return max(1, int(np.bincount(np.flatnonzero(comp) // vps).max()))


class _HostGraph:
    """numpy copies of a layout's slots and their static run structure,
    made once a solve for the host bounds.  The v-sorted permutation is
    sorted on the graph's device: any stable sort of the same keys gives
    the reference's ``_host_v_perm``."""

    def __init__(self, graph: DistGraph, p: int, n: int):
        self.graph = graph
        self.p, self.n = p, n
        self.cap = graph.cap_total // p
        self.vps = vertices_per_shard(n, p)
        self.u = graph.u.cpu().numpy()
        self.v = graph.v.cpu().numpy()
        self.w = graph.w.cpu().numpy()
        self.valid = np.isfinite(self.w)
        self.shard = np.repeat(np.arange(p), self.cap)
        self.u_starts = _host_run_starts(self.u, p)

    @functools.cached_property
    def vperm(self) -> torch.Tensor:
        """``[p, cap]`` int32 on the graph's device: each shard's stable
        sort of ``where(valid, v, n)``."""
        g = self.graph
        key = torch.where(torch.isfinite(g.w), g.v, self.n).view(self.p,
                                                                 self.cap)
        return torch.sort(key, dim=1, stable=True).indices.to(torch.int32)

    @functools.cached_property
    def vindex(self) -> Tuple[np.ndarray, np.ndarray]:
        """(perm [p * cap] int32 — local indices per shard, skey [p * cap]
        int64 — the sorted keys, padding n at each shard's tail), the
        reference's ``_host_v_perm``."""
        perm = self.vperm.cpu().numpy()
        key = np.where(self.valid, self.v, self.n).astype(np.int64)
        skey = np.take_along_axis(key.reshape(self.p, self.cap), perm,
                                  axis=1)
        return perm.reshape(-1), skey.reshape(-1)

    @functools.cached_property
    def v_sorted_runs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(flat slot of each v-sorted position, run starts over the
        sorted keys, the starts whose key is a real vertex)."""
        perm, skey = self.vindex
        at = (perm.reshape(self.p, self.cap)
              + (np.arange(self.p) * self.cap)[:, None]).reshape(-1)
        starts = _host_run_starts(skey, self.p)
        return at, starts, skey[starts] < self.n

    @functools.cached_property
    def v_slot_starts(self) -> np.ndarray:
        """Run starts of the v column in slot order."""
        return _host_run_starts(self.v, self.p)

    def ghost_table_sizes(self) -> Tuple[int, int]:
        """(Gu, Gv): the most source runs and the most v-sorted runs of
        any shard, the host-exact sizes of the two ghost tables."""
        def most(starts):
            return max(1, int(np.bincount(starts // self.cap,
                                          minlength=self.p).max()))
        return most(self.u_starts), most(self.v_sorted_runs[1])


def _lookup_bounds(hg: _HostGraph, live: Optional[np.ndarray],
                   vsorted: bool) -> Tuple[int, int]:
    """Per (shard, owner), the most coalesced requests of the u column
    (its live runs in slot order) and of the v column (its live runs
    through the v-sorted index, or in slot order); 0 where none."""
    p, vps, shard = hg.p, hg.vps, hg.shard
    hu = _live_heads(hg.u_starts, live)
    bu = _per_pair_max(shard[hu], hg.u[hu] // vps, p)
    if not vsorted:
        hv = _live_heads(hg.v_slot_starts, live)
        return bu, _per_pair_max(shard[hv], hg.v[hv] // vps, p)
    at, starts, real = hg.v_sorted_runs
    if live is None:
        hv = starts[real]
    else:
        hv = starts[real & np.logical_or.reduceat(live[at], starts)]
    skey = hg.vindex[1]
    return bu, _per_pair_max(shard[hv], skey[hv] // vps, p)


def _lookup_bound(hg: _HostGraph, live: Optional[np.ndarray],
                  vsorted: bool) -> int:
    """``default_lookup_capacity`` over a ``_HostGraph``'s cached runs."""
    return max(1, *_lookup_bounds(hg, live, vsorted))


def _ghost_fill_bounds(hg: _HostGraph, live: np.ndarray) -> Tuple[int, int]:
    """Exact per-(shard, owner) request counts of the two ghost fills:
    one request per distinct endpoint value with a live slot (u in slot
    order, v through the v-sorted index)."""
    bu, bv = _lookup_bounds(hg, live, True)
    return max(1, bu), max(1, bv)


def _host_ghost_table(hg: _HostGraph, live: np.ndarray) -> np.ndarray:
    """``[p, p * vps]`` bool: shard s caches vertex x — x is an endpoint
    of one of its live slots.  Entries of all-dead runs are never read
    again, so they are neither filled nor subscribed."""
    t = np.zeros((hg.p, hg.p * hg.vps), bool)
    s = hg.shard[live]
    t[s, hg.u[live]] = True
    t[s, hg.v[live]] = True
    return t


def _root_table(table: np.ndarray, lab_h: np.ndarray) -> np.ndarray:
    """``[p, nv]`` bool: shard s caches an entry whose root under
    ``lab_h`` is r.  Labels are fixpoints at every round boundary (a
    root's own label is itself), so a root table of an earlier round
    maps to this round's like the vertices it came from, and shrinks
    with the component count."""
    s, x = np.nonzero(table)
    out = np.zeros_like(table)
    out[s, lab_h[x]] = True
    return out


def _subscribe_capacity_bound(roots: np.ndarray, p: int, vps: int) -> int:
    """Exact per-(shard, owner) row count of the setup subscription: one
    row per distinct cached root per shard (``roots`` from
    ``_root_table``)."""
    return max(1, int(roots.reshape(p, p, vps).sum(2).max()))


def _push_capacity_bound(dirty: np.ndarray, p: int, vps: int) -> int:
    """Bound on the round's flat push and forward rows.

    ``dirty`` is the root table restricted to the components that chose
    an edge: only those can merge, and a root's subscribers at the start
    of the round are exactly the shards caching an entry with that root.
    Push copies per (owner, subscriber), and forward rows per source
    shard (their destination, the surviving root's owner, is not known
    here).  Decays with the alive-component count."""
    if not dirty.any():
        return 1
    per_pair = int(dirty.reshape(p, p, vps).sum(2).max())
    forward = int(dirty.any(0).reshape(p, vps).sum(1).max())
    return max(1, per_pair, forward)


def _push_capacity_bound_grid(dirty: np.ndarray, R: int, C: int,
                              vps: int) -> Tuple[int, int]:
    """Bounds of the two grid push hops over the same ``dirty`` table.

    The device ships the cross product of the per-axis masks, so both
    bounds count it: hop 1 copies per (owner, destination column), with
    the forward leg's rows per source shard, which share its capacity;
    hop 2 copies per (deputy (ri, cc), destination row), the dirty roots
    owned in row ri with a subscriber in column cc and one in the row.
    Returns (bound_row, bound_col), each >= 1."""
    p = R * C
    rows = dirty.reshape(R, C, -1).any(1)  # [R, nv]: a subscriber in row
    cols = dirty.reshape(R, C, -1).any(0)  # [C, nv]: ... in column
    some = rows.any(0)
    if not some.any():
        return 1, 1
    b_row = max(1, int(cols.reshape(C, p, vps).sum(2).max()),
                int(some.reshape(p, vps).sum(1).max()))
    # [owner row, dest row, col]: roots owned in the row with both bits
    by_row = rows.reshape(R, R, C * vps).transpose(1, 0, 2).astype(np.float64)
    by_col = cols.reshape(C, R, C * vps).transpose(1, 2, 0).astype(np.float64)
    b_col = max(1, int(np.matmul(by_row, by_col).max()))
    return b_row, b_col


def default_lookup_capacity(graph: DistGraph, num_shards, n: int,
                            alive: Optional[np.ndarray] = None,
                            vsorted: bool = True,
                            vindex: Optional[Tuple[np.ndarray,
                                                   np.ndarray]] = None
                            ) -> int:
    """Exact-by-construction capacity for the coalesced endpoint lookups.

    Counts, per (shard, owner) pair, the coalesced requests each
    endpoint column can send: the u column's equal-value runs in slot
    order, and the v column's through the v-sorted index (one request
    per distinct v per shard), or in slot order with ``vsorted=False``.
    With ``alive`` (a [p * cap] bool mask of live slots) only runs
    holding a live slot count.  ``vindex`` supplies a precomputed
    v-sorted index, ``(perm, skey)`` as the reference's ``_host_v_perm``
    returns it.
    """
    hg = _HostGraph(graph, math.prod(shard_layout(num_shards)), n)
    if vindex is not None:
        hg.vindex = vindex
    return _lookup_bound(hg, None if alive is None else np.asarray(alive),
                         vsorted)


class _GhostCfg(NamedTuple):
    """The ghost cache as the shrinking driver sizes it."""
    grid: bool                    # the grid push, on an (R, C) layout
    axis_sizes: Tuple[int, ...]
    push_capacity: Optional[int]  # a pinned push capacity, else None


class _RoundCaps(NamedTuple):
    """One round's host-bounded capacities (ladder rungs), what the
    driver keeps of the bounds, and the round's lookup mode."""
    bound_e: int
    cap_edge: int
    cap_lookup: int
    cap_contract: int
    cap_relabel: int
    choosing: np.ndarray  # [p * vps] bool: components with a candidate
    ghost: bool           # the round reads the ghost tables
    cap_push: int
    cap_push_col: int
    cap_push_flat: int    # the flat push bound (0 without the cache)
    coalesce: bool        # the lookups' levers, after a cache fallback
    vsorted: bool


def _host_round_caps(hg: _HostGraph, lab_h: np.ndarray, live_h: np.ndarray,
                     settled_h: np.ndarray, ce_full: int, cl: int,
                     lk_full: int, coalesce: bool, src_only: bool,
                     relabel_skip: bool, vsorted: bool,
                     ghost: Optional[_GhostCfg] = None,
                     roots: Optional[np.ndarray] = None) -> _RoundCaps:
    """The coming round's exact bounds from the host label table and live
    mask, each snapped up onto its ``shrink_schedule`` ladder, and the
    components that have a candidate (``choosing``).

    ``ghost`` is the solve's cache (None without it) and ``roots`` its
    root table for this round (None once the cache has been dropped).
    The push is sized from the roots that chose an edge; a pinned
    ``push_capacity`` below that bound drops the cache for the rest of
    the solve (``ghost`` False in the result), and every round without
    it then runs coalesced lookups through the v-sorted index.
    """
    p, vps, shard = hg.p, hg.vps, hg.shard
    ru_h = lab_h[hg.u]
    rv_h = lab_h[hg.v]
    alive_h = live_h & (ru_h != rv_h)
    cand = _live_heads(hg.u_starts, alive_h)  # alive source runs
    choosing = np.zeros(p * vps, bool)
    choosing[ru_h[cand]] = True  # ru is constant along a source run
    bound_e = _minedges_capacity_bound(ru_h, rv_h, alive_h, shard, cand, p,
                                       vps, src_only)
    on = roots is not None
    cp, cpc, flat = 1, 0, 0
    if on:
        dirty = roots & choosing
        flat = _push_capacity_bound(dirty, p, vps)
        pb = flat
        if ghost.grid:
            R, C = ghost.axis_sizes
            pb, pbc = _push_capacity_bound_grid(dirty, R, C, vps)
            # a deputy relays at most every owned root once per column
            cpc = quantize_capacity(pbc, C * vps)
        cp = quantize_capacity(pb, vps) if ghost.push_capacity is None \
            else int(ghost.push_capacity)
        if cp < pb:
            # a pinned push capacity that cannot hold the round's dirty
            # roots would leave stale ghost entries: drop the cache and
            # finish with exact lookups
            on, cp, cpc = False, 1, 0
    fallback = ghost is not None and not on
    coalesce = coalesce or fallback
    vsorted = vsorted or fallback
    if on:
        lk = 1  # no endpoint lookup runs
    elif coalesce:
        lk = quantize_capacity(_lookup_bound(hg, live_h, vsorted), lk_full)
    else:
        lk = quantize_capacity(_endpoint_lookup_bound(hg.u, hg.v, live_h,
                                                      shard, p, vps),
                               lk_full)
    rl = quantize_capacity(_relabel_capacity_bound(lab_h, settled_h, p,
                                                   vps), cl) \
        if relabel_skip else cl
    return _RoundCaps(
        bound_e, quantize_capacity(bound_e, ce_full), lk,
        quantize_capacity(_contract_capacity_bound(choosing, rv_h, alive_h,
                                                   vps), cl),
        rl, choosing, on, cp, cpc, flat, coalesce, vsorted)


# --------------------------------------------------------------------------
# shrinking-capacity driver: one round at a time, host-bounded capacities
# --------------------------------------------------------------------------

def _stat_values(st: ExchangeStats) -> np.ndarray:
    """The 8 counters of one step as float64 (one device sync)."""
    return torch.stack([x.double() for x in st]).cpu().numpy()


def _comm_from_acc(acc: np.ndarray, rounds: int,
                   device: torch.device) -> CommStats:
    """``CommStats`` of a float64 host accumulator of the 8 counters
    (its slot 3 unused), each rounded to the field's type."""
    def put(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)

    return CommStats(put(np.int32(acc[0]), torch.int32),
                     *(put(np.float32(x), torch.float32) for x in acc[1:3]),
                     put(rounds, torch.int32),
                     *(put(np.float32(x), torch.float32) for x in acc[4:]))


def _certified_checkpoint(graph: DistGraph, n: int,
                          axis_sizes: Sequence[int], cap: int,
                          algorithm: str, windows, rounds: int,
                          lvl_next: int, r_next: int,
                          plan_pos: Optional[int], lab: torch.Tensor,
                          mask_h: np.ndarray, dead_h: np.ndarray,
                          settled_h: np.ndarray, ghost_on: bool,
                          acc: np.ndarray) -> Optional[MSFCheckpoint]:
    """The invariant barrier, then the snapshot: ``core/verify.py``'s
    structural checks run on the partial forest (labels are fixpoints at
    every round boundary and each chosen edge merged two components, so
    it satisfies the final forest's invariants), and the checkpoint is
    made only on a pass.  A failing barrier returns None: no checkpoint
    beats an uncertified one."""
    from repro_torch.core.verify import verify_forest
    dev = graph.u.device
    rep = verify_forest(graph, n, axis_sizes, torch.from_numpy(mask_h), lab,
                        raise_on_fail=False, device=dev)
    if not rep.ok:
        return None
    return MSFCheckpoint.create(
        n=n, num_shards=math.prod(axis_sizes), cap_per_shard=cap,
        algorithm=algorithm, round_index=rounds, level=lvl_next,
        round_in_level=r_next, plan_pos=plan_pos, level_bounds=windows,
        lab=lab.cpu().numpy().reshape(-1), settled=settled_h, mask=mask_h,
        dead=dead_h, eid=graph.eid.cpu().numpy(), ghost_on=ghost_on,
        stats_acc=acc)


def _sharded_round_step(u, v, w, eid, static: _Static, lab, mst, dead,
                        ghost: Optional[GhostState], settled, lo: float,
                        hi: float, n: int, vps: int,
                        axis_sizes: Sequence[int], caps: _RoundCaps,
                        schedule: str, src_only: bool, adaptive: bool,
                        relabel_skip: bool, pallas_minedges: bool,
                        grid_push: bool):
    """One driver round at its own capacities, counted from zero (the
    reference's ``_sharded_round_shard_fn``).  Returns (lab, mst, dead,
    ghost, settled, go, overflow, stats)."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=w.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=w.device)
    live0 = torch.isfinite(w) & (w > lo_t) & (w <= hi_t)
    return _round_body(
        u, v, w, eid, live0, lab, mst, dead, static.runs_u, static.runs_v,
        static.vidx, ghost if caps.ghost else None, settled, n, vps,
        axis_sizes, caps.cap_edge, caps.cap_relabel, caps.cap_lookup,
        caps.cap_contract, caps.cap_push, caps.cap_push_col, schedule,
        caps.coalesce, src_only, adaptive, relabel_skip, pallas_minedges,
        grid_push and caps.ghost, ExchangeStats.zeros(u.device))


def _shrinking_capacity_msf(graph: DistGraph, hg: _HostGraph, n: int,
                            axis_sizes: Sequence[int], algorithm: str,
                            num_levels: int, max_rounds: Optional[int],
                            ce_full: int, cl: int, lk_full: int,
                            schedule: str, local_preprocessing: bool,
                            coalesce: bool, src_only: bool, adaptive: bool,
                            ghost_cache: bool, relabel_skip: bool,
                            vsorted: bool, push_capacity: Optional[int],
                            round_trace: Optional[List[dict]],
                            pallas_minedges: bool, grid_push: bool,
                            plan_out: Optional[dict] = None,
                            ckpt_every: Optional[int] = None,
                            ckpt_out: Optional[List] = None,
                            resume_from: Optional[MSFCheckpoint] = None):
    """Host-driven rounds with per-round shrinking capacities.

    Runs the same ``_round_body`` as the fused engine one round at a
    time, sizing each round's exchanges from the exact host bounds of
    ``_host_round_caps`` on the measured dead mask and label table,
    snapped up onto the ``shrink_schedule`` ladder.  At overflow 0 the
    result equals the flat engine's; a level whose MINEDGES bound is 0
    skips its trailing empty round, so ``rounds`` counts only the rounds
    executed.  A round with overflow ends the solve (the labels are
    garbage by contract).

    With ``ghost_cache`` the ghost tables are sized host-exactly (the
    most runs of a shard), the fills at their exact request bounds and
    the subscription at its distinct-root bound; each round's push is
    sized from the root table, and a pinned ``push_capacity`` below it
    drops the cache for the rest of the solve, which then finishes with
    exact coalesced lookups (``ghost`` False in the trace).

    ``round_trace`` gets one dict per round, field for field the
    reference's.  With ``plan_out`` (a dict) the driver is the
    measurement pass of ``plan_sharded_msf``: it records the ghost setup
    sizes (``"ghost"``), the level windows (``"level_bounds"``) and one
    ``RoundSpec`` per round at the capacities it chose (``"rounds"``).
    A level that ends on a zero MINEDGES bound records its skipped round
    as a sentinel, which the executor runs at floor capacities so that
    its ``go`` flag proves on the device what the zero bound proved here.

    With ``ckpt_every=k`` and ``ckpt_out`` (a list), every k executed
    rounds the partial forest passes the verifier's barrier and a
    certified ``MSFCheckpoint`` is appended: mid-level, or at the head of
    the next level when this one ended.  ``resume_from`` re-enters at a
    checkpoint's (level, round) with its labels, masks, settled mask,
    counters and level windows; the ghost tables, the root table and the
    host bounds are rebuilt from the restored labels and dead mask
    through the setup path.  The driver publishes each round's 1-based
    number through ``faults.set_round`` just before it runs.
    Returns the engine's 6-tuple on the graph's device;
    the weight is the float64 host sum of the masked slots, rounded to
    float32, as the reference's driver does.
    """
    p = math.prod(axis_sizes)
    vps, cap = hg.vps, hg.cap
    dev = graph.u.device
    mr = (math.ceil(math.log2(max(n, 2))) + 1) if max_rounds is None \
        else max_rounds
    hops = _hops(axis_sizes, schedule)
    u, v, w, eid = (x.view(p, cap) for x in graph)
    valid = torch.isfinite(w)

    if plan_out is not None and (resume_from is not None or ckpt_every):
        raise ValueError(
            "checkpointing is not supported during plan measurement; "
            "checkpoint the planned execution via execute_plan instead")

    overflow = 0
    acc = np.zeros(8, np.float64)
    mst = torch.zeros((p, cap), dtype=torch.bool, device=dev)
    if resume_from is not None:
        # re-entry: the certified snapshot replaces the preprocessing
        # product; the ghost tables are rebuilt below from (lab, dead)
        ck = resume_from.validate_for(n, p, cap)
        if ck.algorithm != algorithm:
            raise CheckpointError(
                f"checkpoint algorithm {ck.algorithm!r} does not match "
                f"this solve's {algorithm!r}")
        lab = torch.tensor(ck.lab, device=dev).view(p, vps)
        pre_mst = torch.zeros((p, cap), dtype=torch.bool, device=dev)
        mst = torch.tensor(ck.mask, device=dev).view(p, cap)
        dead = torch.tensor(ck.dead, device=dev).view(p, cap)
        acc += ck.stats_acc
        ghost_cache = ghost_cache and ck.ghost_on
    elif local_preprocessing:
        lab, pre_mst, dead, ovf, st = _sharded_preprocess(
            u, v, w, eid, valid, n, vps, cl, axis_sizes, schedule,
            ExchangeStats.zeros(dev))
        with tracing.span("sharded.sync"):
            overflow += int(ovf)
            acc += _stat_values(st)
    else:
        lab = _bases(p, vps, dev) + torch.arange(vps, dtype=torch.int32,
                                                 device=dev)
        pre_mst = torch.zeros((p, cap), dtype=torch.bool, device=dev)
        dead = u == v
    with tracing.span("sharded.sync"):
        dead_h = dead.cpu().numpy().reshape(-1)

    gs = roots = cfg = None
    if ghost_cache:
        live_h = hg.valid & ~dead_h
        with tracing.span("sharded.sync"):
            lab_h = lab.cpu().numpy().reshape(-1)
        with tracing.span("host_bounds"):
            roots = _root_table(_host_ghost_table(hg, live_h), lab_h)
            Gu, Gv = hg.ghost_table_sizes()
            bu, bv = _ghost_fill_bounds(hg, live_h)
            gp = GhostPlan(Gu, Gv, quantize_capacity(bu, lk_full),
                           quantize_capacity(bv, lk_full),
                           quantize_capacity(_subscribe_capacity_bound(
                               roots, p, vps), vps))
        if plan_out is not None:
            plan_out["ghost"] = gp
        gs, vidx, runs_u, ovf, st = _ghost_setup(
            u, v, valid, valid & ~dead, lab, hg.vperm, n, vps, *gp,
            axis_sizes, schedule, ExchangeStats.zeros(dev), grid_push)
        with tracing.span("sharded.sync"):
            overflow += int(ovf)
            acc += _stat_values(st)
        cfg = _GhostCfg(grid_push, tuple(axis_sizes), push_capacity)
        # after a fallback the rounds look up through the setup's
        # v-sorted index whatever ``vsorted`` says
        static = _Static(runs_u, None, vidx)
    else:
        static = _static_runs(u, v, valid, n, coalesce, src_only, vsorted,
                              hg.vperm if (coalesce and vsorted) else None)

    if algorithm == "boruvka":
        windows = [(-np.inf, np.inf)]
    elif algorithm == "filter_boruvka":
        piv = [float(x) for x in _host_weight_pivots(hg.w, hg.valid,
                                                     num_levels, p, cap)]
        windows = list(zip([-np.inf] + piv, piv + [np.inf]))
    else:
        raise ValueError(algorithm)
    if resume_from is not None:
        # the snapshot freezes the level windows: pivots recomputed on
        # another layout (an elastic restore) could move them
        windows = [(float(lo), float(hi))
                   for lo, hi in resume_from.level_bounds]
    if plan_out is not None:
        plan_out["level_bounds"] = [(float(lo), float(hi))
                                    for lo, hi in windows]
        plan_out["rounds"] = []

    rounds = start_lvl = start_r = 0
    if resume_from is not None:
        rounds = resume_from.round_index
        start_lvl = resume_from.level
        start_r = resume_from.round_in_level
    for lvl, (lo, hi) in enumerate(windows):
        if lvl < start_lvl:
            continue
        active_h = hg.valid & (hg.w > lo) & (hg.w <= hi)
        # settled is per level: a new weight window revives edges
        if lvl == start_lvl and resume_from is not None:
            settled_h = resume_from.settled.copy()
            settled = torch.tensor(settled_h, device=dev).view(p, vps)
            r = start_r
        else:
            settled = torch.zeros((p, vps), dtype=torch.bool, device=dev)
            settled_h = np.zeros(p * vps, bool)
            r = 0
        while r < mr:
            if overflow:
                # an undersized user capacity already dropped items: the
                # result is unreliable by contract and garbage labels
                # would poison the host bounds, so stop and report
                break
            with tracing.span("sharded.sync"):
                lab_h = lab.cpu().numpy().reshape(-1)
            with tracing.span("host_bounds"):
                if roots is not None:
                    roots = _root_table(roots, lab_h)
                caps = _host_round_caps(hg, lab_h, active_h & ~dead_h,
                                        settled_h, ce_full, cl, lk_full,
                                        coalesce, src_only, relabel_skip,
                                        vsorted, cfg, roots)
            if not caps.ghost:
                roots = None  # the cache is dropped for good
            if plan_out is not None:
                plan_out["rounds"].append(RoundSpec(
                    level=lvl, cap_edge=caps.cap_edge,
                    cap_lookup=caps.cap_lookup,
                    cap_contract=caps.cap_contract,
                    cap_relabel=caps.cap_relabel, cap_push=caps.cap_push,
                    ghost=caps.ghost, sentinel=caps.bound_e == 0,
                    cap_push_col=caps.cap_push_col))
            if caps.bound_e == 0:
                break  # no candidate exists: go would come back False
            faults.set_round(rounds + 1)  # for round-selected aborts
            lab, mst, dead, gs, settled, go, ovf, st = _sharded_round_step(
                u, v, w, eid, static, lab, mst, dead, gs, settled, lo, hi,
                n, vps, axis_sizes, caps, schedule, src_only, adaptive,
                relabel_skip, pallas_minedges, grid_push)
            with tracing.span("sharded.sync"):
                overflow += int(ovf)
                stv = _stat_values(st)
                dead_h = dead.cpu().numpy().reshape(-1)
                go = bool(go)
            acc += stv
            if relabel_skip:
                # the device's rule: a requesting vertex settles iff its
                # pre-contraction component chose nothing this round
                settled_h = settled_h | ~caps.choosing[lab_h]
            rounds += 1
            r += 1
            if round_trace is not None:
                round_trace.append({
                    "round": rounds, "level": lvl,
                    "cap_edge": caps.cap_edge,
                    "cap_lookup": caps.cap_lookup,
                    "cap_contract": caps.cap_contract,
                    "cap_relabel": caps.cap_relabel,
                    "cap_push": caps.cap_push,
                    "cap_push_col": caps.cap_push_col,
                    "cap_push_flat": caps.cap_push_flat,
                    "grid_push": bool(grid_push and caps.ghost),
                    "ghost": caps.ghost,
                    "alive_bound": caps.bound_e,
                    "minedges_buffer_bytes": minedges_buffer_bytes(
                        p, caps.cap_edge, hops, src_only),
                    "a2a_calls": int(stv[0]),
                    "routed_items": float(stv[1]),
                    "buffer_bytes": float(stv[2]),
                    "buffer_slots": float(stv[3]),
                    "cache_hits": float(stv[4]),
                    "lookup_items": float(stv[5]),
                    "pushed_items": float(stv[6]),
                    "injected_items": float(stv[7]),
                })
            if (ckpt_out is not None and ckpt_every
                    and rounds % ckpt_every == 0 and not overflow):
                # re-enter mid-level if the level goes on, else at the
                # head of the next level with a fresh settled mask
                nxt_lvl, nxt_r = (lvl, r) if go else (lvl + 1, 0)
                ck = _certified_checkpoint(
                    graph, n, axis_sizes, cap, algorithm, windows, rounds,
                    nxt_lvl, nxt_r, None, lab,
                    (mst | pre_mst).cpu().numpy().reshape(-1), dead_h,
                    settled_h if go else np.zeros(p * vps, bool),
                    roots is not None, acc)
                if ck is not None:
                    ckpt_out.append(ck)
            if not go:
                break

    mask_t = (mst | pre_mst).reshape(-1)
    with tracing.span("sharded.sync"):
        mask = mask_t.cpu().numpy()

    def put(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)

    comm = _comm_from_acc(acc, rounds, dev)
    weight = np.float32(np.sum(hg.w[mask], dtype=np.float64))
    forest = int(mask.sum())
    tracing.count("sharded.forest_edges", forest)
    return (mask_t, put(weight, torch.float32),
            put(forest, torch.int32), lab.reshape(-1),
            put(overflow, torch.int32), comm)


# --------------------------------------------------------------------------
# planned replay: the shrinking schedule as a value
# --------------------------------------------------------------------------

def _planned_shard_fn(u, v, w, eid, n: int, vps: int,
                      axis_sizes: Sequence[int], plan: RoundPlan,
                      start: int = 0, stop: Optional[int] = None,
                      carry=None):
    """The plan executor over stacked ``[p, cap]`` shards: planned rounds
    ``[start, stop)`` (default: all of them).

    The fused engine's setup and ``_round_body``, with each round's
    capacities read off the plan: every planned round of the segment
    runs, sentinels included, one after another on the device.  Nothing
    between two rounds reads a device value on the host (the
    preprocessing loop and the adaptive doubling inside a round still
    read their flags, as the driver's rounds do).

    ``start == 0`` runs the setup (preprocessing, ghost fill); a later
    segment takes ``carry`` = (lab, mask, dead, settled) from the segment
    before it or from a checkpoint — the mask already holds the
    preprocessing picks — and rebuilds the ghost tables from it through
    the same setup.  A segment whose first round opens a new level starts
    it with a fresh settled mask.  The plain replay is the segment ``[0,
    R)``; ``execute_plan`` cuts it at checkpoint boundaries.

    Never silent, beyond the overflow of every exchange:

      * **ghost tables**: a replay graph with more distinct endpoint
        runs on a shard than the planned tables hold would drop fills
        and read clipped entries, so the excess over the planned sizes
        (the most of any shard) is added to ``overflow``;
      * **residual rounds**: each level's last planned round computes
        ``go`` again, and a level still choosing edges after it adds 1
        to ``residual`` — charged by the segment that runs that round.

    Returns (mask [p, cap], weight, count, lab [p, vps], overflow,
    residual, CommStats, dead [p, cap], settled [p, vps]), the residual
    as a device int32 and ``CommStats.rounds`` the segment's length.
    """
    p = u.shape[0]
    dev = u.device
    R = len(plan.rounds)
    stop = R if stop is None else stop
    valid = torch.isfinite(w)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    stats = ExchangeStats.zeros(dev)
    pre_mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)
    if start > 0:
        lab, mst, dead, settled0 = carry
    else:
        lab = _bases(p, vps, dev) + torch.arange(vps, dtype=torch.int32,
                                                 device=dev)
        mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)
        if plan.local_preprocessing:
            lab, pre_mst, dead, ovf, stats = _sharded_preprocess(
                u, v, w, eid, valid, n, vps, plan.cap_prep, axis_sizes,
                plan.schedule, stats)
            overflow = overflow + ovf
        else:
            dead = u == v

    gs = None
    if plan.ghost is not None:
        gp = plan.ghost
        gs, vidx, runs_u, ovf, stats = _ghost_setup(
            u, v, valid, valid & ~dead, lab, None, n, vps, *gp, axis_sizes,
            plan.schedule, stats, plan.grid_push)
        runs_v = None
        # the structural guard: runs past the planned tables were dropped
        nu = runs_u[0].sum(1, dtype=torch.int32).max()
        nv = vidx.runs[0].sum(1, dtype=torch.int32).max()
        overflow = (overflow + ovf + (nu - gp.table_u).clamp(min=0)
                    + (nv - gp.table_v).clamp(min=0))
    else:
        runs_u, runs_v, vidx = _static_runs(u, v, valid, n, plan.coalesce,
                                            plan.src_only,
                                            plan.vsorted_index)

    residual = torch.zeros((), dtype=torch.int32, device=dev)
    start_level = plan.rounds[start].level if start < R else 0
    fresh_level = start == 0 or (start < R and plan.rounds[start].level
                                 != plan.rounds[start - 1].level)
    settled = torch.zeros((p, vps), dtype=torch.bool, device=dev)
    for lvl, (lo, hi) in enumerate(plan.level_bounds):
        idxs = [i for i, r in enumerate(plan.rounds) if r.level == lvl]
        run = [i for i in idxs if start <= i < stop]
        if lvl < start_level or not run:
            continue
        live0 = valid
        if len(plan.level_bounds) > 1:
            live0 = valid & (w > torch.tensor(lo, dtype=torch.float32,
                                              device=dev)) \
                & (w <= torch.tensor(hi, dtype=torch.float32, device=dev))
        if lvl == start_level and not fresh_level:
            settled = settled0
        else:
            settled = torch.zeros((p, vps), dtype=torch.bool, device=dev)
        go = None
        for i in run:
            spec = plan.rounds[i]
            # the driver's lever rules, frozen per round: a round of a
            # cached plan without the cache is its fallback, which looks
            # up coalesced through the v-sorted index
            fallback = plan.ghost is not None and not spec.ghost
            coalesce_eff = plan.coalesce or fallback
            vidx_r = vidx if (spec.ghost or (coalesce_eff
                                             and vidx is not None)) else None
            lab, mst, dead, g_out, settled, go, o, stats = _round_body(
                u, v, w, eid, live0, lab, mst, dead, runs_u, runs_v, vidx_r,
                gs if spec.ghost else None, settled, n, vps, axis_sizes,
                spec.cap_edge, spec.cap_relabel, spec.cap_lookup,
                spec.cap_contract, spec.cap_push, spec.cap_push_col,
                plan.schedule, coalesce_eff, plan.src_only,
                plan.adaptive_doubling, plan.relabel_skip,
                plan.pallas_minedges, plan.grid_push and spec.ghost, stats)
            if spec.ghost:
                gs = g_out
            overflow = overflow + o
        if go is not None and idxs[-1] < stop:
            # a level still choosing edges after its planned rounds has
            # work the plan did not provision
            residual = residual + go.to(torch.int32)

    full_mask = mst | pre_mst
    weight = psum_f32(reference_order_sum(torch.where(full_mask, w, 0.0)))
    count = full_mask.sum(dtype=torch.int32)
    if stop == R:  # the segment that completes the forest
        _count_forest(count)
    comm = CommStats(stats.calls, stats.items, stats.bytes,
                     torch.tensor(stop - start, dtype=torch.int32,
                                  device=dev),
                     stats.hits, stats.misses, stats.pushed, stats.injected)
    return (full_mask, weight, count, lab, overflow, residual, comm, dead,
            settled)


def _validate_plan_shape(plan: RoundPlan, n: int, p: int, cap: int) -> None:
    plan.validate()
    if (plan.n, plan.num_shards, plan.cap_per_shard) != (n, p, cap):
        raise ValueError(
            f"plan was measured for n={plan.n}, p={plan.num_shards}, "
            f"cap/shard={plan.cap_per_shard} but this solve has n={n}, "
            f"p={p}, cap/shard={cap}; plans only transfer across "
            "graphs built at the same shape")


def _check_plan(plan: RoundPlan, n: int, axis_sizes: Sequence[int],
                cap: int) -> None:
    _validate_plan_shape(plan, n, math.prod(axis_sizes), cap)
    if plan.grid_push and len(axis_sizes) != 2:
        raise ValueError(
            "plan was measured with the two-level grid push and needs an "
            f"(R, C) layout, got {tuple(axis_sizes)}")


def _run_segment(graph: DistGraph, n: int, axis_sizes: Sequence[int],
                 plan: RoundPlan, start: int = 0,
                 stop: Optional[int] = None, carry=None):
    """``_planned_shard_fn`` on a flat ``DistGraph`` (``carry`` flat too).
    Returns its 9-tuple with the mask, labels, dead and settled masks
    flat, all on the graph's device."""
    p = math.prod(axis_sizes)
    cap = graph.cap_total // p
    vps = vertices_per_shard(n, p)
    if carry is not None:
        carry = tuple(x.view(p, -1) for x in carry)
    out = _planned_shard_fn(*(x.view(p, cap) for x in graph), n, vps,
                            axis_sizes, plan, start, stop, carry)
    mask, weight, count, lab, ovf, residual, comm, dead, settled = out
    return (mask.reshape(-1), weight, count, lab.reshape(-1), ovf, residual,
            comm, dead.reshape(-1), settled.reshape(-1))


def _run_plan(graph: DistGraph, n: int, axis_sizes: Sequence[int],
              plan: RoundPlan):
    """The whole plan on a flat ``DistGraph``.  Returns (mask [p * cap],
    weight, count, labels [p * vps], overflow, residual, CommStats), all
    on the graph's device."""
    _check_plan(plan, n, axis_sizes, graph.cap_total // math.prod(axis_sizes))
    return _run_segment(graph, n, axis_sizes, plan)[:7]


def _replan_with_plan(graph: DistGraph, n: int, num_shards,
                      plan: RoundPlan,
                      round_trace: Optional[List[dict]] = None,
                      ckpt_every: Optional[int] = None,
                      ckpt_out: Optional[List] = None,
                      resume_from: Optional[MSFCheckpoint] = None):
    """One fresh measured pass with the plan's frozen levers: the
    fallback of a replay that does not fit, and the serving gateway's
    retry rung.  The checkpoint arguments pass through to the driver, so
    a rung takes certified snapshots and the next rung resumes from the
    last one."""
    return distributed_sharded_msf(
        graph, n, num_shards, algorithm=plan.algorithm,
        num_levels=len(plan.level_bounds), schedule=plan.schedule,
        local_preprocessing=plan.local_preprocessing,
        coalesce=plan.coalesce, src_only=plan.src_only,
        adaptive_doubling=plan.adaptive_doubling,
        shrink_capacities=True, ghost_cache=plan.ghost is not None,
        ghost_push=(("grid" if plan.grid_push else "flat")
                    if plan.ghost is not None else None),
        relabel_skip=plan.relabel_skip,
        vsorted_index=plan.vsorted_index,
        pallas_minedges=plan.pallas_minedges, round_trace=round_trace,
        ckpt_every=ckpt_every, ckpt_out=ckpt_out, resume_from=resume_from)


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def shard_layout(num_shards) -> Tuple[int, ...]:
    """The shard layout's axis sizes: ``(p,)`` for an int, ``(R, C)``
    for a pair — the reference's ``Mesh(devices.reshape(R, C), ("row",
    "col"))``, shard s at ``(s // C, s % C)``."""
    sizes = tuple(int(x) for x in num_shards) \
        if isinstance(num_shards, (tuple, list)) else (int(num_shards),)
    if not sizes or min(sizes) < 1:
        raise ValueError(f"num_shards must be a positive int or a tuple of "
                         f"them, got {num_shards!r}")
    return sizes


def _ghost_push_mode(ghost_cache: bool, mode: Optional[str],
                     axis_sizes: Sequence[int],
                     limit: Optional[int]) -> Tuple[bool, bool]:
    """Select the ghost push for this layout: ``(ghost_on, grid)``.

    The auto ladder (``mode`` None) takes the flat push when ``p`` fits
    one mask (``p <= min(limit, 31)``), else the grid push on an
    ``(R, C)`` layout whose axes each fit one, else no cache.  ``limit``
    is ``ghost_shard_limit`` (None means 31).  An explicit ``"flat"`` or
    ``"grid"`` that the layout cannot honour raises; it is never
    downgraded.
    """
    p = math.prod(axis_sizes)
    if not ghost_cache:
        return False, False
    width = min(MAX_GHOST_SHARDS if limit is None else int(limit),
                MAX_GHOST_SHARDS)
    if mode == "flat":
        if p > MAX_GHOST_SHARDS:
            raise ValueError(
                f"ghost_push='flat' needs p <= {MAX_GHOST_SHARDS} "
                f"(int32 subscriber bitmask), got p={p}")
        return True, False
    if mode == "grid":
        if len(axis_sizes) != 2:
            raise ValueError(
                "ghost_push='grid' needs an (R, C) layout, got "
                f"{len(axis_sizes)} axes {tuple(axis_sizes)}")
        if max(axis_sizes) > MAX_GHOST_SHARDS:
            raise ValueError(
                f"ghost_push='grid' needs every axis <= {MAX_GHOST_SHARDS}, "
                f"got {tuple(axis_sizes)}")
        return True, True
    if mode is not None:
        raise ValueError(f"unknown ghost_push mode {mode!r}; one of None "
                         "(auto), 'flat', 'grid'")
    if p <= width:
        return True, False
    if len(axis_sizes) == 2 and max(axis_sizes) <= width:
        return True, True
    return False, False


def _full_capacities(graph: DistGraph, hg: Optional[_HostGraph], n: int,
                     p: int, edge_capacity: Optional[int],
                     label_capacity: Optional[int],
                     lookup_capacity: Optional[int], coalesce: bool,
                     ghost_cache: bool, vsorted_index: bool
                     ) -> Tuple[int, int, int]:
    """The flat capacities (edge, label, lookup): a user's value where
    given, else edges/shard, vps, and the exact coalesced-run bound
    (through the v-sorted index when it or the cache is on) under
    ``coalesce`` or the cache, or the edge capacity."""
    # is-None (not falsy) checks: an explicit 0 must be honored — it
    # yields all-overflow results, which the overflow count reports
    ce = int(graph.cap_total // p if edge_capacity is None else edge_capacity)
    cl = int(vertices_per_shard(n, p) if label_capacity is None
             else label_capacity)
    if lookup_capacity is not None:
        lk = int(lookup_capacity)
    elif coalesce or ghost_cache:
        lk = int(_lookup_bound(hg, None, vsorted_index or ghost_cache))
    else:
        lk = ce
    return ce, cl, lk


def distributed_sharded_msf(graph: DistGraph, n: int, num_shards, *,
                            algorithm: str = "boruvka",
                            num_levels: int = 4,
                            max_rounds: Optional[int] = None,
                            edge_capacity: Optional[int] = None,
                            label_capacity: Optional[int] = None,
                            lookup_capacity: Optional[int] = None,
                            schedule: str = "grid",
                            local_preprocessing: bool = True,
                            coalesce: bool = True,
                            src_only: bool = True,
                            adaptive_doubling: bool = True,
                            shrink_capacities: bool = True,
                            ghost_cache: bool = True,
                            relabel_skip: bool = True,
                            vsorted_index: bool = True,
                            pallas_minedges: bool = False,
                            ghost_push: Optional[str] = None,
                            push_capacity: Optional[int] = None,
                            round_trace: Optional[List[dict]] = None,
                            plan: Optional[RoundPlan] = None,
                            replan: bool = True,
                            ghost_shard_limit: Optional[int] = None,
                            ckpt_every: Optional[int] = None,
                            ckpt_out: Optional[List] = None,
                            resume_from=None):
    """Run the sharded-label distributed MSF over ``num_shards`` stacked
    shards on the graph's device.

    The reference's signature and defaults, with ``num_shards`` where the
    reference takes a mesh: an int ``p``, or an ``(R, C)`` pair for the
    reference's two-axis mesh (``shard_layout``), on which the grid
    schedule takes one hop per axis.  Returns (mask, weight, count,
    labels, overflow, stats):

      * ``mask`` [p * cap] bool is aligned with ``graph`` slots, exactly
        one directed copy of each MSF edge marked (the canonical u < v
        copy when ``src_only=False``);
      * ``labels`` [p * vps] int32 is the sharded label vector laid out
        shard-major (slice [:n] for the per-vertex view);
      * ``overflow`` counts exchange items that exceeded capacity over
        all rounds — results are exact iff it is 0 (guaranteed with the
        default capacities);
      * ``stats`` is a ``CommStats``.

    ``shrink_capacities=True`` runs the host-driven per-round capacity
    schedule, and ``round_trace`` (a caller list) then receives one dict
    per round; ``shrink_capacities=False`` runs the fused flat-capacity
    engine, whose ``round_trace`` stays empty, as in the reference.
    ``lookup_capacity`` defaults to the exact coalesced-run bound
    (``default_lookup_capacity``, through the v-sorted index when it or
    the cache is on) under ``coalesce`` or the cache, else to the edge
    capacity.  ``pallas_minedges=True`` routes both MINEDGES reductions
    through K1 (the CUDA kernel on the card, its plain version on the
    CPU).

    ``ghost_cache=True`` keeps per-shard ghost tables of the endpoint
    labels: filled once, read locally every round, kept coherent by a
    root-delta push after each contraction.  ``ghost_push`` picks the
    push (``_ghost_push_mode``: None walks flat → grid → off,
    ``"flat"``/``"grid"`` pin a rung and raise where the layout cannot
    take it); ``ghost_shard_limit`` caps the mask width of both rungs
    (31).  ``push_capacity`` pins the push exchange: the shrinking
    driver then drops the cache in a round whose push bound it cannot
    hold, the fused engine reports the overflow.

    ``plan`` replays a measured ``RoundPlan`` (``plan_sharded_msf``)
    instead: its rounds run one after another at the planned capacities,
    with no host bound between them, and its frozen levers override this
    call's.  A plan that does not fit the graph (overflow, or a level
    still choosing edges after its last planned round) is never silent:
    the call replans, one fresh measured pass whose ``round_trace`` it
    fills, or with ``replan=False`` raises ``RuntimeError``.

    Checkpoints (the shrinking driver only): ``ckpt_every=k`` with
    ``ckpt_out`` (a list) appends a certified ``MSFCheckpoint`` every k
    executed rounds; ``resume_from=ck`` re-enters at the checkpoint's
    (level, round), and the resumed run's forest and labels equal the
    uninterrupted run's.  A ``ck.remap(...)`` of a checkpoint restores it
    onto another shard count (pass the graph laid out at that count).
    Beside a plan or on the fused engine they raise ``ValueError``;
    checkpointed replay is ``execute_plan``'s.
    """
    wants_ckpt = (ckpt_every is not None or ckpt_out is not None
                  or resume_from is not None)
    axis_sizes = shard_layout(num_shards)
    if plan is not None:
        if wants_ckpt:
            raise ValueError(
                "checkpointing a plan replay goes through execute_plan("
                "ckpt_every=..., resume_from=...), which segments the "
                "planned rounds at cadence boundaries")
        mask, weight, count, lab, ovf, residual, comm = _run_plan(
            graph, n, axis_sizes, plan)
        o, r = torch.stack([ovf, residual]).tolist()
        if o == 0 and r == 0:
            return mask, weight, count, lab, ovf, comm
        if not replan:
            raise RuntimeError(
                f"plan replay does not fit this graph (overflow={o}, "
                f"residual levels={r}); pad the plan, re-measure with "
                "plan_sharded_msf, or allow replan=True")
        return _replan_with_plan(graph, n, num_shards, plan,
                                 round_trace=round_trace)
    if wants_ckpt and not shrink_capacities:
        raise ValueError(
            "checkpointing needs the host-driven shrinking-capacity path "
            "(shrink_capacities=True): the fused engine has no round "
            "boundary to snapshot at")
    p = math.prod(axis_sizes)
    ghost_cache, grid_push = _ghost_push_mode(ghost_cache, ghost_push,
                                              axis_sizes, ghost_shard_limit)
    vps = vertices_per_shard(n, p)
    cap = graph.cap_total // p
    with tracing.span("host_bounds"):
        hg = _HostGraph(graph, p, n) \
            if (coalesce or shrink_capacities or ghost_cache) else None
        ce, cl, lk = _full_capacities(graph, hg, n, p, edge_capacity,
                                      label_capacity, lookup_capacity,
                                      coalesce, ghost_cache, vsorted_index)
    if shrink_capacities:
        return _shrinking_capacity_msf(
            graph, hg, n, axis_sizes, algorithm, num_levels, max_rounds, ce,
            cl, lk, schedule, local_preprocessing, coalesce, src_only,
            adaptive_doubling, ghost_cache, relabel_skip, vsorted_index,
            push_capacity, round_trace, pallas_minedges, grid_push,
            ckpt_every=ckpt_every, ckpt_out=ckpt_out,
            resume_from=resume_from)
    cp = int(vps if push_capacity is None else push_capacity)
    # the fused engine has no bound for the deputy hop: a deputy relays
    # at most one full first-hop buffer per column
    cpc = cp * axis_sizes[1] if grid_push else 0

    def shards(x):
        return x.view(p, cap)

    mask, weight, count, lab, overflow, comm = _sharded_shard_fn(
        shards(graph.u), shards(graph.v), shards(graph.w),
        shards(graph.eid), n, vps, axis_sizes, algorithm, num_levels,
        max_rounds, ce, cl, lk, cp, cpc, schedule, local_preprocessing,
        coalesce, src_only, adaptive_doubling, ghost_cache, relabel_skip,
        vsorted_index, pallas_minedges, grid_push)
    return (mask.reshape(-1), weight, count, lab.reshape(-1), overflow,
            comm)


def plan_sharded_msf(graph: DistGraph, n: int, num_shards, *,
                     algorithm: str = "boruvka", num_levels: int = 4,
                     max_rounds: Optional[int] = None,
                     edge_capacity: Optional[int] = None,
                     label_capacity: Optional[int] = None,
                     lookup_capacity: Optional[int] = None,
                     schedule: str = "grid",
                     local_preprocessing: bool = True,
                     coalesce: bool = True, src_only: bool = True,
                     adaptive_doubling: bool = True,
                     ghost_cache: bool = True, relabel_skip: bool = True,
                     vsorted_index: bool = True,
                     pallas_minedges: bool = False,
                     ghost_push: Optional[str] = None,
                     ghost_shard_limit: Optional[int] = None,
                     push_capacity: Optional[int] = None,
                     round_trace: Optional[List[dict]] = None
                     ) -> RoundPlan:
    """Measure a ``RoundPlan`` for ``graph``: one pass of the shrinking
    driver, whose schedule is frozen — each round's capacities (ladder
    rungs, so the plan transfers to similar graphs), the preprocessing
    and ghost-setup capacities, the filter levels' windows, and a
    sentinel round for each level that ended on a zero bound.

    Replay it with ``execute_plan`` or ``distributed_sharded_msf(...,
    plan=plan)``; ``plan.pad`` adds headroom, ``plan.to_json`` makes it
    durable.  Raises ``RuntimeError`` if the measurement pass overflowed
    (undersized explicit capacities): such a plan would be unreliable.
    ``round_trace`` passes through to the driver.
    """
    axis_sizes = shard_layout(num_shards)
    p = math.prod(axis_sizes)
    ghost_cache, grid_push = _ghost_push_mode(ghost_cache, ghost_push,
                                              axis_sizes, ghost_shard_limit)
    with tracing.span("host_bounds"):
        hg = _HostGraph(graph, p, n)
        ce, cl, lk = _full_capacities(graph, hg, n, p, edge_capacity,
                                      label_capacity, lookup_capacity,
                                      coalesce, ghost_cache, vsorted_index)
    rec: dict = {}
    res = _shrinking_capacity_msf(
        graph, hg, n, axis_sizes, algorithm, num_levels, max_rounds, ce, cl,
        lk, schedule, local_preprocessing, coalesce, src_only,
        adaptive_doubling, ghost_cache, relabel_skip, vsorted_index,
        push_capacity, round_trace, pallas_minedges, grid_push, plan_out=rec)
    ovf = int(res[4])
    if ovf:
        raise RuntimeError(
            f"measurement pass overflowed ({ovf} items): a plan recorded "
            "off a lossy pass would be unreliable — retry with larger "
            "explicit capacities (or the exact defaults)")
    ghost = rec.get("ghost")
    return RoundPlan(
        n=n, num_shards=p, cap_per_shard=graph.cap_total // p,
        algorithm=algorithm, schedule=schedule,
        local_preprocessing=local_preprocessing, coalesce=coalesce,
        src_only=src_only, adaptive_doubling=adaptive_doubling,
        relabel_skip=relabel_skip, vsorted_index=vsorted_index,
        cap_prep=cl, edge_capacity_full=ce, label_capacity_full=cl,
        lookup_capacity_full=lk, ghost=ghost,
        level_bounds=tuple(rec["level_bounds"]), rounds=tuple(rec["rounds"]),
        pallas_minedges=pallas_minedges,
        grid_push=grid_push and ghost is not None).validate()


def execute_plan(graph: DistGraph, n: int, num_shards, plan: RoundPlan, *,
                 replan: bool = True,
                 round_trace: Optional[List[dict]] = None,
                 verify: bool = False, ckpt_every: Optional[int] = None,
                 ckpt_out: Optional[List] = None,
                 resume_from: Optional[MSFCheckpoint] = None):
    """Replay a measured ``RoundPlan`` on a graph of the same shape.

    ``distributed_sharded_msf(graph, n, num_shards, plan=plan)``: the
    planned rounds run at their capacities, and a plan that does not fit
    replans (``replan=True``) or raises (``replan=False``, the strict
    mode).  ``round_trace`` is filled only by a replan: a fitting replay
    has no host step between rounds to tabulate.

    ``verify=True`` checks the returned forest (``core/verify.py``)
    against the structural invariants and the replay's own weight and
    count, raising ``VerifyFailure`` rather than returning a wrong
    forest.

    Checkpoints: ``ckpt_every=k`` with ``ckpt_out`` cuts the replay at
    planned rounds k, 2k, ... (``_planned_shard_fn`` segments) and runs
    the certify + snapshot barrier between segments, each checkpoint
    carrying its ``plan_pos``; ``resume_from=ck`` skips ahead to
    ``ck.plan_pos`` with the restored carry.  The forest, labels, weight
    and count equal the uninterrupted replay's; the counters add the
    segments' in float64, and each later segment fills the ghost tables
    again.
    """
    if ckpt_every is None and ckpt_out is None and resume_from is None:
        out = distributed_sharded_msf(graph, n, num_shards, plan=plan,
                                      replan=replan, round_trace=round_trace)
        if verify:
            _verify_result(graph, n, num_shards, out)
        return out
    axis_sizes = shard_layout(num_shards)
    p = math.prod(axis_sizes)
    vps = vertices_per_shard(n, p)
    cap = graph.cap_total // p
    dev = graph.u.device
    _check_plan(plan, n, axis_sizes, cap)
    R = len(plan.rounds)
    start = 0
    carry = None
    acc = np.zeros(8, np.float64)
    total_ovf = total_res = 0
    if resume_from is not None:
        ck = resume_from.validate_for(n, p, cap)
        if ck.plan_pos is None:
            raise CheckpointError(
                "this checkpoint was taken by the host driver (no plan "
                "position); resume it via distributed_sharded_msf("
                "resume_from=...) instead")
        if not 0 < ck.plan_pos <= R:
            raise CheckpointError(
                f"checkpoint plan_pos={ck.plan_pos} is outside this "
                f"plan's {R} rounds — it was taken against a different "
                "plan")
        start = int(ck.plan_pos)
        carry = _checkpoint_carry(ck, dev)
        acc += ck.stats_acc
    stops = []
    if ckpt_every:
        k = int(ckpt_every)
        stops = list(range((start // k + 1) * k, R, k))
    stops.append(R)
    out = None
    for stop in stops:
        if stop <= start:
            continue
        out = _run_segment(graph, n, axis_sizes, plan, start, stop, carry)
        mask, weight, count, lab, ovf, residual, comm, dead, settled = out
        o, r = torch.stack([ovf, residual]).tolist()
        total_ovf += o
        total_res += r
        vals = _stat_values(comm)
        vals[3] = 0.0  # the round count is the plan's, not a sum
        acc += vals
        if stop < R and not total_ovf:
            lvl_next = plan.rounds[stop].level
            fresh = lvl_next != plan.rounds[stop - 1].level
            ck2 = _certified_checkpoint(
                graph, n, axis_sizes, cap, plan.algorithm, plan.level_bounds,
                stop, lvl_next,
                sum(1 for j in range(stop) if plan.rounds[j].level
                    == lvl_next),
                stop, lab, mask.cpu().numpy(), dead.cpu().numpy(),
                np.zeros(p * vps, bool) if fresh else settled.cpu().numpy(),
                plan.ghost is not None, acc)
            if ck2 is not None and ckpt_out is not None:
                ckpt_out.append(ck2)
        carry = (lab, mask, dead, settled)
        start = stop

    if out is None:  # resumed at the plan's end: nothing left to run
        mask, lab = carry[1], carry[0]
        w_h = graph.w.cpu().numpy()
        weight = torch.tensor(np.sum(w_h[ck.mask], dtype=np.float64),
                              dtype=torch.float32, device=dev)
        count = torch.tensor(int(ck.mask.sum()), dtype=torch.int32,
                             device=dev)
    comm_total = _comm_from_acc(acc, plan.num_rounds, dev)
    if total_ovf or total_res:
        if not replan:
            raise RuntimeError(
                f"plan replay does not fit this graph (overflow="
                f"{total_ovf}, residual levels={total_res}); pad the "
                "plan, re-measure with plan_sharded_msf, or allow "
                "replan=True")
        return _replan_with_plan(graph, n, num_shards, plan,
                                 round_trace=round_trace,
                                 ckpt_every=ckpt_every, ckpt_out=ckpt_out)
    result = (mask, weight, count, lab,
              torch.tensor(total_ovf, dtype=torch.int32, device=dev),
              comm_total)
    if verify:
        _verify_result(graph, n, num_shards, result)
    return result


def _checkpoint_carry(ck: MSFCheckpoint, device: torch.device):
    """A checkpoint's (lab, mask, dead, settled), copied to the device."""
    return tuple(torch.tensor(x, device=device)
                 for x in (ck.lab, ck.mask, ck.dead, ck.settled))


def _verify_result(graph: DistGraph, n: int, num_shards, res):
    """``verify_forest`` of an engine 6-tuple against its own weight and
    count; raises ``VerifyFailure``."""
    from repro_torch.core.verify import verify_forest
    verify_forest(graph, n, num_shards, res[0], res[3],
                  expected_weight=float(res[1]), expected_count=int(res[2]),
                  device=graph.u.device)


def execute_plan_batched(graphs, n: int, num_shards, plan: RoundPlan, *,
                         replan=True, stack: bool = True,
                         verify: bool = False,
                         resume_from: Optional[
                             Sequence[MSFCheckpoint]] = None,
                         device: DeviceLike = None):
    """Replay one measured ``RoundPlan`` on B same-shape graphs.

    The requests go one after another through the planned executor on
    ``device`` (the CUDA card when None, which raises where there is
    none; the tests pass ``"cpu"``), each with its own overflow and
    residual, so a request the plan does not fit never poisons the
    others: it is re-solved alone by one fresh measured pass
    (``replan=True``), the call raises naming the offending batch
    indices (``replan=False``), or its result comes back as None for the
    caller to handle (``replan="defer"``).

    ``verify=True`` checks every returned forest against its own weight
    and count; a forest that fails is treated like an ill-fitting
    request: replanned and verified again strictly (``replan=True``),
    deferred to None, or the ``VerifyFailure`` propagates
    (``replan=False``).

    Returns ``(results, flagged)``: ``results[i]`` is the engine's
    6-tuple for request i (overflow 0 wherever it is not None), and
    ``flagged`` the tuple of indices that fell back or were deferred.

    ``stack=False`` takes ``graphs`` as one ``DistGraph`` of ``[B, p *
    cap]`` tensors.  ``resume_from`` is one checkpoint per request, all
    at one ``plan_pos``, from which the batch skips ahead.
    """
    dev = resolve_device(device)
    axis_sizes = shard_layout(num_shards)
    p = math.prod(axis_sizes)
    if stack:
        batch = [DistGraph(*(x.to(dev) for x in g)) for g in graphs]
        for g in batch:
            _check_plan(plan, n, axis_sizes, g.cap_total // p)
    else:
        stacked = DistGraph(*(x.to(dev) for x in graphs))
        _check_plan(plan, n, axis_sizes, int(stacked.u.shape[1]) // p)
        batch = [DistGraph(*(x[i] for x in stacked))
                 for i in range(int(stacked.u.shape[0]))]
    start, carries = 0, [None] * len(batch)
    if resume_from is not None:
        cks = list(resume_from)
        if len(cks) != len(batch) or any(c is None for c in cks):
            raise CheckpointError(
                f"batched resume needs one checkpoint per request "
                f"({len(batch)}), got {len(cks)} "
                f"({sum(c is None for c in cks)} missing)")
        poss = {c.plan_pos for c in cks}
        if len(poss) != 1 or None in poss:
            raise CheckpointError(
                "batched resume needs every checkpoint at one shared "
                f"plan position (one compiled segment), got {poss}")
        for c in cks:
            c.validate_for(n, p, batch[0].cap_total // p)
        start = int(cks[0].plan_pos)
        if not 0 < start <= len(plan.rounds):
            raise CheckpointError(
                f"checkpoint plan_pos={start} is outside this plan's "
                f"{len(plan.rounds)} rounds — taken against a "
                "different plan")
        carries = [_checkpoint_carry(c, dev) for c in cks]
    outs = [_run_segment(g, n, axis_sizes, plan, start, None, c)[:7]
            for g, c in zip(batch, carries)]
    fit = torch.stack([torch.stack([o[4], o[5]]) for o in outs]).tolist()
    defer = replan == "defer"
    bad = tuple(i for i, (o, r) in enumerate(fit) if o or r)
    if bad and not replan:
        raise RuntimeError(
            f"plan replay does not fit batch requests {list(bad)} "
            f"(overflow={[fit[i][0] for i in bad]}, residual="
            f"{[fit[i][1] for i in bad]}); pad the plan, re-measure "
            "with plan_sharded_msf, or allow replan=True")
    results = []
    for i, out in enumerate(outs):
        if i not in bad:
            mask, weight, count, lab, ovf, _, comm = out
            results.append((mask, weight, count, lab, ovf, comm))
        elif defer:
            results.append(None)
        else:
            # this request alone falls back to one fresh measured pass
            results.append(_replan_with_plan(batch[i], n, num_shards, plan))
    if verify:
        from repro_torch.core.verify import VerifyFailure
        for i, res in enumerate(results):
            if res is None:
                continue
            try:
                _verify_result(batch[i], n, num_shards, res)
            except VerifyFailure:
                if defer:
                    results[i] = None
                    if i not in bad:
                        bad = bad + (i,)
                elif replan and i not in bad:
                    # one strict rung: replan, verify again, else raise
                    r2 = _replan_with_plan(batch[i], n, num_shards, plan)
                    _verify_result(batch[i], n, num_shards, r2)
                    results[i] = r2
                    bad = bad + (i,)
                else:
                    raise
    return results, bad


def make_sharded_mst_step(n: int, cap_total: int, num_shards,
                          algorithm: str = "boruvka",
                          plan: Optional[RoundPlan] = None, **kw):
    """A sharded MSF step of fixed shape that never replans: the port's
    counterpart of the reference's AOT-lowered step, which has no host
    to replan on.  Returns (step, specs): ``step(u, v, w, eid)`` on
    ``[cap_total]`` tensors gives the engine's 6-tuple, and ``specs``
    are its inputs' ``(shape, dtype)`` pairs.

    With ``plan`` the step replays it; the residual count is folded into
    the returned ``overflow`` (exact iff 0) and a plan of another shape
    raises ``ValueError``.  Without one the step runs the fused
    flat-capacity engine: ``shrink_capacities=True`` raises (measure a
    plan instead), an omitted ``shrink_capacities`` warns, and ``False``
    is silent.
    """
    axis_sizes = shard_layout(num_shards)
    p = math.prod(axis_sizes)
    if plan is not None:
        if (cap_total != plan.cap_per_shard * p or n != plan.n
                or p != plan.num_shards):
            raise ValueError(
                f"plan shape (n={plan.n}, p={plan.num_shards}, "
                f"cap/shard={plan.cap_per_shard}) does not match the step "
                f"shape (n={n}, p={p}, cap/shard={cap_total // max(p, 1)})")

        def step(u, v, w, eid):
            mask, weight, count, lab, ovf, residual, comm = _run_plan(
                DistGraph(u, v, w, eid), n, axis_sizes, plan)
            return mask, weight, count, lab, ovf + residual, comm
    else:
        if kw.get("shrink_capacities"):
            raise ValueError(
                "shrink_capacities=True cannot drive the host-orchestrated "
                "schedule in a fixed step; measure a RoundPlan once "
                "(plan_sharded_msf) and pass plan=..., or request the "
                "flat-capacity engine explicitly with "
                "shrink_capacities=False")
        if "shrink_capacities" not in kw:
            warnings.warn(
                "make_sharded_mst_step without a plan runs the fused "
                "flat-capacity engine (worst-case buffers every round); "
                "pass plan=plan_sharded_msf(...) to step the shrinking "
                "schedule, or shrink_capacities=False to silence this",
                stacklevel=2)
            kw = dict(kw, shrink_capacities=False)

        def step(u, v, w, eid):
            return distributed_sharded_msf(DistGraph(u, v, w, eid), n,
                                           num_shards, algorithm=algorithm,
                                           **kw)

    specs = (((cap_total,), torch.int32), ((cap_total,), torch.int32),
             ((cap_total,), torch.float32), ((cap_total,), torch.int32))
    return step, specs
