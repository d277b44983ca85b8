"""Sharded-label distributed Borůvka / Filter-Borůvka (Section IV, the
scalable path for n >> memory/PE).

Port of ``repro/core/distributed_sharded.py``, flat baseline: every
communication lever off (the reference's first sharded engine).  The
label vector is 1D-sharded by vertex id (owner of ``vid`` is shard
``vid // vps``) and every label access is a routed request/reply through
``comm/exchange.py``.  The reference runs one program per device under
``shard_map``; here the p shards are the leading axis of every tensor
(``[p, cap]`` edges, ``[p, vps]`` labels) in one process, so
``axis_index`` is ``arange(p)``, a ``psum`` a sum over dim 0 and an
all-to-all a transpose.

Per round (``_round_body``):

  MINEDGES   both endpoint labels are looked up from their owners; each
             directed copy ships a ``(comp, w, eid, other)`` candidate to
             the owners of both endpoint components, which scatter-min
             them in the ``(w, eid)`` order over their owned slots
             (``_owner_scatter_min``, through the K1 kernel with
             ``pallas_minedges=True``) and confirm the winners back.
  CONTRACT   pointer doubling over the sharded parent array, one routed
             lookup per step, ``_doubling_iters(n)`` steps; the 2-cycle
             of mutually chosen components keeps the smaller id as root.
  RELABEL    every owned vertex re-resolves its label through one more
             lookup; slots whose endpoints share a component join the
             persistent ``dead`` mask.

The reference's fused ``while_loop`` becomes a host loop that reads the
``go`` flag once per round.  Capacities are flat (``edge_capacity`` =
edges/shard, ``label_capacity`` = vps) and every exchange reports
overflow; results are exact iff it is 0.  The levers of the optimized
engine raise ``NotImplementedError`` naming their ``ROADMAP.md`` item
until they are ported — a lever never quietly runs something else.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.exchange import (ExchangeStats, psum_f32, reply,
                                       routed_exchange)
from repro_torch.core.distributed import (ESENT, CommStats, DistGraph,
                                          _doubling_iters, _weight_pivots)
from repro_torch.core.graph import reference_order_sum
from repro_torch.kernels.segmin.ops import scatter_min_tables

_ESENT = int(ESENT)

_LEVERS_ITEM = ("ROADMAP.md queue 1 item 8 (sharded engine, default "
                "levers)")


def vertices_per_shard(n: int, num_shards: int) -> int:
    return max(1, -(-n // num_shards))


def _bases(p: int, vps: int, device: torch.device) -> torch.Tensor:
    """``[p, 1]`` first vertex id owned by each shard."""
    return (torch.arange(p, dtype=torch.int32, device=device) * vps).view(
        p, 1)


def _gather_rows(table: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``table[s, off[s, ...]]`` per shard; ``off`` in range."""
    p, width = table.shape
    base = torch.arange(p, dtype=torch.int64, device=table.device) * width
    flat = off.reshape(p, -1).long() + base.view(p, 1)
    return table.reshape(-1)[flat.reshape(-1)].view(off.shape)


# --------------------------------------------------------------------------
# sharded building blocks (stacked [p, ...] tensors)
# --------------------------------------------------------------------------

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
    answers = torch.where(ex.recv_ok, _gather_rows(table, off), -1)
    out, st = reply(ex, answers, axis_sizes, schedule, stats=ex.stats)
    if count_misses:
        st = st._replace(misses=st.misses + (ex.stats.items - items0))
    return out, ex.sent_ok, ex.overflow, st


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
    at_min = okc & (wc == _gather_rows(wmin, off))
    is_win = at_min & (ec == _gather_rows(emin, off))
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


def _sharded_contract(has, other, n: int, vps: int, capacity: int,
                      axis_sizes: Sequence[int], schedule: str,
                      stats: ExchangeStats):
    """Pointer doubling over the sharded parent array (request/reply).

    Roots with a chosen edge point at the other endpoint's component,
    everything else at itself; the 2-cycle of mutually chosen components
    keeps the smaller id as root; then the fixed schedule of
    ``_doubling_iters(n)`` doubling steps, one routed lookup each.  Only
    ``parent[x] != x`` rows enter the exchange.

    Returns (parent [p, vps] fully contracted, keep [p, vps] — winner
    and not the larger side of a 2-cycle, overflow, stats).
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
    mutual = gp == vid
    keep = has & (~mutual | (vid < parent0))
    parent = torch.where(mutual & (vid < parent0), vid, parent0)
    for _ in range(_doubling_iters(n)):
        parent, o, stats = hop(parent, stats)
        ov = ov + o
    return parent, keep, ov, stats


def _round_body(u, v, w, eid, live0, lab, mst, dead, n: int, vps: int,
                axis_sizes: Sequence[int], cap_edge: int, cap_label: int,
                cap_lookup: int, cap_contract: int, schedule: str,
                pallas_minedges: bool, stats: ExchangeStats):
    """One MINEDGES → CONTRACT → RELABEL round over 1D-sharded labels,
    endpoints resolved by one routed lookup per slot.

    Returns (lab, mst, dead, go, overflow_delta, stats); ``go`` is a
    0-dim bool tensor (some component chose an edge).
    """
    live = live0 & ~dead
    ru, ok_u, o1, st = _sharded_lookup(lab, u, live, vps, cap_lookup,
                                       axis_sizes, schedule, stats,
                                       count_misses=True)
    rv, ok_v, o2, st = _sharded_lookup(lab, v, live, vps, cap_lookup,
                                       axis_sizes, schedule, st,
                                       count_misses=True)
    looked = ok_u & ok_v
    # dead-edge retirement: same component now => same forever
    dead = dead | (looked & (ru == rv))
    alive = looked & (ru != rv) & live
    wk = torch.where(alive, w, float("inf"))
    has, other, win, o3, st = _sharded_minedges(
        ru, rv, wk, eid, alive, vps, cap_edge, axis_sizes, schedule, st,
        pallas_minedges)
    # both directed copies are confirmed; mark only the canonical one so
    # the global mask is exact-once
    mst = mst | (win & (u < v))
    parent, _, o4, st = _sharded_contract(has, other, n, vps, cap_contract,
                                          axis_sizes, schedule, st)
    lab, _, o5, st = _sharded_lookup(
        parent, lab, torch.ones_like(lab, dtype=torch.bool), vps,
        cap_label, axis_sizes, schedule, st, site="relabel")
    go = has.any()
    return lab, mst, dead, go, o1 + o2 + o3 + o4 + o5, st


def _sharded_rounds(u, v, w, eid, valid, lab, mst, dead, n: int, vps: int,
                    axis_sizes: Sequence[int], active: Optional[torch.Tensor],
                    max_rounds: int, cap_edge: int, cap_label: int,
                    cap_lookup: int, overflow, stats: ExchangeStats, rounds,
                    schedule: str, pallas_minedges: bool):
    """Borůvka rounds with 1D-sharded labels (flat capacities).

    ``active`` optionally restricts the edge set (the filter levels);
    ``dead`` persists across rounds and levels (labels only coarsen).
    Runs until no component chooses an edge or ``max_rounds``.
    """
    live0 = valid if active is None else (valid & active)
    r = 0
    go = True
    while go and r < max_rounds:
        lab, mst, dead, go_t, o, stats = _round_body(
            u, v, w, eid, live0, lab, mst, dead, n, vps, axis_sizes,
            cap_edge, cap_label, cap_lookup, cap_label, schedule,
            pallas_minedges, stats)
        overflow = overflow + o
        r += 1
        go = bool(go_t)
    return lab, mst, dead, overflow, stats, rounds + r


def _sharded_shard_fn(u, v, w, eid, n: int, vps: int,
                      axis_sizes: Sequence[int], algorithm: str,
                      num_levels: int, max_rounds: Optional[int],
                      cap_edge: int, cap_label: int, cap_lookup: int,
                      schedule: str, pallas_minedges: bool):
    """The whole solve over stacked shards (``u/v/w/eid`` are [p, cap]).

    Returns (mask [p, cap], weight, count, lab [p, vps], overflow,
    CommStats) — the reference's per-shard program, all shards at once.
    """
    p = u.shape[0]
    dev = u.device
    valid = torch.isfinite(w)
    lab = _bases(p, vps, dev) + torch.arange(vps, dtype=torch.int32,
                                             device=dev)
    mst = torch.zeros(u.shape, dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    stats = ExchangeStats.zeros(dev)
    rounds = 0
    mr = (math.ceil(math.log2(max(n, 2))) + 1) if max_rounds is None \
        else max_rounds
    dead = u == v  # self-loops can never be MSF candidates

    common = dict(n=n, vps=vps, axis_sizes=axis_sizes, max_rounds=mr,
                  cap_edge=cap_edge, cap_label=cap_label,
                  cap_lookup=cap_lookup, schedule=schedule,
                  pallas_minedges=pallas_minedges)
    if algorithm == "boruvka":
        lab, mst, dead, overflow, stats, rounds = _sharded_rounds(
            u, v, w, eid, valid, lab, mst, dead, active=None,
            overflow=overflow, stats=stats, rounds=rounds, **common)
    elif algorithm == "filter_boruvka":
        pivots = _weight_pivots(w, valid, num_levels)
        lo = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
        for lvl in range(num_levels):
            hi = pivots[lvl] if lvl < num_levels - 1 else torch.tensor(
                float("inf"), dtype=torch.float32, device=dev)
            active = (w > lo) & (w <= hi)
            lab, mst, dead, overflow, stats, rounds = _sharded_rounds(
                u, v, w, eid, valid, lab, mst, dead, active=active,
                overflow=overflow, stats=stats, rounds=rounds, **common)
            lo = hi
    else:
        raise ValueError(algorithm)

    weight = psum_f32(reference_order_sum(torch.where(mst, w, 0.0)))
    count = mst.sum(dtype=torch.int32)
    comm = CommStats(stats.calls, stats.items, stats.bytes,
                     torch.tensor(rounds, dtype=torch.int32, device=dev),
                     stats.hits, stats.misses, stats.pushed, stats.injected)
    return mst, weight, count, lab, overflow, comm


def _unported(lever: str, item: str = _LEVERS_ITEM):
    return NotImplementedError(
        f"{lever} is not ported to repro_torch yet ({item}); the flat "
        "baseline runs with local_preprocessing=False, coalesce=False, "
        "src_only=False, adaptive_doubling=False, shrink_capacities=False, "
        "ghost_cache=False, relabel_skip=False")


def distributed_sharded_msf(graph: DistGraph, n: int, num_shards: int, *,
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
                            plan=None,
                            replan: bool = True,
                            ghost_shard_limit: Optional[int] = None,
                            ckpt_every: Optional[int] = None,
                            ckpt_out: Optional[List] = None,
                            resume_from=None):
    """Run the sharded-label distributed MSF over ``num_shards`` stacked
    shards on the graph's device.

    The reference's signature and defaults, with ``num_shards`` where the
    reference takes a mesh.  Returns (mask, weight, count, labels,
    overflow, stats):

      * ``mask`` [p * cap] bool is aligned with ``graph`` slots, the
        canonical (u < v) directed copy of each MSF edge marked;
      * ``labels`` [p * vps] int32 is the sharded label vector laid out
        shard-major (slice [:n] for the per-vertex view);
      * ``overflow`` counts exchange items that exceeded capacity over
        all rounds — results are exact iff it is 0 (guaranteed with the
        default capacities);
      * ``stats`` is a ``CommStats``.

    Ported so far: the flat baseline, i.e. ``local_preprocessing``,
    ``coalesce``, ``src_only``, ``adaptive_doubling``,
    ``shrink_capacities``, ``ghost_cache`` and ``relabel_skip`` all
    False, with ``pallas_minedges`` either way (True routes the
    owner-side MINEDGES through the K1 CUDA kernel).  Each unported lever
    raises ``NotImplementedError``, as do ``plan`` and the checkpoint
    arguments.  ``vsorted_index``, ``ghost_push``, ``push_capacity`` and
    ``ghost_shard_limit`` only act with the coalescing or ghost levers
    and are ignored without them, as in the reference; ``round_trace``
    stays empty on the flat engine, as in the reference's.
    """
    levers = dict(local_preprocessing=local_preprocessing,
                  coalesce=coalesce, src_only=src_only,
                  adaptive_doubling=adaptive_doubling,
                  shrink_capacities=shrink_capacities,
                  ghost_cache=ghost_cache, relabel_skip=relabel_skip)
    for lever, on in levers.items():
        if on:
            raise _unported(f"{lever}=True")
    if plan is not None:
        raise _unported("plan replay",
                        "ROADMAP.md queue 1 item 9 (plans and planned "
                        "replay)")
    if (ckpt_every is not None or ckpt_out is not None
            or resume_from is not None):
        raise _unported("checkpointing",
                        "ROADMAP.md queue 1 item 10 (checkpoints)")
    p = int(num_shards)
    vps = vertices_per_shard(n, p)
    cap = graph.cap_total // p
    # is-None (not falsy) checks: an explicit 0 must be honored — it
    # yields all-overflow results, which the overflow count reports
    ce = int(cap if edge_capacity is None else edge_capacity)
    cl = int(vps if label_capacity is None else label_capacity)
    lk = ce if lookup_capacity is None else int(lookup_capacity)

    def shards(x):
        return x.view(p, cap)

    mask, weight, count, lab, overflow, comm = _sharded_shard_fn(
        shards(graph.u), shards(graph.v), shards(graph.w),
        shards(graph.eid), n, vps, (p,), algorithm, num_levels,
        max_rounds, ce, cl, lk, schedule, pallas_minedges)
    return (mask.reshape(-1), weight, count, lab.reshape(-1), overflow,
            comm)
