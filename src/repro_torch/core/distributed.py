"""Shared pieces of the distributed engines: the sharded graph layout,
the comm counters and the filter levels' pivot selection.

Port of the parts of ``repro/core/distributed.py`` the sharded engine
uses.  Graph representation (paper Section II-B): both directions of
every undirected edge, lexicographically sorted, 1D-partitioned into
equal padded shards; every directed copy carries the undirected edge id
``eid`` so that tie-breaking uses the direction-independent total order
``(w, eid)``.  ``shrink_schedule``/``quantize_capacity`` are the
capacity ladder of the sharded engine's shrinking driver.  The
replicated-label engine (``distributed_msf``) is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import INVALID_W, CapacityError
from repro_torch.device import DeviceLike, resolve_device

# "no chosen edge" sentinel in eid space, shared by every engine so the
# (w, eid) total orders can never diverge
ESENT = np.int32(2 ** 30)


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


def build_dist_graph(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int,
                     num_shards: int, cap: Optional[int] = None,
                     device: DeviceLike = None) -> Tuple[DistGraph, int]:
    """Host-side: canonical undirected edges -> doubled, sorted, padded.

    Returns (graph, cap) with the reference's exact slot layout.  ``eid``
    is the index into the *undirected* input arrays, so a result mask
    over slots reduces back to the input edges via eid.  ``cap`` pins the
    per-shard slot count (>= ``ceil(2m/p)``, else ``CapacityError``).
    """
    m = len(u)
    eid = np.arange(m, dtype=np.int32)
    du = np.concatenate([u, v]).astype(np.int64)
    dv = np.concatenate([v, u]).astype(np.int64)
    dw = np.concatenate([w, w]).astype(np.float32)
    de = np.concatenate([eid, eid])
    order = np.lexsort((dw, dv, du))
    du, dv, dw, de = du[order], dv[order], dw[order], de[order]
    dm = len(du)
    need = max(1, -(-dm // num_shards))
    if cap is None:
        cap = need
    elif cap < need:
        raise CapacityError(
            f"cap={cap} cannot hold ceil(2m/p)={need} edge slots per "
            f"shard (m={m}, p={num_shards}; "
            f"{dm - cap * num_shards} directed copies would be silently "
            "dropped)", dropped=dm - cap * num_shards)
    uu = np.zeros(num_shards * cap, np.int32)
    vv = np.zeros(num_shards * cap, np.int32)
    ww = np.full(num_shards * cap, INVALID_W, np.float32)
    ee = np.zeros(num_shards * cap, np.int32)
    for s in range(num_shards):
        lo, hi = s * cap, min((s + 1) * cap, dm)
        if hi > lo:
            k = hi - lo
            uu[s * cap: s * cap + k] = du[lo:hi]
            vv[s * cap: s * cap + k] = dv[lo:hi]
            ww[s * cap: s * cap + k] = dw[lo:hi]
            ee[s * cap: s * cap + k] = de[lo:hi]
    return DistGraph.from_numpy(uu, vv, ww, ee, device=device), cap


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
