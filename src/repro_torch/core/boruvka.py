"""Borůvka MSF with dense component labels (single device).

Port of ``repro/core/boruvka.py``: the same MINEDGES → CONTRACT →
RELABEL round on a dense vertex→component label vector, with pointer
doubling as ``labels = labels[labels]``.  The reference's
``.at[].min``/``.at[].max`` scatters become ``scatter_reduce_``
(``amin``/``amax``); its ``while_loop`` becomes a host loop that reads
the ``changed`` flag once per round.

Tie-breaking: the effective weight order is lexicographic ``(w, idx)``,
a total order, so the chosen edge set is cycle-free and the MSF unique
— the order of ``core/oracle.py``.

Spans (``repro_torch.tracing``, off by default): ``static.solve``
around ``boruvka_msf``; per round ``static.round`` (and the counter
``static.rounds``), inside it ``static.minedges`` (timed on the card
too), ``static.contract``, ``static.relabel`` and ``static.sync``, the
host's read of ``changed``.  The dynamic engine's base case runs the
same rounds, so it records them too.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import tracing


def _doubling_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def min_edge_per_component(ru: torch.Tensor, rv: torch.Tensor,
                           w: torch.Tensor, n: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented min-edge reduction (the paper's MINEDGES).

    Args: component labels of both endpoints and weights, for m edges.
    Returns (wmin[n], emin[n]): per-component min incident weight and the
    index of the lexicographically-(w, idx)-smallest achieving edge.
    ``emin == m`` (sentinel) where a component has no alive incident edge.
    """
    m = w.shape[0]
    dev = w.device
    inf = torch.tensor(float("inf"), dtype=w.dtype, device=dev)
    alive = ru != rv
    wk = torch.where(alive & torch.isfinite(w), w, inf)
    ru64, rv64 = ru.long(), rv.long()
    wmin = torch.full((n,), float("inf"), dtype=w.dtype, device=dev)
    wmin.scatter_reduce_(0, ru64, wk, "amin")
    wmin.scatter_reduce_(0, rv64, wk, "amin")
    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    sent = torch.tensor(m, dtype=torch.int32, device=dev)
    fin = torch.isfinite(wk)
    cand_u = torch.where(fin & (wk == wmin[ru]), eidx, sent)
    cand_v = torch.where(fin & (wk == wmin[rv]), eidx, sent)
    emin = torch.full((n,), m, dtype=torch.int32, device=dev)
    emin.scatter_reduce_(0, ru64, cand_u, "amin")
    emin.scatter_reduce_(0, rv64, cand_v, "amin")
    return wmin, emin


def contract_components(emin: torch.Tensor, u: torch.Tensor,
                        v: torch.Tensor, labels: torch.Tensor, n: int,
                        root_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pseudo-tree -> rooted-star contraction by pointer doubling.

    Returns (roots[n], has[n]): the new representative of every current
    component label, and whether the component chose an edge this round.
    ``root_mask`` forces components to stay roots.
    """
    m = u.shape[0]
    has = emin < m
    ce = emin.clamp(0, m - 1)
    cids = torch.arange(n, dtype=torch.int32, device=emin.device)
    cu = labels[u[ce]]
    cv = labels[v[ce]]
    other = cu + cv - cids  # the endpoint-component that is not `cids`
    parent = torch.where(has, other, cids)
    if root_mask is not None:
        parent = torch.where(root_mask, cids, parent)
    # Break 2-cycles: the smaller label of the pair becomes the root.
    gp = parent[parent]
    parent = torch.where((gp == cids) & (cids < parent), cids, parent)
    # Pointer doubling (Section IV-B / Chung & Condon).
    for _ in range(_doubling_iters(n)):
        parent = parent[parent]
    return parent, has


def boruvka_round(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  labels: torch.Tensor, mst: torch.Tensor, n: int,
                  root_mask: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Borůvka round on dense labels. Returns (labels', mst', changed)."""
    m = u.shape[0]
    with tracing.span("static.minedges", u.device):
        ru = labels[u]
        rv = labels[v]
        _, emin = min_edge_per_component(ru, rv, w, n)
    with tracing.span("static.contract"):
        roots, has = contract_components(emin, u, v, labels, n, root_mask)
    with tracing.span("static.relabel"):
        ce = emin.clamp(0, m - 1)
        mst_i = mst.to(torch.int32).scatter_reduce(
            0, ce.long(), has.to(torch.int32), "amax")
        labels = roots[labels]
    return labels, mst_i.bool(), has.any()


def rounds_until_stable(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor, mst: torch.Tensor, n: int,
                        max_rounds: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Borůvka rounds until no component changes or ``max_rounds`` (the
    reference's ``while_loop``). Returns (labels', mst')."""
    changed = True
    rounds = 0
    while changed and rounds < max_rounds:
        with tracing.span("static.round"):
            labels, mst, ch = boruvka_round(u, v, w, labels, mst, n)
            with tracing.span("static.sync"):
                changed = bool(ch)
        tracing.count("static.rounds")
        rounds += 1
    return labels, mst


def boruvka_msf(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int,
                max_rounds: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Borůvka on the inputs' device. Returns (mst_mask[m] bool,
    labels[n] int32).

    An empty edge list returns an empty mask and the identity labels
    (the reference raises there; the Kruskal oracle is the contract).
    """
    with tracing.span("static.solve"):
        m = u.shape[0]
        dev = u.device
        labels = torch.arange(n, dtype=torch.int32, device=dev)
        mst = torch.zeros((m,), dtype=torch.bool, device=dev)
        if m == 0:
            return mst, labels
        if max_rounds is None:
            # each round at least halves #non-isolated components; a run
            # over k edges touches <= 2k components.
            max_rounds = max(1, math.ceil(math.log2(max(min(n, 2 * m), 2)))
                             + 1)
        labels, mst = rounds_until_stable(u, v, w, labels, mst, n,
                                          max_rounds)
        return mst, labels
