"""The plain reference: the minimum spanning forest in the (w, eid) order.

A straightforward Borůvka in plain PyTorch, written for the benchmark
and independent of the program: it imports nothing of ``repro_torch``
(nor ``repro`` or JAX) and takes only the ``u, v, w`` arrays the
benchmark hands to the program.

The order is the one every engine of the program guarantees: weights
first, ties broken by the edge's index.  A stable sort of the weights
turns that order into a unique rank per edge, so each component's
lightest incident edge is a plain integer minimum.  Edges with a
non-finite weight and self-loops take no part.  Each round every
component picks its least-ranked outgoing edge, the picks form a forest
of stars after the mutual pairs are rooted at their smaller label, and
pointer jumping collapses it.

``weight_dtype`` computes the same forest on weights rounded to a lower
precision (the benchmark's control, ``torch.bfloat16``): ties then fall
to the index where the float32 weights differ, and the forest's weight
is summed in that precision.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_NONE = torch.iinfo(torch.int64).max


def msf(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int,
        weight_dtype: Optional[torch.dtype] = None
        ) -> Tuple[torch.Tensor, float]:
    """(mask over the m edges, forest weight) of the unique MSF.

    The weight is the float64 sum of the chosen edges' weights, or their
    sum in ``weight_dtype`` where one is given.
    """
    dev = w.device
    m = int(w.shape[0])
    wk = w if weight_dtype is None else w.to(weight_dtype)
    u64, v64 = u.long(), v.long()
    take = torch.isfinite(wk) & (u64 != v64)
    rank = torch.empty(m, dtype=torch.int64, device=dev)
    rank[torch.sort(wk.float(), stable=True).indices] = torch.arange(
        m, dtype=torch.int64, device=dev)
    mask = torch.zeros(m, dtype=torch.bool, device=dev)
    label = torch.arange(n, dtype=torch.int64, device=dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    eidx = torch.nonzero(take).flatten()
    eu, ev, er = u64[eidx], v64[eidx], rank[eidx]
    while eidx.numel():
        cu, cv = label[eu], label[ev]
        cross = cu != cv
        eidx, eu, ev, er = eidx[cross], eu[cross], ev[cross], er[cross]
        cu, cv = cu[cross], cv[cross]
        if not eidx.numel():
            break
        best = torch.full((n,), _NONE, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, cu, er, "amin")
        best.scatter_reduce_(0, cv, er, "amin")
        win_u = er == best[cu]  # the edge is cu's lightest
        win_v = er == best[cv]
        mask[eidx[win_u | win_v]] = True
        parent = ids.clone()
        parent[cu[win_u]] = cv[win_u]
        parent[cv[win_v]] = cu[win_v]
        mutual = (parent[parent] == ids) & (ids < parent)
        parent = torch.where(mutual, ids, parent)
        while True:
            hop = parent[parent]
            if torch.equal(hop, parent):
                break
            parent = hop
        label = parent[label]
    if weight_dtype is None:
        weight = float(w[mask].double().sum())
    else:
        weight = float(wk[mask].sum())
    return mask, weight
