"""Public MSF API.

Port of ``repro/core/mst.py``.  ``minimum_spanning_forest`` dispatches
on ``engine``:

  * ``"static"`` — single-device Borůvka (``core/boruvka.py``) or
    Filter-Borůvka with fixed weight buckets (``core/filter_boruvka.py``);
  * ``"dynamic"`` — the host-orchestrated recursion with compaction and
    a Borůvka base case on the edges' device (``core/filter_boruvka.py``;
    ``**kw`` goes to ``filter_boruvka_dynamic``);
  * ``"distributed"`` — the replicated-label engine over ``num_shards``
    stacked shards (``core/distributed.py: distributed_msf``): every
    shard sees the dense ``[n]`` label vector, and ``algorithm`` may
    also be ``boruvka_shrink`` or ``boruvka_shrink_srconly``;
  * ``"distributed_sharded"`` — the sharded-label engine over
    ``num_shards`` stacked shards (``core/distributed_sharded.py``; the
    reference takes a mesh here): an int ``p``, or an ``(R, C)`` pair
    for the reference's two-axis mesh.  With no engine knobs it runs
    the reference's defaults, the ghost-vertex label cache included;
    knobs pass through ``**kw``, ``plan=`` (a ``RoundPlan`` measured by
    ``plan_sharded_msf`` on the layout this dispatch builds) and
    ``replan=`` included, so a plan replays from here too.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boruvka import boruvka_msf
from repro_torch.core.distributed import build_dist_graph, distributed_msf
from repro_torch.core.distributed_sharded import (distributed_sharded_msf,
                                                  shard_layout)
from repro_torch.core.filter_boruvka import (boruvka_dynamic,
                                             filter_boruvka_dynamic,
                                             filter_boruvka_msf)
from repro_torch.core.graph import EdgeList, forest_weight


def _distributed_dispatch(edges: EdgeList, num_shards, engine: str,
                          algorithm: str,
                          **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bridge the single-array public API onto the distributed engines.

    On the edges' device: drop the non-finite weights, then double +
    sort + 1D-partition the rest (``build_dist_graph``, the engines'
    input format); run; then reduce the slot mask back to the caller's
    edge positions via the undirected edge ids on the host.  ``kw``
    reaches the engine whole, a sharded ``plan`` with it: the layout
    built here is ``build_dist_graph`` of the finite edges, the shape a
    plan must have been measured at.  Repeated solves of one graph
    should build a ``DistGraph`` once and call the engine (or
    ``execute_plan``) directly.
    """
    dev = edges.u.device
    idx = torch.isfinite(edges.w).nonzero().squeeze(1)
    g, _ = build_dist_graph(edges.u[idx], edges.v[idx], edges.w[idx],
                            edges.n, math.prod(shard_layout(num_shards)),
                            device=dev)
    run = (distributed_msf if engine == "distributed"
           else distributed_sharded_msf)
    res = run(g, edges.n, num_shards, algorithm=algorithm, **kw)
    # res: (mask, weight, count, labels, stats) for distributed, plus an
    # overflow count at [4] (stats moves to [5]) for distributed_sharded
    if engine == "distributed_sharded":
        overflow = int(res[4])
        if overflow:  # hard error, not assert: must survive python -O
            raise RuntimeError(
                f"exchange overflow ({overflow} items): retry with larger "
                "edge_capacity/label_capacity")
    mask_slots = res[0].cpu().numpy()
    sel = np.unique(g.eid.cpu().numpy()[mask_slots])
    out = np.zeros(edges.m, bool)
    out[idx.cpu().numpy()[sel]] = True
    return torch.from_numpy(out).to(dev), res[1]


def minimum_spanning_forest(edges: EdgeList, *, algorithm: str = "boruvka",
                            engine: str = "static",
                            num_buckets: Optional[int] = None,
                            num_shards=None,
                            **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute an MSF on the edges' device. Returns (mask over edges,
    total weight).

    ``num_buckets`` controls filter_boruvka's weight bucketing; each
    engine keeps its own default when it is not given (static: 8, the
    sharded engine's ``num_levels``: 4).  ``num_shards`` is the shard
    layout of the distributed engines: a count, or an ``(R, C)`` pair.
    """
    if num_buckets is not None and num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    if engine in ("distributed", "distributed_sharded"):
        if num_shards is None:  # hard error, not assert
            raise ValueError(f"{engine} engine needs num_shards")
        if num_buckets is not None:
            # the distributed engines call their filter knob num_levels
            kw.setdefault("num_levels", num_buckets)
        return _distributed_dispatch(edges, num_shards, engine, algorithm,
                                     **kw)
    if engine == "static":
        if algorithm == "boruvka":
            mask, _ = boruvka_msf(edges.u, edges.v, edges.w, edges.n)
        elif algorithm == "filter_boruvka":
            mask, _ = filter_boruvka_msf(
                edges.u, edges.v, edges.w, edges.n,
                num_buckets=8 if num_buckets is None else num_buckets)
        else:
            raise ValueError(algorithm)
        return mask, forest_weight(edges, mask)
    if engine == "dynamic":
        dev = edges.u.device
        u = edges.u.cpu().numpy()
        v = edges.v.cpu().numpy()
        w = edges.w.cpu().numpy()
        if algorithm == "boruvka":
            mask, wt = boruvka_dynamic(u, v, w, edges.n, device=dev)
        elif algorithm == "filter_boruvka":
            mask, wt = filter_boruvka_dynamic(u, v, w, edges.n, device=dev,
                                              **kw)
        else:
            raise ValueError(algorithm)
        return (torch.from_numpy(mask).to(dev),
                torch.tensor(wt, dtype=torch.float32, device=dev))
    raise ValueError(engine)
