"""Distributed sample sort (AMS-sort analog, Section II-A / VI-C).

Port of ``repro/comm/sorting.py`` over stacked shards: keys are
``[p, L]`` (shard s is row s) and the steps are the reference's

  1. local sort,
  2. regular oversampling -> all-gather -> global splitters (the
     all-gather of the ``[p, s]`` samples is a reshape, shard-major),
  3. one capacity-bounded bucket exchange (``comm/exchange.py:
     routed_exchange``, the two-hop grid schedule over an ``(R, C)``
     layout by default),
  4. local merge of the received runs.

Static shapes: the bucket exchange has ``ceil(L * capacity_factor / p)``
slots per destination; overflow is counted and returned, never silently
dropped, so a caller can retry with a larger factor.  Keys are single
float32 values; a multi-key order is a stable local sort of secondary
keys before or after the pass, since distribution only decides which
shard a key lands on.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from repro_torch.comm.exchange import _leaves, routed_exchange


class SortResult(NamedTuple):
    key: torch.Tensor       # [p, p * cap] locally sorted keys (+inf padded)
    payload: object         # like the input payload, [p, p * cap, ...]
    ok: torch.Tensor        # [p, p * cap] bool validity
    overflow: torch.Tensor  # [] int32, over all shards


def _rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x[s, order[s]]`` per shard, for ``[p, L, ...]`` leaves."""
    idx = order.view(order.shape + (1,) * (x.dim() - 2)).expand(
        order.shape + tuple(x.shape[2:]))
    return x.gather(1, idx)


def sample_sort(key: torch.Tensor, payload, valid: torch.Tensor,
                axis_sizes: Sequence[int], *, oversample: int = 32,
                capacity_factor: float = 2.0,
                schedule: str = "grid") -> SortResult:
    """Globally sort ``(key, payload)`` across the stacked shards.

    ``key`` and ``valid`` are ``[p, L]``; ``payload`` a ``[p, L, ...]``
    tensor or a tuple of them; ``axis_sizes`` the shard layout (``(p,)``
    or ``(R, C)``).  Shard s receives the keys between splitters s - 1
    and s, sorted, with its valid entries first.
    """
    sizes = tuple(int(a) for a in axis_sizes)
    p = math.prod(sizes)
    L = key.shape[1]
    dev = key.device
    kf = torch.where(valid, key, float("inf")).to(torch.float32)
    ks, order = torch.sort(kf, dim=1, stable=True)
    leaves = _leaves(payload)
    ps = tuple(_rows(x, order) for x in leaves)
    vs = valid.gather(1, order)

    # regular sampling from each shard's sorted valid prefix
    s = min(oversample, L)
    nvalid = vs.sum(1, dtype=torch.int64).clamp(min=1).view(p, 1)
    samp_idx = (torch.arange(s, device=dev).view(1, s) * nvalid) // s
    samples = ks.gather(1, samp_idx)
    sorted_samples = torch.sort(samples.reshape(-1)).values  # [p * s]
    spl_idx = (torch.arange(1, p, device=dev) * (p * s)) // p
    splitters = sorted_samples[spl_idx].contiguous()  # [p - 1]

    dest = torch.searchsorted(splitters, ks, right=True).to(torch.int32)
    dest = torch.where(vs, dest, -1)
    capacity = max(1, int(-(-L * capacity_factor // p)))
    ex = routed_exchange((ks,) + ps, dest, vs, capacity, sizes, schedule)
    rok = ex.recv_ok.reshape(p, p * capacity)
    rk = torch.where(rok, ex.recv[0].reshape(p, p * capacity),
                     float("inf"))
    rk, rorder = torch.sort(rk, dim=1, stable=True)
    rp = tuple(_rows(r.reshape((p, p * capacity) + tuple(r.shape[3:])),
                     rorder) for r in ex.recv[1:])
    if not isinstance(payload, (tuple, list)):
        rp = rp[0]
    return SortResult(rk, rp, rok.gather(1, rorder), ex.overflow)


def splitters_from_sorted(ks: torch.Tensor, p: int, s: int) -> torch.Tensor:
    """The splitters of ``p`` buckets from each shard's ``s`` regular
    samples of its sorted keys ``ks`` (``[p, L]``), for redistribution
    by rank.  Returns ``[p - 1]``."""
    if ks.shape[0] != p:
        raise ValueError(f"splitters_from_sorted: keys {tuple(ks.shape)} "
                         f"do not match {p} shards")
    L = ks.shape[1]
    k = min(s, L)
    samp_idx = (torch.arange(k, device=ks.device) * L) // k
    sorted_samples = torch.sort(ks[:, samp_idx].reshape(-1)).values
    spl_idx = (torch.arange(1, p, device=ks.device)
               * sorted_samples.shape[0]) // p
    return sorted_samples[spl_idx]
