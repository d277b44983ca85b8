"""Plain PyTorch version of the fused MINEDGES scatter-min (K1).

Port of ``repro/kernels/segmin/ref.py: owner_scatter_min_ref``.  The
reference is a sequential scan, one candidate at a time; here the same
function is four vectorised ``scatter_reduce_`` passes over the lanes
that take part — (1) min ``w`` per slot, (2) min ``eid`` among the
candidates at that minimum, (3)/(4) max of each payload among the exact
``(w, eid)`` winners.  It is what ``segmin.owner_scatter_min`` runs for
CPU tensors and what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

EID_SENTINEL = 2 ** 30

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def default_tables(lead: Tuple[int, ...], size: int,
                   device: torch.device) -> Tables:
    """Tables with no candidate: ``(inf, EID_SENTINEL, -1, -1)``."""
    shape = tuple(lead) + (size,)
    return (torch.full(shape, float("inf"), dtype=torch.float32,
                       device=device),
            torch.full(shape, EID_SENTINEL, dtype=torch.int32, device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device),
            torch.full(shape, -1, dtype=torch.int32, device=device))


def owner_scatter_min_ref(idx: torch.Tensor, w: torch.Tensor,
                          eid: torch.Tensor, pay1: torch.Tensor,
                          pay2: torch.Tensor, ok: torch.Tensor,
                          size: int) -> Tables:
    """(w, eid)-lexicographic scatter-min into ``size`` slots per row.

    Candidates are ``[..., L]`` (leading dims are independent rows, e.g.
    stacked shards); the tables come back ``[..., size]`` as
    ``(wmin f32, emin i32, pay1 i32, pay2 i32)`` with defaults
    ``(inf, EID_SENTINEL, -1, -1)``.  Only ``ok`` lanes with
    ``0 <= idx < size`` contribute; any other lane is dropped, as the
    reference's Pallas kernel drops it.  An ``ok`` lane with ``w = +inf``
    still competes on ``eid``.  The payloads are the max over the exact
    ``(w, eid)`` winners.  ``-0.0`` and ``+0.0`` tie, as in the
    reference's compare; NaN weights in ``ok`` lanes are outside the
    contract.
    """
    lead = tuple(idx.shape[:-1])
    L = idx.shape[-1]
    dev = idx.device
    if L == 0 or size == 0:
        return default_tables(lead, size, dev)
    rows = math.prod(lead)
    idx2 = idx.reshape(rows, L).long()
    keep = (ok.reshape(rows, L) & (idx2 >= 0) & (idx2 < size)).reshape(-1)
    lanes = keep.nonzero().squeeze(1)
    row = torch.arange(rows, device=dev, dtype=torch.int64).view(rows, 1)
    off = (idx2 + row * size).reshape(-1)[lanes]
    wf = w.reshape(-1)[lanes].to(torch.float32)
    ef = eid.reshape(-1)[lanes]
    tot = rows * size
    wmin = torch.full((tot,), float("inf"), dtype=torch.float32, device=dev)
    wmin.scatter_reduce_(0, off, wf, "amin")
    at_min = wf == wmin[off]
    emin = torch.full((tot,), EID_SENTINEL, dtype=torch.int32, device=dev)
    emin.scatter_reduce_(0, off, torch.where(at_min, ef, EID_SENTINEL),
                         "amin")
    win = at_min & (ef == emin[off])
    p1 = torch.full((tot,), -1, dtype=torch.int32, device=dev)
    p1.scatter_reduce_(0, off, torch.where(win, pay1.reshape(-1)[lanes], -1),
                       "amax")
    p2 = torch.full((tot,), -1, dtype=torch.int32, device=dev)
    p2.scatter_reduce_(0, off, torch.where(win, pay2.reshape(-1)[lanes], -1),
                       "amax")
    shape = lead + (size,)
    return (wmin.view(shape), emin.view(shape), p1.view(shape),
            p2.view(shape))
