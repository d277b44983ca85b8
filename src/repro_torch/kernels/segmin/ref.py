"""Plain PyTorch versions of the MINEDGES kernels (K1, K3) and phase 2.

Port of ``repro/kernels/segmin/ref.py``.  The reference's oracles are
sequential scans, one element at a time; here each function is a few
vectorised ``scatter_reduce_`` passes:

* ``owner_scatter_min_ref`` (K1) — (1) min ``w`` per slot, (2) min
  ``eid`` among the candidates at that minimum, (3)/(4) max of each
  payload among the exact ``(w, eid)`` winners;
* ``segmin_candidates_ref`` (K3) — run ids from a ``cumsum`` of the run
  heads, then min ``w`` and min ``eid`` among the ties per run, emitted
  at each run's last element;
* ``dense_min_from_candidates`` — phase 2, plain tensor code on every
  device, as the reference leaves it to ``jnp``.

The K1 and K3 versions are what the wrappers in ``segmin.py`` run for
CPU tensors and what the CUDA kernels are held against on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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


def segmin_candidates_ref(seg: torch.Tensor, w: torch.Tensor,
                          eid: torch.Tensor, alive: torch.Tensor,
                          block: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element run-end candidates of the segmented ``(w, eid)``-min.

    ``seg``/``eid`` int32, ``w`` float (bf16 is widened to f32),
    ``alive`` bool, all ``[M]``.  A run is a contiguous stretch of equal
    ``seg``; with an integer ``block`` runs also break at every multiple
    of ``block`` (what the K3 kernel computes, one block per CTA), with
    ``block=None`` they are array-wide (the reference's oracle).  Entry
    ``i`` is the run's ``(min w, min eid among the w-ties)`` where ``i``
    ends its run, ``(inf, EID_SENTINEL)`` elsewhere; dead lanes count as
    ``(inf, EID_SENTINEL)``.  An alive lane with ``w = +inf`` still
    competes on ``eid``.  Returns ``(cand_w f32 [M], cand_eid i32 [M])``.
    """
    m = seg.shape[0]
    dev = seg.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    wk = torch.where(alive, w.to(torch.float32), inf)
    ek = torch.where(alive, eid, EID_SENTINEL)
    if m == 0:
        return wk, ek
    new = torch.ones(m, dtype=torch.bool, device=dev)
    new[1:] = seg[1:] != seg[:-1]
    if block is not None:
        new[::block] = True
    last = torch.ones(m, dtype=torch.bool, device=dev)
    last[:-1] = new[1:]
    rid = torch.cumsum(new, 0) - 1  # at most m runs: no host sync
    rw = torch.full((m,), float("inf"), dtype=torch.float32, device=dev)
    rw.scatter_reduce_(0, rid, wk, "amin")
    at_min = wk == rw[rid]
    re = torch.full((m,), EID_SENTINEL, dtype=torch.int32, device=dev)
    re.scatter_reduce_(0, rid, torch.where(at_min, ek, EID_SENTINEL), "amin")
    return (torch.where(last, rw[rid], inf),
            torch.where(last, re[rid], EID_SENTINEL))


def dense_min_from_candidates(seg: torch.Tensor, cand_w: torch.Tensor,
                              cand_eid: torch.Tensor, n: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: scatter the (few) run-end candidates into dense ``[n]``.

    Returns ``(wmin f32 [n], emin i32 [n])``: per ``seg`` value the min
    finite candidate weight and the min ``eid`` among the candidates at
    it; ``(inf, EID_SENTINEL)`` where there is none.  Only the finite
    candidates with ``0 <= seg < n`` take part (the reference also wraps
    a negative ``seg``; no caller passes one).
    """
    dev = seg.device
    wmin = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    emin = torch.full((n,), EID_SENTINEL, dtype=torch.int32, device=dev)
    lanes = (torch.isfinite(cand_w) & (seg >= 0) & (seg < n)).nonzero()
    lanes = lanes.squeeze(1)
    s = seg[lanes].long()
    cw = cand_w[lanes]
    wmin.scatter_reduce_(0, s, cw, "amin")
    hit = cw == wmin[s]
    emin.scatter_reduce_(0, s, torch.where(hit, cand_eid[lanes],
                                           EID_SENTINEL), "amin")
    return wmin, emin
