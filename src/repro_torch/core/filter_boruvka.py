"""Filter-Borůvka (Section V of the paper), two engines.

Port of ``repro/core/filter_boruvka.py``.

Static engine (``filter_boruvka_msf``): sort the edges once by
``(w, idx)``; equal-size ascending weight buckets then make the
recursion a fixed schedule.  Bucket b runs Borůvka rounds from the
labels that buckets < b built — Filter-Kruskal's light-then-filtered-
heavy order — and an edge inside an existing component is a self-loop,
dead for the min-reduction.  The reference's per-bucket ``while_loop``
is a host loop on the ``changed`` flag, capped by ``_bucket_rounds``.

Dynamic engine (``filter_boruvka_dynamic``): the host recursion with
median-of-sample pivots and true edge compaction after filtering, on
numpy arrays, with a Borůvka base case on the device over
power-of-two-padded slices.  Its random draws are numpy's, in the
reference's order, so both pick the same pivots.

Both give the unique MSF under the ``(w, edge-id)`` total order.

Spans (``repro_torch.tracing``): the static engine records
``static.solve`` around its body and ``static.sort`` around the sort,
the bucket arrays and the mask scattered back; its rounds record
``core/boruvka.py``'s.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import oracle
from repro_torch.core.boruvka import rounds_until_stable
from repro_torch.device import DeviceLike, resolve_device


# --------------------------------------------------------------------------
# Static engine
# --------------------------------------------------------------------------

def _bucket_rounds(bucket: int, n: int) -> int:
    return max(1, math.ceil(math.log2(max(min(2 * bucket, n), 2))) + 1)


def filter_boruvka_msf(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                       n: int, num_buckets: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter-Borůvka on the inputs' device. Returns (mst_mask[m] bool,
    labels[n] int32).

    An empty edge list returns an empty mask and the identity labels
    (the reference raises there; the Kruskal oracle is the contract).
    """
    with tracing.span("static.solve"):
        m = u.shape[0]
        dev = u.device
        labels = torch.arange(n, dtype=torch.int32, device=dev)
        if m == 0:
            return torch.zeros((0,), dtype=torch.bool, device=dev), labels
        num_buckets = max(1, min(num_buckets, m))
        bucket = -(-m // num_buckets)
        pad = bucket * num_buckets - m
        with tracing.span("static.sort"):
            # ties, -0.0 with +0.0 too, broken by index: (w, idx), as the
            # reference's stable sort
            order = torch.argsort(w, stable=True)
            us = torch.cat([u[order], torch.zeros(pad, dtype=u.dtype,
                                                  device=dev)])
            vs = torch.cat([v[order], torch.zeros(pad, dtype=v.dtype,
                                                  device=dev)])
            ws = torch.cat([w[order], torch.full((pad,), float("inf"),
                                                 dtype=w.dtype, device=dev)])
            mask_sorted = torch.zeros(num_buckets * bucket, dtype=torch.bool,
                                      device=dev)
        rounds = _bucket_rounds(bucket, n)
        for b in range(num_buckets):  # static schedule of quantile buckets
            sl = slice(b * bucket, (b + 1) * bucket)
            labels, mask_sorted[sl] = rounds_until_stable(
                us[sl], vs[sl], ws[sl], labels, mask_sorted[sl], n, rounds)
        with tracing.span("static.sort"):
            mask = torch.zeros(m, dtype=torch.bool, device=dev)
            mask[order] = mask_sorted[:m]
        return mask, labels


# --------------------------------------------------------------------------
# Dynamic engine (paper-faithful recursion with compaction)
# --------------------------------------------------------------------------

def _pad_pow2(x: np.ndarray, fill) -> np.ndarray:
    m = len(x)
    cap = 1 << max(4, math.ceil(math.log2(max(m, 1))))
    out = np.full(cap, fill, x.dtype)
    out[:m] = x
    return out


def _base_case(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               labels: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Borůvka to completion starting from the running global labels.
    Returns (mst_mask[m], labels[n])."""
    m = u.shape[0]
    max_rounds = max(1, math.ceil(math.log2(max(min(2 * m, n), 2))) + 1)
    mst = torch.zeros(m, dtype=torch.bool, device=u.device)
    labels, mst = rounds_until_stable(u, v, w, labels, mst, n, max_rounds)
    return mst, labels


def _padded_base_case(eu: np.ndarray, ev: np.ndarray, ew: np.ndarray,
                      labels: np.ndarray, n: int, dev: torch.device
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``_base_case`` on power-of-two-padded host slices; returns the
    MST mask over the unpadded slice and the new labels, on the host."""
    pu = _pad_pow2(eu.astype(np.int32), 0)
    pv = _pad_pow2(ev.astype(np.int32), 0)
    pw = _pad_pow2(ew.astype(np.float32), np.inf)
    sub, lab = _base_case(*(torch.from_numpy(x).to(dev)
                            for x in (pu, pv, pw, labels)), n)
    return sub.cpu().numpy()[:len(eu)], lab.cpu().numpy()


def filter_boruvka_dynamic(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                           n: int, *, sparse_avg_degree: float = 4.0,
                           min_edges: int = 1024,
                           sample_size: int = 512,
                           seed: int = 0,
                           device: DeviceLike = None,
                           ) -> Tuple[np.ndarray, float]:
    """Host-driven Filter-Borůvka. Returns (mask over input edges, weight).

    Mirrors Algorithm 2: recursive median-of-sample pivoting, filtering of
    heavy edges against the partial MSF's component labels (the dense
    ``labels`` vector), and a Borůvka base case on ``device`` (the CUDA
    card unless the caller asks for another) once the graph is sparse
    (avg degree <= 4) or small.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = len(u)
    labels = np.arange(n, dtype=np.int32)
    mask = np.zeros(m, bool)
    mst_count = 0

    def base(eu, ev, ew, eidx):
        nonlocal labels, mst_count
        if len(eu) == 0:
            return
        sub, labels = _padded_base_case(eu, ev, ew, labels, n, dev)
        mask[eidx[sub]] = True
        mst_count += int(sub.sum())

    def rec(eu, ev, ew, eidx):
        n_comp = n - mst_count
        if len(eu) <= max(min_edges, sparse_avg_degree * n_comp / 2):
            base(eu, ev, ew, eidx)
            return
        # PivotSelection: median of a random sample (Section V).
        samp = rng.choice(ew, size=min(sample_size, len(ew)), replace=False)
        pivot = float(np.median(samp))
        light = ew <= pivot
        if light.all() or not light.any():  # degenerate pivot: fall back
            base(eu, ev, ew, eidx)
            return
        rec(eu[light], ev[light], ew[light], eidx[light])
        # Filter: drop heavy edges inside components of the partial MSF.
        hu, hv, hw, hidx = eu[~light], ev[~light], ew[~light], eidx[~light]
        keep = labels[hu] != labels[hv]
        rec(hu[keep], hv[keep], hw[keep], hidx[keep])

    finite = np.isfinite(w)
    rec(u[finite].astype(np.int32), v[finite].astype(np.int32),
        w[finite].astype(np.float32), np.arange(m)[finite])
    return mask, float(w[mask].sum())


def boruvka_dynamic(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int,
                    device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """Plain Borůvka through the dynamic-engine plumbing, on ``device``
    (the CUDA card unless the caller asks for another)."""
    dev = resolve_device(device)
    m = len(u)
    finite = np.isfinite(w)
    sub, _ = _padded_base_case(u[finite], v[finite], w[finite],
                               np.arange(n, dtype=np.int32), n, dev)
    mask = np.zeros(m, bool)
    mask[np.arange(m)[finite][sub]] = True
    return mask, float(w[mask].sum())


def validate_against_oracle(u, v, w, n, mask) -> bool:
    """Check a computed MSF mask against the Kruskal oracle by weight."""
    _, ow = oracle.kruskal(np.asarray(u), np.asarray(v), np.asarray(w), n)
    got = float(np.asarray(w)[np.asarray(mask)].sum())
    return abs(got - ow) < 1e-4 * max(1.0, abs(ow))
