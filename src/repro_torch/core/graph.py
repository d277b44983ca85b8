"""Graph representation: padded edge lists, 1D partition.

Port of ``repro/core/graph.py``.  The paper represents the graph as a
lexicographically sorted sequence of directed edges, 1D-partitioned over
PEs.  We mirror that:

* ``EdgeList`` — a padded struct-of-tensors (u, v, w).  Invalid (padding)
  slots carry ``w == +inf`` and ``u == v == 0`` so they behave as
  infinitely heavy self-loops and are ignored by every algorithm.
* ``partition_edges`` — equal-size 1D split of the sorted directed edge
  sequence (the paper's input format).

Host-side preprocessing stays numpy, as in the reference; tensors are
int32/float32 wherever the reference uses them, never torch's int64
default.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

INVALID_W = np.float32(np.inf)

# the reference's CPU compiler rewrites a float32 sum over n > 32
# elements into sequential sums over windows of 32 (zero padding split
# low/high), then reduces the window sums the same way
_SUM_WINDOW = 32


class CapacityError(ValueError):
    """A fixed-capacity edge layout cannot hold the given edges.

    Raised loudly wherever a ``cap``/``pad_to`` argument would otherwise
    be trusted: dropping edges past capacity would produce a *wrong MSF
    with no signal*.  ``dropped`` is the number of edges the requested
    capacity cannot hold.
    """

    def __init__(self, message: str, dropped: int = 0):
        super().__init__(message)
        self.dropped = int(dropped)


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Padded edge list on one device."""

    u: torch.Tensor  # int32 [m]
    v: torch.Tensor  # int32 [m]
    w: torch.Tensor  # float32 [m]; +inf marks padding
    n: int  # number of vertices

    @property
    def m(self) -> int:
        return int(self.u.shape[0])

    @property
    def valid(self) -> torch.Tensor:
        return torch.isfinite(self.w)

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def from_numpy(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int,
               pad_to: int | None = None,
               device: DeviceLike = None) -> EdgeList:
    """Build a (optionally padded) EdgeList from host arrays.

    ``pad_to`` must hold every edge — a short capacity raises a
    ``CapacityError`` with the dropped count instead of truncating.
    ``device=None`` places the tensors on the CUDA card.
    """
    dev = resolve_device(device)
    m = len(u)
    cap = m if pad_to is None else int(pad_to)
    if cap < m:
        raise CapacityError(
            f"pad_to={cap} cannot hold {m} edges ({m - cap} would be "
            "silently dropped)", dropped=m - cap)
    uu = np.zeros(cap, np.int32)
    vv = np.zeros(cap, np.int32)
    ww = np.full(cap, INVALID_W, np.float32)
    uu[:m] = u
    vv[:m] = v
    ww[:m] = w
    return EdgeList(torch.from_numpy(uu).to(dev), torch.from_numpy(vv).to(dev),
                    torch.from_numpy(ww).to(dev), int(n))


def canonicalize_undirected(u: np.ndarray, v: np.ndarray, w: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Keep one canonical direction (u < v); drop self-loops."""
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    keep = lo != hi
    return (lo[keep].astype(np.int32), hi[keep].astype(np.int32),
            w[keep].astype(np.float32))


def dedup_parallel(u: np.ndarray, v: np.ndarray, w: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Keep the lightest among parallel edges (host-side preprocessing)."""
    order = np.lexsort((w, v, u))
    u, v, w = u[order], v[order], w[order]
    first = np.ones(len(u), bool)
    if len(u) > 1:
        first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    return u[first], v[first], w[first]


def to_directed_sorted(u: np.ndarray, v: np.ndarray, w: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Both directions of every undirected edge, lexicographically sorted
    (the paper's on-PE input format, Section II-B)."""
    du = np.concatenate([u, v])
    dv = np.concatenate([v, u])
    dw = np.concatenate([w, w])
    order = np.lexsort((dw, dv, du))
    return (du[order].astype(np.int32), dv[order].astype(np.int32),
            dw[order].astype(np.float32))


def partition_edges(u: np.ndarray, v: np.ndarray, w: np.ndarray, n: int,
                    num_shards: int, cap: int | None = None,
                    device: DeviceLike = None) -> EdgeList:
    """1D-partition a sorted directed edge list into equal padded shards.

    Returns an EdgeList whose tensors have shape [num_shards * cap] laid
    out shard-major (``.view(num_shards, cap)`` gives the stacked shards).
    ``cap`` optionally pins the per-shard slot count; it must hold
    ``ceil(m / num_shards)`` — a short pin raises ``CapacityError``.
    """
    m = len(u)
    need = -(-m // num_shards)  # ceil
    if cap is None:
        cap = need
    elif cap < need:
        raise CapacityError(
            f"cap={cap} cannot hold ceil(m/p)={need} edge slots per "
            f"shard (m={m}, p={num_shards}; "
            f"{m - cap * num_shards} edges would be silently dropped)",
            dropped=m - cap * num_shards)
    uu = np.zeros(num_shards * cap, np.int32)
    vv = np.zeros(num_shards * cap, np.int32)
    ww = np.full(num_shards * cap, INVALID_W, np.float32)
    for s in range(num_shards):
        lo, hi = s * cap, min((s + 1) * cap, m)
        if hi > lo:
            uu[s * cap: s * cap + (hi - lo)] = u[lo:hi]
            vv[s * cap: s * cap + (hi - lo)] = v[lo:hi]
            ww[s * cap: s * cap + (hi - lo)] = w[lo:hi]
    return from_numpy(uu, vv, ww, n, device=device)


def reference_order_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last dim, in the reference's summation order.

    Float addition does not associate, so a weight summed in torch's own
    order can differ from the reference's in the last bit.  This adds in
    the order the reference's CPU compiler does: sequentially within
    windows of 32 elements (the zero padding to a multiple of 32 split
    between both ends), then the window sums the same way, recursively.
    Batched over the leading dims; on any device.
    """
    n = x.shape[-1]
    if n > _SUM_WINDOW:
        tot = -(-n // _SUM_WINDOW) * _SUM_WINDOW
        low = (tot - n) // 2
        x = torch.nn.functional.pad(x, (low, tot - n - low))
        x = x.reshape(x.shape[:-1] + (tot // _SUM_WINDOW, _SUM_WINDOW))
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for k in range(_SUM_WINDOW):
            acc = acc + x[..., k]
        return reference_order_sum(acc)
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(n):
        acc = acc + x[..., k]
    return acc


def forest_weight(edges: EdgeList, mask: torch.Tensor) -> torch.Tensor:
    """Total weight of the selected (valid) edges."""
    sel = mask & edges.valid
    return reference_order_sum(torch.where(sel, edges.w, 0.0))
