"""All-to-all over stacked shards — the reference's mesh collective as a
transpose.

Port of ``repro/comm/grid_alltoall.py``.  In the reference every shard
holds a ``[p, ...]`` send buffer (chunk d goes to shard d) and
``lax.all_to_all`` returns ``[p, ...]`` (chunk s came from shard s).
Here all shards live in one process as a stacked ``[p_src, p_dst, ...]``
tensor, so the exchange is ``transpose(0, 1)``: the result is
``[p_dst, p_src, ...]``, indexed like the reference's receive buffers.

The paper's two-level schedule (Section VI-A) factors the shard axis
into a grid and exchanges along one grid axis per hop; each hop is a
transpose of one source axis with its destination axis, and after all
hops the data sits exactly where the direct exchange puts it — the
reference's element-wise identity of both schedules.

``all_to_all_axis`` is the exchange over one grid axis alone (the
reference's ``lax.all_to_all`` over one named mesh axis), which the
two-hop multicast ``comm/exchange.py: scatter_updates_grid`` takes.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def all_to_all_nd(x: torch.Tensor, axis_sizes: Sequence[int],
                  schedule: str = "grid") -> torch.Tensor:
    """Exchange stacked send buffers ``x`` ([p_src, p_dst, ...]).

    ``axis_sizes`` is the shard layout (``(p,)`` for one axis, ``(R, C)``
    for a grid); ``schedule`` is ``"direct"`` or ``"grid"`` (one hop per
    axis).  Returns the contiguous ``[p_dst, p_src, ...]`` receive
    buffers.
    """
    sizes = tuple(int(s) for s in axis_sizes)
    p = math.prod(sizes)
    if x.shape[0] != p or x.shape[1] != p:
        raise ValueError(f"all_to_all_nd: buffers {tuple(x.shape)} do not "
                         f"match {p} shards")
    if schedule == "direct" or len(sizes) == 1:
        return x.transpose(0, 1).contiguous()
    if schedule == "grid":
        d = len(sizes)
        xr = x.reshape(sizes + sizes + tuple(x.shape[2:]))
        for k in range(d):  # hop k: exchange along grid axis k
            xr = xr.transpose(k, d + k)
        return xr.reshape((p, p) + tuple(x.shape[2:])).contiguous()
    raise ValueError(schedule)


def all_to_all_axis(x: torch.Tensor, axis_sizes: Sequence[int],
                    axis: int) -> torch.Tensor:
    """Exchange over grid axis ``axis`` alone.

    ``x`` is ``[p, D, ...]`` with ``D = axis_sizes[axis]``: chunk ``d``
    of shard ``s`` goes to the shard whose coordinate on ``axis`` is
    ``d`` and whose other coordinates are those of ``s`` (shards are laid
    out row-major over ``axis_sizes``).  Returns the contiguous
    ``[p, D, ...]`` receive buffers, chunk ``j`` from the shard whose
    coordinate on ``axis`` is ``j``.
    """
    sizes = tuple(int(s) for s in axis_sizes)
    p = math.prod(sizes)
    d = sizes[axis]
    if x.shape[0] != p or x.shape[1] != d:
        raise ValueError(f"all_to_all_axis: buffers {tuple(x.shape)} do not "
                         f"match axis {axis} of {sizes}")
    rest = tuple(x.shape[2:])
    xr = x.reshape(sizes + (d,) + rest)
    # swap the source coordinate on `axis` with the chunk (destination)
    return xr.transpose(axis, len(sizes)).reshape((p, d) + rest).contiguous()
