"""Capacity-bounded sparse all-to-all over stacked shards (the paper's
bulk request/reply).

Port of ``repro/comm/exchange.py``.  Every shard routes items into a
static ``[p, C, ...]`` send buffer (one row per destination, ``C`` =
capacity), one all-to-all delivers them, and items beyond capacity are
counted in ``overflow`` instead of corrupting anything.  Here the p
shards are the leading axis of every tensor: items are ``[p, L, ...]``,
send buffers ``[p_src, p_dst, C, ...]``, and the all-to-all is the
transpose of ``comm/grid_alltoall.py``.

Everything the reference leaves to its compiler's index semantics is
spelled out, because the outputs must match the reference bit for bit
even on overflowed (garbage) items:

* items that are not admitted go to trash rows past the zero-filled
  send buffer (the reference's ``mode="drop"`` scatter), so unused
  buffer slots read 0;
* ``reply`` clamps its gather indices into range, as the reference's
  gathers do;
* ``ExchangeStats`` counts one shard's ``[p, C]`` buffers (what one
  device ships), in float32, added in the reference's order.

The multicast primitives deliver one item to every shard of a bitmask:
``scatter_updates`` over the whole shard axis (int32 masks, so at most
31 shards), ``scatter_updates_grid`` in two hops over an ``(R, C)``
layout with one mask per grid axis (at most 31 x 31 shards).  Only the
ghost-vertex label cache uses them.

``site`` labels a call for fault injection, which the port does not have
yet; the argument is kept so call sites stay those of the reference.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.comm.grid_alltoall import all_to_all_axis, all_to_all_nd


class ExchangeStats(NamedTuple):
    """Comm accumulator of the routed exchanges, field for field the
    reference's (see ``repro/comm/exchange.py: ExchangeStats`` for the
    units): ``calls`` all-to-all invocations (int32), ``items`` routed
    payload items summed over shards, ``bytes`` capacity-padded buffer
    bytes of one shard, ``slots`` ``p * capacity`` rows per logical
    exchange, the ghost-cache ``hits``/``misses``/``pushed`` and the
    fault-injection ``injected`` (all float32).  0-dim tensors on the
    solve's device.
    """
    calls: torch.Tensor
    items: torch.Tensor
    bytes: torch.Tensor
    slots: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    pushed: torch.Tensor
    injected: torch.Tensor

    @staticmethod
    def zeros(device: torch.device) -> "ExchangeStats":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return ExchangeStats(torch.zeros((), dtype=torch.int32,
                                         device=device), z, z, z, z, z, z, z)


def _hops(axis_sizes: Sequence[int], schedule: str) -> int:
    """all-to-all invocations one logical exchange costs (grid: one/axis)."""
    sizes = tuple(axis_sizes)
    return 1 if (schedule == "direct" or len(sizes) == 1) else len(sizes)


def _leaves(payload) -> Tuple[torch.Tensor, ...]:
    return tuple(payload) if isinstance(payload, (tuple, list)) \
        else (payload,)


def _buffer_bytes(buffers) -> int:
    """Bytes one shard's ``[p, C, ...]`` buffers ship (the stacked
    ``[p, p, C, ...]`` buffers divided by p)."""
    return sum(x[0].numel() * x.element_size() for x in _leaves(buffers))


def psum_f32(per_shard: torch.Tensor) -> torch.Tensor:
    """Sum a float32 ``[p]`` over shards in shard order — the order of
    the reference's all-reduce, so float sums compare bit for bit."""
    acc = per_shard[0]
    for s in range(1, per_shard.shape[0]):
        acc = acc + per_shard[s]
    return acc


def _psum_count(mask: torch.Tensor) -> torch.Tensor:
    """float32 count of set entries, per shard then over shards."""
    per = mask.reshape(mask.shape[0], -1).sum(1).to(torch.float32)
    return psum_f32(per)


class ExchangeResult(NamedTuple):
    """One routed exchange's receive-side view plus the bookkeeping a
    later ``reply`` needs to route answers back."""
    recv: object               # [p, p, C, ...] received payloads
    recv_ok: torch.Tensor      # [p, p, C] bool — slot holds a delivered item
    sent_ok: torch.Tensor      # [p, L] bool — item was within capacity
    dest: torch.Tensor         # [p, L] int32 (echoed)
    slot: torch.Tensor         # [p, L] int32 position in the send buffer
    overflow: torch.Tensor     # [] int32 dropped items over all shards
    stats: Optional[ExchangeStats] = None


def _group_positions(dest: torch.Tensor, valid: torch.Tensor,
                     p: int) -> torch.Tensor:
    """Stable rank of each item within its destination group, per shard
    (``[p, L]`` in and out).  Invalid items rank in a group of their own
    (key ``p``), as in the reference."""
    L = dest.shape[1]
    key = torch.where(valid, dest, p)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    idx = torch.arange(L, dtype=torch.int32, device=dest.device)
    head = torch.ones_like(sorted_key, dtype=torch.bool)
    head[:, 1:] = sorted_key[:, 1:] != sorted_key[:, :-1]
    first = torch.cummax(torch.where(head, idx, 0), dim=1).values
    pos = torch.empty_like(key)
    pos.scatter_(1, order, idx - first)
    return pos


def routed_exchange(payload, dest: torch.Tensor, valid: torch.Tensor,
                    capacity: int, axis_sizes: Sequence[int],
                    schedule: str = "grid",
                    stats: Optional[ExchangeStats] = None,
                    site: str = "") -> ExchangeResult:
    """Deliver ``payload[s, i]`` from shard ``s`` to shard ``dest[s, i]``.

    ``payload`` is a ``[p, L, ...]`` tensor or a tuple of them; ``dest``
    and ``valid`` are ``[p, L]``.  Each shard's send buffer holds
    ``capacity`` items per destination; an item is sent iff it is valid,
    its destination is in range and its rank within the destination is
    below capacity (``sent_ok``).  The rest are counted in ``overflow``.
    With ``stats``, the result carries it plus this exchange's
    contribution.
    """
    sizes = tuple(axis_sizes)
    p = math.prod(sizes)
    dev = dest.device
    L = dest.shape[1]
    pos = _group_positions(dest, valid, p)
    ok = valid & (pos < capacity) & (dest >= 0) & (dest < p)
    # predicated scatter: an item that is not ok lands in a trash row of
    # its own past the buffer, so no two writes share a row
    buf_rows = p * p * capacity
    shard = torch.arange(p, dtype=torch.int64, device=dev).view(p, 1)
    item = torch.arange(p * L, dtype=torch.int64, device=dev).view(p, L)
    flat = torch.where(ok, (shard * p + dest.long()) * capacity + pos.long(),
                       buf_rows + item).reshape(-1)

    def scatter(x):
        rest = tuple(x.shape[2:])
        buf = torch.zeros((buf_rows + p * L,) + rest, dtype=x.dtype,
                          device=dev)
        buf.index_copy_(0, flat, x.reshape((p * L,) + rest))
        return buf[:buf_rows].view((p, p, capacity) + rest)

    leaves = _leaves(payload)
    send = tuple(scatter(x) for x in leaves)
    send_mask = scatter(ok)
    recv = tuple(all_to_all_nd(b, sizes, schedule) for b in send)
    recv_ok = all_to_all_nd(send_mask, sizes, schedule)
    overflow = (valid & ~ok).sum(dtype=torch.int32)
    if stats is not None:
        h = _hops(sizes, schedule)
        nbuf = len(leaves) + 1  # + validity mask
        by = _buffer_bytes(send) + _buffer_bytes(send_mask)
        stats = stats._replace(calls=stats.calls + nbuf * h,
                               items=stats.items + _psum_count(ok),
                               bytes=stats.bytes + by * h,
                               slots=stats.slots + p * capacity)
    if not isinstance(payload, (tuple, list)):
        recv = recv[0]
    return ExchangeResult(recv, recv_ok, ok, dest, pos, overflow, stats)


def reply(ex: ExchangeResult, answers, axis_sizes: Sequence[int],
          schedule: str = "grid", stats: Optional[ExchangeStats] = None):
    """Route per-slot ``answers`` (``[p, p, C, ...]``, aligned with
    ``ex.recv``) back to the requesting items.  Returns ``[p, L, ...]``
    with ``ex.sent_ok`` telling which entries are meaningful; with
    ``stats``, returns ``([p, L, ...], updated stats)`` instead."""
    sizes = tuple(axis_sizes)
    p = math.prod(sizes)
    dev = ex.dest.device
    L = ex.dest.shape[1]
    leaves = _leaves(answers)
    # item i used buffer position (dest[i], slot[i]); after the return
    # exchange that slot holds the answer from shard dest[i].  Indices
    # are clamped into range like the reference's gathers.
    shard = torch.arange(p, dtype=torch.int64, device=dev).view(p, 1)
    d = ex.dest.clamp(0, p - 1).long()
    out = []
    for a in leaves:
        back = all_to_all_nd(a, sizes, schedule)
        C = back.shape[2]
        rest = tuple(back.shape[3:])
        if C == 0:
            out.append(torch.zeros((p, L) + rest, dtype=back.dtype,
                                   device=dev))
            continue
        s = ex.slot.clamp(0, C - 1).long()
        flat = ((shard * p + d) * C + s).reshape(-1)
        out.append(back.reshape((p * p * C,) + rest)[flat]
                   .view((p, L) + rest))
    result = tuple(out) if isinstance(answers, (tuple, list)) else out[0]
    if stats is None:
        return result
    h = _hops(sizes, schedule)
    by = _buffer_bytes(answers)
    slots = leaves[0].shape[1] * leaves[0].shape[2] if leaves else 0
    stats = stats._replace(calls=stats.calls + len(leaves) * h,
                           items=stats.items + _psum_count(ex.recv_ok),
                           bytes=stats.bytes + by * h,
                           slots=stats.slots + slots)
    return result, stats


def _mask_to_copies(dest_mask: torch.Tensor, valid: torch.Tensor,
                    p: int) -> torch.Tensor:
    """Expand int32 destination bitmasks (``[..., L]``) to the copy
    matrix ``[..., L, p]``: copy (i, s) exists iff item i is valid and
    bit s of its mask is set.  Bits 0..30 are destinations; bit 31, the
    sign bit, is never one, so ``p <= 31``."""
    lanes = torch.arange(p, dtype=torch.int32, device=dest_mask.device)
    return valid.unsqueeze(-1) & (((dest_mask.unsqueeze(-1) >> lanes) & 1)
                                  > 0)


def _axis_masks_to_copies(row_mask: torch.Tensor, col_mask: torch.Tensor,
                          valid: torch.Tensor, r: int, c: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid multicast's pair of per-axis copy matrices: ``(row copies
    [..., L, r], col copies [..., L, c])``; the delivered set is their
    outer product, up to 31 x 31 shards."""
    return (_mask_to_copies(row_mask, valid, r),
            _mask_to_copies(col_mask, valid, c))


class ScatterResult(NamedTuple):
    """Receive side of one multicast; it has no reply leg."""
    recv: object               # [p, D, C, ...] received payloads
    recv_ok: torch.Tensor      # [p, D, C] bool — slot holds a delivered item
    sent_ok: torch.Tensor      # [p, L, D] bool — (item, dest) copy admitted
    overflow: torch.Tensor     # [] int32 dropped copies over all shards
    stats: Optional[ExchangeStats] = None


def _copy_buffers(leaves, want: torch.Tensor, capacity: int):
    """Send buffers of a multicast: copy (s, i, d) of ``want`` ([p, L,
    D]) takes position ``pos`` = its rank among shard s's copies to d (a
    cumsum down the items) in row d of shard s's ``[D, capacity]``
    buffer, if ``pos < capacity``.  Returns (buffers of ``leaves``
    ([p, L, ...] each) as ``[p, D, capacity, ...]``, the validity
    buffer, ok [p, L, D])."""
    p, L, D = want.shape
    dev = want.device
    pos = torch.cumsum(want.to(torch.int32), dim=1) - 1
    ok = want & (pos < capacity)
    rows = p * D * capacity
    shard = torch.arange(p, dtype=torch.int64, device=dev).view(p, 1, 1)
    dst = torch.arange(D, dtype=torch.int64, device=dev).view(1, 1, D)
    copy = torch.arange(p * L * D, dtype=torch.int64, device=dev).view(
        p, L, D)
    # copies that are not ok land in trash rows of their own past the
    # buffer (the reference's mode="drop"), so unused slots read 0
    flat = torch.where(ok, (shard * D + dst) * capacity + pos.long(),
                       rows + copy).reshape(-1)

    def scatter(x):  # x: [p, L, D, ...], one value per copy
        rest = tuple(x.shape[3:])
        buf = torch.zeros((rows + p * L * D,) + rest, dtype=x.dtype,
                          device=dev)
        buf.index_copy_(0, flat, x.reshape((p * L * D,) + rest))
        return buf[:rows].view((p, D, capacity) + rest)

    send = tuple(scatter(x.unsqueeze(2).expand((p, L, D)
                                               + tuple(x.shape[2:])))
                 for x in leaves)
    return send, scatter(ok), ok


def scatter_updates(payload, dest_mask: torch.Tensor, valid: torch.Tensor,
                    capacity: int, axis_sizes: Sequence[int],
                    schedule: str = "grid",
                    stats: Optional[ExchangeStats] = None,
                    site: str = "") -> ScatterResult:
    """Multicast ``payload[s, i]`` to every shard set in ``dest_mask[s,
    i]`` (int32, ``p <= 31``), in one exchange of ``[p, capacity]``
    buffers.  Copies past ``capacity`` per destination are dropped and
    counted in ``overflow``.  ``stats`` books one logical exchange
    (payload leaves + the validity buffer) with the hop multiplier on
    calls, bytes and slots: a multicast re-admits its copies at every
    hop, so it books ``p * capacity * hops`` slots where
    ``routed_exchange`` books ``p * capacity``.  ``pushed`` is the
    caller's to count."""
    sizes = tuple(axis_sizes)
    p = math.prod(sizes)
    leaves = _leaves(payload)
    want = _mask_to_copies(dest_mask, valid, p)
    send, send_mask, ok = _copy_buffers(leaves, want, capacity)
    recv = tuple(all_to_all_nd(b, sizes, schedule) for b in send)
    recv_ok = all_to_all_nd(send_mask, sizes, schedule)
    overflow = (want & ~ok).sum(dtype=torch.int32)
    if stats is not None:
        h = _hops(sizes, schedule)
        by = _buffer_bytes(send) + _buffer_bytes(send_mask)
        stats = stats._replace(calls=stats.calls + (len(leaves) + 1) * h,
                               items=stats.items + _psum_count(ok),
                               bytes=stats.bytes + by * h,
                               slots=stats.slots + p * capacity * h)
    if not isinstance(payload, (tuple, list)):
        recv = recv[0]
    return ScatterResult(recv, recv_ok, ok, overflow, stats)


def scatter_updates_grid(payload, row_mask: torch.Tensor,
                         col_mask: torch.Tensor, valid: torch.Tensor,
                         cap_row: int, cap_col: int,
                         axis_sizes: Sequence[int],
                         stats: Optional[ExchangeStats] = None,
                         site_row: str = "", site_col: str = ""
                         ) -> ScatterResult:
    """Two-hop multicast over an ``(R, C)`` layout: ``payload[s, i]``
    reaches every shard ``(rr, cc)`` with bit ``rr`` of ``row_mask`` and
    bit ``cc`` of ``col_mask`` set.

    Hop 1 ships one copy per subscribing column along the owner's row
    (an exchange over the col axis, ``[C, cap_row]`` buffers), carrying
    the row mask; hop 2 re-multicasts each deputy's items down its
    column (over the row axis, ``[R, cap_col]`` buffers).  The delivered
    set is the outer product of the masks, so receivers must apply
    updates by value.  Both hops drop and count copies past capacity.
    ``stats`` books the legs apart: ``(leaves + 2) + (leaves + 1)``
    calls, ``C * cap_row + R * cap_col`` slots, no hop multiplier.
    ``sent_ok`` is hop 1's ``[p, L, C]`` admission matrix.
    """
    sizes = tuple(axis_sizes)
    if len(sizes) != 2:
        raise ValueError(f"scatter_updates_grid needs a (row, col) layout, "
                         f"got {sizes!r}")
    R, C = sizes
    p = R * C
    leaves = _leaves(payload)

    # hop 1: owner -> deputies along the row (exchange over col)
    want1 = _mask_to_copies(col_mask, valid, C)
    send1, mask1, ok1 = _copy_buffers(leaves + (row_mask,), want1, cap_row)
    hop1 = tuple(all_to_all_axis(b, sizes, 1) for b in send1)
    ok_r = all_to_all_axis(mask1, sizes, 1)
    ovf1 = (want1 & ~ok1).sum(dtype=torch.int32)

    # hop 2: deputy -> subscribers down the column (exchange over row)
    M = C * cap_row
    dep = tuple(x.reshape((p, M) + tuple(x.shape[3:])) for x in hop1)
    want2 = _mask_to_copies(dep[-1], ok_r.reshape(p, M), R)
    send2, mask2, ok2 = _copy_buffers(dep[:-1], want2, cap_col)
    recv = tuple(all_to_all_axis(b, sizes, 0) for b in send2)
    recv_ok = all_to_all_axis(mask2, sizes, 0)
    ovf2 = (want2 & ~ok2).sum(dtype=torch.int32)

    if stats is not None:
        by = (_buffer_bytes(send1) + _buffer_bytes(mask1)
              + _buffer_bytes(send2) + _buffer_bytes(mask2))
        per = (ok1.reshape(p, -1).sum(1).to(torch.float32)
               + ok2.reshape(p, -1).sum(1).to(torch.float32))
        stats = stats._replace(
            calls=stats.calls + (len(leaves) + 2) + (len(leaves) + 1),
            items=stats.items + psum_f32(per),
            bytes=stats.bytes + by,
            slots=stats.slots + (C * cap_row + R * cap_col))
    if not isinstance(payload, (tuple, list)):
        recv = recv[0]
    return ScatterResult(recv, recv_ok, ok1, ovf1 + ovf2, stats)


def request_reply(request, dest: torch.Tensor, valid: torch.Tensor,
                  answer_fn: Callable, capacity: int,
                  axis_sizes: Sequence[int], schedule: str = "grid",
                  site: str = ""):
    """EXCHANGELABELS pattern: ship requests home, answer, ship answers
    back.  ``answer_fn(recv, recv_ok) -> answers`` sees the receiving
    shards' ``[p, p, C, ...]`` buffers.  Returns (answers [p, L, ...],
    answered [p, L] bool, overflow count)."""
    ex = routed_exchange(request, dest, valid, capacity, axis_sizes,
                         schedule, site=site)
    answers = answer_fn(ex.recv, ex.recv_ok)
    out = reply(ex, answers, axis_sizes, schedule)
    return out, ex.sent_ok, ex.overflow
