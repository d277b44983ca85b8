"""Mixture-of-Experts with the paper's sparse-exchange machinery, the
port of ``repro.models.moe``.

Token->expert dispatch is a capacity-bounded sparse all-to-all, the
communication problem the paper engineers for MST label exchange
(Section VI-A):

  * ``moe_local``    — single-program path: per-expert capacity buckets
    built with the port's ``comm/exchange.py: _group_positions`` (a
    stable rank per expert), so the same copies are dropped as in the
    reference; no exchange.
  * ``moe_dispatch`` — expert-parallel path on the port's mesh model
    (every shard in one process, a leading shard axis): each shard routes
    its own tokens into its own capacity buckets and the buckets travel to
    the experts' home shards and back through ``comm/grid_alltoall.py:
    all_to_all_nd``, direct or with the two-level grid schedule.

Over-capacity copies pass through the residual.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.exchange import _group_positions
from repro_torch.comm.grid_alltoall import all_to_all_nd
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu


def router_topk(x2d: torch.Tensor, w_router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (gates [T, k] fp32 normalised, experts [T, k] int32).

    ``lax.top_k`` breaks ties toward the lower expert index, which
    ``torch.topk`` does not promise: a stable sort on ``-gate`` keeps
    equal gates in index order."""
    logits = x2d.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    gates = torch.gather(probs, 1, order)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, order.to(torch.int32)


def _expert_ffn(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D]; weights [E, D, F] / [E, F, D]."""
    g = torch.bmm(xe, wg.to(xe.dtype))
    u = torch.bmm(xe, wu.to(xe.dtype))
    return torch.bmm(F.silu(g) * u, wd.to(xe.dtype))


def _bucketize(x2d: torch.Tensor, gates: torch.Tensor,
               experts: torch.Tensor, E: int, capacity: int):
    """Pack token copies into per-expert capacity buckets.

    Returns (xbuf [E, C, D], gbuf [E, C], src [E, C] source-token index or
    -1, ok [T, k]).  A copy past its expert's capacity lands in a trash
    row past the buffer, which is sliced off (the reference's
    ``mode="drop"``).
    """
    T, k = experts.shape
    dev = x2d.device
    flat_e = experts.reshape(-1)
    valid = torch.ones((1, T * k), dtype=torch.bool, device=dev)
    pos = _group_positions(flat_e[None], valid, E)[0]
    ok = pos < capacity
    rows = E * capacity
    flat = torch.where(ok, flat_e.long() * capacity + pos.long(), rows)
    tok = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)

    def place(values, fill, dtype):
        buf = torch.full((rows + 1,) + tuple(values.shape[1:]), fill,
                         dtype=dtype, device=dev)
        buf[flat] = values.to(dtype)
        return buf[:rows].reshape((E, capacity) + tuple(values.shape[1:]))

    xbuf = place(x2d[tok.long()], 0, x2d.dtype)
    gbuf = place(gates.reshape(-1), 0, torch.float32)
    src = place(tok, -1, torch.int32)
    return xbuf, gbuf, src, ok.reshape(T, k)


def moe_local(cfg: ModelConfig, p, x: torch.Tensor,
              capacity: Optional[int] = None) -> torch.Tensor:
    """Single-program MoE (the capacity semantics of the dispatch path
    with an undivided expert axis)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    x2d = x.reshape(B * S, D)
    T = x2d.shape[0]
    C = capacity or max(1, int(T * k * cfg.capacity_factor / E) + 1)
    gates, experts = router_topk(x2d, p["router"], k)
    xbuf, gbuf, src, _ = _bucketize(x2d, gates, experts, E, C)
    ybuf = _expert_ffn(xbuf, p["wg"], p["wu"], p["wd"])
    ybuf = ybuf * gbuf[..., None].to(ybuf.dtype)
    y = torch.zeros((T + 1, D), dtype=x2d.dtype, device=x.device)
    y.index_add_(0, torch.where(src >= 0, src, T).reshape(-1).long(),
                 ybuf.reshape(E * C, D))
    return y[:T].reshape(B, S, D)


def moe_dispatch(cfg: ModelConfig, p, x: torch.Tensor, mesh,
                 dp_axes: Sequence[str], ep_axes: Sequence[str],
                 capacity: Optional[int] = None) -> torch.Tensor:
    """Expert-parallel MoE: routed exchange over ``ep_axes`` of ``mesh``
    (a ``launch/mesh.py: Mesh``).

    ``x`` [B, S, D] is split into ``[pd, pe]`` blocks of
    ``[B/pd, S/pe, D]``: batch over the DP axes, sequence over the expert
    axes (the reference's ``in_specs=P(dp, ep, None)``, row-major over
    each group of axes).  Experts are split over the expert axes, shard
    ``j`` holding ``[j * E/pe, (j+1) * E/pe)``.  Each shard sizes its own
    capacity from its own token count, so the copies it drops depend on
    the mesh.  The grid schedule applies when the expert axes span >= 2
    mesh axes.  Requires ``B % pd == 0``, ``S % pe == 0`` and
    ``E % pe == 0``.
    """
    dp, ep = tuple(dp_axes), tuple(ep_axes)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    schedule = cfg.moe_dispatch if len(ep) > 1 else "direct"
    ep_sizes = tuple(mesh.shape[a] for a in ep)
    pd = math.prod(mesh.shape[a] for a in dp)
    pe = math.prod(ep_sizes)
    B, S, D = x.shape
    if B % pd or S % pe or E % pe:
        raise ValueError(f"moe_dispatch: batch {B} over {pd} DP shards, "
                         f"sequence {S} and {E} experts over {pe} expert "
                         "shards must divide")
    e_local = E // pe
    Bl, Sl = B // pd, S // pe
    T = Bl * Sl
    C = capacity or max(1, int(T * k * cfg.capacity_factor / E) + 1)
    # [pd, pe, T, D]: shard (i, j)'s tokens in row-major order
    x2d = x.reshape(pd, Bl, pe, Sl, D).transpose(1, 2).reshape(pd, pe, T, D)

    send, gbufs, srcs = [], [], []
    for i in range(pd):
        for j in range(pe):
            gates, experts = router_topk(x2d[i, j], p["router"], k)
            xbuf, gbuf, src, _ = _bucketize(x2d[i, j], gates, experts, E, C)
            # experts are contiguous per shard: [E, C, D] -> [pe, e_local*C,
            # D], chunk d for expert shard d
            send.append(xbuf.reshape(pe, e_local * C, D))
            gbufs.append(gbuf)
            srcs.append(src)
    recv = _exchange(torch.stack(send).reshape(pd, pe, pe, e_local * C, D),
                     ep_sizes, schedule)   # [pd, pe_dst, pe_src, elC, D]

    # The reference stores each expert's hidden dim sharded over the DP
    # axes and all-gathers it at use (ZeRO-3); one process holds every
    # expert whole, so that gather is the identity here.
    back = []
    for i in range(pd):
        for j in range(pe):
            lo, hi = j * e_local, (j + 1) * e_local
            xe = recv[i, j].reshape(pe, e_local, C, D).transpose(0, 1)
            ye = _expert_ffn(xe.reshape(e_local, pe * C, D), p["wg"][lo:hi],
                             p["wu"][lo:hi], p["wd"][lo:hi])
            back.append(ye.reshape(e_local, pe, C, D).transpose(0, 1)
                        .reshape(pe, e_local * C, D))
    recv_y = _exchange(torch.stack(back).reshape(pd, pe, pe, e_local * C, D),
                       ep_sizes, schedule)

    out = []
    for s_idx in range(pd * pe):
        i, j = divmod(s_idx, pe)
        ybuf = recv_y[i, j].reshape(E, C, D) \
            * gbufs[s_idx][..., None].to(x.dtype)
        src = srcs[s_idx]
        y = torch.zeros((T + 1, D), dtype=x.dtype, device=x.device)
        y.index_add_(0, torch.where(src >= 0, src, T).reshape(-1).long(),
                     ybuf.reshape(E * C, D))
        out.append(y[:T])
    y = torch.stack(out).reshape(pd, pe, Bl, Sl, D).transpose(1, 2)
    return y.reshape(B, S, D)


def _exchange(buf: torch.Tensor, ep_sizes, schedule: str) -> torch.Tensor:
    """One all-to-all within every DP group: ``buf`` [pd, pe_src, pe_dst,
    ...] -> [pd, pe_dst, pe_src, ...]."""
    moved = all_to_all_nd(buf.movedim(0, 2), ep_sizes, schedule)
    return moved.movedim(2, 0)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor,
              mesh_ctx=None) -> torch.Tensor:
    """MoE layer: routed experts (+ optional shared experts).  The routed
    exchange runs where the reference runs it: ``moe_impl="dispatch"``, a
    mesh context with more than one expert shard and a sequence that they
    divide; anything else (single-token decode among it) runs
    ``moe_local``."""
    if cfg.moe_impl == "dispatch" and mesh_ctx is not None \
            and mesh_ctx.ep_size > 1 \
            and x.shape[1] % mesh_ctx.ep_size == 0:
        y = moe_dispatch(cfg, p, x, mesh_ctx.mesh, mesh_ctx.dp_axes,
                         mesh_ctx.ep_axes)
    else:
        y = moe_local(cfg, p, x)
    if cfg.num_shared_experts:
        y = y + swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y
