"""Mixture-of-Experts, single-program path: the port of
``repro.models.moe``'s ``router_topk``, ``_expert_ffn``, ``_bucketize``,
``moe_local`` and ``moe_apply``.

Token copies are packed into per-expert capacity buckets with the port's
``comm/exchange.py: _group_positions`` (a stable rank per expert), so the
same copies are dropped as in the reference.  Over-capacity copies pass
through the residual.  The expert-parallel path (``moe_dispatch``, and
``moe_apply`` under a mesh context) is ROADMAP item 13b.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.comm.exchange import _group_positions
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


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor,
              mesh_ctx=None) -> torch.Tensor:
    """MoE layer: routed experts (+ optional shared experts)."""
    if mesh_ctx is not None:
        raise NotImplementedError(
            "moe_apply with a mesh context (the expert-parallel "
            "moe_dispatch) is not ported yet: ROADMAP item 13b")
    y = moe_local(cfg, p, x)
    if cfg.num_shared_experts:
        y = y + swiglu(x, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    return y
