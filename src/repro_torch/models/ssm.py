"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060], the port
of ``repro.models.ssm``.

Chunked SSD: the sequence is split into chunks of length Q; inside a
chunk the recurrence is a decay-masked attention-like quadratic form
(batched einsums), and the chunk states are carried across chunks by a
Python loop where the reference scans.  Decode keeps O(1) state per
layer: the SSM state [H, P, N] plus the causal-conv tail.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _pad_time, proj, rmsnorm


class SSMState(NamedTuple):
    h: torch.Tensor        # [B, H, P, N] ssm state
    conv: torch.Tensor     # [B, W-1, conv_channels] causal-conv tail


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    return cfg.num_heads, cfg.ssm_head_dim, cfg.ssm_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x [B,S,C], w [W,C]. Returns (y, new_tail)."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    # the reference's order: 0 + tap 0 + tap 1 + ... in the input dtype
    y = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return F.silu(y), xp[:, -(W - 1):]


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh [B,S,H,P], dt [B,S,H] (softplus'd), A [H] (negative), Bm/Cm [B,S,N].
    Returns (y [B,S,H,P], h_final [B,H,P,N]).
    """
    B, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    xh, dt, Bm, Cm = (_pad_time(t, pad) for t in (xh, dt, Bm, Cm))
    Sp = S + pad
    nc = Sp // Q

    def r(t):  # reshape into chunks
        return t.reshape((B, nc, Q) + tuple(t.shape[2:]))

    xc, dtc, Bc, Cc = r(xh), r(dt.float()), r(Bm), r(Cm)
    # per-step log decay: l = A * dt  (A < 0)
    lc = A.float()[None, None, None, :] * dtc               # [B,nc,Q,H]
    cum = torch.cumsum(lc, dim=2)                           # [B,nc,Q,H]
    # intra-chunk decay matrix M[t,s] = exp(cum_t - cum_s), s <= t
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,nc,t,s,H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))
    M = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0)
    # intra-chunk (attention-like) term
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc).float()
    dx = xc.float() * dtc[..., None]                        # [B,nc,Q,H,P]
    y_intra = torch.einsum("bcts,bctsh,bcshp->bcthp", scores, M, dx)

    # chunk summary states, then the cross-chunk recurrence
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,nc,Q,H]
    states = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc.float(), decay_end,
                          dx)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [B,nc,H]

    h = (torch.zeros((B, H, Pd, N), device=xh.device) if h0 is None
         else h0.float())
    h_enter = []
    for c in range(nc):
        h_enter.append(h)  # state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_enter = torch.stack(h_enter, dim=1)                   # [B,nc,H,P,N]
    # contribution of the entering state to each position
    y_init = torch.einsum("bctn,bcth,bchpn->bcthp", Cc.float(),
                          torch.exp(cum), h_enter)
    y = (y_intra + y_init).reshape(B, Sp, H, Pd)[:, :S]
    return y.to(xh.dtype), h.to(xh.dtype)


def mamba2_block(cfg: ModelConfig, p, x: torch.Tensor,
                 state: Optional[SSMState] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full Mamba2 mixer. x [B,S,D]. state!=None -> streaming/decode mode
    (a new state is returned; the caller stores it)."""
    B, S, D = x.shape
    H, Pd, N = ssm_dims(cfg)
    inner = H * Pd
    z, xr, Bm, Cm, dt = torch.split(proj(x, p["in_proj"]),
                                    [inner, inner, N, N, H], dim=-1)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)
    tail = state.conv if state is not None else None
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"], tail)
    xr, Bm, Cm = torch.split(conv_out, [inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xr.reshape(B, S, H, Pd)
    h0 = state.h if state is not None else None
    y, h = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, inner)
    # gated RMSNorm then out projection
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = proj(y, p["out_proj"])
    new_state = SSMState(h, new_tail) if state is not None else None
    return out, new_state
