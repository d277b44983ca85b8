"""Common transformer building blocks in plain PyTorch, the port of
``repro.models.layers``.

Conventions, as in the reference:
  * activations [B, S, D]; weights carry explicit head dims ([D, H, hd],
    [H, hd, D]), so a converted reference tree maps leaf for leaf
  * fp32 for norms, RoPE and the softmax, ``cfg.dtype`` elsewhere: the
    scores are cast to fp32 after the product in the model dtype and the
    softmax weights back to ``q.dtype`` before the value product
  * decode paths take a cache and a ``[B]`` write position; the cache is
    updated in place (the reference returns a functionally updated copy
    with the same values) and returned
No attention here goes through ``F.scaled_dot_product_attention``: the
score/softmax/value chain is spelled out so that it holds the reference's
precision points and stays a plain baseline.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG = -1e30  # the reference's mask value


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# -- RoPE -------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [.. S] -> (cos, sin) [.., S, dim//2], fp32."""
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (i / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, H, hd] (split-half convention), cos/sin [B or 1, S, hd//2]."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


# -- projections and FFN ----------------------------------------------------

def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the last dim of ``x`` with the first of ``w`` (one
    matmul), keeping ``w``'s trailing dims: "bsd,dhk->bshk" and the like.
    ``w`` is cast to ``x.dtype``, as the reference's einsums do."""
    k = w.shape[0]
    out = x @ w.to(x.dtype).reshape(k, -1)
    return out.reshape(tuple(x.shape[:-1]) + tuple(w.shape[1:]))


def heads_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"bshk,hkd->bsd": merge the head dims of ``x`` through ``w``."""
    H, hd, D = w.shape
    return x.reshape(tuple(x.shape[:-2]) + (H * hd,)) @ \
        w.to(x.dtype).reshape(H * hd, D)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    g = proj(x, wg)
    u = proj(x, wu)
    return proj(F.silu(g) * u, wd)


def gelu_mlp(x: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
             wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(proj(x, wi) + bi, approximate="tanh")
    return proj(h, wo) + bo


# -- attention core ---------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # [B, T, KV, hd]
    v: torch.Tensor  # [B, T, KV, hd]


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(token, head) symmetric scales."""
    k_q: torch.Tensor      # int8 [B, T, KV, hd]
    k_scale: torch.Tensor  # f32  [B, T, KV]
    v_q: torch.Tensor      # int8 [B, T, KV, hd]
    v_scale: torch.Tensor  # f32  [B, T, KV]


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, KV, hd] -> (int8, scale[B, KV]); round half to even, as
    ``jnp.round``."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q [B,S,H,hd]; k,v [B,T,KV,hd]; GQA via head grouping. fp32 softmax."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, hd)


def causal_mask(S: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))


def _pad_time(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (time) at its end by ``pad``."""
    if not pad:
        return t
    shape = list(t.shape)
    shape[1] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def _sdpa_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool, block: int) -> torch.Tensor:
    """Flash-style attention: online softmax over KV chunks, a Python loop
    where the reference scans.  Never materialises [B, H, S, T]; the peak
    intermediate is [B, KV, G, S, block].  q [B,S,H,hd]; k,v [B,T,KV,hd].
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    blk = min(block, T)
    pad = (-T) % blk
    k, v = _pad_time(k, pad), _pad_time(v, pad)
    nb = (T + pad) // blk
    qg = (q.reshape(B, S, KV, G, hd) * scale).to(q.dtype)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, KV, G, S), -torch.inf, device=q.device)
    l = torch.zeros((B, KV, G, S), device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), device=q.device)
    for c in range(nb):
        start = c * blk
        kc, vc = k[:, start:start + blk], v[:, start:start + blk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kc).float()
        kpos = start + torch.arange(blk, device=q.device)
        dead = kpos[None, :] >= T
        if causal:
            dead = dead | (kpos[None, :] > qpos[:, None])
        s = torch.where(dead, NEG, s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _decode_mask(T: int, cache_pos: torch.Tensor) -> torch.Tensor:
    """[B, 1, T]: position t is visible to row b iff t <= cache_pos[b]."""
    tpos = torch.arange(T, device=cache_pos.device)[None, :]
    return (tpos <= cache_pos[:, None])[:, None, :]


def gqa_attention(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor,
                  cache=None, cache_pos: Optional[torch.Tensor] = None,
                  kv_source: Optional[torch.Tensor] = None,
                  causal: bool = True, use_rope: bool = True):
    """Standard GQA attention with optional KV cache / cross-attention.

    cache + cache_pos: decode mode — write the new K/V at ``cache_pos``
    (in place) and attend to positions <= cache_pos.
    kv_source: encoder states for cross-attention (no cache, no mask).
    Returns (y, cache).
    """
    B, S, D = x.shape
    hd = cfg.hd
    src = x if kv_source is None else kv_source
    q = proj(x, p["wq"])
    k = proj(src, p["wk"])
    v = proj(src, p["wv"])
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if use_rope and kv_source is None:
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = 1.0 / (hd ** 0.5)

    if isinstance(cache, QuantKVCache):
        # int8 cache: quantise the new entry, attend over the dequantised
        # buffer
        bidx = torch.arange(B, device=x.device)
        kq, ks = _quant_kv(k[:, 0])
        vq, vs = _quant_kv(v[:, 0])
        cache.k_q[bidx, cache_pos] = kq
        cache.k_scale[bidx, cache_pos] = ks
        cache.v_q[bidx, cache_pos] = vq
        cache.v_scale[bidx, cache_pos] = vs
        ck = cache.k_q.to(x.dtype) * cache.k_scale[..., None].to(x.dtype)
        cv = cache.v_q.to(x.dtype) * cache.v_scale[..., None].to(x.dtype)
        out = _sdpa(q, ck, cv, _decode_mask(ck.shape[1], cache_pos), scale)
    elif cache is not None:
        # decode: write the new entries, attend over the whole buffer
        bidx = torch.arange(B, device=x.device)
        cache.k[bidx, cache_pos] = k[:, 0]
        cache.v[bidx, cache_pos] = v[:, 0]
        out = _sdpa(q, cache.k, cache.v,
                    _decode_mask(cache.k.shape[1], cache_pos), scale)
    elif kv_source is not None:
        if cfg.attn_impl == "blockwise":
            out = _sdpa_blockwise(q, k, v, scale, False, cfg.attn_block)
        else:
            out = _sdpa(q, k, v, None, scale)
    elif cfg.attn_impl == "blockwise":
        out = _sdpa_blockwise(q, k, v, scale, causal, cfg.attn_block)
    else:
        mask = causal_mask(S, x.device)[None] if causal else None
        out = _sdpa(q, k, v, mask, scale)
    return heads_out(out, p["wo"]), cache


# -- MLA (multi-head latent attention, DeepSeek-V2) --------------------------

class MLACache(NamedTuple):
    latent: torch.Tensor  # [B, T, kv_lora + rope_head_dim]


def mla_attention(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[MLACache] = None,
                  cache_pos: Optional[torch.Tensor] = None,
                  causal: bool = True):
    """MLA: low-rank KV latent cache (kv_lora) + decoupled RoPE key.

    The cache stores the compressed latent (kv_lora + rope_head_dim per
    token), and K/V are re-expanded from it through ``wkv_b`` at
    attention time, or, with ``cfg.mla_absorb`` in decode, ``wkv_b`` is
    folded into the query and the output.  Returns (y, cache).
    """
    B, S, D = x.shape
    H, hd, r = cfg.num_heads, cfg.hd, cfg.rope_head_dim
    lo = cfg.kv_lora_rank

    # queries through the q-LoRA bottleneck
    q_lat = rmsnorm(proj(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
    q = proj(q_lat, p["wq_b"])
    q_nope, q_rope = q[..., :hd], q[..., hd:]

    # KV latent (+ decoupled rope key channel, shared across heads)
    kv = proj(x, p["wkv_a"])
    latent, k_rope_in = kv[..., :lo], kv[..., lo:]
    latent = rmsnorm(latent, p["kv_norm"], cfg.norm_eps)

    cos, sin = rope_cos_sin(positions, r, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope_in[:, :, None, :], cos, sin)[:, :, 0, :]

    packed = torch.cat([latent, k_rope], dim=-1)  # [B, S, lo+r]

    if cache is not None:
        bidx = torch.arange(B, device=x.device)
        cache.latent[bidx, cache_pos] = packed[:, 0]
        packed_all = cache.latent
        mask = _decode_mask(packed_all.shape[1], cache_pos)
    else:
        packed_all = packed
        mask = causal_mask(S, x.device)[None] if causal else None

    scale = 1.0 / ((hd + r) ** 0.5)
    if cache is not None and cfg.mla_absorb:
        # absorbed-weight decode: attention in the latent space, the
        # cached latents are never re-expanded
        lat_all = packed_all[..., :lo]
        k_rope_all = packed_all[..., lo:]
        wk_abs = p["wkv_b"][..., :hd].to(x.dtype)   # [lo, H, hd]
        wv_abs = p["wkv_b"][..., hd:].to(x.dtype)   # [lo, H, hd]
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_abs)
        s_nope = torch.einsum("bshr,btr->bhst", q_lat, lat_all)
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope_all)
        scores = (s_nope + s_rope).float() * scale
        if mask is not None:
            scores = torch.where(mask[:, None], scores, NEG)
        wgt = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btr->bshr", wgt, lat_all)
        out = torch.einsum("bshr,rhk->bshk", ctx, wv_abs)
    elif cfg.attn_impl == "blockwise" and cache is None:
        out = _mla_blockwise(q_nope, q_rope, packed_all, p["wkv_b"], lo, hd,
                             scale, causal, cfg.attn_block)
    else:
        lat_all = packed_all[..., :lo]
        k_rope_all = packed_all[..., lo:]
        # expand K (nope part) and V from the latent
        kvex = proj(lat_all, p["wkv_b"])
        k_nope, v = kvex[..., :hd], kvex[..., hd:]
        s_nope = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope_all)
        scores = (s_nope + s_rope).float() * scale
        if mask is not None:
            scores = torch.where(mask[:, None], scores, NEG)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthk->bshk", w, v)
    return heads_out(out, p["wo"]), cache


def _mla_blockwise(q_nope: torch.Tensor, q_rope: torch.Tensor,
                   packed: torch.Tensor, wkv_b: torch.Tensor, lo: int,
                   hd: int, scale: float, causal: bool, block: int
                   ) -> torch.Tensor:
    """Blockwise MLA: chunk the *latent* cache, expand K/V per chunk
    (compute traded for memory).  The reference pins the carries'
    sharding; one device has nothing to pin."""
    B, S, H, _ = q_nope.shape
    T = packed.shape[1]
    blk = min(block, T)
    pad = (-T) % blk
    packed = _pad_time(packed, pad)
    nb = (T + pad) // blk
    qpos = torch.arange(S, device=q_nope.device)
    dev = q_nope.device
    m = torch.full((B, H, S), -torch.inf, device=dev)
    l = torch.zeros((B, H, S), device=dev)
    acc = torch.zeros((B, H, S, hd), device=dev)
    for c in range(nb):
        start = c * blk
        lat_c = packed[:, start:start + blk]         # [B, blk, lo + r]
        kvex = proj(lat_c[..., :lo], wkv_b.to(q_nope.dtype))
        k_nope_c, v_c = kvex[..., :hd], kvex[..., hd:]
        s = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope_c)
             + torch.einsum("bshk,btk->bhst", q_rope, lat_c[..., lo:])
             ).float() * scale
        kpos = start + torch.arange(blk, device=dev)
        dead = kpos[None, :] >= T
        if causal:
            dead = dead | (kpos[None, :] > qpos[:, None])
        s = torch.where(dead, NEG, s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p_ = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthk->bhsk", p_.to(q_nope.dtype), v_c).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)
