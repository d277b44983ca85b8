"""Model assembly: init / train-forward / prefill / decode per family, the
port of ``repro.models.model``.

The parameters are one ``Params`` module tree with the reference's names.
Where the reference stacks a layer group into ``[L, ...]`` leaves and
scans it, the port holds an ``nn.ModuleList`` of per-layer trees and
loops over it in Python.  The caches keep the reference's stacked
``[L, ...]`` layout and are updated in place, layer by layer, through
views.

Families:
  dense / vlm      — [ln, GQA, ln, SwiGLU] x L  (vlm: patch-prefix stub)
  moe              — GQA or MLA + (routed experts | dense) per the layer
                     pattern
  ssm              — Mamba2 mixer x L
  hybrid (zamba2)  — Mamba2 backbone + one *shared-weight* attention block
                     applied every ``shared_attn_every`` layers
  audio (whisper)  — encoder (bidirectional, learned pos, GELU) + decoder
                     (causal self-attn + cross-attn); the conv frontend is
                     a stub: the encoder consumes precomputed frame
                     embeddings

``forward_train`` runs every layer under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), where the
reference wraps every layer body in ``jax.checkpoint``: a layer's
activations are recomputed in the backward pass, and with
``cfg.remat_policy == "dots"`` the products without batch dims are kept
(``_remat_policy``).  Remat changes memory, never numbers.  Prefill and
decode run without autograd and without remat.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (KVCache, MLACache, QuantKVCache,
                                       gelu_mlp, gqa_attention, layernorm,
                                       mla_attention, proj, rmsnorm, swiglu)
from repro_torch.models.ssm import SSMState, mamba2_block, ssm_dims

# the reference's stacked layer groups; the port holds one tree a layer
STACKED = ("blocks", "dense_blocks", "moe_blocks", "enc_blocks",
           "dec_blocks")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh that ``moe_apply`` dispatches over: a ``launch/mesh.py:
    Mesh`` description, its data-parallel axes and its expert axes."""
    mesh: Any
    dp_axes: Tuple[str, ...]
    ep_axes: Tuple[str, ...]

    @property
    def ep_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.ep_axes)


class Params(nn.Module):
    """A tree of parameters addressed like the reference's dict:
    ``p["attn"]["wq"]``.  A tensor leaf is an ``nn.Parameter``, a dict a
    ``Params``, a list (one tree a layer) an ``nn.ModuleList``.  Leaves
    are frozen as built; ``requires_grad_(True)`` makes them trainable
    (the train step does so)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, Params(val))
            elif isinstance(val, list):
                self.add_module(name, nn.ModuleList(Params(t) for t in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Params":
        """A frozen tree of the same structure with ``fn`` of each leaf."""
        return tree_map(fn, self)


def stacked_shapes(params: Params) -> Dict[str, Tuple[int, ...]]:
    """{reference leaf path ("blocks/attn/wq"): stacked shape} of a
    ``Params`` tree: a per-layer group's leaves with their leading layer
    dim, as the reference stacks them."""
    return {path: shape for path, (shape, _) in stacked_leaves(params)
            .items()}


def stacked_leaves(params: Params) -> Dict[str, Tuple[Tuple[int, ...],
                                                      torch.dtype]]:
    """``stacked_shapes`` with each leaf's dtype."""
    out = {}

    def walk(node, path, lead):
        for k in node.keys():
            child = node[k]
            key = path + (k,)
            if isinstance(child, nn.ModuleList):
                walk(child[0], key, (len(child),))
            elif isinstance(child, Params):
                walk(child, key, lead)
            else:
                out["/".join(key)] = (lead + tuple(child.shape), child.dtype)
    walk(params, (), ())
    return out


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure, leaf by leaf:
    ``Params`` trees (the result a frozen ``Params``), or dicts and lists
    of tensors (the result of the same kind)."""
    out = _walk(fn, trees)
    return Params(out) if isinstance(trees[0], Params) else out


def _walk(fn, nodes):
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that would keep ``fn`` and what it
    # holds (a step's gradients) alive until the garbage collector runs
    node = nodes[0]
    if isinstance(node, (Params, dict)):
        return {k: _walk(fn, [n[k] for n in nodes]) for k in node.keys()}
    if isinstance(node, (nn.ModuleList, list)):
        return [_walk(fn, list(group)) for group in zip(*nodes)]
    return fn(*nodes)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

class _Init:
    """The reference's initialisers on one generator and device: normal
    draws in fp32 times the scale, cast to the leaf's dtype.  On the
    ``meta`` device a leaf has its shape and dtype and nothing is drawn
    (the reference's ``jax.eval_shape(init_params)``)."""

    def __init__(self, gen: Optional[torch.Generator],
                 device: torch.device):
        self.gen = gen
        self.device = device

    def dense(self, shape, dtype, scale=0.02):
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.gen.device)
        return (scale * x).to(device=self.device, dtype=dtype)

    def const(self, shape, dtype, value):
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _attn_params(cfg: ModelConfig, ini: _Init, dt) -> Dict:
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    p = {
        "wq": ini.dense((D, H, hd), dt),
        "wk": ini.dense((D, KV, hd), dt),
        "wv": ini.dense((D, KV, hd), dt),
        "wo": ini.dense((H, hd, D), dt),
    }
    if cfg.attn_bias:
        p["bq"] = ini.const((H, hd), dt, 0)
        p["bk"] = ini.const((KV, hd), dt, 0)
        p["bv"] = ini.const((KV, hd), dt, 0)
    return p


def _mla_params(cfg: ModelConfig, ini: _Init, dt) -> Dict:
    D, H, hd, r = cfg.d_model, cfg.num_heads, cfg.hd, cfg.rope_head_dim
    lo, qlo = cfg.kv_lora_rank, cfg.q_lora_rank
    return {
        "wq_a": ini.dense((D, qlo), dt),
        "q_norm": ini.const((qlo,), dt, 1),
        "wq_b": ini.dense((qlo, H, hd + r), dt),
        "wkv_a": ini.dense((D, lo + r), dt),
        "kv_norm": ini.const((lo,), dt, 1),
        "wkv_b": ini.dense((lo, H, 2 * hd), dt),
        "wo": ini.dense((H, hd, D), dt),
    }


def _mlp_params(cfg: ModelConfig, ini: _Init, dt) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"wg": ini.dense((D, F), dt), "wu": ini.dense((D, F), dt),
            "wd": ini.dense((F, D), dt)}


def _moe_params(cfg: ModelConfig, ini: _Init, dt) -> Dict:
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": ini.dense((D, E), torch.float32),
        "wg": ini.dense((E, D, Fe), dt),
        "wu": ini.dense((E, D, Fe), dt),
        "wd": ini.dense((E, Fe, D), dt),
    }
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * Fe
        p["shared_wg"] = ini.dense((D, Fs), dt)
        p["shared_wu"] = ini.dense((D, Fs), dt)
        p["shared_wd"] = ini.dense((Fs, D), dt)
    return p


def _mamba_params(cfg: ModelConfig, ini: _Init, dt) -> Dict:
    H, Pd, N = ssm_dims(cfg)
    D = cfg.d_model
    inner = H * Pd
    return {
        "in_proj": ini.dense((D, 2 * inner + 2 * N + H), dt),
        "conv_w": ini.dense((cfg.conv_width, inner + 2 * N), dt, 0.2),
        "dt_bias": ini.const((H,), torch.float32, 0),
        "A_log": ini.const((H,), torch.float32, 0),
        "D": ini.const((H,), dt, 1),
        "norm": ini.const((inner,), dt, 1),
        "out_proj": ini.dense((inner, D), dt),
    }


def _gelu_params(cfg: ModelConfig, ini: _Init, dt) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"wi": ini.dense((D, F), dt), "bi": ini.const((F,), dt, 0),
            "wo": ini.dense((F, D), dt), "bo": ini.const((D,), dt, 0)}


def layer_pattern(cfg: ModelConfig) -> Sequence[str]:
    """Per-layer kind for MoE stacks: 'dense' | 'moe'."""
    if not cfg.is_moe:
        return ["dense"] * cfg.num_layers
    pat = []
    moe_every = cfg.moe_every
    for i in range(cfg.num_layers):
        if i < cfg.first_dense_layers:
            pat.append("dense")
        elif (i - cfg.first_dense_layers) % moe_every == moe_every - 1 \
                or moe_every == 1:
            pat.append("moe")
        else:
            pat.append("dense")
    return pat


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: DeviceLike = None) -> Params:
    """The reference's parameter tree (names, shapes, dtypes and init
    scales: normal 0.02, the embedding 1.0, the conv taps 0.2, norms
    ones, biases zero), drawn from ``generator`` on its own device and
    placed on ``device`` (the card unless the CPU is named).  The draws
    cannot equal ``jax.random``'s; ``convert.params_from_reference``
    carries a reference tree over value for value.

    On ``device="meta"`` the tree holds shapes and dtypes only and
    ``generator`` is neither read nor needed (None is accepted): the
    dry-run's parameters (``launch/shapes.py``)."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        raise ValueError("init_params draws from a generator on every "
                         "device but meta")
    ini = _Init(generator, device)
    dt = cfg.torch_dtype
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    ones = lambda: ini.const((D,), dt, 1)
    params: Dict[str, Any] = {
        "embed": ini.dense((V, D), dt, 1.0),
        "unembed": ini.dense((D, V), dt),
        "final_norm": ones(),
    }
    fam = cfg.family
    if fam in ("dense", "vlm"):
        params["blocks"] = [
            {"ln1": ones(), "ln2": ones(), "attn": _attn_params(cfg, ini, dt),
             "mlp": _mlp_params(cfg, ini, dt)} for _ in range(L)]
    elif fam == "moe":
        pat = layer_pattern(cfg)
        nd = sum(1 for k in pat if k == "dense")
        attn_fn = _mla_params if cfg.kv_lora_rank else _attn_params
        if nd:
            params["dense_blocks"] = [
                {"ln1": ones(), "ln2": ones(), "attn": attn_fn(cfg, ini, dt),
                 "mlp": _mlp_params(cfg, ini, dt)} for _ in range(nd)]
        params["moe_blocks"] = [
            {"ln1": ones(), "ln2": ones(), "attn": attn_fn(cfg, ini, dt),
             "moe": _moe_params(cfg, ini, dt)} for _ in range(L - nd)]
    elif fam in ("ssm", "hybrid"):
        params["blocks"] = [{"ln": ones(), "mixer": _mamba_params(cfg, ini,
                                                                   dt)}
                            for _ in range(L)]
        if fam == "hybrid":
            params["shared_attn"] = {
                "ln1": ones(), "ln2": ones(),
                "attn": _attn_params(cfg, ini, dt),
                "mlp": _mlp_params(cfg, ini, dt)}
    elif fam == "audio":
        params["enc_pos"] = ini.dense((cfg.frontend_len, D), dt)
        # whisper publishes 448 learned positions; the reference enlarges
        # the table to 32k for its decode cells
        params["dec_pos"] = ini.dense((32768, D), dt)
        params["enc_blocks"] = [
            {"ln1": ones(), "ln2": ones(), "attn": _attn_params(cfg, ini, dt),
             "mlp": _gelu_params(cfg, ini, dt)}
            for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = ones()
        params["dec_blocks"] = [
            {"ln1": ones(), "ln_x": ones(), "ln2": ones(),
             "attn": _attn_params(cfg, ini, dt),
             "xattn": _attn_params(cfg, ini, dt),
             "mlp": _gelu_params(cfg, ini, dt)} for _ in range(L)]
    else:
        raise ValueError(fam)
    return Params(params)


# --------------------------------------------------------------------------
# block applications
# --------------------------------------------------------------------------

def _layer(caches, i: int):
    """Layer ``i``'s cache: views into the stacked buffers."""
    return type(caches)(*(t[i] for t in caches))


def _dense_block(cfg, lp, x, positions, cache=None, cache_pos=None):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn = mla_attention if cfg.kv_lora_rank else gqa_attention
    attn_out, _ = attn(cfg, lp["attn"], h, positions, cache=cache,
                       cache_pos=cache_pos)
    if cfg.parallel_block:
        mlp_out = swiglu(h, lp["mlp"]["wg"], lp["mlp"]["wu"],
                         lp["mlp"]["wd"])
        return x + attn_out + mlp_out
    x = x + attn_out
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def _moe_block(cfg, lp, x, positions, mesh_ctx, cache=None, cache_pos=None):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    attn = mla_attention if cfg.kv_lora_rank else gqa_attention
    attn_out, _ = attn(cfg, lp["attn"], h, positions, cache=cache,
                       cache_pos=cache_pos)
    x = x + attn_out
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + moe_lib.moe_apply(cfg, lp["moe"], h2, mesh_ctx)


def _mamba_layer(cfg, lp, x, state):
    h = rmsnorm(x, lp["ln"], cfg.norm_eps)
    out, new_state = mamba2_block(cfg, lp["mixer"], h, state)
    return x + out, new_state


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def _embed(cfg, params, tokens, extras):
    x = params["embed"][tokens].to(cfg.torch_dtype)
    if cfg.frontend == "patch" and extras is not None \
            and "patch_embeds" in extras and tokens.shape[1] > 1:
        fl = cfg.frontend_len
        x = x.clone()
        x[:, :fl] = extras["patch_embeds"].to(x.dtype)
    return x


# the products that ``remat_policy="dots"`` keeps: the reference's
# ``dots_with_no_batch_dims_saveable`` saves the dots without batch dims,
# which reach the dispatcher as these (the projections, the FFNs, the
# router); the batched ones (attention scores and values, the SSM's
# einsums, the expert FFN's ``bmm``) are recomputed, as there
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat_policy(name: str):
    """The checkpoint ``context_fn`` of a remat policy: ``"dots"`` keeps
    the products without batch dims and recomputes the rest, ``"none"``
    keeps only the layer's inputs."""
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _DOTS)
    if name == "none":
        return noop_context_fn
    raise ValueError(f"remat_policy {name!r}")


def _call(remat, fn, *args):
    """One layer: ``fn(*args)``, under per-layer checkpointing when
    ``remat`` is a policy's ``context_fn`` (training), directly when it
    is None (prefill, decode)."""
    if remat is None:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=remat)


def _backbone(cfg, params, x, positions, mesh_ctx, caches=None,
              cache_pos=None, remat=None):
    """Hidden states; with ``caches``, each layer's cache is updated in
    place."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        for i, lp in enumerate(params["blocks"]):
            c = None if caches is None else _layer(caches, i)
            x = _call(remat, _dense_block, cfg, lp, x, positions, c,
                      cache_pos)
    elif fam == "moe":
        x = _moe_backbone(cfg, params, x, positions, mesh_ctx, caches,
                          cache_pos, remat)
    elif fam == "ssm":
        for i, lp in enumerate(params["blocks"]):
            st = None if caches is None else _layer(caches, i)
            x, ns = _call(remat, _mamba_layer, cfg, lp, x, st)
            if ns is not None:
                st.h.copy_(ns.h)
                st.conv.copy_(ns.conv)
    elif fam == "hybrid":
        x = _zamba_backbone(cfg, params, x, positions, caches, cache_pos,
                            remat)
    else:
        raise ValueError(fam)
    return x


def _shared_attn_block(cfg, sp, x, positions, kv=None, cache_pos=None):
    h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    att, _ = gqa_attention(cfg, sp["attn"], h, positions, cache=kv,
                           cache_pos=cache_pos)
    x = x + att
    h2 = rmsnorm(x, sp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, sp["mlp"]["wg"], sp["mlp"]["wu"], sp["mlp"]["wd"])


def _zamba_backbone(cfg, params, x, positions, caches, cache_pos,
                    remat=None):
    """Mamba2 stack with a shared attention block every k layers: the
    shared block's weights are reused at every site, each site has its
    own KV cache."""
    every = cfg.shared_attn_every
    sp = params["shared_attn"]
    site = 0
    for i, lp in enumerate(params["blocks"]):
        st = None if caches is None else _layer(caches["ssm"], i)
        x, ns = _call(remat, _mamba_layer, cfg, lp, x, st)
        if ns is not None:
            st.h.copy_(ns.h)
            st.conv.copy_(ns.conv)
        if every and (i % every == every - 1):
            kv = None if caches is None else _layer(caches["attn"], site)
            x = _call(remat, _shared_attn_block, cfg, sp, x, positions, kv,
                      cache_pos)
            site += 1
    return x


def _moe_backbone(cfg, params, x, positions, mesh_ctx, caches, cache_pos,
                  remat=None):
    """Dense/MoE interleave in layer order.  The reference scans runs of
    one kind (or (dense, moe) pairs for llama4's alternation); either
    way layer ``i`` of kind ``k`` is the next entry of ``k``'s stack."""
    di = mi = 0
    for kind in layer_pattern(cfg):
        if kind == "dense":
            c = None if caches is None else _layer(caches["dense"], di)
            x = _call(remat, _dense_block, cfg, params["dense_blocks"][di],
                      x, positions, c, cache_pos)
            di += 1
        else:
            c = None if caches is None else _layer(caches["moe"], mi)
            x = _call(remat, _moe_block, cfg, params["moe_blocks"][mi], x,
                      positions, mesh_ctx, c, cache_pos)
            mi += 1
    return x


def _ln(x, scale, eps):
    return layernorm(x, scale, torch.zeros_like(scale), eps)


def _whisper_decoder_layer(cfg, lp, h, dpos, enc, cache=None,
                           cache_pos=None):
    hn = _ln(h, lp["ln1"], cfg.norm_eps)
    att, _ = gqa_attention(cfg, lp["attn"], hn, dpos, cache=cache,
                           cache_pos=cache_pos, causal=True, use_rope=False)
    h = h + att
    hn = _ln(h, lp["ln_x"], cfg.norm_eps)
    xatt, _ = gqa_attention(cfg, lp["xattn"], hn, dpos, kv_source=enc,
                            use_rope=False)
    h = h + xatt
    hn = _ln(h, lp["ln2"], cfg.norm_eps)
    return h + gelu_mlp(hn, lp["mlp"]["wi"], lp["mlp"]["bi"],
                        lp["mlp"]["wo"], lp["mlp"]["bo"])


def _whisper_encoder_layer(cfg, lp, h, enc_pos):
    hn = _ln(h, lp["ln1"], cfg.norm_eps)
    att, _ = gqa_attention(cfg, lp["attn"], hn, enc_pos, causal=False,
                           use_rope=False)
    h = h + att
    hn = _ln(h, lp["ln2"], cfg.norm_eps)
    return h + gelu_mlp(hn, lp["mlp"]["wi"], lp["mlp"]["bi"],
                        lp["mlp"]["wo"], lp["mlp"]["bo"])


def _whisper_logits(cfg, params, batch, remat=None):
    frames = batch["frames"].to(cfg.torch_dtype)   # [B, Tf, D] stub
    tokens = batch["tokens"]
    B, S = tokens.shape
    Tf = frames.shape[1]
    enc = frames + params["enc_pos"][None, :Tf].to(frames.dtype)
    enc_pos = torch.arange(Tf, dtype=torch.int32, device=enc.device)[None]
    for lp in params["enc_blocks"]:
        enc = _call(remat, _whisper_encoder_layer, cfg, lp, enc, enc_pos)
    enc = _ln(enc, params["enc_final_norm"], cfg.norm_eps)

    x = params["embed"][tokens].to(cfg.torch_dtype)
    x = x + params["dec_pos"][None, :S].to(x.dtype)
    dpos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    for lp in params["dec_blocks"]:
        x = _call(remat, _whisper_decoder_layer, cfg, lp, x, dpos, enc)
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    return proj(x, params["unembed"])


def forward_train(cfg: ModelConfig, params: Params, batch: Dict,
                  mesh_ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Next-token cross-entropy loss (fp32 log-softmax), averaged over the
    positions whose label is >= 0.  ``batch`` holds ``tokens`` and
    ``labels`` [B, S], and ``patch_embeds`` (vlm) or ``frames`` (audio)
    where the family reads them.  Every layer runs under per-layer
    checkpointing with ``cfg.remat_policy``."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    B, S = tokens.shape
    remat = _remat_policy(cfg.remat_policy)
    if cfg.family == "audio":
        logits = _whisper_logits(cfg, params, batch, remat)
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        x = _embed(cfg, params, tokens, batch)
        x = _backbone(cfg, params, x, positions, mesh_ctx, remat=remat)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = proj(x, params["unembed"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    # a masked label gathers any entry (the reference's -1 wraps to the
    # last); the mask zeroes it
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# --------------------------------------------------------------------------
# serving: cache init, prefill, decode
# --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, B: int, T: int,
                device: DeviceLike = None) -> Any:
    """The reference's cache tree, stacked ``[L, ...]``, zeroed, on
    ``device`` (the card unless the CPU is named)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    KV, hd = cfg.num_kv_heads, cfg.hd
    L = cfg.num_layers

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n):
        if cfg.kv_cache_dtype == "int8":
            return QuantKVCache(zeros((n, B, T, KV, hd), torch.int8),
                                zeros((n, B, T, KV), torch.float32),
                                zeros((n, B, T, KV, hd), torch.int8),
                                zeros((n, B, T, KV), torch.float32))
        return KVCache(zeros((n, B, T, KV, hd)), zeros((n, B, T, KV, hd)))

    def ssm_state():
        Hh, Pd, N = ssm_dims(cfg)
        return SSMState(zeros((L, B, Hh, Pd, N)),
                        zeros((L, B, cfg.conv_width - 1, Hh * Pd + 2 * N)))

    fam = cfg.family
    if fam in ("dense", "vlm"):
        return kv(L)
    if fam == "moe":
        pat = layer_pattern(cfg)
        nd = sum(1 for k in pat if k == "dense")
        if cfg.kv_lora_rank:
            mk = lambda n: MLACache(zeros(
                (n, B, T, cfg.kv_lora_rank + cfg.rope_head_dim)))
        else:
            mk = kv
        out = {"moe": mk(L - nd)}
        if nd:
            out["dense"] = mk(nd)
        return out
    if fam == "ssm":
        return ssm_state()
    if fam == "hybrid":
        every = cfg.shared_attn_every
        sites = sum(1 for i in range(L)
                    if every and i % every == every - 1)
        return {"ssm": ssm_state(), "attn": kv(max(sites, 1))}
    if fam == "audio":
        return {"self": kv(L), "enc": zeros((B, cfg.frontend_len,
                                             cfg.d_model))}
    raise ValueError(fam)


@torch.no_grad()
def forward_decode(cfg: ModelConfig, params: Params, caches: Any,
                   tokens: torch.Tensor, pos: torch.Tensor,
                   mesh_ctx=None) -> Tuple[torch.Tensor, Any]:
    """One decode step. tokens [B] int, pos [B] int (write position).
    Returns (logits [B, V], caches), the caches updated in place."""
    x = params["embed"][tokens][:, None].to(cfg.torch_dtype)  # [B,1,D]
    positions = pos[:, None]

    if cfg.family == "audio":
        enc = caches["enc"]
        x = x + params["dec_pos"][pos][:, None].to(x.dtype)
        for i, lp in enumerate(params["dec_blocks"]):
            x = _whisper_decoder_layer(cfg, lp, x, positions, enc,
                                       _layer(caches["self"], i), pos)
        x = _ln(x, params["final_norm"], cfg.norm_eps)
        return proj(x, params["unembed"])[:, 0], caches

    x = _backbone(cfg, params, x, positions, mesh_ctx, caches=caches,
                  cache_pos=pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return proj(x, params["unembed"])[:, 0], caches


@torch.no_grad()
def forward_prefill(cfg: ModelConfig, params: Params, batch: Dict,
                    mesh_ctx=None) -> torch.Tensor:
    """Prefill: full forward, last-position logits [B, V]."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :]
    if cfg.family == "audio":
        return _whisper_logits(cfg, params, batch)[:, -1]
    x = _embed(cfg, params, tokens, batch)
    x = _backbone(cfg, params, x, positions, mesh_ctx)
    x = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return proj(x, params["unembed"])[:, 0]
