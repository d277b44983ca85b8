"""Input/state specs per (architecture x shape cell) and step builders,
the port of ``repro.launch.shapes``.

Every cell is a (kind, seq, batch) triple from the assignment:
    train_4k     train_step   seq 4096,    global_batch 256
    prefill_32k  serve prefill seq 32768,  global_batch 32
    decode_32k   serve_step   1 new token, KV 32768, global_batch 128
    long_500k    serve_step   1 new token, state 524288, global_batch 1
                 (sub-quadratic archs only — full-attention archs are
                 skipped per DESIGN.md and recorded as such)

Every tensor lives on the ``meta`` device: shapes and dtypes, no
storage, so a cell of a 400B-parameter model allocates nothing.  Specs
follow ``models/sharding.py``'s rules with divisibility-aware fallbacks;
where the reference builds ``NamedSharding``s the port gives spec tuples
on a ``launch/mesh.py: Mesh`` (``models/sharding.py: shard_shape`` gives
a leaf's per-device shape).  A cell may also be named by its own
``{"kind", "seq", "batch"}`` triple instead of a ``SHAPES`` id.

The reference's ``probe_configs`` has no counterpart.  XLA's cost
analysis counts a scanned layer once, so the reference compiles two
shallow probes and extrapolates to the full depth; the port's layers are
Python loops run eagerly, and the dry-run's counter
(``launch/roofline.py: cost_summary``) sees every layer of the
full-depth step.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.model import (MeshContext, Params, forward_decode,
                                      forward_prefill, init_caches,
                                      init_params, stacked_leaves)
from repro_torch.train.optimizer import init_state, state_specs
from repro_torch.train.train_loop import TrainConfig, make_train_step

META = torch.device("meta")

SHAPES: Dict[str, Dict] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

Shape = Union[str, Mapping[str, Any]]


def shape_info(shape: Shape) -> Dict:
    """A cell's ``{"kind", "seq", "batch"}``: a ``SHAPES`` id, or the
    triple itself."""
    return dict(SHAPES[shape] if isinstance(shape, str) else shape)


def cell_supported(cfg: ModelConfig, shape_id: Shape) -> Tuple[bool, str]:
    if shape_id == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 512k-token cache cell skipped "
                       "per spec (sub-quadratic attns only); see DESIGN.md")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _dp(mesh) -> Tuple[str, ...]:
    return shd.data_axes(mesh)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in _dp(mesh))


def batch_sharding(mesh, B: int) -> shd.Spec:
    if B % max(_dp_size(mesh), 1) == 0 and B >= _dp_size(mesh):
        return shd.batch_spec(mesh)
    return ()


def _generic_sharding(shape, mesh, B: int,
                      mode: str = "feature") -> shd.Spec:
    """Caches/stubs: batch dim over DP (if divisible), plus 'model' on
    either the last divisible feature dim (mode="feature") or the
    sequence dim (mode="sequence", flash-decoding style length split —
    the reference's fix for KV-head counts below the TP degree)."""
    dp = _dp(mesh)
    dsz = _dp_size(mesh)
    msz = mesh.shape["model"]
    ndim = len(shape)
    spec = [None] * ndim
    for i, d in enumerate(shape):
        if d == B and d % dsz == 0 and d >= dsz:
            spec[i] = dp if len(dp) > 1 else dp[0]
            break
    order = range(ndim - 1, -1, -1)
    if mode == "sequence" and ndim >= 4:
        order = [2] + [i for i in range(ndim - 1, -1, -1) if i != 2]
    for i in order:
        if spec[i] is None and shape[i] % msz == 0 \
                and shape[i] >= msz and i != 0:
            spec[i] = "model"
            break
    return tuple(spec)


def map_tree(fn, tree):
    """``fn`` over the tensor leaves of a tree of dicts, NamedTuples,
    lists and tuples (caches, batches), keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def leaf_table(tree, prefix: str = "") -> Dict[str, Tuple[Tuple[int, ...],
                                                          torch.dtype]]:
    """``{path: (shape, dtype)}`` of every tensor leaf.  A ``Params``
    tree gives the reference's stacked leaves (``"blocks/attn/wq"`` with
    its leading layer dim); dict keys, NamedTuple fields and sequence
    indices join with ``/`` as the reference's tree paths do."""
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if isinstance(tree, Params):
        for path, (shape, dtype) in stacked_leaves(tree).items():
            out[prefix + path] = (shape, dtype)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaf_table(v, f"{prefix}{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            out.update(leaf_table(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaf_table(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = (tuple(tree.shape), tree.dtype)
    elif tree is not None:
        raise TypeError(f"leaf_table: {type(tree).__name__} at {prefix!r}")
    return out


def spec_table(specs, prefix: str = "") -> Dict[str, Any]:
    """``{path: spec}`` of a spec tree parallel to ``leaf_table``'s: a
    tuple of axis entries is one leaf's spec; a dict (a parameter spec
    dict keyed by stacked paths among them), a NamedTuple or another
    tuple is a node; ``None`` (no spec: the placement chooses) maps to
    ``None`` and covers the subtree under it."""
    out: Dict[str, Any] = {}
    if specs is None or _is_spec(specs):
        out[prefix.rstrip("/")] = None if specs is None else tuple(specs)
    elif isinstance(specs, dict):
        for k, v in specs.items():
            out.update(spec_table(v, f"{prefix}{k}/"))
    elif isinstance(specs, tuple) and hasattr(specs, "_fields"):
        for k, v in zip(specs._fields, specs):
            out.update(spec_table(v, f"{prefix}{k}/"))
    elif isinstance(specs, (list, tuple)):
        for i, v in enumerate(specs):
            out.update(spec_table(v, f"{prefix}{i}/"))
    else:
        raise TypeError(f"spec_table: {type(specs).__name__} at {prefix!r}")
    return out


def _is_spec(x) -> bool:
    """A plain tuple of axis entries (None, a name, a tuple of names)."""
    def entry(e):
        return e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(entry(e) for e in x))


def model_inputs(cfg: ModelConfig, shape_id: Shape, mesh):
    """Returns (input tree of meta tensors, matching spec tree)."""
    info = shape_info(shape_id)
    B, S = info["batch"], info["seq"]
    bsh = batch_sharding(mesh, B)
    if info["kind"] in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        shard = {"tokens": bsh, "labels": bsh}
        for front, key in (("patch", "patch_embeds"), ("audio", "frames")):
            if cfg.frontend == front:
                batch[key] = _meta((B, cfg.frontend_len, cfg.d_model),
                                   torch.bfloat16)
                shard[key] = _generic_sharding(batch[key].shape, mesh, B)
        return batch, shard
    # decode
    caches = init_caches(cfg, B, S, device=META)
    cshard = map_tree(
        lambda leaf: _generic_sharding(leaf.shape, mesh, B,
                                       mode=cfg.cache_shard), caches)
    tokens = _meta((B,), torch.int32)
    pos = _meta((B,), torch.int32)
    return {"caches": caches, "tokens": tokens, "pos": pos}, \
           {"caches": cshard, "tokens": bsh, "pos": bsh}


@functools.lru_cache(maxsize=None)
def _meta_params(cfg: ModelConfig) -> Params:
    # a meta tree holds no storage, so one tree a config serves every
    # cell (a step's in-place updates of it change nothing)
    return init_params(cfg, None, META)


@functools.lru_cache(maxsize=None)
def _meta_state(cfg: ModelConfig):
    return init_state(_meta_params(cfg))


def params_and_shardings(cfg: ModelConfig, mesh):
    """(meta parameter tree, ``{stacked path: spec}`` for ``mesh``)."""
    params = _meta_params(cfg)
    return params, shd.valid_param_specs(params, mesh)


def build_step(cfg: ModelConfig, shape_id: Shape, mesh,
               donate_caches: bool = False):
    """Returns (fn, meta argument tuple, input spec tuple, output specs[,
    donate]).  ``donate_caches`` returns the decode caches' argument
    index, which the reference donates (its memory record's
    ``alias_bytes``).  The specs are trees parallel to the arguments and
    outputs (``spec_table`` flattens them); ``None`` where the reference
    leaves an output's sharding to XLA."""
    info = shape_info(shape_id)
    mesh_ctx = MeshContext(mesh, _dp(mesh), ("model",))
    params, pspecs = params_and_shardings(cfg, mesh)
    inputs, ispecs = model_inputs(cfg, shape_id, mesh)

    if info["kind"] == "train":
        step = make_train_step(cfg, TrainConfig(), mesh_ctx)
        state = _meta_state(cfg)
        sspecs = state_specs(pspecs, params, mesh)
        args = (params, state, inputs)
        in_sh = (pspecs, sspecs, ispecs)
        out_sh = (pspecs, sspecs, None)
        return step, args, in_sh, out_sh
    if info["kind"] == "prefill":
        def step(params, batch):
            return forward_prefill(cfg, params, batch, mesh_ctx)
        return step, (params, inputs), (pspecs, ispecs), None
    # decode
    def step(params, caches, tokens, pos):
        return forward_decode(cfg, params, caches, tokens, pos, mesh_ctx)
    args = (params, inputs["caches"], inputs["tokens"], inputs["pos"])
    in_sh = (pspecs, ispecs["caches"], ispecs["tokens"], ispecs["pos"])
    logits_sh = None
    if cfg.shard_logits and cfg.vocab_size % mesh.shape["model"] == 0:
        # serving keeps logits vocab-sharded (sample via sharded argmax)
        B = info["batch"]
        bdim = shd.batch_spec(mesh)[0] \
            if (B % _dp_size(mesh) == 0 and B >= _dp_size(mesh)) else None
        logits_sh = (bdim, "model")
    out_sh = (logits_sh, ispecs["caches"])
    if donate_caches:
        return step, args, in_sh, out_sh, (1,)
    return step, args, in_sh, out_sh


def shard_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree under its spec tree: each leaf's
    ``shard_shape`` times its element size; a leaf whose spec is
    ``None`` counts whole."""
    sp = spec_table(specs)
    total = 0
    for path, (shape, dtype) in leaf_table(tree).items():
        spec = sp[path] if path in sp else _enclosing(sp, path)
        per = shape if spec is None else shd.shard_shape(shape, spec, mesh)
        total += math.prod(per) * dtype.itemsize
    return total


def _enclosing(sp: Dict[str, Any], path: str):
    """The spec of the nearest enclosing node that has one (an output
    subtree left to the placement, ``None``)."""
    parts = path.split("/")
    for i in range(len(parts) - 1, -1, -1):
        key = "/".join(parts[:i])
        if key in sp:
            return sp[key]
    raise KeyError(f"no spec for {path!r}")

