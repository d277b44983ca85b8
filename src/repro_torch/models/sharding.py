"""Parameter / activation partition rules for the production mesh, the
port of ``repro.models.sharding``.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod.  Megatron-style tensor parallelism over "model"; DP over
("pod", "data"); MoE experts sharded over "model" with the hidden dim of
expert weights additionally sharded over "data" (ZeRO-3 storage).

A spec is a plain tuple with one entry per dim, as ``tuple()`` of the
reference's ``PartitionSpec``: ``None``, an axis name, or a tuple of
names.  Specs are keyed by the reference's leaf paths
(``"blocks/attn/wq"``) and sized for its stacked ``[L, ...]`` leaves, so
a stacked group's leading layer dim is unsharded; where the port holds
one tree a layer, a layer's leaf takes the stacked spec without its
first entry.  The reference's ``param_shardings`` has no counterpart:
the port places no tensor across devices.  GSPMD placement does not
change values, so on one card these rules describe the reference's
layout and move no number; the one mesh-dependent result is
``moe_dispatch``'s, where each shard sizes its own capacity.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

from repro_torch.models.model import Params, stacked_shapes

Spec = Tuple[Any, ...]

# leaf name -> spec of its trailing dims; leading layer-stack dims are
# unsharded
_RULES: Dict[str, Tuple] = {
    # attention (column-parallel QKV, row-parallel out)
    "wq": (None, "model", None),
    "wk": (None, "model", None),
    "wv": (None, "model", None),
    "wo": ("model", None, None),
    "bq": ("model", None),
    "bk": ("model", None),
    "bv": ("model", None),
    # MLA
    "wq_a": (None, "model"),
    "wq_b": (None, "model", None),
    "wkv_a": (None, None),
    "wkv_b": (None, "model", None),
    "q_norm": (None,),
    "kv_norm": (None,),
    # dense mlp
    "wg": (None, "model"),
    "wu": (None, "model"),
    "wd": ("model", None),
    "wi": (None, "model"),
    "bi": ("model",),
    # mamba
    "in_proj": (None, "model"),
    "out_proj": ("model", None),
    "conv_w": (None, "model"),
    "A_log": ("model",),
    "D": ("model",),
    "dt_bias": ("model",),
    "norm": ("model",),
    # embeddings
    "embed": ("model", None),
    "unembed": (None, "model"),
    "enc_pos": (None, None),
    "dec_pos": (None, None),
}

# expert-weight overrides (leaf names inside a "moe" subtree): E over
# "model", hidden dim over "data" (gathered at use: ZeRO-3 for experts)
_MOE_RULES: Dict[str, Tuple] = {
    "router": (None, None),
    "wg": ("model", None, "data"),
    "wu": ("model", None, "data"),
    "wd": ("model", "data", None),
    "shared_wg": (None, "model"),
    "shared_wu": (None, "model"),
    "shared_wd": ("model", None),
}


def _spec(*entries) -> Spec:
    """A spec as ``tuple(PartitionSpec(*entries))``: a one-name tuple
    entry becomes the name, an empty one ``None``."""
    def one(e):
        if isinstance(e, tuple) and len(e) < 2:
            return e[0] if e else None
        return e
    return tuple(one(e) for e in entries)


def leaf_shapes(params) -> Mapping[str, Tuple[int, ...]]:
    """{reference leaf path: stacked shape} of a ``Params`` tree, or the
    mapping itself."""
    return stacked_shapes(params) if isinstance(params, Params) else params


def _spec_for(path: str, ndim: int) -> Spec:
    names = path.split("/")
    leaf = names[-1]
    in_moe = "moe" in names[:-1]
    rules = _MOE_RULES if (in_moe and leaf in _MOE_RULES) else _RULES
    rule = rules.get(leaf)
    if rule is None:
        return ()  # norms, scalars: replicated
    if len(rule) < ndim:  # leading layer-stack dim(s): unsharded
        rule = (None,) * (ndim - len(rule)) + rule
    elif len(rule) > ndim:
        rule = rule[-ndim:] if ndim else ()
    return _spec(*rule)


def param_specs(params) -> Dict[str, Spec]:
    """{reference leaf path: spec} for a ``Params`` tree or a mapping of
    reference leaf paths to stacked shapes."""
    return {path: _spec_for(path, len(shape))
            for path, shape in leaf_shapes(params).items()}


def _valid(sp: Spec, shape, mesh) -> Spec:
    """Clear axes that do not divide the corresponding dim."""
    out = []
    for dim, ax in zip(shape, tuple(sp) + (None,) * len(shape)):
        if ax is None:
            out.append(None)
            continue
        size = mesh.shape[ax] if isinstance(ax, str) else 1
        out.append(ax if dim % size == 0 and dim >= size else None)
    return _spec(*out)


def valid_param_specs(params, mesh) -> Dict[str, Spec]:
    """Partition specs with non-dividing axes cleared for ``mesh``."""
    shapes = leaf_shapes(params)
    return {path: _valid(sp, shapes[path], mesh)
            for path, sp in param_specs(shapes).items()}


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a leaf of ``shape`` under ``spec`` on
    ``mesh`` (a ``launch/mesh.py: Mesh``): each dim divided by the sizes
    of the axes its entry names, the reference's
    ``NamedSharding(mesh, P(*spec)).shard_shape(shape)``.  A dim that
    its axes do not divide raises ``ValueError``, as there."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        names = () if ax is None else (ax,) if isinstance(ax, str) else ax
        size = math.prod(mesh.shape[a] for a in names)
        if dim % size:
            raise ValueError(f"dim {i} of shape {tuple(shape)} is not "
                             f"divisible by {size}, the size of {ax!r} "
                             f"in spec {spec}")
        out.append(dim // size)
    return tuple(out)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh) -> Spec:
    return _spec(data_axes(mesh))


def cache_spec(mesh) -> Spec:
    """KV caches: batch over DP axes, heads over model."""
    return _spec(None, data_axes(mesh), None, "model", None)


def activation_spec(mesh) -> Spec:
    return _spec(data_axes(mesh), None, None)
