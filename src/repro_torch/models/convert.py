"""Carry the reference's trees into the port: parameters and caches as
nested numpy arrays (``jax.tree.map(np.asarray, tree)``) become the port's
``Params`` and cache tensors, value for value.  bfloat16 arrays arrive as
numpy's ``bfloat16`` extension dtype and are reinterpreted bit for bit.

"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import KVCache, MLACache, QuantKVCache
from repro_torch.models.model import STACKED, Params
from repro_torch.models.ssm import SSMState

_CACHES = {c.__name__: c for c in (KVCache, QuantKVCache, MLACache,
                                   SSMState)}


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _split_layers(tree: Dict[str, Any]):
    """A stacked group ({name: [L, ...]}) -> a list of L per-layer trees."""
    def depth(t):
        v = next(iter(t.values()))
        return depth(v) if isinstance(v, dict) else np.asarray(v).shape[0]

    def take(t, i):
        return {k: take(v, i) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in t.items()}
    return [take(tree, i) for i in range(depth(tree))]


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device: DeviceLike = None) -> Params:
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    ``Params`` on ``device``: each stacked group split into one tree a
    layer; ``shared_attn`` and the top-level leaves as they are."""
    device = resolve_device(device)
    out = {k: _split_layers(v) if k in STACKED else v
           for k, v in tree.items()}
    layers = sum(len(v) for k, v in out.items()
                 if k in STACKED and k != "enc_blocks")
    if layers != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the tree holds {layers} layers, "
                         f"the config {cfg.num_layers}")
    return Params(_to_tensors(out, device))


def caches_from_reference(caches, device: DeviceLike = None):
    """The reference's cache tree (numpy leaves; ``KVCache``,
    ``QuantKVCache``, ``MLACache``, ``SSMState`` or dicts of them) as the
    port's, so that decode can be compared from mid-stream."""
    device = resolve_device(device)

    def conv(c):
        if isinstance(c, dict):
            return {k: conv(v) for k, v in c.items()}
        if isinstance(c, tuple) and type(c).__name__ in _CACHES:
            return _CACHES[type(c).__name__](
                *(_tensor(x, device) for x in c))
        return _tensor(c, device)
    return conv(caches)
