"""Carry trees between the reference and the port, value for value, in
both directions.

The reference's parameters, optimizer state and caches are nested numpy
arrays (``jax.tree.map(np.asarray, tree)``) with every layer group
stacked into ``[L, ...]`` leaves; the port holds a ``Params`` tree with
one tree a layer.  bfloat16 arrays arrive as numpy's ``bfloat16``
extension dtype (``ml_dtypes``) and are reinterpreted bit for bit; numpy
itself has no bfloat16, so the port hands them back as their raw
``uint16`` bits, which is how the checkpoint format
(``train/checkpoint.py``) stores them too.
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
from repro_torch.train.optimizer import AdamWState

_CACHES = {c.__name__: c for c in (KVCache, QuantKVCache, MLACache,
                                   SSMState)}


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy copy on the host; bfloat16 as its ``uint16``
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().copy()


def _split_layers(tree: Dict[str, Any]):
    """A stacked group ({name: [L, ...]}) -> a list of L per-layer trees."""
    def leaf(v):
        return v if isinstance(v, torch.Tensor) else np.asarray(v)

    def depth(t):
        v = next(iter(t.values()))
        return depth(v) if isinstance(v, dict) else leaf(v).shape[0]

    def take(t, i):
        return {k: take(v, i) if isinstance(v, dict) else leaf(v)[i]
                for k, v in t.items()}
    return [take(tree, i) for i in range(depth(tree))]


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_stacked(tree: Dict[str, Any], device: torch.device
                        ) -> Params:
    """A tree in the reference's layout (numpy arrays or tensors, stacked
    groups) as the port's ``Params`` on ``device``: each stacked group
    split into one tree a layer."""
    out = {k: _split_layers(v) if k in STACKED else v
           for k, v in tree.items()}
    return Params(_to_tensors(out, device))


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device: DeviceLike = None) -> Params:
    """The reference's ``init_params`` tree (numpy leaves) as the port's
    ``Params`` on ``device``: each stacked group split into one tree a
    layer; ``shared_attn`` and the top-level leaves as they are."""
    params = params_from_stacked(tree, resolve_device(device))
    layers = sum(len(params[k]) for k in params.keys()
                 if k in STACKED and k != "enc_blocks")
    if layers != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the tree holds {layers} layers, "
                         f"the config {cfg.num_layers}")
    return params


def stacked(params: Params) -> Dict[str, Any]:
    """The reference's layout of a ``Params`` tree, as tensors: each
    per-layer group stacked into ``[L, ...]`` leaves (a copy), every
    other leaf as it is."""
    def tree(node):
        return {k: tree(node[k]) if isinstance(node[k], Params)
                else node[k].detach() for k in node.keys()}

    def stack(layers):
        trees = [tree(layer) for layer in layers]

        def join(parts):
            if isinstance(parts[0], dict):
                return {k: join([p[k] for p in parts]) for k in parts[0]}
            return torch.stack(parts)
        return join(trees)
    return {k: stack(params[k]) if k in STACKED else
            (tree(params[k]) if isinstance(params[k], Params)
             else params[k].detach())
            for k in params.keys()}


def params_to_reference(params: Params) -> Dict[str, Any]:
    """The inverse of ``params_from_reference``: numpy leaves on the host,
    stacked ``[L, ...]``; bfloat16 leaves as their ``uint16`` bits."""
    return _numpy(stacked(params))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return to_numpy(tree)


def opt_state_to_reference(state: AdamWState) -> AdamWState:
    """The port's AdamW state as the reference's: the step an int32
    scalar, the fp32 moments numpy trees stacked ``[L, ...]``."""
    return AdamWState(to_numpy(state.step).astype(np.int32),
                      params_to_reference(state.mu),
                      params_to_reference(state.nu))


def opt_state_from_reference(state, device: DeviceLike = None
                             ) -> AdamWState:
    """The reference's ``AdamWState`` (or any ``(step, mu, nu)`` with
    numpy leaves) as the port's on ``device``."""
    device = resolve_device(device)
    step, mu, nu = state
    return AdamWState(_tensor(np.asarray(step, np.int32), device),
                      params_from_stacked(mu, device),
                      params_from_stacked(nu, device))


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
