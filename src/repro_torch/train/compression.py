"""Gradient compression with error feedback, the port of
``repro.train.compression``.

int8 block-quantised gradients cut the volume of a slow-link all-reduce
4x (bf16) / 8x (fp32); the quantisation error is carried in a residual
buffer and added back the next step (error feedback).  ``torch.round``
rounds half to even like ``jnp.round``, so ``q``, the scales and the
residual equal the reference's bit for bit.  Trees are ``Params`` or
dicts of tensors (``models/model.py: tree_map``).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.model import tree_map


def quantize_int8(x: torch.Tensor, block: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8 quantisation. Returns (q [nb, block] int8,
    scales [nb] fp32)."""
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype
                    ) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def compress_with_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Quantise (grad + residual); return (dequantised grads, new
    residual).  The returned grads are what the slow-axis all-reduce
    ships; the residual accumulates this step's quantisation error."""
    errors = []

    def one(g, r):
        target = g.float() + r
        q, s = quantize_int8(target)
        deq = dequantize_int8(q, s, g.shape, torch.float32)
        errors.append(target - deq)
        return deq.to(g.dtype)

    new_grads = tree_map(one, grads, residual)
    # tree_map visits the leaves in one order: hand them back in it
    it = iter(errors)
    return new_grads, tree_map(lambda r: next(it), residual)


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
