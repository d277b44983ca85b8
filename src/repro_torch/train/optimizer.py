"""AdamW with the reference's ZeRO-1 moment specs, the port of
``repro.train.optimizer``.

The moments are fp32 ``Params`` trees that mirror the parameters.  The
update runs leaf by leaf and in place (parameters and moments), with the
reference's arithmetic: a global-norm clip in fp32, the bias
corrections, the fp32 update cast back to each parameter's dtype.  The
reference shards the moments like their parameters plus the DP axes on
the first free dim (ZeRO-1); ``zero1_specs`` and ``state_specs`` state
that layout, which the port, on one card, does not place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.model import Params
from repro_torch.models.sharding import data_axes, leaf_shapes


class AdamWState(NamedTuple):
    step: Any   # int32 scalar tensor
    mu: Any     # fp32 tree mirroring the parameters
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_ratio``, in fp32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params: Params) -> AdamWState:
    """Step 0 and fp32 zero moments on the parameters' device."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = next(params.parameters()).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      params.map(f32), params.map(f32))


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: AdamWState) -> Tuple[Params, AdamWState]:
    """One AdamW step: ``params`` and the moments updated in place and
    returned with the new step count."""
    leaves = list(params.parameters())
    gs = list(grads.parameters())
    mus, nus = list(state.mu.parameters()), list(state.nu.parameters())
    if not len(leaves) == len(gs) == len(mus) == len(nus):
        raise ValueError("apply_update: the trees differ in leaf count")
    # global-norm clip (fp32)
    gsq = sum(torch.sum(torch.square(g.float())) for g in gs)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** sf
    b2c = 1.0 - cfg.b2 ** sf
    for p, g, mu, nu in zip(leaves, gs, mus, nus):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        pf = p.float()
        delta.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr * delta)
    return params, AdamWState(step, state.mu, state.nu)


def zero1_specs(param_specs: Dict[str, tuple], params, mesh
                ) -> Dict[str, tuple]:
    """Moment specs: the parameter's spec plus DP sharding on its first
    free dim that the DP size divides.  ``params`` is a ``Params`` tree
    or a mapping of reference leaf paths to stacked shapes."""
    shapes = leaf_shapes(params)
    dp = data_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)

    def one(spec, shape):
        if not dp or len(shape) == 0:
            return spec
        entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
        used = set()
        for e in entries:
            used.update(e if isinstance(e, tuple) else (e,))
        if any(a in used for a in dp):
            return spec  # a DP axis already shards this leaf
        for i, e in enumerate(entries):
            if e is None and shape[i] % dp_size == 0 \
                    and shape[i] >= dp_size:
                entries[i] = dp if len(dp) > 1 else dp[0]
                break
        return tuple(entries)

    return {path: one(spec, shapes[path])
            for path, spec in param_specs.items()}


def state_specs(param_specs: Dict[str, tuple], params, mesh) -> AdamWState:
    """The reference's ``state_shardings`` as specs: the step replicated,
    both moments by ``zero1_specs``."""
    mspecs = zero1_specs(param_specs, params, mesh)
    return AdamWState((), mspecs, mspecs)
