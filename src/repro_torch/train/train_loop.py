"""Training loop, the port of ``repro.train.train_loop``: the train step
(gradient accumulation, per-layer remat'd model, AdamW), auto-resume and
checkpoints in the reference's format.

The step runs eagerly on the parameters' device: autograd in place of
``jax.value_and_grad``, the AdamW update in place.  ``setup_sharded``
computes the reference's partition specs for a mesh and hands back the
``MeshContext`` that ``moe_dispatch`` reads; the tensors themselves stay
on one device (``models/sharding.py`` says why that moves no number).
The reference's ``TrainConfig.compress_pod_grads`` is left out: its
train step never reads it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import sharding as shd
from repro_torch.models.model import (MeshContext, Params, forward_train,
                                      init_params)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         apply_update, init_state,
                                         state_specs)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1             # grad accumulation
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10


def make_loss_fn(cfg: ModelConfig, mesh_ctx: Optional[MeshContext] = None):
    def loss_fn(params, batch):
        return forward_train(cfg, params, batch, mesh_ctx)
    return loss_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    mesh_ctx: Optional[MeshContext] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and the moments are updated in place.  With
    ``microbatches > 1`` the batch splits along its first dim and the
    grads add into fp32 zeros in microbatch order; loss and grads are
    divided by the count."""
    loss_fn = make_loss_fn(cfg, mesh_ctx)

    def value_and_grad(leaves, params, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def train_step(params: Params, opt_state: AdamWState, batch: Dict):
        params.requires_grad_(True)
        leaves = list(params.parameters())
        mb = tc.microbatches
        if mb > 1:
            micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            l_acc = torch.zeros((), dtype=torch.float32,
                                device=leaves[0].device)
            for i in range(mb):
                loss, g = value_and_grad(leaves, params,
                                         {k: v[i] for k, v in micro.items()})
                for a, b in zip(g_acc, g):
                    a.add_(b)
                del g  # before the next microbatch's grads exist
                l_acc = l_acc + loss
            grads = [g.div_(mb) for g in g_acc]
            loss = l_acc / mb
        else:
            loss, grads = value_and_grad(leaves, params, batch)
        it = iter(grads)
        grads = params.map(lambda p: next(it))
        new_params, new_state = apply_update(tc.opt, params, grads,
                                             opt_state)
        return new_params, new_state, {"loss": loss, "step": new_state.step}

    return train_step


def setup_sharded(cfg: ModelConfig, mesh, tc: TrainConfig,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None):
    """Parameters (seed 0 on ``device`` unless ``generator`` is given),
    optimizer state, the step and the ``MeshContext`` (the mesh's DP
    axes, ``("model",)`` as the expert axes), and the reference's specs
    for this mesh: ``{"params": ..., "opt": AdamWState}``."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    specs = shd.valid_param_specs(params, mesh)
    opt_state = init_state(params)
    mesh_ctx = MeshContext(mesh, shd.data_axes(mesh), ("model",))
    step = make_train_step(cfg, tc, mesh_ctx)
    return params, opt_state, step, mesh_ctx, {
        "params": specs, "opt": state_specs(specs, params, mesh)}


def _on(batch: Dict, device: torch.device) -> Dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train(cfg: ModelConfig, tc: TrainConfig, data_iter, num_steps: int,
          mesh=None, log: Callable = print, device: DeviceLike = None
          ) -> Dict[str, Any]:
    """Host loop with auto-resume from the newest valid checkpoint; the
    parameters are drawn from seed 0 on ``device`` (the card unless the
    CPU is named)."""
    device = resolve_device(device)
    if mesh is not None:
        params, opt_state, step_fn, _, _ = setup_sharded(cfg, mesh, tc,
                                                         device=device)
    else:
        params = init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        opt_state = init_state(params)
        step_fn = make_train_step(cfg, tc)

    start = 0
    if tc.ckpt_dir:
        latest = ckpt_lib.latest_step(tc.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(tc.ckpt_dir, latest,
                                     {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = latest
            log(f"[train] resumed from step {latest}")

    losses = []
    t0 = time.time()
    for i in range(start, num_steps):
        batch = _on(next(data_iter), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % tc.log_every == 0 or i == num_steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            log(f"[train] step {i + 1} loss {loss:.4f} "
                f"({(time.time() - t0) / max(i + 1 - start, 1):.3f}s/step)")
        if tc.ckpt_dir and ((i + 1) % tc.ckpt_every == 0
                            or i == num_steps - 1):
            ckpt_lib.save(tc.ckpt_dir, i + 1,
                          {"params": params, "opt": opt_state})
    return {"params": params, "opt_state": opt_state, "losses": losses}
