"""Batched LM serving engine: continuous-batching decode over a static
slot pool, the port of ``repro.serve.engine``.

Slots hold independent requests; a finished slot is refilled from the
queue.  Shapes stay static ([B] slots, length-T caches, updated in
place).  A prompt is teacher-forced through the decode path one token a
step.  Greedy decoding takes the argmax of the host logits, as the
reference does, so the two engines emit the same tokens on the same
parameters.  Temperature sampling draws Gumbel noise from a seeded
``torch.Generator``: the same distribution as ``jax.random.categorical``,
never the same draws.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Params, forward_decode, init_caches


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # prompt tokens not yet teacher-forced through the decode path;
    # owned by the engine from admission (_fill_slots) to end of prefill
    _pending: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Params,
                 batch_slots: int = 4, max_len: int = 128,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        held = params["embed"].device
        if held.type != self.device.type:
            raise ValueError(f"the parameters are on {held}, the engine "
                             f"serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.T = max_len
        self.temperature = temperature
        self.caches = init_caches(cfg, self.B, self.T, device=self.device)
        self.pos = np.zeros(self.B, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: Deque[Request] = collections.deque()
        self.generator = torch.Generator().manual_seed(seed)

    def submit(self, req: Request) -> None:
        if not req.prompt:
            # step() seeds decode from prompt[-1]; an empty prompt has no
            # seed token, so it is rejected at admission
            raise ValueError(f"request {req.rid}: empty prompt "
                             "(decode needs >= 1 seed token)")
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for b in range(self.B):
            if self.slot_req[b] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[b] = req
                self.pos[b] = 0
                # the prompt is consumed token by token (teacher-forced
                # prefill through the decode path)
                req._pending = list(req.prompt)

    def _sample(self, logits: np.ndarray) -> int:
        if self.temperature > 0:
            u = torch.rand(logits.shape, generator=self.generator,
                           dtype=torch.float64).numpy()
            gumbel = -np.log(-np.log(np.clip(u, 1e-300, 1.0)))
            return int(np.argmax(logits / self.temperature + gumbel))
        return int(logits.argmax())

    def step(self) -> None:
        """One global decode step across all active slots."""
        self._fill_slots()
        tokens = np.zeros(self.B, np.int64)
        for b, req in enumerate(self.slot_req):
            if req is None:
                continue
            if req._pending:
                tokens[b] = req._pending[0]
            elif req.out:
                tokens[b] = req.out[-1]
            else:
                tokens[b] = req.prompt[-1]
        logits, self.caches = forward_decode(
            self.cfg, self.params, self.caches,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.pos).to(self.device))
        logits = logits.float().cpu().numpy()
        for b, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.pos[b] += 1
            if req._pending:
                req._pending.pop(0)
                if req._pending:
                    continue  # still prefilling
            req.out.append(self._sample(logits[b]))
            if len(req.out) >= req.max_new or self.pos[b] >= self.T - 1:
                req.done = True
                self.slot_req[b] = None

    def run(self, max_steps: int = 10_000) -> int:
        """Step until the queue and the slots are empty; returns the
        number of steps taken."""
        steps = 0
        while (self.queue or any(s is not None for s in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps
