"""The benchmark's frozen graph generators, drawn on the device from a seed.

The distributions are those of ``repro_torch/data/generators.py``
(GNM and Graph500's RMAT), copied here so that a change to the program
cannot change the benchmark's inputs.  Each family sits in a module of
its own, ``gen/<family>.py``, found by the configuration's ``family``
(``gnm``, ``rmat``), with ``draw(config, generator)`` and
``shrink(config, factor)``.  Every family ends in ``finish``: canonical ``u < v``, self-loops dropped, parallel edges
merged, the edges in ``(u, v)`` order, and weights uniform in
``[1, 255)``, float32, one per kept edge.

The draws come from one ``torch.Generator`` on the target device in a
few large calls, so a graph of 2^23 edges is made on the card in
milliseconds.  The same seed on the same device gives the same graph;
the CPU and the card draw different (equally distributed) graphs.
"""
from __future__ import annotations

import dataclasses

import torch

import msfbench

WEIGHT_LO, WEIGHT_HI = 1.0, 255.0


@dataclasses.dataclass(frozen=True)
class Graph:
    """One undirected graph on a device: int32 ``u < v``, float32 ``w``."""

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    n: int

    @property
    def m(self) -> int:
        return int(self.u.shape[0])


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int >= 0 below
    2^64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def finish(u: torch.Tensor, v: torch.Tensor, n: int, gen: torch.Generator,
            keep: int | None = None) -> Graph:
    lo = torch.minimum(u, v)
    hi = torch.maximum(u, v)
    key = (lo * n + hi)[lo != hi]
    key = torch.unique(key)  # sorted: the edges in (u, v) order
    if keep is not None:
        key = key[:keep]
    w = torch.rand(key.shape[0], generator=gen, device=key.device,
                   dtype=torch.float32)
    w = w * (WEIGHT_HI - WEIGHT_LO) + WEIGHT_LO
    return Graph(u=(key // n).to(torch.int32), v=(key % n).to(torch.int32),
                 w=w.contiguous(), n=n)


def make(config: dict, seed: int, device: torch.device) -> Graph:
    """The graph of ``config`` for ``seed``: its ``family`` names the
    module ``gen/<family>.py`` that draws it."""
    family = msfbench.by_name("gen", config["family"])
    return family.draw(config, generator(seed, device))


def shrink(config: dict, factor: int) -> dict:
    """The configuration's family at about ``factor`` times fewer
    vertices and edges (the warm-up's graph)."""
    if factor <= 1:
        return dict(config)
    return msfbench.by_name("gen", config["family"]).shrink(config, factor)
