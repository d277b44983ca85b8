"""Graph500's Kronecker (RMAT) generator as
``repro_torch/data/generators.py: rmat`` draws it: ``edgefactor << scale``
endpoint pairs drawn bit by bit, one uniform a bit, its quadrant the
count of the cumulative probabilities ``a, b, c`` (``d = 1 - a - b - c``)
below it; then finished.  Configuration keys: ``scale``, ``edgefactor``,
``abc`` (Graph500's by default)."""
from __future__ import annotations

import torch

from msfbench.gen.graphs import Graph, finish

GRAPH500_ABC = (0.57, 0.19, 0.19)


def rmat(scale: int, m: int, gen: torch.Generator,
         abc=GRAPH500_ABC) -> Graph:
    a, b, c = abc
    dev = gen.device
    u = torch.zeros(m, dtype=torch.int64, device=dev)
    v = torch.zeros(m, dtype=torch.int64, device=dev)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
        quad = ((r > a).long() + (r > a + b).long()
                + (r > a + b + c).long())
        u = (u << 1) | (quad >> 1)
        v = (v << 1) | (quad & 1)
    return finish(u, v, 1 << scale, gen)


def draw(config: dict, gen: torch.Generator) -> Graph:
    scale = int(config["scale"])
    m = int(config["edgefactor"]) << scale
    return rmat(scale, m, gen, tuple(config.get("abc", GRAPH500_ABC)))


def shrink(config: dict, factor: int) -> dict:
    """Fewer vertices and edges by the largest power of two in ``factor``."""
    return {**config, "scale": int(config["scale"])
            - (factor.bit_length() - 1)}
