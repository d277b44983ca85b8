"""Erdős–Rényi G(n, m) as ``repro_torch/data/generators.py: gnm`` draws
it: ``int(1.1 m) + 16`` uniform endpoint pairs, finished, and the first
``m`` edges in ``(u, v)`` order kept.  Configuration keys: ``n``, ``m``."""
from __future__ import annotations

import torch

from msfbench.gen.graphs import Graph, finish


def gnm(n: int, m: int, gen: torch.Generator) -> Graph:
    k = int(m * 1.1) + 16
    dev = gen.device
    u = torch.randint(0, n, (k,), generator=gen, device=dev,
                      dtype=torch.int64)
    v = torch.randint(0, n, (k,), generator=gen, device=dev,
                      dtype=torch.int64)
    return finish(u, v, n, gen, keep=m)


def draw(config: dict, gen: torch.Generator) -> Graph:
    return gnm(int(config["n"]), int(config["m"]), gen)


def shrink(config: dict, factor: int) -> dict:
    return {**config, "n": int(config["n"]) // factor,
            "m": int(config["m"]) // factor}
