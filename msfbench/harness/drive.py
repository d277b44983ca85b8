"""What every traffic driver shares: the window, its records, the pool.

A traffic file (``traffic/<traffic>.json``) names its ``entry``, the
driver ``traffic/<entry>.py`` that reads the rest of its parameters;
``prepare(run)`` finds it by that name and calls its ``prepare(run)``,
which does the set-up and returns the window's loop.

The window admits work until ``seconds`` have passed and then finishes
what it started.  The system is the program (``repro_torch``) or, for
the control, the plain reference in a lower precision put in its place;
both take the same graphs.  Which answers the comparison checks is the
harness's rule (``Keep``), the same for every traffic.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, Optional

import torch

import msfbench
from msfbench.gen import graphs

DRAIN_S = 60.0  # how long past the close a started request may take
# the answers kept for the comparison: the first CHECK_FIRST, then one in
# CHECK_EVERY drawn from the seed, at most CHECK_MAX in a window
CHECK_FIRST, CHECK_EVERY, CHECK_MAX = 8, 16, 48


@dataclasses.dataclass
class Done:
    """One request or solve the window began."""
    index: int          # its order in the window
    graph: int          # the pool graph it solved
    edges: int          # m of that graph
    latency: float      # seconds, submit (or call) to completion
    t_done: float       # perf_counter at completion
    answer: Optional[tuple] = None  # kept for the comparison
    error: str = ""


@dataclasses.dataclass
class Window:
    start: float = 0.0
    start_ns: int = 0
    end: float = 0.0
    end_ns: int = 0
    done: List[Done] = dataclasses.field(default_factory=list)
    began: int = 0
    # called after each solve or step (the traced run stops its profiler
    # there once it has recorded enough)
    tick: Callable[[], None] = lambda: None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def served(self) -> List[Done]:
        return [d for d in self.done if not d.error]


class Keep:
    """Whether the window's ``i``-th answer is kept for the comparison."""

    def __init__(self, seed: int) -> None:
        self.rng = random.Random(seed)
        self.kept = 0

    def __call__(self, i: int) -> bool:
        if self.kept < CHECK_MAX and (
                i < CHECK_FIRST or self.rng.random() < 1.0 / CHECK_EVERY):
            self.kept += 1
            return True
        return False


def pool_seed(seed: int, i: int) -> int:
    return int(seed) * 16 + i + 1


def make_pool(config: dict, seed: int, size: int,
              device: torch.device) -> List[graphs.Graph]:
    return [graphs.make(config, pool_seed(seed, i), device)
            for i in range(size)]


def engine_kwargs(config: dict, traffic: dict) -> dict:
    kw = dict(engine=config["engine"], algorithm=traffic["algorithm"])
    if "num_shards" in config:
        kw["num_shards"] = config["num_shards"]
    kw.update(config.get("engine_options", {}))
    return kw


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def prepare(run) -> Callable:
    """Set-up by the cell's traffic driver; returns the window's loop."""
    return msfbench.by_name("traffic", run.cell.traffic["entry"]).prepare(run)
