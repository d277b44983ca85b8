"""The ``"solve"`` driver: one caller in a closed loop of public-API solves.

``minimum_spanning_forest(edges, engine=..., algorithm=...)`` on a pool
of ``pool`` device-resident graphs taken in turn, each call timed on the
host clock up to ``torch.cuda.synchronize()``.  Parameters: ``algorithm``,
``pool``.  Set-up draws the pool and solves one warm graph
``warm_shrink`` times smaller (the configuration's) from a seed outside
the pool.  The window ends with the solve in flight.
"""
from __future__ import annotations

import sys
import time
import traceback
from typing import Callable

import torch

from msfbench.gen import graphs
from msfbench.harness.drive import (Done, Keep, Window, engine_kwargs,
                                    make_pool, pool_seed, sync)
from msfbench.reference import msf as reference


class ProgramSolver:
    """``repro_torch``'s public API."""

    def __init__(self, config: dict, traffic: dict) -> None:
        from repro_torch.core.graph import EdgeList
        from repro_torch.core.mst import minimum_spanning_forest
        self._edges = EdgeList
        self._solve = minimum_spanning_forest
        self.kw = engine_kwargs(config, traffic)

    def __call__(self, g: graphs.Graph):
        mask, weight = self._solve(self._edges(g.u, g.v, g.w, g.n), **self.kw)
        return mask, weight


def control_solver(g: graphs.Graph):
    """The reference in bfloat16, in the program's place."""
    return reference.msf(g.u, g.v, g.w, g.n, weight_dtype=torch.bfloat16)


def prepare(run) -> Callable:
    cfg, trf, dev = run.config, run.cell.traffic, run.device
    pool = make_pool(cfg, run.seed, int(trf["pool"]), dev)
    solver = control_solver if run.control else ProgramSolver(cfg, trf)
    warm = graphs.make(graphs.shrink(cfg, int(cfg.get("warm_shrink", 1))),
                       pool_seed(run.seed, len(pool)), dev)
    solver(warm)
    sync(dev)
    run.pool = pool
    solve = run.spans.span("solve", solver)
    keep = Keep(run.seed)

    def loop(window: Window, seconds: float) -> None:
        i = 0
        while time.perf_counter() - window.start < seconds:
            gi = i % len(pool)
            g = pool[gi]
            window.began += 1
            t0 = time.perf_counter()
            try:
                mask, weight = solve(g)
                sync(dev)
            except Exception:  # a failed solve is this run's result
                traceback.print_exc(file=sys.stderr)
                t1 = time.perf_counter()
                window.done.append(Done(i, gi, g.m, t1 - t0, t1,
                                        error="raised"))
                break
            t1 = time.perf_counter()
            d = Done(i, gi, g.m, t1 - t0, t1)
            if keep(i):
                d.answer = (mask.cpu().numpy(), float(weight))
            del mask, weight
            window.done.append(d)
            window.tick()
            i += 1
    return loop
