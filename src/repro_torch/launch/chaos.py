"""Chaos driver: the fault matrix, end to end, on the port.

    python -m repro_torch.launch.chaos --smoke            # on the card
    python -m repro_torch.launch.chaos --smoke --device cpu
    python -m repro_torch.launch.chaos                    # full, prints JSON

Port of ``repro/launch/chaos.py``.  Runs every fault kind of
``comm/faults.py`` against the sharded engine (p = 8 stacked shards,
``pallas_minedges=True``, so K1 serves both MINEDGES sites) and asserts
the one robustness invariant: **an injected fault is either detected or
tolerated, never silent.**

  * *detected* — the run raised the engine's own error (a strict replay
    that does not fit, ``CapacityError``, ``ShardAbort``), or the
    returned forest failed the fault-free verifier armed with the
    Kruskal oracle's weight and edge count;
  * *tolerated* — the forest is bit-identical to the fault-free one;
  * *SILENT* — anything else.  One silent cell fails the driver (exit 1).

Each cell replays a fault-free measured plan under ``faults.inject``
with ``replan=False``, so a misfit raises instead of replanning around
the fault.  The grid cells fault either hop of the two-hop ghost push on
a ``(4, 2)`` layout.  After the matrix every baseline is replayed
fault-free again and must be bit-identical.  The recovery cells kill the
driven engine mid-run with an ``abort`` fault past the checkpoint
cadence, resume from the last certified checkpoint (bit-identical, at
most the cadence re-executed), and remap it onto p/2 shards (the
Kruskal edge set).  ``measure_verify_overhead`` times
``execute_plan(verify=True)`` against the plain replay.

Runs on the CUDA card unless ``--device``/``device=`` names another
device, and raises where there is none.  Full mode prints its cells as
one JSON object and writes no file.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import faults
from repro_torch.core import oracle
from repro_torch.core.distributed import build_dist_graph
from repro_torch.core.distributed_sharded import (
    distributed_sharded_msf, execute_plan, execute_plan_batched,
    plan_sharded_msf)
from repro_torch.core.graph import CapacityError
from repro_torch.core.verify import VerifyFailure, verify_forest
from repro_torch.data import generators
from repro_torch.device import DeviceLike, resolve_device

NUM_SHARDS = 8
GRID_SHARDS = (4, 2)
K1 = dict(pallas_minedges=True)

# fault kind -> FaultSpec aimed at the exchange site where it bites.
# corrupt flips an exponent bit (26) of a fraction of the in-flight
# candidate weights: a swayed argmin picks an edge whose weight differs
# from the oracle's by far more than the verifier's tolerance.
FAULT_MATRIX: Tuple[Tuple[str, faults.FaultSpec], ...] = (
    ("clip", faults.FaultSpec(kind="clip", site="minedges",
                              cap_frac=0.25)),
    ("corrupt", faults.FaultSpec(kind="corrupt", site="minedges",
                                 fraction=0.25, bit=26)),
    ("shuffle_dest", faults.FaultSpec(kind="shuffle_dest",
                                      site="contract", fraction=1.0)),
    ("drop", faults.FaultSpec(kind="drop", site="push", fraction=0.5)),
    ("stall", faults.FaultSpec(kind="stall", site="minedges", shard=0)),
)

# faults on either hop of the grid ghost push.  corrupt is left out: the
# push payload is int32 (vid, parent) and the bit flip touches float32
# leaves only.
GRID_FAULT_MATRIX: Tuple[Tuple[str, faults.FaultSpec], ...] = (
    ("drop", faults.FaultSpec(kind="drop", site="ghost_push_col",
                              fraction=0.5)),
    ("drop", faults.FaultSpec(kind="drop", site="ghost_push_row",
                              fraction=0.5)),
    ("shuffle_dest", faults.FaultSpec(kind="shuffle_dest",
                                      site="ghost_push_row",
                                      fraction=1.0)),
    ("stall", faults.FaultSpec(kind="stall", site="ghost_push_col",
                               shard=0)),
)


def _build(family: str, n: int, p: int, seed: int, device: torch.device,
           cap: Optional[int] = None):
    """One generated graph: (DistGraph, oracle mask, weight and count,
    cap, m)."""
    u, v, w, n = generators.generate(family, n, avg_degree=8.0, seed=seed)
    if cap is None:
        cap = max(1, -(-2 * len(u) // p))
    g = build_dist_graph(u, v, w, n, p, cap=cap, device=device)[0]
    km, kw = oracle.kruskal(u, v, w, n)
    return g, km, kw, int(km.sum()), cap, len(u)


def _oracle_identical(g, mask, km) -> bool:
    eid = g.eid.cpu().numpy()
    return np.array_equal(np.unique(eid[np.asarray(mask)]),
                          np.flatnonzero(km))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _detected(exc: Exception) -> bool:
    """Whether ``exc`` is the engine reporting a fault.  A bare
    ``RuntimeError`` is one only when it is the strict replay's misfit:
    anything else (an indexing error of torch, say) is a fault of the
    port and propagates."""
    if isinstance(exc, (faults.ShardAbort, VerifyFailure, CapacityError)):
        return True
    return type(exc) is RuntimeError and str(exc).startswith(
        "plan replay does not fit")


def _classify(g, n, shards, plan, spec, seed, base_mask, kw, kc):
    """One strict replay under injection, classified."""
    fp = faults.FaultPlan(seed=seed, specs=(spec,))
    injected = -1.0
    try:
        with faults.inject(fp):
            out = execute_plan(g, n, shards, plan, replan=False)
            injected = float(out[5].injected)
    except (RuntimeError, CapacityError) as e:
        if not _detected(e):
            raise
        return "detected", f"raised {type(e).__name__}: {e}", injected
    mask = _host(out[0])
    if np.array_equal(mask, base_mask):
        return "tolerated", "bit-identical MSF", injected
    rep = verify_forest(g, n, shards, out[0], out[3], expected_weight=kw,
                        expected_count=kc, raise_on_fail=False,
                        device=g.u.device)
    if not rep.ok:
        return "detected", "verify: " + "; ".join(rep.reasons), injected
    return "SILENT", "result differs from oracle yet verified", injected


def _classify_batched(graphs, n, plan, spec, seed, truths):
    """The same classification through ``execute_plan_batched``."""
    fp = faults.FaultPlan(seed=seed, specs=(spec,))
    dev = graphs[0].u.device
    try:
        with faults.inject(fp):
            results, _ = execute_plan_batched(graphs, n, NUM_SHARDS, plan,
                                              replan=False, device=dev)
    except (RuntimeError, CapacityError) as e:
        if not _detected(e):
            raise
        return "detected", f"raised {type(e).__name__}: {e}"
    verdicts = []
    for g, res, (base_mask, kw, kc) in zip(graphs, results, truths):
        if np.array_equal(_host(res[0]), base_mask):
            verdicts.append("tolerated")
            continue
        rep = verify_forest(g, n, NUM_SHARDS, res[0], res[3],
                            expected_weight=kw, expected_count=kc,
                            raise_on_fail=False, device=dev)
        verdicts.append("detected" if not rep.ok else "SILENT")
    if "SILENT" in verdicts:
        return "SILENT", f"per-graph verdicts: {verdicts}"
    if "detected" in verdicts:
        return "detected", f"per-graph verdicts: {verdicts}"
    return "tolerated", "all graphs bit-identical"


def run_matrix(families, n: int, seed: int, batched: bool,
               verbose: bool = True, device: DeviceLike = None) -> List[dict]:
    """Every ``FAULT_MATRIX`` cell on each family's planned replay, and
    with ``batched`` through ``execute_plan_batched`` on two graphs."""
    dev = resolve_device(device)
    p = NUM_SHARDS
    cells: List[dict] = []
    baselines = []  # (graph, plan, base_mask, family) for the re-check
    for family in families:
        g, km, kw, kc, cap, m = _build(family, n, p, seed, dev)
        plan = plan_sharded_msf(g, n, p, **K1)
        out0 = execute_plan(g, n, p, plan, replan=False)
        base_mask = _host(out0[0])
        assert _oracle_identical(g, base_mask, km), \
            f"{family}: fault-free baseline != Kruskal oracle"
        baselines.append((g, plan, base_mask, family))
        for fault, spec in FAULT_MATRIX:
            verdict, why, injected = _classify(
                g, n, p, plan, spec, seed, base_mask, kw, kc)
            cells.append({"fault": fault, "family": family,
                          "path": "planned", "verdict": verdict,
                          "why": why, "injected_items": injected})
            if verbose:
                print(f"  {fault:<12} {family:<6} planned  -> {verdict}"
                      f"  ({why[:90]})")
        if batched:
            # two same-shape graphs in one call; the shared capacity is
            # the larger of the two exact needs
            e1 = generators.generate(family, n, avg_degree=8.0, seed=seed)
            e2 = generators.generate(family, n, avg_degree=8.0,
                                     seed=seed + 1)
            bcap = max(max(1, -(-2 * len(e[0]) // p)) for e in (e1, e2))
            pair, truths = [], []
            for u, v, w, _n in (e1, e2):
                pair.append(build_dist_graph(u, v, w, n, p, cap=bcap,
                                             device=dev)[0])
                km_i, kw_i = oracle.kruskal(u, v, w, n)
                truths.append((km_i, kw_i, int(km_i.sum())))
            # the cells replay with replan=False, so the plan must fit
            # both graphs fault-free: measure on the first, pad, and if
            # the second still does not fit batch the first twice
            bplan = plan_sharded_msf(pair[0], n, p, **K1).pad(0.5)
            try:
                bres, _ = execute_plan_batched(pair, n, p, bplan,
                                               replan=False, device=dev)
            except RuntimeError as e:
                if not _detected(e):
                    raise
                pair[1] = pair[0]
                truths[1] = truths[0]
                bres, _ = execute_plan_batched(pair, n, p, bplan,
                                               replan=False, device=dev)
            for g_i, res, (km_i, _, _) in zip(pair, bres, truths):
                assert _oracle_identical(g_i, _host(res[0]), km_i), \
                    f"{family}: batched baseline != oracle"
            truths = [(_host(r[0]), t[1], t[2])
                      for r, t in zip(bres, truths)]
            for fault, spec in FAULT_MATRIX:
                verdict, why = _classify_batched(pair, n, bplan, spec,
                                                 seed, truths)
                cells.append({"fault": fault, "family": family,
                              "path": "batched", "verdict": verdict,
                              "why": why})
                if verbose:
                    print(f"  {fault:<12} {family:<6} batched  -> "
                          f"{verdict}  ({why[:90]})")
    # the fault-free path must be unperturbed by everything above
    for g, plan, base_mask, family in baselines:
        out = execute_plan(g, n, p, plan, replan=False)
        assert np.array_equal(_host(out[0]), base_mask), \
            f"{family}: fault-free path perturbed after the fault matrix"
    if verbose:
        print(f"  fault-free re-run: {len(baselines)} baselines "
              "bit-identical")
    return cells


def run_grid_push_cells(n: int, seed: int, verbose: bool = True,
                        device: DeviceLike = None) -> List[dict]:
    """``GRID_FAULT_MATRIX`` on a ``(4, 2)`` layout: a plan measured with
    the grid push, replayed strictly under each spec, so a fault on the
    owner->deputy hop (``ghost_push_row``) or the deputy->rows hop
    (``ghost_push_col``) must be detected or tolerated."""
    dev = resolve_device(device)
    shards = GRID_SHARDS
    g, km, kw, kc, _, _ = _build("rgg2d", n, NUM_SHARDS, seed, dev)
    plan = plan_sharded_msf(g, n, shards, ghost_push="grid", **K1)
    assert plan.grid_push and plan.ghost is not None, \
        "grid-push chaos needs the ghost cache live on the grid rung"
    out0 = execute_plan(g, n, shards, plan, replan=False)
    base_mask = _host(out0[0])
    assert _oracle_identical(g, base_mask, km), \
        "grid-push fault-free baseline != Kruskal oracle"
    cells: List[dict] = []
    for fault, spec in GRID_FAULT_MATRIX:
        verdict, why, injected = _classify(
            g, n, shards, plan, spec, seed, base_mask, kw, kc)
        cells.append({"fault": fault, "family": "rgg2d",
                      "path": f"grid_push:{spec.site}",
                      "verdict": verdict, "why": why,
                      "injected_items": injected})
        if verbose:
            print(f"  {fault:<12} rgg2d  {spec.site:<14} -> {verdict}"
                  f"  ({why[:80]})")
    out = execute_plan(g, n, shards, plan, replan=False)
    assert np.array_equal(_host(out[0]), base_mask), \
        "fault-free grid push perturbed after the fault cells"
    return cells


def run_recovery_cells(families, n: int, seed: int, ckpt_every: int = 2,
                       elastic: bool = True, verbose: bool = True,
                       device: DeviceLike = None) -> List[dict]:
    """Kill mid-run, resume.

    Per family: the driven engine fault-free, then with ``ckpt_every``
    under an ``abort`` at round ``ckpt_every + 1`` (after at least one
    certified checkpoint); the ``ShardAbort`` is caught, the run resumes
    from the last checkpoint, and the resumed forest must be
    bit-identical to the fault-free one with at most the cadence
    re-executed.  The elastic cell remaps that checkpoint onto p/2 shards
    (the edges laid out again from the host arrays) and must give the
    Kruskal edge set."""
    dev = resolve_device(device)
    p = NUM_SHARDS
    cells: List[dict] = []
    abort_round = ckpt_every + 1
    for family in families:
        u, v, w, n2 = generators.generate(family, n, avg_degree=8.0,
                                          seed=seed)
        g = build_dist_graph(u, v, w, n2, p, device=dev)[0]
        km, _ = oracle.kruskal(u, v, w, n2)
        base = distributed_sharded_msf(g, n2, p, **K1)
        base_mask = _host(base[0])
        assert _oracle_identical(g, base_mask, km), \
            f"{family}: fault-free driver baseline != Kruskal oracle"
        assert int(base[5].rounds) >= abort_round, \
            f"{family}: solve ends in {int(base[5].rounds)} rounds, " \
            f"before the injected abort at round {abort_round}"
        fp = faults.FaultPlan(seed=seed, specs=(
            faults.FaultSpec(kind="abort", site="minedges",
                             rounds=(abort_round,)),))
        cks: List = []
        died = False
        try:
            with faults.inject(fp):
                distributed_sharded_msf(g, n2, p, ckpt_every=ckpt_every,
                                        ckpt_out=cks, **K1)
        except faults.ShardAbort:
            died = True
        assert died, f"{family}: abort round {abort_round} never fired"
        assert cks, f"{family}: no certified checkpoint before abort"
        ck = cks[-1]
        res = distributed_sharded_msf(g, n2, p, resume_from=ck, **K1)
        identical = (np.array_equal(_host(res[0]), base_mask)
                     and float(res[1]) == float(base[1])
                     and int(res[2]) == int(base[2]))
        re_exec = abort_round - 1 - ck.round_index
        cells.append({"cell": "resume", "family": family,
                      "abort_round": abort_round,
                      "ckpt_round": ck.round_index,
                      "re_executed_rounds": re_exec,
                      "bit_identical": bool(identical)})
        assert identical, \
            f"{family}: resumed run != fault-free run (ckpt {ck!r})"
        assert 0 <= re_exec <= ckpt_every, \
            f"{family}: {re_exec} re-executed rounds > cadence " \
            f"{ckpt_every}"
        if verbose:
            print(f"  resume       {family:<6} driver   -> recovered "
                  f"(ckpt@r{ck.round_index}, re-exec {re_exec} <= "
                  f"{ckpt_every}, bit-identical)")
        if elastic and family == families[0]:
            p2 = max(1, p // 2)
            g2, cap2 = build_dist_graph(u, v, w, n2, p2, device=dev)
            ck2 = ck.remap(p2, cap2, _host(g2.u), _host(g2.v),
                           _host(g2.eid))
            res2 = distributed_sharded_msf(g2, n2, p2, resume_from=ck2, **K1)
            ok = (_oracle_identical(g2, _host(res2[0]), km)
                  and int(res2[4]) == 0)
            cells.append({"cell": "elastic", "family": family,
                          "p_from": p, "p_to": p2,
                          "ckpt_round": ck.round_index,
                          "oracle_identical": bool(ok)})
            assert ok, f"{family}: elastic p{p}->p{p2} restore != oracle"
            if verbose:
                print(f"  elastic      {family:<6} p{p}->p{p2}  -> "
                      f"recovered (ckpt@r{ck.round_index}, oracle-"
                      "identical edge set)")
    return cells


def _wall(fn, iters: int, device: torch.device) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls, host clock."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def measure_verify_overhead(n: int, seed: int, iters: int = 5,
                            device: DeviceLike = None) -> dict:
    """Warm-path cost of ``execute_plan(verify=True)`` against the plain
    strict replay, both warmed up first."""
    dev = resolve_device(device)
    p = NUM_SHARDS
    g, _, _, _, _, _ = _build("gnm", n, p, seed, dev)
    plan = plan_sharded_msf(g, n, p, **K1)
    for verify in (False, True):
        execute_plan(g, n, p, plan, replan=False, verify=verify)
    t_plain = _wall(lambda: execute_plan(g, n, p, plan, replan=False),
                    iters, dev)
    t_verify = _wall(lambda: execute_plan(g, n, p, plan, replan=False,
                                          verify=True), iters, dev)
    return {"n": n, "iters": iters, "t_plain_ms": t_plain * 1e3,
            "t_verify_ms": t_verify * 1e3,
            "verify_overhead_x": t_verify / max(t_plain, 1e-9)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small matrix (planned path only); asserts zero "
                    "silent corruptions")
    ap.add_argument("--n", type=int, default=0,
                    help="vertices per graph (default 128 smoke / 512 "
                    "full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n or (128 if args.smoke else 512)

    print(f"chaos: {len(FAULT_MATRIX)} fault classes x gnm/rgg2d x "
          f"{'planned' if args.smoke else 'planned+batched'}, n={n}, "
          f"p={NUM_SHARDS}, device={dev}")
    cells = run_matrix(("gnm", "rgg2d"), n, args.seed,
                       batched=not args.smoke, device=dev)
    print(f"grid push: {len(GRID_FAULT_MATRIX)} deputy-hop cells on a "
          f"{GRID_SHARDS} layout")
    cells += run_grid_push_cells(n, args.seed, device=dev)
    silent = [c for c in cells if c["verdict"] == "SILENT"]
    counts = {v: sum(1 for c in cells if c["verdict"] == v)
              for v in ("detected", "tolerated", "SILENT")}
    print(f"chaos matrix: {len(cells)} cells -> {counts}")
    if silent:
        for c in silent:
            print(f"SILENT: {c}")
        raise SystemExit(1)

    rec_families = ("gnm",) if args.smoke else ("gnm", "rgg2d")
    rec_cells = run_recovery_cells(rec_families, n, args.seed, device=dev)
    print(f"recovery: {len(rec_cells)} cells, all recovered")

    overhead = measure_verify_overhead(n, args.seed, device=dev)
    print(f"verify=True overhead: {overhead['verify_overhead_x']}x "
          f"({overhead['t_plain_ms']} ms -> {overhead['t_verify_ms']} ms "
          f"warm, n={overhead['n']})")
    if not args.smoke:
        print(json.dumps({"chaos": {"n": n, "seed": args.seed,
                                    "device": str(dev), "cells": cells,
                                    "verdict_counts": counts,
                                    "recovery_cells": rec_cells,
                                    "verify_overhead": overhead}},
                         sort_keys=True))
    print("chaos: OK (zero silent corruptions)")


if __name__ == "__main__":
    main()
