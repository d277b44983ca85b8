"""Multi-pod dry-run, the port of ``repro.launch.dryrun``: cost every
(architecture x shape x mesh) cell on the production meshes, plus the
distributed-MST step (the paper's own workload), and emit the roofline
table inputs.

Usage:
  python -m repro_torch.launch.dryrun                  # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --mst            # MST cell only
  python -m repro_torch.launch.dryrun --out build/dryrun.json

The reference AOT-compiles each cell for 512 placeholder XLA devices
and reads the compiled program.  The port compiles nothing and needs no
device: its mesh is a description (``launch/mesh.py``), and this module
sets no environment variable and no device count.

  * An LM cell builds its step on the ``meta`` device at full published
    width and the production shape (``launch/shapes.py: build_step``)
    and runs it once under the counter (``launch/roofline.py:
    cost_summary``): flops and bytes of the whole step, divided by the
    mesh's chips for the per-chip figure (``cost_source``).  Its
    collectives follow from the specs (``lm_collective_bytes``) and its
    memory from ``models/sharding.py: shard_shape`` of every argument
    and output leaf; ``alias_bytes`` is the donated caches, or 0.
  * The MST cell runs no engine (their host syncs cannot run on
    ``meta``): its exchange bytes come from the plan
    (``plan_exchange_bytes``) or the replicated engine's round count
    (``replicated_exchange_bytes``).

Each record has the reference's keys.  Where the port has no value it
writes ``null`` and says why under ``"why"``: ``memory.temp_bytes`` (no
compiler, so no temporary-buffer plan), ``lower_s`` and ``compile_s``
(no compile; the costing's own seconds are ``costing_s``),
``extrapolated`` (no depth probes: the counter sees every layer), and
for the MST cell ``cost`` (no step is run).  Keys of the port's own are
``PORT_KEYS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (SHAPES, build_step, cell_supported,
                                       leaf_table, shape_info, shard_bytes)

# record keys the reference does not write
PORT_KEYS = ("why", "costing_s", "cost_source", "collective_note")

_WHY_LM = {
    "memory.temp_bytes": "no compiler, so no temporary-buffer plan: the "
                         "eager step's intermediates are in cost.bytes",
    "lower_s": "nothing is lowered: the step runs eagerly on meta "
               "tensors (costing_s)",
    "compile_s": "nothing is compiled (costing_s)",
    "extrapolated": "no depth probes: the port's layers are Python loops "
                    "and the counter sees every one",
}
_NVLINK_DOMAIN = 8  # H100 SXM cards joined all to all by NVLink


def parse_overrides(pairs):
    """--override attn_impl=blockwise --override moe_impl=dispatch ..."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k] = v
    return out


def apply_overrides(cfg, overrides: Optional[Dict]):
    """``cfg`` with ``overrides`` replaced.  ``scan_unroll`` is refused:
    it makes the reference's XLA cost analysis see every layer of a
    scan, and the port has no scan to unroll."""
    if not overrides:
        return cfg
    if "scan_unroll" in overrides:
        raise ValueError(
            "scan_unroll steers the reference's XLA probes (a scanned "
            "layer is counted once there); the port's layers are Python "
            "loops that the counter sees one by one, so it has no such "
            "knob")
    return dataclasses.replace(cfg, **overrides)


def _collective_note(chips: int) -> str:
    return (f"every axis at the NVLink rate ({rl.NVLINK_BW:.3g} B/s); "
            f"{chips} cards span {-(-chips // _NVLINK_DOMAIN)} NVLink "
            f"domains of {_NVLINK_DOMAIN}, so links between domains are "
            "slower and the collective term is a lower bound")


def cost_cell(cfg, shape, mesh, donate_caches: bool = False) -> Dict:
    """The counterpart of the reference's ``compile_cell``: ``cost``,
    ``collectives`` and ``memory`` of one cell, per chip."""
    t0 = time.perf_counter()
    built = build_step(cfg, shape, mesh, donate_caches=donate_caches)
    step, args, in_sh, out_sh = built[:4]
    donate = built[4] if len(built) == 5 else ()
    info = shape_info(shape)
    chips = mesh.size
    # the bytes the step is handed, before a train step updates in place
    argument_bytes = shard_bytes(args, in_sh, mesh)
    alias_bytes = sum(shard_bytes(args[i], in_sh[i], mesh) for i in donate)
    params_table = leaf_table(args[0])
    counted, out = rl.cost_summary(step, args)
    return {
        "cost": {"flops": counted["flops"] / chips,
                 "bytes": counted["bytes"] / chips,
                 "flops_global": counted["flops"],
                 "bytes_global": counted["bytes"]},
        "collectives": rl.lm_collective_bytes(cfg, info, params_table,
                                              in_sh[0], mesh),
        "memory": {"argument_bytes": argument_bytes,
                   "output_bytes": shard_bytes(out, out_sh, mesh),
                   "temp_bytes": None,
                   "alias_bytes": alias_bytes},
        "lower_s": None,
        "compile_s": None,
        "costing_s": round(time.perf_counter() - t0, 2),
    }


def run_cell(arch: str, shape_id, mesh, mesh_label: str,
             probes: bool = True, overrides=None, donate_caches=False):
    """One LM cell's record.  ``probes`` is the reference's flag and
    changes nothing here (no probes: the counter sees every layer)."""
    cfg = apply_overrides(get_arch(arch).config, overrides)
    ok, why = cell_supported(cfg, shape_id)
    rec = {"arch": arch, "shape": shape_id, "mesh": mesh_label}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    try:
        rec.update(cost_cell(cfg, shape_id, mesh,
                             donate_caches=donate_caches))
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
        return rec
    rec["extrapolated"] = None
    rec["why"] = dict(_WHY_LM)
    info = shape_info(shape_id)
    chips = mesh.size
    rec["cost_source"] = (
        "FlopCounterMode and a per-op byte counter over one eager step "
        "on the meta device, the whole program, divided by the mesh's "
        f"{chips} chips")
    rec["collective_note"] = _collective_note(chips)
    flops = rec["cost"]["flops"]
    terms = rl.RooflineTerms(flops=flops, bytes_accessed=rec["cost"]["bytes"],
                             collective_bytes=rec["collectives"]["wire_bytes"],
                             chips=chips)
    rec["roofline"] = terms.as_dict()
    mf = rl.model_flops(cfg, info, backward=(info["kind"] == "train"))
    rec["model_flops_global"] = mf
    rec["model_flops_per_chip"] = mf / chips
    rec["useful_ratio"] = (mf / chips) / flops if flops else 0.0
    return rec


def _mst_memory(n: int, chips: int, cap_total: int, engine: str) -> Dict:
    """Per-chip argument and output bytes of the MST step: one shard's
    slice of the four ``[cap_total]`` inputs; of the outputs, one
    shard's slice of the mask (and, sharded, of the labels), the
    replicated engine's ``[n]`` labels whole, and the scalars (weight,
    count, overflow and the 8 ``CommStats`` fields)."""
    cap = cap_total // chips
    labels = (-(-n // chips) if engine == "sharded" else n) * 4
    return {"argument_bytes": cap * (4 + 4 + 4 + 4),
            "output_bytes": cap + labels + 4 * (3 + 8),
            "temp_bytes": None, "alias_bytes": 0}


def _mst_collectives(kind: str, nbytes: float, wire: float,
                     count: int) -> Dict:
    out = {f"{k}_{s}": 0.0 for k in rl.COLLECTIVES
           for s in ("bytes", "wire", "count")}
    out.update({f"{kind}_bytes": nbytes, f"{kind}_wire": wire,
                f"{kind}_count": float(count), "total_bytes": nbytes,
                "wire_bytes": wire})
    return out


def run_mst_cell(mesh, mesh_label: str, n_exp: int = 22,
                 edges_per_shard_exp: int = 18,
                 algorithm: str = "boruvka", local_preprocessing=True,
                 engine: str = "replicated", plan_path=None):
    """The paper's own workload on the production mesh: the distributed
    Borůvka step over a 1D-partitioned edge list (weak-scaling shape:
    2^n_exp vertices, 2^edges_per_shard_exp directed slots per device).

    ``engine="sharded"`` costs the sharded-label engine's planned
    replay: a ``RoundPlan`` loaded from ``plan_path`` (``plan.to_json``
    output) or synthesized on the geometric ladder (``core/plan.py:
    synthetic_plan``), beside its flat-capacity comparator (every round
    at the full capacities).  ``engine="replicated"`` costs
    ``make_mst_step`` at the static ``log2(n) + 1`` rounds a level.
    """
    chips = mesh.size
    n = 2 ** n_exp
    cap_total = chips * (2 ** edges_per_shard_exp)
    sizes = tuple(mesh.sizes)
    rec = {"arch": f"mst-{engine}-{algorithm}", "shape": f"n=2^{n_exp}",
           "mesh": mesh_label}
    t0 = time.perf_counter()
    why = {"cost": "no step is run (the engines' host syncs cannot run on "
                   "meta tensors): the roofline's compute and memory terms "
                   "are not counted, only its collective term",
           "memory.temp_bytes": _WHY_LM["memory.temp_bytes"],
           "compile_s": _WHY_LM["compile_s"]}
    try:
        if engine == "sharded":
            from repro_torch.core.distributed_sharded import \
                make_sharded_mst_step
            from repro_torch.core.plan import RoundPlan, synthetic_plan
            if plan_path:
                # a measured plan's levers are frozen: the cell costs what
                # the plan encodes, recorded below
                with open(plan_path) as f:
                    plan = RoundPlan.from_json(f.read())
            else:
                plan = synthetic_plan(
                    n, cap_total, chips, algorithm=algorithm,
                    local_preprocessing=local_preprocessing)
            rec["plan"] = rl.plan_summary(plan)
            rec["plan_source"] = plan_path or "synthetic"
            rec["plan_local_preprocessing"] = plan.local_preprocessing
            make_sharded_mst_step(n, cap_total, chips, plan=plan)  # shape
            flat = rl.flat_capacity_plan(plan)
            for prefix, pl in (("", plan), ("flat_", flat)):
                rec[prefix + "compile_s"] = None
                rec[prefix + "cost"] = {"flops": None, "bytes": None}
                rec[prefix + "collectives"] = _mst_collectives(
                    "all-to-all", rl.plan_exchange_bytes(pl, sizes),
                    rl.plan_exchange_bytes(pl, sizes, wire=True),
                    sum(1 for _ in rl.plan_exchanges(pl, sizes)))
                rec[prefix + "memory"] = _mst_memory(n, chips, cap_total,
                                                     engine)
            rec["temp_bytes_shrink_vs_flat"] = (
                rec["flat_collectives"]["total_bytes"]
                / max(rec["collectives"]["total_bytes"], 1.0))
            why["flat_compile_s"] = _WHY_LM["compile_s"]
            why["flat_cost"] = why["cost"]
            why["temp_bytes_shrink_vs_flat"] = (
                "the flat comparator's exchange bytes over the plan's: the "
                "reference divides temp bytes, which the port has not")
            rec["note"] = ("exchange bytes from the plan's static "
                           "capacities, every round as planned, the "
                           "pointer doubling at its log2(n) bound; flat "
                           "comparator: every round at the full "
                           "capacities")
        else:
            from repro_torch.core.distributed import make_mst_step
            make_mst_step(n, cap_total, chips, algorithm=algorithm,
                          local_preprocessing=local_preprocessing)
            bound = int(math.ceil(math.log2(max(n, 2)))) + 1
            rounds = bound if algorithm == "boruvka" else [bound] * 4
            nbytes = rl.replicated_exchange_bytes(
                n, chips, rounds, algorithm=algorithm,
                local_preprocessing=local_preprocessing)
            rec["compile_s"] = None
            rec["cost"] = {"flops": None, "bytes": None}
            # three all-reduced n-vectors a round; the preprocessing's
            # label combine and its two boundary gathers
            calls = 3 * sum([rounds] if algorithm == "boruvka" else rounds)
            rec["collectives"] = _mst_collectives(
                "all-reduce", nbytes, 2.0 * nbytes * (chips - 1) / chips,
                calls + (3 if local_preprocessing else 0))
            rec["memory"] = _mst_memory(n, chips, cap_total, engine)
            rec["note"] = ("while-loop costs use the static iteration "
                           f"bound (log2(n)+1 = {bound} rounds)")
        terms = rl.RooflineTerms(
            flops=0.0, bytes_accessed=0.0,
            collective_bytes=rec["collectives"]["wire_bytes"], chips=chips)
        rec["roofline"] = terms.as_dict()
        rec["status"] = "ok"
        rec["why"] = why
        rec["collective_note"] = _collective_note(chips)
    except Exception as e:
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    rec["costing_s"] = round(time.perf_counter() - t0, 2)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape id")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mst", action="store_true", help="MST cell only")
    ap.add_argument("--mst-algorithm", default="boruvka")
    ap.add_argument("--mst-no-preprocessing", action="store_true")
    ap.add_argument("--mst-engine", default="replicated",
                    choices=["replicated", "sharded"],
                    help="sharded = cost the planned (RoundPlan) replay "
                         "beside its flat-capacity comparator")
    ap.add_argument("--mst-plan", default=None, metavar="PLAN_JSON",
                    help="RoundPlan JSON (plan.to_json) to cost; "
                         "default synthesizes a geometric-ladder plan")
    ap.add_argument("--override", action="append", default=[],
                    help="config overrides, e.g. attn_impl=blockwise")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the reference's command lines; "
                         "the port needs no probes")
    ap.add_argument("--donate-caches", action="store_true")
    ap.add_argument("--out", default="build/dryrun.json")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod-16x16", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multipod-2x16x16",
                       make_production_mesh(multi_pod=True)))

    records = []
    for label, mesh in meshes:
        if args.mst:
            rec = run_mst_cell(
                mesh, label, algorithm=args.mst_algorithm,
                local_preprocessing=not args.mst_no_preprocessing,
                engine=args.mst_engine, plan_path=args.mst_plan)
            print(json.dumps({k: rec[k] for k in rec
                              if k not in ("trace",)}, default=str)[:2000])
            records.append(rec)
            continue
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES)
        for arch in archs:
            for shape_id in shapes:
                t0 = time.time()
                rec = run_cell(arch, shape_id, mesh,
                               label, probes=not args.no_probes,
                               overrides=overrides,
                               donate_caches=args.donate_caches)
                dt = time.time() - t0
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']}"
                             f" comp={r['compute_s']:.4f}s"
                             f" mem={r['memory_s']:.4f}s"
                             f" coll={r['collective_s']:.4f}s"
                             f" useful={rec['useful_ratio']:.2f}")
                elif status == "failed":
                    extra = " " + rec["error"][:160]
                print(f"[{label}] {arch} x {shape_id}: {status}"
                      f" ({dt:.0f}s){extra}", flush=True)
                records.append(rec)
        if not args.arch and not args.shape:
            rec = run_mst_cell(mesh, label)
            print(f"[{label}] mst-boruvka: {rec['status']}", flush=True)
            records.append(rec)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1, default=str)
    nok = sum(1 for r in records if r["status"] == "ok")
    nsk = sum(1 for r in records if r["status"] == "skipped")
    nf = sum(1 for r in records if r["status"] == "failed")
    print(f"\ndry-run: {nok} ok, {nsk} skipped (documented), {nf} failed")
    print(f"wrote {args.out}")
    return 0 if nf == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
