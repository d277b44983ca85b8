#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit 1):

  1. build every CUDA kernel from the sources in this checkout (one
     ``nvcc`` per source, all at once) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card: the
     wall of edge cases (tie storms, +inf tails, all-dead, L = 0/1,
     size 0, non-dividing lengths, stacked shards), exact equality;
  3. drive the main path: ``minimum_spanning_forest(engine=
     "distributed_sharded", num_shards=8, pallas_minedges=True)`` with
     every other lever off, on GNM n = 2^20, m = 2^23 (seed 0), for both
     algorithms — the K1 launch count must rise; the result must equal
     the same solve through the plain scatter path (edge set, labels,
     overflow = 0, every CommStats field) and match scipy's MST weight
     within 1e-3 relative with n - #components edges;
  4. the same call on RMAT (scale 16, average degree 8) and the static
     engine on that graph, both against the exact Kruskal edge set;
  5. time K1 at the shape the engine gave it (CUDA events) beside its
     plain version, one ``scatter_reduce_`` over a packed key as a
     library yardstick, and its bound from device-memory bytes.

The line before the last is the card's name and power limit as
``nvidia-smi`` reports them, the one before that a JSON object with one
entry per kernel, and the last ``{"ok": true, "device": {...}}``.
Needs one CUDA card; with none it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NUM_SHARDS = 8
GNM_N, GNM_M, SEED = 1 << 20, 1 << 23, 0
RMAT_SCALE, RMAT_DEGREE = 16, 8
OFF = dict(local_preprocessing=False, coalesce=False, src_only=False,
           adaptive_doubling=False, shrink_capacities=False,
           ghost_cache=False, relabel_skip=False)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
K1_SOURCE = "src/repro_torch/kernels/segmin/csrc/owner_scatter_min.cu"
K1_REPLACES = "src/repro/kernels/segmin/segmin.py:176"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def _candidates(rng, L, size, tie_heavy, inf_tail, rows=None):
    """K1 inputs as in the reference's property wall: random slots,
    tie-heavy or uniform weights, optional +inf tails, 80% ok."""
    import numpy as np
    shape = (L,) if rows is None else (rows, L)
    idx = rng.integers(0, max(size, 1), shape).astype(np.int32)
    if tie_heavy:
        w = rng.integers(1, 4, shape).astype(np.float32)
    else:
        w = rng.uniform(1, 255, shape).astype(np.float32)
    if inf_tail and L:
        k = int(rng.integers(0, L + 1))
        w[..., L - k:] = np.inf
    eid = rng.integers(0, 2 ** 20, shape).astype(np.int32)
    pay1 = rng.integers(0, 1000, shape).astype(np.int32)
    pay2 = rng.integers(0, 1000, shape).astype(np.int32)
    ok = rng.random(shape) < 0.8
    return idx, w, eid, pay1, pay2, ok


def max_abs_diff(got, exp) -> float:
    import torch
    worst = 0.0
    for g, e in zip(got, exp):
        g = g.double()
        e = e.double()
        both_inf = torch.isinf(g) & torch.isinf(e) & (g == e)
        d = torch.where(both_inf, 0.0, (g - e).abs())
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def k1_parity_wall(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.segmin.ref import owner_scatter_min_ref
    from repro_torch.kernels.segmin.segmin import owner_scatter_min

    rng = np.random.default_rng(7)
    cases = []
    for name, L, size, tie, tail in (
            ("tie_storm", 5000, 4, True, False),
            ("inf_tail", 3000, 64, False, True),
            ("tie_inf", 2049, 17, True, True),
            ("single", 1, 4, True, False),
            ("empty", 0, 8, False, False),
            ("size_zero", 10, 0, False, False),
            ("non_dividing", 257, 31, True, True),
            ("one_slot", 1001, 1, True, True)):
        cases.append((name, _candidates(rng, L, size, tie, tail), size))
    idx, w, eid, p1, p2, _ = _candidates(rng, 500, 16, False, False)
    cases.append(("all_dead", (idx, w, eid, p1, p2, np.zeros(500, bool)), 16))
    cases.append(("stacked_8x4099", _candidates(rng, 4099, 300, True, True,
                                                rows=8), 300))
    # ok lanes past either end of a row's table are dropped, never
    # written into the next row's slots
    stray = _candidates(rng, 3001, 13, True, False, rows=3)
    stray[0][:, ::7] += 13
    stray[0][:, 3::11] = -1 - stray[0][:, 3::11]
    cases.append(("out_of_range_3x3001", stray, 13))
    eq = np.full(20000, 11, np.int32)
    eq[10000:] = np.arange(10000)
    cases.append(("exact_tie_max_payload",
                  (np.full(20000, 2, np.int32), np.full(20000, 5, np.float32),
                   eq, rng.integers(0, 100, 20000).astype(np.int32),
                   rng.integers(0, 100, 20000).astype(np.int32),
                   np.ones(20000, bool)), 4))
    for name, arrays, size in cases:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = owner_scatter_min(*args, size)
        exp = owner_scatter_min_ref(*args, size)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, e) for g, e in zip(got, exp))
        err = max_abs_diff(got, exp)
        log(f"k1 parity {name}: shape={tuple(args[0].shape)} size={size} "
            f"max|diff|={err} equal={equal}")
        check(equal, f"K1 differs from its plain version on {name}")


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def scipy_msf(u, v, w, n):
    """(weight, edge count) of scipy's minimum spanning forest."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, \
        minimum_spanning_tree
    a = coo_matrix((w.astype(np.float64), (u, v)), shape=(n, n)).tocsr()
    t = minimum_spanning_tree(a)
    ncomp, _ = connected_components(a, directed=False)
    return float(t.sum()), n - ncomp


def run_main_path(dev, u, v, w, n, algorithm):
    """One warm-up, then the counted solve through the public entry
    point.  Returns (mask, weight, seconds, K1 launches)."""
    import torch
    from repro_torch.core.graph import from_numpy
    from repro_torch.core.mst import minimum_spanning_forest
    from repro_torch.kernels.segmin.segmin import owner_scatter_min

    edges = from_numpy(u, v, w, n, device=dev)
    kw = dict(engine="distributed_sharded", num_shards=NUM_SHARDS,
              algorithm=algorithm, pallas_minedges=True, **OFF)
    minimum_spanning_forest(edges, **kw)  # warm-up
    torch.cuda.synchronize()
    owner_scatter_min.launches = 0
    t0 = time.perf_counter()
    mask, weight = minimum_spanning_forest(edges, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return mask, weight, seconds, owner_scatter_min.launches


def compare_engine_paths(dev, u, v, w, n, algorithm, captured=None):
    """The engine on one prebuilt layout through K1 and through the
    plain scatters: every output must be equal.  With ``captured`` (a
    dict), the inputs of the kernel run's first K1 launch are kept there,
    to time K1 at the engine's shape.  Returns (graph, result, engine
    seconds, host layout build seconds)."""
    import torch
    from repro_torch.core import distributed_sharded as ds
    from repro_torch.core.distributed import build_dist_graph
    from repro_torch.kernels.segmin import ops as segmin_ops

    t0 = time.perf_counter()
    g, _ = build_dist_graph(u, v, w, n, NUM_SHARDS, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    real = segmin_ops.owner_scatter_min

    def keep_first_inputs(*args):
        if captured is not None and "args" not in captured:
            captured["args"] = tuple(a.clone() for a in args[:6])
            captured["size"] = args[6]
        return real(*args)

    segmin_ops.owner_scatter_min = keep_first_inputs
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern = ds.distributed_sharded_msf(g, n, NUM_SHARDS,
                                          algorithm=algorithm,
                                          pallas_minedges=True, **OFF)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        segmin_ops.owner_scatter_min = real
    plain = ds.distributed_sharded_msf(g, n, NUM_SHARDS, algorithm=algorithm,
                                       pallas_minedges=False, **OFF)
    torch.cuda.synchronize()
    names = ("mask", "weight", "count", "labels", "overflow")
    for name, a, b in zip(names, kern[:5], plain[:5]):
        check(torch.equal(a, b), f"{algorithm}: K1 path {name} differs "
              "from the plain scatter path")
    for field, a, b in zip(kern[5]._fields, kern[5], plain[5]):
        check(torch.equal(a, b), f"{algorithm}: CommStats.{field} differs "
              "between the K1 and plain paths")
    check(int(kern[4]) == 0, f"{algorithm}: overflow {int(kern[4])}")
    return g, kern, seconds, layout_s


def kruskal_check(u, v, w, n, mask, what):
    import numpy as np
    from repro_torch.core import oracle
    kmask, _ = oracle.kruskal(u, v, w, n)
    check(np.array_equal(mask.cpu().numpy(), kmask),
          f"{what}: edge set differs from Kruskal")


# ---------------------------------------------------------------------------
# phase 5: K1 timing at the engine's shape
# ---------------------------------------------------------------------------

def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_k1(args, size):
    import torch
    from repro_torch.kernels.segmin.ref import owner_scatter_min_ref
    from repro_torch.kernels.segmin.segmin import owner_scatter_min

    idx, w, eid, pay1, pay2, ok = args
    rows, L = idx.shape
    got = owner_scatter_min(*args, size)
    exp = owner_scatter_min_ref(*args, size)
    torch.cuda.synchronize()
    equal = all(torch.equal(g, e) for g, e in zip(got, exp))
    err = max_abs_diff(got, exp)
    # winning lanes: the ok lanes that tie their slot's (wmin, emin) in
    # the plain version's tables; only they need their payloads read
    row = torch.arange(rows, device=idx.device).view(-1, 1)
    live = ok & (idx >= 0) & (idx < size)
    slot = idx.long().clamp(0, max(size - 1, 0)) + row * size
    n_win = int((live & (w == exp[0].reshape(-1)[slot])
                 & (eid == exp[1].reshape(-1)[slot])).sum())
    n_ok = int(live.sum())
    del got, exp, slot
    plain_ms = time_ms(lambda: owner_scatter_min_ref(*args, size), 3)
    ms = time_ms(lambda: owner_scatter_min(*args, size), 20)
    # library yardstick: one scatter_reduce_ amin of a packed (w, eid)
    # int64 key (w > 0 on this path, so its bits order as integers); lanes
    # that are not ok carry the neutral key, spread over the row's slots
    # so they do not all contend on one
    spread = torch.arange(L, device=idx.device) % size
    slot = torch.where(ok, idx.long(), spread)
    flat = (slot + torch.arange(rows, device=idx.device).view(-1, 1)
            * size).reshape(-1)
    key = torch.where(ok, (w.view(torch.int32).long() << 32) | eid.long(),
                      torch.iinfo(torch.int64).max).reshape(-1)
    table = torch.empty(rows * size, dtype=torch.int64, device=idx.device)
    library_ms = time_ms(lambda: table.fill_(torch.iinfo(torch.int64).max)
                         .scatter_reduce_(0, flat, key, "amin"), 20)
    # each lane's ok byte read once, idx/w/eid (12 B) of each ok lane,
    # pay1/pay2 (8 B) of each winning lane, 16 B written per slot
    bytes_moved = rows * L + 12 * n_ok + 8 * n_win + 16 * rows * size
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return dict(equal=equal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, lanes=rows * L,
                ok_lanes=n_ok, win_lanes=n_win, slots=rows * size,
                bytes=bytes_moved)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: FAILED: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: no CUDA device — this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: FAILED: {src / 'repro_torch'} not found — run "
              "chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.core.graph import from_numpy
    from repro_torch.core.mst import minimum_spanning_forest
    from repro_torch.data import generators
    from repro_torch.kernels import _build
    from repro_torch.kernels.segmin.segmin import owner_scatter_min

    dev = torch.device("cuda")
    smi = gpu_line()
    log(f"gpu: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 1: build
    t0 = time.perf_counter()
    per_kernel = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in per_kernel.items())})")
    for name in per_kernel:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # phase 2: parity wall
    k1_parity_wall(dev)

    # phase 3: the main path on GNM
    t0 = time.perf_counter()
    u, v, w, n = generators.gnm(GNM_N, GNM_M, seed=SEED)
    log(f"gnm: n={n} m={len(u)} generated in "
        f"{time.perf_counter() - t0:.1f} s")
    ref_weight, ref_count = scipy_msf(u, v, w, n)
    captured = {}
    launches = {}
    for algorithm in ("boruvka", "filter_boruvka"):
        torch.cuda.reset_peak_memory_stats()
        mask, weight, secs, k1 = run_main_path(dev, u, v, w, n, algorithm)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        count = int(mask.sum())
        rel = abs(float(weight) - ref_weight) / ref_weight
        log(f"main path gnm {algorithm}: solve {secs:.3f} s wall "
            f"(public API, incl. host layout build) after one warm-up; "
            f"K1 launches {k1}; edges {count} (scipy {ref_count}); "
            f"weight {float(weight):.1f} (scipy {ref_weight:.1f}, rel "
            f"{rel:.2e}); peak device memory {peak:.2f} GiB")
        check(k1 > 0, f"{algorithm}: the main path launched K1 no time")
        check(count == ref_count, f"{algorithm}: {count} MSF edges, scipy "
              f"{ref_count}")
        check(rel < 1e-3, f"{algorithm}: weight off by {rel:.2e} relative")
        launches[algorithm] = k1
        g, res, engine_s, layout_s = compare_engine_paths(
            dev, u, v, w, n, algorithm,
            captured if algorithm == "boruvka" else None)
        sel = np.unique(g.eid.cpu().numpy()[res[0].cpu().numpy()])
        check(np.array_equal(sel, np.nonzero(mask.cpu().numpy())[0]),
              f"{algorithm}: public API and engine edge sets differ")
        stats = {f: float(x) for f, x in zip(res[5]._fields, res[5])}
        log(f"engine gnm {algorithm}: {engine_s:.3f} s on a prebuilt "
            f"layout (host layout build {layout_s:.3f} s), K1 and plain "
            f"paths equal (mask, labels, overflow 0, "
            f"CommStats {json.dumps(stats)})")
        del g, res, mask

    # phase 4: RMAT through the same call, and the static engine
    ru, rv, rw, rn = generators.rmat(RMAT_SCALE, (1 << RMAT_SCALE)
                                     * RMAT_DEGREE // 2, seed=SEED)
    edges = from_numpy(ru, rv, rw, rn, device=dev)
    mask, _ = minimum_spanning_forest(
        edges, engine="distributed_sharded", num_shards=NUM_SHARDS,
        algorithm="boruvka", pallas_minedges=True, **OFF)
    kruskal_check(ru, rv, rw, rn, mask, "rmat distributed_sharded")
    mask, _ = minimum_spanning_forest(edges, engine="static")
    kruskal_check(ru, rv, rw, rn, mask, "rmat static")
    log(f"rmat scale {RMAT_SCALE} (n={rn}, m={len(ru)}): sharded and "
        "static engines equal the Kruskal edge set")

    # phase 5: K1 at the engine's shape
    args, size = captured["args"], captured["size"]
    k1 = time_k1(args, size)
    log(f"k1 engine shape: rows={args[0].shape[0]} L={args[0].shape[1]} "
        f"size={size} ok lanes={k1['ok_lanes']} winning lanes="
        f"{k1['win_lanes']} max|diff|="
        f"{k1['max_abs_err']} equal={k1['equal']}")
    check(k1["equal"], "K1 differs from its plain version at the engine's "
          "shape")
    log(f"k1 timing: {k1['ms']:.4f} ms/launch, plain {k1['plain_ms']:.4f} "
        f"ms, library scatter_reduce_ {k1['library_ms']:.4f} ms, bound "
        f"{k1['bound_ms']:.4f} ms ({k1['bytes']} B at 3.35 TB/s); "
        f"launches per solve: {json.dumps(launches)}")

    kernels = [dict(name="owner_scatter_min", route="cuda",
                    source=K1_SOURCE, replaces=K1_REPLACES,
                    launches=launches["boruvka"],
                    max_abs_err=k1["max_abs_err"], ms=k1["ms"],
                    plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
                    bound_by="bytes", library_ms=k1["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
