#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit 1):

  1. build every CUDA kernel from the sources in this checkout (one
     ``nvcc`` per source, all at once) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card: the
     wall of edge cases (tie storms, +inf tails, all-dead, L = 0/1,
     size 0, non-dividing lengths, stacked shards; for K1 also rows of
     L = 15, 17 and 4097, ok prefixes that end mid-group, all-dead
     groups beside all-ok ones, a 2^20-lane hot-slot storm that
     overflows the candidate list, keys decreasing in lane order, inputs
     sliced one element in, and the per-run combine's class of input —
     sorted run ids whose runs cross 16-lane groups, warp tiles and
     rows, size = L, dead lanes in mid-run — each with pay1 aliased to
     pay2 and not), exact equality;
  3. drive the main path: ``minimum_spanning_forest(engine=
     "distributed_sharded", num_shards=8, pallas_minedges=True)`` with
     no other lever argument — the reference's defaults, so the
     ghost-vertex label cache with its flat push and the
     shrinking-capacity driver — on GNM n = 2^20, m = 2^23 (seed 0),
     for both algorithms.  K1 must launch at both MINEDGES sites in
     every round (the per-run combine and the owner-side scatter-min,
     counted apart); the result must equal the same solve through the
     plain scatter path on one prebuilt layout (edge set, labels,
     overflow = 0, every CommStats field, every round_trace row) and
     match scipy's MST weight within 1e-3 relative with
     n - #components edges.  The time spent in the driver's host bounds
     is reported apart;
  3d. (run right after phase 3's cached path) plan and replay the main
     path on phase 3's prebuilt layout, for each algorithm:
     ``plan_sharded_msf(pallas_minedges=True)`` timed (the measurement
     pass), its JSON round-tripped, then
     ``execute_plan(replan=False)`` once to warm up and once timed with
     the counts set to 0: its mask must equal phase 3's driven solve,
     overflow 0, weight and edge count as scipy's, no host bound called,
     K1 at both sites in every round that is not a sentinel.  The
     replay, measurement and driven engine times are printed side by
     side.  Then (boruvka) ``plan.pad(0.5)`` replayed with replans
     allowed on the same u, v with the weights shuffled by
     ``default_rng(1)``, whose forest weight must equal scipy's; and on
     RMAT a plan cut to 2 rounds and one with ``cap_edge=1`` must raise
     under ``replan=False`` and give the driven mask under
     ``replan=True``;
  3e. (run right after phase 3d, on its layout, boruvka plan and second
     graph) the robustness paths, each a hard check with K1 counted
     apart: ``execute_plan(verify=True)`` equal to the strict replay and
     timed against it (the verifier's overhead); ``ckpt_every=3`` with
     every checkpoint's CRCs checked and every resume equal to the plain
     replay (checkpoint count, bytes, certify + snapshot time); the
     driven engine killed by an ``abort`` fault in round 3 with
     ``ckpt_every=2``, resumed from its last checkpoint to phase 3's
     driven mask with at most 2 rounds run again; ``execute_plan_batched``
     of both graphs under ``plan.pad(0.5)`` with ``verify=True``, each
     request equal to its own strict replay, timed against two single
     replays; a ``corrupt`` fault at ``minedges`` (fraction 0.25, bit 26)
     detected or tolerated, then a fault-free replay equal to the
     baseline; and the chaos harness (``repro_torch.launch.chaos``) at
     n = 512 on the card — the planned and batched matrix on gnm and
     rgg2d, the grid-push cells, the recovery cells — with no ``SILENT``
     cell;
  3b. the earlier paths, each checked the same way: the lever path
     (``ghost_cache=False``, every other lever on), whose edge set the
     cached path must equal while serving hits, pushing, and shipping
     fewer lookup and push items (misses + pushed) than its misses; and
     every lever off (``OFF``).  Only the main path gets a warm-up;
  3c. the grid rung: ``num_shards=(4, 2), ghost_push="grid"`` (boruvka,
     same graph), whose mask must equal the flat push's, with every
     round a ghost round through the grid push and K1 at both sites;
  4. the cached, lever and ``OFF`` paths on RMAT (scale 16, average
     degree 8) and the static engine on that graph, all against the
     exact Kruskal edge set;
  5. time K1 at the two shapes the engine gave it — the ``OFF`` path's
     owner-side scatter-min (pay1 and pay2 one buffer, as the engine
     passes them) and the main path's round-1 per-run combine (sorted
     run ids, size = L, pay1 and pay2 two buffers) — with CUDA events,
     beside its plain version, one ``scatter_reduce_`` over a packed key
     as a library yardstick, and its bound from device-memory bytes;
     split its time among its launches with ``torch.profiler``;
  2b. (run right after phase 2) hold K2 (``relabel``) and K3
     (``segmin_candidates``) against their plain versions on their walls
     (the reference's test shapes, +inf tails, out-of-range and negative
     indices, m = 0; sorted runs, ties, piecewise runs, all-dead,
     m = 1/7, blocks from 3 to 4096 that do not divide m, runs across
     thread chunks, warps and tiles, inputs sliced one element in),
     exact equality with -0.0 == +0.0;
  6. the single-device Borůvka selection through K2 and K3: on GNM
     n = 2^20 and n = 2^15 (m = 2^23, seed 0), the directed both-copy
     list (2^24 edges, sorted by source), and in every Borůvka round
     ``relabel_edges`` then ``min_edges_dense`` — equal to their plain
     versions bit for bit and to ``min_edge_per_component`` on the
     undirected list; each kernel launches once per round;
  7. the single-device engines: ``engine="static"`` with both
     algorithms on the GNM 2^20 graph against scipy (solve time, peak
     memory), and on RMAT ``static`` filter_boruvka and ``dynamic`` with
     both algorithms against the Kruskal edge set;
  8. time K2 and K3 at phase 6's 2^24-edge shape (round-1 and round-3
     labels, and K2's 2^15-entry table) beside their plain versions and
     their bounds from device-memory bytes, and K3 beside one
     ``scatter_reduce_`` of a packed key into a per-run table.

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
# the main path is the reference's defaults (the ghost cache on); the
# earlier paths drop the cache, then every lever
CACHED = dict()
LEVERS = dict(ghost_cache=False)
PATHS = {"cached": CACHED, "levers": LEVERS, "OFF": OFF}
GRID_SHARDS = (4, 2)  # the grid rung: the cache's two-hop push
GRID = dict(ghost_push="grid")
SMALL_N = 1 << 15  # K2's resident-table regime (n' <= 35 000)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
K1_SOURCE = "src/repro_torch/kernels/segmin/csrc/owner_scatter_min.cu"
K1_REPLACES = "src/repro/kernels/segmin/segmin.py:176"
K2_SOURCE = "src/repro_torch/kernels/relabel/csrc/relabel.cu"
K2_REPLACES = "src/repro/kernels/relabel/relabel.py:45"
K3_SOURCE = "src/repro_torch/kernels/segmin/csrc/segmin_candidates.cu"
K3_REPLACES = "src/repro/kernels/segmin/segmin.py:242"
NO_LIBRARY = ("no single PyTorch call computes K2: a gather gives the "
              "labels but not the self-loop kill in one pass")


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


def _prefix_ok(rng, rows, L, seg_len, prefixes):
    """K1 inputs laid out as the engine's exchange buffers: each row is
    segments of ``seg_len`` lanes whose ok lanes are a prefix of the
    segment (lengths drawn from ``prefixes``); idx of dead lanes is 0."""
    import numpy as np
    idx, w, eid, pay1, pay2, _ = _candidates(rng, L, 97, True, False,
                                             rows=rows)
    lane = np.arange(L) % seg_len
    lens = rng.choice(prefixes, (rows, L // seg_len + 1))
    ok = lane[None, :] < np.repeat(lens, seg_len, axis=1)[:, :L]
    idx[~ok] = 0
    return idx, w, eid, pay1, pay2, ok


def _combine_site(rng, rows, L):
    """K1 inputs of the per-run combine's class: per row the run ids of
    sorted runs (lengths 1 to 1499, cut at row ends, so runs cross
    16-lane groups, 512-lane warp tiles and rows), tie-heavy weights,
    pay2 constant along a run and pay1 not, 30% of the lanes dead in
    mid-run (w = +inf, as the engine passes them) and every fifth run
    dead."""
    import numpy as np
    total = rows * L
    ends = np.cumsum(rng.integers(1, 1500, 2 * total // 750 + 16))
    check(ends[-1] >= total, "combine-site case: the runs do not fill "
          "the rows")
    run = np.zeros(total, np.int64)
    run[ends[ends < total]] = 1
    run = np.cumsum(run).reshape(rows, L)
    idx = (run - run[:, :1]).astype(np.int32)  # each row from run 0
    w = rng.integers(1, 6, (rows, L)).astype(np.float32)
    eid = rng.integers(0, 2 ** 20, (rows, L)).astype(np.int32)
    pay1 = rng.integers(0, 1 << 20, (rows, L)).astype(np.int32)
    pay2 = (run * 7919 % 100003).astype(np.int32)
    ok = (rng.random((rows, L)) < 0.7) & (run % 5 != 0)
    w[~ok] = np.inf
    return idx, w, eid, pay1, pay2, ok


def k1_parity_wall(dev) -> None:
    import numpy as np
    import torch

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
    # rows whose L is not a multiple of 16 (the scalar path)
    for L in (15, 17, 4097):
        cases.append((f"stacked_3x{L}", _candidates(rng, L, 50, True, True,
                                                     rows=3), 50))
    # ok prefixes that start and end mid-group, and all-dead groups next
    # to all-ok ones, on the 16-lane path
    cases.append(("prefix_mid_group_4x8192", _prefix_ok(
        rng, 4, 8192, 1024, [0, 1, 7, 8, 9, 15, 17, 333, 1023, 1024]), 97))
    cases.append(("prefix_whole_groups_2x8192", _prefix_ok(
        rng, 2, 8192, 2048, [0, 512, 1024, 2048]), 97))
    # a hot-slot storm: 2^20 lanes on 2 slots, exact (w, eid) ties and
    # different payloads; every lane passes the filter, so the list
    # overflows and the payloads take the full pass
    storm = 1 << 20
    cases.append(("hot_slot_storm_2^20", (
        (np.arange(storm) % 2).astype(np.int32),
        np.full(storm, 3.0, np.float32), np.full(storm, 77, np.int32),
        rng.integers(0, 1 << 30, storm).astype(np.int32),
        rng.integers(0, 1 << 30, storm).astype(np.int32),
        np.ones(storm, bool)), 2))
    # keys decreasing in lane order: later lanes keep lowering the keys,
    # so many take the atomic and the list
    dec = 1 << 16
    cases.append(("decreasing_keys_2^16", (
        (np.arange(dec) % 16).astype(np.int32),
        np.linspace(1000, 1, dec).astype(np.float32),
        np.arange(dec)[::-1].astype(np.int32),
        rng.integers(0, 100, dec).astype(np.int32),
        rng.integers(0, 100, dec).astype(np.int32), np.ones(dec, bool)), 16))
    # the per-run combine's class: sorted run ids, size = L, pay1 != pay2
    for rows, L in ((8, 65536), (3, 4097)):
        cases.append((f"combine_sorted_{rows}x{L}",
                      _combine_site(rng, rows, L), L))
    for name, arrays, size in cases:
        for alias in (False, True):
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            if alias:
                args[4] = args[3]
            _k1_case(f"{name}{' alias' if alias else ''}", args, size)
    # inputs sliced one element in: no pointer is 16-byte aligned
    idx, w, eid, p1, p2, ok = _prefix_ok(rng, 1, 4097, 4097,
                                         [0, 1, 2049, 4097])
    full = [torch.from_numpy(a[0]).to(dev) for a in (idx, w, eid, p1, p2,
                                                      ok)]
    _k1_case("sliced_offset_1", [a[1:] for a in full], 97)
    _k1_case("sliced_offset_1 ok only",
             [a[:-1] for a in full[:5]] + [full[5][1:]], 97)


def list_use_text(use) -> str:
    """K1's list use as the logs show it: lanes listed for the payload
    pass, entries the warps reserved (128 at a time), the capacity."""
    if use is None:
        return ""
    listed = ("(overflow: full pass)" if use.listed is None
              else f"listed={use.listed}")
    return f" {listed} reserved={use.reserved} capacity={use.capacity}"


def _k1_case(name, args, size) -> None:
    """K1 against its plain version on one wall case, with what it put on
    the list of its payload pass."""
    import torch
    from repro_torch.kernels.segmin.ref import owner_scatter_min_ref
    from repro_torch.kernels.segmin.segmin import owner_scatter_min_list_use
    got, use = owner_scatter_min_list_use(*args, size)
    exp = owner_scatter_min_ref(*args, size)
    torch.cuda.synchronize()
    equal = all(torch.equal(g, e) for g, e in zip(got, exp))
    err = max_abs_diff(got, exp)
    log(f"k1 parity {name}: shape={tuple(args[0].shape)} size={size}"
        f"{list_use_text(use)} max|diff|={err} equal={equal}")
    check(equal, f"K1 differs from its plain version on {name}")


def _relabel_case(rng, m, n, inf_tail=False):
    """K2 inputs as in the reference's relabel test: random endpoints, a
    pointer-doubled label forest, 10% +inf weights (or a 10% +inf
    tail)."""
    import numpy as np
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(1, 255, m).astype(np.float32)
    if inf_tail:
        w[m - m // 10:] = np.inf
    else:
        w[rng.random(m) < 0.1] = np.inf
    lab = np.minimum(rng.integers(0, n, n),
                     np.arange(n)).astype(np.int32)
    for _ in range(20):
        lab = lab[lab]
    return u, v, w, lab


def k2_parity_wall(dev) -> float:
    import numpy as np
    import torch
    from repro_torch.kernels.relabel.ref import relabel_ref
    from repro_torch.kernels.relabel.relabel import relabel

    rng = np.random.default_rng(11)
    cases = [(f"shape_{m}x{n}", _relabel_case(rng, m, n))
             for m, n in ((16, 8), (500, 100), (2048, 35000))]
    cases.append(("inf_tail_10pct", _relabel_case(rng, 5000, 300, True)))
    u, v, w, lab = _relabel_case(rng, 4001, 10)
    u[::3] = rng.integers(-25, 25, u[::3].shape)  # negative, past n'
    v[1::3] = rng.integers(-25, 25, v[1::3].shape)
    w[::17] = np.nan
    w[5::17] = -np.inf
    cases.append(("out_of_range_negative", (u, v, w, lab)))
    cases.append(("empty", (np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.float32), lab)))
    worst = 0.0
    for name, arrays in cases:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        got = relabel(*args)
        exp = relabel_ref(*args)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, e) for g, e in zip(got, exp))
        err = max_abs_diff(got, exp)
        worst = max(worst, err)
        log(f"k2 parity {name}: m={args[0].shape[0]} n'={args[3].shape[0]} "
            f"max|diff|={err} equal={equal}")
        check(equal, f"K2 differs from its plain version on {name}")
    return worst


def _sorted_runs(rng, m, n, tie_heavy=False):
    """K3 inputs as in the reference's segmin tests: sorted seg, uniform
    or tie-heavy weights, a permutation of eids, 80% alive."""
    import numpy as np
    seg = np.sort(rng.integers(0, n, m)).astype(np.int32)
    if tie_heavy:
        w = rng.integers(1, 4, m).astype(np.float32)
    else:
        w = rng.uniform(1, 255, m).astype(np.float32)
    return (seg, w, rng.permutation(m).astype(np.int32),
            rng.random(m) < 0.8)


def k3_parity_wall(dev) -> float:
    import numpy as np
    import torch
    from repro_torch.kernels.segmin.ops import min_edges_dense
    from repro_torch.kernels.segmin.ref import segmin_candidates_ref
    from repro_torch.kernels.segmin.segmin import segmin_candidates

    rng = np.random.default_rng(13)
    cases = [(f"sorted_{m}_b{b}", _sorted_runs(rng, m, max(4, m // 4)), b)
             for m in (8, 100, 512, 1000, 2048) for b in (128, 512)]
    cases.append(("tie_heavy", _sorted_runs(rng, 777, 50, True), 128))
    seg = np.repeat([5, 2, 9, 2, 0], [7, 3, 11, 4, 6]).astype(np.int32)
    cases.append(("piecewise", (seg, rng.uniform(1, 9, 31).astype(
        np.float32), np.arange(31, dtype=np.int32), np.ones(31, bool)), 8))
    seg, w, eid, _ = _sorted_runs(rng, 3000, 64)
    cases.append(("all_dead", (seg, w, eid, np.zeros(3000, bool)), 512))
    for m in (1, 7):
        cases.append((f"m{m}", _sorted_runs(rng, m, 3), 512))
    for b in (8, 100, 1024, 4096):
        cases.append((f"ragged_b{b}", _sorted_runs(rng, 10007, 2500,
                                                   b == 100), b))
    for b in (3, 4, 5, 13, 516):
        cases.append((f"ragged_b{b}", _sorted_runs(rng, 10007, 2500,
                                                   b == 5), b))
    # runs that cross thread chunks (4 elements), warps (128) and tiles
    # (512), with unsorted seg whose values recur
    lens = [1, 3, 4, 5, 127, 128, 129, 600, 2, 1100, 33, 4000]
    seg = np.repeat(np.arange(len(lens)) % 5, lens).astype(np.int32)
    runs = (seg, rng.choice(np.array([0.0, -0.0, 1.0, np.inf], np.float32),
                            len(seg)),
            rng.integers(0, 50, len(seg)).astype(np.int32),
            rng.random(len(seg)) < 0.7)
    for b in (512, 513, 2048):
        cases.append((f"long_runs_b{b}", runs, b))
    # inputs sliced one element in: no pointer is 16-byte aligned
    seg, w, eid, alive = _sorted_runs(rng, 5001, 600)
    cases.append(("sliced_offset_1", (seg, w, eid, alive), 512))
    worst = 0.0
    for name, arrays, block in cases:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        if name.startswith("sliced"):
            args = [a[1:] for a in args]
        m = args[0].shape[0]
        got = segmin_candidates(*args, block=block)
        exp = segmin_candidates_ref(*args, min(block, max(m, 8)))
        n = int(args[0].max()) + 1
        dense = min_edges_dense(*args, n, block=block)
        dense_plain = min_edges_dense(*args, n, use_kernel=False)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, e) for g, e in zip(got, exp))
        dense_equal = all(torch.equal(g, e)
                          for g, e in zip(dense, dense_plain))
        err = max(max_abs_diff(got, exp), max_abs_diff(dense, dense_plain))
        worst = max(worst, err)
        log(f"k3 parity {name}: m={m} block={block} max|diff|={err} "
            f"equal={equal} dense_equal={dense_equal}")
        check(equal, f"K3 differs from its plain version on {name}")
        check(dense_equal, f"min_edges_dense through K3 differs from the "
              f"plain path on {name}")
    return worst


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


class K1Sites:
    """While active, counts K1's launches at each MINEDGES site apart —
    ``owner`` inside ``_owner_scatter_min``, ``combine`` (the src-only
    per-run combine) everywhere else — from the wrapper's own launch
    count, and keeps a copy of the inputs of the first launch at the
    site named by ``capture``."""

    def __init__(self, capture=None):
        self.owner = 0
        self.combine = 0
        self.capture = capture
        self.captured = None

    def __enter__(self):
        from repro_torch.core import distributed_sharded as ds
        from repro_torch.kernels.segmin import ops as segmin_ops
        from repro_torch.kernels.segmin.segmin import owner_scatter_min
        self._saved = (ds, ds._owner_scatter_min, segmin_ops,
                       segmin_ops.owner_scatter_min)
        site_fn, k1_fn = self._saved[1], self._saved[3]
        inside = []

        def owner_site(*args, **kw):
            inside.append(True)
            try:
                return site_fn(*args, **kw)
            finally:
                inside.pop()

        def k1(*args):
            site = "owner" if inside else "combine"
            before = owner_scatter_min.launches
            out = k1_fn(*args)
            launched = owner_scatter_min.launches - before
            setattr(self, site, getattr(self, site) + launched)
            if (launched and site == self.capture
                    and self.captured is None):
                # one copy per tensor, so that a payload passed as both
                # pay1 and pay2 (as the owner site does) stays one buffer
                copies = {}
                self.captured = (tuple(copies.setdefault(id(a), a.clone())
                                       for a in args[:6]), args[6])
            return out

        ds._owner_scatter_min = owner_site
        segmin_ops.owner_scatter_min = k1
        return self

    def __exit__(self, *exc):
        ds, site_fn, segmin_ops, k1_fn = self._saved
        ds._owner_scatter_min = site_fn
        segmin_ops.owner_scatter_min = k1_fn
        return False


class HostBounds:
    """While active, the host clock spent in the shrinking driver's numpy
    bounds: the host copy of the layout and its run structure
    (``_HostGraph``), the lookup bound of the whole graph, each round's
    bounds (``_host_round_caps``, the push bounds inside it), and the
    ghost cache's: the cached-vertex and root tables, the table sizes,
    the fill and subscription bounds.  ``seconds`` counts nested calls
    once; ``by_name`` holds each function's own total, nested or not."""

    GHOST = ("_host_ghost_table", "_root_table",
             "_HostGraph.ghost_table_sizes",
             "_ghost_fill_bounds", "_subscribe_capacity_bound",
             "_push_capacity_bound", "_push_capacity_bound_grid")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self.by_name = {}

    def ghost_seconds(self) -> float:
        """The cache's own bounds: none of them nests in another."""
        return sum(self.by_name.get(k, 0.0) for k in self.GHOST)

    def text(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.by_name.items())

    def __enter__(self):
        from repro_torch.core import distributed_sharded as ds
        self._ds = ds
        self._saved = {name: getattr(ds, name)
                       for name in ("_lookup_bound", "_host_round_caps",
                                    "_host_ghost_table", "_root_table",
                                    "_ghost_fill_bounds",
                                    "_subscribe_capacity_bound",
                                    "_push_capacity_bound",
                                    "_push_capacity_bound_grid")}
        self._init = ds._HostGraph.__init__
        self._sizes = ds._HostGraph.ghost_table_sizes
        depth = [0]

        def timed(fn):
            name = fn.__qualname__

            def run(*args, **kw):
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    depth[0] -= 1
                    dt = time.perf_counter() - t0
                    self.by_name[name] = self.by_name.get(name, 0.0) + dt
                    if depth[0] == 0:
                        self.seconds += dt
                        self.calls += 1
            return run

        for name, fn in self._saved.items():
            setattr(ds, name, timed(fn))
        ds._HostGraph.__init__ = timed(self._init)
        ds._HostGraph.ghost_table_sizes = timed(self._sizes)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._ds, name, fn)
        self._ds._HostGraph.__init__ = self._init
        self._ds._HostGraph.ghost_table_sizes = self._sizes
        return False


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.relabel.relabel import relabel
    from repro_torch.kernels.segmin.segmin import (owner_scatter_min,
                                                   segmin_candidates)
    for fn in (owner_scatter_min, relabel, segmin_candidates):
        fn.launches = 0


def run_main_path(dev, u, v, w, n, algorithm, levers, warm=True,
                  num_shards=NUM_SHARDS):
    """With ``warm`` one warm-up, then the counted solve through the
    public entry point with the counts set to 0 just before it.  Returns
    (mask, weight, seconds, K1 sites, round_trace, ``HostBounds``)."""
    import torch
    from repro_torch.core.graph import from_numpy
    from repro_torch.core.mst import minimum_spanning_forest

    edges = from_numpy(u, v, w, n, device=dev)
    kw = dict(engine="distributed_sharded", num_shards=num_shards,
              algorithm=algorithm, pallas_minedges=True, **levers)
    if warm:
        minimum_spanning_forest(edges, **kw)
    torch.cuda.synchronize()
    trace = []
    reset_counts()
    with K1Sites() as sites, HostBounds() as host:
        t0 = time.perf_counter()
        mask, weight = minimum_spanning_forest(edges, round_trace=trace,
                                               **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return mask, weight, seconds, sites, trace, host


def compare_engine_paths(dev, u, v, w, n, algorithm, levers, capture=None):
    """The engine on one prebuilt layout through K1 and through the
    plain scatters: every output and round_trace row must be equal.
    ``capture`` names the K1 site whose first launch's inputs are kept,
    to time K1 at the engine's shape.  Returns (graph, result, engine
    seconds, host layout build seconds, K1 sites, round_trace,
    ``HostBounds``)."""
    import torch
    from repro_torch.core import distributed_sharded as ds
    from repro_torch.core.distributed import build_dist_graph

    t0 = time.perf_counter()
    g, _ = build_dist_graph(u, v, w, n, NUM_SHARDS, device=dev)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    trace, plain_trace = [], []
    with K1Sites(capture) as sites, HostBounds() as host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern = ds.distributed_sharded_msf(g, n, NUM_SHARDS,
                                          algorithm=algorithm,
                                          pallas_minedges=True,
                                          round_trace=trace, **levers)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    plain = ds.distributed_sharded_msf(g, n, NUM_SHARDS, algorithm=algorithm,
                                       pallas_minedges=False,
                                       round_trace=plain_trace, **levers)
    torch.cuda.synchronize()
    names = ("mask", "weight", "count", "labels", "overflow")
    for name, a, b in zip(names, kern[:5], plain[:5]):
        check(torch.equal(a, b), f"{algorithm}: K1 path {name} differs "
              "from the plain scatter path")
    for field, a, b in zip(kern[5]._fields, kern[5], plain[5]):
        check(torch.equal(a, b), f"{algorithm}: CommStats.{field} differs "
              "between the K1 and plain paths")
    check(trace == plain_trace, f"{algorithm}: round_trace differs between "
          "the K1 and plain paths")
    check(int(kern[4]) == 0, f"{algorithm}: overflow {int(kern[4])}")
    return g, kern, seconds, layout_s, sites, trace, host


def check_solve(what, mask, weight, secs, sites, trace, host, k1, peak,
                ref_weight, ref_count, combine):
    """Log one counted public-API solve and hold it to scipy and to K1's
    launch contract: both MINEDGES sites in every round where the path
    has the per-run combine (``combine``), the owner site alone
    otherwise."""
    count = int(mask.sum())
    rel = abs(float(weight) - ref_weight) / ref_weight
    log(f"{what} gnm: solve {secs:.3f} s wall (public API, incl. host "
        f"layout build; {host.seconds:.3f} s of it in the driver's host "
        f"bounds, {host.ghost_seconds():.3f} s of those the cache's); "
        f"K1 launches {k1} (per-run combine {sites.combine}, owner-side "
        f"{sites.owner}); round_trace rows {len(trace)}; edges {count} "
        f"(scipy {ref_count}); weight {float(weight):.1f} (scipy "
        f"{ref_weight:.1f}, rel {rel:.2e}); peak device memory "
        f"{peak:.2f} GiB")
    check(k1 > 0, f"{what}: the path launched K1 no time")
    check(k1 == sites.combine + sites.owner,
          f"{what}: K1 launched outside its two sites")
    if combine:
        check(sites.combine == sites.owner == len(trace) > 0,
              f"{what}: K1 must launch at both MINEDGES sites in each of "
              f"the {len(trace)} rounds (per-run combine {sites.combine}, "
              f"owner-side {sites.owner})")
    else:
        check(sites.combine == 0, f"{what}: the path has no per-run "
              "combine, yet K1 launched there")
    check(count == ref_count, f"{what}: {count} MSF edges, scipy {ref_count}")
    check(rel < 1e-3, f"{what}: weight off by {rel:.2e} relative")


def check_cache_gain(algorithm, mask, stats, cached_mask, cached_stats):
    """The cached path against the lever path: the same edge set, hits
    and pushes, and fewer lookup and push items (misses + pushed) than
    the lever path's misses."""
    import numpy as np
    check(np.array_equal(mask.cpu().numpy(), cached_mask),
          f"{algorithm}: the cached path's edge set differs from the "
          "lever path's")
    shipped = cached_stats["misses"] + cached_stats["pushed"]
    check(cached_stats["hits"] > 0 and cached_stats["pushed"] > 0,
          f"{algorithm}: the cache served no hit or pushed nothing")
    check(shipped < stats["misses"],
          f"{algorithm}: misses + pushed {shipped} with the cache, not "
          f"below the lever path's misses {stats['misses']}")
    log(f"cache against the lever path, gnm {algorithm}: edge sets equal; "
        f"items {cached_stats['items']:.4e} against {stats['items']:.4e} "
        f"({cached_stats['items'] / stats['items']:.3f}x), bytes "
        f"{cached_stats['bytes']:.4e} against {stats['bytes']:.4e} "
        f"({cached_stats['bytes'] / stats['bytes']:.3f}x), calls "
        f"{cached_stats['calls']:.0f} against {stats['calls']:.0f}; misses "
        f"+ pushed {shipped:.4e} against misses {stats['misses']:.4e}")


TRACE_KEYS = ("round", "level", "cap_edge", "cap_lookup", "cap_contract",
              "cap_relabel", "cap_push", "cap_push_col", "cap_push_flat",
              "alive_bound", "a2a_calls", "routed_items", "buffer_bytes",
              "cache_hits", "lookup_items", "pushed_items")


def log_trace(what, trace):
    if trace:
        log(f"{what}: " + json.dumps([[row[k] for k in TRACE_KEYS]
                                      for row in trace])
            + f" as {list(TRACE_KEYS)}")


def kruskal_check(kmask, mask, what):
    import numpy as np
    check(np.array_equal(mask.cpu().numpy(), kmask),
          f"{what}: edge set differs from Kruskal")


# ---------------------------------------------------------------------------
# phase 3d: plan the main path and replay it
# ---------------------------------------------------------------------------

def plan_and_replay(dev, g, n, algorithm, driven, ref_weight, ref_count):
    """Measure a plan of the main path on the prebuilt layout ``g``,
    round-trip its JSON, and replay it strictly: one warm-up, then the
    counted replay with the counts set to 0 just before it.  ``driven``
    holds phase 3's driven solve on the same layout (mask, engine
    seconds, host-bound seconds).  Returns (plan, a dict of figures)."""
    import torch
    from repro_torch.core import distributed_sharded as ds
    from repro_torch.core.plan import RoundPlan
    from repro_torch.kernels.segmin.segmin import owner_scatter_min

    torch.cuda.synchronize()
    with HostBounds() as measure_host:
        t0 = time.perf_counter()
        measured = ds.plan_sharded_msf(g, n, NUM_SHARDS,
                                       algorithm=algorithm,
                                       pallas_minedges=True)
        torch.cuda.synchronize()
        measure_s = time.perf_counter() - t0
    text = measured.to_json()
    plan = RoundPlan.from_json(text)
    check(plan == measured and plan.to_json() == text,
          f"plan {algorithm}: the JSON round trip changed the plan")
    sentinels = sum(r.sentinel for r in plan.rounds)
    log(f"plan gnm {algorithm}: {plan.num_rounds} rounds ({sentinels} "
        f"sentinels) over {len(plan.level_bounds)} levels; ghost tables "
        f"{plan.ghost.table_u} x {plan.ghost.table_v}, fills "
        f"{plan.ghost.cap_fill_u}/{plan.ghost.cap_fill_v}, subscription "
        f"{plan.ghost.cap_subscribe}; JSON {len(text)} B; cap_edge per "
        f"round {[r.cap_edge for r in plan.rounds]}")
    ds.execute_plan(g, n, NUM_SHARDS, plan, replan=False)  # warm-up
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    trace = []
    reset_counts()
    with K1Sites() as sites, HostBounds() as host:
        t0 = time.perf_counter()
        res = ds.execute_plan(g, n, NUM_SHARDS, plan, replan=False,
                              round_trace=trace)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    k1 = owner_scatter_min.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mask, weight, count, _, overflow, _ = res
    rel = abs(float(weight) - ref_weight) / ref_weight
    check(int(overflow) == 0, f"replay {algorithm}: overflow "
          f"{int(overflow)}")
    check(torch.equal(mask, driven["mask"]), f"replay {algorithm}: the "
          "mask differs from phase 3's driven solve on the same layout")
    check(int(count) == ref_count, f"replay {algorithm}: {int(count)} MSF "
          f"edges, scipy {ref_count}")
    check(rel < 1e-3, f"replay {algorithm}: weight off by {rel:.2e} "
          "relative")
    check(host.calls == 0 and trace == [],
          f"replay {algorithm}: a fitting replay ran {host.calls} host "
          "bound calls or filled the round trace")
    real = plan.num_rounds - sentinels
    check(k1 == sites.combine + sites.owner,
          f"replay {algorithm}: K1 launched outside its two sites")
    check(sites.combine >= real and sites.owner >= real,
          f"replay {algorithm}: K1 must launch at both MINEDGES sites in "
          f"each of the {real} rounds that are not sentinels (per-run "
          f"combine {sites.combine}, owner-side {sites.owner})")
    saved = driven["engine_s"] - replay_s
    repays = measure_s / saved if saved > 0 else float("inf")
    stats = {f: float(x) for f, x in zip(res[5]._fields, res[5])}
    log(f"replay gnm {algorithm}: strict replay {replay_s:.3f} s (after one "
        f"warm-up) against phase 3's driven engine {driven['engine_s']:.3f} s "
        f"({driven['host_s']:.3f} s of it host bounds) on the same layout; "
        f"measurement pass {measure_s:.3f} s ({measure_host.seconds:.3f} "
        f"s of it host bounds), repaid by {repays:.2f} "
        f"replays in place of driven solves; mask equals the driven "
        f"solve's, overflow 0, residual 0, no host bound ran; edges "
        f"{int(count)} (scipy {ref_count}); weight {float(weight):.1f} "
        f"(scipy {ref_weight:.1f}, rel {rel:.2e}); K1 launches {k1} "
        f"(per-run combine {sites.combine}, owner-side {sites.owner}) over "
        f"{plan.num_rounds} planned rounds; peak device memory "
        f"{peak:.2f} GiB, {held:.2f} GiB of it held before the replay (the "
        f"layout, phase 3's masks and K1 inputs kept for phase 5); "
        f"CommStats {json.dumps(stats)}")
    return plan, dict(replay_s=replay_s, measure_s=measure_s, peak=peak,
                      rounds=plan.num_rounds, sentinels=sentinels,
                      combine=sites.combine, owner=sites.owner, total=k1)


def replay_second_graph(dev, u, v, w, n, g, plan):
    """The same u, v with weights shuffled by ``default_rng(1)``, laid
    out again, and ``plan.pad(0.5)`` replayed on it with replans allowed:
    its forest's float64 weight must equal scipy's MST weight (the MSF
    weight is unique even where the MSF is not) with n - #components
    edges.  Returns (whether the plan fitted, the second layout)."""
    import numpy as np
    import torch
    from repro_torch.core import distributed_sharded as ds
    from repro_torch.core.distributed import build_dist_graph

    w2 = np.asarray(w).copy()
    np.random.default_rng(1).shuffle(w2)
    g2, _ = build_dist_graph(u, v, w2, n, NUM_SHARDS, device=dev)
    check(g2.cap_total == g.cap_total, "second graph: the layout's "
          f"capacity {g2.cap_total} differs from the plan's {g.cap_total}")
    trace = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ds.execute_plan(g2, n, NUM_SHARDS, plan.pad(0.5), replan=True,
                          round_trace=trace)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # the chosen undirected edges, each once by eid, summed in float64
    sel = np.unique(g2.eid.cpu().numpy()[res[0].cpu().numpy()])
    got, edges = float(np.sum(w2[sel].astype(np.float64))), len(sel)
    exp, exp_edges = scipy_msf(u, v, w2, n)
    check(int(res[4]) == 0, f"second graph: overflow {int(res[4])}")
    check(edges == exp_edges == int(res[2]),
          f"second graph: {edges} MSF edges, scipy {exp_edges}")
    check(abs(got - exp) <= 1e-9 * exp, f"second graph: forest weight "
          f"{got!r} against scipy's {exp!r}")
    fitted = not trace
    log(f"second graph (gnm weights shuffled by default_rng(1)): "
        f"plan.pad(0.5) {'fitted' if fitted else 'replanned'} in "
        f"{secs:.3f} s; forest weight {got!r} equals scipy's {exp!r} "
        f"(float64 sums), {edges} edges")
    return fitted, g2


def never_silent(dev, ru, rv, rw, rn):
    """Plans that do not fit, on RMAT: cut to 2 rounds (residual) and
    with every ``cap_edge = 1`` (overflow) must raise under
    ``replan=False`` and give the driven solve's mask under
    ``replan=True``."""
    import torch
    from repro_torch.core import distributed_sharded as ds
    from repro_torch.core.distributed import build_dist_graph

    rg, _ = build_dist_graph(ru, rv, rw, rn, NUM_SHARDS, device=dev)
    driven = ds.distributed_sharded_msf(rg, rn, NUM_SHARDS,
                                        pallas_minedges=True)
    plan = ds.plan_sharded_msf(rg, rn, NUM_SHARDS, pallas_minedges=True)
    check(plan.num_rounds > 2, f"rmat: a plan of {plan.num_rounds} rounds "
          "cannot be cut short to 2")
    cases = (("short", plan._replace(rounds=plan.rounds[:2]), "residual"),
             ("cap_edge=1", plan._replace(rounds=tuple(
                 r._replace(cap_edge=1) for r in plan.rounds)), "overflow"))
    for name, bad, word in cases:
        try:
            ds.execute_plan(rg, rn, NUM_SHARDS, bad, replan=False)
        except RuntimeError as exc:
            check(word in str(exc), f"rmat {name}: the error does not name "
                  f"the {word}: {exc}")
        else:
            raise SmokeFailure(f"rmat {name}: the strict replay returned")
        res = ds.execute_plan(rg, rn, NUM_SHARDS, bad, replan=True)
        check(int(res[4]) == 0 and torch.equal(res[0], driven[0]),
              f"rmat {name}: the replan differs from the driven solve")
    log(f"never silent, rmat scale {RMAT_SCALE} ({plan.num_rounds}-round "
        "plan): cut to 2 rounds raises naming the residual, cap_edge=1 "
        "raises naming the overflow, and both replan to the driven mask")


# ---------------------------------------------------------------------------
# phase 3e: verified, checkpointed, recovered, batched and faulted replays
# ---------------------------------------------------------------------------

def wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, synced."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(what, fn):
    """``fn()`` with every launch count set to 0 just before it; K1 must
    launch in it.  Returns (result, seconds, K1 launches)."""
    from repro_torch.kernels.segmin.segmin import owner_scatter_min
    reset_counts()
    out, secs = wall(fn)
    k1 = owner_scatter_min.launches
    check(k1 > 0, f"{what}: the path launched K1 no time")
    return out, secs, k1


def same_result(a, b, what):
    """Two engine 6-tuples equal on every output and CommStats field."""
    import torch
    names = ("mask", "weight", "count", "labels", "overflow")
    for name, x, y in zip(names, a[:5], b[:5]):
        check(torch.equal(x, y), f"{what}: {name} differs")
    for field, x, y in zip(a[5]._fields, a[5], b[5]):
        check(torch.equal(x, y), f"{what}: CommStats.{field} differs")


def same_forest(a, b, what):
    """Equal mask, weight and count."""
    import torch
    check(torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])
          and int(a[2]) == int(b[2]), f"{what}: the forest differs")


class Certify:
    """While active, the host clock of each certify + snapshot barrier
    (``_certified_checkpoint``)."""

    def __enter__(self):
        from repro_torch.core import distributed_sharded as ds
        self._ds, self._fn, self.seconds = ds, ds._certified_checkpoint, []

        def timed(*args, **kw):
            out, secs = wall(lambda: self._fn(*args, **kw))
            self.seconds.append(secs)
            return out

        ds._certified_checkpoint = timed
        return self

    def __exit__(self, *exc):
        self._ds._certified_checkpoint = self._fn
        return False


def robustness(dev, g, n, plan, driven_mask, g2, fitted):
    """Phase 3e on phase 3's layout ``g`` with phase 3d's boruvka
    ``plan``; ``g2`` is phase 3d's second graph, which ``plan.pad(0.5)``
    ``fitted``.  Each step is a hard check, with K1 counted per step.
    Returns a dict of figures."""
    import torch
    from repro_torch.comm import faults
    from repro_torch.core import distributed_sharded as ds
    from repro_torch.core.verify import verify_forest
    from repro_torch.launch import chaos

    def replay(**kw):
        return ds.execute_plan(g, n, NUM_SHARDS, plan, replan=False, **kw)

    fig, k1 = {}, {}
    # 1. the verified replay against the plain one, both warmed up
    base = replay()
    replay(verify=True)
    base, fig["replay_s"], _ = counted("strict replay", replay)
    ver, fig["verified_s"], k1["verified_replay"] = counted(
        "verified replay", lambda: replay(verify=True))
    same_result(ver, base, "verified replay")
    check(torch.equal(base[0], driven_mask), "strict replay: the mask "
          "differs from phase 3d's")
    def check_forest():
        return verify_forest(g, n, NUM_SHARDS, base[0], base[3],
                             expected_weight=float(base[1]),
                             expected_count=int(base[2]), device=dev)

    report = check_forest()
    check(report.ok, f"verify: {report.reasons}")
    # the verifier alone, the mean of 5 calls: the overhead itself, which
    # one replay's run-to-run spread hides
    _, secs = wall(lambda: [check_forest() for _ in range(5)])
    fig["verify_alone_s"] = secs / 5
    log(f"3e verified replay gnm boruvka: {report}; verify=True "
        f"{fig['verified_s']:.3f} s against the strict replay "
        f"{fig['replay_s']:.3f} s (difference "
        f"{(fig['verified_s'] - fig['replay_s']) * 1e3:.1f} ms); "
        f"verify_forest alone {fig['verify_alone_s'] * 1e3:.2f} ms (mean "
        f"of 5); K1 launches {k1['verified_replay']}")

    # 2. the checkpointed replay and a resume from each checkpoint
    cks = []
    with Certify() as cert:
        seg, fig["ckpt_replay_s"], k1["checkpointed_replay"] = counted(
            "checkpointed replay",
            lambda: replay(ckpt_every=3, ckpt_out=cks))
    same_forest(seg, base, "checkpointed replay")
    check(torch.equal(seg[3], base[3]), "checkpointed replay: labels differ")
    check(len(cks) >= 1, "checkpointed replay: no certified checkpoint")
    resumes = []
    for ck in cks:
        ck.verify_checksums()
        res, secs, launched = counted(
            f"resume at plan_pos {ck.plan_pos}",
            lambda ck=ck: replay(resume_from=ck))
        same_forest(res, base, f"resume at plan_pos {ck.plan_pos}")
        k1[f"resume_plan_pos_{ck.plan_pos}"] = launched
        resumes.append(f"plan_pos {ck.plan_pos}: {secs:.3f} s")
    fig["ckpt_bytes"] = sum(getattr(cks[0], f).nbytes for f in (
        "lab", "settled", "mask", "dead", "eids", "stats_acc", "checksums"))
    fig["certify_s"] = cert.seconds
    certify = ", ".join(f"{x:.3f}" for x in cert.seconds)
    log(f"3e checkpointed replay (ckpt_every=3): {len(cks)} certified "
        f"checkpoints at plan_pos {[c.plan_pos for c in cks]}; "
        f"{fig['ckpt_replay_s']:.3f} s against {fig['replay_s']:.3f} s "
        f"plain; certify + snapshot {certify} s; one checkpoint "
        f"{fig['ckpt_bytes']} B; every resume equals the plain replay "
        f"({'; '.join(resumes)}); K1 launches "
        f"{k1['checkpointed_replay']}")

    # 3. the driven engine killed in round 3, resumed
    cks = []
    abort = faults.FaultPlan(seed=0, specs=(faults.FaultSpec(
        kind="abort", site="minedges", rounds=(3,)),))

    def killed():
        try:
            with faults.inject(abort):
                ds.distributed_sharded_msf(g, n, NUM_SHARDS,
                                           pallas_minedges=True,
                                           ckpt_every=2, ckpt_out=cks)
        except faults.ShardAbort as exc:  # the death this step injects
            # not the exception: its traceback would hold the dead
            # round's tensors in a cycle through this frame
            return exc.site, exc.round
        raise SmokeFailure("driven recovery: the abort never fired")

    (site, died), fig["killed_s"], k1["driven_until_abort"] = counted(
        "driven run until the abort", killed)
    check(died == 3 and cks, f"driven recovery: died in round {died} with "
          f"{len(cks)} checkpoints")
    ck = cks[-1]
    res, fig["resumed_s"], k1["driven_resume"] = counted(
        "driven resume", lambda: ds.distributed_sharded_msf(
            g, n, NUM_SHARDS, pallas_minedges=True, resume_from=ck))
    check(torch.equal(res[0], driven_mask) and int(res[4]) == 0,
          "driven resume: the mask differs from phase 3's driven solve")
    again = died - 1 - ck.round_index
    check(0 <= again <= 2, f"driven recovery: {again} rounds run again")
    log(f"3e driven recovery: ShardAbort at {site!r} in round "
        f"{died} after {fig['killed_s']:.3f} s; resumed from {ck!r} in "
        f"{fig['resumed_s']:.3f} s, {again} rounds run again; mask equals "
        f"phase 3's driven solve; K1 launches {k1['driven_until_abort']} + "
        f"{k1['driven_resume']}")

    # 4. two graphs through execute_plan_batched, verified, strict
    check(fitted, "batched replay: phase 3d's padded plan did not fit the "
          "second graph, so a strict batch cannot hold it")
    padded = plan.pad(0.5)
    singles = [ds.execute_plan(x, n, NUM_SHARDS, padded, replan=False)
               for x in (g, g2)]
    _, fig["two_singles_s"] = wall(lambda: [
        ds.execute_plan(x, n, NUM_SHARDS, padded, replan=False)
        for x in (g, g2)])
    (results, flagged), fig["batched_s"], k1["batched"] = counted(
        "batched replay", lambda: ds.execute_plan_batched(
            [g, g2], n, NUM_SHARDS, padded, replan=False, verify=True,
            device=dev))
    check(flagged == (), f"batched replay: flagged {flagged}")
    for i, (res, one) in enumerate(zip(results, singles)):
        same_result(res, one, f"batched request {i}")
    log(f"3e batched replay of 2 graphs (plan.pad(0.5), verify=True): "
        f"{fig['batched_s']:.3f} s against two single strict replays "
        f"{fig['two_singles_s']:.3f} s; each request equals its own "
        f"replay, flagged (); K1 launches {k1['batched']}")

    # 5. one fault cell at full width, K1 in the loop
    spec = faults.FaultSpec(kind="corrupt", site="minedges", fraction=0.25,
                            bit=26)
    with faults.inject(faults.FaultPlan(seed=0, specs=(spec,))):
        raw, _, k1["faulted_replay"] = counted(
            "faulted replay", lambda: ds._run_plan(g, n, (NUM_SHARDS,),
                                                   plan))
    injected = float(raw[6].injected)
    verdict, why, _ = chaos._classify(
        g, n, NUM_SHARDS, plan, spec, 0, base[0].cpu().numpy(),
        float(base[1]), int(base[2]))
    check(injected > 0, "faulted replay: nothing injected")
    check(verdict in ("detected", "tolerated"),
          f"faulted replay: {verdict} ({why})")
    after = replay()
    same_result(after, base, "fault-free replay after the fault cell")
    log(f"3e fault cell corrupt@minedges (fraction 0.25, bit 26): "
        f"{injected:.0f} items injected, overflow {int(raw[4])}, residual "
        f"{int(raw[5])}; {verdict} ({why[:160]}); the fault-free replay "
        f"after it equals the baseline; K1 launches "
        f"{k1['faulted_replay']}")

    # 6. the chaos harness on the card at n = 512
    def harness():
        cells = chaos.run_matrix(("gnm", "rgg2d"), 512, 0, batched=True,
                                 verbose=False, device=dev)
        cells += chaos.run_grid_push_cells(512, 0, verbose=False,
                                           device=dev)
        return cells, chaos.run_recovery_cells(("gnm",), 512, 0,
                                               verbose=False, device=dev)

    (cells, rec), fig["chaos_s"], k1["chaos_n512"] = counted(
        "chaos harness", harness)
    counts = {v: sum(c["verdict"] == v for c in cells)
              for v in ("detected", "tolerated", "SILENT")}
    check(counts["SILENT"] == 0, "chaos: silent cells " + json.dumps(
        [c for c in cells if c["verdict"] == "SILENT"]))
    log(f"3e chaos harness n=512 on the card: {len(cells)} cells "
        f"{json.dumps(counts)}, {len(rec)} recovery cells recovered, "
        f"{fig['chaos_s']:.3f} s; K1 launches {k1['chaos_n512']}")
    for c in cells:
        log(f"  {c['fault']:<12} {c['family']:<6} {c['path']:<24} -> "
            f"{c['verdict']}  ({c['why'][:100]})")
    fig["verdicts"] = counts
    fig["k1"] = k1
    return fig


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


def device_split(fn, reps, names):
    """Device time per call of each kernel or copy whose name holds one
    of ``names``, from ``torch.profiler`` over ``reps`` calls of ``fn``;
    ``{}`` where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        for name in names:
            if name in ev.key and us:
                split[name] = split.get(name, 0.0) + us / 1e3 / reps
    return split


K1_STAGES = ("min_pass", "resolve_list", "resolve_all", "Memset", "Memcpy")


def time_k1(args, size):
    import torch
    from repro_torch.kernels.segmin.ref import owner_scatter_min_ref
    from repro_torch.kernels.segmin.segmin import (owner_scatter_min,
                                                   owner_scatter_min_list_use)

    idx, w, eid, pay1, pay2, ok = args
    rows, L = idx.shape
    got, use = owner_scatter_min_list_use(*args, size)
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
    split = device_split(lambda: owner_scatter_min(*args, size), 10,
                         K1_STAGES)
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
    # the payloads of each winning lane (4 B where pay1 and pay2 are one
    # buffer, as the engine passes them, else 8 B), 16 B written per slot
    pay_bytes = 4 if pay1.data_ptr() == pay2.data_ptr() else 8
    bytes_moved = (rows * L + 12 * n_ok + pay_bytes * n_win
                   + 16 * rows * size)
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    return dict(equal=equal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, lanes=rows * L,
                ok_lanes=n_ok, win_lanes=n_win, list_use=use,
                slots=rows * size, bytes=bytes_moved, split=split)


# ---------------------------------------------------------------------------
# phase 6: the single-device Borůvka selection through K2 and K3
# ---------------------------------------------------------------------------

def directed_copies(ut, vt, wt):
    """Both directions of every undirected edge, stably sorted by source,
    with eid = the undirected edge index."""
    import torch
    m = ut.shape[0]
    src = torch.cat([ut, vt])
    order = torch.sort(src, stable=True).indices
    return (src[order], torch.cat([vt, ut])[order],
            torch.cat([wt, wt])[order], (order % m).to(torch.int32))


def selection_rounds(dev, u, v, w, n, keep=(1, 3)):
    """Borůvka rounds from the identity labels until no component
    changes.  Before each round: K2 then K3 (``relabel_edges``, then
    ``min_edges_dense`` on the directed both-copy list), each held bit for
    bit to its plain path, and the dense ``(wmin, emin)`` to
    ``min_edge_per_component`` on the undirected list with the same
    labels (its sentinel ``m`` read as 2^30).  Returns the round count,
    the largest difference seen, the directed list and the labels of the
    rounds in ``keep``."""
    import torch
    from repro_torch.core.boruvka import boruvka_round, \
        min_edge_per_component
    from repro_torch.kernels.relabel.ops import relabel_edges
    from repro_torch.kernels.segmin.ops import min_edges_dense
    from repro_torch.kernels.segmin.ref import EID_SENTINEL

    ut, vt, wt = (torch.from_numpy(x).to(dev) for x in (u, v, w))
    m = ut.shape[0]
    du, dv, dw, eid = directed_copies(ut, vt, wt)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    mst = torch.zeros(m, dtype=torch.bool, device=dev)
    kept = {}
    worst = 0.0
    rounds = 0
    changed = True
    while changed:
        rounds += 1
        if rounds in keep:
            kept[rounds] = labels.clone()
        got = relabel_edges(du, dv, dw, labels)
        exp = relabel_edges(du, dv, dw, labels, use_kernel=False)
        check(all(torch.equal(g, e) for g, e in zip(got, exp)),
              f"round {rounds}: K2 differs from the plain relabel")
        ru, _, wp = got
        alive = torch.isfinite(wp)
        dense = min_edges_dense(ru, wp, eid, alive, n)
        plain = min_edges_dense(ru, wp, eid, alive, n, use_kernel=False)
        check(all(torch.equal(g, e) for g, e in zip(dense, plain)),
              f"round {rounds}: min_edges_dense through K3 differs from "
              "the plain path")
        wl, el = min_edge_per_component(labels[ut], labels[vt], wt, n)
        el = torch.where(el == m, EID_SENTINEL, el)
        check(torch.equal(dense[0], wl) and torch.equal(dense[1], el),
              f"round {rounds}: the K2 -> K3 selection differs from "
              "min_edge_per_component")
        worst = max(worst, max_abs_diff(got, exp), max_abs_diff(dense, plain),
                    max_abs_diff(dense, (wl, el)))
        labels, mst, ch = boruvka_round(ut, vt, wt, labels, mst, n)
        changed = bool(ch)
    return dict(rounds=rounds, max_abs_err=worst, directed=(du, dv, dw, eid),
                labels=kept, n=n)


# ---------------------------------------------------------------------------
# phase 7: the single-device engines
# ---------------------------------------------------------------------------

def time_static_engine(dev, u, v, w, n, algorithm):
    """One warm-up, then the timed solve through the public entry point.
    Returns (mask, weight, seconds, peak GiB above what was allocated
    before the solve, that baseline in GiB)."""
    import torch
    from repro_torch.core.graph import from_numpy
    from repro_torch.core.mst import minimum_spanning_forest

    edges = from_numpy(u, v, w, n, device=dev)
    minimum_spanning_forest(edges, engine="static", algorithm=algorithm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mask, weight = minimum_spanning_forest(edges, engine="static",
                                           algorithm=algorithm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    return mask, weight, seconds, peak / 2 ** 30, before / 2 ** 30


# ---------------------------------------------------------------------------
# phase 8: K2 and K3 timing at phase 6's shape
# ---------------------------------------------------------------------------

def time_k2(directed, labels, reps=20):
    import torch
    from repro_torch.kernels.relabel.ref import relabel_ref
    from repro_torch.kernels.relabel.relabel import relabel

    du, dv, dw, _ = directed
    got = relabel(du, dv, dw, labels)
    exp = relabel_ref(du, dv, dw, labels)
    torch.cuda.synchronize()
    equal = all(torch.equal(g, e) for g, e in zip(got, exp))
    err = max_abs_diff(got, exp)
    del got, exp
    m, n = du.shape[0], labels.shape[0]
    # u, v, w read and ru, rv, w' written once (24 B), the table once
    bytes_moved = 24 * m + 4 * n
    return dict(equal=equal, max_abs_err=err, m=m, n=n, bytes=bytes_moved,
                ms=time_ms(lambda: relabel(du, dv, dw, labels), reps),
                plain_ms=time_ms(lambda: relabel_ref(du, dv, dw, labels), 3),
                bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3)


def time_k3(directed, labels, block=512, reps=20):
    import torch
    from repro_torch.kernels.relabel.ops import relabel_edges
    from repro_torch.kernels.segmin.ref import segmin_candidates_ref
    from repro_torch.kernels.segmin.segmin import segmin_candidates

    du, dv, dw, eid = directed
    seg, _, wp = relabel_edges(du, dv, dw, labels, use_kernel=False)
    alive = torch.isfinite(wp)
    args = (seg, wp, eid, alive)
    got = segmin_candidates(*args, block=block)
    exp = segmin_candidates_ref(*args, block)
    torch.cuda.synchronize()
    equal = all(torch.equal(g, e) for g, e in zip(got, exp))
    err = max_abs_diff(got, exp)
    del got, exp
    m = seg.shape[0]
    # library yardstick: one scatter_reduce_ amin of the packed (w, eid)
    # int64 key (w > 0 on this path) into a per-(block, run) table.  It
    # computes less: run minima into a table, not placed at run ends.
    # The run ids are built outside the timed window.
    head = torch.ones(m, dtype=torch.bool, device=seg.device)
    head[1:] = seg[1:] != seg[:-1]
    head[::block] = True
    rid = torch.cumsum(head, 0) - 1
    top = torch.iinfo(torch.int64).max
    key = torch.where(alive, (wp.view(torch.int32).long() << 32)
                      | eid.long(), top)
    table = torch.empty(int(rid[-1]) + 1, dtype=torch.int64,
                        device=seg.device)
    library_ms = time_ms(lambda: table.fill_(top).scatter_reduce_(
        0, rid, key, "amin"), reps)
    del head, rid, key, table
    # seg, w, eid (12 B) and alive (1 B) read, cand_w, cand_eid written
    bytes_moved = 21 * m
    return dict(equal=equal, max_abs_err=err, m=m, bytes=bytes_moved,
                alive=int(alive.sum()),
                ms=time_ms(lambda: segmin_candidates(*args, block=block),
                           reps),
                plain_ms=time_ms(lambda: segmin_candidates_ref(*args, block),
                                 3),
                library_ms=library_ms,
                bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3)



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
    from repro_torch.core import oracle
    from repro_torch.kernels import _build
    from repro_torch.kernels.relabel.relabel import relabel
    from repro_torch.kernels.segmin.segmin import (owner_scatter_min,
                                                   segmin_candidates)

    counted = (owner_scatter_min, relabel, segmin_candidates)

    start = time.perf_counter()
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
    # phase 2b: K2 and K3 walls
    k2_err = k2_parity_wall(dev)
    k3_err = k3_parity_wall(dev)

    # phases 3 and 3b: the cached path (the main path), then the lever
    # and OFF paths
    t0 = time.perf_counter()
    u, v, w, n = generators.gnm(GNM_N, GNM_M, seed=SEED)
    log(f"gnm: n={n} m={len(u)} generated in "
        f"{time.perf_counter() - t0:.1f} s")
    ref_weight, ref_count = scipy_msf(u, v, w, n)
    captured = {}
    launches = {}
    cached = {}
    driven = {}  # the cached path's engine solves, for phase 3d
    layout = None  # its prebuilt layout, which phase 3d replays on
    for path, levers in PATHS.items():
        for algorithm in ("boruvka", "filter_boruvka"):
            torch.cuda.reset_peak_memory_stats()
            mask, weight, secs, sites, trace, host = run_main_path(
                dev, u, v, w, n, algorithm, levers, warm=path == "cached")
            k1 = owner_scatter_min.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check_solve(f"{path} {algorithm}", mask, weight, secs, sites,
                        trace, host, k1, peak, ref_weight, ref_count,
                        combine=levers is not OFF)
            launches[(path, algorithm)] = dict(
                total=k1, combine=sites.combine, owner=sites.owner)
            capture = None
            if algorithm == "boruvka" and path != "levers":
                capture = "combine" if levers is CACHED else "owner"
            (g, res, engine_s, layout_s, esites, etrace,
             ehost) = compare_engine_paths(dev, u, v, w, n, algorithm,
                                           levers, capture)
            if capture:
                captured[capture] = esites.captured
            sel = np.unique(g.eid.cpu().numpy()[res[0].cpu().numpy()])
            check(np.array_equal(sel, np.nonzero(mask.cpu().numpy())[0]),
                  f"{path} {algorithm}: public API and engine edge sets "
                  "differ")
            stats = {f: float(x) for f, x in zip(res[5]._fields, res[5])}
            log(f"{path} engine gnm {algorithm}: {engine_s:.3f} s on a "
                f"prebuilt layout ({ehost.seconds:.3f} s of it in the host "
                f"bounds, {ehost.ghost_seconds():.3f} s of those the "
                f"cache's; host layout build {layout_s:.3f} s), K1 and "
                f"plain paths equal (mask, labels, overflow 0, "
                f"round_trace, CommStats {json.dumps(stats)})")
            log(f"{path} engine gnm {algorithm} host bounds by function "
                f"(each its own total, nested ones inside their caller's): "
                f"{ehost.text()}")
            log_trace(f"{path} round_trace gnm {algorithm}", etrace)
            if levers is CACHED:
                check(all(row["ghost"] and not row["grid_push"]
                          for row in etrace),
                      f"{algorithm}: a round of the cached path did not "
                      "read the ghost tables through the flat push")
                cached[algorithm] = (mask.cpu().numpy(), stats)
                if layout is None:
                    layout = g
                check(all(torch.equal(a, b) for a, b in zip(g, layout)),
                      f"{algorithm}: the layout differs from the first "
                      "one built of the same graph")
                driven[algorithm] = dict(mask=res[0], engine_s=engine_s,
                                         host_s=ehost.seconds)
            elif levers is LEVERS:
                check_cache_gain(algorithm, mask, stats, *cached[algorithm])
            del g, res, mask
        if levers is CACHED:
            # phase 3d: plan the main path on phase 3's layout, replay it
            replays = {}
            for algorithm in ("boruvka", "filter_boruvka"):
                plan, replays[algorithm] = plan_and_replay(
                    dev, layout, n, algorithm, driven[algorithm],
                    ref_weight, ref_count)
                if algorithm == "boruvka":
                    b_plan = plan
                    fitted, second = replay_second_graph(
                        dev, u, v, w, n, layout, plan)
            # phase 3e: verify, checkpoints, recovery, batched replay,
            # faults, on phase 3d's layout and plan
            t0 = time.perf_counter()
            robust = robustness(dev, layout, n, b_plan,
                                driven["boruvka"]["mask"], second, fitted)
            log(f"phase 3e: {time.perf_counter() - t0:.1f} s wall")
            ru, rv, rw, rn = generators.rmat(RMAT_SCALE, (1 << RMAT_SCALE)
                                             * RMAT_DEGREE // 2, seed=SEED)
            never_silent(dev, ru, rv, rw, rn)
            del layout, driven, plan, b_plan, second

    # phase 3c: the grid rung of the ghost push
    torch.cuda.reset_peak_memory_stats()
    mask, weight, secs, sites, trace, host = run_main_path(
        dev, u, v, w, n, "boruvka", GRID, warm=False, num_shards=GRID_SHARDS)
    k1 = owner_scatter_min.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_solve("grid rung boruvka", mask, weight, secs, sites, trace, host,
                k1, peak, ref_weight, ref_count, combine=True)
    launches[("grid", "boruvka")] = dict(total=k1, combine=sites.combine,
                                         owner=sites.owner)
    check(all(row["ghost"] and row["grid_push"] and row["cap_push_col"] > 0
              for row in trace),
          "grid rung: a round did not read the ghost tables through the "
          "grid push")
    check(np.array_equal(mask.cpu().numpy(), cached["boruvka"][0]),
          "grid rung: the mask differs from the flat push's")
    log_trace("grid rung round_trace gnm boruvka", trace)
    log(f"grid rung (num_shards={GRID_SHARDS}, ghost_push='grid'): mask "
        "equals the flat push's, every round through the grid push")
    del mask

    # phase 4: RMAT through every path, and the static engine
    edges = from_numpy(ru, rv, rw, rn, device=dev)
    rmat_kmask, _ = oracle.kruskal(ru, rv, rw, rn)
    for path, levers in PATHS.items():
        mask, _ = minimum_spanning_forest(
            edges, engine="distributed_sharded", num_shards=NUM_SHARDS,
            algorithm="boruvka", pallas_minedges=True, **levers)
        kruskal_check(rmat_kmask, mask, f"rmat distributed_sharded {path}")
    mask, _ = minimum_spanning_forest(edges, engine="static")
    kruskal_check(rmat_kmask, mask, "rmat static")
    log(f"rmat scale {RMAT_SCALE} (n={rn}, m={len(ru)}): sharded (cached, "
        "lever and OFF paths) and static engines equal the Kruskal edge set")

    # phase 5: K1 at the engine's two shapes
    k1_sites = {}
    for site in ("owner", "combine"):
        args, size = captured[site]
        k1 = time_k1(args, size)
        k1_sites[site] = k1
        what = ("OFF path owner-side scatter-min" if site == "owner" else
                "cached path per-run combine, round 1")
        log(f"k1 {what}: rows={args[0].shape[0]} L={args[0].shape[1]} "
            f"size={size} pay1 is pay2: {args[3] is args[4]} ok lanes="
            f"{k1['ok_lanes']}{list_use_text(k1['list_use'])} winning "
            f"lanes={k1['win_lanes']} max|diff|="
            f"{k1['max_abs_err']} equal={k1['equal']}")
        check(k1["equal"], f"K1 differs from its plain version at the "
              f"{what} shape")
        log(f"k1 timing, {what}: {k1['ms']:.4f} ms/launch, plain "
            f"{k1['plain_ms']:.4f} ms, library scatter_reduce_ "
            f"{k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
            f"({k1['bytes']} B at 3.35 TB/s)")
        split = ", ".join(f"{k} {v:.4f} ms" for k, v in k1["split"].items())
        log(f"k1 split per launch, {what} (torch.profiler device time): "
            f"{split or 'not measured (no device time in the trace)'}")
        del args
    log("k1 launches per solve: " + json.dumps(
        {f"{p} {a}": c for (p, a), c in launches.items()}))

    # phase 6: the single-device selection through K2 and K3
    del edges, mask, captured  # K1's owner-site inputs alone hold 5.3 GiB
    selections = {}
    for gn in (GNM_N, SMALL_N):
        t0 = time.perf_counter()
        gu, gv, gw, _ = (u, v, w, n) if gn == GNM_N else generators.gnm(
            gn, GNM_M, seed=SEED)
        gen_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        sel = selection_rounds(dev, gu, gv, gw, gn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in counted}
        log(f"selection gnm n={gn} m={len(gu)} ({2 * len(gu)} directed, "
            f"generated in {gen_s:.1f} s): {sel['rounds']} rounds in "
            f"{secs:.3f} s wall (with the plain comparisons); K2 and K3 "
            f"equal their plain paths and min_edge_per_component in every "
            f"round, max|diff|={sel['max_abs_err']}; launches "
            f"{json.dumps(counts)}")
        for fn in (relabel, segmin_candidates):
            check(fn.launches == sel["rounds"],
                  f"n={gn}: {fn.__name__} launched {fn.launches} times in "
                  f"{sel['rounds']} rounds, not once per round")
        check(counts["owner_scatter_min"] == 0,
              "the single-device selection launched K1")
        sel["launches"] = counts
        selections[gn] = sel
    del gu, gv, gw

    # phase 7: the single-device engines
    engine_s = {}
    for algorithm in ("boruvka", "filter_boruvka"):
        mask, weight, secs, peak, held = time_static_engine(dev, u, v, w, n,
                                                            algorithm)
        count = int(mask.sum())
        rel = abs(float(weight) - ref_weight) / ref_weight
        log(f"static engine gnm {algorithm}: solve {secs:.3f} s wall "
            f"(public API) after one warm-up; edges {count} (scipy "
            f"{ref_count}); weight {float(weight):.1f} (scipy "
            f"{ref_weight:.1f}, rel {rel:.2e}); peak device memory "
            f"{peak:.3f} GiB above the {held:.3f} GiB held before the "
            "solve (the edges and phase 6's directed lists)")
        check(count == ref_count, f"static {algorithm}: {count} MSF edges, "
              f"scipy {ref_count}")
        check(rel < 1e-3, f"static {algorithm}: weight off by {rel:.2e} "
              "relative")
        engine_s[algorithm] = secs
        del mask
    edges = from_numpy(ru, rv, rw, rn, device=dev)
    for engine, algorithm in (("static", "filter_boruvka"),
                              ("dynamic", "boruvka"),
                              ("dynamic", "filter_boruvka")):
        t0 = time.perf_counter()
        mask, _ = minimum_spanning_forest(edges, engine=engine,
                                          algorithm=algorithm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        kruskal_check(rmat_kmask, mask, f"rmat {engine} {algorithm}")
        log(f"rmat {engine} {algorithm}: {secs:.3f} s wall (first call), "
            "equals the Kruskal edge set")
    del edges, mask

    # phase 8: K2 and K3 per launch at phase 6's shape
    big = selections[GNM_N]
    k2 = {(gn, r): time_k2(selections[gn]["directed"], lab)
          for gn in (GNM_N, SMALL_N)
          for r, lab in sorted(selections[gn]["labels"].items())}
    k3 = {(GNM_N, r): time_k3(big["directed"], lab)
          for r, lab in sorted(big["labels"].items())}
    for name, res in list(k2.items()) + list(k3.items()):
        check(res["equal"], f"n={name[0]} round {name[1]}: kernel differs "
              "from its plain version at phase 6's shape")
    for (gn, r), res in k2.items():
        log(f"k2 timing gnm n={gn} round {r}: m={res['m']} n'={res['n']} "
            f"{res['ms']:.4f} ms/launch, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bytes']} B at "
            f"3.35 TB/s), launches per selection path "
            f"{selections[gn]['launches']['relabel']}, "
            f"max|diff|={res['max_abs_err']}")
    for (gn, r), res in k3.items():
        log(f"k3 timing gnm n={gn} round {r}: m={res['m']} alive="
            f"{res['alive']} block=512 {res['ms']:.4f} ms/launch, plain "
            f"{res['plain_ms']:.4f} ms, library scatter_reduce_ "
            f"{res['library_ms']:.4f} ms (computes less: run minima into "
            f"a table, not placed at run ends), bound "
            f"{res['bound_ms']:.4f} ms "
            f"({res['bytes']} B at 3.35 TB/s), launches per selection "
            f"path {selections[gn]['launches']['segmin_candidates']}, "
            f"max|diff|={res['max_abs_err']}")
    log(f"library: null for K2: {NO_LIBRARY}")
    k2_main = k2[(GNM_N, 1)]
    k3_main = k3[(GNM_N, 1)]

    k1 = k1_sites["combine"]
    kernels = [dict(name="owner_scatter_min", route="cuda",
                    source=K1_SOURCE, replaces=K1_REPLACES,
                    launches=launches[("cached", "boruvka")]["total"],
                    max_abs_err=max(k1["max_abs_err"],
                                    k1_sites["owner"]["max_abs_err"]),
                    ms=k1["ms"], plain_ms=k1["plain_ms"],
                    bound_ms=k1["bound_ms"], bound_by="bytes",
                    library_ms=k1["library_ms"],
                    shape="per-run combine, round 1 of the cached path",
                    owner_site=dict(
                        launches=launches[("cached", "boruvka")]["owner"],
                        shape="owner-side scatter-min of the OFF path",
                        ms=k1_sites["owner"]["ms"],
                        plain_ms=k1_sites["owner"]["plain_ms"],
                        bound_ms=k1_sites["owner"]["bound_ms"],
                        library_ms=k1_sites["owner"]["library_ms"]),
                    planned_replay={a: dict(combine=r["combine"],
                                            owner=r["owner"],
                                            rounds=r["rounds"],
                                            sentinels=r["sentinels"])
                                    for a, r in replays.items()},
                    robustness_paths=robust["k1"]),
               dict(name="relabel", route="cuda", source=K2_SOURCE,
                    replaces=K2_REPLACES,
                    launches=big["launches"]["relabel"],
                    max_abs_err=max([k2_err, big["max_abs_err"]]
                                    + [r["max_abs_err"] for r in k2.values()]),
                    ms=k2_main["ms"], plain_ms=k2_main["plain_ms"],
                    bound_ms=k2_main["bound_ms"], bound_by="bytes",
                    library_ms=None),
               dict(name="segmin_candidates", route="cuda", source=K3_SOURCE,
                    replaces=K3_REPLACES,
                    launches=big["launches"]["segmin_candidates"],
                    max_abs_err=max([k3_err, big["max_abs_err"]]
                                    + [r["max_abs_err"] for r in k3.values()]),
                    ms=k3_main["ms"], plain_ms=k3_main["plain_ms"],
                    bound_ms=k3_main["bound_ms"], bound_by="bytes",
                    library_ms=k3_main["library_ms"])]
    log(f"total: {time.perf_counter() - start:.1f} s wall")
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
