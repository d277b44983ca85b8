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
  3f. (run right after phase 3e) serving at full width: ``MSFGateway(8,
     batch_slots=2, verify=True, pallas_minedges=True)`` serves four gnm
     requests on phase 3's u, v (phase 3's weights, then shuffled by
     ``default_rng(1)``, ``(2)``, ``(3)``): request 0 must be phase 3's
     cached-path forest, every forest scipy's weight with
     n - #components edges, none rejected, the stats one miss, two
     batches and a hit, and K1 must launch at both sites in the
     measurement pass and the batched replays (counted apart from any
     retry rung); each request's latency and layout build, each step's
     time, requests/s and the peak are printed.  Then the launcher on
     the card (``repro_torch.launch.serve_msf``): its smoke, and a gnm +
     rgg2d mix at n = 2^16 (16 requests, 4 slots, oracle check);
  3g. the replicated engine (``distributed_msf``) on phase 3's layout
     for boruvka, filter_boruvka and boruvka_shrink, each after one
     warm-up: edge set equal to phase 3's cached path, weight and count
     scipy's, rounds and every CommStats field printed; then one
     public-API solve with ``engine="distributed"``;
  3b. the earlier paths, each checked the same way: the lever path
     (``ghost_cache=False``, every other lever on), whose edge set the
     cached path must equal while serving hits, pushing, and shipping
     fewer lookup and push items (misses + pushed) than its misses; and
     every lever off (``OFF``).  Only the main path gets a warm-up;
  3c. the grid rung: ``num_shards=(4, 2), ghost_push="grid"`` (boruvka,
     same graph), whose mask must equal the flat push's, with every
     round a ghost round through the grid push and K1 at both sites;
  3s. (after phase 3c) ``sample_sort`` of 8 shards x 2^21 float32 keys
     with an int32 payload (85% valid, ``capacity_factor=2.0``): overflow
     0, sorted across shard boundaries, the (key, payload) multiset kept,
     timed;
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
     ``scatter_reduce_`` of a packed key into a per-run table;
  9. the LM serving path (plain PyTorch: no kernel of its own, so every
     kernel's count over it is 0, reported as ``lm_path``):
     9a. llama3.2-3b at full width and depth (28 layers, d 3072, GQA
         24/8, vocab 128,256, bf16) drawn from the seed on the card;
         ``ServeEngine(batch_slots=4, max_len=512)`` serves 8 requests
         (4-token prompts, ``max_new=32``) to completion: tokens/s, ms a
         step, peak memory, the step's roofline bound
         (``launch/roofline.py: RooflineTerms``), the device busy share
         and kernel launches of one step (``torch.profiler``); the
         teacher-forced decode of request 0's tokens against
         ``forward_prefill`` of them (within 5% of the largest logit,
         its argmax among the prefill's top 5); one prefill of B = 1,
         S = 2048 beside its bound;
     9b. every arch's smoke config in float32, plus the int8 KV cache
         and blockwise attention on llama3.2 and absorbed MLA on
         deepseek-v2: prefill and 4 decode steps on the card against the
         port's own CPU run on the same parameters (1e-4 relative);
     9c. deepseek-v2-236b at full width, depth cut from 60 to 2 layers
         (1 dense, 1 MoE with MLA): one prefill (B = 2, S = 64) and 4
         decode steps, finite logits;
  10. LM training (plain PyTorch and autograd: no kernel of its own, so
      every kernel's count over it is 0, reported as ``lm_train_path``):
     10a. llama3.2-3b at full width and depth (bf16) trained by
          ``make_train_step`` with ``TrainConfig()``'s AdamW and per-layer
          remat ``"none"`` on the launcher's synthetic stream, one
          sequence of the reference's train_4k shape (B = 1, S = 4096): 2
          warm-up steps, 10 timed (ms a step, tokens/s, the share of the
          989 TFLOP/s bf16 peak from ``launch/roofline.py: model_flops``,
          peak memory, the losses, all finite, and a parameter changed);
          then one step under remat ``"dots"`` and one with 2
          microbatches at B = 2;
     10b. every arch's smoke config in float32 on the card against the
          CPU on the same parameters and batch: ``forward_train``'s loss
          and every gradient, then the parameters, ``mu`` and ``nu`` after
          one train step (1e-4 of each leaf's largest CPU value); every
          router gradient looked at apart: a top-1 router's (llama4's,
          zero by construction) must be noise below the 1e-6 floor on
          both devices, any other within 1e-4 of its own largest;
     10c. deepseek-v2-236b cut to 2 layers as in 9c (bf16):
          ``forward_train`` and its backward pass with
          ``moe_impl="dispatch"`` under a (2, 4) data x model and a
          (2, 2, 2) data x em x en (grid) ``MeshContext`` against
          ``moe_local``, capacity factor 32 (no copy dropped), loss and
          every gradient within 2e-2 of its leaf's largest (about three
          bf16 ulps); one layer's ``moe_apply`` timed both ways; then the
          same in float32 within 1e-3 (rounding, not a misrouted copy);
     10d. llama3.2's smoke config (bf16): 5 steps with checkpoints, the
          checkpoint restored bit for bit (every sha1 checked), resumed
          to step 10; then ``python -m repro_torch.launch.train --arch
          llama3.2-3b --smoke --steps 8`` on the card, whose last line
          must parse;
  11. the dry-run (meta tensors and counters: no kernel of its own, so
      every kernel's count over it is 0, reported as ``dryrun_path``):
     11a. ``python -m repro_torch.launch.dryrun`` for llama3.2-3b x 4
          shapes x both production meshes and for the MST cell of both
          engines (three processes at once): 0 failed, the skipped cells
          those ``cell_supported`` refuses; each cell's dominant term,
          compute_s, memory_s, collective_s and useful_ratio printed;
     11b. the cells phases 9a and 10a ran (decode at 4 slots of 512, the
          2048-token prefill, the train step at B = 1, S = 4096) costed
          on the meta device: the flops equal ``FlopCounterMode``'s count
          of the real step on the card (taken on phase 10a's parameters
          and moments right after 10a), the argument bytes within 2% of
          what the card allocated for the step, and 9a's and 10a's
          measured times at or above the roofline step time;
     11c. ``synthetic_plan`` replayed on phase 3's layout through
          ``make_sharded_mst_step(plan=...)``: ``plan_exchange_bytes``
          equals ``ExchangeStats.bytes`` with ``adaptive_doubling`` off,
          and bounds it with it on.

The line before the last is the card's name and power limit as
``nvidia-smi`` reports them, the one before that a JSON object with one
entry per kernel, and the last ``{"ok": true, "device": {...}}``.
Needs one CUDA card; with none it exits 1 and prints no result.
"""
from __future__ import annotations

import gc
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


def kernel_wrappers():
    """The wrappers of K1, K2 and K3, each with its launch count."""
    from repro_torch.kernels.relabel.relabel import relabel
    from repro_torch.kernels.segmin.segmin import (owner_scatter_min,
                                                   segmin_candidates)
    return owner_scatter_min, relabel, segmin_candidates


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for fn in kernel_wrappers():
        fn.launches = 0


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count by name."""
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


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
# phase 3f: serving at full width through the gateway and its launcher
# ---------------------------------------------------------------------------

class ServeSplit:
    """While active (inside ``K1Sites``), the host clock and K1's
    launches at each MINEDGES site of every gateway step: each request's
    layout build (by rid), the measurement pass, each batched replay and
    each retry rung, and the verifier inside them (summed apart)."""

    STEPS = ("plan_sharded_msf", "execute_plan_batched", "_replan_with_plan")

    def __init__(self, sites, rid_of):
        self.sites = sites
        self.rid_of = rid_of  # id(request.w) -> rid
        self.layout_s = {}
        self.events = []  # (step, seconds, combine, owner)
        self.verify_s = 0.0

    def __enter__(self):
        from repro_torch.core import verify
        from repro_torch.serve import msf_gateway as gw
        self._gw, self._verify = gw, verify
        self._saved = {k: getattr(gw, k) for k in self.STEPS
                       + ("build_dist_graph", "verify_forest")}
        self._verify_fn = verify.verify_forest

        def step(name, fn):
            def run(*args, **kw):
                c0, o0 = self.sites.combine, self.sites.owner
                out, secs = wall(lambda: fn(*args, **kw))
                self.events.append((name, secs, self.sites.combine - c0,
                                    self.sites.owner - o0))
                return out
            return run

        def layout(u, v, w, *args, **kw):
            out, secs = wall(lambda: self._saved["build_dist_graph"](
                u, v, w, *args, **kw))
            self.layout_s[self.rid_of[id(w)]] = secs
            return out

        def timed_verify(fn):
            def run(*args, **kw):
                out, secs = wall(lambda: fn(*args, **kw))
                self.verify_s += secs
                return out
            return run

        for name in self.STEPS:
            setattr(gw, name, step(name, self._saved[name]))
        gw.build_dist_graph = layout
        gw.verify_forest = timed_verify(self._saved["verify_forest"])
        verify.verify_forest = timed_verify(self._verify_fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._gw, name, fn)
        self._verify.verify_forest = self._verify_fn
        return False

    def k1(self, name):
        """K1 launches (per-run combine, owner-side) over the steps
        named ``name``."""
        return [sum(e[2] for e in self.events if e[0] == name),
                sum(e[3] for e in self.events if e[0] == name)]


def serve_full_width(dev, u, v, w, n, cached_mask):
    """Phase 3f: ``MSFGateway(8, batch_slots=2, verify=True,
    pallas_minedges=True)`` serves four gnm requests on phase 3's u, v:
    request 0 with phase 3's weights, requests 1-3 with them shuffled by
    ``default_rng(1)``, ``(2)`` and ``(3)``.  Request 0 must be phase
    3's cached-path forest, every forest scipy's weight with
    n - #components edges, none rejected; one miss, two batches, a hit;
    K1 at both sites in the measurement pass and the batched replays,
    counted apart from any retry rung.  Returns a dict of figures."""
    import numpy as np
    import torch
    from repro_torch.serve.msf_gateway import MSFGateway, MSFRequest

    reqs = []
    for rid in range(4):
        wr = np.asarray(w).copy()
        if rid:
            np.random.default_rng(rid).shuffle(wr)
        reqs.append(MSFRequest(rid=rid, family="gnm", u=u, v=v, w=wr, n=n))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gw = MSFGateway(NUM_SHARDS, batch_slots=2, verify=True,
                    pallas_minedges=True, device=dev)
    reset_counts()
    with K1Sites() as sites, ServeSplit(
            sites, {id(r.w): r.rid for r in reqs}) as split:
        t0 = time.perf_counter()
        for r in reqs:
            gw.submit(r)
        gw.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    from repro_torch.kernels.segmin.segmin import owner_scatter_min
    launched = owner_scatter_min.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s = gw.stats
    check(all(r.served_via in ("batched", "replanned") for r in reqs),
          "serving: " + "; ".join(f"request {r.rid} {r.served_via} "
                                  f"{r.error}" for r in reqs))
    check((s.misses, s.batches) == (1, 2) and s.hits >= 1,
          f"serving: stats {vars(s)}")
    check(np.array_equal(reqs[0].edges, np.nonzero(cached_mask)[0]),
          "serving: request 0's forest differs from phase 3's cached path")
    for r in reqs:
        exp, exp_edges = scipy_msf(u, v, r.w, n)
        got = float(np.sum(r.w[r.edges].astype(np.float64)))
        rel = abs(r.weight - exp) / exp
        check(len(r.edges) == r.count == exp_edges,
              f"serving request {r.rid}: {r.count} edges, scipy "
              f"{exp_edges}")
        check(rel < 1e-3 and abs(got - exp) <= 1e-9 * exp,
              f"serving request {r.rid}: weight {r.weight!r} (float64 "
              f"{got!r}) against scipy's {exp!r}")
        log(f"3f request {r.rid}: {r.served_via}, latency {r.latency:.3f} s "
            f"from submit (layout build {split.layout_s[r.rid]:.3f} s); "
            f"{r.count} edges, weight {r.weight:.1f} (scipy {exp:.1f}, "
            f"rel {rel:.2e})")
    k1 = dict(measurement=split.k1("plan_sharded_msf"),
              batched=split.k1("execute_plan_batched"),
              rungs=split.k1("_replan_with_plan"))
    check(k1["measurement"][0] > 0 and k1["measurement"][1] > 0
          and k1["batched"][0] > 0 and k1["batched"][1] > 0,
          f"serving: K1 did not launch at both sites {k1}")
    check(launched == sum(sum(x) for x in k1.values()),
          f"serving: K1 launched {launched} times, {k1} in the steps")
    steps = "; ".join(f"{name} {secs:.3f} s (K1 {c} + {o})"
                      for name, secs, c, o in split.events)
    layout_s = sum(split.layout_s.values())
    log(f"3f serving gnm n={n} m={len(u)}, 4 requests, batch_slots=2, "
        f"verify=True: {secs:.3f} s wall, {4 / secs:.4f} requests/s; "
        f"layout builds {layout_s:.3f} s ({100 * layout_s / secs:.1f}%); "
        f"steps: {steps}; verify {split.verify_s:.3f} s in all; stats "
        f"{json.dumps(vars(s))}; peak device memory {peak:.2f} GiB")
    log(f"3f K1 launches (per-run combine, owner-side): {json.dumps(k1)}")
    return dict(k1=k1, seconds=secs, layout_s=layout_s)


def launcher_on_card():
    """The serving launcher on the card, in process: its smoke (n = 256,
    24 requests, oracle identity, hit rate > 0.5) and a gnm + rgg2d mix
    at n = 2^16 with the oracle check, both through K1.  Returns K1's
    launches in each."""
    import contextlib
    import io
    from repro_torch.kernels.segmin.segmin import owner_scatter_min
    from repro_torch.launch import serve_msf

    runs = {"smoke": ["--smoke", "--pallas-minedges"],
            "mix_n65536": ["--families", "gnm,rgg2d", "--sizes", "65536",
                           "--requests", "16", "--slots", "4", "--check",
                           "--pallas-minedges"]}
    k1 = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve_msf.main(argv)
        secs = time.perf_counter() - t0
        k1[name] = owner_scatter_min.launches
        out = buf.getvalue()
        check("forests bit-identical" in out, f"launcher {name}: {out}")
        check(k1[name] > 0, f"launcher {name}: K1 launched no time")
        log(f"3f launcher {' '.join(argv)} ({secs:.1f} s, K1 launches "
            f"{k1[name]}): " + " | ".join(out.strip().splitlines()))
    return k1


# ---------------------------------------------------------------------------
# phase 3g: the replicated mesh engine at full width
# ---------------------------------------------------------------------------

def replicated_engine(dev, g, n, u, v, w, cached_mask, ref_weight,
                      ref_count):
    """Phase 3g: ``distributed_msf`` on phase 3's layout for boruvka,
    filter_boruvka and boruvka_shrink, each timed after one warm-up: the
    edge set must equal phase 3's cached path, the weight and edge count
    scipy's.  Then one public-API solve (``engine="distributed"``)."""
    import numpy as np
    import torch
    from repro_torch.core.distributed import distributed_msf
    from repro_torch.core.graph import from_numpy
    from repro_torch.core.mst import minimum_spanning_forest

    eid = g.eid.cpu().numpy()
    want = np.nonzero(cached_mask)[0]
    out = {}
    for algo in ("boruvka", "filter_boruvka", "boruvka_shrink"):
        distributed_msf(g, n, NUM_SHARDS, algorithm=algo)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        res, secs = wall(lambda: distributed_msf(g, n, NUM_SHARDS,
                                                 algorithm=algo))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mask, weight, count, _, comm = res
        sel = np.unique(eid[mask.cpu().numpy()])
        rel = abs(float(weight) - ref_weight) / ref_weight
        check(np.array_equal(sel, want), f"replicated {algo}: the edge set "
              "differs from phase 3's cached path")
        check(int(count) == ref_count and rel < 1e-3,
              f"replicated {algo}: {int(count)} edges (scipy {ref_count}), "
              f"weight rel {rel:.2e}")
        stats = {f: float(x) for f, x in zip(comm._fields, comm)}
        log(f"3g replicated engine gnm {algo}: {secs:.3f} s on phase 3's "
            f"layout after one warm-up; rounds {int(comm.rounds)}; "
            f"CommStats {json.dumps(stats)}; edge set equals the cached "
            f"path's, weight rel {rel:.2e}; peak device memory "
            f"{peak:.2f} GiB ({held:.2f} GiB held before)")
        out[algo] = secs
    edges = from_numpy(u, v, w, n, device=dev)
    (mask, weight), secs = wall(lambda: minimum_spanning_forest(
        edges, engine="distributed", num_shards=NUM_SHARDS))
    check(np.array_equal(np.nonzero(mask.cpu().numpy())[0], want),
          "replicated public API: the edge set differs")
    log(f"3g public API engine='distributed' (boruvka): {secs:.3f} s wall "
        "(incl. host layout build), edge set equals the cached path's")
    out["api"] = secs
    return out


def sample_sort_phase(dev):
    """``sample_sort`` of 8 shards x 2^21 float32 keys with an int32
    payload (``default_rng(0)``, 85% valid, ``capacity_factor=2.0``):
    overflow 0, keys sorted across shard boundaries, the (key, payload)
    multiset kept.  Timed after one warm-up."""
    import numpy as np
    import torch
    from repro_torch.comm.sorting import sample_sort

    p, L = NUM_SHARDS, 1 << 21
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.random((p, L), np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((p, L)) < 0.85).to(dev)
    vals = torch.arange(p * L, dtype=torch.int32, device=dev).view(p, L)

    def run():
        return sample_sort(keys, vals, valid, (p,), capacity_factor=2.0)

    run()
    res, secs = wall(run)
    check(int(res.overflow) == 0, f"sample sort: overflow "
          f"{int(res.overflow)}")
    got_vals = res.payload[res.ok]
    check(torch.equal(torch.sort(got_vals).values,
                      vals[valid].sort().values),
          "sample sort: the payload multiset changed")
    check(torch.equal(res.key[res.ok], keys.view(-1)[got_vals.long()]),
          "sample sort: a key lost its payload")
    fin = torch.where(res.ok, res.key, float("nan"))
    lo = torch.where(res.ok, res.key, float("inf")).min(1).values
    hi = torch.where(res.ok, res.key, -float("inf")).max(1).values
    rows_sorted = bool(((fin[:, 1:] >= fin[:, :-1]) | ~res.ok[:, 1:])
                       .all())
    check(rows_sorted and bool((hi[:-1] <= lo[1:]).all()),
          "sample sort: keys not sorted across shard boundaries")
    log(f"sample sort {p} x {L} float32 keys + int32 payload (85% valid, "
        f"capacity_factor 2.0): {secs * 1e3:.3f} ms after one warm-up; "
        f"overflow 0, sorted across shard boundaries, (key, payload) "
        f"multiset kept; received per shard {res.ok.sum(1).tolist()}")
    return secs


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



# ---------------------------------------------------------------------------
# phase 9: the LM serving path (no kernel of its own: plain PyTorch)
# ---------------------------------------------------------------------------

LM_ARCH = "llama3.2-3b"
LM_SLOTS, LM_MAX_LEN = 4, 512
LM_REQUESTS, LM_PROMPT, LM_MAX_NEW = 8, 4, 32
LM_PREFILL_LEN = 2048
# teacher-forced decode against the parallel prefill, bf16 at full width:
# 8 significant bits, and the two paths round their products at other
# shapes (GEMV against GEMM, a 64-slot masked buffer against a causal
# 36 x 36 score matrix) through 28 layers
LM_DECODE_REL = 5e-2
LM_CARD_REL = 1e-4  # float32 smoke configs, the card against the CPU
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_T, LM_SMOKE_STEPS = 2, 8, 16, 4
CUT_ARCH, CUT_LAYERS = "deepseek-v2-236b", 2  # 1 dense + 1 MoE layer


def lm_step_terms(cfg, params, B, T):
    """The roofline of one decode step of ``B`` slots over length-``T``
    caches (``launch/roofline.py: RooflineTerms``): every weight read
    once (of the embedding table only the ``B`` gathered rows), the whole
    KV buffer read (the static-shape step attends over all ``T`` rows
    under its mask); flops of the weight products and of the scores and
    values over ``T``."""
    from repro_torch.launch.roofline import RooflineTerms
    size = lambda t: t.numel() * t.element_size()
    embed = params["embed"]
    weights = (sum(size(p) for p in params.parameters()) - size(embed)
               + B * embed.shape[1] * embed.element_size())
    kv = (2 * cfg.num_layers * B * T * cfg.num_kv_heads * cfg.hd
          * embed.element_size())
    n_mm = sum(p.numel() for p in params.parameters()) - embed.numel()
    flops = (2 * B * n_mm
             + 4 * B * T * cfg.num_heads * cfg.hd * cfg.num_layers)
    return RooflineTerms(flops, weights + kv, 0, 1), weights, kv


def lm_prefill_terms(cfg, params, S):
    """The roofline of one causal prefill of ``S`` tokens that keeps the
    last position's logits: the layer weights at every position, the
    unembedding once, the causal half of the scores and values."""
    from repro_torch.launch.roofline import RooflineTerms
    size = lambda t: t.numel() * t.element_size()
    embed, unembed = params["embed"], params["unembed"]
    n_layers = (sum(p.numel() for p in params.parameters())
                - embed.numel() - unembed.numel())
    flops = (2 * S * n_layers + 2 * unembed.numel()
             + 2 * S * S * cfg.num_heads * cfg.hd * cfg.num_layers)
    nbytes = (sum(size(p) for p in params.parameters()) - size(embed)
              + S * embed.shape[1] * embed.element_size())
    return RooflineTerms(flops, nbytes, 0, 1)


def device_busy(fn):
    """(device busy ms, kernel launches, copies and sets) over one call of
    ``fn``, from ``torch.profiler`` (its second trace: the first pays the
    profiler's start-up); (None, None, None) where it saw no device time.
    The busy time holds every device event; the launches count the
    kernels alone, apart from the memcpy and memset events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None, None
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in events)
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3,
            len(events) - copies, copies)


def lm_requests(cfg, count, seed):
    from repro_torch.serve.engine import Request
    import numpy as np
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, LM_PROMPT)], max_new=LM_MAX_NEW)
        for i in range(count)]


def lm_serve(dev, cfg, max_len=LM_MAX_LEN, prefill_len=LM_PREFILL_LEN):
    """Phase 9a: ``cfg`` (llama3.2-3b at full width and depth on the card)
    drawn from the seed on ``dev``, 8 requests served to completion by
    ``ServeEngine(batch_slots=4)``, the teacher-forced decode held to the
    prefill of the same tokens, and one prefill of ``prefill_len``."""
    import numpy as np
    import torch
    from repro_torch.models.model import (forward_decode, forward_prefill,
                                          init_caches, init_params)
    from repro_torch.serve.engine import ServeEngine

    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    log(f"9a {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, GQA "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}: {n_params} parameters ({n_params * 2 / 1e9:.3f} GB; "
        f"param_count() {cfg.param_count()}, which leaves out the norms) "
        f"drawn on the card in {init_s:.2f} s")

    warm = ServeEngine(cfg, params, batch_slots=LM_SLOTS, max_len=max_len,
                       device=dev)
    for r in lm_requests(cfg, LM_SLOTS, SEED + 1):
        r.max_new = 2
        warm.submit(r)
    warm.run()
    del warm
    torch.cuda.synchronize()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, batch_slots=LM_SLOTS, max_len=max_len,
                      device=dev)
    reqs = lm_requests(cfg, LM_REQUESTS, SEED)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = sum(len(r.out) for r in reqs)
    check(all(r.done and len(r.out) == LM_MAX_NEW for r in reqs),
          "9a: a request did not finish with max_new tokens")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          "9a: a token outside the vocabulary")
    terms, w_bytes, kv_bytes = lm_step_terms(cfg, params, LM_SLOTS, max_len)
    step_ms = serve_s / steps * 1e3
    res = dict(arch=cfg.name, requests=len(reqs), tokens=tokens,
               steps=steps, serve_s=serve_s, step_ms=step_ms,
               tokens_per_s=tokens / serve_s, peak_gib=peak,
               held_gib=held, init_s=init_s,
               bound_ms=terms.step_time_s * 1e3, bound_by=terms.dominant,
               weight_bytes=w_bytes, kv_bytes=kv_bytes, launches=launches)
    log(f"9a served {len(reqs)} requests ({LM_PROMPT}-token prompts, "
        f"max_new {LM_MAX_NEW}) on {LM_SLOTS} slots, max_len {max_len}: "
        f"{tokens} tokens in {steps} steps, {serve_s:.3f} s wall, "
        f"{step_ms:.3f} ms a step, {tokens / serve_s:.1f} tokens/s; peak "
        f"{peak:.3f} GiB ({held:.3f} GiB held before the parameters were "
        f"drawn); "
        f"kernel launches {json.dumps(launches)}")
    log(f"9a step roofline (RooflineTerms, H100 data sheet): "
        f"{terms.bytes_accessed} B ({w_bytes} B weights + {kv_bytes} B KV "
        f"buffer) -> memory {terms.memory_s * 1e3:.4f} ms, {terms.flops:.4e} "
        f"flops -> compute {terms.compute_s * 1e3:.4f} ms; bound "
        f"{res['bound_ms']:.4f} ms ({terms.dominant}), measured step "
        f"{step_ms:.3f} ms = {res['bound_ms'] / step_ms:.1%} of it")

    # one steady step under the profiler: device busy share, launches
    eng2 = ServeEngine(cfg, params, batch_slots=LM_SLOTS, max_len=max_len,
                       device=dev)
    for r in lm_requests(cfg, LM_SLOTS, SEED + 2):
        eng2.submit(r)
    for _ in range(LM_PROMPT + 2):
        eng2.step()
    busy = kernels = copies = None
    if dev.type == "cuda":  # a CPU rehearsal has no device to trace
        busy, kernels, copies = device_busy(eng2.step)
    res.update(busy_ms=busy, kernels_per_step=kernels,
               copies_per_step=copies,
               busy_share=None if busy is None else busy / step_ms)
    log("9a one decode step under torch.profiler: device busy "
        + (f"{busy:.3f} ms, {busy / step_ms:.1%} of the served run's "
           f"{step_ms:.3f} ms a step; {kernels} kernel launches and "
           f"{copies} memcpy/memset events"
           if busy is not None else "not measured (no device time in the "
           "trace)"))
    del eng2

    # teacher-forced decode of request 0's tokens against their prefill
    seq = reqs[0].prompt + reqs[0].out
    toks = torch.tensor([seq], device=dev)
    caches = init_caches(cfg, 1, 64, dev)
    for t in range(len(seq)):
        logits, caches = forward_decode(cfg, params, caches, toks[:, t],
                                        torch.tensor([t], device=dev))
    want = forward_prefill(cfg, params, {"tokens": toks})
    got, want = logits.float().cpu().numpy(), want.float().cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    top5 = np.argsort(-want[0])[:5]
    log(f"9a teacher-forced decode of {len(seq)} tokens against "
        f"forward_prefill: max|diff| {np.abs(got - want).max():.4f} = "
        f"{rel:.3e} of max|logit| {np.abs(want).max():.3f} (bound "
        f"{LM_DECODE_REL}); argmax {int(got[0].argmax())} / "
        f"{int(want[0].argmax())}")
    check(rel <= LM_DECODE_REL, f"9a: decode and prefill logits differ by "
          f"{rel:.3e} of the largest, bound {LM_DECODE_REL}")
    check(int(got[0].argmax()) in top5, "9a: the decode's argmax is not "
          "among the prefill's top 5")
    res["decode_vs_prefill_rel"] = rel
    del caches

    # one prefill of prefill_len tokens at B = 1
    rng = np.random.default_rng(SEED)
    long = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, prefill_len))).to(dev)
    forward_prefill(cfg, params, {"tokens": long[:, :64]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = forward_prefill(cfg, params, {"tokens": long})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(tuple(out.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(out.float()).all()),
          "9a: prefill logits not finite or of the wrong shape")
    pterms = lm_prefill_terms(cfg, params, prefill_len)
    res.update(prefill_len=prefill_len, prefill_ms=prefill_s * 1e3,
               prefill_bound_ms=pterms.step_time_s * 1e3,
               prefill_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"9a forward_prefill B=1 S={prefill_len}: {prefill_s * 1e3:.3f} ms "
        f"({prefill_len / prefill_s:.0f} tokens/s), bound "
        f"{res['prefill_bound_ms']:.4f} ms ({pterms.dominant}: "
        f"{pterms.flops:.4e} flops), peak {res['prefill_peak_gib']:.3f} GiB")
    return res


def lm_smoke_on(dev, cfg, params, batch, enc):
    """Prefill logits and LM_SMOKE_STEPS decode steps' logits, as numpy."""
    import numpy as np
    import torch
    from repro_torch.models.model import (forward_decode, forward_prefill,
                                          init_caches)
    B = LM_SMOKE_B
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    outs = [forward_prefill(cfg, params, tb)]
    caches = init_caches(cfg, B, LM_SMOKE_T, dev)
    if cfg.family == "audio":
        caches["enc"] = torch.from_numpy(enc).to(dev)
    for t in range(LM_SMOKE_STEPS):
        pos = torch.tensor([t, t + 2], device=dev)
        lg, caches = forward_decode(cfg, params, caches,
                                    tb["tokens"][:, t].long(), pos)
        outs.append(lg)
    return [o.float().cpu().numpy() for o in outs]


LM_VARIANTS = (("llama3.2-3b", dict(kv_cache_dtype="int8")),
               ("llama3.2-3b", dict(attn_impl="blockwise", attn_block=3)),
               ("deepseek-v2-236b", dict(mla_absorb=True)))


def lm_smoke_archs(dev):
    """Phase 9b: every arch's smoke config in float32, and the int8 KV,
    blockwise and absorbed-MLA variants, on the card against the port's
    own CPU run on the same parameters."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import ARCH_IDS, get_arch
    from repro_torch.models.model import init_params

    worst = 0.0
    cases = [(a, {}) for a in ARCH_IDS] + list(LM_VARIANTS)
    for arch, over in cases:
        cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32",
                                  **over)
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        rng = np.random.default_rng(SEED)
        B, S = LM_SMOKE_B, LM_SMOKE_S
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
        enc = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)
                                  ).astype(np.float32)
        if cfg.frontend == "patch":
            batch["patch_embeds"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        if cfg.frontend == "audio":
            batch["frames"] = enc[:, ::-1].copy()
        host = lm_smoke_on(torch.device("cpu"), cfg, params, batch, enc)
        card = lm_smoke_on(dev, cfg, params.to(dev), batch, enc)
        errs = []
        for what, h, c in zip(["prefill"] + [f"decode {t}" for t in
                                             range(LM_SMOKE_STEPS)],
                              host, card):
            check(h.shape == c.shape and np.isfinite(c).all(),
                  f"9b {arch} {over}: {what} logits not finite or of "
                  "another shape")
            rel = float(np.abs(c - h).max() / max(np.abs(h).max(), 1e-6))
            check(rel <= LM_CARD_REL, f"9b {arch} {over} {what}: the card "
                  f"differs from the CPU by {rel:.3e}, bound {LM_CARD_REL}")
            errs.append(rel)
        worst = max(worst, max(errs))
        log(f"9b {arch} {json.dumps(over) if over else ''}: prefill + "
            f"{LM_SMOKE_STEPS} decode steps, the card against the CPU, "
            f"max rel diff {max(errs):.3e}")
    return worst


def lm_cut_deepseek(dev, cfg):
    """Phase 9c: ``cfg`` (deepseek-v2-236b at full width, depth cut to 2:
    one dense layer and one MoE layer with MLA): one prefill and 4 decode
    steps on the card."""
    import numpy as np
    import torch
    from repro_torch.models.model import (forward_decode, forward_prefill,
                                          init_caches, init_params,
                                          layer_pattern)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(dev)
    forward_prefill(cfg, params, {"tokens": toks[:, :8]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = forward_prefill(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ok = bool(torch.isfinite(logits.float()).all())
    caches = init_caches(cfg, 2, 64, dev)
    t0 = time.perf_counter()
    for t in range(4):
        lg, caches = forward_decode(cfg, params, caches, toks[:, t],
                                    torch.full((2,), t, device=dev))
        ok = ok and bool(torch.isfinite(lg.float()).all())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(ok and tuple(lg.shape) == (2, cfg.vocab_size),
          "9c: logits not finite or of the wrong shape")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"9c {cfg.name} cut to {cfg.num_layers} layers "
        f"({'/'.join(layer_pattern(cfg))}; widths kept: d {cfg.d_model}, "
        f"{cfg.num_heads} heads, kv_lora {cfg.kv_lora_rank}, "
        f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} + "
        f"{cfg.num_shared_experts} shared, vocab {cfg.vocab_size}): "
        f"{n_params} parameters drawn in {init_s:.2f} s; prefill B=2 S=64 "
        f"{prefill_s * 1e3:.3f} ms; 4 decode steps B=2 "
        f"{decode_s * 1e3 / 4:.3f} ms each (the first included); peak "
        f"{peak:.3f} GiB; logits finite")
    return dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
                prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3 / 4,
                peak_gib=peak)


def lm_phase(dev, serve_cfg=None, cut_cfg=None, **serve_kw):
    """Phase 9: 9a, 9b and 9c; the configs default to the full ones."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    serve_cfg = serve_cfg or get_arch(LM_ARCH).config
    cut_cfg = cut_cfg or dataclasses.replace(get_arch(CUT_ARCH).config,
                                             num_layers=CUT_LAYERS)
    served = lm_serve(dev, serve_cfg, **serve_kw)
    torch.cuda.empty_cache()
    served["card_vs_cpu_max_rel"] = lm_smoke_archs(dev)
    served["cut"] = lm_cut_deepseek(dev, cut_cfg)
    torch.cuda.empty_cache()
    log("phase 9 summary: " + json.dumps(served))
    return served


# ---------------------------------------------------------------------------
# phase 10: LM training (no kernel of its own: plain PyTorch and autograd)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 1, 4096   # the reference's train_4k shape, one sequence
TRAIN_WARM, TRAIN_STEPS = 2, 10
BF16_PEAK = 989e12           # H100 SXM dense bf16 (NVIDIA data sheet)
TRAIN_CARD_REL = 1e-4        # float32 smoke configs, the card against the CPU
# a leaf's scale for that bound is at least this share of its tree's
# largest value: llama4's top-1 router gets a zero gradient by
# construction (its one gate is normalised to 1), so both devices hold
# rounding noise there (2e-12 against a largest gradient of 0.2)
NOISE_FLOOR = 1e-6
# the dispatch against moe_local in bf16: the same products at other
# shapes, rounded at other points through two layers' backward, and every
# gradient stored in bf16, whose ulp is 2^-8 to 2^-7 of a value: about
# three ulps of a leaf's largest gradient (the card gave 1.00e-2 on the
# embedding's, one to two ulps; a misrouted copy moves a gradient by O(1))
DISPATCH_REL = 2e-2
# the same in float32 (ROADMAP queue 3's open check): with no misrouted
# copy only the products' rounding at other shapes remains, about 1e-6
# to 1e-4 of a leaf's largest; a misrouted copy moves a gradient by O(1)
DISPATCH_REL_F32 = 1e-3
CUT_B, CUT_S, CUT_CF = 2, 64, 32.0   # 16 tokens a shard: no copy dropped
DISPATCH_MESHES = (((2, 4), ("data", "model"), ("data",), ("model",),
                    "direct"),
                   ((2, 2, 2), ("data", "em", "en"), ("data",),
                    ("em", "en"), "grid"))
SMOKE_CKPT_STEPS, SMOKE_RESUME_STEPS, LAUNCHER_STEPS = 5, 10, 8


def train_stream(cfg, B, S, seed=SEED):
    """The launcher's synthetic stream (token t+1 = (5 t + 7) mod V from
    random first tokens), as CPU tensors, with zero frontend stubs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    while True:
        seq = [rng.integers(0, cfg.vocab_size, (B, 1))]
        for _ in range(S):
            seq.append((seq[-1] * 5 + 7) % cfg.vocab_size)
        arr = np.concatenate(seq, axis=1)
        batch = {"tokens": torch.from_numpy(arr[:, :S]),
                 "labels": torch.from_numpy(arr[:, 1:])}
        if cfg.frontend in ("patch", "audio"):
            key = "patch_embeds" if cfg.frontend == "patch" else "frames"
            batch[key] = torch.zeros((B, cfg.frontend_len, cfg.d_model),
                                     dtype=torch.bfloat16)
        yield batch


def on(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def timed_steps(dev, step, params, state, stream, count):
    """``count`` train steps, host clock ending in a synchronize; the
    losses read after the last."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(count):
        params, state, m = step(params, state, on(next(stream), dev))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return params, state, secs, [float(x) for x in losses]


def lm_train_full(dev, cfg, S=TRAIN_S):
    """Phase 10a: ``cfg`` (llama3.2-3b at full width and depth, bf16)
    trained by ``make_train_step`` with ``TrainConfig()``'s AdamW on one
    sequence of ``S`` tokens: 2 warm-up steps, 10 timed; then one step
    under ``remat_policy="dots"`` and one with 2 microbatches at B = 2."""
    import dataclasses
    import math
    import torch
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    state = init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    watch = [params["final_norm"], params["blocks"][0]["attn"]["wq"]]
    before = [w.detach().clone() for w in watch]
    stream = train_stream(cfg, TRAIN_B, S)
    step = make_train_step(cfg, TrainConfig())
    params, state, warm_s, warm_losses = timed_steps(
        dev, step, params, state, stream, TRAIN_WARM)
    torch.cuda.reset_peak_memory_stats()
    params, state, secs, losses = timed_steps(dev, step, params, state,
                                              stream, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in warm_losses + losses),
          f"10a: a loss is not finite: {warm_losses + losses}")
    check(any(not torch.equal(w, b) for w, b in zip(watch, before)),
          "10a: no watched parameter changed")
    del watch, before
    step_ms = secs / TRAIN_STEPS * 1e3
    tokens = TRAIN_B * S
    flops = model_flops(cfg, {"kind": "train", "seq": S, "batch": TRAIN_B},
                        backward=True)
    res = dict(arch=cfg.name, params=n_params, batch=TRAIN_B, seq=S,
               init_s=init_s, warm_ms=warm_s / TRAIN_WARM * 1e3,
               step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               model_flops=flops,
               bf16_peak_share=flops / (step_ms / 1e3) / BF16_PEAK,
               peak_gib=peak, losses=warm_losses + losses,
               state_gb=sum(p.numel() * (p.element_size() + 8)
                            for p in params.parameters()) / 1e9)
    log(f"10a {cfg.name} trained at full width and depth ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params} parameters; parameters + AdamW moments "
        f"{res['state_gb']:.2f} GB) on B={TRAIN_B} S={S}, remat "
        f"'{cfg.remat_policy}': {TRAIN_WARM} warm-up steps "
        f"{res['warm_ms']:.1f} ms each, then {TRAIN_STEPS} steps "
        f"{step_ms:.3f} ms each ({res['tokens_per_s']:.1f} tokens/s); "
        f"model_flops {flops:.4e} -> {res['bf16_peak_share']:.2%} of the "
        f"989 TFLOP/s bf16 peak; peak {peak:.3f} GiB; losses "
        f"{[round(x, 4) for x in res['losses']]}")

    # the step split: forward + backward, then the AdamW update; and one
    # step under the profiler (device busy share, kernel launches)
    from repro_torch.train.optimizer import apply_update
    batch = on(next(stream), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = _loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    it = iter(grads)
    grads = params.map(lambda p: next(it))
    params, state = apply_update(TrainConfig().opt, params, grads, state)
    torch.cuda.synchronize()
    res.update(fwd_bwd_ms=(t1 - t0) * 1e3,
               adamw_ms=(time.perf_counter() - t1) * 1e3)
    # the iterator too: having handed out every gradient it still holds
    # their tuple (6.7 GiB), which the steps below and 11b would carry
    del grads, it
    busy = kernels = copies = None
    if dev.type == "cuda":  # a CPU rehearsal has no device to trace
        holder = {}

        def one_step():
            holder["out"] = step(params, state, on(next(stream), dev))
        busy, kernels, copies = device_busy(one_step)
        params, state = holder.pop("out")[:2]
    res.update(busy_ms=busy, kernels_per_step=kernels,
               copies_per_step=copies)
    log(f"10a step split: forward_train + backward {res['fwd_bwd_ms']:.1f} "
        f"ms, AdamW update {res['adamw_ms']:.1f} ms; one step under "
        f"torch.profiler: "
        + (f"device busy {busy:.1f} ms, {kernels} kernel launches, "
           f"{copies} memcpy/memset events" if busy is not None else
           "not measured (no device time in the trace)"))

    # one step under remat "dots", one with 2 microbatches at B = 2
    for what, c, tc, B in (
            ("remat 'dots'", dataclasses.replace(cfg, remat_policy="dots"),
             TrainConfig(), TRAIN_B),
            ("2 microbatches", cfg, TrainConfig(microbatches=2), 2)):
        torch.cuda.reset_peak_memory_stats()
        params, state, secs, ls = timed_steps(
            dev, make_train_step(c, tc), params, state,
            train_stream(cfg, B, S, SEED + B), 1)
        check(math.isfinite(ls[0]), f"10a {what}: the loss is not finite")
        res[what] = dict(batch=B, step_ms=secs * 1e3, loss=ls[0],
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        log(f"10a one step, {what}, B={B} S={S}: {secs * 1e3:.3f} ms, "
            f"loss {ls[0]:.4f}, peak {res[what]['peak_gib']:.3f} GiB")
    box = dict(params=params, state=state)
    del params, state
    res["card_counts"] = card_counts(dev, cfg, box, stream, held)
    return res


def card_counts(dev, cfg, box, stream, held):
    """Phase 11b's card side, on phase 10a's parameters and moments
    (``cfg`` at full width, as phases 9a and 10a run it): the real train
    step (B = 1, S = 4096), then, with the moments freed, one decode step
    of 4 slots over length-512 caches and one prefill of 2048 tokens,
    each counted by ``FlopCounterMode``, with
    ``torch.cuda.memory_allocated()`` above ``held`` (what the card held
    before phase 10a drew its parameters) taken right before it: the
    bytes of the step's arguments.  ``box`` holds the only references to
    the parameters and moments, so they are freed here.  The inputs are
    int32, as the dry-run's."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.model import (forward_decode, forward_prefill,
                                          init_caches)
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    def counted(fn, *args):
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - held
        with FlopCounterMode(display=False) as fc:
            fn(*args)
        torch.cuda.synchronize()
        return dict(flops=fc.get_total_flops(), alloc=alloc)

    i32 = lambda b: {k: v.to(dev, torch.int32) for k, v in b.items()}
    params = box.pop("params")
    out = dict(train=counted(make_train_step(cfg, TrainConfig()), params,
                             box.pop("state"), i32(next(stream))))
    gc.collect()
    caches = init_caches(cfg, LM_SLOTS, LM_MAX_LEN, dev)
    zeros = torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev)
    out["decode"] = counted(forward_decode, cfg, params, caches, zeros,
                            zeros.clone())
    del caches, zeros
    tokens = torch.zeros((1, LM_PREFILL_LEN), dtype=torch.int32, device=dev)
    out["prefill"] = counted(forward_prefill, cfg, params,
                             {"tokens": tokens, "labels": tokens.clone()})
    log("11b card side (phase 10a's parameters; FlopCounterMode, "
        "memory_allocated above what was held before them): "
        + json.dumps(out))
    return out


def _loss_and_grads(cfg, params, batch, mesh_ctx=None):
    import torch
    from repro_torch.models.model import forward_train
    params.requires_grad_(True)
    loss = forward_train(cfg, params, batch, mesh_ctx)
    # command-r's parallel block never reads ln2: a zero gradient
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True, materialize_grads=True)
    return float(loss.detach()), grads


def _leaf_rel(got, want):
    """max |got - want| over max |want| of one leaf, on ``got``'s
    device (``want`` may wait on the host)."""
    got = got.detach().float()
    want = want.detach().to(got.device).float()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-6))


def _tree_rel(got, want):
    """The largest leaf error of two trees (tensor lists), each against
    its leaf's largest ``want`` magnitude floored at NOISE_FLOOR of the
    tree's largest: a leaf whose gradient is zero by construction holds
    only rounding noise."""
    got = [g.detach().float().cpu() for g in got]
    want = [w.detach().float().cpu() for w in want]
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max())
               / max(float(w.abs().max()), NOISE_FLOOR * top, 1e-30)
               for g, w in zip(got, want))


def _step_params_err(got, want, host_mu, opt):
    """The parameters after one AdamW step from zero moments: within
    1e-4 * lr where the (clipped) CPU gradient, mu / (1 - b1), is at
    least 1e-6, and within 2 * lr elsewhere, where the step takes the
    sign of a vanishing gradient (the reference test's rule).  Returns
    the largest |diff| / lr where the gradient is at least 1e-6."""
    import torch
    from repro_torch.train.optimizer import schedule
    lr = float(schedule(opt, torch.tensor(1)))
    worst = 0.0
    for g, w, mu in zip(got, want, host_mu):
        diff = (g.detach().float().cpu() - w.detach().float()).abs()
        big = (mu.detach() / (1 - opt.b1)).abs() >= 1e-6
        check(bool((diff[~big] <= 2 * lr).all()),
              "10b: a parameter moved by more than 2 lr from the CPU's")
        if bool(big.any()):
            worst = max(worst, float(diff[big].max()) / lr)
    return worst


def lm_train_smoke(dev):
    """Phase 10b: every arch's smoke config in float32, the same
    parameters and batch on the CPU and the card: ``forward_train``'s loss
    and every gradient, ``mu`` and ``nu`` after one ``make_train_step``
    (1e-4 of each leaf's largest CPU value, ``_tree_rel``), and the
    parameters after it (``_step_params_err``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import ARCH_IDS, get_arch
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    cpu = torch.device("cpu")
    # the CPU train-step test's AdamW (lr 1e-2 at step 1): TrainConfig()'s
    # first step moves a weight by lr = 3e-6, under 1e3 float32 ulps of a
    # 0.05 weight, so a 1e-4 lr bound would measure the rounding of p
    tc = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1,
                                     total_steps=10))
    worst = 0.0
    looks = []
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
        host = init_params(cfg, torch.Generator().manual_seed(SEED), cpu)
        card = host.map(lambda t: t.to(dev, copy=True))
        batch = next(train_stream(cfg, LM_SMOKE_B, LM_SMOKE_S))
        rng = np.random.default_rng(SEED)
        for key in ("patch_embeds", "frames"):  # random, not the zero stubs
            if key in batch:
                batch[key] = torch.from_numpy(rng.standard_normal(
                    tuple(batch[key].shape)).astype(np.float32))
        h_loss, h_grads = _loss_and_grads(cfg, host, batch)
        c_loss, c_grads = _loss_and_grads(cfg, card, on(batch, dev))
        errs = {"loss": abs(c_loss - h_loss) / abs(h_loss),
                "grads": _tree_rel(c_grads, h_grads)}
        looks += _router_look(arch, cfg, host, c_grads, h_grads)
        step = make_train_step(cfg, tc)
        h_p, h_s, _ = step(host, init_state(host), batch)
        c_p, c_s, _ = step(card, init_state(card), on(batch, dev))
        check(int(c_s.step) == int(h_s.step) == 1, f"10b {arch}: step count")
        for name in ("mu", "nu"):
            errs[name] = _tree_rel(getattr(c_s, name).parameters(),
                                   getattr(h_s, name).parameters())
        worst_arch = max(errs.values())
        check(worst_arch <= TRAIN_CARD_REL, f"10b {arch}: the card differs "
              f"from the CPU by {errs}, bound {TRAIN_CARD_REL}")
        errs["params / lr"] = _step_params_err(
            list(c_p.parameters()), list(h_p.parameters()),
            list(h_s.mu.parameters()), tc.opt)
        check(errs["params / lr"] <= TRAIN_CARD_REL, f"10b {arch}: a "
              f"parameter differs from the CPU's by {errs['params / lr']:.3e}"
              f" lr, bound {TRAIN_CARD_REL} lr")
        worst = max(worst, worst_arch)
        log(f"10b {arch}: forward_train loss {c_loss:.6f} (CPU "
            f"{h_loss:.6f}), {len(c_grads)} gradients, mu and nu after one "
            f"train step, the card against the CPU: max rel diff "
            f"{worst_arch:.3e} ({', '.join(f'{k} {v:.2e}' for k, v in errs.items())})")
    return worst, looks


def _router_look(arch, cfg, host, c_grads, h_grads):
    """10b's look at the noise floor: every router gradient's largest
    magnitude on the card and the CPU and their largest difference,
    against the tree's largest CPU gradient.  A top-1 router (llama4's)
    gets a zero gradient by construction (its one gate is normalised to
    1), so both devices must hold noise there, below NOISE_FLOOR of the
    tree's largest, which is what the floor in ``_tree_rel`` assumes; any
    other router is held to its own largest, with no floor."""
    top = max(float(h.abs().max()) for h in h_grads)
    out = []
    for (name, _), g, h in zip(host.named_parameters(), c_grads, h_grads):
        if not name.endswith("router"):
            continue
        g, h = g.detach().float().cpu(), h.detach().float()
        look = dict(arch=arch, leaf=name, top1=cfg.num_experts_per_tok == 1,
                    card=float(g.abs().max()), cpu=float(h.abs().max()),
                    diff=float((g - h).abs().max()), tree_max=top)
        log(f"10b {arch} {name}: router gradient max |card| "
            f"{look['card']:.3e}, max |CPU| {look['cpu']:.3e}, max |diff| "
            f"{look['diff']:.3e}; the tree's largest {top:.3e} (floor "
            f"{NOISE_FLOOR} of it: {NOISE_FLOOR * top:.3e})")
        if look["top1"]:
            check(max(look["card"], look["cpu"]) <= NOISE_FLOOR * top,
                  f"10b {arch} {name}: a top-1 router's gradient is not "
                  f"noise: {look}")
        else:
            check(look["diff"] <= TRAIN_CARD_REL * look["cpu"],
                  f"10b {arch} {name}: the router gradient differs from "
                  f"the CPU's by more than {TRAIN_CARD_REL} of its own "
                  f"largest: {look}")
        out.append(look)
    return out


def lm_train_dispatch(dev, cfg, bound=DISPATCH_REL, time_moe=True):
    """Phase 10c: ``cfg`` (deepseek-v2-236b at full width, cut to 2
    layers; bf16, then float32): ``forward_train`` and its backward pass
    with ``moe_impl="dispatch"`` under a (2, 4) and a (2, 2, 2) grid
    ``MeshContext`` against ``moe_local`` (no mesh), capacity factor
    large enough that no copy is dropped, within ``bound`` of each
    leaf's largest; and (``time_moe``) one MoE layer's ``moe_apply``
    timed both ways.  In float32 the ``moe_local`` gradients wait on the
    host, so the card holds one set of 21 GB beside the parameters."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import MeshContext, init_params
    from repro_torch.models.moe import moe_apply

    cfg = dataclasses.replace(cfg, moe_impl="dispatch",
                              capacity_factor=CUT_CF)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    batch = on(next(train_stream(cfg, CUT_B, CUT_S)), dev)
    t0 = time.perf_counter()
    want_loss, want = _loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    if cfg.dtype == "float32":
        want = [w.cpu() for w in want]
    names = [n for n, _ in params.named_parameters()]
    res = dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
               loss=want_loss, local_fwd_bwd_ms=local_s * 1e3, meshes={})
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (CUT_B, CUT_S, cfg.d_model))).to(dev, cfg.torch_dtype)
    lp = params["moe_blocks"][0]["moe"]
    local_ms = None
    if time_moe:
        with torch.no_grad():
            local_ms = time_ms(lambda: moe_apply(cfg, lp, x), 5)
    for shape, axes, dp, ep, sched in DISPATCH_MESHES:
        c = dataclasses.replace(cfg, moe_dispatch=sched)
        ctx = MeshContext(make_mesh(shape, axes), dp, ep)
        t0 = time.perf_counter()
        loss, grads = _loss_and_grads(c, params, batch, ctx)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        leaf = sorted(((_leaf_rel(g, w), n) for g, w, n in
                       zip(grads, want, names)), reverse=True)
        rel = max(abs(loss - want_loss) / abs(want_loss), leaf[0][0])
        del grads
        ms = None
        if time_moe:
            with torch.no_grad():
                ms = time_ms(lambda: moe_apply(c, lp, x, ctx), 5)
        name = "x".join(map(str, shape)) + " " + "/".join(axes)
        res["meshes"][name] = dict(schedule=sched, ep_size=ctx.ep_size,
                                   loss=loss, max_rel=rel,
                                   largest=[(n, r) for r, n in leaf[:4]],
                                   fwd_bwd_ms=secs * 1e3,
                                   moe_apply_ms=ms)
        log(f"10c {cfg.name} cut to {cfg.num_layers} layers, {cfg.dtype}, "
            f"B={CUT_B} S={CUT_S}, capacity factor {CUT_CF}: forward_train "
            f"+ backward through moe_dispatch on {name} ({sched}, EP "
            f"{ctx.ep_size}) {secs * 1e3:.1f} ms, loss {loss:.5f} against "
            f"moe_local's {want_loss:.5f} ({local_s * 1e3:.1f} ms), max rel "
            f"diff of the loss and every gradient {rel:.3e} (bound {bound}; "
            f"largest leaves {', '.join(f'{n} {r:.2e}' for r, n in leaf[:4])})"
            + (f"; one layer's moe_apply {ms:.3f} ms against moe_local's "
               f"{local_ms:.3f} ms" if time_moe else ""))
        check(rel <= bound, f"10c {name} {sched} {cfg.dtype}: the dispatch "
              f"differs from moe_local by {rel:.3e}, bound {bound}")
    res.update(moe_local_ms=local_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"10c peak {res['peak_gib']:.3f} GiB")
    return res


def lm_train_checkpoint(dev, cfg):
    """Phase 10d: ``cfg`` (llama3.2's smoke config, bf16) trained 5 steps
    with checkpoints, the checkpoint restored bit for bit with every sha1
    checked, the run resumed to step 10; then the launcher in a
    subprocess on the card."""
    import math
    import os
    import re
    import tempfile
    import torch
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, train

    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(opt=AdamWConfig(lr=5e-3), ckpt_dir=d,
                         ckpt_every=SMOKE_CKPT_STEPS, log_every=1)
        first = train(cfg, tc, train_stream(cfg, 8, 32),
                      SMOKE_CKPT_STEPS, log=lambda *_: None, device=dev)
        like = {"params": first["params"], "opt": first["opt_state"]}
        back = checkpoint.restore(d, SMOKE_CKPT_STEPS, like, verify=True)
        same = all(torch.equal(a, b) for a, b in zip(
            back["params"].parameters(), first["params"].parameters()))
        for name in ("mu", "nu"):
            same = same and all(torch.equal(a, b) for a, b in zip(
                getattr(back["opt"], name).parameters(),
                getattr(first["opt_state"], name).parameters()))
        check(same and int(back["opt"].step) == SMOKE_CKPT_STEPS,
              "10d: the restored checkpoint differs from the trained state")
        files = len(os.listdir(os.path.join(
            d, f"step_{SMOKE_CKPT_STEPS:010d}"))) - 1
        logs = []
        second = train(cfg, tc, train_stream(cfg, 8, 32),
                       SMOKE_RESUME_STEPS, log=logs.append, device=dev)
        check(logs[0] == f"[train] resumed from step {SMOKE_CKPT_STEPS}"
              and int(second["opt_state"].step) == SMOKE_RESUME_STEPS
              and all(math.isfinite(x) for x in second["losses"]),
              f"10d: the resumed run did not reach step "
              f"{SMOKE_RESUME_STEPS}: {logs[:2]}")
        check(checkpoint.latest_step(d) == SMOKE_RESUME_STEPS,
              "10d: no checkpoint at the resumed run's end")
    log(f"10d {cfg.name} ({cfg.dtype}): {SMOKE_CKPT_STEPS} steps, the "
        f"checkpoint ({files} leaves) restored bit for bit with every sha1 "
        f"checked, resumed to step {SMOKE_RESUME_STEPS} (losses "
        f"{[round(x, 4) for x in first['losses'] + second['losses']]})")

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-3b", "--smoke", "--steps", str(LAUNCHER_STEPS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    m = re.fullmatch(r"done: final loss (\S+)", lines[-1] if lines else "")
    check(proc.returncode == 0 and m is not None
          and math.isfinite(float(m.group(1))),
          f"10d: the launcher failed (rc {proc.returncode}): "
          f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    log(f"10d launcher python -m repro_torch.launch.train --arch "
        f"llama3.2-3b --smoke --steps {LAUNCHER_STEPS} on the card: "
        f"{secs:.1f} s, last line {lines[-1]!r}")
    return dict(ckpt_leaves=files, final_loss=float(m.group(1)),
                launcher_s=secs)


def lm_train_phase(dev, full_cfg=None, cut_cfg=None, smoke_cfg=None,
                   **full_kw):
    """Phase 10: 10a-10d, the kernel counts set to 0 before and read
    after; the configs default to the full ones."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_arch
    full_cfg = full_cfg or get_arch(LM_ARCH).config
    cut_cfg = cut_cfg or dataclasses.replace(get_arch(CUT_ARCH).config,
                                             num_layers=CUT_LAYERS)
    smoke_cfg = smoke_cfg or get_arch(LM_ARCH).smoke

    def release():
        # the serving engines of phase 9 hold their parameters in
        # reference cycles: collect them before a peak is read
        gc.collect()
        torch.cuda.empty_cache()
    release()
    reset_counts()
    res = dict(full=lm_train_full(dev, full_cfg, **full_kw))
    release()
    res["card_vs_cpu_max_rel"], res["router_look"] = lm_train_smoke(dev)
    res["dispatch"] = lm_train_dispatch(dev, cut_cfg)
    release()
    res["dispatch_f32"] = lm_train_dispatch(
        dev, dataclasses.replace(cut_cfg, dtype="float32"),
        bound=DISPATCH_REL_F32, time_moe=False)
    release()
    res["checkpoint"] = lm_train_checkpoint(dev, smoke_cfg)
    res["launches"] = kernel_counts()
    log("phase 10 summary: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 11: the dry-run (no kernel of its own: meta tensors and counters)
# ---------------------------------------------------------------------------

DRYRUN_RUNS = {"lm": ["--arch", LM_ARCH],
               "mst replicated": ["--mst", "--mst-engine", "replicated"],
               "mst sharded": ["--mst", "--mst-engine", "sharded"]}
DRYRUN_TIMEOUT = 300
DRYRUN_MEM_REL = 2e-2  # meta argument bytes against the card's allocation


def dryrun_launcher():
    """Phase 11a: ``python -m repro_torch.launch.dryrun`` for llama3.2-3b
    x 4 shapes x both production meshes and for the MST cell of both
    engines, three processes at once: every process exits 0, no record
    failed, and the LM cells skipped are exactly those ``cell_supported``
    refuses.  Each costed cell's roofline is printed."""
    import os
    import tempfile
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.shapes import SHAPES, cell_supported
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    records = {}
    with tempfile.TemporaryDirectory() as d:
        out = {k: os.path.join(d, k.replace(" ", "_") + ".json")
               for k in DRYRUN_RUNS}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", out[k]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for k, argv in DRYRUN_RUNS.items()}
        try:
            texts = {k: p.communicate(timeout=DRYRUN_TIMEOUT)
                     for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for k, p in procs.items():
            check(p.returncode == 0,
                  f"11a: dryrun {' '.join(DRYRUN_RUNS[k])} exited "
                  f"{p.returncode}: {texts[k][0][-1000:]} "
                  f"{texts[k][1][-2000:]}")
            with open(out[k]) as f:
                records[k] = json.load(f)
    cfg = get_arch(LM_ARCH).config
    meshes = ("pod-16x16", "multipod-2x16x16")
    want_skipped = {(m, sh) for m in meshes for sh in SHAPES
                    if not cell_supported(cfg, sh)[0]}
    lm = records["lm"]
    got_skipped = {(r["mesh"], r["shape"]) for r in lm
                   if r["status"] == "skipped"}
    failed = [f"{r['arch']} {r['shape']} {r['mesh']}: {r.get('error')}"
              for recs in records.values() for r in recs
              if r["status"] == "failed"]
    check(not failed, f"11a: failed cells {failed}")
    check(len(lm) == len(meshes) * len(SHAPES)
          and got_skipped == want_skipped,
          f"11a: skipped {sorted(got_skipped)}, cell_supported refuses "
          f"{sorted(want_skipped)}")
    check(all(len(records[k]) == len(meshes) for k in records if k != "lm"),
          "11a: an MST run did not cost both meshes")
    rows = []
    for recs in records.values():
        for r in recs:
            if r["status"] != "ok":
                continue
            t = r["roofline"]
            row = dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                       dominant=t["dominant"], compute_s=t["compute_s"],
                       memory_s=t["memory_s"],
                       collective_s=t["collective_s"],
                       useful_ratio=r.get("useful_ratio"),
                       costing_s=r["costing_s"])
            rows.append(row)
            log(f"11a [{row['mesh']}] {row['arch']} x {row['shape']}: "
                f"dominant {row['dominant']}, compute_s {row['compute_s']}, "
                f"memory_s {row['memory_s']}, collective_s "
                f"{row['collective_s']}, useful_ratio {row['useful_ratio']}"
                f" (costed in {row['costing_s']} s)")
    log(f"11a: three dryrun processes in {secs:.1f} s wall; "
        f"{len(rows)} cells costed, skipped {sorted(got_skipped)} "
        "(cell_supported's rule), 0 failed")
    return dict(seconds=secs, cells=rows, skipped=sorted(got_skipped))


def dryrun_on_card(cfg, served, trained):
    """Phase 11b: the cells that phases 9a and 10a ran (``cfg`` decode at
    4 slots of 512, its 2048-token prefill, the train step at B = 1,
    S = 4096) costed on the meta device on a 1 x 1 mesh
    (``launch/dryrun.py: cost_cell``) and held to the card: the flops
    equal to ``FlopCounterMode``'s count of the real step
    (``card_counts``), the argument bytes within 2% of what the card
    allocated for the step, and the measured time (9a's step and
    prefill, 10a's step) at or above the roofline's step time."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import RooflineTerms
    one = make_mesh((1, 1), ("data", "model"))
    card = trained["full"]["card_counts"]
    cells = {"decode": (dict(kind="decode", seq=LM_MAX_LEN, batch=LM_SLOTS),
                        served["step_ms"], "9a's served step"),
             "prefill": (dict(kind="prefill", seq=LM_PREFILL_LEN, batch=1),
                         served["prefill_ms"], "9a's prefill"),
             "train": (dict(kind="train", seq=TRAIN_S, batch=TRAIN_B),
                       trained["full"]["step_ms"], "10a's step")}
    out = {}
    for name, (info, ms, what) in cells.items():
        rec = dryrun.cost_cell(cfg, info, one)
        terms = RooflineTerms(rec["cost"]["flops"], rec["cost"]["bytes"],
                              rec["collectives"]["wire_bytes"], 1)
        bound_ms = terms.step_time_s * 1e3
        args = rec["memory"]["argument_bytes"]
        alloc = card[name]["alloc"]
        res = dict(flops=rec["cost"]["flops"], card_flops=card[name]["flops"],
                   bytes=rec["cost"]["bytes"], argument_bytes=args,
                   card_alloc=alloc, mem_rel=abs(args - alloc) / alloc,
                   bound_ms=bound_ms, bound_by=terms.dominant,
                   compute_ms=terms.compute_s * 1e3,
                   memory_ms=terms.memory_s * 1e3, measured_ms=ms,
                   measured_over_bound=ms / bound_ms,
                   costing_s=rec["costing_s"])
        out[name] = res
        log(f"11b {cfg.name} {name} {info}: meta flops {res['flops']:.6e} "
            f"(card FlopCounterMode {res['card_flops']:.6e}), bytes "
            f"{res['bytes']:.6e}; argument bytes {args} against "
            f"{alloc} allocated on the card ({res['mem_rel']:.3%}); "
            f"roofline {bound_ms:.4f} ms ({terms.dominant}: compute "
            f"{res['compute_ms']:.4f} ms, memory {res['memory_ms']:.4f} "
            f"ms), {what} {ms:.3f} ms = {ms / bound_ms:.2f}x the bound; "
            f"costed in {rec['costing_s']} s")
        check(res["flops"] == res["card_flops"],
              f"11b {name}: the meta count differs from the card's")
        check(res["mem_rel"] <= DRYRUN_MEM_REL,
              f"11b {name}: argument bytes {args} against {alloc} "
              f"allocated, bound {DRYRUN_MEM_REL}")
        check(ms >= bound_ms, f"11b {name}: {what} {ms:.4f} ms is under "
              f"its roofline bound {bound_ms:.4f} ms: the costing is wrong")
    return out


def plan_bytes_on_card(dev, layout, n):
    """Phase 11c: ``synthetic_plan`` replayed on phase 3's prebuilt
    layout through ``make_sharded_mst_step(plan=...)`` (the residual
    folds into ``overflow``), with ``adaptive_doubling`` off and on:
    ``plan_exchange_bytes`` equals the replay's ``ExchangeStats.bytes``
    with it off and bounds it with it on."""
    import torch
    from repro_torch.core.distributed_sharded import make_sharded_mst_step
    from repro_torch.core.plan import synthetic_plan
    from repro_torch.launch.roofline import plan_exchange_bytes
    plan = synthetic_plan(n, layout.cap_total, NUM_SHARDS)
    out = {}
    for adaptive in (False, True):
        pl = plan._replace(adaptive_doubling=adaptive)
        step, _ = make_sharded_mst_step(n, layout.cap_total, NUM_SHARDS,
                                        plan=pl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(*layout)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got, want = float(res[5].bytes), plan_exchange_bytes(pl)
        key = "adaptive" if adaptive else "static"
        out[key] = dict(replay_bytes=got, plan_bytes=want,
                        overflow=int(res[4]), replay_s=secs)
        log(f"11c synthetic plan ({pl.num_rounds} rounds) replayed on "
            f"phase 3's layout (n={n}, p={NUM_SHARDS}), adaptive_doubling "
            f"{adaptive}: ExchangeStats.bytes {got:.9e}, "
            f"plan_exchange_bytes {want:.9e} ("
            + ("must be equal" if not adaptive else "a bound") + f"); "
            f"overflow + residual {int(res[4])}; replay {secs:.3f} s")
        check(got == want if not adaptive else got <= want,
              f"11c adaptive_doubling={adaptive}: plan bytes {want} "
              f"against the replay's {got}")
    return out


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
            del driven, plan, b_plan, second
            # phase 3f: serving at full width, then the launcher
            t0 = time.perf_counter()
            served = serve_full_width(dev, u, v, w, n, cached["boruvka"][0])
            served["k1"]["launcher"] = launcher_on_card()
            log(f"phase 3f: {time.perf_counter() - t0:.1f} s wall")
            # phase 3g: the replicated engine on phase 3's layout
            t0 = time.perf_counter()
            replicated_engine(dev, layout, n, u, v, w, cached["boruvka"][0],
                              ref_weight, ref_count)
            log(f"phase 3g: {time.perf_counter() - t0:.1f} s wall")
            # the layout stays for phase 11c

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

    # sample sort at the main path's shard count
    sample_sort_phase(dev)

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
        counts = kernel_counts()
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
                    robustness_paths=robust["k1"],
                    served_path=served["k1"]),
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
    # phase 9: the LM serving path, counted from 0 inside lm_serve
    t0 = time.perf_counter()
    lm = lm_phase(dev)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s wall")
    # phase 10: LM training, counted from 0 inside lm_train_phase
    t0 = time.perf_counter()
    trained = lm_train_phase(dev)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s wall")
    # phase 11: the dry-run, counted from 0
    t0 = time.perf_counter()
    from repro_torch.configs.base import get_arch
    reset_counts()
    costing = dict(launcher=dryrun_launcher(),
                   card=dryrun_on_card(get_arch(LM_ARCH).config, lm,
                                       trained),
                   plan_bytes=plan_bytes_on_card(dev, layout, n))
    costing["launches"] = kernel_counts()
    del layout
    log("phase 11 summary: " + json.dumps(costing))
    log(f"phase 11: {time.perf_counter() - t0:.1f} s wall")
    for entry in kernels:
        entry["lm_path"] = lm["launches"][entry["name"]]
        entry["lm_train_path"] = trained["launches"][entry["name"]]
        entry["dryrun_path"] = costing["launches"][entry["name"]]
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
