"""Roofline costing, the port of ``repro/launch/roofline.py``:
``RooflineTerms``, ``plan_summary``, ``model_flops``, and the counting
that stands in for the reference's compiled-program analysis
(``cost_summary``, ``lm_collective_bytes``, ``plan_exchange_bytes``,
``replicated_exchange_bytes``).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM), 700 W, NVIDIA's data
sheet, dense rates:
    peak bf16 compute : 989 TFLOP/s
    HBM bandwidth     : 3.35 TB/s
    NVLink            : 450 GB/s per direction

Three terms per program (per device):
    compute    = flops / peak
    memory     = bytes / hbm_bw
    collective = collective_bytes / nvlink_bw

The reference reads XLA artifacts: ``cost_summary`` a compiled
program's ``cost_analysis`` and ``collective_bytes_from_hlo`` its HLO
text.  The port compiles nothing, so it counts instead:

  * ``cost_summary(step, args)`` runs the step once, eagerly, under
    ``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode
    that adds, for every aten op, the bytes of its tensor inputs (read
    once) and outputs (written once).  View ops (``OpOverload.is_view``,
    and ``_unsafe_view``) and the allocators ``empty``/``empty_strided``
    move nothing and count nothing.  The port runs eagerly with no
    fusion, so the per-op bytes are what the card moves, give or take
    its caches; the counter counts the whole program as one device runs
    it, and a per-chip figure is that count over the mesh's chips.  On
    the ``meta`` device nothing is allocated, so a cell costs its full
    published width on any host.  ``FlopCounterMode`` counts the
    products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
    ``scaled_dot_product_attention``); element-wise ops, reductions,
    softmax, gathers, scatters and sorts have no flop formula there and
    count 0 flops (their bytes are counted).
  * ``lm_collective_bytes`` states an LM step's collectives from its
    partition specs (the rule is in its docstring).
  * ``plan_exchange_bytes`` and ``replicated_exchange_bytes`` give the
    MSF engines' ``ExchangeStats.bytes`` from a ``RoundPlan`` or a round
    count, without running an engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12      # bf16 dense / card
HBM_BW = 3.35e12         # bytes / s / card
NVLINK_BW = 450e9        # bytes / s / card, one direction


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per device
    bytes_accessed: float        # per device
    collective_bytes: float      # per device
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (full overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: compute term / max term (1.0 = compute
        bound at peak)."""
        t = self.step_time_s
        return self.compute_s / t if t > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "coll_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_fraction": self.compute_fraction,
        }


def plan_summary(plan) -> Dict[str, float]:
    """Host-side static costing view of a ``core/plan.py: RoundPlan``.

    Every exchange of round ``r`` allocates ``[p, cap]`` buffers at the
    plan's static capacities, so the capacity trajectory can be costed
    without running it.  Sums and maxima only.
    """
    caps = ("cap_edge", "cap_lookup", "cap_contract", "cap_relabel",
            "cap_push")
    out: Dict[str, float] = {
        "rounds": float(plan.num_rounds),
        "sentinel_rounds": float(sum(r.sentinel for r in plan.rounds)),
        "levels": float(len(plan.level_bounds)),
        "ghost": float(plan.ghost is not None),
        "edge_capacity_full": float(plan.edge_capacity_full),
    }
    for f in caps:
        vals = [getattr(r, f) for r in plan.rounds]
        out[f"{f}_sum"] = float(sum(vals))
        out[f"{f}_max"] = float(max(vals))
    # flat comparator: the fused engine ships the full edge capacity
    # for every round the plan runs
    out["cap_edge_flat_sum"] = float(plan.edge_capacity_full
                                     * plan.num_rounds)
    out["cap_edge_shrink"] = out["cap_edge_flat_sum"] / max(
        out["cap_edge_sum"], 1.0)
    return out


def model_flops(cfg, shape_info: Dict, backward: bool) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D tokens (train) or 2*N_active*D
    (forward-only), attention term included for long sequences."""
    tokens = shape_info["batch"] * (shape_info["seq"]
                                    if shape_info["kind"] != "decode" else 1)
    n = cfg.active_param_count()
    mult = 6.0 if backward else 2.0
    base = mult * n * tokens
    # attention score/value flops: 2 * 2 * tokens * ctx * H * hd (fwd)
    if cfg.family not in ("ssm",):
        ctx = shape_info["seq"]
        att = 2 * 2 * tokens * ctx * cfg.num_heads * cfg.hd
        if shape_info["kind"] == "train":
            att *= 0.5 * 3.0  # causal half, fwd+bwd
        base += att * cfg.num_layers
    return base


# ---------------------------------------------------------------------------
# counting an eager step: flops and bytes
# ---------------------------------------------------------------------------

# views the schema does not mark, and allocations that touch nothing
_NO_BYTES = (torch.ops.aten._unsafe_view.default,
             torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default)


def _tensor_bytes(x) -> int:
    """Bytes of the tensors in an op's arguments or result (tensors,
    lists and tuples of them, dicts of keyword arguments)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(y) for y in x.values())
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs into
    ``bytes``; views and allocations count 0."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func in _NO_BYTES):
            self.bytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                           + _tensor_bytes(out))
        return out


def cost_summary(step, args: Sequence[Any]) -> Tuple[Dict[str, float], Any]:
    """Run ``step(*args)`` once under ``FlopCounterMode`` and the byte
    counter.  Returns ``({"flops", "bytes"}, the step's outputs)``: the
    whole step as one device runs it (the module docstring says what
    each counts).  The reference's ``cost_summary`` reads the same two
    numbers, per device, off a compiled program."""
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        out = step(*args)
    return ({"flops": float(flops.get_total_flops()),
             "bytes": float(counter.bytes)}, out)


# ---------------------------------------------------------------------------
# LM collectives from the partition specs
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class _Collectives:
    """Per-chip sums in the reference's ``collective_bytes_from_hlo``
    units: with ``R`` the per-chip result bytes and ``G`` the group,
    operand and wire (ring, receive side) bytes are
      all-reduce      R          2R(G-1)/G
      all-gather      R/G        R(G-1)/G
      reduce-scatter  R*G        R(G-1)
      all-to-all      R          R(G-1)/G
    """

    def __init__(self):
        self.op = {k: 0.0 for k in COLLECTIVES}
        self.wire = {k: 0.0 for k in COLLECTIVES}
        self.count = {k: 0.0 for k in COLLECTIVES}

    def add(self, kind: str, result: float, group: int, times: int = 1):
        if group <= 1 or times <= 0 or result <= 0:
            return
        g = float(group)
        op, wire = {
            "all-reduce": (result, 2.0 * result * (g - 1) / g),
            "all-gather": (result / g, result * (g - 1) / g),
            "reduce-scatter": (result * g, result * (g - 1)),
            "all-to-all": (result, result * (g - 1) / g),
        }[kind]
        self.op[kind] += times * op
        self.wire[kind] += times * wire
        self.count[kind] += times

    def as_dict(self) -> Dict[str, float]:
        res = {f"{k}_bytes": v for k, v in self.op.items()}
        res.update({f"{k}_wire": v for k, v in self.wire.items()})
        res.update({f"{k}_count": v for k, v in self.count.items()})
        res["total_bytes"] = sum(self.op.values())
        res["wire_bytes"] = sum(self.wire.values())
        return res


def _row_parallel_sites(cfg, kind: str) -> Tuple[int, int]:
    """(decoder-side all-reduces, encoder-side all-reduces) of one
    forward pass: one per row-parallel projection whose output is
    summed over the model axis."""
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "moe"):
        return 2 * L, 0                      # attention out, FFN/MoE out
    if cfg.family == "ssm":
        return L, 0                          # out_proj
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        sites = sum(1 for i in range(L) if every and i % every == every - 1)
        return L + 2 * sites, 0
    if cfg.family == "audio":                # self, cross, MLP; encoder
        return 3 * L, (0 if kind == "decode" else 2 * cfg.encoder_layers)
    raise ValueError(cfg.family)


def lm_collective_bytes(cfg, info: Dict, params: Dict[str, Tuple],
                        specs: Dict[str, tuple], mesh) -> Dict[str, float]:
    """Per-chip collective bytes of one LM step of kind ``info["kind"]``
    from ``params`` (``{stacked path: (shape, dtype)}``) and their specs
    on ``mesh``, in the reference's record keys.  The rule:

      * a parameter sharded on a data axis (ZeRO-3: the MoE experts'
        hidden dim) is all-gathered over those axes before use: once a
        serving step, twice a train step (the forward and the remat's
        recompute);
      * a train step reduce-scatters such a parameter's gradient over
        the same axes, and all-reduces every gradient over the data
        axes its spec does not name (data parallelism);
      * every row-parallel projection (attention out, FFN or MoE out,
        the SSM's out_proj; whisper's cross-attention and encoder too)
        all-reduces its activation ``[tokens, d_model]`` over "model"
        (tensor parallelism), once a forward pass; a train step makes
        three passes (forward, recompute, backward);
      * an MoE layer moves each token's ``k`` routed copies to the
        experts' shards and back over "model": two all-to-alls a pass.

    A chip's tokens are the batch over the data axes (when they divide
    it) times the sequence (1 for decode).  Collectives a serving cell
    could need besides (a sequence-sharded cache's softmax combine, the
    loss's vocab reduction) and the optimizer's own traffic are not
    counted, so the figure is a lower bound on what the reference's
    partitioner moves."""
    from repro_torch.models.model import layer_pattern
    from repro_torch.models.sharding import data_axes, shard_shape
    col = _Collectives()
    kind = info["kind"]
    train = kind == "train"
    dp = data_axes(mesh)
    D = math.prod(mesh.shape[a] for a in dp)
    M = mesh.shape.get("model", 1)
    for path, (shape, dtype) in params.items():
        spec = specs[path]
        shard = math.prod(shard_shape(shape, spec, mesh)) * dtype.itemsize
        named = set()
        for e in spec:
            named.update((e,) if isinstance(e, str) else (e or ()))
        g = math.prod(mesh.shape[a] for a in dp if a in named)
        col.add("all-gather", shard * g, g, 2 if train else 1)
        if train:
            col.add("reduce-scatter", shard, g)
            col.add("all-reduce", shard, D // g)
    B, S = info["batch"], info["seq"]
    b_local = B // D if (B % D == 0 and B >= D) else B
    tokens = b_local * (1 if kind == "decode" else S)
    width = cfg.d_model * cfg.torch_dtype.itemsize
    passes = 3 if train else 1
    dec, enc = _row_parallel_sites(cfg, kind)
    col.add("all-reduce", tokens * width, M, passes * dec)
    col.add("all-reduce", b_local * cfg.frontend_len * width, M,
            passes * enc)
    if cfg.is_moe:
        n_moe = sum(1 for k in layer_pattern(cfg) if k == "moe")
        col.add("all-to-all", tokens * cfg.num_experts_per_tok * width, M,
                2 * passes * n_moe)
    return col.as_dict()


# ---------------------------------------------------------------------------
# MSF engines: ExchangeStats.bytes without running them
# ---------------------------------------------------------------------------

def plan_exchanges(plan, sizes: Tuple[int, ...]
                   ) -> Iterator[Tuple[int, float]]:
    """(``ExchangeStats.bytes`` increment, its wire bytes) of every
    exchange of one replay of ``plan`` (``core/distributed_sharded.py:
    _planned_shard_fn``) on the layout ``sizes``, in the order the
    engine adds them.  The increments are one shard's capacity-padded
    buffers (``comm/exchange.py: _buffer_bytes``): a routed exchange of
    capacity C ships ``p * C`` rows of its leaves plus a 1-byte validity
    mask, a reply ``p * C`` rows of the answers, each once a hop of the
    schedule; the wire bytes leave out the rows a hop keeps on its own
    shard (``(a - 1) / a`` of a hop over an axis of ``a`` shards).

    Every loop whose trip count depends on the data takes its static
    bound, as the reference's HLO weights a ``while`` by its bound: the
    pointer doubling its ``_doubling_iters(n)`` steps whether
    ``adaptive_doubling`` stops it early or not; the preprocessing loop
    ships nothing."""
    from repro_torch.core.distributed import _doubling_iters
    p = plan.num_shards
    hops = (p,) if (plan.schedule == "direct" or len(sizes) == 1) \
        else sizes
    keep = sum(1 - 1 / a for a in hops)
    i32, f32, mask = 4, 4, 1

    def routed(cap, leaves):
        row = p * cap * (sum(leaves) + mask)
        yield row * len(hops), row * keep

    def reply(cap, leaves):
        row = p * cap * sum(leaves)
        yield row * len(hops), row * keep

    def lookup(cap):
        yield from routed(cap, [i32])
        yield from reply(cap, [i32])

    iters = _doubling_iters(plan.n)
    if plan.local_preprocessing:  # the (vid, root) scatter to the owners
        yield from routed(min(plan.cap_prep, plan.cap_per_shard),
                          [i32, i32])
    push_masks = 2 if plan.grid_push else 1
    if plan.ghost is not None:     # two fills, one subscription
        gp = plan.ghost
        yield from lookup(gp.cap_fill_u)
        yield from lookup(gp.cap_fill_v)
        yield from routed(gp.cap_subscribe, [i32] * (1 + push_masks))
    candidate = [i32, f32, i32, i32]  # (comp, w, eid, other)
    for spec in plan.rounds:
        cached = plan.ghost is not None and spec.ghost
        if not cached:             # both endpoint lookups
            yield from lookup(spec.cap_lookup)
            yield from lookup(spec.cap_lookup)
        if plan.src_only:
            yield from routed(spec.cap_edge, candidate)
        else:
            yield from routed(spec.cap_edge, candidate)
            yield from routed(spec.cap_edge, candidate)
            yield from reply(spec.cap_edge, [mask])
            yield from reply(spec.cap_edge, [mask])
        for _ in range(1 + iters):  # the 2-cycle hop, then the doubling
            yield from lookup(spec.cap_contract)
        if plan.src_only:          # the deferred confirmation
            yield from reply(spec.cap_edge, [mask])
        if plan.relabel_skip:
            yield from routed(spec.cap_relabel, [i32])
            yield from reply(spec.cap_relabel, [i32, mask])
        else:
            yield from lookup(spec.cap_relabel)
        if cached:                 # the root-delta push, then the forward
            if plan.grid_push:     # over the columns, then down the rows
                R, C = sizes
                one = C * spec.cap_push * (3 * i32 + mask)
                two = R * spec.cap_push_col * (2 * i32 + mask)
                yield one + two, one * (1 - 1 / C) + two * (1 - 1 / R)
            else:                  # p destination rows a shard
                row = p * spec.cap_push * (2 * i32 + mask)
                yield row * len(hops), row * keep
            yield from routed(spec.cap_push, [i32] * (1 + push_masks))


def plan_exchange_bytes(plan, axis_sizes: Optional[Sequence[int]] = None,
                        wire: bool = False) -> float:
    """``ExchangeStats.bytes`` of one replay of ``plan`` through
    ``make_sharded_mst_step(plan=...)`` on the layout ``axis_sizes``
    (``(plan.num_shards,)`` by default, or the ``(R, C)`` grid): the
    capacity-padded buffer bytes of one shard (``comm/exchange.py:
    ExchangeStats``), summed round by round over the plan's static
    capacities (``plan_exchanges``) in float32 in the engine's order,
    as the engine's counter sums them.  Equal to the replay's with
    ``adaptive_doubling`` off; with it on, an upper bound.  ``wire``
    gives the bytes that leave the shard instead (summed exactly)."""
    sizes = tuple(axis_sizes or (plan.num_shards,))
    if math.prod(sizes) != plan.num_shards:
        raise ValueError(f"layout {sizes} does not hold the plan's "
                         f"{plan.num_shards} shards")
    if plan.grid_push and len(sizes) != 2:
        raise ValueError("a grid-push plan needs an (R, C) layout, got "
                         f"{sizes}")
    if wire:
        return float(sum(w for _, w in plan_exchanges(plan, sizes)))
    acc = np.float32(0.0)
    for inc, _ in plan_exchanges(plan, sizes):
        acc = np.float32(acc + np.float32(inc))
    return float(acc)


def flat_capacity_plan(plan):
    """``plan`` with every round at the plan's full capacities (edges,
    lookups, labels): the flat comparator of the dry-run's MSF cell,
    which ships the full buffers every round the plan runs."""
    rounds = tuple(r._replace(cap_edge=plan.edge_capacity_full,
                              cap_lookup=plan.lookup_capacity_full,
                              cap_contract=plan.label_capacity_full,
                              cap_relabel=plan.label_capacity_full)
                   for r in plan.rounds)
    return plan._replace(rounds=rounds)


def replicated_exchange_bytes(n: int, num_shards: int, rounds,
                              algorithm: str = "boruvka",
                              local_preprocessing: bool = True) -> float:
    """``CommStats.bytes`` of the replicated engine
    (``core/distributed.py: distributed_msf`` and ``make_mst_step``) at
    ``rounds`` Borůvka rounds (for ``filter_boruvka`` a sequence, one
    count a level), in the engine's float32 arithmetic: three
    all-reduced n-vectors a round (12n bytes), the preprocessing's label
    combine and boundary gathers (4(n + 2p)), the filter's pivot gather
    (4 * 64p).  The dry-run takes the static ``log2(n) + 1`` rounds."""
    f32 = np.float32
    nbytes = f32(0.0)
    if local_preprocessing:
        nbytes += f32(4 * (n + 2 * num_shards))
    if algorithm == "boruvka":
        nbytes += f32(12.0 * n) * f32(rounds)
    elif algorithm == "filter_boruvka":
        nbytes += f32(4 * 64 * num_shards)
        for r in rounds:
            nbytes += f32(12.0 * n) * f32(r)
    else:
        raise ValueError(f"no analytic byte count for {algorithm!r}")
    return float(nbytes)
