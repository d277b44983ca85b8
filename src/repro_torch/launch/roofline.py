"""Roofline costing, the pure parts of ``repro/launch/roofline.py``:
``RooflineTerms``, ``plan_summary`` and ``model_flops``.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM), 700 W, NVIDIA's data
sheet, dense rates:
    peak bf16 compute : 989 TFLOP/s
    HBM bandwidth     : 3.35 TB/s
    NVLink            : 450 GB/s per direction

Three terms per program (per device):
    compute    = flops / peak
    memory     = bytes / hbm_bw
    collective = collective_bytes / nvlink_bw

The reference also parses XLA artifacts: ``collective_bytes_from_hlo``
reads compiled HLO text and ``cost_summary`` a compiled program's
``cost_analysis``.  The port compiles no XLA program, so they have no
counterpart here; a caller counts its own flops and bytes from shapes
(``chip_smoke.py`` phase 9 does so for a decode step).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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
