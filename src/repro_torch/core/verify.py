"""Self-verification of a returned MSF on the solve's device.

Port of ``repro/core/verify.py``.  A fault past the transport layer (a
corrupted in-flight candidate, a dropped receive slot, a stalled shard)
can produce a plausible forest with overflow 0.  ``verify_forest``
checks the returned (mask, labels) pair against the invariants every
correct MSF run satisfies, at O(n/p) cost per shard:

  * **pointer-chase convergence** — the labels are a fixpoint,
    ``lab[lab[x]] == lab[x]`` for every real vertex (one owner-routed
    request/reply at capacity ``vps``, which cannot overflow: a shard
    sends at most ``vps`` requests);
  * **range** — every real vertex's label is a real vertex id;
  * **forest size** — ``count == n - components``, components counted
    as label fixpoints;
  * **edge sanity** — no masked slot is padding or a self-loop;
  * **weight checksum** — the recomputed ``sum(w[mask])`` against a
    caller-supplied expectation, within ``rel_tol``.

The verifier's exchange is labelled ``site="verify"``, which blanket
fault plans never match.  Each shard's weight is summed in the
reference's order and the shards are added in shard order, so the
report's ``weight`` equals the reference's bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.comm.exchange import psum_f32, reply, routed_exchange
from repro_torch.core.distributed import DistGraph
from repro_torch.core.distributed_sharded import _bases, _take, shard_layout
from repro_torch.core.graph import reference_order_sum
from repro_torch.device import DeviceLike, resolve_device


class VerifyReport(NamedTuple):
    """Host-side verdict of one ``verify_forest`` pass.  ``reasons`` is
    empty iff ``ok``; every failed invariant contributes one line."""
    ok: bool
    reasons: Tuple[str, ...]
    count: int            # masked edges
    components: int       # label fixpoints among real vertices
    weight: float         # recomputed sum(w[mask]) over all shards
    converged_bad: int    # real vertices with lab[lab[x]] != lab[x]
    range_bad: int        # real vertices with lab[x] outside [0, n)
    edge_bad: int         # masked slots that are padding or self-loops
    overflow: int         # verify-exchange overflow (0 by construction)


class VerifyFailure(RuntimeError):
    """A returned forest failed self-verification.  ``report`` carries
    the invariant-by-invariant breakdown."""

    def __init__(self, report: VerifyReport):
        self.report = report
        super().__init__(
            "forest failed verification: " + "; ".join(report.reasons))


def _verify_counts(u, v, w, mask, lab, n: int, vps: int, axis_sizes):
    """The invariant counts over stacked ``[p, cap]`` slots and ``[p,
    vps]`` labels: (converged_bad, range_bad, edge_bad, components,
    count, overflow) as one int64 tensor, and the float32 weight."""
    p = lab.shape[0]
    base = _bases(p, vps, lab.device)
    vid = base + torch.arange(vps, dtype=torch.int32, device=lab.device)
    real = vid < n
    # range first: out-of-range labels are counted, then clamped so the
    # fixpoint request still routes to a real owner
    range_bad = (real & ((lab < 0) | (lab >= n))).sum()
    labq = lab.clamp(0, n - 1)
    ex = routed_exchange(labq, labq // vps, real, vps, axis_sizes, "grid",
                         site="verify")
    off = (ex.recv - base.view(p, 1, 1)).clamp(0, vps - 1)
    answers = torch.where(ex.recv_ok, _take(lab, off), -1)
    lab2 = reply(ex, answers, axis_sizes, "grid")
    ok_req = real & ex.sent_ok
    converged_bad = ((ok_req & (lab2 != labq)).sum()
                     + (real & ~ex.sent_ok).sum())
    components = (real & (lab == vid)).sum()
    count = mask.sum()
    edge_bad = (mask & (~torch.isfinite(w) | (u == v))).sum()
    weight = psum_f32(reference_order_sum(torch.where(mask, w, 0.0)))
    ints = torch.stack([converged_bad, range_bad, edge_bad, components,
                        count, ex.overflow.to(torch.int64)])
    return ints, weight


def verify_forest(graph: DistGraph, n: int, num_shards,
                  mask: torch.Tensor, lab: torch.Tensor, *,
                  expected_weight: Optional[float] = None,
                  expected_count: Optional[int] = None,
                  rel_tol: float = 1e-5, raise_on_fail: bool = True,
                  device: DeviceLike = None) -> VerifyReport:
    """Check ``(mask, lab)`` as an MSF of ``graph`` over ``num_shards``
    stacked shards (an int ``p`` or an ``(R, C)`` layout).

    ``mask`` is the engine's per-slot mask (``[p * cap]``), ``lab`` the
    sharded labels (``[p * vps]``).  The structural invariants always
    run; the weight and count checks run when the caller supplies
    expectations — the replay's own scalars in ``execute_plan(verify=
    True)``, the Kruskal oracle's in the chaos harness.  ``rel_tol``
    tolerates summation-order noise in the weight.

    Runs on ``device`` (the CUDA card when None, which raises where there
    is none; the tests pass ``"cpu"``).  Returns the ``VerifyReport``;
    with ``raise_on_fail`` a failing report raises ``VerifyFailure``.
    """
    dev = resolve_device(device)
    sizes = shard_layout(num_shards)
    p = math.prod(sizes)
    vps = max(1, -(-n // p))
    cap = graph.cap_total // p

    def shards(x, width):
        return x.to(dev).reshape(p, width)

    ints, weight = _verify_counts(
        shards(graph.u, cap), shards(graph.v, cap), shards(graph.w, cap),
        shards(mask, cap), shards(lab, vps), n, vps, sizes)
    (converged_bad, range_bad, edge_bad, components, count,
     overflow) = ints.tolist()
    weight = float(weight)
    reasons = []
    if overflow:
        reasons.append(f"verify exchange overflowed ({overflow} items)")
    if range_bad:
        reasons.append(f"{range_bad} labels outside [0, {n})")
    if converged_bad:
        reasons.append(f"{converged_bad} labels not a fixpoint "
                       "(lab[lab[x]] != lab[x])")
    if edge_bad:
        reasons.append(f"{edge_bad} masked slots are padding or "
                       "self-loops")
    if count != n - components:
        reasons.append(f"edge count {count} != n - components = "
                       f"{n} - {components} = {n - components}")
    if expected_count is not None and count != int(expected_count):
        reasons.append(f"edge count {count} != expected "
                       f"{int(expected_count)}")
    if expected_weight is not None:
        exp = float(expected_weight)
        if abs(weight - exp) > rel_tol * max(1.0, abs(exp)):
            reasons.append(f"weight checksum {weight!r} != expected "
                           f"{exp!r} (rel_tol={rel_tol})")
    report = VerifyReport(ok=not reasons, reasons=tuple(reasons),
                          count=count, components=components,
                          weight=weight, converged_bad=converged_bad,
                          range_bad=range_bad, edge_bad=edge_bad,
                          overflow=overflow)
    if reasons and raise_on_fail:
        raise VerifyFailure(report)
    return report
