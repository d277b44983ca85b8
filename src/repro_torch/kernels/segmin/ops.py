"""Public wrappers around the segmented-scan machinery.

Port of ``repro/kernels/segmin/ops.py``: ``run_metadata`` (contiguous
equal-value runs, used by the sharded engine's coalescing levers), the
dense per-vertex min-edge entry point ``min_edges_dense`` (K3, then
phase 2) and the ``scatter_min_tables`` dispatcher in front of K1.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.segmin.ref import (Tables, dense_min_from_candidates,
                                            owner_scatter_min_ref,
                                            segmin_candidates_ref)
from repro_torch.kernels.segmin.segmin import (owner_scatter_min,
                                               segmin_candidates)


def run_metadata(values: torch.Tensor, perm: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contiguous equal-value run structure of ``values`` ([..., L]).

    Returns (head [..., L] bool — first slot of its run, head_idx
    [..., L] int32 — index of each slot's run head, run_id [..., L]
    int32 — dense run number), each row of the last dimension on its own
    (the stacked shards of the sharded engine).  With ``perm`` (int
    permutations of each row, the shape of ``values``) the runs are
    computed over the permuted view ``values.gather(-1, perm)`` and the
    metadata is in permuted-slot order.  An empty row has no runs.
    """
    if perm is not None:
        values = values.gather(-1, perm.long())
    L = values.shape[-1]
    dev = values.device
    if L == 0:
        z = torch.zeros(values.shape, dtype=torch.int32, device=dev)
        return torch.zeros(values.shape, dtype=torch.bool, device=dev), z, z
    idx = torch.arange(L, dtype=torch.int32, device=dev).expand(
        values.shape)
    head = torch.ones(values.shape, dtype=torch.bool, device=dev)
    head[..., 1:] = values[..., 1:] != values[..., :-1]
    head_idx = torch.cummax(torch.where(head, idx, 0), -1).values
    run_id = torch.cumsum(head, -1, dtype=torch.int32) - 1
    return head, head_idx, run_id


def min_edges_dense(seg: torch.Tensor, w: torch.Tensor, eid: torch.Tensor,
                    alive: torch.Tensor, n: int, *, block: int = 512,
                    use_kernel: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-vertex (min weight, argmin eid) over contiguous-run edges.

    Two-phase: run-end candidates, then the scatter-min of phase 2 into
    dense ``(wmin f32 [n], emin i32 [n])``.  ``use_kernel=True`` takes
    the candidates from the K3 wrapper (the CUDA kernel on the card, its
    plain version on CPU tensors, in blocks of ``block``);
    ``use_kernel=False`` from the array-wide plain version.  The dense
    result is the same either way.
    """
    if use_kernel:
        cw, ce = segmin_candidates(seg, w, eid, alive, block=block)
    else:
        cw, ce = segmin_candidates_ref(seg, w, eid, alive)
    return dense_min_from_candidates(seg, cw, ce, n)


def scatter_min_tables(idx: torch.Tensor, w: torch.Tensor,
                       eid: torch.Tensor, pay1: torch.Tensor,
                       pay2: torch.Tensor, ok: torch.Tensor, size: int, *,
                       use_kernel: bool = True) -> Tables:
    """Fused (w, eid)-lexicographic scatter-min, dispatchable.

    ``use_kernel=True`` goes through the K1 wrapper (the CUDA kernel on
    the card, its plain version on CPU tensors); ``use_kernel=False``
    always runs the plain version — the comparator the kernel is held
    against.  The reference's ``use_pallas`` flag, renamed.
    """
    if use_kernel:
        return owner_scatter_min(idx, w, eid, pay1, pay2, ok, size)
    return owner_scatter_min_ref(idx, w, eid, pay1, pay2, ok, size)
