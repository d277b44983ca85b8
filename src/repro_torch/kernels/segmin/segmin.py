"""K1 and K3 wrappers: the MINEDGES kernels, in CUDA.

Ports of ``repro/kernels/segmin/segmin.py``:

* ``owner_scatter_min`` (K1, Pallas body ``_scatter_min_kernel``) — the
  fused scatter-min, ``csrc/owner_scatter_min.cu``;
* ``segmin_candidates`` (K3, Pallas body ``_segmin_kernel``) — the
  block-segmented run-end min, ``csrc/segmin_candidates.cu``.

On a CUDA tensor a wrapper launches its hand-written kernel (built on
first use by ``kernels/_build.py``); on a CPU tensor it runs the plain
PyTorch version of ``ref.py``.  There is no fallback between the two: a
CUDA input that the kernel does not take raises.

Each wrapper's ``launches`` counts its kernel's launches (never the
plain version's calls), so a run can show that it went through the
kernel.  ``owner_scatter_min_list_use`` is K1 with a report of its
payload list, for the card's checks and measurements.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segmin.plan import K1_ENTRY_BYTES, k1_plan, k3_plan
from repro_torch.kernels.segmin.ref import (EID_SENTINEL, Tables,
                                            default_tables,
                                            owner_scatter_min_ref,
                                            segmin_candidates_ref)

__all__ = ["EID_SENTINEL", "ListUse", "owner_scatter_min",
           "owner_scatter_min_list_use", "segmin_candidates"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_K1_ARGS = [_P] * 13 + [_I64] * 8
_K3_ARGS = [_P] * 6 + [_I64] * 5


def owner_scatter_min(idx: torch.Tensor, w: torch.Tensor,
                      eid: torch.Tensor, pay1: torch.Tensor,
                      pay2: torch.Tensor, ok: torch.Tensor,
                      size: int) -> Tables:
    """Fused (w, eid)-lexicographic scatter-min into ``size`` slots.

    Candidates ``idx/w/eid/pay1/pay2/ok`` are ``[..., L]`` (int32, f32,
    int32, int32, int32, bool); every leading index is its own table row
    (the stacked shards), and one launch covers them all.  Returns
    ``(wmin f32, emin i32, pay1 i32, pay2 i32)``, each ``[..., size]``,
    with defaults ``(inf, EID_SENTINEL, -1, -1)`` — the contract of
    ``ref.owner_scatter_min_ref``.  ``ok=False`` lanes never contribute
    and the kernel never reads their ``idx``; an ``ok`` lane with ``idx``
    outside ``[0, size)`` is dropped.  Where ``pay1`` and ``pay2`` are
    one buffer (as the engine passes them) the kernel loads and updates
    it once.  The launch is planned by ``plan.k1_plan``.
    """
    if idx.device.type == "cpu":
        return owner_scatter_min_ref(idx, w, eid, pay1, pay2, ok, size)
    return _owner_scatter_min_launch(idx, w, eid, pay1, pay2, ok, size)[0]


owner_scatter_min.launches = 0


class ListUse(NamedTuple):
    """What one K1 launch put on its list of payload candidates."""
    reserved: int   # entries the warps reserved, 128 at a time
    listed: Optional[int]  # lanes listed; None where the full pass ran
    capacity: int   # entries; 0 (no list) or fewer than reserved: the
    #                 payloads came from the full pass over every lane


def owner_scatter_min_list_use(idx: torch.Tensor, w: torch.Tensor,
                               eid: torch.Tensor, pay1: torch.Tensor,
                               pay2: torch.Tensor, ok: torch.Tensor,
                               size: int
                               ) -> Tuple[Tables, Optional[ListUse]]:
    """``owner_scatter_min``, and what its launch put on the list: for
    checks and measurements (it waits for the card).  ``None`` in place
    of the list's use where no list was made: a CPU input, which runs
    the plain version, or an empty one."""
    if idx.device.type == "cpu":
        return owner_scatter_min_ref(idx, w, eid, pay1, pay2, ok, size), None
    tables, entries, counter, capacity = _owner_scatter_min_launch(
        idx, w, eid, pay1, pay2, ok, size)
    if counter is None:
        return tables, None
    return tables, list_use(entries, int(counter), capacity)


def list_use(entries: torch.Tensor, reserved: int,
             capacity: int) -> ListUse:
    """The use of K1's list from its int32 ``entries`` (``{key lo, key
    hi, slot, lane}`` each) and the count of entries reserved.  Where
    the list held them all, each reserved entry is a listed lane or, in
    the unused rest of a warp's last reservation, has the slot
    ``kNoSlot`` (-1 as int32)."""
    listed = None
    if 0 < capacity and reserved <= capacity:
        slots = entries.view(-1, K1_ENTRY_BYTES // 4)[:reserved, 2]
        listed = int((slots != -1).sum())
    return ListUse(reserved, listed, capacity)


def _owner_scatter_min_launch(idx, w, eid, pay1, pay2, ok, size):
    """K1's launch on CUDA tensors: ``(tables, list entries as int32,
    device counter of entries reserved, capacity)``, the last three
    ``None`` where the input is empty and nothing is launched."""
    if idx.device.type != "cuda":
        raise ValueError(f"owner_scatter_min: no kernel for device "
                         f"{idx.device}")
    _build.check_tensors("owner_scatter_min", {
        "idx": (idx, torch.int32), "w": (w, torch.float32),
        "eid": (eid, torch.int32), "pay1": (pay1, torch.int32),
        "pay2": (pay2, torch.int32), "ok": (ok, torch.bool)}, idx.shape)
    lead = tuple(idx.shape[:-1])
    L = idx.shape[-1]
    rows = math.prod(lead)
    if L == 0 or size == 0 or rows == 0:
        return default_tables(lead, size, idx.device), None, None, None
    shape = lead + (size,)
    dev = idx.device
    wmin = torch.empty(shape, dtype=torch.float32, device=dev)
    emin = torch.empty(shape, dtype=torch.int32, device=dev)
    p1 = torch.empty(shape, dtype=torch.int32, device=dev)
    p2 = torch.empty(shape, dtype=torch.int32, device=dev)
    plan = k1_plan(rows, L, size,
                   [t.data_ptr() for t in (idx, w, eid, ok)],
                   pay1.data_ptr() == pay2.data_ptr(),
                   torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    keys = torch.empty(rows * size, dtype=torch.int64, device=dev)
    entries = torch.empty(max(plan.capacity, 1) * K1_ENTRY_BYTES // 4,
                          dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    _build.launch("owner_scatter_min", _K1_ARGS, dev,
                  idx.data_ptr(), w.data_ptr(), eid.data_ptr(),
                  pay1.data_ptr(), pay2.data_ptr(), ok.data_ptr(),
                  keys.data_ptr(), entries.data_ptr(), counter.data_ptr(),
                  wmin.data_ptr(), emin.data_ptr(), p1.data_ptr(),
                  p2.data_ptr(), rows, L, size, plan.capacity, *plan.grid,
                  int(plan.vec), int(plan.alias))
    owner_scatter_min.launches += 1
    return (wmin, emin, p1, p2), entries, counter, plan.capacity


def segmin_candidates(seg: torch.Tensor, w: torch.Tensor, eid: torch.Tensor,
                      alive: torch.Tensor, *, block: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-segmented run-end ``(w, eid)``-min candidates (phase 1).

    ``seg``/``eid`` int32, ``w`` f32 or bf16 (widened to f32, as the
    reference's kernel does), ``alive`` bool, all ``[M]``.  The array is
    cut into blocks of ``min(block, max(M, 8))`` elements; within a
    block, each contiguous run of equal ``seg`` gives its ``(min w, min
    eid among the w-ties)`` at its last element and ``(inf,
    EID_SENTINEL)`` everywhere else, so a run that a block boundary cuts
    gives one candidate per piece.  Returns ``(cand_w f32 [M], cand_eid
    i32 [M])``: ``ref.segmin_candidates_ref(..., block)``.

    Unlike the reference's kernel, a run is contiguous: where ``seg`` is
    not sorted, the reference's Hillis–Steele guard can also fold in an
    earlier run of the same value in the block.  ``min_edges_dense``
    gives the same dense result either way.
    """
    if block < 1:
        raise ValueError(f"segmin_candidates: block must be >= 1, got "
                         f"{block}")
    m = seg.shape[0]
    block = min(block, max(m, 8))
    if seg.device.type == "cpu":
        return segmin_candidates_ref(seg, w, eid, alive, block)
    if seg.device.type != "cuda":
        raise ValueError(f"segmin_candidates: no kernel for device "
                         f"{seg.device}")
    if w.dtype == torch.bfloat16:
        w = w.float()
    _build.check_tensors("segmin_candidates", {
        "seg": (seg, torch.int32), "w": (w, torch.float32),
        "eid": (eid, torch.int32), "alive": (alive, torch.bool)},
        torch.Size([m]))
    cand_w = torch.empty(m, dtype=torch.float32, device=seg.device)
    cand_e = torch.empty(m, dtype=torch.int32, device=seg.device)
    if m == 0:
        return cand_w, cand_e
    plan = k3_plan(m, block, [t.data_ptr() for t in (seg, w, eid, alive,
                                                      cand_w, cand_e)])
    _build.launch("segmin_candidates", _K3_ARGS, seg.device,
                  seg.data_ptr(), w.data_ptr(), eid.data_ptr(),
                  alive.data_ptr(), cand_w.data_ptr(), cand_e.data_ptr(),
                  m, block, plan.span, plan.ctas, int(plan.vec))
    segmin_candidates.launches += 1
    return cand_w, cand_e


segmin_candidates.launches = 0
