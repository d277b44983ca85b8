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
kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segmin.ref import (EID_SENTINEL, Tables,
                                            default_tables,
                                            owner_scatter_min_ref,
                                            segmin_candidates_ref)

__all__ = ["EID_SENTINEL", "owner_scatter_min", "segmin_candidates"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_K1_ARGS = [_P] * 11 + [_I64] * 3
_K3_ARGS = [_P] * 6 + [_I64] * 2


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
    outside ``[0, size)`` is dropped.
    """
    if idx.device.type == "cpu":
        return owner_scatter_min_ref(idx, w, eid, pay1, pay2, ok, size)
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
        return default_tables(lead, size, idx.device)
    shape = lead + (size,)
    wmin = torch.empty(shape, dtype=torch.float32, device=idx.device)
    emin = torch.empty(shape, dtype=torch.int32, device=idx.device)
    p1 = torch.empty(shape, dtype=torch.int32, device=idx.device)
    p2 = torch.empty(shape, dtype=torch.int32, device=idx.device)
    keys = torch.empty(rows * size, dtype=torch.int64, device=idx.device)
    _build.launch("owner_scatter_min", _K1_ARGS, idx.device,
                  idx.data_ptr(), w.data_ptr(), eid.data_ptr(),
                  pay1.data_ptr(), pay2.data_ptr(), ok.data_ptr(),
                  keys.data_ptr(), wmin.data_ptr(), emin.data_ptr(),
                  p1.data_ptr(), p2.data_ptr(), rows, L, size)
    owner_scatter_min.launches += 1
    return wmin, emin, p1, p2


owner_scatter_min.launches = 0


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
    _build.launch("segmin_candidates", _K3_ARGS, seg.device,
                  seg.data_ptr(), w.data_ptr(), eid.data_ptr(),
                  alive.data_ptr(), cand_w.data_ptr(), cand_e.data_ptr(),
                  m, block)
    segmin_candidates.launches += 1
    return cand_w, cand_e


segmin_candidates.launches = 0
