"""K1 wrapper: the fused MINEDGES scatter-min, as a CUDA kernel.

Port of ``repro/kernels/segmin/segmin.py: owner_scatter_min`` (Pallas
body ``_scatter_min_kernel``).  On a CUDA tensor the wrapper launches
the hand-written kernel of ``csrc/owner_scatter_min.cu`` (built on first
use by ``kernels/_build.py``); on a CPU tensor it runs the plain PyTorch
version of ``ref.py``.  There is no fallback between the two: a CUDA
input that the kernel does not take raises.

``owner_scatter_min.launches`` counts kernel launches (never the plain
version's calls), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segmin.ref import (EID_SENTINEL, Tables,
                                            default_tables,
                                            owner_scatter_min_ref)

__all__ = ["EID_SENTINEL", "owner_scatter_min"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _launcher():
    fn = _build.load("owner_scatter_min").owner_scatter_min_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 11 + [_I64, _I64, _I64, _P]
        fn.restype = ctypes.c_int
    return fn


def _check(idx, w, eid, pay1, pay2, ok):
    want = {"idx": (idx, torch.int32), "w": (w, torch.float32),
            "eid": (eid, torch.int32), "pay1": (pay1, torch.int32),
            "pay2": (pay2, torch.int32), "ok": (ok, torch.bool)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"owner_scatter_min: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if t.shape != idx.shape:
            raise ValueError(f"owner_scatter_min: {name} has shape "
                             f"{tuple(t.shape)}, idx {tuple(idx.shape)}")
        if t.device != idx.device:
            raise ValueError(f"owner_scatter_min: {name} is on {t.device}, "
                             f"idx on {idx.device}")
        if not t.is_contiguous():
            raise ValueError(f"owner_scatter_min: {name} must be "
                             "contiguous")


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
    _check(idx, w, eid, pay1, pay2, ok)
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
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(idx.data_ptr(), w.data_ptr(), eid.data_ptr(),
                          pay1.data_ptr(), pay2.data_ptr(), ok.data_ptr(),
                          keys.data_ptr(), wmin.data_ptr(), emin.data_ptr(),
                          p1.data_ptr(), p2.data_ptr(), rows, L, size,
                          stream)
    if err != 0:
        raise RuntimeError(f"owner_scatter_min: kernel launch failed with "
                           f"cudaError_t {err}")
    owner_scatter_min.launches += 1
    return wmin, emin, p1, p2


owner_scatter_min.launches = 0
