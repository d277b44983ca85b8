"""K2 wrapper: the fused relabel + self-loop kill, as a CUDA kernel.

Port of ``repro/kernels/relabel/relabel.py: relabel`` (Pallas body
``_relabel_kernel``).  On a CUDA tensor the wrapper launches the
hand-written kernel of ``csrc/relabel.cu`` (built on first use by
``kernels/_build.py``); on a CPU tensor it runs the plain PyTorch
version of ``ref.py``.  There is no fallback between the two: a CUDA
input that the kernel does not take raises.

``relabel.launches`` counts kernel launches (never the plain version's
calls), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.relabel.ref import relabel_ref

__all__ = ["relabel"]

_K2_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2


def relabel(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
            labels: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused relabel: ``(labels[u], labels[v], w')`` with ``w' = +inf``
    where both labels are equal or ``w`` is not finite.

    ``u``/``v`` int32 and ``w`` f32, all ``[m]``; ``labels`` int32
    ``[n']``.  Indices follow the reference's gather: negative ones wrap
    once, then everything is clamped into the table, so no index reads
    outside it.  An empty table with ``m > 0`` raises ``ValueError``.
    """
    m = u.shape[0]
    n = labels.shape[0]
    if m and not n:
        raise ValueError(f"relabel: {m} edges but an empty label table")
    if u.device.type == "cpu":
        return relabel_ref(u, v, w, labels)
    if u.device.type != "cuda":
        raise ValueError(f"relabel: no kernel for device {u.device}")
    _build.check_tensors("relabel", {
        "u": (u, torch.int32), "v": (v, torch.int32),
        "w": (w, torch.float32)}, torch.Size([m]))
    _build.check_tensors("relabel", {"labels": (labels, torch.int32)},
                         torch.Size([n]))
    if labels.device != u.device:
        raise ValueError(f"relabel: labels is on {labels.device}, expected "
                         f"{u.device}")
    ru = torch.empty(m, dtype=torch.int32, device=u.device)
    rv = torch.empty(m, dtype=torch.int32, device=u.device)
    wp = torch.empty(m, dtype=torch.float32, device=u.device)
    if m == 0:
        return ru, rv, wp
    _build.launch("relabel", _K2_ARGS, u.device, u.data_ptr(), v.data_ptr(),
                  w.data_ptr(), labels.data_ptr(), ru.data_ptr(),
                  rv.data_ptr(), wp.data_ptr(), m, n)
    relabel.launches += 1
    return ru, rv, wp


relabel.launches = 0
