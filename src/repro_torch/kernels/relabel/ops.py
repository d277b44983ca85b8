"""Public wrapper for the fused relabel (K2).

Port of ``repro/kernels/relabel/ops.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.relabel.ref import relabel_ref
from repro_torch.kernels.relabel.relabel import relabel


def relabel_edges(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  labels: torch.Tensor, *, use_kernel: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ru, rv, w')``: ``use_kernel=True`` goes through the K2 wrapper
    (the CUDA kernel on the card, its plain version on CPU tensors);
    ``use_kernel=False`` always runs the plain version — the comparator
    the kernel is held against.  The reference's ``use_pallas``."""
    if use_kernel:
        return relabel(u, v, w, labels)
    return relabel_ref(u, v, w, labels)
