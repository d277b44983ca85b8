"""Plain PyTorch version of the fused relabel + self-loop kill (K2).

Port of ``repro/kernels/relabel/ref.py: relabel_ref``.  It is what
``relabel.relabel`` runs for CPU tensors and what the CUDA kernel is
held against on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def gather_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's gather index into an ``[n]`` table: a negative
    index becomes ``idx + n``, then it is clamped to ``[0, n - 1]``."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)


def relabel_ref(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return ``(ru, rv, w')`` with ``w' = +inf`` for self-loops/padding.

    ``ru = labels[u]``, ``rv = labels[v]`` (indices as ``gather_rows``
    makes them); an edge whose endpoints fell into one component, or
    whose weight is not finite, gets ``+inf`` — with static shapes the
    paper's RELABEL neutralises such edges instead of dropping them.
    """
    n = labels.shape[0]
    ru = labels[gather_rows(u, n)]
    rv = labels[gather_rows(v, n)]
    dead = (ru == rv) | ~torch.isfinite(w)
    return ru, rv, torch.where(dead, float("inf"), w)
