"""Device resolution for the port's entry points: the card by default,
the CPU only on an explicit request, and no fallback between them."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raise when there is none.

    A caller that wants the CPU (the tests) passes ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch paths on the "
                "CPU")
        return torch.device("cuda")
    return torch.device(device)
