"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device:
``None`` resolves to ``cuda`` and raises when CUDA is absent. Nothing
falls back to the CPU on its own; tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raising if CUDA is absent); otherwise the
    named device, checked for availability."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "explicitly to run the plain PyTorch path")
    return dev

