"""Convert the reference package's parameter trees (numpy arrays) to torch.

``torch.from_numpy`` rejects ml_dtypes' bfloat16, so bf16 leaves travel
as their raw 16-bit words and are reinterpreted on the torch side —
bitwise identical, no rounding.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def array_from_numpy(a, device: DeviceLike = None) -> torch.Tensor:
    """One numpy array → tensor on ``device`` (bf16 detected by name)."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:   # jax hands out read-only buffers
        a = a.copy()
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None):
    """Nested dict of numpy arrays → nested dict of tensors on ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else array_from_numpy(v, device) for k, v in tree.items()}
