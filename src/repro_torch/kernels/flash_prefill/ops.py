"""Causal prefill attention through the CUDA kernel or its plain version.
The counterpart of ``src/repro/kernels/flash_prefill/ops.py``.

The device of ``q`` decides: a CPU tensor takes ``flash_prefill_ref``; a
CUDA tensor launches the kernel or raises. There is no backend argument
and no fallback.
"""

from __future__ import annotations

from .kernel import flash_prefill_cuda
from .ref import flash_prefill_ref


def flash_prefill(q, k, v, window: int = 0, softcap: float = 0.0):
    """q: (B,S,Hq,D); k, v: (B,S,Hkv,D); positions 0..S-1. Causal, with
    an optional sliding ``window`` and tanh ``softcap`` (0: none).
    Returns (B,S,Hq,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, window=window, softcap=softcap)
    return flash_prefill_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              window=window, softcap=softcap)
