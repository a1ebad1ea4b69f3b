"""Causal prefill attention through the CUDA kernel or its plain version.
The counterpart of ``src/repro/kernels/flash_prefill/ops.py``.

The device of ``q`` decides: a CPU tensor takes ``flash_prefill_ref``
under plain autograd; a ``meta`` tensor (shapes only: the dry-run's
costing, ``launch/dryrun.py``) takes it too; a CUDA tensor goes through
``FlashPrefillFn``, whose forward launches the kernel (or raises) and
whose backward launches the backward kernel (or raises). There is no
backend argument and no fallback.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .grad import flash_prefill_vjp
from .kernel import flash_prefill_bwd_cuda, flash_prefill_cuda
from .ref import flash_prefill_ref


class FlashPrefillFn(torch.autograd.Function):
    """``forward_fn(q, k, v, window=, softcap=, return_lse=)`` (the
    kernel's wrapper on the card; the CPU tests pass ``flash_prefill_ref``)
    with the gradient of the backward kernel on CUDA tensors
    (``flash_prefill_bwd_cuda``) and of ``flash_prefill_vjp``, its plain
    version, on CPU tensors. Where an input needs its gradient the forward
    also returns each row's log-sum-exp; q, k, v, the output and it are
    saved through ``save_for_backward``, so under ``torch.utils.checkpoint``
    the backward reads those of the recomputed forward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float, forward_fn):
        ctx.window, ctx.softcap = window, softcap
        if not any(ctx.needs_input_grad[:3]):
            return forward_fn(q, k, v, window=window, softcap=softcap)
        out, lse = forward_fn(q, k, v, window=window, softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grad = flash_prefill_bwd_cuda if q.device.type == "cuda" else flash_prefill_vjp
        dq, dk, dv = grad(q, k, v, out, dout.contiguous(), window=ctx.window,
                          softcap=ctx.softcap, lse=lse)
        return dq, dk, dv, None, None, None


def flash_prefill(q, k, v, window: int = 0, softcap: float = 0.0):
    """q: (B,S,Hq,D); k, v: (B,S,Hkv,D); positions 0..S-1. Causal, with
    an optional sliding ``window`` and tanh ``softcap`` (0: none).
    Returns (B,S,Hq,D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, window=window, softcap=softcap)
    if q.device.type == "meta":    # no data to run a kernel on: the plain version's shapes
        return flash_prefill_ref(q, k, v, window=window, softcap=softcap)
    return FlashPrefillFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                window, softcap, flash_prefill_cuda)
