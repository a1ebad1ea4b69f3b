"""Launch wrappers for the CUDA flash-prefill kernel
(``csrc/flash_prefill.cu``, which replaces the TPU kernel
``src/repro/kernels/flash_prefill/kernel.py::flash_prefill_pallas``) and
its backward (``csrc/flash_prefill_bwd.cu``, which replaces no TPU
kernel: the reference differentiates its attention with ``jax.grad``).
bf16 runs on the tensor cores (forward: ``wgmma`` with ``cp.async`` K/V
copies; backward: ``mma.sync``), fp32 on the CUDA cores; all accumulate
in fp32.

Each checks device, dtype, shape, contiguity and alignment, allocates
its outputs, and launches on the current stream. Nothing here runs a
plain PyTorch version: a tensor a kernel does not take is an error. The
forward's output has no ``grad_fn``, so with grad mode on it refuses
inputs that require grad: the differentiable path is
``ops.FlashPrefillFn``, whose backward calls ``flash_prefill_bwd_cuda``.
``flash_prefill_cuda.launches`` and ``flash_prefill_bwd_cuda.launches``
count calls; a backward call is two kernel launches (dq with Δ, then dk
and dv).
"""

from __future__ import annotations

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)   # the kernel's instantiations


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_prefill kernel: {msg}")


def flash_prefill_cuda(q, k, v, window: int = 0, softcap: float = 0.0,
                       return_lse: bool = False):
    """q: (B,S,Hq,D); k, v: (B,S,Hkv,D), fp32 or bf16, positions 0..S-1.
    Causal, with an optional sliding ``window`` (0: none) and tanh
    ``softcap`` (0: none). Returns (B,S,Hq,D) in q's dtype; with
    ``return_lse`` also each row's log-sum-exp, (B,Hq,S) fp32 (natural
    log), which the backward takes."""
    tensors = (q, k, v)
    dev = q.device
    _require(not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)),
             "inputs require grad and its output would have none: call it through "
             "ops.flash_prefill (FlashPrefillFn)")
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(all(t.device == dev for t in tensors), "all tensors must be on one device")
    _require(all(t.is_contiguous() for t in tensors), "all tensors must be contiguous")
    _require(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share a dtype")
    _require(q.dim() == 4 and k.dim() == 4, "q, k and v must be (B, S, H, D)")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _require(tuple(k.shape) == (B, S, Hkv, D) and v.shape == k.shape,
             "k and v must be (B, S, Hkv, D) with q's B, S and D")
    _require(Hkv > 0 and Hq % Hkv == 0, "Hq must be a multiple of Hkv")
    _require(D in HEAD_DIMS, f"head_dim must be one of {HEAD_DIMS}")
    _require(window >= 0 and softcap >= 0, "window and softcap must be >= 0")
    _require(all(t.data_ptr() % 16 == 0 for t in tensors),
             "q, k and v must be 16-byte aligned (16-byte copies)")

    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev) if return_lse else None
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, S, Hq, Hkv, D,
            int(window), _DTYPES[q.dtype], float(softcap),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "flash_prefill")
    flash_prefill_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_prefill_cuda.launches = 0


def flash_prefill_bwd_cuda(q, k, v, out, dout, lse, window: int = 0, softcap: float = 0.0):
    """The gradient of ``flash_prefill_cuda``'s output: q (B,S,Hq,D), k
    and v (B,S,Hkv,D), the forward's out, its gradient dout (B,S,Hq,D) and
    its lse (B,Hq,S) fp32, with the forward's ``window`` and ``softcap``.
    Returns (dq, dk, dv) in the inputs' dtype. Deterministic: two calls on
    the same inputs give bitwise equal grads."""
    tensors = (q, k, v, out, dout, lse)
    _require(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _require(all(t.dtype == q.dtype for t in (k, v, out, dout)),
             "q, k, v, out and dout must share a dtype")
    _require(lse.dtype == torch.float32, "lse must be float32")
    _require(q.dim() == 4 and k.dim() == 4, "q, k and v must be (B, S, H, D)")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _require(tuple(k.shape) == (B, S, Hkv, D) and v.shape == k.shape,
             "k and v must be (B, S, Hkv, D) with q's B, S and D")
    _require(out.shape == q.shape and dout.shape == q.shape, "out and dout must be q's shape")
    _require(tuple(lse.shape) == (B, Hq, S), "lse must be (B, Hq, S)")
    _require(Hkv > 0 and Hq % Hkv == 0, "Hq must be a multiple of Hkv")
    _require(D in HEAD_DIMS, f"head_dim must be one of {HEAD_DIMS}")
    _require(window >= 0 and softcap >= 0, "window and softcap must be >= 0")
    _require(all(t.is_contiguous() for t in tensors), "all tensors must be contiguous")
    dev = q.device
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(all(t.device == dev for t in tensors), "all tensors must be on one device")
    _require(all(t.data_ptr() % 16 == 0 for t in tensors),
             "all tensors must be 16-byte aligned (16-byte copies)")

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)   # rowsum(dO ∘ O)
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.flash_prefill_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            B, S, Hq, Hkv, D, int(window), _DTYPES[q.dtype], float(softcap),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "flash_prefill_bwd")
    flash_prefill_bwd_cuda.launches += 1
    return dq, dk, dv


flash_prefill_bwd_cuda.launches = 0
