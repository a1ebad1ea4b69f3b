"""Launch wrapper for the CUDA flash-prefill kernel
(``csrc/flash_prefill.cu``, which replaces the TPU kernel
``src/repro/kernels/flash_prefill/kernel.py::flash_prefill_pallas``).
bf16 runs on the tensor cores (``wgmma`` with ``cp.async`` K/V
copies), fp32 on the CUDA cores; both accumulate in fp32.

Checks device, dtype, shape, contiguity and alignment, allocates the
output, and launches on the current stream. Nothing here runs a plain
PyTorch version: a tensor the kernel does not take is an error. Its
output has no ``grad_fn``, so with grad mode on it refuses inputs that
require grad: the differentiable path is ``ops.FlashPrefillFn``.
``flash_prefill_cuda.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)   # the kernel's instantiations


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_prefill kernel: {msg}")


def flash_prefill_cuda(q, k, v, window: int = 0, softcap: float = 0.0):
    """q: (B,S,Hq,D); k, v: (B,S,Hkv,D), fp32 or bf16, positions 0..S-1.
    Causal, with an optional sliding ``window`` (0: none) and tanh
    ``softcap`` (0: none). Returns (B,S,Hq,D) in q's dtype."""
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
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D,
            int(window), _DTYPES[q.dtype], float(softcap),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0
