"""Launch wrappers for the CUDA page gather/scatter kernels
(``csrc/scope_copy.cu``, which replaces the TPU kernels
``src/repro/kernels/scope_copy/kernel.py::gather_pages_pallas`` and
``::scatter_pages_pallas``).

The kernels copy raw row bytes, so every dtype is copied bitwise.
"""

from __future__ import annotations

import torch

from .. import build


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"scope_copy kernel: {msg}")


def _check(pool, pages) -> None:
    _require(pool.device.type == "cuda",
             f"tensors must be on a CUDA device, got {pool.device}")
    _require(pages.device == pool.device, "pages must be on the pool's device")
    _require(pool.dim() == 2 and pool.is_contiguous(),
             "pool must be a contiguous (P, W) tensor")
    _require(pages.dim() == 1 and pages.dtype == torch.int32
             and pages.is_contiguous(), "pages must be a contiguous (n,) int32")
    _require(pool.shape[0] > 0, "pool must have at least one row")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gather_pages_cuda(pool, pages):
    """pool: (P, W); pages: (n,) int32 → (n, W) rows pool[clip(pages)]."""
    _check(pool, pages)
    P, W = pool.shape
    n = pages.shape[0]
    out = torch.empty((n, W), dtype=pool.dtype, device=pool.device)
    with torch.cuda.device(pool.device):
        code = build.library().gather_pages_launch(
            pool.data_ptr(), out.data_ptr(), pages.data_ptr(), n,
            W * pool.element_size(), P, _stream(pool.device))
    build.check(code, "gather_pages")
    return out


def scatter_pages_cuda(pool, pages, buf):
    """Write buf (n, W) into pool rows clip(pages), in place; returns pool.
    With duplicate ids, which row lands is unspecified."""
    _check(pool, pages)
    P, W = pool.shape
    n = pages.shape[0]
    _require(buf.device == pool.device and buf.dtype == pool.dtype
             and tuple(buf.shape) == (n, W) and buf.is_contiguous(),
             "buf must be a contiguous (n, W) tensor like the pool")
    with torch.cuda.device(pool.device):
        code = build.library().scatter_pages_launch(
            pool.data_ptr(), buf.data_ptr(), pages.data_ptr(), n,
            W * pool.element_size(), P, _stream(pool.device))
    build.check(code, "scatter_pages")
    return pool
