"""Launch wrapper for the CUDA paged-attention kernel
(``csrc/paged_attention.cu``, which replaces the TPU kernel
``src/repro/kernels/paged_attention/kernel.py::paged_attention_pallas``).

Checks device, dtype, shape, contiguity and alignment, allocates the
outputs, and launches on the current stream. Nothing here runs a plain
PyTorch version: a tensor the kernel does not take is an error.
"""

from __future__ import annotations

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)   # bf16: 4 or 8 k-steps of mma.sync; f32: a lane owns D/32 columns
MAX_Q_PER_KV = 8        # query rows per KV head: the m16n8k16 A fragment's 8 live rows


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention_cuda(q, k_pool, v_pool, block_tab, seq_lens, perm_bits,
                         sandbox, bitmap, lib=None):
    """q: (B, Hq, D); pools: (P, T, Hkv, D); block_tab: (B, MAXP) int32;
    seq_lens: (B,) int32; perm_bits/bitmap: (P,) int32; sandbox: (3,)
    int32. Returns (out (B, Hq, D) in q's dtype, oob (B,) int32). ``lib``:
    the kernel library to launch from (default: the build of ``csrc/``;
    ``variants.py`` and ``timeline.py`` pass their own builds)."""
    tensors = (q, k_pool, v_pool, block_tab, seq_lens, perm_bits, sandbox,
               bitmap)
    dev = q.device
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(all(t.device == dev for t in tensors),
             "all tensors must be on one device")
    _require(all(t.is_contiguous() for t in tensors),
             "all tensors must be contiguous")
    _require(q.dtype in _DTYPES, f"unsupported dtype {q.dtype}")
    _require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
             "q and the pools must share a dtype")
    _require(all(t.dtype == torch.int32 for t in tensors[3:]),
             "block_tab, seq_lens, perm_bits, sandbox, bitmap must be int32")
    B, Hq, D = q.shape
    P, T, Hkv, D2 = k_pool.shape
    MAXP = block_tab.shape[1]
    _require(v_pool.shape == k_pool.shape and D2 == D, "pool shape mismatch")
    _require(Hq % Hkv == 0 and Hq // Hkv <= MAX_Q_PER_KV,
             f"Hq/Hkv must be a whole number <= {MAX_Q_PER_KV}")
    _require(tuple(block_tab.shape) == (B, MAXP)
             and tuple(seq_lens.shape) == (B,), "block_tab/seq_lens shape")
    _require(tuple(perm_bits.shape) == (P,) and tuple(bitmap.shape) == (P,)
             and tuple(sandbox.shape) == (3,), "perm_bits/bitmap/sandbox shape")
    _require(D in HEAD_DIMS, f"head_dim must be one of {HEAD_DIMS}")
    _require(all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
             "q and the pools must be 16-byte aligned (vector loads)")

    out = torch.empty_like(q)
    oob = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = lib if lib is not None else build.library()
    with torch.cuda.device(dev):
        code = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tab.data_ptr(), seq_lens.data_ptr(), perm_bits.data_ptr(),
            sandbox.data_ptr(), bitmap.data_ptr(), out.data_ptr(),
            oob.data_ptr(), B, Hq, Hkv, D, P, T, MAXP, _DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "paged_attention")
    return out, oob


def cluster_size(B: int, Hkv: int, lib=None) -> int:
    """Blocks the bf16 kernel splits each (sequence, KV head) pair's pages
    over on the current card, as its launch picks them: up to 8, 1 once
    the B·Hkv pairs alone fill the card (olmo-1b at B=8)."""
    lib = lib if lib is not None else build.library()
    c = lib.paged_attention_cluster_size(B, Hkv)
    if c < 0:
        build.check(-c, "paged_attention_cluster_size")
    return c
