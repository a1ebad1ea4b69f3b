"""Launch wrapper for the CUDA SSD intra-chunk kernel (``csrc/ssd.cu``,
which replaces the TPU kernel
``src/repro/kernels/ssd/kernel.py::ssd_intra_chunk_pallas``).

Checks device, dtype, shape and contiguity, allocates the outputs, and
launches on the current stream. Nothing here runs a plain PyTorch
version: a tensor the kernel does not take is an error. Its outputs have
no ``grad_fn``, so with grad mode on it refuses inputs that require grad:
the differentiable path is ``ops.SsdIntraChunkFn``.
``ssd_intra_chunk_cuda.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .. import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_Q, MAX_N, MAX_P = 128, 128, 64   # the kernel's thread tiles (csrc/ssd.cu)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_intra_chunk kernel: {msg}")


def ssd_intra_chunk_cuda(x, dt, A, Bm, Cm, chunk: int, lib=None):
    """x: (B,S,H,P); dt: (B,S,H) fp32; A: (H,) fp32; Bm/Cm: (B,S,N) in x's
    dtype (fp32 or bf16). S must be a multiple of Q = min(chunk, S).
    ``lib``: the kernel library to launch from (default: the build of
    ``csrc/``; ``variants.py`` passes its own builds).

    Returns y_diag (B,S,H,P), states (B,nc,H,N,P), decay (B,nc,H), fp32.
    """
    tensors = (x, dt, A, Bm, Cm)
    dev = x.device
    _require(not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)),
             "inputs require grad and its outputs would have none: call it through "
             "ops.ssd_chunked (SsdIntraChunkFn)")
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(all(t.device == dev for t in tensors), "all tensors must be on one device")
    _require(all(t.is_contiguous() for t in tensors), "all tensors must be contiguous")
    _require(x.dtype in _DTYPES, f"unsupported dtype {x.dtype}")
    _require(Bm.dtype == x.dtype and Cm.dtype == x.dtype,
             "x, Bm and Cm must share a dtype")
    _require(dt.dtype == torch.float32 and A.dtype == torch.float32,
             "dt and A must be float32")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    _require(tuple(dt.shape) == (B, S, H) and tuple(A.shape) == (H,),
             "dt must be (B,S,H) and A (H,)")
    _require(tuple(Bm.shape) == (B, S, N) and tuple(Cm.shape) == (B, S, N),
             "Bm and Cm must be (B,S,N)")
    Q = min(chunk, S)
    _require(S % Q == 0, f"S={S} must be a multiple of the chunk {Q} (ops pads it)")
    _require(Q <= MAX_Q and N <= MAX_N and P <= MAX_P,
             f"needs chunk <= {MAX_Q}, state N <= {MAX_N}, head_dim P <= {MAX_P}")
    nc = S // Q

    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((B, S, H, P), **f32)
    states = torch.empty((B, nc, H, N, P), **f32)
    decay = torch.empty((B, nc, H), **f32)
    lib = lib if lib is not None else build.library()
    with torch.cuda.device(dev):
        code = lib.ssd_intra_chunk_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), B, S, H, P, N, Q,
            _DTYPES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "ssd_intra_chunk")
    ssd_intra_chunk_cuda.launches += 1
    return y, states, decay


ssd_intra_chunk_cuda.launches = 0


def bf16_blocks_per_sm(lib=None) -> int:
    """Blocks of the bf16 kernel that share one SM (its shared memory and
    registers, as the CUDA occupancy calculator counts them)."""
    lib = lib if lib is not None else build.library()
    n = lib.ssd_intra_chunk_bf16_blocks_per_sm()
    if n < 0:
        build.check(-n, "ssd_intra_chunk_bf16_blocks_per_sm")
    return n
