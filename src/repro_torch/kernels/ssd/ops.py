"""Chunked SSD scan: the intra-chunk part through the CUDA kernel (or its
plain version), the inter-chunk recurrence and the off-diagonal term in
torch. The counterpart of ``src/repro/kernels/ssd/ops.py``.

The device of ``x`` decides: a CPU tensor takes ``ssd_intra_chunk_ref``
under plain autograd, and so does a ``meta`` tensor (shapes only: the
dry-run's costing, ``launch/dryrun.py``); a CUDA tensor goes through
``SsdIntraChunkFn``,
whose forward launches the kernel (or raises) and whose backward is the
plain-torch gradient of ``grad.py``. There is no backend argument and no
fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .grad import ssd_intra_chunk_vjp
from .kernel import ssd_intra_chunk_cuda
from .ref import ssd_intra_chunk_ref


class SsdIntraChunkFn(torch.autograd.Function):
    """``forward_fn(x, dt, A, Bm, Cm, chunk)`` (the kernel's wrapper on the
    card; the CPU tests pass ``ssd_intra_chunk_ref``) with the gradient of
    ``ssd_intra_chunk_vjp``. The inputs are saved through
    ``save_for_backward``, so under ``torch.utils.checkpoint`` the
    backward reads those of the recomputed forward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int, forward_fn):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return forward_fn(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy, dstates, ddecay):
        grads = ssd_intra_chunk_vjp(*ctx.saved_tensors, ctx.chunk, dy, dstates, ddecay)
        return (*grads, None, None)


def ssd_intra_chunk(x, dt, A, Bm, Cm, chunk: int):
    """The intra-chunk step (``ssd_intra_chunk_ref``'s contract) on the
    device of ``x``: the plain version on the CPU, the kernel through
    ``SsdIntraChunkFn`` on the card."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "meta":    # no data to run a kernel on: the plain version's shapes
        return ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk)
    return SsdIntraChunkFn.apply(x, dt, A, Bm, Cm, chunk, ssd_intra_chunk_cuda)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """x: (B,S,H,P); dt: (B,S,H) fp32; A: (H,) fp32; Bm/Cm: (B,S,G,N), G=1.

    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) fp32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    Bm, Cm = Bm[:, :, 0], Cm[:, :, 0]
    if pad:   # padded steps have dt = 0: decay 1, no input, no effect on the state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    y_diag, states, decay = ssd_intra_chunk(*(t.contiguous() for t in (x, dt, A, Bm, Cm)), Q)

    # inter-chunk state recurrence (tiny: nc steps of (B,H,N,P))
    f32 = torch.float32
    s = (init_state.to(f32) if init_state is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x.device))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * decay[:, c, :, None, None] + states[:, c]

    # off-diagonal contribution: carried state read through C with decay
    cum = torch.cumsum((dt.to(f32) * A.to(f32)).reshape(B, nc, Q, H), dim=2)
    y_off = torch.einsum("bcin,bchnp,bcih->bcihp",
                         Cm.to(f32).reshape(B, nc, Q, N),
                         torch.stack(s_prevs, dim=1), torch.exp(cum))
    y = (y_diag.reshape(B, nc, Q, H, P) + y_off).reshape(B, Sp, H, P)
    return y[:, :S].to(x.dtype), s
