"""Gradient of the SSD intra-chunk step in plain PyTorch: the backward of
``ops.SsdIntraChunkFn``.

The JAX package has no backward kernel: its training differentiates the
masked chunked formulation (``src/repro/models/ssm.py::ssd_chunked`` with
``use_kernel=False``) with ``jax.grad``. This is the counterpart of that
autodiff: PyTorch's autograd over ``ref.ssd_intra_chunk_ref``, recomputed
from the saved inputs. The plain version masks the decay matrix *before*
its exp, so the gradient stays finite where the reference's ``where``
after the exp gives 0·inf = NaN (a chunk's summed decay above ~88,
ROADMAP Queue 3 entry 13).
"""

from __future__ import annotations

import torch

from .ref import ssd_intra_chunk_ref


def ssd_intra_chunk_vjp(x, dt, A, Bm, Cm, chunk: int, dy=None, dstates=None, ddecay=None):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N), as the forward
    took them. dy (B,S,H,P), dstates (B,nc,H,N,P) and ddecay (B,nc,H) are
    the gradients of the forward's three outputs; any may be ``None``.

    Returns (dx, ddt, dA, dBm, dCm) in the inputs' dtypes."""
    inputs = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    with torch.enable_grad():
        outs = ssd_intra_chunk_ref(*inputs, chunk)
    pairs = [(o, g) for o, g in zip(outs, (dy, dstates, ddecay)) if g is not None]
    grads = (torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                 allow_unused=True) if pairs else [None] * len(inputs))
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads))
