"""Gradient of causal prefill attention (GQA, sliding window, tanh
softcap) in plain PyTorch: the backward of ``ops.FlashPrefillFn`` on the
CPU, and the plain version of its backward kernel on the card.

The JAX package has no backward kernel: its training differentiates the
plain attention of ``src/repro/models/attention.py::_attend`` with
``jax.grad``. This is the counterpart of that autodiff, written as the
explicit softmax gradient. Queries go in chunks of ``q_chunk`` rows as in
``ref.py``; each chunk recomputes its fp32 scores from the saved q and k,
so no (S, S) matrix outlives its chunk.

With s the scaled scores, c the softcap, P the softmax of the capped and
masked scores and O = P·V:

    dV  = Pᵀ·dO
    dP  = dO·Vᵀ
    dS  = P ⊙ (dP − rowsum(dO ⊙ O))   (the rowsum from the forward output)
    dS *= 1 − tanh²(s / c)             (the softcap's chain; none without it)
    dQ  = dS·K / √D,   dK = dSᵀ·Q / √D

dK and dV sum over each KV head's group of query heads. Everything runs
in fp32 and the grads come back in the inputs' dtype.

P is the softmax of the chunk's scores, or, given the forward's row
log-sum-exp ``lse``, exp(scores − lse): the formulation of the backward
kernel (``csrc/flash_prefill_bwd.cu``, launched by ``kernel.py``'s
``flash_prefill_bwd_cuda``).
"""

from __future__ import annotations

import math

import torch


def flash_prefill_vjp(q, k, v, out, dout, window: int = 0, softcap: float = 0.0,
                      q_chunk: int = 1024, lse=None):
    """q: (B,S,Hq,D); k, v: (B,S,Hkv,D); out: the forward's (B,S,Hq,D);
    dout: the gradient of ``out``. Positions 0..S-1, causal, with the
    ``window`` (0: none) and ``softcap`` (0: none) of the forward;
    ``lse``: None, or the forward's (B,Hq,S) fp32 row log-sum-exp.

    Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qpk = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qg = q.to(f32).reshape(B, S, Hkv, qpk, D)
    og = out.to(f32).reshape(B, S, Hkv, qpk, D)
    dog = dout.to(f32).reshape(B, S, Hkv, qpk, D)
    kf, vf = k.to(f32), v.to(f32)
    pos = torch.arange(S, device=q.device)
    if lse is not None:
        lse = lse.to(f32).reshape(B, Hkv, qpk, S)
    dq = torch.empty((B, S, Hkv, qpk, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, S, Hkv, D), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, S, q_chunk):
        q1 = min(q0 + q_chunk, S)
        k0 = max(0, q0 - window + 1) if window else 0
        qc, doc = qg[:, q0:q1], dog[:, q0:q1]
        kc, vc = kf[:, k0:q1], vf[:, k0:q1]
        s = torch.einsum("bqgpd,bkgd->bgpqk", qc, kc) * scale
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        mask = qp >= kp
        if window:
            mask &= qp - kp < window
        s = s.masked_fill(~mask, float("-inf"))
        p = (torch.softmax(s, dim=-1) if lse is None
             else torch.exp(s - lse[..., q0:q1, None]))
        dv[:, k0:q1] += torch.einsum("bgpqk,bqgpd->bkgd", p, doc)
        dp = torch.einsum("bqgpd,bkgd->bgpqk", doc, vc)
        rows = torch.einsum("bqgpd,bqgpd->bgpq", doc, og[:, q0:q1])
        ds = p * (dp - rows[..., None])
        if softcap:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[:, q0:q1] = torch.einsum("bgpqk,bkgd->bqgpd", ds, kc)
        dk[:, k0:q1] += torch.einsum("bgpqk,bqgpd->bkgd", ds, qc)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
