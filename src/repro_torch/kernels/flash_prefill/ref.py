"""Plain PyTorch version of causal prefill attention (GQA, sliding window,
tanh softcap): the port's own copy of
``src/repro/kernels/flash_prefill/ref.py``.

The CPU path of ``ops.flash_prefill`` and what ``chip_smoke.py`` holds
the CUDA kernel against. Queries go in chunks of ``q_chunk`` rows, each
against the keys its rows can see, so scores materialize as at most
(B, Hkv, qpk, q_chunk, S) fp32, as in the reference model's ``_attend``.
"""

from __future__ import annotations

import math

import torch


def flash_prefill_ref(q, k, v, *, window: int = 0, softcap: float = 0.0,
                      q_chunk: int = 1024, return_lse: bool = False):
    """q: (B,S,Hq,D); k,v: (B,S,Hkv,D); positions are 0..S-1.

    Scores in fp32 scaled by 1/sqrt(D), then softcap, then the causal mask
    with the window (q - k < window), masked with -inf; fp32 softmax and
    fp32 P·V. Returns (B,S,Hq,D) in q's dtype; with ``return_lse`` also
    each row's log-sum-exp of those masked scores, (B,Hq,S) fp32 in
    natural-log units (what the kernel's forward saves for its backward).
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qpk = Hq // Hkv
    qg = q.float().reshape(B, S, Hkv, qpk, D)
    kf, vf = k.float(), v.float()
    pos = torch.arange(S, device=q.device)
    out = torch.empty((B, S, Hkv, qpk, D), dtype=torch.float32,
                      device=q.device)
    lse = (torch.empty((B, Hkv, qpk, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    for q0 in range(0, S, q_chunk):
        q1 = min(q0 + q_chunk, S)
        # keys past the chunk's last row or before its first row's window
        # are masked for every row of the chunk
        k0 = max(0, q0 - window + 1) if window else 0
        s = torch.einsum("bqgpd,bkgd->bgpqk", qg[:, q0:q1],
                         kf[:, k0:q1]) / math.sqrt(D)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        mask = qp >= kp
        if window:
            mask &= qp - kp < window
        s = s.masked_fill(~mask, float("-inf"))
        w = torch.softmax(s, dim=-1)
        out[:, q0:q1] = torch.einsum("bgpqk,bkgd->bqgpd", w, vf[:, k0:q1])
        if return_lse:
            lse[..., q0:q1] = torch.logsumexp(s, dim=-1)
    out = out.reshape(B, S, Hq, D).to(q.dtype)
    if return_lse:
        return out, lse.reshape(B, Hq, S)
    return out
