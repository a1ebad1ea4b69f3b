"""Plain PyTorch versions of the Mamba-2 SSD scan (arXiv:2405.21060 §6).

- ``ssd_intra_chunk_ref``: what the CUDA kernel computes (the intra-chunk
  dual form, each chunk's end state and decay). The CPU path of
  ``ops.ssd_chunked`` and what ``chip_smoke.py`` holds the kernel against.
- ``ssd_chunked_ref``: the whole chunked formulation in one function, the
  port's own copy of ``src/repro/models/ssm.py:110-165``.
- ``ssd_sequential_ref``: the token-by-token recurrence, the ground truth.

All math in fp32. The decay matrix ``L[i, j] = exp(cum_i - cum_j)`` is
masked *before* the exp: above the diagonal ``cum_i - cum_j`` is positive
and, once a chunk's summed decay passes ~88, ``exp`` overflows to inf.
The TPU kernel (``src/repro/kernels/ssd/kernel.py:48``) multiplies
``exp(li)`` by the triangular mask, so inf·0 gives NaN there; this port
departs from it on purpose and follows the ``where`` form of
``src/repro/models/ssm.py:133``, which stays finite.
"""

from __future__ import annotations

import torch


def _decay_matrix(cum: torch.Tensor) -> torch.Tensor:
    """cum: (..., Q, H) inclusive cumsum of dt·A → L (..., Q, Q, H) with
    L[i, j] = exp(cum_i - cum_j) for j ≤ i and 0 above the diagonal; the
    entries above the diagonal are never exponentiated."""
    Q = cum.shape[-2]
    li = cum[..., :, None, :] - cum[..., None, :, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(li.masked_fill(~tri[:, :, None], float("-inf")))


def ssd_intra_chunk_ref(x, dt, A, Bm, Cm, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N); S % min(chunk, S) == 0.

    Returns y_diag (B,S,H,P), states (B,nc,H,N,P) and decay (B,nc,H), fp32.
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} must be a multiple of the chunk {Q} (ops pads it)")
    nc = S // Q
    f32 = torch.float32
    xc = x.to(f32).reshape(B, nc, Q, H, P)
    dtc = dt.to(f32).reshape(B, nc, Q, H)
    Bc = Bm.to(f32).reshape(B, nc, Q, N)
    Cc = Cm.to(f32).reshape(B, nc, Q, N)

    cum = torch.cumsum(dtc * A.to(f32), dim=2)             # (B,nc,Q,H)
    L = _decay_matrix(cum)                                  # (B,nc,Q,Q,H)
    xdt = xc * dtc[..., None]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, L, xdt)

    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,H), ≤ 1
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_end, xdt)
    decay = torch.exp(cum[:, :, -1, :])
    return y_diag.reshape(B, S, H, P), states, decay


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """The whole chunked formulation in one function, as
    ``src/repro/models/ssm.py:110-165`` writes it.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,G,N) with G = 1.
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) fp32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = (S + Q - 1) // Q
    pad = nc * Q - S
    f32 = torch.float32
    F = torch.nn.functional
    xc = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(B, nc, Q, H, P)
    dtc = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(B, nc, Q, H)
    Bc = F.pad(Bm.to(f32)[:, :, 0], (0, 0, 0, pad)).reshape(B, nc, Q, N)
    Cc = F.pad(Cm.to(f32)[:, :, 0], (0, 0, 0, pad)).reshape(B, nc, Q, N)

    cum = torch.cumsum(dtc * A.to(f32), dim=2)              # (B,nc,Q,H), ≤ 0
    L = _decay_matrix(cum)
    xdt = xc * dtc[..., None]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, L, xdt)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_end, xdt)

    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    s = (init_state.to(f32) if init_state is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x.device))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", Cc,
                         torch.stack(s_prevs, dim=1), torch.exp(cum))
    y = (y_diag + y_off).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), s


def ssd_sequential_ref(x, dt, A, Bm, Cm, init_state=None):
    """Token-by-token recurrence — the definitionally-correct oracle.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,G,N) with G = 1.
    Returns (y (B,S,H,P) fp32, final_state (B,H,N,P) fp32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    x, dt, A = x.to(f32), dt.to(f32), A.to(f32)
    Bm, Cm = Bm.to(f32)[:, :, 0], Cm.to(f32)[:, :, 0]
    s = (init_state.to(f32) if init_state is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x.device))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])                       # (B,H)
        s = s * dA[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], s))
    return torch.stack(ys, dim=1), s
