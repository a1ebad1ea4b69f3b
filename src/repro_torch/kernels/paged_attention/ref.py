"""Plain PyTorch version of sandboxed paged decode attention.

The same contract as the CUDA kernel; all math in fp32. The CPU path of
the wrapper, and what ``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import math

import torch

PERM_SEALED = 1  # bit0 — mirrors repro_torch.core.heap.PERM_SEALED


def paged_attention_ref(q, k_pool, v_pool, block_tab, seq_lens, perm_bits,
                        sandbox, bitmap):
    """q: (B, Hq, D); pools: (P, T, Hkv, D); block_tab: (B, MAXP) int32.

    Returns (out (B, Hq, D) in q's dtype, oob (B,) int32).
    """
    B, Hq, D = q.shape
    P, T, Hkv, _ = k_pool.shape
    MAXP = block_tab.shape[1]
    qpk = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    sb_lo, sb_hi, sb_on = sandbox[0], sandbox[1], sandbox[2]
    n_needed = (seq_lens + T - 1) // T                      # (B,)
    page_idx = torch.arange(MAXP, device=dev)[None, :]      # (1, MAXP)
    in_use = page_idx < n_needed[:, None]                   # (B, MAXP)

    clamped = block_tab.clamp(0, P - 1).long()
    in_bounds = (block_tab >= sb_lo) & (block_tab < sb_hi)
    allowed = bitmap[clamped] > 0
    sealed = (perm_bits[clamped] & PERM_SEALED) > 0
    ok = in_bounds & allowed & sealed
    valid_page = in_use & torch.where(sb_on > 0, ok, in_bounds)
    oob = (in_use & ~valid_page).sum(dim=1).to(torch.int32)

    # gather pages: (B, MAXP, T, Hkv, D)
    k = k_pool[clamped].float().reshape(B, MAXP * T, Hkv, D)
    v = v_pool[clamped].float().reshape(B, MAXP * T, Hkv, D)

    tok_pos = page_idx[..., None] * T + torch.arange(T, device=dev)[None, None]
    tok_ok = (tok_pos < seq_lens[:, None, None]) & valid_page[..., None]
    tok_ok = tok_ok.reshape(B, MAXP * T)

    qg = q.float().reshape(B, Hkv, qpk, D)
    s = torch.einsum("bgpd,btgd->bgpt", qg, k) * scale
    s = s.masked_fill(~tok_ok[:, None, None, :], float("-inf"))
    # rows with zero valid tokens → zero output, never NaN
    any_valid = tok_ok.any(dim=-1)[:, None, None, None]
    w = torch.softmax(s, dim=-1)
    w = torch.where(any_valid, w, torch.zeros_like(w))
    out = torch.einsum("bgpt,btgd->bgpd", w, v).reshape(B, Hq, D)
    return out.to(q.dtype), oob
