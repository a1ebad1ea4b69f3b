"""Dense GQA self-attention with RoPE and a global KV cache.

Two entry modes share one math core (``_attend``):
  * full-sequence prefill — query-chunked so a long prompt never
    materializes an (S, S) score matrix at once;
  * decode — one query token per sequence against the dense cache.

Rounding follows the reference at every step: fp32 scores, ``NEG_INF``
masking, fp32 softmax, and the weights cast to ``v``'s dtype before the
PV product. These are plain products outside any kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .config import LayerSpec, ModelConfig
from .layers import apply_rope, dense_init

Params = Dict[str, Any]

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, device=None) -> Params:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, (d, H, Dh), device=device),
        "wk": dense_init(gen, (d, Hkv, Dh), device=device),
        "wv": dense_init(gen, (d, Hkv, Dh), device=device),
        "wo": dense_init(gen, (H, Dh, d), device=device),
    }


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
def _project_q(x, p, cfg: ModelConfig):
    return torch.einsum("bsd,dhk->bshk", x, p["wq"])


def _project_kv(x, p, cfg: ModelConfig):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return k, v


def _rope_qk(q, k, positions, cfg: ModelConfig, spec: LayerSpec):
    if cfg.rope_kind != "rope":
        raise NotImplementedError(f"rope kind {cfg.rope_kind!r} is not ported")
    return (apply_rope(q, positions, spec.rope_theta),
            apply_rope(k, positions, spec.rope_theta))


# ---------------------------------------------------------------------------
# core attention math (GQA, chunked over queries)
# ---------------------------------------------------------------------------
def _attend(q, k, v, q_pos, kv_pos, *, causal: bool,
            kv_valid: Optional[torch.Tensor] = None, q_chunk: int = 1024):
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D); *_pos: (B,S*).

    Scores materialize per query chunk as (B, Hkv, qpk, Cq, Skv) fp32.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qpk = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, Hkv, qpk, Dh)
    kf = k.float()

    outs = []
    for c0 in range(0, Sq, q_chunk):
        qc, qpc = qg[:, c0:c0 + q_chunk], q_pos[:, c0:c0 + q_chunk]
        s = torch.einsum("bqgpd,bkgd->bgpqk", qc.float(), kf) * scale
        mask = torch.ones((B, 1, 1, qc.shape[1], Skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (qpc[:, :, None] >= kv_pos[:, None, :])[:, None, None]
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bgpqk,bkgd->bqgpd", w.to(v.dtype), v))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, Dh)


# ---------------------------------------------------------------------------
# public modes
# ---------------------------------------------------------------------------
def attention_full(x, p, cfg: ModelConfig, spec: LayerSpec, positions,
                   want_cache: bool = False, cache_len: int = 0):
    """Prefill over the full sequence; with ``want_cache`` also returns
    the KV cache sized ``cache_len`` (>= S for decode continuation)."""
    q = _project_q(x, p, cfg)
    k, v = _project_kv(x, p, cfg)
    q, k = _rope_qk(q, k, positions, cfg, spec)
    out = _attend(q, k, v, positions, positions[:, : k.shape[1]], causal=True)
    cache = _build_cache(k, v, positions, cache_len) if want_cache else None
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def _build_cache(k, v, pos, cache_len: int):
    """Prefill→decode cache for a global layer: every token up to
    ``cache_len``; unwritten slots carry position -1."""
    B, S = k.shape[0], k.shape[1]
    ck = torch.zeros((B, cache_len) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    cv = torch.zeros_like(ck)
    cpos = torch.full((B, cache_len), -1, dtype=torch.int32, device=k.device)
    bidx = torch.arange(B, device=k.device)[:, None]
    slots = pos[:, :S].long()
    ck[bidx, slots] = k
    cv[bidx, slots] = v
    cpos[bidx, slots] = pos[:, :S].to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


def attention_decode(x, p, cfg: ModelConfig, spec: LayerSpec, cache: Params,
                     pos):
    """One-token decode. x: (B, 1, D); pos: (B,) current positions.

    Writes this token's K/V into ``cache`` in place (the returned cache
    is the same tensors) and attends over the valid slots.
    """
    B = x.shape[0]
    q = _project_q(x, p, cfg)
    k_new, v_new = _project_kv(x, p, cfg)
    pos2 = pos[:, None]
    q, k_new = _rope_qk(q, k_new, pos2, cfg, spec)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    bidx = torch.arange(B, device=x.device)
    slot = pos.long()
    ck[bidx, slot] = k_new[:, 0].to(ck.dtype)
    cv[bidx, slot] = v_new[:, 0].to(cv.dtype)
    cpos[bidx, slot] = pos.to(cpos.dtype)

    out = _attend(q, ck, cv, pos2, cpos, causal=True, kv_valid=cpos >= 0)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def empty_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                cache_len: int, dtype=torch.bfloat16, device=None) -> Params:
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }
