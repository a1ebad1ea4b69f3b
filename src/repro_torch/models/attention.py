"""GQA self-attention with RoPE, optional qk-norm and sliding windows, and
dense or ring KV caches.

Two entry modes:
  * full-sequence prefill — the ``flash_prefill`` kernel (its plain
    version on a CPU tensor) over positions 0..S-1, causal, with the
    layer's window;
  * decode — one query token per sequence against the cache, through
    ``_attend``.

KV caches of sliding-window layers are rings of ``min(window, cache_len)``
slots (slot = position % size), as in the reference: gemma3's local layers
keep 1024 tokens whatever the context.

``_attend`` rounds as the reference does at every step: fp32 scores,
``NEG_INF`` masking, fp32 softmax, and the weights cast to ``v``'s dtype
before the PV product. These are plain products outside any kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.flash_prefill.ops import flash_prefill
from .config import LayerSpec, ModelConfig
from .layers import apply_rope, dense_init, rmsnorm

Params = Dict[str, Any]

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, device=None) -> Params:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, H, Dh), device=device),
        "wk": dense_init(gen, (d, Hkv, Dh), device=device),
        "wv": dense_init(gen, (d, Hkv, Dh), device=device),
        "wo": dense_init(gen, (H, Dh, d), device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((Dh,), dtype=torch.bfloat16, device=device)
        p["k_norm"] = torch.ones((Dh,), dtype=torch.bfloat16, device=device)
    return p


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
def _project_q(x, p, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(x, p, cfg: ModelConfig):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _rope_qk(q, k, positions, cfg: ModelConfig, spec: LayerSpec):
    if cfg.rope_kind != "rope":
        raise NotImplementedError(f"rope kind {cfg.rope_kind!r} is not ported")
    return (apply_rope(q, positions, spec.rope_theta),
            apply_rope(k, positions, spec.rope_theta))


# ---------------------------------------------------------------------------
# core attention math for decode (GQA)
# ---------------------------------------------------------------------------
def _attend(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0,
            kv_valid: Optional[torch.Tensor] = None):
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D); *_pos: (B,S*). A key is visible
    when ``q_pos >= kv_pos`` (causal), ``q_pos - kv_pos < window`` (when
    ``window``) and ``kv_valid``.

    Scores materialize as (B, Hkv, qpk, Sq, Skv) fp32; decode has Sq = 1.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqgpd,bkgd->bgpqk", qg.float(), k.float()) * (1.0 / math.sqrt(Dh))
    mask = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m = q_pos[:, :, None] >= kv_pos[:, None, :]           # (B, Sq, Skv)
        if window:
            m = m & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
        mask = mask & m[:, None, None]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bgpqk,bkgd->bqgpd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dh)


# ---------------------------------------------------------------------------
# public modes
# ---------------------------------------------------------------------------
def attention_full(x, p, cfg: ModelConfig, spec: LayerSpec, positions,
                   want_cache: bool = False, cache_len: int = 0):
    """Prefill over the full sequence at positions 0..S-1 (what the
    kernel assumes; ``positions`` feeds RoPE and the cache). With
    ``want_cache`` also returns the KV cache sized ``cache_len`` (>= S
    for decode continuation; a ring of the last tokens for a windowed
    layer)."""
    q = _project_q(x, p, cfg)
    k, v = _project_kv(x, p, cfg)
    q, k = _rope_qk(q, k, positions, cfg, spec)
    out = flash_prefill(q, k, v, window=spec.sliding_window,
                        softcap=cfg.attn_logit_softcap)
    cache = (_build_cache(k, v, positions, spec.sliding_window, cache_len)
             if want_cache else None)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def _cache_size(window: int, cache_len: int) -> int:
    return min(window, cache_len) if window else cache_len


def _build_cache(k, v, pos, window: int, cache_len: int):
    """Prefill→decode cache. A windowed layer keeps a ring of the last
    ``min(window, cache_len)`` tokens at slot ``pos % size``; a global
    layer keeps every token up to ``cache_len``. Unwritten slots carry
    position -1."""
    B, S = k.shape[0], k.shape[1]
    size = _cache_size(window, cache_len)
    ck = torch.zeros((B, size) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    cv = torch.zeros_like(ck)
    cpos = torch.full((B, size), -1, dtype=torch.int32, device=k.device)
    if window and S > size:
        k, v, pos = k[:, -size:], v[:, -size:], pos[:, -size:]
    slots = (pos % size if window else pos).long()
    bidx = torch.arange(B, device=k.device)[:, None]
    ck[bidx, slots] = k
    cv[bidx, slots] = v
    cpos[bidx, slots] = pos.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


def attention_decode(x, p, cfg: ModelConfig, spec: LayerSpec, cache: Params,
                     pos):
    """One-token decode. x: (B, 1, D); pos: (B,) current positions.

    Writes this token's K/V into ``cache`` in place (slot ``pos % size``
    in a windowed layer's ring; the returned cache is the same tensors)
    and attends over the valid slots, within the window. ``pos`` must lie
    inside a global layer's cache; ``apply_stack_decode`` checks that
    before any layer writes.
    """
    B = x.shape[0]
    q = _project_q(x, p, cfg)
    k_new, v_new = _project_kv(x, p, cfg)
    pos2 = pos[:, None]
    q, k_new = _rope_qk(q, k_new, pos2, cfg, spec)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    bidx = torch.arange(B, device=x.device)
    slot = (pos % ck.shape[1] if spec.sliding_window else pos).long()
    ck[bidx, slot] = k_new[:, 0].to(ck.dtype)
    cv[bidx, slot] = v_new[:, 0].to(cv.dtype)
    cpos[bidx, slot] = pos.to(cpos.dtype)

    out = _attend(q, ck, cv, pos2, cpos, causal=True,
                  window=spec.sliding_window, kv_valid=cpos >= 0)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def empty_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                cache_len: int, dtype=torch.bfloat16, device=None) -> Params:
    size = _cache_size(spec.sliding_window, cache_len)
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
    }
