"""Paged decode over the RPCool KV pool, for uniform GQA stacks (the
dense and vlm families: yi, olmo, qwen2-vl's backbone).

Prefill reuses the standard stack (``Model.prefill``); decode projects
q/k/v per layer, writes this token's K/V into its page slot, and attends
through the ``paged_attention`` kernel, which dereferences block-table
pointers under the sandbox contract.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.paged_attention.ops import paged_attention
from ..models.attention import _project_kv, _project_q
from ..models.config import ModelConfig
from ..models.layers import apply_norm, apply_rope, embed_tokens, mlp_apply, unembed
from ..models.model import Model, check_ported
from ..models.transformer import tree_index


def check_paged_compatible(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a ported, uniform self-attention stack
    without cross-attention (``NotImplementedError`` for what the port
    does not run at all; ``ValueError`` for MoE, SSM, hybrid and windowed
    stacks, which decode over dense caches instead, as the reference's
    ``PagedLM`` refuses them, and for encoder–decoders, which the
    reference's accepts and then decodes without their cross-attention)."""
    check_ported(cfg)
    pattern = cfg.block_pattern()
    spec = pattern[0]
    if len(pattern) != 1 or spec.kind != "attn" or spec.moe or spec.cross_attn:
        raise ValueError(
            f"{cfg.name}: PagedLM serves uniform dense-attention stacks without "
            "cross-attention; MoE/SSM/hybrid and encoder-decoder archs use the "
            "dense-cache decode path")


def paged_decode_step(cfg: ModelConfig, params, tokens, pos, block_tab,
                      seq_lens, k_pool, v_pool, perm_bits, sandbox, bitmap):
    """One decode step over the pool.

    tokens: (B,) int32; pos: (B,) int32 (position being generated);
    block_tab: (B, MAXP) int32; seq_lens: (B,) valid length AFTER this
    token. k_pool/v_pool: (L, P, T, Hkv, D), updated in place with this
    token's K/V (each layer's write is issued before that layer's kernel
    reads the pool, on the same stream). Returns (logits (B, V) fp32,
    k_pool, v_pool, oob_total (B,) int32).
    """
    spec = cfg.block_pattern()[0]
    P, T = k_pool.shape[1], k_pool.shape[2]
    B = tokens.shape[0]

    x = embed_tokens(tokens[:, None], params["embed"], cfg.embed_scale,
                     cfg.d_model)
    page = torch.gather(block_tab, 1, (pos // T)[:, None].long())[:, 0]
    slot = pos % T
    # a forged page id outside [0, P) is dropped from the write (torch would
    # raise). The reference's scatter drops ids >= P alike but wraps a
    # negative id to P + id and writes that page; the port does not
    keep = torch.nonzero((page >= 0) & (page < P)).squeeze(1)
    w_page, w_slot = page[keep].long(), slot[keep].long()
    oob_total = torch.zeros((B,), dtype=torch.int32, device=tokens.device)

    for l in range(cfg.num_layers):
        lp = tree_index(params["stack"]["pos0"], l)
        h = apply_norm(x, lp.get("norm_in"), cfg.norm_kind, cfg.norm_eps)
        q = _project_q(h, lp["attn"], cfg)              # (B, 1, Hq, D)
        k_new, v_new = _project_kv(h, lp["attn"], cfg)  # (B, 1, Hkv, D)
        # text-only decode: M-RoPE with equal t/h/w streams is RoPE
        q = apply_rope(q, pos[:, None], spec.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], spec.rope_theta)

        # write this token's KV into its page slot (the pool is the heap)
        k_pool[l, w_page, w_slot] = k_new[keep, 0].to(k_pool.dtype)
        v_pool[l, w_page, w_slot] = v_new[keep, 0].to(v_pool.dtype)

        out, oob = paged_attention(
            q[:, 0].contiguous(), k_pool[l], v_pool[l], block_tab, seq_lens,
            perm_bits, sandbox, bitmap)
        oob_total = oob_total + oob
        a = torch.einsum("bhk,hkd->bd", out, lp["attn"]["wo"])[:, None]
        x = x + a
        h = apply_norm(x, lp.get("norm_mlp"), cfg.norm_kind, cfg.norm_eps)
        x = x + mlp_apply(h, lp["mlp"], cfg.mlp_kind)

    x = apply_norm(x, params["norm_f"], cfg.norm_kind, cfg.norm_eps)
    logits = unembed(x, params["embed"])[:, 0].float()
    return logits, k_pool, v_pool, oob_total


def prefill_kv(model: Model, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill through the standard stack; returns (last_logits,
    k (L, B, S, Hkv, D), v). The engine slices [:, b] per request for
    ``PagedKVPool.write_prefill``."""
    logits, cache = model.prefill(tokens, cache_len=tokens.shape[1])
    kv = cache["pos0"]["self"]
    return logits, kv["k"], kv["v"]
