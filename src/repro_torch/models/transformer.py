"""Decoder stack: dense self-attention layers (global or sliding-window,
as gemma3's 5:1 local:global super-block) and Mamba-2 SSM layers, mixed
in jamba's 1:7 attention:SSM super-block, each with a dense SwiGLU FFN or
a mixture-of-experts FFN (``moe.py``).

Parameters for each super-block position are stacked over blocks with a
leading layer axis (``stack.pos0.attn.wq`` is ``(L, d, H, Dh)``), as in
the reference; the reference's ``lax.scan`` over that axis becomes a
Python loop over layer slices (views, no copies). A layer has an MLP
only when ``d_ff > 0`` (an SSM layer of mamba2 has none; jamba's have
one); an MoE layer, attention or SSM, has an MoE FFN in its place. A
norm's subtree is empty for OLMo's non-parametric LayerNorm. A windowed
position's cache leaves are rings of ``min(window, cache_len)`` slots.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .attention import attention_decode, attention_full, empty_cache, init_attention
from .config import LayerSpec, ModelConfig
from .layers import apply_norm, init_mlp, init_norm, mlp_apply
from .moe import init_moe, moe_apply
from .ssm import empty_ssm_state, init_ssm, ssm_decode_step, ssm_forward

Params = Dict[str, Any]


def _is_tree(x) -> bool:
    return hasattr(x, "items")


def tree_index(tree, i: int):
    """Slice index ``i`` of the leading axis out of every leaf."""
    return {k: tree_index(v, i) if _is_tree(v) else v[i]
            for k, v in tree.items()}


def _check_ported(spec: LayerSpec) -> None:
    if spec.kind not in ("attn", "ssm") or spec.cross_attn:
        raise NotImplementedError(
            f"layer {spec} is not ported: the port serves self-attention "
            "(global or sliding-window) and SSM layers, each with a dense "
            "or MoE FFN or none, and no cross-attention")


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, device=None) -> Params:
    _check_ported(spec)
    p = {"norm_in": init_norm(cfg.d_model, cfg.norm_kind, device)}
    if spec.kind == "attn":
        p["attn"] = init_attention(gen, cfg, device)
    else:
        p["ssm"] = init_ssm(gen, cfg, device)
    if spec.moe or cfg.d_ff > 0:
        p["norm_mlp"] = init_norm(cfg.d_model, cfg.norm_kind, device)
        if spec.moe:
            p["moe"] = init_moe(gen, cfg, device)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
    return p


def _ffn_residual(x, p, cfg: ModelConfig):
    """x plus the layer's FFN (dense or MoE) of its normed input. Returns
    (x, aux): the MoE layer's load-balancing loss, else ``None``."""
    if "mlp" not in p and "moe" not in p:
        return x, None
    h = apply_norm(x, p.get("norm_mlp"), cfg.norm_kind, cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_apply(h, p["moe"], cfg)
        return x + m, aux
    return x + mlp_apply(h, p["mlp"], cfg.mlp_kind), None


def apply_layer_full(x, p, cfg: ModelConfig, spec: LayerSpec, positions,
                     want_cache: bool = False, cache_len: int = 0,
                     caller_positions: bool = False):
    """Prefill application. Returns (x, aux, cache); ``aux`` is the MoE
    load-balancing loss, ``None`` for a layer without MoE."""
    h = apply_norm(x, p.get("norm_in"), cfg.norm_kind, cfg.norm_eps)
    if spec.kind == "attn":
        a, c = attention_full(h, p["attn"], cfg, spec, positions,
                              want_cache=want_cache, cache_len=cache_len,
                              caller_positions=caller_positions)
        key = "self"
    else:
        a, c = ssm_forward(h, p["ssm"], cfg, want_state=want_cache)
        key = "ssm"
    x, aux = _ffn_residual(x + a, p, cfg)
    return x, aux, ({key: c} if want_cache else {})


def apply_layer_decode(x, p, cfg: ModelConfig, spec: LayerSpec,
                       cache: Params, pos):
    """One-token decode. Returns x; ``cache`` is updated in place (each
    leaf keeps its dtype). The MoE aux loss is dropped."""
    h = apply_norm(x, p.get("norm_in"), cfg.norm_kind, cfg.norm_eps)
    if spec.kind == "attn":
        a, _ = attention_decode(h, p["attn"], cfg, spec, cache["self"], pos)
    else:
        a, new = ssm_decode_step(h, p["ssm"], cfg, cache["ssm"])
        for k, v in new.items():
            cache["ssm"][k].copy_(v)
    return _ffn_residual(x + a, p, cfg)[0]


# ---------------------------------------------------------------------------
# the stacked decoder
# ---------------------------------------------------------------------------
def init_stack(gen, cfg: ModelConfig, device=None) -> Params:
    """Per-layer init written into preallocated stacked leaves, so the
    full-size model never holds two copies of a leaf."""
    out: Params = {}
    nb = cfg.num_blocks
    for i, spec in enumerate(cfg.block_pattern()):
        stacked = None
        for b in range(nb):
            layer = init_layer(gen, cfg, spec, device)
            if stacked is None:
                stacked = _alloc_stacked(layer, nb)
            _copy_into(stacked, layer, b)
        out[f"pos{i}"] = stacked
    return out


def _alloc_stacked(layer, nb: int):
    return {k: _alloc_stacked(v, nb) if _is_tree(v) else
            torch.empty((nb,) + tuple(v.shape), dtype=v.dtype, device=v.device)
            for k, v in layer.items()}


def _copy_into(stacked, layer, b: int) -> None:
    for k, v in layer.items():
        if _is_tree(v):
            _copy_into(stacked[k], v, b)
        else:
            stacked[k][b].copy_(v)


def apply_stack_full(x, stack, cfg: ModelConfig, positions,
                     want_cache: bool = False, cache_len: int = 0,
                     caller_positions: bool = False):
    """Returns (x, aux, cache): ``aux`` the MoE layers' load-balancing
    losses summed (0-d fp32), cache leaves stacked (L, B, cache_len, ...).
    ``positions``: (B, S), or (3, B, S) for M-RoPE; ``caller_positions``
    selects the attention path (``attention_full``)."""
    pattern = cfg.block_pattern()
    per_block: List[Params] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(cfg.num_blocks):
        caches = {}
        for i, spec in enumerate(pattern):
            x, a, c = apply_layer_full(x, tree_index(stack[f"pos{i}"], b), cfg,
                                       spec, positions, want_cache=want_cache,
                                       cache_len=cache_len,
                                       caller_positions=caller_positions)
            if a is not None:
                aux = aux + a
            caches[f"pos{i}"] = c
        per_block.append(caches)
    if not want_cache:
        return x, aux, None
    return x, aux, _stack_trees(per_block)


def _stack_trees(trees: List[Params]) -> Params:
    first = trees[0]
    return {k: _stack_trees([t[k] for t in trees]) if _is_tree(v)
            else torch.stack([t[k] for t in trees])
            for k, v in first.items()}


def apply_stack_decode(x, stack, cfg: ModelConfig, cache: Params, pos):
    """One-token decode through every layer; ``cache`` (stacked leaves)
    is updated in place and returned.

    A position past the end of a global layer's cache raises
    ``ValueError`` before any layer writes, when ``pos`` lies on the host;
    on the card the check would cost a synchronisation, so there the
    caller sizes the cache (``cache_len``)."""
    pattern = cfg.block_pattern()
    dense = [cache[f"pos{i}"]["self"]["k"].shape[2] for i, spec in enumerate(pattern)
             if spec.kind == "attn" and not spec.sliding_window]
    if dense and pos.device.type == "cpu" and pos.numel():
        last, size = int(pos.max()), min(dense)
        if last >= size:
            raise ValueError(
                f"decode position {last} is past the end of the dense KV cache "
                f"({size} slots): prefill with a cache_len above it")
    for b in range(cfg.num_blocks):
        for i, spec in enumerate(pattern):
            x = apply_layer_decode(
                x, tree_index(stack[f"pos{i}"], b), cfg, spec,
                tree_index(cache[f"pos{i}"], b), pos)
    return x, cache


def empty_stack_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      kv_dtype=torch.bfloat16, device=None) -> Params:
    out = {}
    nb = cfg.num_blocks
    for i, spec in enumerate(cfg.block_pattern()):
        _check_ported(spec)
        if spec.kind == "attn":
            key, c = "self", empty_cache(cfg, spec, batch, cache_len,
                                         dtype=kv_dtype, device=device)
        else:
            key, c = "ssm", empty_ssm_state(cfg, batch, device=device)
        out[f"pos{i}"] = {key: {
            k: v[None].repeat((nb,) + (1,) * v.dim()) for k, v in c.items()}}
    return out
