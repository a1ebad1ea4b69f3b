"""Decoder stack: dense self-attention layers (global or sliding-window,
as gemma3's 5:1 local:global super-block; with a cross-attention over
encoder memory in whisper's decoder) and Mamba-2 SSM layers, mixed in
jamba's 1:7 attention:SSM super-block, each with a dense FFN (SwiGLU or
GELU) or a mixture-of-experts FFN (``moe.py``); and whisper's encoder.

Parameters for each super-block position are stacked over blocks with a
leading layer axis (``stack.pos0.attn.wq`` is ``(L, d, H, Dh)``), as in
the reference; the reference's ``lax.scan`` over that axis becomes a
Python loop over layer slices (views, no copies). The full-sequence
stack takes them with one ``unbind(0)`` a stacked leaf, whose backward
stacks the blocks' gradients once (indexing each block would write a
full-size gradient per block), and recomputes each super-block in the
backward under ``remat`` (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does. A layer has an MLP
only when ``d_ff > 0`` (an SSM layer of mamba2 has none; jamba's have
one); an MoE layer, attention or SSM, has an MoE FFN in its place. A
norm's subtree is empty for OLMo's non-parametric LayerNorm. A windowed
position's cache leaves are rings of ``min(window, cache_len)`` slots.
A cross-attention layer's cache also holds the encoder memory's K and V
(``cross``), written by the prefill and only read by decode.

The encoder (``encode``) is whisper's: sinusoidal positions added to the
stub frontend's frames, then ``encoder_layers`` bidirectional blocks
stacked under ``encoder.blocks`` and a final ``encoder.norm_out``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..sharding import rules_context, shard
from .attention import (ATTENTION_AXES, attention_decode, attention_full, empty_cache,
                        init_attention)
from .config import LayerSpec, ModelConfig
from .layers import MLP_AXES, NORM_AXES, apply_norm, init_mlp, init_norm, mlp_apply
from .moe import MOE_AXES, init_moe, moe_apply
from .ssm import SSM_AXES, empty_ssm_state, init_ssm, ssm_decode_step, ssm_forward

Params = Dict[str, Any]


def _is_tree(x) -> bool:
    return hasattr(x, "items")


def tree_index(tree, i: int):
    """Slice index ``i`` of the leading axis out of every leaf."""
    return {k: tree_index(v, i) if _is_tree(v) else v[i]
            for k, v in tree.items()}


def tree_unbind(tree, n: int) -> List[Params]:
    """The ``n`` slices of the leading axis of every leaf, one ``unbind``
    a leaf: a list of ``n`` trees."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = tree_unbind(v, n) if _is_tree(v) else v.unbind(0)
        for b in range(n):
            out[b][k] = parts[b]
    return out


# ---------------------------------------------------------------------------
# axes trees (leaves are tuples of logical axis names, repro_torch.sharding)
# ---------------------------------------------------------------------------
def is_axes_leaf(x) -> bool:
    return x is None or (
        isinstance(x, tuple)
        and all(e is None or isinstance(e, str) for e in x)
    )


def axes_map(fn, tree, *rest):
    """``fn(axes, *leaves)`` over the axes leaves of a nested-dict axes
    tree and the matching leaves of trees of its structure."""
    if is_axes_leaf(tree):
        return fn(tree, *rest)
    return {k: axes_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}


def stack_layer_axes(ax_tree):
    """Prepend the 'layer' axis to every leaf (stacked over super-blocks)."""
    return axes_map(lambda a: ("layer",) + tuple(a or ()), ax_tree)


# the axes table of each subtree of a layer's parameters, by its key
_LAYER_AXES = {"norm_in": NORM_AXES, "norm_cross": NORM_AXES, "norm_mlp": NORM_AXES,
               "attn": ATTENTION_AXES, "cross": ATTENTION_AXES, "ssm": SSM_AXES,
               "moe": MOE_AXES, "mlp": MLP_AXES}


def layer_axes(layer: Params) -> Params:
    """The axes tree of one layer's parameter tree (built by
    ``init_layer``; stacked or not), leaf for leaf, unstacked."""
    return {k: {name: _LAYER_AXES[k][name] for name in sub} for k, sub in layer.items()}


def _check_ported(spec: LayerSpec) -> None:
    if spec.kind not in ("attn", "ssm"):
        raise NotImplementedError(
            f"layer {spec} is not ported: the port serves attention layers "
            "(global or sliding-window, optionally with cross-attention) and "
            "SSM layers, each with a dense or MoE FFN or none")


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, device=None) -> Params:
    """An SSM layer ignores ``spec.cross_attn``, as the reference's does."""
    _check_ported(spec)
    p = {"norm_in": init_norm(cfg.d_model, cfg.norm_kind, device)}
    if spec.kind == "attn":
        p["attn"] = init_attention(gen, cfg, device)
        if spec.cross_attn:
            p["norm_cross"] = init_norm(cfg.d_model, cfg.norm_kind, device)
            p["cross"] = init_attention(gen, cfg, device)
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
                     caller_positions: bool = False, memory=None):
    """Prefill application. Returns (x, aux, cache); ``aux`` is the MoE
    load-balancing loss, ``None`` for a layer without MoE. A
    cross-attention layer given ``memory`` (the encoder's output) adds
    its cross residual between the attention and the FFN and caches the
    memory's K and V under ``cross``."""
    h = apply_norm(x, p.get("norm_in"), cfg.norm_kind, cfg.norm_eps)
    cache = {}
    if spec.kind == "attn":
        a, cache["self"] = attention_full(h, p["attn"], cfg, spec, positions,
                                          want_cache=want_cache, cache_len=cache_len,
                                          caller_positions=caller_positions)
    else:
        a, cache["ssm"] = ssm_forward(h, p["ssm"], cfg, want_state=want_cache)
    x = x + a
    if "cross" in p and memory is not None:
        h = apply_norm(x, p.get("norm_cross"), cfg.norm_kind, cfg.norm_eps)
        a, cache["cross"] = attention_full(h, p["cross"], cfg, spec, positions,
                                           want_cache=want_cache, memory=memory)
        x = x + a
    x, aux = _ffn_residual(x, p, cfg)
    x = shard(x, ("batch", "seq", "embed"))
    return x, aux, (cache if want_cache else {})


def apply_layer_decode(x, p, cfg: ModelConfig, spec: LayerSpec,
                       cache: Params, pos):
    """One-token decode. Returns x; ``cache`` is updated in place (each
    leaf keeps its dtype). The MoE aux loss is dropped. A cross-attention
    layer whose cache holds ``cross`` attends over it and never writes it."""
    h = apply_norm(x, p.get("norm_in"), cfg.norm_kind, cfg.norm_eps)
    if spec.kind == "attn":
        a, _ = attention_decode(h, p["attn"], cfg, spec, cache["self"], pos)
    else:
        a, new = ssm_decode_step(h, p["ssm"], cfg, cache["ssm"])
        for k, v in new.items():
            cache["ssm"][k].copy_(v)
    x = x + a
    if spec.cross_attn and "cross" in cache:
        h = apply_norm(x, p.get("norm_cross"), cfg.norm_kind, cfg.norm_eps)
        a, _ = attention_decode(h, p["cross"], cfg, spec, None, pos,
                                memory_cache=cache["cross"])
        x = x + a
    return _ffn_residual(x, p, cfg)[0]


# ---------------------------------------------------------------------------
# the stacked decoder
# ---------------------------------------------------------------------------
def init_stack(gen, cfg: ModelConfig, device=None) -> Params:
    """Per-layer init written into preallocated stacked leaves, so the
    full-size model never holds two copies of a leaf."""
    return {f"pos{i}": _init_stacked(gen, cfg, spec, cfg.num_blocks, device)
            for i, spec in enumerate(cfg.block_pattern())}


def _init_stacked(gen, cfg: ModelConfig, spec: LayerSpec, n: int, device):
    stacked = None
    for b in range(n):
        layer = init_layer(gen, cfg, spec, device)
        if stacked is None:
            stacked = _alloc_stacked(layer, n)
        _copy_into(stacked, layer, b)
    return stacked


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


# the matmul outputs ``remat="dots"`` keeps: products without batch dims,
# as the reference's ``dots_with_no_batch_dims_saveable``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _with_rules(contexts):
    """``contexts`` (a checkpoint ``context_fn``) whose recompute context
    also installs the sharding rules of the forward: the recompute runs in
    the autograd engine's thread (``sharding.rules_context``)."""
    def context_fn():
        fwd, rec = contexts()
        stack = contextlib.ExitStack()
        rules = rules_context()

        @contextlib.contextmanager
        def recompute():
            with stack:
                stack.enter_context(rules)
                stack.enter_context(rec)
                yield
        return fwd, recompute()
    return context_fn


def _no_contexts():
    return contextlib.nullcontext(), contextlib.nullcontext()


def _remat(fn, remat: Union[bool, str]):
    """``fn`` recomputed in the backward: the whole of it for ``True`` or
    ``"full"``, all but its matmul outputs for ``"dots"``; as it is for
    ``False``. The recompute runs under the forward's sharding rules."""
    if not remat:
        return fn
    if remat is True or remat == "full":
        contexts = _no_contexts
    elif remat == "dots":
        contexts = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    else:
        raise ValueError(f"remat must be True, False, 'full' or 'dots', got {remat!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=_with_rules(contexts))


def apply_stack_full(x, stack, cfg: ModelConfig, positions,
                     want_cache: bool = False, cache_len: int = 0,
                     caller_positions: bool = False, memory=None,
                     remat: Union[bool, str] = False):
    """Returns (x, aux, cache): ``aux`` the MoE layers' load-balancing
    losses summed (0-d fp32), cache leaves stacked (L, B, cache_len, ...).
    ``positions``: (B, S), or (3, B, S) for M-RoPE; ``caller_positions``
    selects the attention path (``attention_full``); ``memory``, the
    encoder's output, feeds the cross-attention layers. ``remat``
    recomputes each super-block in the backward (``_remat``); the
    reference's ``src/repro/models/transformer.py:195-230``."""
    pattern = cfg.block_pattern()
    blocks = [tree_unbind(stack[f"pos{i}"], cfg.num_blocks) for i in range(len(pattern))]

    def body(x, aux, params):
        caches = {}
        for i, spec in enumerate(pattern):
            x, a, c = apply_layer_full(x, params[i], cfg, spec, positions,
                                       want_cache=want_cache, cache_len=cache_len,
                                       caller_positions=caller_positions, memory=memory)
            if a is not None:
                aux = aux + a
            caches[f"pos{i}"] = c
        return x, aux, caches

    body = _remat(body, remat)
    per_block: List[Params] = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(cfg.num_blocks):
        x, aux, caches = body(x, aux, [blk[b] for blk in blocks])
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


def stack_cache_axes(cfg: ModelConfig) -> Params:
    """Logical axes tree matching empty_stack_cache's structure."""
    pattern = cfg.block_pattern()
    out = {}
    for i, spec in enumerate(pattern):
        c: Params = {}
        if spec.kind == "attn":
            c["self"] = {
                "k": ("layer", "batch", "kv_seq", "kv_heads", None),
                "v": ("layer", "batch", "kv_seq", "kv_heads", None),
                "pos": ("layer", "batch", "kv_seq"),
            }
            if spec.cross_attn:
                c["cross"] = {
                    "k": ("layer", "batch", None, "kv_heads", None),
                    "v": ("layer", "batch", None, "kv_heads", None),
                }
        else:
            c["ssm"] = {
                "conv_x": ("layer", "batch", None, "ssm_inner"),
                "conv_B": ("layer", "batch", None, "ssm_state"),
                "conv_C": ("layer", "batch", None, "ssm_state"),
                "ssd": ("layer", "batch", "ssm_heads", None, None),
            }
        out[f"pos{i}"] = c
    return out


def empty_stack_cache(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int = 0,
                      kv_dtype=torch.bfloat16, device=None) -> Params:
    """Empty decode caches, leaves stacked (L, B, ...). A cross-attention
    layer's ``cross`` K and V are bf16 zeros of ``enc_len`` slots whatever
    ``kv_dtype`` is, as in the reference."""
    nb = cfg.num_blocks

    def stacked(c):
        return {k: v[None].repeat((nb,) + (1,) * v.dim()) for k, v in c.items()}

    out = {}
    for i, spec in enumerate(cfg.block_pattern()):
        _check_ported(spec)
        if spec.kind == "attn":
            c = {"self": stacked(empty_cache(cfg, spec, batch, cache_len,
                                             dtype=kv_dtype, device=device))}
            if spec.cross_attn:
                shape = (nb, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
                c["cross"] = {k: torch.zeros(shape, dtype=torch.bfloat16, device=device)
                              for k in ("k", "v")}
        else:
            c = {"ssm": stacked(empty_ssm_state(cfg, batch, device=device))}
        out[f"pos{i}"] = c
    return out


# ---------------------------------------------------------------------------
# the encoder (whisper): bidirectional blocks over the stub frontend's frames
# ---------------------------------------------------------------------------
def _encoder_spec(cfg: ModelConfig) -> LayerSpec:
    return LayerSpec(kind="attn", rope_theta=cfg.rope_theta)


def init_encoder(gen, cfg: ModelConfig, device=None) -> Params:
    """``blocks``: ``encoder_layers`` self-attention layers with their
    FFNs, stacked; ``norm_out``: the final norm."""
    return {"blocks": _init_stacked(gen, cfg, _encoder_spec(cfg), cfg.encoder_layers, device),
            "norm_out": init_norm(cfg.d_model, cfg.norm_kind, device)}


def sinusoid_positions(S: int, d: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """(S, d): sines of the angles pos / 10000^(2i/d) in the first half,
    their cosines in the second, computed in fp32 and cast to ``dtype``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def encode(enc, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, d), the stub frontend's embeddings. Each block
    attends over its own normed states with no mask (``attention_full``'s
    memory mode), then its FFN; returns the normed (B, S_enc, d)."""
    B, S, D = frames.shape
    x = frames + sinusoid_positions(S, D, frames.dtype, frames.device)[None]
    spec = _encoder_spec(cfg)
    for p in tree_unbind(enc["blocks"], cfg.encoder_layers):
        h = apply_norm(x, p.get("norm_in"), cfg.norm_kind, cfg.norm_eps)
        a, _ = attention_full(h, p["attn"], cfg, spec, None, memory=h)
        x = _ffn_residual(x + a, p, cfg)[0]
    return apply_norm(x, enc["norm_out"], cfg.norm_kind, cfg.norm_eps)
