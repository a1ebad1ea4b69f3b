"""Top-level Model for the dense, vlm (Qwen2-VL's backbone), moe, SSM,
hybrid (jamba) and audio (whisper's encoder–decoder backbone) families:
init, training loss, prefill, decode.

``Model`` is an ``nn.ModuleDict`` whose parameter tree has the reference
tree's key paths (``embed.tok``, ``stack.pos0.attn.wq``, ``norm_f.scale``)
with the same shapes and dtypes, so the model itself indexes like the
reference's params dict and can be handed to the functional layers.
Parameters are built without grad, for serving; ``trainable()`` turns
grad on for every floating parameter, and ``loss_fn`` is then
differentiated by ``torch.autograd`` (``repro_torch.training``).

Training batches, as the reference's:

  LM (dense/moe/ssm/hybrid):  {"tokens": (B,S) int, "labels": (B,S) int}
  vlm (qwen2-vl backbone):    + {"positions": (3,B,S) int}  (M-RoPE streams)
  audio (whisper backbone):   + {"frames": (B,S_enc,D)}     (stub frontend)

Labels < 0 are masked out of the loss.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..convert import params_from_numpy
from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from ..sharding import shard
from .layers import (EMBED_AXES, MLP_KINDS, NORM_AXES, NORM_KINDS, apply_norm, embed_tokens,
                     init_embed, init_norm, unembed)
from .transformer import (apply_stack_decode, apply_stack_full, empty_stack_cache, encode,
                          init_encoder, init_stack, layer_axes, stack_layer_axes)

Params = Dict[str, Any]


def _to_module(tree: Mapping[str, Any]) -> nn.Module:
    """Nested dict of tensors → ModuleDict/ParameterDict nesting."""
    leaves = [isinstance(v, torch.Tensor) for v in tree.values()]
    if all(leaves):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(leaves):
        raise ValueError("parameter tree mixes leaves and subtrees at one level")
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any architecture feature outside the ported families:
    dense (RoPE, SwiGLU; optionally gemma's RMSNorm, OLMo's LayerNorm,
    q/k/v biases, qk-norm, sliding windows and a logit softcap), vlm (the
    same with M-RoPE), moe (the dense family's attention with an MoE FFN),
    Mamba-2 SSM (no positions), the hybrid (attention without positions
    among SSM layers, with or without MoE FFNs, as jamba) and audio
    (whisper: an encoder, a decoder without positions whose layers attend
    over the encoder's output, LayerNorm with parameters, the GELU MLP).
    Only the audio family has an encoder."""
    rope = {"dense": "rope", "vlm": "mrope", "moe": "rope", "ssm": "none",
            "hybrid": "none", "audio": "none"}
    experts = {"moe": (True,), "hybrid": (False, True)}
    unported = [
        name for name, bad in (
            (f"family {cfg.family!r}", cfg.family not in rope),
            ("norm_kind", cfg.norm_kind not in NORM_KINDS),
            ("rope_kind", cfg.rope_kind != rope.get(cfg.family)),
            ("mlp_kind", cfg.mlp_kind not in MLP_KINDS),
            ("encoder_layers", bool(cfg.encoder_layers) != (cfg.family == "audio")),
            ("num_experts",
             bool(cfg.num_experts) not in experts.get(cfg.family, (False,))),
        ) if bad]
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(unported)}")


class Model(nn.ModuleDict):
    def __init__(self, cfg: ModelConfig):
        check_ported(cfg)
        super().__init__()
        self.cfg = cfg

    # -- parameters -----------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self["embed"]["tok"].device

    def init(self, generator: torch.Generator, device: DeviceLike = None
             ) -> "Model":
        """Random parameters from ``generator`` on ``device`` (``None`` →
        cuda). Same key paths, shapes and dtypes as the reference's
        ``Model.init``; the values differ because the generators do."""
        return self.install(self._param_tree(generator, resolve_device(device)))

    def _param_tree(self, generator: torch.Generator, dev: torch.device) -> Params:
        cfg = self.cfg
        tree = {
            "embed": init_embed(generator, cfg.vocab_size, cfg.d_model,
                                cfg.tie_embeddings, dev),
            "stack": init_stack(generator, cfg, dev),
            "norm_f": init_norm(cfg.d_model, cfg.norm_kind, dev),
        }
        if cfg.encoder_layers:
            tree["encoder"] = init_encoder(generator, cfg, dev)
        return tree

    def param_shapes(self) -> Params:
        """The parameter tree on the ``meta`` device: every leaf's shape
        and dtype, nothing allocated (the reference's ``param_shapes``)."""
        return self._param_tree(torch.Generator(), torch.device("meta"))

    def axes(self) -> Params:
        """The logical-axes tree matching ``params()`` leaf for leaf (the
        reference's ``Model.axes``): each leaf's axes by its key, over the
        tree that ``param_shapes`` builds; stacked leaves lead with
        ``"layer"``."""
        shapes = self.param_shapes()

        def table(tree, axes):
            return {k: axes[k] for k in tree}

        ax: Params = {
            "embed": table(shapes["embed"], EMBED_AXES),
            "stack": {pos: stack_layer_axes(layer_axes(t)) for pos, t in shapes["stack"].items()},
            "norm_f": table(shapes["norm_f"], NORM_AXES),
        }
        if "encoder" in shapes:
            enc = shapes["encoder"]
            ax["encoder"] = {"blocks": stack_layer_axes(layer_axes(enc["blocks"])),
                             "norm_out": table(enc["norm_out"], NORM_AXES)}
        return ax

    def load_params(self, tree: Mapping[str, Any], device: DeviceLike = None
                    ) -> "Model":
        """Install the reference's parameters, given as numpy arrays."""
        return self.install(params_from_numpy(tree, resolve_device(device)))

    def install(self, tree: Mapping[str, Any]) -> "Model":
        """Make the tensors of ``tree`` (the parameter tree's key paths)
        the model's parameters, without copies (DTensors too:
        ``launch/sharding.distribute_model``)."""
        self.clear()
        for k, v in tree.items():
            self[k] = _to_module(v)
        return self

    def params(self) -> Params:
        """The parameter tree as nested dicts of the model's own
        ``nn.Parameter``s (no copies); an empty norm is ``{}``."""
        def tree(m):
            if isinstance(m, nn.ParameterDict):
                return dict(m.items())
            return {k: tree(v) for k, v in m.items()}
        return tree(self)

    @torch.no_grad()
    def load_state(self, tree: Mapping[str, Any]) -> "Model":
        """Copy a tree of tensors (a checkpoint's ``params``) into the
        model's parameters in place, each converted to the parameter's
        device; the key paths, shapes and dtypes must be the model's."""
        def copy(dst, src, path):
            if set(dst) != set(src):
                raise ValueError(f"parameter tree differs at {path or '<root>'}: "
                                 f"{sorted(set(dst) ^ set(src))}")
            for k, d in dst.items():
                if isinstance(d, dict):
                    copy(d, src[k], f"{path}{k}.")
                elif (d.shape, d.dtype) != (src[k].shape, src[k].dtype):
                    raise ValueError(f"{path}{k}: {tuple(src[k].shape)} {src[k].dtype}, "
                                     f"the model has {tuple(d.shape)} {d.dtype}")
                else:
                    d.copy_(src[k])
        copy(self.params(), tree, "")
        return self

    def trainable(self) -> "Model":
        """Grad on for every floating parameter."""
        for p in self.parameters():
            if p.is_floating_point():
                p.requires_grad_()
        return self

    # -- training -----------------------------------------------------------
    def _batch_positions(self, batch: Mapping[str, Any], B: int, S: int):
        """(positions, caller_positions): M-RoPE's ``batch["positions"]``
        when the batch has them (``_attend`` masks by their temporal
        stream, as the reference does); otherwise 0..S-1 for the kernel
        path. A RoPE model ignores ``batch["positions"]``, as the
        reference's ``_positions`` does (ROADMAP Queue 3 entry 8)."""
        if self.cfg.rope_kind == "mrope" and batch.get("positions") is not None:
            positions = batch["positions"]
            if tuple(positions.shape) != (3, B, S):
                raise ValueError(f"{self.cfg.name}: batch positions are M-RoPE's "
                                 f"(3, {B}, {S}) streams, got {tuple(positions.shape)}")
            return positions, True
        positions = torch.arange(S, dtype=torch.int32,
                                 device=batch["tokens"].device)[None].expand(B, S)
        if self.cfg.rope_kind == "mrope":
            positions = positions[None].expand(3, B, S)
        return positions, False

    def loss_fn(self, batch: Mapping[str, Any], remat: Union[bool, str] = True):
        """Masked next-token NLL over ``labels >= 0`` (fp32 logits and a
        logsumexp), plus ``router_aux_coef`` times the MoE aux loss for a
        model with experts. ``remat`` recomputes each super-block in the
        backward (``True``/``"full"``, or ``"dots"`` keeping the matmul
        outputs; ``apply_stack_full``). Returns (loss, metrics ``{loss,
        tokens, aux}``), 0-d fp32; the reference's
        ``src/repro/models/model.py:89-116``."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        x = embed_tokens(tokens, self["embed"], cfg.embed_scale, cfg.d_model)
        x = shard(x, ("batch", "seq", "embed"))
        positions, given = self._batch_positions(batch, B, S)
        x, aux, _ = apply_stack_full(x, self["stack"], cfg, positions,
                                     caller_positions=given,
                                     memory=self._memory(batch.get("frames")),
                                     remat=remat)
        x = apply_norm(x, self["norm_f"], cfg.norm_kind, cfg.norm_eps)
        # under sharding rules the fp32 logits are gathered over the vocab
        # before the logsumexp and the target's pick, and the (B, S) terms
        # over the batch before the sums, which then add in the unsharded
        # order on every rank (all identities without rules)
        logits = shard(unembed(x, self["embed"]).float(), ("batch", "seq", None))
        mask = shard((labels >= 0).float(), (None, None))
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
        tokens_n = mask.sum()
        nll = shard(lse - tgt, (None, None)) * mask
        loss = nll.sum() / torch.clamp(tokens_n, min=1.0)
        if cfg.num_experts:
            loss = loss + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "tokens": tokens_n, "aux": aux}

    # -- serving ------------------------------------------------------------
    def _memory(self, frames: Optional[torch.Tensor]):
        """The encoder's output for ``frames``, or ``None`` without frames
        or without an encoder (the reference's ``_memory``)."""
        if self.cfg.encoder_layers and frames is not None:
            return encode(self["encoder"], self.cfg, frames)
        return None

    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                positions: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None):
        """tokens: (B, S) int. Returns (last-token logits (B, V) fp32,
        cache). An attention layer's cache leaves are (L, B, cache_len,
        Hkv, D); an SSM layer's are the conv tails (L, B, K-1, C) in the
        activation dtype and the SSD state (L, B, H, N, P) in fp32.

        ``positions``: M-RoPE's (3, B, S) int streams (temporal, height,
        width), as the reference's ``batch["positions"]``. Without them
        the positions are 0..S-1 (three equal streams for M-RoPE) and
        attention runs the ``flash_prefill`` kernel; with them it masks by
        the temporal stream's values, as the reference does
        (``attention_full``).

        ``frames``: whisper's (B, S_enc, d_model) stub-frontend embeddings,
        the reference's ``batch["frames"]``. The encoder runs over them and
        each cross-attention layer caches the K and V of its output under
        ``cross`` ((L, B, S_enc, Hkv, D)). Without frames there is no
        memory: the cross-attention layers are skipped and the cache has
        no ``cross``, as in the reference."""
        cfg = self.cfg
        B, S = tokens.shape
        cache_len = cache_len or S
        x = embed_tokens(tokens, self["embed"], cfg.embed_scale, cfg.d_model)
        x = shard(x, ("batch", "seq", "embed"))
        given = positions is not None
        if not given:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device)[None].expand(B, S)
            if cfg.rope_kind == "mrope":
                positions = positions[None].expand(3, B, S)
        elif cfg.rope_kind != "mrope" or tuple(positions.shape) != (3, B, S):
            raise ValueError(f"{cfg.name}: caller positions are M-RoPE's "
                             f"(3, {B}, {S}) streams, got {tuple(positions.shape)} "
                             f"for rope kind {cfg.rope_kind!r}")
        x, _, cache = apply_stack_full(x, self["stack"], cfg, positions,
                                       want_cache=True, cache_len=cache_len,
                                       caller_positions=given,
                                       memory=self._memory(frames))
        x = apply_norm(x[:, -1:], self["norm_f"], cfg.norm_kind, cfg.norm_eps)
        return unembed(x, self["embed"])[:, 0].float(), cache

    def decode_step(self, token: torch.Tensor, pos: torch.Tensor,
                    cache: Params):
        """token: (B,) int; pos: (B,) int, or a 0-d int tensor when every
        sequence is at the same position (unused by SSM layers). Returns
        (logits (B, V) fp32, cache) — the cache is updated in place."""
        cfg = self.cfg
        x = embed_tokens(token[:, None], self["embed"], cfg.embed_scale,
                         cfg.d_model)
        x, cache = apply_stack_decode(x, self["stack"], cfg, cache, pos)
        x = apply_norm(x, self["norm_f"], cfg.norm_kind, cfg.norm_eps)
        return unembed(x, self["embed"])[:, 0].float(), cache

    def empty_cache(self, batch: int, cache_len: int,
                    kv_dtype=torch.bfloat16) -> Params:
        """Empty decode caches; ``kv_dtype`` bf16, fp32 or int8 (stored at
        ``attention.KV_INT8_SCALE``) for the attention layers; the cross
        caches hold ``encoder_seq`` bf16 slots."""
        return empty_stack_cache(self.cfg, batch, cache_len, enc_len=self.cfg.encoder_seq,
                                 kv_dtype=kv_dtype, device=self.device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
