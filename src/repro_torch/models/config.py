"""Model configuration — the architecture dataclass and its super-block.

The field set is the reference package's, so a config built here names
the same architecture; the port serves the dense family (``rmsnorm``,
``rope``, ``swiglu``), its vlm and moe variants, the Mamba-2 SSM family
(``d_inner``, ``ssm_heads``), the hybrid (jamba's attention:SSM
super-block, ``attn_layer_period``) and the encoder–decoder (whisper:
``encoder_layers``, a cross-attention on every decoder layer).
``block_pattern()`` factors the layer stack into a repeating
*super-block*; the stacked parameters carry one leading layer axis per
pattern position.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating super-block."""
    kind: str = "attn"            # "attn" | "ssm"
    moe: bool = False             # MoE FFN instead of dense FFN
    sliding_window: int = 0       # 0 = global attention
    rope_theta: float = 1e4
    cross_attn: bool = False      # decoder cross-attention (enc-dec)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    rope_kind: str = "rope"       # rope | mrope | none
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0
    local_global_period: int = 0
    qk_norm: bool = False
    attn_bias: bool = False
    attn_logit_softcap: float = 0.0

    # --- norm / mlp ---
    norm_kind: str = "rmsnorm"
    norm_eps: float = 1e-6
    mlp_kind: str = "swiglu"
    embed_scale: bool = False

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # --- encoder–decoder ---
    encoder_layers: int = 0
    encoder_seq: int = 0

    # --- embeddings / misc ---
    tie_embeddings: bool = True
    max_seq_len: int = 131072
    sub_quadratic: bool = False
    param_dtype: str = "bfloat16"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def block_pattern(self) -> List[LayerSpec]:
        """The repeating super-block of the layer stack."""
        period = 1
        if self.local_global_period:
            period = self.local_global_period
        if self.attn_layer_period:
            period = max(period, self.attn_layer_period)
        if self.num_experts and self.moe_layer_period > 1:
            period = _lcm(period, self.moe_layer_period)
        if self.num_layers % period != 0:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible "
                f"by super-block period {period}")

        specs = []
        for i in range(period):
            if self.attn_layer_period:
                kind = ("attn" if i % self.attn_layer_period ==
                        self.attn_layer_offset else "ssm")
            elif self.family == "ssm":
                kind = "ssm"
            else:
                kind = "attn"
            window, theta = self.sliding_window, self.rope_theta
            if self.local_global_period and kind == "attn":
                if (i + 1) % self.local_global_period == 0:
                    window = 0
                    theta = self.rope_theta_global or self.rope_theta
            moe = bool(self.num_experts) and (
                i % self.moe_layer_period == self.moe_layer_offset)
            specs.append(LayerSpec(
                kind=kind, moe=moe, sliding_window=window, rope_theta=theta,
                cross_attn=bool(self.encoder_layers) and kind == "attn",
            ))
        return specs

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.block_pattern())

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer, and the
        encoder's), the reference's formula. Like the reference it counts a
        dense FFN only on attention layers and in the ssm family: a
        hybrid's non-MoE SSM layers hold one (``init_layer``) that the
        count leaves out."""
        d, v = self.d_model, self.vocab_size
        total = d * v
        if not self.tie_embeddings:
            total += d * v
        for spec in self.block_pattern() * self.num_blocks:
            if spec.kind == "attn":
                qkv = d * self.num_heads * self.head_dim \
                    + 2 * d * self.num_kv_heads * self.head_dim \
                    + self.num_heads * self.head_dim * d
                total += 2 * qkv if spec.cross_attn else qkv
            else:
                di, ds, h = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ds + h)      # in_z, in_x, in_B, in_C, in_dt
                total += (di + 2 * ds) * self.ssm_conv  # conv
                total += 2 * h                          # A_log, D
                total += di * d                         # out_proj
            if spec.moe:
                total += d * self.num_experts                     # router
                total += self.num_experts * 3 * d * self.moe_d_ff
            elif self.d_ff and (spec.kind == "attn" or self.family == "ssm"):
                total += (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
            total += 2 * d  # norms (approx)
        if self.encoder_layers:
            n = 3 if self.mlp_kind == "swiglu" else 2
            total += self.encoder_layers * (4 * d * self.num_heads * self.head_dim
                                            + n * d * self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts), the
        reference's formula."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(
            1 for s in self.block_pattern() if s.moe) * self.num_blocks
        inactive = moe_layers * (self.num_experts - self.top_k) * \
            3 * self.d_model * self.moe_d_ff
        return full - inactive


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclass(frozen=True)
class ShapeConfig:
    """One launch shape (assigned per-arch input shapes)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
