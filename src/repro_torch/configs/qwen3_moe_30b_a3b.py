"""qwen3-moe-30b-a3b — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B].

48 layers, d_model 2048, 32 heads (GQA kv=4, head_dim 128), expert d_ff
768, vocab 151936 (untied). Every layer's FFN is MoE; qk-norm per Qwen3.
About 30.5 B parameters (3 B active a token): 61 GB in bf16, so one 80 GB
card holds it whole.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # all-MoE FFN
    vocab_size=151936,
    rope_kind="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    norm_kind="rmsnorm",
    norm_eps=1e-6,
    mlp_kind="swiglu",
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    moe_layer_period=1,
    capacity_factor=1.25,
    tie_embeddings=False,
    max_seq_len=32768,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 8 experts, top-2."""
    return replace(
        CONFIG, name="qwen3moe-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=128,
        num_experts=8, top_k=2, moe_d_ff=32,
    )
