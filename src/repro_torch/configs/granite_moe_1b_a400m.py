"""granite-moe-1b-a400m — 32 experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model 1024, 16 heads (GQA kv=8, head_dim 64), expert d_ff
512, vocab 49155 (tied). Every layer's FFN is MoE. About 1.33 B
parameters: 2.7 GB in bf16.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    rope_kind="rope",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    norm_eps=1e-6,
    mlp_kind="swiglu",
    num_experts=32,
    top_k=8,
    moe_d_ff=512,
    moe_layer_period=1,
    capacity_factor=1.25,
    tie_embeddings=True,
    max_seq_len=4096,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 8 experts, top-2."""
    return replace(
        CONFIG, name="granite-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=128,
        num_experts=8, top_k=2, moe_d_ff=32,
    )
