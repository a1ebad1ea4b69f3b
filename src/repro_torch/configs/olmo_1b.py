"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838].

16 layers, d_model 2048, 16 heads (MHA: kv=16, head_dim 128), d_ff 8192,
vocab 50304 (tied). OLMo's LayerNorm carries no scale and no bias, so
its norm subtrees are empty. About 1.18 B parameters: 2.4 GB in bf16.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    rope_kind="rope",
    rope_theta=10_000.0,
    norm_kind="layernorm_np",
    norm_eps=1e-5,
    mlp_kind="swiglu",
    tie_embeddings=True,
    max_seq_len=4096,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 4/4 heads of 16."""
    return replace(
        CONFIG, name="olmo-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
    )
