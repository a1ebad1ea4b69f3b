"""yi-9b — llama-architecture GQA [arXiv:2403.04652].

48 layers, d_model 4096, 32 heads (GQA kv=4, head_dim 128), d_ff 11008,
vocab 64000. About 8.8 B parameters: 17.6 GB in bf16, so one 80 GB card
holds it whole.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_kind="rope",
    rope_theta=5_000_000.0,
    norm_kind="rmsnorm",
    norm_eps=1e-5,
    mlp_kind="swiglu",
    tie_embeddings=False,
    max_seq_len=32768,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 4/2 heads."""
    return replace(
        CONFIG, name="yi9b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
    )
