"""gemma3-12b — 5:1 local:global attention, 128k context [hf:google/gemma-3].

48 layers, d_model 3840, 16 heads (GQA kv=8, head_dim 256), d_ff 15360,
vocab 262144. Every 6th layer is global (rope base 1M); the five local
layers use a 1024-token sliding window (rope base 10k) and keep 1024-slot
ring caches. Gemma-style (1+w) RMSNorm, qk-norm, sqrt(d) embedding
scale, tied embeddings. About 11.8 B parameters: 23.5 GB in bf16, so one
80 GB card holds it whole.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    rope_kind="rope",
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    sliding_window=1024,
    local_global_period=6,
    qk_norm=True,
    norm_kind="rmsnorm_gemma",
    norm_eps=1e-6,
    mlp_kind="swiglu",
    embed_scale=True,
    tie_embeddings=True,
    max_seq_len=131072,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    """Same family at test size: one super-block of 6 layers (5 local,
    1 global), window 8, d_model 64, 4/2 heads of 16."""
    return replace(
        CONFIG, name="gemma3-smoke", num_layers=6, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256, sliding_window=8,
    )
