"""whisper-base backbone — encoder–decoder [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model 512, 8 heads (MHA kv=8, head_dim
64), d_ff 2048, vocab 51865. The conv frontend is a stub, as in the
reference: the caller gives precomputed frame embeddings (B, 1500, 512).
Sinusoidal positions in the encoder, none in the decoder; parametric
LayerNorm, tanh-GELU MLP with biases. The decoder's cross-attention K/V
is computed once at prefill and never rewritten by decode. About 71 M
parameters: 0.14 GB in bf16.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,       # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    rope_kind="none",
    norm_kind="layernorm",
    norm_eps=1e-5,
    mlp_kind="gelu",
    encoder_layers=6,
    encoder_seq=1500,
    tie_embeddings=True,
    max_seq_len=32768,  # the reference's shape table; whisper's decoder holds 448
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 + 2 layers, d_model 64, 32 frames."""
    return replace(
        CONFIG, name="whisper-smoke", num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=128, encoder_seq=32,
    )
