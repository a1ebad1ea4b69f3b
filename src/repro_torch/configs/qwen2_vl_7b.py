"""qwen2-vl-7b backbone — M-RoPE, GQA with q/k/v biases [arXiv:2409.12191].

28 layers, d_model 3584, 28 heads (GQA kv=4, head_dim 128: 7 query heads
a KV head), d_ff 18944, vocab 152064 (untied). The modality frontend is a
stub, as in the reference: patch embeddings arrive as ordinary tokens and
the caller gives M-RoPE position triples (3, B, S) to ``Model.prefill``;
the 64 frequency slots of a head split 16/24/24 over the temporal, height
and width streams. About 7.62 B parameters: 15.2 GB in bf16.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    rope_kind="mrope",
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    attn_bias=True,
    norm_kind="rmsnorm",
    norm_eps=1e-6,
    mlp_kind="swiglu",
    tie_embeddings=False,
    max_seq_len=32768,
    sub_quadratic=False,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 4/2 heads of 16,
    sections (2, 3, 3) over the 8 frequency slots."""
    return replace(
        CONFIG, name="qwen2vl-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
        mrope_sections=(2, 3, 3),
    )
