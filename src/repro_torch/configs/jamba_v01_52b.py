"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

32 layers, d_model 4096: one attention layer (32 heads, GQA kv=8,
head_dim 128, no positional encoding) per 8 layers (offset 4, as the HF
config), the other 7 are SSD layers (d_inner 8192, 128 heads of 64,
state 16, conv 4); an MoE FFN (16 experts, top-2, d_ff 14336) on every
second layer (the odd positions, all SSM layers), a dense SwiGLU FFN
(d_ff 14336) on the others. Jamba v0.1's SSM layers are S6 (Mamba-1);
the reference instantiates them with the SSD (Mamba-2) formulation at
matched dimensions, and so does the port.

``param_count()`` gives the reference's 49.08 B, which leaves out the
dense FFN of the SSM layers at positions 0, 2 and 6; the initialised
tree holds 51.19 B (102.4 GB in bf16), so one 80 GB card serves half its
depth (16 layers, 25.73 B).
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope_kind="none",  # jamba uses no positional encoding in attn layers
    norm_kind="rmsnorm",
    norm_eps=1e-6,
    mlp_kind="swiglu",
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    capacity_factor=1.25,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_layer_period=8,
    attn_layer_offset=4,
    tie_embeddings=True,
    max_seq_len=262144,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    """Same family at test size: one super-block of 8 layers, d_model 64,
    4 experts top-2, SSD state 8 in chunks of 16."""
    return replace(
        CONFIG, name="jamba-smoke", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128, num_experts=4, top_k=2, moe_d_ff=64,
        ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
    )
