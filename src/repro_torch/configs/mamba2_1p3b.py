"""mamba2-1.3b — SSD state-space model [arXiv:2405.21060].

48 layers, d_model 2048, attention-free (d_ff 0: the Mamba-2 block carries
the channel mixing), vocab 50280, ssm_state 128. d_inner = 2·2048 = 4096,
head_dim 64 ⇒ 64 SSD heads, chunk 128. About 1.3 B parameters: 2.7 GB in
bf16, so one card holds it whole.
"""

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    rope_kind="none",
    norm_kind="rmsnorm",
    norm_eps=1e-5,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
    max_seq_len=1 << 20,
    sub_quadratic=True,
)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 8 heads of 16."""
    return replace(
        CONFIG, name="mamba2-smoke", num_layers=2, d_model=64,
        vocab_size=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    )
