"""yi-6b — llama-architecture GQA [arXiv:2403.04652].

yi-9b's widths at 32 layers: d_model 4096, 32 heads (GQA kv=4, head_dim
128), d_ff 11008, vocab 64000. About 6.06 B parameters: 12.1 GB in bf16.
"""

from dataclasses import replace

from ..models.config import ModelConfig
from .yi_9b import CONFIG as _YI9B

CONFIG = replace(_YI9B, name="yi-6b", num_layers=32)


def smoke() -> ModelConfig:
    """Same family at test size: 2 layers, d_model 64, 4/2 heads."""
    return replace(
        CONFIG, name="yi6b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128,
    )
