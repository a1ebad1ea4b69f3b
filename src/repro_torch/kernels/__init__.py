"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``paged_attention``, ``scope_copy`` (gather/scatter pages),
``ssd`` (the Mamba-2 SSD intra-chunk scan) and ``flash_prefill`` (causal
prefill attention). ``build`` compiles ``csrc/*.cu`` at first use."""
from . import build, flash_prefill, paged_attention, scope_copy, ssd

__all__ = ["build", "flash_prefill", "paged_attention", "scope_copy", "ssd"]
