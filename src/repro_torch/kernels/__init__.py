"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``paged_attention`` and ``scope_copy`` (gather/scatter pages).
``build`` compiles ``csrc/*.cu`` at first use."""
