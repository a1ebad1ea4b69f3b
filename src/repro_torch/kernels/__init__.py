"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``paged_attention``, ``scope_copy`` (gather/scatter pages) and
``ssd`` (the Mamba-2 SSD intra-chunk scan).
``build`` compiles ``csrc/*.cu`` at first use."""
