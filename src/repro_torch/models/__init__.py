"""Dense, vlm, MoE and Mamba-2 SSM models: config, layers, attention, SSM, stack, Model."""

from .config import LayerSpec, ModelConfig
from .model import Model, build_model

__all__ = ["LayerSpec", "ModelConfig", "Model", "build_model"]
