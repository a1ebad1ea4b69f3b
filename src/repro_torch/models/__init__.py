"""Dense-family model: config, layers, attention, stack, Model."""

from .config import LayerSpec, ModelConfig
from .model import Model, build_model

__all__ = ["LayerSpec", "ModelConfig", "Model", "build_model"]
