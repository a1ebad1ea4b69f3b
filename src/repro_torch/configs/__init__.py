"""The RPC plane's runtime config and the architecture configs.

``ReproConfig``/``global_config`` hold the tuning knobs (admission,
streaming, the fallback transport) that the RPC plane's constructors
read their defaults from.

Each architecture module defines ``CONFIG`` (the published config) and
``smoke()`` (a reduced same-family variant for CPU tests). The registry
holds only the architectures the port serves; the model machinery is
imported lazily, so ``repro_torch.core`` loads this package without it.
"""

from __future__ import annotations

import importlib
from typing import TYPE_CHECKING, Dict, List

from .global_config import ReproConfig, global_config

if TYPE_CHECKING:  # typing only
    from ..models.config import ModelConfig

__all__ = ["ReproConfig", "global_config", "ARCH_IDS", "ALIASES",
           "get_config", "get_smoke_config", "all_configs"]

ARCH_IDS: List[str] = ["yi_9b", "mamba2_1p3b", "gemma3_12b", "olmo_1b",
                        "yi_6b", "qwen2_vl_7b", "granite_moe_1b_a400m",
                        "qwen3_moe_30b_a3b", "jamba_v01_52b", "whisper_base"]

ALIASES: Dict[str, str] = {"yi-9b": "yi_9b", "mamba2-1.3b": "mamba2_1p3b",
                           "gemma3-12b": "gemma3_12b", "olmo-1b": "olmo_1b",
                           "yi-6b": "yi_6b", "qwen2-vl-7b": "qwen2_vl_7b",
                           "granite-moe-1b-a400m": "granite_moe_1b_a400m",
                           "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
                           "jamba-v0.1-52b": "jamba_v01_52b",
                           "whisper-base": "whisper_base"}


def _module(arch: str):
    key = ALIASES.get(arch, arch)
    if key not in ARCH_IDS:
        raise KeyError(f"architecture {arch!r} is not ported "
                       f"(ported: {', '.join(ARCH_IDS)})")
    return importlib.import_module(f"{__name__}.{key}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
