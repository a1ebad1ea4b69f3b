"""Architecture configs ported so far.

Each module defines ``CONFIG`` (the published config) and ``smoke()``
(a reduced same-family variant for CPU tests). The registry holds only
the architectures the port serves.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

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
