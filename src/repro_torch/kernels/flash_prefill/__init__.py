from .ops import flash_prefill
from .ref import flash_prefill_ref

__all__ = ["flash_prefill", "flash_prefill_ref"]
