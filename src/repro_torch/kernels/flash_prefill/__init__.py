from .grad import flash_prefill_vjp
from .ops import FlashPrefillFn, flash_prefill
from .ref import flash_prefill_ref

__all__ = ["FlashPrefillFn", "flash_prefill", "flash_prefill_ref", "flash_prefill_vjp"]
