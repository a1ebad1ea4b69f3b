"""Serving data plane: the paged KV pool, paged decode, and the engine."""

from .engine import Request, ServeEngine, StreamScheduler
from .kv_pool import PagedKVPool, PoolConfig, transfer_pages_cross_pod
from .paged_model import check_paged_compatible, paged_decode_step, prefill_kv

__all__ = [
    "Request", "ServeEngine", "StreamScheduler", "PagedKVPool", "PoolConfig",
    "transfer_pages_cross_pod", "check_paged_compatible",
    "paged_decode_step", "prefill_kv",
]
