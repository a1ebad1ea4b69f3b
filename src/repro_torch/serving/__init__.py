"""Serving data plane: the paged KV pool, paged decode, the engine and
its decode service over the RPC plane."""

from .engine import (FN_ATTACH, FN_ATTACH_REMOTE, DecodeService, Request,
                     ServeEngine, StreamScheduler)
from .kv_pool import PagedKVPool, PoolConfig, PoolPages, transfer_pages_cross_pod
from .paged_model import check_paged_compatible, paged_decode_step, prefill_kv

__all__ = [
    "FN_ATTACH", "FN_ATTACH_REMOTE", "DecodeService", "Request",
    "ServeEngine", "StreamScheduler", "PagedKVPool", "PoolConfig",
    "PoolPages", "transfer_pages_cross_pod", "check_paged_compatible",
    "paged_decode_step", "prefill_kv",
]
