"""Plain PyTorch version of page gather/scatter (ids clamped to [0, P-1])."""

from __future__ import annotations


def gather_pages_ref(pool, pages):
    """pool: (P, W); pages: (n,) int32 → (n, W)."""
    return pool[pages.clamp(0, pool.shape[0] - 1).long()]


def scatter_pages_ref(pool, pages, buf):
    """Write buf (n, W) into pool rows ``pages`` in place; returns pool."""
    pool[pages.clamp(0, pool.shape[0] - 1).long()] = buf
    return pool
