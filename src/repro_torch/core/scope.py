"""Scopes — self-contained page ranges for RPC arguments (§4.5, §5.1).

A scope is a dedicated range of contiguous pages within a connection's heap
that holds exactly the data for one RPC, so sealing it never "false-seals"
unrelated objects that share a page. Scopes carry their own bump
allocator (``alloc``) and can be ``reset`` for reuse or ``destroy``ed to
return the pages to the heap. ``ScopePool`` (§5.3) keeps pre-created
scopes so hot RPC paths never touch the heap allocator.
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import addr as gaddr
from .errors import AllocationError, InvalidPointer
from .heap import SharedHeap

_ALIGN = 8


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class Scope:
    """A contiguous page range + bump allocator."""

    def __init__(self, heap: SharedHeap, start_page: int, num_pages: int,
                 owner: int = 0):
        self.heap = heap
        self.start_page = start_page
        self.num_pages = num_pages
        self.owner = owner
        self._bump = 0  # byte offset within the scope
        self._live = True
        if heap._tracer is not None:
            heap._tracer.on_scope_create(self)

    # -- geometry ------------------------------------------------------
    @property
    def size_bytes(self) -> int:
        return self.num_pages * self.heap.page_size

    @property
    def base_addr(self) -> int:
        return self.heap.addr_of_page(self.start_page)

    def page_range(self) -> tuple[int, int]:
        return (self.start_page, self.num_pages)

    def contains(self, a: int) -> bool:
        if gaddr.is_null(a) or gaddr.heap_of(a) != self.heap.heap_id:
            return False
        lin = gaddr.linear(a, self.heap.page_size)
        lo = self.start_page * self.heap.page_size
        return lo <= lin < lo + self.size_bytes

    # -- allocation ----------------------------------------------------
    def alloc(self, nbytes: int) -> int:
        """Bump-allocate ``nbytes`` in the scope; returns a GlobalAddr."""
        if self.heap._tracer is not None:
            self.heap._tracer.on_scope_use(self, "alloc")
        if not self._live:
            raise InvalidPointer("allocation in destroyed scope")
        off = _align(self._bump)
        if off + nbytes > self.size_bytes:
            raise AllocationError(
                f"scope overflow: {off}+{nbytes} > {self.size_bytes}"
            )
        self._bump = off + nbytes
        return gaddr.add(self.base_addr, off, self.heap.page_size)

    def write_bytes(self, data: bytes | bytearray | memoryview | np.ndarray,
                    pid: int = 0) -> int:
        """Copy ``data`` into the scope (one memcpy)."""
        a = self.alloc(SharedHeap._payload_nbytes(data))
        self.heap.write(a, data, pid=pid)
        return a

    def write_u64(self, values: List[int], pid: int = 0) -> int:
        return self.write_bytes(np.asarray(values, dtype="<u8"), pid)

    def view(self) -> np.ndarray:
        """Raw ndarray view of the scope's bytes (zero-copy fill path)."""
        if self.heap._tracer is not None:
            self.heap._tracer.on_scope_use(self, "view")
        lo = self.start_page * self.heap.page_size
        return self.heap.buf[lo : lo + self.size_bytes]

    def used_bytes(self) -> int:
        return self._bump

    def remaining_bytes(self) -> int:
        """Bytes still allocatable (from the next aligned offset)."""
        return max(0, self.size_bytes - _align(self._bump))

    # -- lifecycle (§5.1) ----------------------------------------------
    def reset(self) -> None:
        """Reuse the scope: all objects allocated within are lost."""
        self._bump = 0

    def destroy(self) -> None:
        if self._live:
            self.heap.free_extent(self.start_page, self.num_pages)
            self._live = False
            if self.heap._tracer is not None:
                self.heap._tracer.on_scope_destroy(self)

    @property
    def live(self) -> bool:
        return self._live

    def __repr__(self) -> str:
        return (
            f"<Scope heap={self.heap.heap_id} pages=[{self.start_page},"
            f"{self.start_page + self.num_pages}) used={self._bump}B>"
        )


def create_scope(heap: SharedHeap, size_bytes: int, owner: int = 0) -> Scope:
    """``Connection::create_scope(size)`` (§5.1)."""
    pages = max(1, (size_bytes + heap.page_size - 1) // heap.page_size)
    start = heap.alloc_pages(pages, owner=owner)
    return Scope(heap, start, pages, owner=owner)


def implicit_scope(conn, nbytes: int, page_size: int) -> Scope:
    """The implicit-allocation policy behind scope-less ``new_bytes``:
    consecutive allocations share the connection's current implicit scope
    until it fills; every such scope is tracked on the connection and
    returned to the heap at close."""
    s = conn._implicit
    if s is None or s.remaining_bytes() < nbytes:
        s = conn.create_scope(max(nbytes or 1, page_size))
        conn._implicit_scopes.append(s)
        conn._implicit = s
    return s


class ScopePool:
    """Pre-created scopes for hot RPC paths + batched seal release (§5.3).

    ``pop`` hands out a reset scope; ``push`` returns it. A scope whose seal
    release was batched is returned with ``push_sealed`` and stays
    quarantined until the SealManager flushes the batch (its pages are
    still write-protected). If the pool runs dry it forces a flush.
    """

    def __init__(self, heap: SharedHeap, scope_pages: int,
                 max_scopes: int = 8192, owner: int = 0, seals=None):
        self.heap = heap
        self.scope_pages = scope_pages
        self.max_scopes = max_scopes
        self.owner = owner
        self.seals = seals  # Optional[SealManager]
        self._free: List[Scope] = []
        self._pending: List[tuple] = []  # (scope, flush generation)
        self._created = 0

    def pop(self) -> Scope:
        if not self._free and self._pending:
            self._reclaim()
        if not self._free and self._created >= self.max_scopes \
                and self._pending:
            # pool dry: pay for a flush now (one epoch) to reclaim scopes
            self.seals.flush()
            self._reclaim()
        if self._free:
            s = self._free.pop()
            s.reset()
            if self.heap._tracer is not None:
                self.heap._tracer.on_pool_pop(s)
            return s
        if self._created >= self.max_scopes:
            raise AllocationError("scope pool exhausted")
        self._created += 1
        start = self.heap.alloc_pages(self.scope_pages, owner=self.owner)
        return Scope(self.heap, start, self.scope_pages, owner=self.owner)

    def push(self, scope: Scope) -> None:
        if scope.heap is not self.heap or scope.num_pages != self.scope_pages:
            raise InvalidPointer("scope returned to wrong pool")
        self._free.append(scope)
        if self.heap._tracer is not None:
            self.heap._tracer.on_pool_push(scope)

    def push_sealed(self, scope: Scope, seal_idx: int) -> None:
        """Return a scope whose batched seal release is still pending."""
        if self.seals is None:
            raise InvalidPointer("push_sealed on a pool without a SealManager")
        self._pending.append((scope, self.seals.flush_gen))
        if self.heap._tracer is not None:
            self.heap._tracer.on_pool_push(scope)

    def _reclaim(self) -> None:
        gen = self.seals.flush_gen
        still = []
        for s, g in self._pending:
            if g < gen:  # queued before the last flush ⇒ released
                self._free.append(s)
            else:
                still.append((s, g))
        self._pending = still

    def drain(self) -> None:
        if self._pending and self.seals is not None:
            self.seals.flush()
            self._reclaim()
        for s in self._free:
            s.destroy()
        self._free.clear()
        self._created = 0

    @property
    def outstanding(self) -> int:
        return self._created - len(self._free) - len(self._pending)
