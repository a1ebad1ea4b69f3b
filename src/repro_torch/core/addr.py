"""Global address space for RPCool heaps.

The orchestrator assigns every heap a cluster-unique id, so a pointer
stored by one process stays valid in any other process that maps the
heap (§4.1 "Shared memory heaps"). The pointer is a packed 64-bit
``GlobalAddr``::

    [ heap_id : 16 | page : 24 | offset : 24 ]

* ``heap_id`` is assigned by the orchestrator and unique per cluster.
* ``page`` indexes the heap's fixed-size page array.
* ``offset`` is a byte offset within the page.

``NULL`` is all-ones, never a valid address (heap_id 0xFFFF is reserved).
The packing is the reference package's, bit for bit: a graph built by
either package holds the same words.
"""

from __future__ import annotations

from typing import NamedTuple

HEAP_BITS = 16
PAGE_BITS = 24
OFF_BITS = 24

MAX_HEAPS = (1 << HEAP_BITS) - 1  # top id reserved for NULL
MAX_PAGES = 1 << PAGE_BITS
MAX_OFFSET = 1 << OFF_BITS

NULL = (1 << (HEAP_BITS + PAGE_BITS + OFF_BITS)) - 1


class Addr(NamedTuple):
    heap_id: int
    page: int
    offset: int

    def pack(self) -> int:
        return pack(self.heap_id, self.page, self.offset)


def pack(heap_id: int, page: int, offset: int = 0) -> int:
    if not (0 <= heap_id < MAX_HEAPS):
        raise ValueError(f"heap_id out of range: {heap_id}")
    if not (0 <= page < MAX_PAGES):
        raise ValueError(f"page out of range: {page}")
    if not (0 <= offset < MAX_OFFSET):
        raise ValueError(f"offset out of range: {offset}")
    return (heap_id << (PAGE_BITS + OFF_BITS)) | (page << OFF_BITS) | offset


def unpack(addr: int) -> Addr:
    if addr == NULL:
        raise ValueError("dereference of NULL GlobalAddr")
    return Addr(
        heap_id=(addr >> (PAGE_BITS + OFF_BITS)) & ((1 << HEAP_BITS) - 1),
        page=(addr >> OFF_BITS) & ((1 << PAGE_BITS) - 1),
        offset=addr & ((1 << OFF_BITS) - 1),
    )


def is_null(addr: int) -> bool:
    return addr == NULL


def heap_of(addr: int) -> int:
    return (addr >> (PAGE_BITS + OFF_BITS)) & ((1 << HEAP_BITS) - 1)


def page_of(addr: int) -> int:
    return (addr >> OFF_BITS) & ((1 << PAGE_BITS) - 1)


def offset_of(addr: int) -> int:
    return addr & ((1 << OFF_BITS) - 1)


_PAGE_MASK = MAX_PAGES - 1
_OFF_MASK = MAX_OFFSET - 1
_HEAP_SHIFT = PAGE_BITS + OFF_BITS
_HEAP_FIELD = ((1 << HEAP_BITS) - 1) << _HEAP_SHIFT


def add(addr: int, nbytes: int, page_size: int) -> int:
    """Pointer arithmetic within a heap: advance ``addr`` by ``nbytes``,
    carrying across page boundaries (scopes are contiguous page ranges,
    §5.1). Shift/mask arithmetic only: it sits under every container
    dereference on the RPC path."""
    if addr == NULL:
        raise ValueError("dereference of NULL GlobalAddr")
    lin = ((addr >> OFF_BITS) & _PAGE_MASK) * page_size \
        + (addr & _OFF_MASK) + nbytes
    page = lin // page_size
    if page >= MAX_PAGES:   # never carry into the heap_id bits
        raise ValueError(f"address arithmetic past heap end: page {page}")
    return (addr & _HEAP_FIELD) \
        | (page << OFF_BITS) | (lin % page_size)


def linear(addr: int, page_size: int) -> int:
    """Byte offset of ``addr`` within its heap's linear byte space."""
    if addr == NULL:
        raise ValueError("dereference of NULL GlobalAddr")
    return ((addr >> OFF_BITS) & _PAGE_MASK) * page_size \
        + (addr & _OFF_MASK)
