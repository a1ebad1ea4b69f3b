"""Global address space for RPCool heaps (the parts the serving slice uses).

A ``GlobalAddr`` is a packed 64-bit integer::

    [ heap_id : 16 | page : 24 | offset : 24 ]

so a heap holds at most ``MAX_PAGES`` pages. The slice hands page ids,
not packed addresses, to the kernels; the RPC plane's slice brings the
packing back with the ring.
"""

from __future__ import annotations

HEAP_BITS = 16
PAGE_BITS = 24
OFF_BITS = 24

MAX_PAGES = 1 << PAGE_BITS
