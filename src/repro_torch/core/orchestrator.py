"""Global orchestrator — heap ids, leases and page quotas (§4.6, §5.4).

The parts of the control plane the serving slice runs on: it assigns heap
ids, grants the *leases* a process renews while it has a heap mapped, and
holds the §5.4 pool-page quotas the KV pool enforces. Time is injected
(``clock``); production uses ``time.monotonic``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from .heap import SharedHeap

DEFAULT_LEASE_TTL = 5.0  # seconds


@dataclass
class Lease:
    pid: int
    heap_id: int
    expires: float
    live: bool = True


class Orchestrator:
    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 lease_ttl: float = DEFAULT_LEASE_TTL):
        self.clock = clock or time.monotonic
        self.lease_ttl = lease_ttl

        self._next_heap_id = 1
        self.heaps: Dict[int, SharedHeap] = {}
        self._leases: Dict[Tuple[int, int], Lease] = {}  # (pid, heap) -> lease
        # §5.4 pool-page quotas: pid -> max pages owned at once inside a
        # registered pool heap; the pool's allocator enforces it
        self._page_quota: Dict[int, int] = {}

    # -- heap lifecycle ------------------------------------------------------
    def create_heap(self, num_pages: int, page_size: int = 4096,
                    name: str = "") -> SharedHeap:
        hid = self._next_heap_id
        self._next_heap_id += 1
        heap = SharedHeap(hid, num_pages, page_size, name=name)
        self.heaps[hid] = heap
        return heap

    def map_heap(self, pid: int, heap: SharedHeap) -> Lease:
        """Map a heap into a process — grants a lease."""
        lease = Lease(pid, heap.heap_id, self.clock() + self.lease_ttl)
        self._leases[(pid, heap.heap_id)] = lease
        return lease

    def renew(self, pid: int) -> int:
        """Periodic lease renewal for every heap of ``pid``."""
        now = self.clock()
        n = 0
        for (p, _h), lease in self._leases.items():
            if p == pid and lease.live:
                lease.expires = now + self.lease_ttl
                n += 1
        return n

    def set_page_quota(self, pid: int, max_pages: Optional[int]) -> None:
        """Cap how many pool pages ``pid`` may own at once (``None``
        clears the cap)."""
        if max_pages is None:
            self._page_quota.pop(pid, None)
        else:
            self._page_quota[pid] = int(max_pages)

    def page_quota(self, pid: int) -> Optional[int]:
        return self._page_quota.get(pid)
