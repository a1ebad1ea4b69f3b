"""Global orchestrator — heap ids, leases, quotas, pods and the channel
registry (§4.6, §5.4).

The parts of the control plane the serving slice and its RPC plane run
on: it assigns heap ids (hence globally-unique address spaces), grants
the *leases* a process holds while it has a heap mapped, holds the §5.4
pool-page quotas the KV pool enforces, registers channels under
hierarchical names, and keeps the *coherence-domain* registry: two
processes share hardware cache coherence iff they are in the same pod.
``ClusterRouter`` consults exactly this metadata to choose between the
CXL ring and the fallback transport. Time is injected (``clock``);
production uses ``time.monotonic``. The plane's tuning defaults live in
``repro_torch.configs.global_config``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set, Tuple

from .errors import ChannelError
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
        self.channels: Dict[str, object] = {}  # name -> Channel
        self._leases: Dict[Tuple[int, int], Lease] = {}  # (pid, heap) -> lease
        self._mapped: Dict[int, Set[int]] = {}  # pid -> heap ids
        # §5.4 pool-page quotas: pid -> max pages owned at once inside a
        # registered pool heap; the pool's allocator enforces it
        self._page_quota: Dict[int, int] = {}
        # pod -> shared pool (the KV pool serving that pod): a byref
        # argument crossing pods resolves its destination pages here
        self._pod_pools: Dict[str, object] = {}
        # coherence domains: pod name -> member pids (§4.6)
        self.pods: Dict[str, Set[int]] = {}
        self._pod_of: Dict[int, str] = {}

    # -- coherence domains ---------------------------------------------------
    def assign_pod(self, pid: int, pod: str) -> None:
        """Place ``pid`` in coherence domain ``pod`` (one pod per pid)."""
        old = self._pod_of.get(pid)
        if old is not None:
            self.pods[old].discard(pid)
        self._pod_of[pid] = pod
        self.pods.setdefault(pod, set()).add(pid)

    def pod_of(self, pid: int) -> Optional[str]:
        return self._pod_of.get(pid)

    def same_domain(self, pid_a: int, pid_b: int) -> bool:
        """True iff the two processes share hardware cache coherence. A
        pid with no pod assignment is treated as local."""
        pa, pb = self._pod_of.get(pid_a), self._pod_of.get(pid_b)
        return pa is None or pb is None or pa == pb

    def alloc_heap_id(self) -> int:
        """Reserve a cluster-unique heap id without creating a heap here
        (the fallback transport instantiates its own replica pair)."""
        hid = self._next_heap_id
        self._next_heap_id += 1
        return hid

    # -- heap lifecycle ------------------------------------------------------
    def create_heap(self, num_pages: int, page_size: int = 4096,
                    name: str = "") -> SharedHeap:
        hid = self.alloc_heap_id()
        heap = SharedHeap(hid, num_pages, page_size, name=name)
        self.heaps[hid] = heap
        return heap

    def map_heap(self, pid: int, heap: SharedHeap) -> Lease:
        """Map a heap into a process — grants a lease."""
        lease = Lease(pid, heap.heap_id, self.clock() + self.lease_ttl)
        self._leases[(pid, heap.heap_id)] = lease
        self._mapped.setdefault(pid, set()).add(heap.heap_id)
        return lease

    def unmap_heap(self, pid: int, heap_id: int) -> None:
        self._leases.pop((pid, heap_id), None)
        self._mapped.get(pid, set()).discard(heap_id)
        if heap_id in self.heaps and not any(
                h == heap_id and lease.live
                for (_, h), lease in self._leases.items()):
            # the last process mapping the heap is gone → reclaim (§5.4)
            del self.heaps[heap_id]

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

    # -- pod pool registry (cross-pod byref resolution) ------------------------
    def register_pool(self, pod: str, pool: object) -> None:
        """Publish ``pool`` as coherence domain ``pod``'s shared pool."""
        self._pod_pools[pod] = pool

    def pool_of_pod(self, pod: str) -> object:
        try:
            return self._pod_pools[pod]
        except KeyError:
            raise ChannelError(f"no pool registered for pod {pod!r}")

    # -- channel registry ------------------------------------------------------
    def register_channel(self, name: str, channel: object) -> None:
        if name in self.channels:
            raise ChannelError(f"channel {name!r} already registered")
        self.channels[name] = channel

    def lookup_channel(self, name: str) -> object:
        try:
            return self.channels[name]
        except KeyError:
            raise ChannelError(f"no such channel {name!r}")

    def unregister_channel(self, name: str) -> None:
        self.channels.pop(name, None)
