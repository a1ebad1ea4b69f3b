"""Global orchestrator — leases, quotas, registry, failure GC (§4.6, §5.4).

The cluster-level control plane: it assigns heap ids (hence
globally-unique address spaces), registers channels under hierarchical
names, tracks which process has which heap mapped via *leases*, enforces
per-process shared-memory byte quotas and holds the request and
pool-page quota tables (§5.4), and garbage-collects orphaned heaps when
every lease on them has lapsed. It also keeps the *coherence-domain*
registry: two processes share hardware cache coherence iff they are in
the same pod. ``ClusterRouter`` consults exactly this metadata to choose
between the CXL ring and the fallback transport.

Time is injected (``clock``) so tests drive lease expiry
deterministically; production uses ``time.monotonic``.

Failure model (Fig. 5):
  (a) server crash → its leases lapse → the orchestrator notifies
      connected clients; the heap survives while any client still holds
      a lease and is reclaimed when the last lease closes.
  (b) client hoarding heaps from dead servers → the quota forces it to
      return heaps before mapping new ones.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from .errors import ChannelError, QuotaExceeded
from .heap import SharedHeap

DEFAULT_LEASE_TTL = 5.0  # seconds; the router renews at ttl/2


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
        # pid mint for processes the orchestrator brings up itself (warm
        # replicas restored from a snapshot): a high base, so it never
        # collides with caller-chosen pids
        self._next_pid = 1_000_000
        self.heaps: Dict[int, SharedHeap] = {}
        self.channels: Dict[str, object] = {}  # name -> Channel
        self._leases: Dict[Tuple[int, int], Lease] = {}  # (pid, heap) -> lease
        self._mapped: Dict[int, Set[int]] = {}  # pid -> heap ids
        self._quota: Dict[int, int] = {}  # pid -> max mapped bytes
        # §5.4 request quotas: pid -> admitted requests/second; the
        # servers' AdmissionInterceptor enforces them pre-dispatch
        self._req_quota: Dict[int, float] = {}
        # §5.4 pool-page quotas: pid -> max pages owned at once inside a
        # registered pool heap; the pool's allocator enforces it
        self._page_quota: Dict[int, int] = {}
        # pod -> shared pool (the KV pool serving that pod): a byref
        # argument crossing pods resolves its destination pages here
        self._pod_pools: Dict[str, object] = {}
        # coherence domains: pod name -> member pids (§4.6)
        self.pods: Dict[str, Set[int]] = {}
        self._pod_of: Dict[int, str] = {}
        self._failure_cbs: List[Callable[[int, int], None]] = []
        # stats
        self.reclaimed_heaps = 0
        self.expired_leases = 0

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

    def alloc_pid(self) -> int:
        """A fresh process id for an orchestrator-spawned worker (a
        restored snapshot replica); monotonically unique per instance."""
        pid = self._next_pid
        self._next_pid += 1
        return pid

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
        """Map a heap into a process — checks the byte quota, grants a
        lease."""
        quota = self._quota.get(pid)
        mapped = self._mapped.setdefault(pid, set())
        if quota is not None:
            projected = sum(
                self.heaps[h].num_pages * self.heaps[h].page_size
                for h in mapped | {heap.heap_id}
                if h in self.heaps
            )
            if projected > quota:
                raise QuotaExceeded(
                    f"pid {pid}: mapping heap {heap.heap_id} "
                    f"({projected}B) exceeds quota {quota}B; "
                    "close existing channels first (§5.4)"
                )
        lease = Lease(pid, heap.heap_id, self.clock() + self.lease_ttl)
        self._leases[(pid, heap.heap_id)] = lease
        mapped.add(heap.heap_id)
        return lease

    def unmap_heap(self, pid: int, heap_id: int) -> None:
        self._leases.pop((pid, heap_id), None)
        self._mapped.get(pid, set()).discard(heap_id)
        self._maybe_reclaim(heap_id)

    def renew(self, pid: int) -> int:
        """Periodic lease renewal for every heap of ``pid``."""
        now = self.clock()
        n = 0
        for (p, _h), lease in self._leases.items():
            if p == pid and lease.live:
                lease.expires = now + self.lease_ttl
                n += 1
        return n

    def set_quota(self, pid: int, max_bytes: int) -> None:
        self._quota[pid] = max_bytes

    def set_request_quota(self, pid: int,
                          per_second: Optional[float]) -> None:
        """§5.4 traffic quota: cap the request rate the cluster admits
        from ``pid`` (``None`` clears the cap). The servers'
        ``AdmissionInterceptor`` token buckets enforce it on this
        orchestrator's ``clock``."""
        if per_second is None:
            self._req_quota.pop(pid, None)
        else:
            self._req_quota[pid] = float(per_second)

    def request_quota(self, pid: int) -> Optional[float]:
        return self._req_quota.get(pid)

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

    def mapped_bytes(self, pid: int) -> int:
        return sum(
            self.heaps[h].num_pages * self.heaps[h].page_size
            for h in self._mapped.get(pid, set())
            if h in self.heaps
        )

    # -- failure handling ------------------------------------------------------
    def on_failure(self, cb: Callable[[int, int], None]) -> None:
        """cb(pid, heap_id) fired when a lease expires."""
        self._failure_cbs.append(cb)

    def expire_leases(self, pid: int) -> int:
        """Force every live lease of ``pid`` to lapse on the next
        ``tick()``: the deterministic form of "the process died" (Fig.
        5a), without waiting out the TTL. Returns the leases marked."""
        n = 0
        for (p, _h), lease in self._leases.items():
            if p == pid and lease.live:
                lease.expires = float("-inf")
                n += 1
        return n

    def tick(self) -> List[Tuple[int, int]]:
        """Expire lapsed leases, notify peers, GC orphaned heaps. Returns
        the (pid, heap_id) leases that expired this tick."""
        now = self.clock()
        expired = []
        for key, lease in list(self._leases.items()):
            if lease.live and lease.expires < now:
                lease.live = False
                expired.append(key)
        for pid, heap_id in expired:
            self.expired_leases += 1
            del self._leases[(pid, heap_id)]
            self._mapped.get(pid, set()).discard(heap_id)
            for cb in self._failure_cbs:
                cb(pid, heap_id)
            self._maybe_reclaim(heap_id)
        return expired

    def _maybe_reclaim(self, heap_id: int) -> None:
        if heap_id not in self.heaps:
            return
        if any(h == heap_id and lease.live
               for (_, h), lease in self._leases.items()):
            return
        # the last process accessing the heap is gone → reclaim (§5.4)
        del self.heaps[heap_id]
        self.reclaimed_heaps += 1

    def live_leases(self, heap_id: Optional[int] = None) -> int:
        return sum(
            1 for (_, h), lease in self._leases.items()
            if lease.live and (heap_id is None or h == heap_id)
        )
