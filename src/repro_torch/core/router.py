"""Cluster router — transparent CXL/RDMA endpoint routing (§4.6–§4.7).

Servers register channels with the orchestrator under hierarchical names
(``/pod0/decode``); clients connect *by name*, and RPCool picks the data
plane — shared CXL memory when the two endpoints sit in the same
coherence domain, the RDMA-style software-coherent fallback when they do
not. The choice is made from the orchestrator's pod registry and
**nothing else**; the programmer-facing call surface is identical either
way (§5.6).

* ``register(name, channel)`` publishes a server channel under a
  hierarchical endpoint name.
* ``connect(name, pid)`` returns a ``RoutedConnection`` — a thin client
  handle bound to the endpoint, wired underneath to a CXL ring
  ``Connection`` (same pod) or a ``FallbackConnection`` (cross pod,
  bridged onto the same live handler table, over the pod pair's shared
  ``LinkPool``).
* ``stub(name, service, pid)`` wraps that handle in a ``ServiceStub``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import addr as gaddr
from .channel import Channel
from .errors import ChannelError
from .fallback import LinkPool
from .orchestrator import Orchestrator, ReproConfig
from .scope import Scope


# the fallback plane's shape (the reference's defaults): pages of each
# link's heap replicas, and descriptor slots of a fallback ring
FALLBACK_PAGES = 4096
FALLBACK_RING_CAPACITY = 64


class ClusterRouter:
    """Names → transports: the layer every client connects through."""

    def __init__(self, orch: Orchestrator):
        self.orch = orch
        # (client pod, server pod, page_size) -> shared LinkPool
        self._link_pools: Dict[Tuple, LinkPool] = {}
        self.endpoints: Dict[str, Channel] = {}
        self._conns: List["RoutedConnection"] = []
        self._lock = threading.RLock()
        # routing stats
        self.n_cxl_connects = 0
        self.n_fallback_connects = 0

    # -- cross-pod link pooling (one shared plane per pod pair) --------------
    def _fallback_pool(self, client_pid: int, server_pid: int,
                       page_size: int) -> LinkPool:
        orch = self.orch
        key = (orch.pod_of(client_pid) or f"pid:{client_pid}",
               orch.pod_of(server_pid) or f"pid:{server_pid}",
               page_size)
        with self._lock:
            pool = self._link_pools.get(key)
            if pool is None:
                cfg = ReproConfig
                pool = LinkPool(
                    num_pages=FALLBACK_PAGES, page_size=page_size,
                    link_latency_us=cfg.fallback_link_latency_us,
                    pool_size=cfg.fallback_pool_size,
                    heap_ids=[orch.alloc_heap_id()
                              for _ in range(cfg.fallback_pool_size)])
                self._link_pools[key] = pool
            return pool

    # -- registration --------------------------------------------------------
    def register(self, name: str, channel: Channel,
                 pod: Optional[str] = None) -> None:
        """Publish ``channel`` under hierarchical endpoint ``name``;
        ``pod`` optionally assigns the serving pid's coherence domain."""
        if not name.startswith("/"):
            raise ChannelError(
                f"endpoint names are hierarchical paths, got {name!r}")
        if pod is not None:
            self.orch.assign_pod(channel.server_pid, pod)
        with self._lock:
            if name in self.endpoints:
                raise ChannelError(f"endpoint {name!r} already registered")
            self.endpoints[name] = channel

    def resolve(self, name: str) -> Channel:
        try:
            return self.endpoints[name]
        except KeyError:
            raise ChannelError(f"no endpoint registered as {name!r}")

    def list_endpoints(self, prefix: str = "/") -> List[str]:
        """Hierarchical listing: every endpoint under ``prefix``."""
        return sorted(n for n in self.endpoints if n.startswith(prefix))

    # -- connection ---------------------------------------------------------
    def connect(self, name: str, pid: int, ring_capacity: int = 256,
                pod: Optional[str] = None) -> "RoutedConnection":
        """Connect ``pid`` to endpoint ``name``; the transport (CXL ring
        vs fallback) is chosen purely from the orchestrator's pod
        metadata for (client pid, endpoint's serving pid)."""
        if pod is not None:
            self.orch.assign_pod(pid, pod)
        rc = RoutedConnection(self, self.resolve(name), pid, ring_capacity)
        with self._lock:
            self._conns.append(rc)
        return rc

    def stub(self, name: str, service, pid: int, ring_capacity: int = 256,
             pod: Optional[str] = None, interceptors=()):
        """Connect ``pid`` to endpoint ``name`` and wrap the routed
        connection in a typed ``ServiceStub`` for ``service``: every
        method becomes a proxy that rides the route the registry picked —
        CXL pointer passing in pod, by-value fallback across pods."""
        from .service import ServiceStub, service_def
        conn = self.connect(name, pid, ring_capacity, pod)
        return ServiceStub(conn, service_def(service), interceptors)

    def stats(self) -> Dict[str, int]:
        return {
            "cxl_connects": self.n_cxl_connects,
            "fallback_connects": self.n_fallback_connects,
            "endpoints": len(self.endpoints),
            "live_connections": len(self._conns),
        }

    def _drop(self, rc: "RoutedConnection") -> None:
        with self._lock:
            if rc in self._conns:
                self._conns.remove(rc)


class RoutedConnection:
    """A client handle bound to an endpoint *name*, not a server.

    Underneath sits either a CXL ring ``Connection`` or a
    ``FallbackConnection``: ``.transport`` is ``"cxl"`` / ``"fallback"``,
    ``.target`` the live object."""

    def __init__(self, router: ClusterRouter, endpoint: Channel,
                 pid: int, ring_capacity: int = 256):
        self.router = router
        self.endpoint = endpoint
        self.client_pid = pid
        self.ring_capacity = ring_capacity
        self.target = None          # Connection | FallbackConnection
        self.transport: Optional[str] = None
        self.closed = False
        self._attach()

    # -- wiring -------------------------------------------------------------
    def _attach(self) -> None:
        ch = self.endpoint
        router = self.router
        if router.orch.same_domain(self.client_pid, ch.server_pid):
            self.target = ch.accept(self.client_pid, self.ring_capacity)
            self.transport = "cxl"
            router.n_cxl_connects += 1
        else:
            pool = router._fallback_pool(self.client_pid, ch.server_pid,
                                         ch.page_size)
            self.target = pool.connect(
                client_pid=self.client_pid, server_pid=ch.server_pid,
                ring_capacity=FALLBACK_RING_CAPACITY,
                functions=ch.functions)  # the SAME live handler table
            # the admission gate guards the SERVICE, not the transport:
            # cross-pod requests shed exactly like same-pod ones
            self.target.admission = ch.admission
            self.transport = "fallback"
            router.n_fallback_connects += 1

    def _ensure(self):
        if self.closed:
            raise ChannelError("call on closed RoutedConnection")
        return self.target

    # -- the identical call surface (§5.6) ------------------------------------
    def call(self, fn_id: int, arg_addr: int = gaddr.NULL, **kw) -> int:
        return self._ensure().call(fn_id, arg_addr, **kw)

    def call_inline(self, fn_id: int, arg_addr: int = gaddr.NULL,
                    **kw) -> int:
        return self._ensure().call_inline(fn_id, arg_addr, **kw)

    def invoke(self, fn_id: int, *args, **kw):
        """Typed invoke bound to the endpoint *name*: pointer passing over
        the CXL ring in pod, the serialized fallback route across pods."""
        return self._ensure().invoke(fn_id, *args, **kw)

    def invoke_stream(self, fn_id: int, *args, **kw):
        """Streaming typed invoke: the reply chain needs the CXL ring
        (streams over the fallback link are not ported)."""
        target = self._ensure()
        if self.transport != "cxl":
            raise ChannelError(
                "invoke_stream needs the CXL ring; streams over the "
                "fallback link are not supported")
        return target.invoke_stream(fn_id, *args, **kw)

    # -- object construction (always against the live target's heap) --------
    def create_scope(self, size_bytes: int) -> Scope:
        return self._ensure().create_scope(size_bytes)

    @property
    def heap(self):
        target = self._ensure()
        return target.heap if self.transport == "cxl" \
            else target.client.heap

    @property
    def marshal_bytes(self) -> int:
        return 0 if self.target is None else self.target.marshal_bytes

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                if self.target is not None:
                    self.target.close()
            finally:
                self.target = None
                self.router._drop(self)
