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

Every call form rides either route: ``invoke``/``call``, pipelined
``invoke_async`` futures (posted on the ring, or staged for the link's
next one-sided flight), ``invoke_stream`` chunk iterators (pushed by the
serve loop, or pulled in staged chunk flights), ``invoke_serialized``
and prebuilt ``build_graph`` argument tuples. The handle returns the
transport's own future or stream.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import addr as gaddr
from ..configs.global_config import ReproConfig, global_config
from .channel import Channel
from .errors import ChannelError
from .fallback import FallbackConnection, LinkPool
from .orchestrator import Orchestrator
from .scope import Scope


class ClusterRouter:
    """Names → transports: the layer every client connects through."""

    def __init__(self, orch: Orchestrator,
                 fallback_pages: Optional[int] = None,
                 fallback_link_latency_us: Optional[float] = None,
                 fallback_ring_capacity: Optional[int] = None,
                 fallback_pool_size: Optional[int] = None,
                 fallback_stripe: Optional[str] = None,
                 fallback_one_sided: Optional[bool] = None,
                 config: Optional[ReproConfig] = None):
        # knob defaults come from the central ReproConfig; an explicit
        # kwarg (anything not None) still overrides per router
        cfg = config or global_config
        self.config = cfg
        self.orch = orch
        self.fallback_pages = cfg.fallback_pages \
            if fallback_pages is None else fallback_pages
        self.fallback_link_latency_us = cfg.fallback_link_latency_us \
            if fallback_link_latency_us is None else fallback_link_latency_us
        self.fallback_ring_capacity = cfg.fallback_ring_capacity \
            if fallback_ring_capacity is None else fallback_ring_capacity
        # cross-pod transport shape: ``fallback_pool_size >= 1`` shares a
        # per-pod-pair LinkPool across every client the router routes to
        # that pod (striped by ``fallback_stripe``); 0 gives each connect
        # a private link. ``fallback_one_sided`` selects cMPI put/get bulk
        # framing vs the send/ack flights.
        self.fallback_pool_size = cfg.fallback_pool_size \
            if fallback_pool_size is None else fallback_pool_size
        self.fallback_stripe = cfg.fallback_stripe \
            if fallback_stripe is None else fallback_stripe
        self.fallback_one_sided = cfg.fallback_one_sided \
            if fallback_one_sided is None else fallback_one_sided
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
                pool = LinkPool(
                    num_pages=self.fallback_pages,
                    page_size=page_size,
                    link_latency_us=self.fallback_link_latency_us,
                    pool_size=self.fallback_pool_size,
                    stripe=self.fallback_stripe,
                    heap_ids=[orch.alloc_heap_id()
                              for _ in range(self.fallback_pool_size)])
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
        orch = router.orch
        if orch.same_domain(self.client_pid, ch.server_pid):
            self.target = ch.accept(self.client_pid, self.ring_capacity)
            self.transport = "cxl"
            router.n_cxl_connects += 1
        else:
            if router.fallback_pool_size >= 1:
                pool = router._fallback_pool(self.client_pid,
                                             ch.server_pid, ch.page_size)
                self.target = pool.connect(
                    client_pid=self.client_pid,
                    server_pid=ch.server_pid,
                    ring_capacity=router.fallback_ring_capacity,
                    functions=ch.functions,  # the SAME live handler table
                    one_sided=router.fallback_one_sided)
            else:
                # one private link per connect
                self.target = FallbackConnection(
                    num_pages=router.fallback_pages,
                    page_size=ch.page_size,
                    link_latency_us=router.fallback_link_latency_us,
                    client_pid=self.client_pid,
                    server_pid=ch.server_pid,
                    ring_capacity=router.fallback_ring_capacity,
                    functions=ch.functions,  # the SAME live handler table
                    heap_id=orch.alloc_heap_id(),
                    one_sided=router.fallback_one_sided)
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

    def invoke_serialized(self, fn_id: int, *args, **kw):
        """The by-value form bound to the endpoint name: the Fig. 11
        serializing baseline on a CXL route, the native copy semantics on
        a fallback route."""
        target = self._ensure()
        if self.transport == "cxl":
            return target.invoke_serialized(fn_id, *args, **kw)
        return target.invoke(fn_id, *args, **kw)

    def invoke_async(self, fn_id: int, *args, **kw):
        """Pipelined typed invoke: the transport's own future — an
        ``RpcFuture`` posted on the ring now, or a ``FallbackRpcFuture``
        staged for the link's next flight."""
        return self._ensure().invoke_async(fn_id, *args, **kw)

    def invoke_stream(self, fn_id: int, *args, **kw):
        """Streaming typed invoke: the transport's own chunk iterator — an
        ``RpcStream`` the serve loop pushes, or a ``FallbackRpcStream``
        pulled in staged chunk flights."""
        return self._ensure().invoke_stream(fn_id, *args, **kw)

    def build_graph(self, *values):
        """Materialize an argument tuple once against the live target's
        heap (see ``marshal.build_graph``)."""
        from .marshal import build_graph
        return build_graph(self._ensure(), *values)

    def call_async(self, fn_id: int, arg_addr: int = gaddr.NULL,
                   **kw) -> Tuple[int, int]:
        target = self._ensure()
        if self.transport != "cxl":
            raise ChannelError(
                "call_async needs the CXL ring; the fallback link is "
                "synchronous request/reply (§5.6 limitation)")
        return target.call_async(fn_id, arg_addr, **kw)

    def wait(self, token: Tuple[int, int], **kw) -> int:
        if self.closed:
            raise ChannelError("wait on closed RoutedConnection")
        return self.target.wait(token, **kw)

    # -- object construction (always against the live target's heap) --------
    def create_scope(self, size_bytes: int) -> Scope:
        return self._ensure().create_scope(size_bytes)

    def new_bytes(self, data: bytes, scope: Optional[Scope] = None) -> int:
        return self._ensure().new_bytes(data, scope)

    def scope_pool(self, scope_pages: int = 1):
        target = self._ensure()
        if self.transport != "cxl":
            raise ChannelError("scope_pool is a CXL-path amortization")
        return target.scope_pool(scope_pages)

    @property
    def heap(self):
        target = self._ensure()
        return target.heap if self.transport == "cxl" \
            else target.client.heap

    @property
    def seals(self):
        return self._ensure().seals

    @property
    def n_calls(self) -> int:
        return 0 if self.target is None else self.target.n_calls

    @property
    def n_invokes(self) -> int:
        return 0 if self.target is None else self.target.n_invokes

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
