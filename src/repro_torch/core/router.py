"""Cluster router — transparent CXL/RDMA endpoint routing (§4.6–§4.7).

Servers register channels with the orchestrator under hierarchical names
(``/pod0/decode``); clients connect *by name*, and RPCool picks the data
plane — shared CXL memory when the two endpoints sit in the same
coherence domain, the RDMA-style software-coherent fallback when they do
not. The choice is made from the orchestrator's pod registry and
**nothing else**; the programmer-facing call surface is identical either
way (§5.6).

``ClusterRouter`` is that composition layer:

* ``register(name, channel)`` publishes a server channel under a
  hierarchical endpoint name; registering a second channel under the same
  name appends a *replica* (the Fig. 5 failover target).
* ``connect(name, pid)`` returns a ``RoutedConnection`` — a thin client
  handle bound to the endpoint *name*, wired underneath to either a CXL
  ring ``Connection`` (same pod) or a ``FallbackConnection`` (cross pod,
  bridged onto the same live handler table, over the pod pair's shared
  ``LinkPool``). ``stub(name, service, pid)`` wraps it in a
  ``ServiceStub``; ``balance=`` spreads a stub over the replica chain
  (``BalancedConnection``), and a trailing-``*`` name binds every
  endpoint under a prefix (``WildcardConnection``).
* Leases of every pid that registered or connected are auto-renewed at
  ttl/2 (librpcool's renewal cadence): deterministically via ``pump()``
  with an injected clock, or by a background thread
  (``start_auto_renew``) in wall-clock deployments.
* A lease lapse on an endpoint's serving pid (Fig. 5a server crash)
  fires the orchestrator failure callback; the router fails the endpoint
  over to the next replica and every live ``RoutedConnection`` re-wires
  itself on its next call. ``migrate`` moves a live endpoint onto a warm
  replica restored from its snapshot, in one generation bump.

Failover re-wires the *descriptor plane* only: scopes/objects a client
allocated in the dead server's connection heap are gone with it (the
paper's leases reclaim that heap) — callers re-create argument scopes
after a failover, which ``RoutedConnection.create_scope`` does naturally
since it always allocates against the live target.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import addr as gaddr
from .channel import Channel, Connection
from .errors import ChannelError, DeadlineExceeded, InvalidPointer, \
    Overloaded
from .fallback import FallbackConnection, LinkPool
from .orchestrator import Orchestrator
from .scope import Scope
from ..configs.global_config import ReproConfig, global_config

# What the failover-retry guards treat as "the old wire died under this
# call". A bare InvalidPointer normally surfaces (it is a caller bug),
# but when the endpoint's generation moved mid-call it means the reply
# or argument pages were reclaimed with the migrated-away/dead server —
# the same condition the lease machinery signals with ChannelError.
_FAILOVER_ERRORS = (ChannelError, InvalidPointer)


@dataclass
class EndpointRecord:
    """A hierarchical name bound to a primary channel + replica chain.

    (The router's *registry record*; the serve-side lifecycle handle is
    ``repro_torch.core.lifecycle.Endpoint``.)"""

    name: str
    chain: List[Channel] = field(default_factory=list)
    active_idx: int = 0
    generation: int = 0   # bumped on every failover
    dead: bool = False    # primary and every replica lapsed

    @property
    def channel(self) -> Channel:
        return self.chain[self.active_idx]

    @property
    def replicas(self) -> List[Channel]:
        return self.chain[1:]


@dataclass
class MigrationReport:
    """What ``ClusterRouter.migrate`` did, for gates and ops logs."""

    name: str
    src_channel: str
    dst_channel: str
    src_pid: int
    dst_pid: int
    dst_pod: Optional[str]
    generation_before: int
    generation_after: int
    drained: bool            # source went idle within the drain budget
    shed_during_drain: int   # typed Overloaded sheds while quiesced
    synced_attrs: int        # stop-and-copy attributes re-synced
    duration_s: float
    restored: object = None  # the RestoredEndpoint now serving

    @property
    def handoff_epochs(self) -> int:
        """Generation bumps this migration cost (the gate: exactly 1)."""
        return self.generation_after - self.generation_before


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
        self.endpoints: Dict[str, EndpointRecord] = {}
        self._conns: List["RoutedConnection"] = []
        # serving pids whose lease lapsed (Fig. 5a): the replica
        # balancer drops these from its live set; re-registering a
        # channel for the pid revives it
        self._dead_pids: Set[int] = set()
        self._lock = threading.RLock()
        # lease renewal bookkeeping: pid -> clock() of the last renewal
        self._renew_last: Dict[int, float] = {}
        self._renew_stop = threading.Event()
        self._renew_thread: Optional[threading.Thread] = None
        # routing stats
        self.n_cxl_connects = 0
        self.n_fallback_connects = 0
        self.n_failovers = 0
        self.n_migrations = 0
        orch.on_failure(self._on_lease_lapse)

    # -- cross-pod link pooling (one shared plane per pod pair) --------------
    def _fallback_pool(self, client_pid: int, server_pid: int,
                       page_size: int) -> LinkPool:
        """The pod pair's shared LinkPool: every client the router routes
        from ``client_pid``'s pod to ``server_pid``'s pod rides the same
        striped DSMLink set instead of minting a private link."""
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
                 pod: Optional[str] = None) -> EndpointRecord:
        """Publish ``channel`` under hierarchical endpoint ``name``.

        ``pod`` optionally assigns the serving pid's coherence domain at
        the same time. Registering a second channel under an existing
        name appends it to the replica chain (Fig. 5 failover target);
        registering onto a fully-dead endpoint revives it.
        """
        if not name.startswith("/"):
            raise ChannelError(
                f"endpoint names are hierarchical paths, got {name!r}")
        if pod is not None:
            self.orch.assign_pod(channel.server_pid, pod)
        with self._lock:
            ep = self.endpoints.get(name)
            if ep is None:
                ep = EndpointRecord(name, [channel])
                self.endpoints[name] = ep
            elif channel not in ep.chain:
                ep.chain.append(channel)
                if ep.dead:  # revived by a fresh replica
                    ep.dead = False
                    ep.active_idx = len(ep.chain) - 1
                    ep.generation += 1
            self._dead_pids.discard(channel.server_pid)
            self._track(channel.server_pid)
        return ep

    def resolve(self, name: str) -> EndpointRecord:
        try:
            return self.endpoints[name]
        except KeyError:
            raise ChannelError(f"no endpoint registered as {name!r}")

    def list_endpoints(self, prefix: str = "/") -> List[str]:
        """Hierarchical listing: every endpoint under ``prefix``."""
        return sorted(n for n in self.endpoints if n.startswith(prefix))

    # -- connection ---------------------------------------------------------
    def connect(self, name: str, pid: int, ring_capacity: int = 256,
                pod: Optional[str] = None):
        """Connect ``pid`` to endpoint ``name``; the transport (CXL ring
        vs RDMA-style fallback) is chosen purely from the orchestrator's
        pod metadata for (client pid, endpoint's serving pid).

        A trailing-``*`` name (``"/pod0/kv/*"``) returns a
        ``WildcardConnection`` over every endpoint under the prefix —
        resolved per dispatch via ``list_endpoints``, so siblings that
        appear, drain, or migrate after the connect are picked up without
        hardcoding names or pids."""
        if pod is not None:
            self.orch.assign_pod(pid, pod)
        if name.endswith("*"):
            wc = WildcardConnection(self, name, pid, ring_capacity)
            with self._lock:
                self._track(pid)
            return wc
        ep = self.resolve(name)
        rc = RoutedConnection(self, ep, pid, ring_capacity)
        with self._lock:
            self._conns.append(rc)
            self._track(pid)
        return rc

    def stub(self, name: str, service, pid: int, ring_capacity: int = 256,
             pod: Optional[str] = None, interceptors=(),
             balance: Optional[str] = None, balance_seed: int = 0):
        """Connect ``pid`` to endpoint ``name`` and wrap the routed
        connection in a typed ``ServiceStub`` for ``service`` (a
        ``@service`` class/instance or a ``ServiceDef``): every method
        becomes a callable proxy (``stub.get(k)`` / ``stub.get.future(k)``)
        that rides the route the registry picked — CXL pointer passing in
        pod, by-value fallback across pods, transparent failover in
        between. The raw ``connect``+``invoke`` surface stays underneath
        as the escape hatch (``stub.connection``).

        ``balance`` turns the endpoint's replica chain from a failover
        chain into a load-spread set: ``"power2"`` (two random live
        replicas, dispatch to the one with fewer in-flight calls) or
        ``"rr"`` (round-robin). Failover stays as the degraded mode —
        dead replicas drop out of the live set — and streams stay pinned
        to one replica. ``balance_seed`` makes replica picks
        reproducible."""
        from .service import ServiceStub, service_def
        if balance is not None and name.endswith("*"):
            raise ChannelError(
                "wildcard stubs pick an endpoint per dispatch already — "
                "combine balance= with a concrete endpoint name")
        if balance is None:
            conn = self.connect(name, pid, ring_capacity, pod)
        else:
            if pod is not None:
                self.orch.assign_pod(pid, pod)
            conn = BalancedConnection(self, self.resolve(name), pid,
                                      ring_capacity, balance=balance,
                                      seed=balance_seed)
            with self._lock:
                self._track(pid)
        return ServiceStub(conn, service_def(service), interceptors)

    def stats(self) -> Dict[str, int]:
        return {
            "cxl_connects": self.n_cxl_connects,
            "fallback_connects": self.n_fallback_connects,
            "failovers": self.n_failovers,
            "endpoints": len(self.endpoints),
            "live_connections": len(self._conns),
        }

    # -- lease renewal (librpcool's ttl/2 heartbeat) -------------------------
    def _track(self, pid: int) -> None:
        self._renew_last.setdefault(pid, self.orch.clock())

    def mark_crashed(self, pid: int) -> None:
        """Stop heartbeating for ``pid`` (test/ops hook: the process died;
        its leases will lapse and Fig. 5 reclamation takes over)."""
        with self._lock:
            self._renew_last.pop(pid, None)

    def pump(self) -> int:
        """One heartbeat step: renew every tracked pid whose last renewal
        is ≥ ttl/2 old, then run the orchestrator's expiry tick (which
        fires failure callbacks → failover). Deterministic under an
        injected clock; the auto-renew thread just calls this. Returns
        the number of pids renewed."""
        now = self.orch.clock()
        half = self.orch.lease_ttl / 2.0
        renewed = 0
        with self._lock:
            due = [pid for pid, last in self._renew_last.items()
                   if now - last >= half]
            for pid in due:
                self.orch.renew(pid)
                self._renew_last[pid] = now
                renewed += 1
        self.orch.tick()
        return renewed

    def start_auto_renew(self, interval_s: Optional[float] = None) -> None:
        """Wall-clock deployments: heartbeat from a daemon thread every
        ttl/2 (or ``interval_s``). Use ``pump()`` directly when driving
        an injected clock."""
        if self._renew_thread is not None and self._renew_thread.is_alive():
            return
        interval = interval_s if interval_s is not None \
            else self.orch.lease_ttl / 2.0
        self._renew_stop.clear()

        def _loop() -> None:
            while not self._renew_stop.wait(interval):
                self.pump()

        t = threading.Thread(target=_loop, daemon=True,
                             name="rpcool-lease-renew")
        self._renew_thread = t
        t.start()

    def stop_auto_renew(self, timeout: float = 2.0) -> None:
        self._renew_stop.set()
        t = self._renew_thread
        if t is not None:
            t.join(timeout)
        self._renew_thread = None

    # -- failure handling (Fig. 5a) ------------------------------------------
    def _on_lease_lapse(self, pid: int, heap_id: int) -> None:
        """Orchestrator failure callback: if the lapsed lease belongs to
        a pid serving any endpoint replica, record it dead (the balancer
        drops it from its live set); if it was the *active* channel,
        fail the endpoint over."""
        with self._lock:
            for ep in self.endpoints.values():
                if any(ch.server_pid == pid for ch in ep.chain):
                    self._dead_pids.add(pid)
                if not ep.dead and ep.channel.server_pid == pid:
                    self._fail_over(ep, pid)

    def _fail_over(self, ep: EndpointRecord, dead_pid: int) -> None:
        # skip over every replica known dead, not just the pid that
        # lapsed now — a standby that died earlier must not become the
        # active target
        while ep.channel.server_pid == dead_pid or \
                ep.channel.server_pid in self._dead_pids:
            if ep.active_idx + 1 >= len(ep.chain):
                ep.dead = True
                break
            ep.active_idx += 1
        ep.generation += 1
        self.n_failovers += 1

    def _drop(self, rc: "RoutedConnection") -> None:
        with self._lock:
            if rc in self._conns:
                self._conns.remove(rc)

    # -- live migration (snapshot → warm replica → drain → handoff) ----------
    def migrate(self, name: str, dst_pod: Optional[str] = None, *,
                server_pid: Optional[int] = None,
                drain_timeout_s: Optional[float] = None,
                interceptors=None,
                close_source: bool = True) -> "MigrationReport":
        """Move a live endpoint to ``dst_pod`` without dropping traffic.

        The sequence is pre-copy live migration over the §5.4 machinery:

        1. **snapshot** the active channel (source keeps serving);
        2. **restore** it as a warm replica on ``dst_pod`` — registered
           on the endpoint's chain, served by its own lifecycle handle;
        3. **quiesce** the source: new admissions shed typed
           ``Overloaded`` (with a retry-after hint), in-flight work keeps
           running; the quiesce gate is also pushed onto live fallback
           targets, whose admission hook is captured at attach time;
        4. **drain**: wait (bounded by ``drain_timeout_s``, default
           ``config.migrate_drain_timeout_s``) for posted slots to be
           served and stream chunk-chains to end;
        5. **stop-and-copy**: re-sync service state mutated since the
           snapshot onto the warm replica;
        6. **handoff**: swap the replica in as the active channel and
           bump the endpoint generation exactly once — every
           ``RoutedConnection`` re-wires on its next call, unsettled
           ``RoutedRpcFuture``s re-invoke against the replica, and
           still-open streams surface the documented mid-stream
           ``ChannelError``.

        ``close_source=True`` then retires the source: through its
        lifecycle ``Endpoint`` handle when it has one, else via
        ``Channel.destroy()`` (if a caller-owned ``ServerLoop`` is still
        sweeping the source, detach it first or pass
        ``close_source=False``).
        """
        from .lifecycle import QuiesceGate, _channel_busy
        from .snapshot import restore, snapshot, sync_state
        cfg = self.config
        t0 = time.monotonic()
        with self._lock:
            ep = self.resolve(name)
            if ep.dead:
                raise ChannelError(
                    f"cannot migrate {name!r}: endpoint is dead "
                    "(register a replica to revive it)")
            src = ep.channel
            gen_before = ep.generation
        # 1–2. pre-copy: checkpoint + warm replica while source serves
        snap = snapshot(src)
        restored = restore(snap, pod=dst_pod, router=self, name=name,
                           server_pid=server_pid,
                           interceptors=interceptors, start=True)
        dst = restored.channel
        # 3. quiesce the source (new requests shed typed Overloaded)
        gate = QuiesceGate(src.admission,
                           retry_after_s=cfg.migrate_retry_after_s)
        src.admission = gate
        with self._lock:
            for rc in self._conns:
                # fallback targets capture the gate at attach time —
                # push the quiesce gate onto every live one bridged to
                # the source's handler table
                if rc.transport == "fallback" and rc.target is not None \
                        and rc.target.functions is src.functions:
                    rc.target.admission = gate
        # 4. drain: the source's serve loop settles what is in flight
        timeout = cfg.migrate_drain_timeout_s \
            if drain_timeout_s is None else drain_timeout_s
        deadline = time.monotonic() + timeout
        drained = False
        while time.monotonic() < deadline:
            if not _channel_busy(src):
                drained = True
                break
            time.sleep(200e-6)
        # 5. stop-and-copy: writes since the snapshot land on the replica
        synced = sync_state(src.served_instance, restored.instance)
        # 6. handoff: retire the source from the chain, ONE epoch bump
        with self._lock:
            if src in ep.chain:
                ep.chain.remove(src)
            if dst not in ep.chain:
                ep.chain.append(dst)
            ep.active_idx = ep.chain.index(dst)
            ep.dead = False
            ep.generation += 1
            self.n_migrations += 1
            src_pid = src.server_pid
            if not any(ch.server_pid == src_pid
                       for e2 in self.endpoints.values()
                       for ch in e2.chain):
                # nothing serves from the old pid anymore: the balancer
                # must stop considering it (re-registering revives it)
                self._dead_pids.add(src_pid)
            gen_after = ep.generation
        if close_source:
            if src.lifecycle is not None:
                src.lifecycle.close(timeout_s=timeout)
            else:
                src.destroy()
        return MigrationReport(
            name=name, src_channel=src.name, dst_channel=dst.name,
            src_pid=src_pid, dst_pid=dst.server_pid, dst_pod=dst_pod,
            generation_before=gen_before, generation_after=gen_after,
            drained=drained, shed_during_drain=gate.n_shed,
            synced_attrs=synced,
            duration_s=time.monotonic() - t0, restored=restored)


class RoutedConnection:
    """A client handle bound to an endpoint *name*, not a server.

    Underneath sits either a CXL ring ``Connection`` or a
    ``FallbackConnection`` (``.transport`` is ``"cxl"`` / ``"fallback"``,
    ``.target`` the live object). When the endpoint fails over, the stale
    target is dropped and the next call transparently re-wires against
    the replica — re-running the same pod-metadata routing decision, so a
    replica in another pod correctly comes up on the fallback transport.
    """

    def __init__(self, router: ClusterRouter, endpoint: EndpointRecord,
                 pid: int, ring_capacity: int = 256,
                 pin_idx: Optional[int] = None):
        self.router = router
        self.endpoint = endpoint
        self.client_pid = pid
        self.ring_capacity = ring_capacity
        self.target = None          # Connection | FallbackConnection
        self.transport: Optional[str] = None
        self.generation = -1
        self.failovers = 0
        self.closed = False
        # pinned handles (replica balancing): bound to chain[pin_idx]
        # instead of the active channel — they never re-wire on
        # failover; replica death surfaces to the balancer instead
        self.pin_idx = pin_idx
        # heaps of targets this handle abandoned on failover/re-route:
        # GraphRefs built against them are stale (lease-reclaimed)
        self._dead_heaps: List = []
        self._attach()

    # -- wiring -------------------------------------------------------------
    def _attach(self) -> None:
        ep = self.endpoint
        if self.pin_idx is None:
            if ep.dead:
                raise ChannelError(
                    f"endpoint {ep.name!r}: primary and all replicas "
                    "are gone")
            ch = ep.channel
        else:
            if self.pin_idx >= len(ep.chain):
                raise ChannelError(
                    f"endpoint {ep.name!r} has no replica "
                    f"#{self.pin_idx}")
            ch = ep.chain[self.pin_idx]
            if ch.server_pid in self.router._dead_pids:
                raise ChannelError(
                    f"replica #{self.pin_idx} of {ep.name!r} is gone")
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
        self.generation = ep.generation

    def _ensure(self):
        if self.closed:
            raise ChannelError("call on closed RoutedConnection")
        if self.pin_idx is not None:
            # pinned handles never re-wire: sync the generation so the
            # failover-retry guards below stay quiet, and surface
            # replica death for the balancer to handle
            self.generation = self.endpoint.generation
            if self.endpoint.chain[self.pin_idx].server_pid \
                    in self.router._dead_pids:
                raise ChannelError(
                    f"replica #{self.pin_idx} of "
                    f"{self.endpoint.name!r} is gone")
            return self.target
        if self.generation != self.endpoint.generation:
            old, self.target = self.target, None
            old_heap = getattr(old, "heap", None)
            if old_heap is not None and old_heap not in self._dead_heaps:
                self._dead_heaps.append(old_heap)
            try:
                if old is not None:
                    old.close()
            except Exception:
                pass  # the dead server's heap may already be reclaimed
            self.failovers += 1
            self._attach()
        return self.target

    def _can_retry(self, arg_addr: int, kw: dict) -> bool:
        """A mid-call failover may only be retried transparently when the
        request references nothing in the dead server's heap: a scope or
        a non-NULL argument pointer indexes pages of the OLD connection
        heap, which the lease machinery has reclaimed — re-posting it
        against the replica would seal/read unrelated pages. Those calls
        surface the ChannelError so the caller can rebuild its arguments
        (``create_scope``/``new_bytes`` already target the live wire).
        Pinned handles never retry: the balancer owns replica choice."""
        return self.pin_idx is None and kw.get("scope") is None \
            and gaddr.is_null(arg_addr) \
            and self.generation != self.endpoint.generation

    # -- the identical call surface (§5.6) ------------------------------------
    def call(self, fn_id: int, arg_addr: int = gaddr.NULL, **kw) -> int:
        target = self._ensure()
        try:
            return target.call(fn_id, arg_addr, **kw)
        except _FAILOVER_ERRORS:
            if self._can_retry(arg_addr, kw):
                # the endpoint failed over mid-call: retry once, re-wired
                return self._ensure().call(fn_id, arg_addr, **kw)
            raise

    def call_inline(self, fn_id: int, arg_addr: int = gaddr.NULL,
                    **kw) -> int:
        target = self._ensure()
        try:
            return target.call_inline(fn_id, arg_addr, **kw)
        except _FAILOVER_ERRORS:
            if self._can_retry(arg_addr, kw):
                return self._ensure().call_inline(fn_id, arg_addr, **kw)
            raise

    def invoke(self, fn_id: int, *args, **kw):
        """Typed invoke bound to the endpoint *name*: same-pod targets get
        pointer-passing over the CXL ring, cross-pod targets the
        serialized fallback route — decided per route, with no caller
        change (§5.6). Unlike raw ``call``, plain-value argument sets are
        safe to retry across a failover: they reference nothing in the
        dead server's heap and are simply re-marshalled against the
        replica. Pre-built ``GraphRef`` args pin the request to the heap
        they live in, so those surface the error instead."""
        target = self._ensure()
        self._check_graph_args(target, args)
        try:
            return target.invoke(fn_id, *args, **kw)
        except _FAILOVER_ERRORS:
            from .marshal import GraphRef
            if self.pin_idx is None and \
                    self.generation != self.endpoint.generation and \
                    not any(isinstance(a, GraphRef) for a in args):
                return self._ensure().invoke(fn_id, *args, **kw)
            raise

    def invoke_serialized(self, fn_id: int, *args, **kw):
        """The by-value form bound to the endpoint name: the Fig. 11
        serializing baseline on a CXL route, the native copy semantics on
        a fallback route. Always failover-retryable (a serialized request
        references nothing in any heap)."""
        target = self._ensure()
        try:
            if self.transport == "cxl":
                return target.invoke_serialized(fn_id, *args, **kw)
            return target.invoke(fn_id, *args, **kw)
        except DeadlineExceeded:
            raise
        except _FAILOVER_ERRORS:
            if self.pin_idx is None and \
                    self.generation != self.endpoint.generation:
                return self.invoke_serialized(fn_id, *args, **kw)
            raise

    def invoke_async(self, fn_id: int, *args, **kw):
        """Pipelined typed invoke bound to the endpoint *name* — the same
        future surface on every route (CXL ring posts now / fallback
        stages a flight). The returned future is failover-aware: if the
        endpoint fails over while the call is in flight and the arguments
        are plain values (nothing pinned in the dead heap), settling the
        future transparently re-invokes against the replica."""
        target = self._ensure()
        self._check_graph_args(target, args)
        if self.pin_idx is not None:
            # pinned handles (replica balancing) surface replica death
            # to the balancer instead of re-routing mid-flight
            return target.invoke_async(fn_id, *args, **kw)
        from .marshal import GraphRef
        retryable = not any(isinstance(a, GraphRef) for a in args)
        try:
            inner = target.invoke_async(fn_id, *args, **kw)
        except _FAILOVER_ERRORS:
            # the POST itself raced a failover/migration handoff: the old
            # wire closed under us. Re-ensure rather than compare
            # generations — a sibling thread that lost the same race may
            # have re-wired (and synced the generation) already, so
            # "target went stale" is the reliable signal. Plain-value
            # args simply re-post against the live wire, like invoke().
            if not retryable:
                raise
            fresh = self._ensure()
            if fresh is target:
                raise   # nothing failed over: a real caller-side error
            inner = fresh.invoke_async(fn_id, *args, **kw)
        return RoutedRpcFuture(self, fn_id, args, kw, inner, retryable)

    def invoke_stream(self, fn_id: int, *args, **kw):
        """Streaming typed invoke bound to the endpoint *name*: the same
        chunk-chain iterator on every route (CXL push-mode pumping /
        fallback staged chunk flights). The returned ``RoutedRpcStream``
        is failover-*aware* but not failover-transparent: a stream that
        already delivered chunks cannot be silently replayed against a
        replica, so a mid-stream failover surfaces ``ChannelError`` and
        the caller decides whether to restart the stream."""
        target = self._ensure()
        self._check_graph_args(target, args)
        if self.pin_idx is not None:
            return target.invoke_stream(fn_id, *args, **kw)
        return RoutedRpcStream(self, target.invoke_stream(fn_id, *args,
                                                          **kw))

    def _check_graph_args(self, target, args) -> None:
        """A GraphRef built in the heap of a target this handle has since
        failed away from is stale: that heap is lease-reclaimed, and
        silently deep-copying out of it would read memory whose
        ownership lapsed. Surface it — callers rebuild with
        ``build_graph`` against the live target. Refs in OTHER live
        heaps are fine: the marshal layer deep-copies (CXL) or
        serializes (fallback) them per §5.6."""
        from .marshal import GraphRef
        for a in args:
            if isinstance(a, GraphRef) and a.scope is not None and \
                    any(a.scope.heap is h for h in self._dead_heaps):
                raise ChannelError(
                    "stale GraphRef: the graph lives in a failed-over "
                    "target's heap — rebuild it with build_graph() "
                    "against the live target")

    def build_graph(self, *values):
        """Materialize an argument tuple once against the live target's
        heap (see ``marshal.build_graph``). The ref dies with the target:
        after a failover, invoke it again to build against the replica."""
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
        if self.pin_idx is None and \
                self.generation != self.endpoint.generation:
            # the token names a slot of the DEAD server's ring; waiting it
            # on the re-wired ring would consume someone else's result
            raise ChannelError(
                "endpoint failed over: in-flight call_async token is void")
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


class RoutedRpcFuture:
    """A pipelined invoke bound to an endpoint *name*: wraps the live
    target's future and, on a failover mid-flight, re-invokes plain-value
    argument sets against the replica (re-running the routing decision)
    instead of surfacing the dead server's error. GraphRef-pinned calls
    and lapsed deadlines surface — the first references a reclaimed heap,
    the second has no budget left to retry with."""

    __slots__ = ("rc", "fn_id", "args", "kw", "inner", "retryable",
                 "_settled", "_value")

    def __init__(self, rc: RoutedConnection, fn_id: int, args, kw,
                 inner, retryable: bool):
        self.rc = rc
        self.fn_id = fn_id
        self.args = args
        self.kw = kw
        self.inner = inner
        self.retryable = retryable
        self._settled = False
        self._value = None

    def done(self) -> bool:
        return self._settled or self.inner.done()

    def _kick(self) -> None:
        self.inner._kick()

    def cancel(self) -> bool:
        if self._settled:
            return False
        cancelled = self.inner.cancel()
        if cancelled:
            # a cancelled call must never re-run: without this, a
            # failover between cancel() and result() would swallow the
            # inner 'future cancelled' error and re-invoke the RPC
            self.retryable = False
        return cancelled

    def _wire_stale(self) -> bool:
        """Did this future's wire die with a failover/migration handoff?
        A moved endpoint generation is the obvious signal; comparing the
        inner future's connection against the handle's current target
        additionally catches the shared-handle race where a sibling
        thread already re-wired (and re-synced the generation) before
        this thread observed its own call failing."""
        rc = self.rc
        if rc.generation != rc.endpoint.generation:
            return True
        inner_conn = getattr(self.inner, "conn", None)
        return inner_conn is not None and inner_conn is not rc.target

    def result(self, timeout: Optional[float] = None):
        if self._settled:
            return self._value
        rc = self.rc
        try:
            if self.retryable and not rc.closed and self._wire_stale():
                # the endpoint already failed over: give the dead ring
                # one brief drain chance (the reply may have landed
                # pre-crash), then fall through to the replica retry
                # instead of burning the full wait timeout
                self._value = self.inner.result(0.05)
            else:
                self._value = self.inner.result(timeout)
        except DeadlineExceeded:
            raise
        except _FAILOVER_ERRORS:
            if not self.retryable or rc.closed or not self._wire_stale():
                raise
            # mid-flight failover: the token names the dead server's
            # ring — re-marshal against the replica (sync; the pipeline
            # is gone with the old ring anyway)
            self._value = rc.invoke(self.fn_id, *self.args, **self.kw)
        self._settled = True
        return self._value


class RoutedRpcStream:
    """A streaming reply bound to an endpoint *name*: wraps the live
    target's chunk iterator. Unlike ``RoutedRpcFuture`` there is no
    transparent retry — chunks already delivered cannot be un-delivered,
    so a failover mid-stream surfaces ``ChannelError`` (§4.6: the lease
    machinery reclaimed the chain pages with the dead server) and the
    caller restarts the stream if the method is idempotent."""

    __slots__ = ("rc", "inner")

    def __init__(self, rc: RoutedConnection, inner):
        self.rc = rc
        self.inner = inner

    def __iter__(self) -> "RoutedRpcStream":
        return self

    def __next__(self):
        return self.next()

    def next(self, timeout: Optional[float] = None):
        rc = self.rc
        if not rc.closed and rc.generation != rc.endpoint.generation:
            self.inner.close()
            raise ChannelError(
                "endpoint failed over mid-stream: the reply chain died "
                "with the old server — restart the stream")
        try:
            return self.inner.next(timeout)
        except (DeadlineExceeded, StopIteration):
            raise
        except _FAILOVER_ERRORS:
            if rc.generation != rc.endpoint.generation:
                raise ChannelError(
                    "endpoint failed over mid-stream: the reply chain "
                    "died with the old server — restart the stream")
            raise

    def close(self) -> None:
        self.inner.close()


class BalancedConnection:
    """Replica load-balancing client handle (the overload-robust mode of
    an endpoint's replica chain).

    Where ``RoutedConnection`` treats ``EndpointRecord.chain`` as a *failover*
    chain — one active channel, standbys idle until a lease lapse —
    ``BalancedConnection`` treats it as a *load-spread set*: every
    dispatch picks a live replica (``"power2"``: two random candidates,
    take the one with fewer in-flight calls; ``"rr"``: round-robin) and
    rides a per-replica *pinned* ``RoutedConnection`` underneath, so the
    §5.6 routing decision (CXL ring vs fallback link) still happens
    per replica from pod metadata.

    Failover degrades gracefully rather than re-wiring: a replica whose
    serving lease lapsed drops out of the live set (``router._dead_pids``)
    and plain-value dispatches retry on another replica; calls that pin
    the dead replica's heap surface ``ChannelError`` like any routed
    call. Streams stay *pinned* to one replica — a chunk chain cannot be
    split across servers — and ``Overloaded``/``DeadlineExceeded`` are
    never retried here (the retry interceptor owns backoff policy).
    """

    def __init__(self, router: ClusterRouter, endpoint: EndpointRecord,
                 pid: int, ring_capacity: int = 256, balance: str = "power2",
                 seed: int = 0):
        if balance not in ("power2", "rr"):
            raise ChannelError(
                f"unknown balance policy {balance!r} "
                "(want 'power2' or 'rr')")
        self.router = router
        self.endpoint = endpoint
        self.client_pid = pid
        self.ring_capacity = ring_capacity
        self.balance = balance
        self.transport = "balanced"
        self.closed = False
        self._rng = random.Random(seed)
        self._rr = 0
        self._subs: Dict[int, RoutedConnection] = {}
        # per-replica gauges/counters: the power-of-two-choices signal
        # and the spread a caller reads back
        self.inflight: Dict[int, int] = {}
        self.dispatched: Dict[int, int] = {}
        self._stream_pin: Optional[int] = None
        self.n_degraded = 0   # dispatches that fell over to another replica

    # -- replica selection ---------------------------------------------------
    def _live(self) -> List[int]:
        dead = self.router._dead_pids
        return [i for i, ch in enumerate(self.endpoint.chain)
                if ch.server_pid not in dead]

    def _pick(self, live: List[int]) -> int:
        if len(live) == 1:
            return live[0]
        if self.balance == "rr":
            idx = live[self._rr % len(live)]
            self._rr += 1
            return idx
        a, b = self._rng.sample(live, 2)   # power of two choices
        if self.inflight.get(b, 0) < self.inflight.get(a, 0):
            return b
        return a

    def _sub(self, idx: int) -> RoutedConnection:
        rc = self._subs.get(idx)
        if rc is None:
            rc = RoutedConnection(self.router, self.endpoint,
                                  self.client_pid, self.ring_capacity,
                                  pin_idx=idx)
            with self.router._lock:
                self.router._conns.append(rc)
            self._subs[idx] = rc
        return rc

    def _drop_replica(self, idx: int) -> None:
        rc = self._subs.pop(idx, None)
        if rc is not None:
            try:
                rc.close()
            except Exception:
                pass
        if self._stream_pin == idx:
            self._stream_pin = None

    def prime(self) -> int:
        """Pre-wire a pinned sub-connection to every live replica (call
        before opening traffic so no connection setup — heap mapping,
        ring attach — happens under load). Returns the number wired."""
        n = 0
        for i in self._live():
            self._sub(i)
            n += 1
        return n

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, method: str, fn_id: int, args, kw,
                  retry_safe: bool):
        if self.closed:
            raise ChannelError("call on closed BalancedConnection")
        tried: Set[int] = set()
        while True:
            live = [i for i in self._live() if i not in tried]
            if not live:
                raise ChannelError(
                    f"endpoint {self.endpoint.name!r}: no live replica "
                    "left to balance onto")
            idx = self._pick(live)
            tried.add(idx)
            self.dispatched[idx] = self.dispatched.get(idx, 0) + 1
            self.inflight[idx] = self.inflight.get(idx, 0) + 1
            try:
                rc = self._sub(idx)
                return getattr(rc, method)(fn_id, *args, **kw)
            except (DeadlineExceeded, Overloaded):
                raise   # backoff is the retry interceptor's job
            except _FAILOVER_ERRORS:
                # only a DEAD replica degrades to the next one, and only
                # when the arguments pin nothing in its heap; anything
                # else (bad fn_id, sealed-page violation, ...) surfaces
                pid = self.endpoint.chain[idx].server_pid
                if retry_safe and pid in self.router._dead_pids:
                    self._drop_replica(idx)
                    self.n_degraded += 1
                    continue
                raise
            finally:
                self.inflight[idx] = self.inflight.get(idx, 1) - 1

    # -- the identical call surface (§5.6) ------------------------------------
    def call(self, fn_id: int, arg_addr: int = gaddr.NULL, **kw) -> int:
        safe = kw.get("scope") is None and gaddr.is_null(arg_addr)
        return self._dispatch("call", fn_id, (arg_addr,), kw, safe)

    def call_inline(self, fn_id: int, arg_addr: int = gaddr.NULL,
                    **kw) -> int:
        safe = kw.get("scope") is None and gaddr.is_null(arg_addr)
        return self._dispatch("call_inline", fn_id, (arg_addr,), kw, safe)

    def invoke(self, fn_id: int, *args, **kw):
        from .marshal import GraphRef
        safe = not any(isinstance(a, GraphRef) for a in args)
        return self._dispatch("invoke", fn_id, args, kw, safe)

    def invoke_serialized(self, fn_id: int, *args, **kw):
        return self._dispatch("invoke_serialized", fn_id, args, kw, True)

    def invoke_async(self, fn_id: int, *args, **kw):
        """Pipelined dispatch to the least-loaded replica. The returned
        future holds that replica's in-flight slot until it settles or
        is cancelled — that gauge IS the power-of-two-choices signal, so
        a slow replica sheds new arrivals onto its peers. No transparent
        cross-replica retry mid-flight: replica death surfaces and the
        caller (or the retry interceptor) re-invokes."""
        if self.closed:
            raise ChannelError("call on closed BalancedConnection")
        live = self._live()
        if not live:
            raise ChannelError(
                f"endpoint {self.endpoint.name!r}: no live replica "
                "left to balance onto")
        idx = self._pick(live)
        rc = self._sub(idx)
        self.dispatched[idx] = self.dispatched.get(idx, 0) + 1
        self.inflight[idx] = self.inflight.get(idx, 0) + 1
        try:
            inner = rc.invoke_async(fn_id, *args, **kw)
        except BaseException:
            self.inflight[idx] -= 1
            raise
        return _BalancedFuture(self, idx, inner)

    def invoke_stream(self, fn_id: int, *args, **kw):
        """Streams stay pinned: chunk chains cannot be split across
        replicas, so the first stream picks a replica and every later
        stream sticks to it while it lives."""
        if self.closed:
            raise ChannelError("call on closed BalancedConnection")
        live = self._live()
        if not live:
            raise ChannelError(
                f"endpoint {self.endpoint.name!r}: no live replica "
                "left to balance onto")
        pin = self._stream_pin
        if pin is None or pin not in live:
            pin = self._pick(live)
            self._stream_pin = pin
        self.dispatched[pin] = self.dispatched.get(pin, 0) + 1
        return self._sub(pin).invoke_stream(fn_id, *args, **kw)

    # -- object construction -------------------------------------------------
    def create_scope(self, size_bytes: int):
        raise ChannelError(
            "a balanced handle has no single target heap — a scope would "
            "pin every call to one replica; use plain-value (byval) "
            "methods, or a pinned connect() handle for scope-based calls")

    def new_bytes(self, data: bytes, scope=None) -> int:
        raise ChannelError(
            "a balanced handle has no single target heap — pass bytes "
            "as plain values and let each dispatch marshal them")

    def build_graph(self, *values):
        raise ChannelError(
            "a balanced handle has no single target heap — pass plain "
            "values; each dispatch marshals against the replica it picks")

    # -- stats ---------------------------------------------------------------
    @property
    def n_calls(self) -> int:
        return sum(rc.n_calls for rc in self._subs.values())

    @property
    def n_invokes(self) -> int:
        return sum(rc.n_invokes for rc in self._subs.values())

    @property
    def marshal_bytes(self) -> int:
        return sum(rc.marshal_bytes for rc in self._subs.values())

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for idx in list(self._subs):
            rc = self._subs.pop(idx)
            try:
                rc.close()   # drops itself from router._conns
            except Exception:
                pass


class WildcardConnection:
    """A client handle over an endpoint *prefix* (``"/pod0/kv/*"``).

    Where ``RoutedConnection`` binds one endpoint name, a wildcard handle
    re-resolves ``router.list_endpoints(prefix)`` on every dispatch and
    round-robins across the live matches, lazily keeping one routed
    sub-connection per matched endpoint. Siblings registered, drained,
    migrated, or revived *after* the connect are discovered naturally —
    no hardcoded names or pids — which is exactly what a client of a
    sharded/migrating service family wants.

    An endpoint that dies between listing and dispatch degrades to the
    next match (plain routed-connection failover semantics otherwise
    apply per endpoint); ``Overloaded``/``DeadlineExceeded`` surface for
    the retry interceptor to handle, like every other handle."""

    def __init__(self, router: ClusterRouter, pattern: str, pid: int,
                 ring_capacity: int = 256):
        if not pattern.endswith("*"):
            raise ChannelError(
                f"wildcard patterns end with '*', got {pattern!r}")
        self.prefix = pattern[:-1]
        if not self.prefix.startswith("/"):
            raise ChannelError(
                f"endpoint names are hierarchical paths, got {pattern!r}")
        self.router = router
        self.client_pid = pid
        self.ring_capacity = ring_capacity
        self.transport = "wildcard"
        self.closed = False
        self._rr = 0
        self._subs: Dict[str, RoutedConnection] = {}
        self.dispatched: Dict[str, int] = {}

    # -- resolution ----------------------------------------------------------
    def endpoints(self) -> List[str]:
        """The live endpoint names under the prefix, right now."""
        router = self.router
        return [n for n in router.list_endpoints(self.prefix)
                if not router.endpoints[n].dead]

    def _sub(self, name: str) -> RoutedConnection:
        rc = self._subs.get(name)
        if rc is None:
            rc = self.router.connect(name, self.client_pid,
                                     self.ring_capacity)
            self._subs[name] = rc
        return rc

    def _drop_sub(self, name: str) -> None:
        rc = self._subs.pop(name, None)
        if rc is not None:
            try:
                rc.close()
            except Exception:
                pass  # the dead server's heap may already be reclaimed

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, method: str, fn_id: int, args, kw):
        if self.closed:
            raise ChannelError("call on closed WildcardConnection")
        tried: Set[str] = set()
        while True:
            live = [n for n in self.endpoints() if n not in tried]
            if not live:
                raise ChannelError(
                    f"no live endpoint matches {self.prefix + '*'!r}")
            name = live[self._rr % len(live)]
            self._rr += 1
            tried.add(name)
            self.dispatched[name] = self.dispatched.get(name, 0) + 1
            try:
                return getattr(self._sub(name), method)(fn_id, *args, **kw)
            except (DeadlineExceeded, Overloaded):
                raise   # backoff is the retry interceptor's job
            except _FAILOVER_ERRORS:
                # only an endpoint that died under us degrades to the
                # next match; anything else surfaces
                ep = self.router.endpoints.get(name)
                if ep is not None and not ep.dead:
                    raise
                self._drop_sub(name)

    # -- the identical call surface (§5.6) ------------------------------------
    def call(self, fn_id: int, arg_addr: int = gaddr.NULL, **kw) -> int:
        return self._dispatch("call", fn_id, (arg_addr,), kw)

    def call_inline(self, fn_id: int, arg_addr: int = gaddr.NULL,
                    **kw) -> int:
        return self._dispatch("call_inline", fn_id, (arg_addr,), kw)

    def invoke(self, fn_id: int, *args, **kw):
        return self._dispatch("invoke", fn_id, args, kw)

    def invoke_serialized(self, fn_id: int, *args, **kw):
        return self._dispatch("invoke_serialized", fn_id, args, kw)

    def invoke_async(self, fn_id: int, *args, **kw):
        return self._dispatch("invoke_async", fn_id, args, kw)

    def invoke_stream(self, fn_id: int, *args, **kw):
        return self._dispatch("invoke_stream", fn_id, args, kw)

    # -- object construction -------------------------------------------------
    def create_scope(self, size_bytes: int):
        raise ChannelError(
            "a wildcard handle has no single target heap — use "
            "plain-value (byval) methods, or connect() to one of "
            ".endpoints() for scope-based calls")

    def new_bytes(self, data: bytes, scope=None) -> int:
        raise ChannelError(
            "a wildcard handle has no single target heap — pass bytes "
            "as plain values and let each dispatch marshal them")

    def build_graph(self, *values):
        raise ChannelError(
            "a wildcard handle has no single target heap — pass plain "
            "values; each dispatch marshals against the endpoint it picks")

    # -- stats ---------------------------------------------------------------
    @property
    def n_calls(self) -> int:
        return sum(rc.n_calls for rc in self._subs.values())

    @property
    def n_invokes(self) -> int:
        return sum(rc.n_invokes for rc in self._subs.values())

    @property
    def marshal_bytes(self) -> int:
        return sum(rc.marshal_bytes for rc in self._subs.values())

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for name in list(self._subs):
            self._drop_sub(name)


class _BalancedFuture:
    """Wraps a pinned replica's future and releases that replica's
    in-flight gauge exactly once — on first result (either outcome) or
    on a successful cancel. Holding the slot until settle is what makes
    the power-of-two-choices signal reflect *completion* load, not just
    dispatch counts."""

    __slots__ = ("bc", "idx", "inner", "_released")

    def __init__(self, bc: BalancedConnection, idx: int, inner):
        self.bc = bc
        self.idx = idx
        self.inner = inner
        self._released = False

    def _release(self) -> None:
        if not self._released:
            self._released = True
            self.bc.inflight[self.idx] = \
                self.bc.inflight.get(self.idx, 1) - 1

    def done(self) -> bool:
        return self.inner.done()

    def _kick(self) -> None:
        self.inner._kick()

    def cancel(self) -> bool:
        cancelled = self.inner.cancel()
        if cancelled:
            self._release()
        return cancelled

    def result(self, timeout: Optional[float] = None):
        try:
            return self.inner.result(timeout)
        finally:
            self._release()
