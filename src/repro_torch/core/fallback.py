"""RDMA/DCN fallback transport — §4.7, §5.6.

When the two endpoints of a connection do not share a coherence domain
(different racks in the paper; different pods here), RPCool replaces
hardware coherence with a minimalist two-node software-coherent shared
memory: every page is *exclusively owned* by one node. A load/store to a
page the node does not own faults, fetches the page from the peer, flips
ownership, and re-executes. RPC traffic is strongly phase-alternating, so
this avoids full DSM synchronization.

The host-side protocol runs for real: two heap replicas, an ownership
bitmap, byte copies, and a modeled one-way link latency (3 µs by default,
one direct-attached RDMA hop). The counters (bytes moved, faults,
messages, one-sided puts) are the reference package's, charge for charge.

The programmer-facing API is the CXL path's (§5.6): ``FallbackConnection``
mirrors ``Connection.call``/``invoke`` including seals and sandboxes, over
the same descriptor ring layout; ``send_msg`` models a descriptor's flight
over the link. The bulk KV handoff across pods moves pool pages through
the page-copy kernels and charges them to the link with ``put_bytes``, one
one-sided flight with a completion word.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import addr as gaddr
from .channel import BusyWaitPolicy, DescriptorRing, RING_SLOT_BYTES, \
    F_DEADLINE, F_SANDBOXED, F_SEALED, OK, R_DONE, R_EMPTY, R_ERR, \
    E_EXCEPTION, _admission_park, _now_us
from .errors import ChannelError, DeadlineExceeded, Overloaded, \
    OwnershipMiss, SealViolation
from .heap import SharedHeap
from .orchestrator import ReproConfig
from .sandbox import SandboxManager
from .scope import Scope, create_scope
from .seal import SealManager

OWNER_CLIENT = 0
OWNER_SERVER = 1

# the 8-byte completion word a one-sided put publishes after its bulk
# payload lands (cMPI framing: the receiver polls this word instead of
# exchanging per-message acks — its wire cost rides the same flight)
COMPLETION_WORD_BYTES = 8


class DSMLink:
    """The wire between the two replicas + the ownership table."""

    def __init__(self, num_pages: int, page_size: int = 4096,
                 link_latency_us: float = 3.0, heap_id: int = 1):
        self.page_size = page_size
        self.num_pages = num_pages
        self.link_latency_us = link_latency_us
        # one replica per node — same heap_id: it is ONE logical heap
        self.replica = [
            SharedHeap(heap_id, num_pages, page_size, name="dsm/client"),
            SharedHeap(heap_id, num_pages, page_size, name="dsm/server"),
        ]
        # the client replica is the single allocator; page states are
        # mirrored to the server replica with ``sync_meta``
        self.owner = np.full(num_pages, OWNER_CLIENT, dtype=np.uint8)
        # per-destination completion words of one-sided puts
        self.completion = np.zeros(2, dtype=np.uint64)
        # stats
        self.bytes_moved = 0
        self.page_faults = 0
        self.ownership_misses = 0
        self.msgs = 0
        self.n_puts = 0

    def _wire(self, nbytes: int) -> None:
        self.bytes_moved += nbytes
        if self.link_latency_us:
            time.sleep(self.link_latency_us * 1e-6)

    def send_msg(self, nbytes: int) -> None:
        """An explicit message (RPC descriptor / completion) on the wire."""
        self.msgs += 1
        self._wire(nbytes)

    def claim(self, pages: List[int], to: int) -> None:
        """Metadata-only ownership flip for pages the claimant is about
        to fully overwrite (fresh allocations, reply blobs): no bytes and
        no latency go on the wire."""
        if pages:
            self.owner[np.asarray(pages)] = to

    @staticmethod
    def _runs(pages: List[int]) -> List[Tuple[int, int]]:
        """Group a sorted page list into consecutive ``[lo, hi)`` runs."""
        runs: List[List[int]] = []
        for p in pages:
            if runs and p == runs[-1][1]:
                runs[-1][1] = p + 1
            else:
                runs.append([p, p + 1])
        return [(lo, hi) for lo, hi in runs]

    def migrate(self, pages: List[int], to: int) -> int:
        """Fetch ``pages`` to node ``to`` (§5.6 page-fault service path):
        one slice copy per consecutive run, one fault and one wire op for
        the whole list. Returns the number of pages moved."""
        need = sorted(p for p in pages if self.owner[p] != to)
        if not need:
            return 0
        src = self.replica[1 - to].buf
        dst = self.replica[to].buf
        ps = self.page_size
        for lo, hi in self._runs(need):
            dst[lo * ps : hi * ps] = src[lo * ps : hi * ps]
        self.owner[np.asarray(need)] = to
        self.page_faults += 1
        self._wire(len(need) * ps)
        return len(need)

    def put_bytes(self, nbytes: int, to: int) -> None:
        """One-sided payload-only put (no page-table involvement): the
        byref KV-page path moves pool pages through the gather → wire →
        scatter kernels, and the link charges that bulk as a single
        one-sided flight plus its completion word."""
        self.msgs += 1
        self.n_puts += 1
        self._wire(nbytes + COMPLETION_WORD_BYTES)
        self.completion[to] += 1       # publish AFTER the payload lands

    def sync_meta(self, to: int) -> None:
        """Propagate allocator/perm metadata (tiny control message)."""
        src, dst = self.replica[1 - to], self.replica[to]
        dst.state[:] = src.state
        dst.owner[:] = src.owner
        dst.perm[:] = src.perm
        dst.seal_holder[:] = src.seal_holder


class DSMNode:
    """One endpoint's view of the logical heap: checked, faulting access."""

    def __init__(self, link: DSMLink, node_id: int):
        self.link = link
        self.node_id = node_id
        self.heap = link.replica[node_id]
        self.page_size = link.page_size

    def _page_range(self, a: int, nbytes: int) -> Tuple[int, int]:
        lin = gaddr.linear(a, self.page_size)
        return lin // self.page_size, (lin + nbytes - 1) // self.page_size

    def check_owned(self, a: int, nbytes: int = 1) -> None:
        """Raise ``OwnershipMiss`` on the first page of the extent this
        node does not own — the §5.6 page fault, surfaced."""
        p0, p1 = self._page_range(a, nbytes)
        for p in range(p0, p1 + 1):
            if self.link.owner[p] != self.node_id:
                raise OwnershipMiss(p)

    def _fault_in(self, a: int, nbytes: int) -> None:
        """Fault-and-fetch: a miss is counted, then serviced by one bulk
        migration of the whole unowned extent."""
        try:
            self.check_owned(a, nbytes)
        except OwnershipMiss:
            self.link.ownership_misses += 1
            p0, p1 = self._page_range(a, nbytes)
            self.link.migrate(
                [p for p in range(p0, p1 + 1)
                 if self.link.owner[p] != self.node_id],
                to=self.node_id)

    def read(self, a: int, nbytes: int) -> np.ndarray:
        self._fault_in(a, nbytes)
        return self.heap.read(a, nbytes)

    def read_owned(self, a: int, nbytes: int) -> np.ndarray:
        """Strict read: touching a page the peer holds mid-flight raises
        ``OwnershipMiss`` instead of migrating it."""
        self.check_owned(a, nbytes)
        return self.heap.read(a, nbytes)

    def write(self, a: int, data, pid: int = 0) -> None:
        self._fault_in(a, SharedHeap._payload_nbytes(data))
        self.heap.write(a, data, pid=pid)


class FallbackConnection:
    """Two-node RPC over the DSM link. API mirrors ``Connection``; calls
    are synchronous request/reply."""

    def __init__(self, num_pages: int = 4096, page_size: int = 4096,
                 link_latency_us: float = 3.0, client_pid: int = 1,
                 server_pid: int = 2, ring_capacity: int = 64,
                 functions: Optional[Dict[int, Callable]] = None,
                 heap_id: int = 1, link: Optional[DSMLink] = None):
        cfg = ReproConfig
        # ``link`` shares a DSMLink (heap replicas + ownership table) with
        # other connections — the LinkPool multiplexing
        if link is None:
            link = DSMLink(num_pages, page_size, link_latency_us,
                           heap_id=heap_id)
        self.link = link
        self._pool = None              # set by LinkPool.connect
        self._stripe = 0
        self.client = DSMNode(self.link, OWNER_CLIENT)
        self.server = DSMNode(self.link, OWNER_SERVER)
        self.client_pid = client_pid
        self.server_pid = server_pid
        # allocation + seals happen against the client replica (the single
        # allocator of the link); metadata is mirrored on demand
        self.seals = SealManager(self.client.heap)
        self.sandboxes = SandboxManager(self.server.heap)
        self.ring = DescriptorRing(self.client.heap, ring_capacity)
        self._next_seq = 1
        # ``functions`` may be a Channel's live handler table: the router
        # bridges a cross-pod client to the same server code the CXL path
        # dispatches to (§5.6 "interfaces are identical")
        self.functions: Dict[int, Callable[["FallbackServerCtx", int], int]] \
            = functions if functions is not None else {}
        # typed data plane bookkeeping (core/marshal.py)
        self._reply_free: List[Scope] = []
        self._reply_live: Dict[int, Scope] = {}
        # bounded admission queue for a full ring (§5.4) — same contract
        # as Connection
        self.admission_wait_s = cfg.admission_wait_s
        self.admission_max_waiters = cfg.admission_max_waiters
        self._admission_waiters = 0
        self.wait_policy = BusyWaitPolicy(
            fixed_sleep_us=cfg.wait_fixed_sleep_us, window=cfg.wait_window)
        # server-side pre-dispatch admission gate (§5.4)
        self.admission = None
        self.n_calls = 0
        self.n_invokes = 0
        self.marshal_bytes = 0
        self.n_admission_waits = 0
        self.n_overloads = 0
        self.closed = False

    # -- client-side API (identical shape to Connection) -----------------
    def create_scope(self, size_bytes: int) -> Scope:
        scope = create_scope(self.client.heap, size_bytes,
                             owner=self.client_pid)
        # write-allocate: a fresh scope's pages have no remote content
        # worth fetching, so ownership flips by metadata alone
        s, n = scope.page_range()
        self.link.claim(list(range(s, s + n)), to=OWNER_CLIENT)
        return scope

    def add(self, fn_id: int, fn) -> None:
        self.functions[fn_id] = fn

    def invoke(self, fn_id: int, *args, **kw):
        """Typed invoke: the SAME surface as ``Connection.invoke``, but
        the arguments travel by value over the link — ``serial.encode``
        into one blob, a single copy across, decode on the far side."""
        from .marshal import invoke_fallback
        return invoke_fallback(self, fn_id, args, **kw)

    def _post(self, fn_id: int, arg_addr: int, scope: Optional[Scope],
              sealed: bool, sandboxed: bool, flags_extra: int,
              deadline_us: int) -> Tuple[int, int]:
        """Claim a ring slot (seq claimed only on success) and publish the
        descriptor record. Nothing goes on the wire yet."""
        if self.closed:
            raise ChannelError("call on closed connection")
        flags = flags_extra
        seal_idx = 0
        sc_start = sc_count = 0
        if scope is not None:
            sc_start, sc_count = scope.page_range()
        if sealed and scope is None:
            raise SealViolation("sealed call requires a scope")
        if sandboxed:
            flags |= F_SANDBOXED
        if deadline_us:
            flags |= F_DEADLINE

        ring = self.ring
        seq = self._next_seq
        slot = seq % ring.capacity
        if ring.state_of(slot) != R_EMPTY:
            _admission_park(self, ring, slot, deadline_us)
        if sealed:   # seal only after every rejecting path
            seal_idx = self.seals.seal(scope, holder=self.client_pid)
            flags |= F_SEALED
        self._next_seq = seq + 1
        ring.post(slot, seq, fn_id, flags, arg_addr, seal_idx,
                  sc_start, sc_count, ret=deadline_us)
        return slot, seal_idx

    def call(self, fn_id: int, arg_addr: int = gaddr.NULL,
             scope: Optional[Scope] = None, sealed: bool = False,
             sandboxed: bool = False, batch_release: bool = False,
             flags_extra: int = 0, deadline_us: int = 0,
             **_ignored) -> int:
        """Mirrors ``Connection.call``; the CXL-tuning kwargs (timeouts,
        spin intervals) are accepted and ignored — the call is
        synchronous request/reply over the link."""
        slot, seal_idx = self._post(fn_id, arg_addr, scope, sealed,
                                    sandboxed, flags_extra, deadline_us)
        ring = self.ring
        # the descriptor record goes over the wire (§5.6)
        self.link.send_msg(RING_SLOT_BYTES)
        self.link.sync_meta(to=OWNER_SERVER)
        try:
            self._serve(slot)
        except BaseException:
            # free the slot so the link survives handler failures
            ring.complete(slot, 0, R_ERR, E_EXCEPTION)
            ring.consume(slot)
            raise
        # completion message back
        self.link.send_msg(RING_SLOT_BYTES)
        ret, _state, _status = ring.consume(slot)
        if sealed:
            if batch_release:
                self.seals.release_batched(seal_idx, holder=self.client_pid)
            else:
                self.seals.release(seal_idx, holder=self.client_pid)
        self.n_calls += 1
        return ret

    # the call is already synchronous end to end, so the inline variant
    # is the same entry point (RoutedConnection relies on this)
    call_inline = call

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            if self._pool is not None:
                self._pool.detach(self)
            for s in (*self._reply_free, *self._reply_live.values()):
                if s.live:
                    s.destroy()
            self._reply_free.clear()
            self._reply_live.clear()

    # -- server half (shares the CXL-path descriptor format) --------------
    def _serve(self, slot: int) -> None:
        ring = self.ring
        (_seq, fn_id, flags, arg, seal_idx, _ret, _st, _status,
         sc_start, sc_count) = ring.load(slot)
        fn = self.functions.get(fn_id)
        if fn is None:
            raise ChannelError(f"no function {fn_id}")
        # deadline gate: a request that expired on the wire is dropped
        # before the server touches a single argument page
        if flags & F_DEADLINE and _now_us() > _ret:
            raise DeadlineExceeded(
                f"RPC {fn_id} deadline lapsed on the link")
        # admission gate (§5.4): shed before the handler
        gate = self.admission
        if gate is not None:
            retry_after_us = gate.admit(self.client_pid, fn_id)
            if retry_after_us is not None:
                raise Overloaded(
                    f"server shed RPC {fn_id} (E_OVERLOAD)",
                    retry_after_s=retry_after_us * 1e-6)
        try:
            ctx = FallbackServerCtx(self, flags)
            ctx.deadline_us = _ret if flags & F_DEADLINE else 0
            if flags & F_SEALED and not self.seals.is_sealed(seal_idx):
                raise SealViolation("receiver found region unsealed")
            try:
                if flags & F_SANDBOXED and not gaddr.is_null(arg) \
                        and sc_count:
                    # server must own the pages before sandboxing them
                    self.link.migrate(
                        list(range(sc_start, sc_start + sc_count)),
                        to=OWNER_SERVER)
                    with self.sandboxes.enter(sc_start, sc_count) as sb:
                        ctx.sandbox = sb
                        ret = fn(ctx, arg)
                else:
                    ret = fn(ctx, arg)
            finally:
                if flags & F_SEALED:
                    self.seals.mark_complete(seal_idx)
            ring.complete(slot, ret, R_DONE, OK)
        finally:
            if gate is not None:
                gate.release()

class LinkPool:
    """A pod pair's shared fallback plane: ``pool_size`` DSMLinks
    multiplexing N ``FallbackConnection`` clients, striped round-robin at
    connect time. Every connection on a stripe shares that link's heap
    replicas, ownership table and counters."""

    def __init__(self, num_pages: int = 4096, page_size: int = 4096,
                 link_latency_us: float = 3.0, pool_size: int = 2,
                 heap_ids: Optional[List[int]] = None):
        if pool_size < 1:
            raise ChannelError(f"LinkPool needs >= 1 link, got {pool_size}")
        self.pool_size = pool_size
        self.links = [
            DSMLink(num_pages, page_size, link_latency_us,
                    heap_id=(heap_ids[i] if heap_ids else 1 + i))
            for i in range(pool_size)
        ]
        self.members: List[List[FallbackConnection]] = \
            [[] for _ in range(pool_size)]
        self._rr = 0

    def connect(self, client_pid: int = 1, server_pid: int = 2,
                ring_capacity: int = 64,
                functions: Optional[Dict[int, Callable]] = None
                ) -> FallbackConnection:
        """Mint a pooled connection on the next stripe; its ring, seals
        and handler table stay per connection (SPSC per client)."""
        idx = self._rr % self.pool_size
        self._rr += 1
        conn = FallbackConnection(
            client_pid=client_pid, server_pid=server_pid,
            ring_capacity=ring_capacity, functions=functions,
            link=self.links[idx])
        conn._pool = self
        conn._stripe = idx
        self.members[idx].append(conn)
        return conn

    def detach(self, conn: FallbackConnection) -> None:
        members = self.members[conn._stripe]
        if conn in members:
            members.remove(conn)
        conn._pool = None


class FallbackServerCtx:
    """Server view: reads fault pages across the link (§5.6)."""

    def __init__(self, conn: FallbackConnection, flags: int = 0):
        self.conn = conn
        self.flags = flags
        self.sandbox = None
        self.deadline_us = 0  # propagated request deadline (0 = none)

    def read(self, a: int, nbytes: int):
        if self.sandbox is not None:
            self.sandbox.check(a, nbytes)
        return self.conn.server.read(a, nbytes)

    def write(self, a: int, data) -> None:
        """Handler-facing store: sandbox-confined like ``read`` (§4.4)."""
        if self.sandbox is not None:
            self.sandbox.check(a, SharedHeap._payload_nbytes(data))
        self.conn.server.write(a, data, pid=self.conn.server_pid)

    def _daemon_write(self, a: int, data) -> None:
        """Privileged runtime store (reply marshalling): reply scopes are
        carved from the client replica's allocator mid-request, so the
        metadata is propagated first; the reply extent is write-allocated
        (ownership flips by metadata, nothing is fetched to be
        overwritten)."""
        conn = self.conn
        conn.link.sync_meta(to=OWNER_SERVER)
        node = conn.server
        nbytes = SharedHeap._payload_nbytes(data)
        p0, p1 = node._page_range(a, max(1, nbytes))
        conn.link.claim(list(range(p0, p1 + 1)), to=OWNER_SERVER)
        node.write(a, data, pid=conn.server_pid)

    def heap(self) -> SharedHeap:
        return self.conn.server.heap

    @property
    def page_size(self) -> int:
        return self.conn.server.page_size
