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
messages, one-sided puts and gets) are the reference package's, charge
for charge.

The programmer-facing API is the CXL path's (§5.6): ``FallbackConnection``
mirrors ``Connection.call``/``invoke``/``invoke_async``/``invoke_stream``
including seals and sandboxes, over the same descriptor ring layout;
``send_msg`` models a descriptor's flight over the link. Pipelined invokes
are *staged* and ``flush``ed as one flight (cMPI-style one-sided ``put``s,
one per direction); a streaming reply comes back in staged chunk flights
the client pulls. ``LinkPool`` stripes many clients of one pod pair over
a few links, and a flush on any member flies every member's staged
flight on that stripe. The bulk KV handoff across pods moves pool pages
through the page-copy kernels and charges them to the link with
``put_bytes``, one one-sided flight with a completion word.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import addr as gaddr
from .channel import BusyWaitPolicy, DescriptorRing, RING_SLOT_BYTES, \
    F_DEADLINE, F_SANDBOXED, F_SEALED, OK, R_DONE, R_EMPTY, R_ERR, \
    E_DEADLINE, E_EXCEPTION, E_OVERLOAD, _admission_park, _now_us, \
    _SLOT_WORDS, _W_RET
from .errors import ChannelError, DeadlineExceeded, Overloaded, \
    OwnershipMiss, SealViolation
from .heap import SharedHeap
from .sandbox import SandboxManager
from .scope import Scope, create_scope, implicit_scope
from .seal import S_COMPLETE, SealManager

OWNER_CLIENT = 0
OWNER_SERVER = 1

# the 8-byte completion word a one-sided put/get publishes after its bulk
# payload lands (cMPI framing: the receiver polls this word instead of
# exchanging per-message acks — its wire cost rides the same flight)
COMPLETION_WORD_BYTES = 8


class _FlightEntry:
    """One staged (posted, not yet flown) pipelined invoke."""

    __slots__ = ("slot", "scope", "sealed", "seal_idx")

    def __init__(self, slot: int, scope, sealed: bool, seal_idx: int):
        self.slot = slot
        self.scope = scope
        self.sealed = sealed
        self.seal_idx = seal_idx


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
        tr = self.replica[0]._tracer
        if tr is not None:
            # ShmCheck: the replicas are ONE logical heap — fold them
            # into one shadow space so a migrated page keeps its identity
            tr.alias_space(self.replica[1], self.replica[0])
        # allocator state must be common (one logical heap): client's heap
        # object is the source of truth for allocation; mirror page states.
        self.owner = np.full(num_pages, OWNER_CLIENT, dtype=np.uint8)
        # per-destination completion words (cMPI one-sided framing): a
        # ``put``/``get`` publishes completion[to] after its payload; the
        # receiver polls the word instead of waiting on a message ack
        self.completion = np.zeros(2, dtype=np.uint64)
        # stats
        self.bytes_moved = 0
        self.page_faults = 0
        self.ownership_misses = 0
        self.msgs = 0
        self.n_puts = 0
        self.n_gets = 0
        # round trips a run-at-a-time DSM would have paid that the bulk
        # consecutive-run batching collapsed into one (satellite of the
        # ownership_misses accounting — see ``migrate``)
        self.migrate_rtts_saved = 0

    def _wire(self, nbytes: int) -> None:
        self.bytes_moved += nbytes
        if self.link_latency_us:
            time.sleep(self.link_latency_us * 1e-6)

    def send_msg(self, nbytes: int) -> None:
        """An explicit message (RPC descriptor / completion) on the wire."""
        self.msgs += 1
        self._wire(nbytes)

    def send_batch(self, count: int, nbytes: int) -> None:
        """``count`` messages pipelined into ONE wire flight (the cMPI
        amortization: in-flight requests share the link latency; only
        the bytes scale with the batch)."""
        self.msgs += count
        self._wire(nbytes)

    def claim(self, pages: List[int], to: int) -> None:
        """Metadata-only ownership flip for pages the claimant is about
        to fully overwrite (fresh allocations, reply blobs): a real DSM
        write-allocates such extents without fetching the stale remote
        copy, so no bytes and no latency go on the wire."""
        if pages:
            self.owner[np.asarray(pages)] = to
            tr = self.replica[0]._tracer
            if tr is not None:
                # ownership hand-off is a synchronization barrier: the
                # claimant fully overwrites, so prior accesses are dead
                tr.reset_pages(self.replica[0], pages)

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

    def _copy_pages(self, need: List[int], to: int) -> None:
        """Copy ``need`` (sorted, all unowned by ``to``) between replicas
        and flip ownership — one slice memcpy per consecutive run, not
        one per page. A run-at-a-time DSM would also pay one fetch round
        trip per run; the callers here move the whole list in ONE wire
        op, so the collapsed round trips are counted as saved."""
        src = self.replica[1 - to].buf
        dst = self.replica[to].buf
        ps = self.page_size
        runs = self._runs(need)
        for lo, hi in runs:
            dst[lo * ps : hi * ps] = src[lo * ps : hi * ps]
        self.owner[np.asarray(need)] = to
        self.migrate_rtts_saved += len(runs) - 1
        tr = self.replica[0]._tracer
        if tr is not None:
            # a page migration is an ownership-transfer sync edge: the
            # new owner sees every write the old owner published
            tr.reset_pages(self.replica[0], need)

    def migrate(self, pages: List[int], to: int) -> int:
        """Fetch ``pages`` to node ``to`` (§5.6 page-fault service path).

        Returns the number of pages actually moved.
        """
        need = sorted(p for p in pages if self.owner[p] != to)
        if not need:
            return 0
        self._copy_pages(need, to)
        self.page_faults += 1          # one fault services the whole range
        self._wire(len(need) * self.page_size)  # bulk fetch on the wire
        return len(need)

    # -- cMPI-style one-sided primitives --------------------------------
    def _one_sided(self, pages: List[int], to: int, payload_bytes: int,
                   msgs: int) -> int:
        need = sorted(p for p in pages if self.owner[p] != to)
        if need:
            self._copy_pages(need, to)
            self.page_faults += 1
        self.msgs += msgs
        self._wire(len(need) * self.page_size + payload_bytes
                   + COMPLETION_WORD_BYTES)
        self.completion[to] += 1       # publish AFTER the payload lands
        return len(need)

    def put(self, pages: List[int], to: int, payload_bytes: int = 0,
            msgs: int = 1) -> int:
        """One-sided bulk write toward node ``to``: every not-yet-owned
        page of ``pages`` plus ``payload_bytes`` of framing (descriptor
        or completion records) crosses as ONE asynchronous wire flight,
        then the direction's completion word is published. No per-message
        ack ping-pong — the receiver polls ``completion[to]``; the word's
        8 bytes ride the same flight. Returns the pages moved."""
        self.n_puts += 1
        return self._one_sided(pages, to, payload_bytes, msgs)

    def get(self, pages: List[int], frm: int, payload_bytes: int = 0,
            msgs: int = 1) -> int:
        """One-sided bulk read from node ``frm`` — the mirror of ``put``
        (the initiator pulls the pages toward itself instead of pushing
        them away; same single flight, same completion word)."""
        self.n_gets += 1
        return self._one_sided(pages, 1 - frm, payload_bytes, msgs)

    def put_bytes(self, nbytes: int, to: int) -> None:
        """One-sided payload-only put (no page-table involvement): the
        byref KV-page path moves pool pages through the scope_copy
        gather→wire→scatter kernels, and the link charges that bulk as a
        single one-sided flight with a completion word."""
        self.msgs += 1
        self.n_puts += 1
        self._wire(nbytes + COMPLETION_WORD_BYTES)
        self.completion[to] += 1

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
        """The load/store permission check: raise ``OwnershipMiss`` on the
        first page of the extent this node does not currently own — the
        §5.6 page-fault analogue, surfaced instead of serviced."""
        p0, p1 = self._page_range(a, nbytes)
        for p in range(p0, p1 + 1):
            if self.link.owner[p] != self.node_id:
                raise OwnershipMiss(p)

    def _fault_in(self, a: int, nbytes: int) -> None:
        """Fault-and-fetch: a miss is *counted*, then serviced by a bulk
        migration of the whole unowned extent (one fault, one wire op)."""
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
        """Strict read: no transparent migration. Touching a page the peer
        holds mid-flight raises ``OwnershipMiss`` to the caller."""
        self.check_owned(a, nbytes)
        return self.heap.read(a, nbytes)

    def write(self, a: int, data, pid: int = 0) -> None:
        self._fault_in(a, SharedHeap._payload_nbytes(data))
        self.heap.write(a, data, pid=pid)

    def owns(self, page: int) -> bool:
        return self.link.owner[page] == self.node_id


class FallbackConnection:
    """Two-node RPC over the DSM link. API mirrors ``Connection``."""

    def __init__(self, num_pages: int = 4096, page_size: int = 4096,
                 link_latency_us: float = 3.0, client_pid: int = 1,
                 server_pid: int = 2, ring_capacity: int = 64,
                 functions: Optional[Dict[int, Callable]] = None,
                 heap_id: int = 1, link: Optional[DSMLink] = None,
                 one_sided: bool = True,
                 window_seal_batching: bool = True,
                 config=None):
        from ..configs.global_config import global_config
        cfg = config or global_config
        # ``link`` shares an existing DSMLink (heap replicas + ownership
        # table) with other connections — the LinkPool multiplexing that
        # lifts the paper's one-client-per-link limitation. Without it
        # the connection owns a private link, exactly as before.
        if link is None:
            link = DSMLink(num_pages, page_size, link_latency_us,
                           heap_id=heap_id)
        self.link = link
        # ``one_sided`` frames staged flights as cMPI put/get bulk
        # transfers (one flight per direction); False keeps the legacy
        # send_batch + migrate ping-pong (the baseline framing).
        self.one_sided = one_sided
        # ``window_seal_batching`` releases a sealed pipeline window's
        # seals in ONE permission epoch at flush time (§5.3 composed
        # with pipelined flights) instead of one epoch per future.
        self.window_seal_batching = window_seal_batching
        self._pool = None              # set by LinkPool.connect
        self._stripe = 0
        self.client = DSMNode(self.link, OWNER_CLIENT)
        self.server = DSMNode(self.link, OWNER_SERVER)
        self.client_pid = client_pid
        self.server_pid = server_pid
        # allocation + seals happen against the client replica (the single
        # allocator of this 1:1 link) and metadata is mirrored on demand.
        self.seals = SealManager(self.client.heap)
        self.sandboxes = SandboxManager(self.server.heap)
        # The descriptor ring is daemon-owned heap bytes on the client
        # replica; its slot record is what ``send_msg`` carries.
        self.ring = DescriptorRing(self.client.heap, ring_capacity)
        self._next_seq = 1
        # ``functions`` may be a Channel's live handler table: the router
        # bridges a cross-pod client to the same server code the CXL path
        # dispatches to (§5.6 "interfaces are identical").
        self.functions: Dict[int, Callable[["FallbackServerCtx", int], int]] \
            = functions if functions is not None else {}
        # typed data plane bookkeeping (core/marshal.py) + tracked
        # implicit scopes (scope-less new_bytes must not leak pages)
        self._reply_free: List[Scope] = []
        self._reply_live: Dict[int, Scope] = {}
        self._implicit: Optional[Scope] = None
        self._implicit_scopes: List[Scope] = []
        # pipelined-flight state (invoke_async): descriptors posted but
        # not yet flown; flush() pipelines them in one wire flight
        self._flight: List["_FlightEntry"] = []
        self._flight_errors: Dict[int, BaseException] = {}
        self._fb_abandoned: List["_FlightEntry"] = []
        # streaming replies (invoke_stream): recycled chunk-chain scopes,
        # the per-call generation counter, and the live client iterators
        # (so close() can fail their waiters exactly once)
        self._chain_free: List[Scope] = []
        self._stream_gen = 0
        self._client_streams: List = []
        # bounded admission queue for a full ring (§5.4 backpressure) —
        # same contract as Connection: park up to admission_wait_s (or
        # the remaining descriptor deadline) before typed Overloaded
        self.admission_wait_s = cfg.admission_wait_s
        self.admission_max_waiters = cfg.admission_max_waiters
        self._admission_waiters = 0
        self.wait_policy = BusyWaitPolicy(
            fixed_sleep_us=cfg.wait_fixed_sleep_us, window=cfg.wait_window)
        # server-side pre-dispatch admission gate (§5.4); wired by
        # ServiceDef.serve when an AdmissionInterceptor is registered
        self.admission = None
        self.n_calls = 0
        self.n_invokes = 0
        self.marshal_bytes = 0
        self.n_flushes = 0
        self.n_stream_flights = 0
        self.n_admission_waits = 0
        self.n_overloads = 0
        # windowed seal-epoch batching bookkeeping: seal idxs the flush
        # already released (their futures must not release again) and
        # the number of one-epoch window flushes performed
        self._window_released: set = set()
        self.n_window_seal_flushes = 0
        self.closed = False

    # -- client-side API (identical shape to Connection) -----------------
    def create_scope(self, size_bytes: int) -> Scope:
        scope = create_scope(self.client.heap, size_bytes,
                             owner=self.client_pid)
        # write-allocate: a fresh scope's pages have no remote content
        # worth fetching, so ownership flips by metadata alone — without
        # this, a page the server owned in a previous life would page-
        # fault back over the wire just to be overwritten
        s, n = scope.page_range()
        self.link.claim(list(range(s, s + n)), to=OWNER_CLIENT)
        return scope

    def new_bytes(self, data: bytes, scope: Optional[Scope] = None) -> int:
        if scope is None:
            # same contract as Connection.new_bytes: implicit allocations
            # share a tracked connection-owned scope, freed on close
            scope = implicit_scope(self, len(data), self.link.page_size)
        # client writes fault pages back to the client side if needed
        a = scope.alloc(len(data))
        self.client.write(a, data, pid=self.client_pid)
        return a

    def add(self, fn_id: int, fn) -> None:
        self.functions[fn_id] = fn

    def add_typed(self, fn_id: int, fn) -> None:
        """Typed handler registration — same contract as
        ``Channel.add_typed`` (§5.6: identical programmer-facing API)."""
        from .marshal import typed_handler
        self.functions[fn_id] = typed_handler(fn)

    def invoke(self, fn_id: int, *args, **kw):
        """Typed invoke: the SAME surface as ``Connection.invoke``, but
        the arguments travel by value over the link — ``serial.encode``
        into one blob, a single copy across, decode on the far side (the
        §5.6 copy semantics instead of pointer passing)."""
        from .marshal import invoke_fallback
        return invoke_fallback(self, fn_id, args, **kw)

    def _post(self, fn_id: int, arg_addr: int, scope: Optional[Scope],
              sealed: bool, sandboxed: bool, flags_extra: int,
              deadline_us: int) -> Tuple[int, int]:
        """Shared posting half of ``call`` and ``post_async``: claim a
        ring slot (overflow-checked, seq claimed only on success) and
        publish the descriptor record. Nothing goes on the wire yet."""
        if self.closed:
            raise ChannelError("call on closed connection")
        flags = flags_extra
        seal_idx = 0
        sc_start = sc_count = 0
        if scope is not None:
            sc_start, sc_count = scope.page_range()
        if sealed:
            if scope is None:
                raise SealViolation("sealed call requires a scope")
        if sandboxed:
            flags |= F_SANDBOXED
        if deadline_us:
            flags |= F_DEADLINE

        ring = self.ring
        seq = self._next_seq
        slot = seq % ring.capacity
        if ring.state_of(slot) != R_EMPTY:
            # full ring: bounded admission queue (§5.4), not an instant
            # failure — reaping landed completions of abandoned flights
            # can free the slot mid-wait
            _admission_park(self, ring, slot, deadline_us,
                            reap=self._reap_abandoned_flight)
        if sealed:   # seal only after every rejecting path
            seal_idx = self.seals.seal(scope, holder=self.client_pid)
            flags |= F_SEALED
        self._next_seq = seq + 1
        tr = self.client.heap._tracer
        if tr is not None:
            tr.sync_release(("req", id(ring), slot))
        ring.post(slot, seq, fn_id, flags, arg_addr, seal_idx,
                  sc_start, sc_count, ret=deadline_us)
        return slot, seal_idx

    def call(self, fn_id: int, arg_addr: int = gaddr.NULL,
             scope: Optional[Scope] = None, sealed: bool = False,
             sandboxed: bool = False, batch_release: bool = False,
             flags_extra: int = 0, deadline_us: int = 0,
             **_ignored) -> int:
        """Mirrors ``Connection.call``; extra CXL-tuning kwargs (timeouts,
        spin intervals) are accepted and ignored — the fallback call is
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
        tr = self.client.heap._tracer
        if tr is not None:
            tr.sync_acquire(("rep", id(ring), slot))
        ret, _state, _status = ring.consume(slot)
        if sealed:
            if batch_release:
                self.seals.release_batched(seal_idx, holder=self.client_pid)
            else:
                self.seals.release(seal_idx, holder=self.client_pid)
        self.n_calls += 1
        return ret

    # the fallback call is already synchronous end-to-end, so the inline
    # variant is the same entry point (RoutedConnection relies on this)
    call_inline = call

    def invoke_async(self, fn_id: int, *args, **kw):
        """Pipelined typed invoke over the link: the descriptor and its
        by-value payload are staged locally and ``flush()``ed in ONE wire
        flight with every other staged invoke — the cMPI amortization
        (in-flight requests share the link latency). Same future surface
        as ``Connection.invoke_async``."""
        from .marshal import invoke_async_fallback
        return invoke_async_fallback(self, fn_id, args, **kw)

    def invoke_stream(self, fn_id: int, *args, **kw):
        """Streaming typed invoke over the link: the generator handler's
        reply chain crosses in *staged chunk flights* — up to ``window``
        chunks per wire flush, bulk-migrated together — instead of one
        buffered reply at the end. Same iterator surface as
        ``Connection.invoke_stream``."""
        from .marshal import invoke_stream_fallback
        return invoke_stream_fallback(self, fn_id, args, **kw)

    def serve(self, instance, interceptors=()):
        """Declarative service registration — mirror of
        ``Channel.serve`` (§5.6: identical programmer-facing API)."""
        from .service import service_def
        sdef = service_def(instance)
        sdef.serve(self, instance, interceptors)
        return sdef

    # -- the pipelined flight (client half of invoke_async) ---------------
    def post_async(self, fn_id: int, arg_addr: int, scope: Scope,
                   sealed: bool = False, sandboxed: bool = False,
                   flags_extra: int = 0, deadline_us: int = 0) -> int:
        """Stage a descriptor for the next flight; returns its slot."""
        slot, seal_idx = self._post(fn_id, arg_addr, scope, sealed,
                                    sandboxed, flags_extra, deadline_us)
        self._flight.append(_FlightEntry(slot, scope, sealed, seal_idx))
        return slot

    def in_flight(self, slot: int) -> bool:
        return any(e.slot == slot for e in self._flight)

    def flush(self) -> int:
        """Fly the staged batch. One-sided framing (default): the whole
        flight — descriptor records AND every argument page — crosses as
        ONE cMPI-style ``put`` toward the server, and the completions AND
        every reply page come back as ONE ``put`` toward the client; each
        direction pays the link latency exactly once, completion words
        instead of per-message acks. Legacy framing (``one_sided=False``)
        keeps the descriptor flight and the page migration as separate
        wire ops per direction. A pooled connection delegates to its
        stripe so every member's staged flight shares the same two
        transfers. Returns the number of RPCs served."""
        if self._pool is not None:
            return self._pool.flush_stripe(self._stripe)
        entries = self._take_flight()
        if not entries:
            return 0
        n = len(entries)
        link = self.link
        arg_pages = self._flight_arg_pages(entries)
        if self.one_sided:
            link.sync_meta(to=OWNER_SERVER)
            link.put(arg_pages, to=OWNER_SERVER,
                     payload_bytes=n * RING_SLOT_BYTES, msgs=n)
        else:
            link.send_batch(n, n * RING_SLOT_BYTES)
            link.sync_meta(to=OWNER_SERVER)
            if arg_pages:
                link.migrate(arg_pages, to=OWNER_SERVER)
        reply_pages = self._serve_flight(entries)
        if self.one_sided:
            link.put(reply_pages, to=OWNER_CLIENT,
                     payload_bytes=n * RING_SLOT_BYTES, msgs=n)
        else:
            link.send_batch(n, n * RING_SLOT_BYTES)
            if reply_pages:
                link.migrate(reply_pages, to=OWNER_CLIENT)
        self._end_flight(entries)
        return n

    # -- flight halves (shared with LinkPool.flush_stripe) -----------------
    def _take_flight(self) -> List["_FlightEntry"]:
        """Detach the staged flight (counted as one flush once flown)."""
        entries, self._flight = self._flight, []
        if entries:
            self.n_flushes += 1
        return entries

    def _flight_arg_pages(self, entries: List["_FlightEntry"]) -> List[int]:
        """Every staged argument page the server does not own yet — the
        request half of the bulk transfer (one fetch for the whole
        flight, not one page-fault round trip per RPC)."""
        link = self.link
        return [p for e in entries
                for p in range(e.scope.start_page,
                               e.scope.start_page + e.scope.num_pages)
                if link.owner[p] != OWNER_SERVER]

    def _serve_flight(self, entries: List["_FlightEntry"]) -> List[int]:
        """Serve every slot of a detached flight; per-entry failures
        complete the slot R_ERR (isolated — the rest of the flight
        proceeds). Returns the reply pages that must travel back."""
        ring = self.ring
        link = self.link
        reply_pages: List[int] = []
        for e in entries:
            try:
                self._serve(e.slot)
            except BaseException as exc:
                self._flight_errors[e.slot] = exc
                if isinstance(exc, DeadlineExceeded):
                    status, word = E_DEADLINE, 0
                elif isinstance(exc, Overloaded):
                    # shed pre-dispatch: the ret word carries the
                    # suggested retry-after (µs), mirroring the CXL path
                    status = E_OVERLOAD
                    word = int(exc.retry_after_s * 1e6)
                else:
                    status, word = E_EXCEPTION, 0
                ring.complete(e.slot, word, R_ERR, status)
                continue
            ret = ring._words[ring._w0 + e.slot * _SLOT_WORDS + _W_RET]
            scope = self._reply_live.get(int(ret))
            if scope is not None:
                reply_pages.extend(range(scope.start_page,
                                         scope.start_page + scope.num_pages))
        return [p for p in reply_pages
                if link.owner[p] != OWNER_CLIENT]

    def _end_flight(self, entries: List["_FlightEntry"]) -> None:
        """Post-flight hygiene: release the window's completed seals in
        ONE permission epoch (§5.3 batch_release composed with pipelined
        flights — the per-future release is skipped via
        ``_consume_window_release``), then reap abandoned slots."""
        if self.window_seal_batching:
            abandoned = {a.slot for a in self._fb_abandoned}
            idxs = [e.seal_idx for e in entries
                    if e.sealed and e.slot not in abandoned
                    and self.seals.state_of(e.seal_idx) == S_COMPLETE]
            if idxs:
                self.seals.release_window(idxs, holder=self.client_pid)
                self._window_released.update(idxs)
                self.n_window_seal_flushes += 1
        self._reap_abandoned_flight()

    def _consume_window_release(self, seal_idx: int) -> bool:
        """True if the flight's window flush already released this seal
        (the settling future must not pay a second release)."""
        if seal_idx in self._window_released:
            self._window_released.discard(seal_idx)
            return True
        return False

    def abandon_flight_entry(self, slot: int, scope: Scope, sealed: bool,
                             seal_idx: int) -> None:
        """A flight future was cancelled: its slot is reaped (consumed,
        reply recycled, scope destroyed) after the next flush serves it."""
        self._fb_abandoned.append(_FlightEntry(slot, scope, sealed,
                                               seal_idx))

    def _reap_abandoned_flight(self) -> None:
        still = []
        for e in self._fb_abandoned:
            if self.ring.state_of(e.slot) < R_DONE:
                still.append(e)
                continue
            tr = self.client.heap._tracer
            if tr is not None:
                tr.sync_acquire(("rep", id(self.ring), e.slot))
            ret, state, _status = self.ring.consume(e.slot)
            self._flight_errors.pop(e.slot, None)
            if e.sealed:
                if not self._consume_window_release(e.seal_idx):
                    try:
                        self.seals.release(e.seal_idx,
                                           holder=self.client_pid)
                    except SealViolation:
                        pass
            if state == R_DONE:
                from .marshal import _recycle_reply
                _recycle_reply(self, ret)
            if e.scope.live:
                e.scope.destroy()
        self._fb_abandoned = still

    # -- streaming replies (server half of invoke_stream) ------------------
    def start_stream(self, stream) -> None:
        """Wire the streaming descriptor across and start the handler's
        generator; chunks flow later, flight by flight, as the client
        iterator pulls (``pump_stream``). A failure to *start* (missing
        fn, pre-lapsed deadline, unsealed region, handler raising before
        the first yield) completes the slot R_ERR and is surfaced on the
        client's first ``next()``."""
        self.link.send_msg(RING_SLOT_BYTES)
        self.link.sync_meta(to=OWNER_SERVER)
        try:
            stream._srv = self._serve_stream_start(stream.slot)
        except BaseException as exc:
            if isinstance(exc, DeadlineExceeded):
                status = E_DEADLINE
            elif isinstance(exc, Overloaded):
                status = E_OVERLOAD
            else:
                status = E_EXCEPTION
            self._flight_errors[stream.slot] = exc
            self.ring.complete(stream.slot, 0, R_ERR, status)
        self._client_streams.append(stream)

    def _serve_stream_start(self, slot: int):
        """The descriptor-processing half of ``_serve`` for a streaming
        request: instead of running the handler to completion, create the
        ``ServerStream`` (the generator is built, nothing is decoded yet)
        and leave the slot open until the chain ends."""
        ring = self.ring
        (_seq, fn_id, flags, arg, seal_idx, _ret, _st, _status,
         sc_start, sc_count) = ring.load(slot)
        fn = self.functions.get(fn_id)
        if fn is None:
            raise ChannelError(f"no function {fn_id}")
        if flags & F_DEADLINE and _now_us() > _ret:
            raise DeadlineExceeded(
                f"RPC {fn_id} deadline lapsed on the link")
        if flags & F_SEALED and not self.seals.is_sealed(seal_idx):
            raise SealViolation("receiver found region unsealed")
        gate = self.admission
        if gate is not None:
            retry_after_us = gate.admit(self.client_pid, fn_id)
            if retry_after_us is not None:
                raise Overloaded(
                    f"server shed stream RPC {fn_id} (E_OVERLOAD)",
                    retry_after_s=retry_after_us * 1e-6)
        try:
            ctx = FallbackServerCtx(self, flags)
            ctx.deadline_us = _ret if flags & F_DEADLINE else 0
            if flags & F_SANDBOXED and not gaddr.is_null(arg) and sc_count:
                # server must own the pages before sandboxing them
                self.link.migrate(
                    list(range(sc_start, sc_start + sc_count)),
                    to=OWNER_SERVER)
                with self.sandboxes.enter(sc_start, sc_count) as sb:
                    ctx.sandbox = sb
                    ret = fn(ctx, arg)
            else:
                ret = fn(ctx, arg)
            if not getattr(ret, "_server_stream", False):
                raise ChannelError(
                    "stream invoke reached a non-streaming handler")
        except BaseException:
            if gate is not None:
                gate.release()
            raise
        ret.bind(self, ring, slot, seal_idx, flags, sc_start, sc_count)
        if gate is not None:
            # the stream stays admitted until its chain ends
            ret.release_cb = gate.release
        return ret

    def pump_stream(self, srv, max_chunks: int) -> List[int]:
        """One staged chunk flight: advance the generator up to
        ``max_chunks`` chunks server-side, then cross the wire ONCE —
        one batched chunk-descriptor message plus one bulk migration of
        every chunk page back to the client. Returns the chunk addrs now
        readable client-side."""
        if self.closed:
            raise ChannelError("pump_stream on closed connection")
        addrs: List[int] = []
        srv.pump(max_chunks=max_chunks, collect=addrs)
        if addrs:
            link = self.link
            pages = {gaddr.page_of(srv.anchor)}
            for a in addrs:
                scope = self._reply_live.get(a)
                if scope is not None:
                    pages.update(range(scope.start_page,
                                       scope.start_page + scope.num_pages))
            link.send_batch(len(addrs), len(addrs) * RING_SLOT_BYTES)
            need = sorted(p for p in pages
                          if link.owner[p] != OWNER_CLIENT)
            if need:
                link.migrate(need, to=OWNER_CLIENT)
            self.n_stream_flights += 1
        return addrs

    def _drop_client_stream(self, stream) -> None:
        if stream in self._client_streams:
            self._client_streams.remove(stream)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            if self._pool is not None:
                self._pool.detach(self)
            # fail the staged flight: every unsettled future sees a
            # ChannelError (its result() checks closed first) and each
            # staged argument scope is drained exactly once
            for e in (*self._flight, *self._fb_abandoned):
                if e.scope.live:
                    e.scope.destroy()
            self._flight.clear()
            self._fb_abandoned.clear()
            self._flight_errors.clear()
            # fail every live stream iterator the same way: the waiter
            # sees ChannelError (exactly once — the state flip is
            # guarded), the generator is closed, and the argument scope
            # is drained here; chunk scopes follow with _reply_live and
            # the chain freelist below
            for s in list(self._client_streams):
                s._fail_on_close()
            self._client_streams.clear()
            for s in self._chain_free:
                if s.live:
                    s.destroy()
            self._chain_free.clear()
            for s in self._implicit_scopes:
                if s.live:
                    s.destroy()
            self._implicit_scopes.clear()
            self._implicit = None
            for s in (*self._reply_free, *self._reply_live.values()):
                if s.live:
                    s.destroy()
            self._reply_free.clear()
            self._reply_live.clear()
            tr = self.client.heap._tracer
            if tr is not None:
                tr.on_conn_close(self.client.heap, self.client_pid,
                                 self.seals)

    # -- server half (shares the CXL-path descriptor format) --------------
    def _serve(self, slot: int) -> None:
        ring = self.ring
        (seq, fn_id, flags, arg, seal_idx, _ret, _st, _status,
         sc_start, sc_count) = ring.load(slot)
        tr = self.client.heap._tracer
        if tr is not None:
            tr.sync_acquire(("req", id(ring), slot))

        fn = self.functions.get(fn_id)
        if fn is None:
            raise ChannelError(f"no function {fn_id}")

        # deadline gate: a request that expired on the wire is dropped
        # before the server touches a single argument page
        if flags & F_DEADLINE and _now_us() > _ret:
            raise DeadlineExceeded(
                f"RPC {fn_id} deadline lapsed on the link")

        # admission gate (§5.4): shed before the handler — the flight
        # machinery maps Overloaded to an E_OVERLOAD completion whose
        # ret word carries the suggested retry-after
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
            if tr is not None:
                tr.sync_release(("rep", id(ring), slot))
            ring.complete(slot, ret, R_DONE, OK)
        finally:
            if gate is not None:
                gate.release()

    def stats(self) -> Dict[str, int]:
        return {
            "bytes_moved": self.link.bytes_moved,
            "page_faults": self.link.page_faults,
            "ownership_misses": self.link.ownership_misses,
            # round trips the consecutive-run batching collapsed (one
            # bulk transfer where a run-at-a-time DSM pays one per run)
            "migrate_rtts_saved": self.link.migrate_rtts_saved,
            "msgs": self.link.msgs,
            "one_sided_puts": self.link.n_puts,
            "one_sided_gets": self.link.n_gets,
            "window_seal_flushes": self.n_window_seal_flushes,
            "calls": self.n_calls,
        }


class LinkPool:
    """A pod pair's shared fallback plane: ``pool_size`` DSMLinks
    multiplexing N ``FallbackConnection`` clients — the lift of the
    paper's one-client-per-link §5.6 limitation.

    Connections are *striped* over the links at connect time
    (``stripe="rr"`` round-robin | ``"pid"`` hash by client pid); every
    connection on a stripe shares that link's heap replicas and
    ownership table. The latency win is shared flights: ``flush()`` on
    ANY member flies EVERY member's staged descriptors over the stripe
    as one combined one-sided transfer per direction, so M pipelining
    clients to the same remote pod pay the link latency once per stripe
    window instead of once per client per direction pair.
    """

    def __init__(self, num_pages: int = 4096, page_size: int = 4096,
                 link_latency_us: float = 3.0, pool_size: int = 2,
                 stripe: str = "rr",
                 heap_ids: Optional[List[int]] = None):
        if pool_size < 1:
            raise ChannelError(f"LinkPool needs >= 1 link, got {pool_size}")
        if stripe not in ("rr", "pid"):
            raise ChannelError(f"unknown stripe policy {stripe!r}")
        self.pool_size = pool_size
        self.stripe_policy = stripe
        self.links = [
            DSMLink(num_pages, page_size, link_latency_us,
                    heap_id=(heap_ids[i] if heap_ids else 1 + i))
            for i in range(pool_size)
        ]
        self.members: List[List[FallbackConnection]] = \
            [[] for _ in range(pool_size)]
        self._rr = 0
        self.n_connects = 0
        self.n_shared_flushes = 0

    def _pick_stripe(self, client_pid: int) -> int:
        if self.stripe_policy == "pid":
            return client_pid % self.pool_size
        idx = self._rr % self.pool_size
        self._rr += 1
        return idx

    def connect(self, client_pid: int = 1, server_pid: int = 2,
                ring_capacity: int = 64,
                functions: Optional[Dict[int, Callable]] = None,
                one_sided: bool = True,
                window_seal_batching: bool = True) -> FallbackConnection:
        """Mint a pooled connection on the next stripe. It shares the
        stripe link's pages with its co-members; its ring, seals, and
        handler table stay per-connection (SPSC per client, the paper's
        model)."""
        idx = self._pick_stripe(client_pid)
        conn = FallbackConnection(
            client_pid=client_pid, server_pid=server_pid,
            ring_capacity=ring_capacity, functions=functions,
            link=self.links[idx], one_sided=one_sided,
            window_seal_batching=window_seal_batching)
        conn._pool = self
        conn._stripe = idx
        self.members[idx].append(conn)
        self.n_connects += 1
        return conn

    def detach(self, conn: FallbackConnection) -> None:
        members = self.members[conn._stripe]
        if conn in members:
            members.remove(conn)
        conn._pool = None

    def flush_stripe(self, idx: int) -> int:
        """Fly every member's staged flight over stripe ``idx`` as ONE
        combined one-sided transfer per direction: descriptors + every
        argument page out, completions + every reply page back. Returns
        the total RPCs served across members."""
        link = self.links[idx]
        batches: List[Tuple[FallbackConnection, List[_FlightEntry]]] = []
        for conn in list(self.members[idx]):
            if conn.closed:
                continue
            entries = conn._take_flight()
            if entries:
                batches.append((conn, entries))
        if not batches:
            return 0
        n = sum(len(entries) for _, entries in batches)
        link.sync_meta(to=OWNER_SERVER)
        arg_pages = [p for conn, entries in batches
                     for p in conn._flight_arg_pages(entries)]
        link.put(arg_pages, to=OWNER_SERVER,
                 payload_bytes=n * RING_SLOT_BYTES, msgs=n)
        reply_pages: List[int] = []
        for conn, entries in batches:
            reply_pages.extend(conn._serve_flight(entries))
        link.put(reply_pages, to=OWNER_CLIENT,
                 payload_bytes=n * RING_SLOT_BYTES, msgs=n)
        for conn, entries in batches:
            conn._end_flight(entries)
        self.n_shared_flushes += 1
        return n

    def flush_all(self) -> int:
        """Fly every stripe's staged flights (one transfer pair each)."""
        return sum(self.flush_stripe(i) for i in range(self.pool_size))

    def stats(self) -> Dict[str, int]:
        return {
            "pool_size": self.pool_size,
            "connects": self.n_connects,
            "shared_flushes": self.n_shared_flushes,
            "bytes_moved": sum(l.bytes_moved for l in self.links),
            "page_faults": sum(l.page_faults for l in self.links),
            "msgs": sum(l.msgs for l in self.links),
            "one_sided_puts": sum(l.n_puts for l in self.links),
            "one_sided_gets": sum(l.n_gets for l in self.links),
            "migrate_rtts_saved": sum(l.migrate_rtts_saved
                                      for l in self.links),
        }


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
        tr = self.conn.server.heap._tracer
        if tr is not None:
            # ShmCheck: an invalid pointer reaching an unsandboxed
            # handler is the §4.4 wild-dereference bug class
            return tr.checked_deref_node(self.conn.server, a, nbytes)
        return self.conn.server.read(a, nbytes)

    def write(self, a: int, data) -> None:
        """Handler-facing store: sandbox-confined like ``read`` (§4.4)."""
        if self.sandbox is not None:
            self.sandbox.check(a, SharedHeap._payload_nbytes(data))
        self.conn.server.write(a, data, pid=self.conn.server_pid)

    def _daemon_write(self, a: int, data) -> None:
        """Privileged runtime store (reply marshalling): reply scopes are
        carved from the link's single allocator (the client replica)
        mid-request, so the allocator metadata is propagated first — the
        same tiny control message the request path sends (§5.6). The
        reply extent itself is write-allocated: the blob fully overwrites
        its single-tenant scope, so ownership flips by metadata instead
        of fetching the stale client copy just to clobber it."""
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
