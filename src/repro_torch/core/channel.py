"""Channels, connections, and the RPC data path (§4.2, Fig. 6).

A server ``open``s a channel (registered with the orchestrator under a
hierarchical name); clients ``connect`` and receive a ``Connection`` whose
shared-memory heap holds both the RPC argument objects *and* the request
descriptor ring. An RPC is: client writes a descriptor (fn id, GlobalAddr
of the args, seal index, flags) into the ring and the server — polling
under the §5.8 adaptive busy-wait policy — dereferences the pointer
directly. **No argument bytes ever move**; that is the paper's entire
point.

The ring slots live in heap bytes (so the fallback transport can migrate
them like any page) but are accessed through a preallocated NumPy
structured-array view (``DescriptorRing``): every slot field is a strided
view over the heap buffer, so the steady-state path performs **zero
``struct`` repacking and zero Python-level byte copies** — a post is one
record store, a completion is two word stores, a poll is one word load.
Rings are daemon-owned and never sealed, so the checked load/store path
would only add cost without adding safety — same reasoning as the paper
running the descriptor buffer outside the seal machinery.

Threading model: one client per connection (the paper's model — each
client gets its own connection+ring); the server may serve many
connections from one listen loop. ``serve_once`` sweeps every ring's head
state with a single vectorized compare; ``serve_many`` drains every ready
slot found until the channel is idle.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import addr as gaddr
from .errors import ChannelError, DeadlineExceeded, Overloaded, \
    SandboxViolation, SealViolation, WaitTimeout
from .heap import SharedHeap
from .orchestrator import Orchestrator
from .sandbox import SandboxManager
from .scope import Scope, ScopePool, create_scope, implicit_scope
from .seal import SealManager
from ..configs.global_config import ReproConfig, global_config

# Lazily-bound marshalling module (core/marshal.py imports this module for
# the flag constants, so the import direction must stay marshal → channel;
# the first invoke binds it here and the hot path pays one global load).
_marshal = None


def _get_marshal():
    global _marshal
    if _marshal is None:
        from . import marshal
        _marshal = marshal
    return _marshal

# Request-ring slot layout: seq, fn, flags, arg, seal_idx, ret, state,
# status, scope_start, scope_count (the receiver sandboxes exactly the
# scope the sender used — §5.2). Little-endian, no padding: the struct
# format "<QIIQQQIIII" (56 bytes), the reference package's layout, so a
# ring page migrated by the fallback transport reads the same either way.
RING_DTYPE = np.dtype([
    ("seq", "<u8"),
    ("fn", "<u4"),
    ("flags", "<u4"),
    ("arg", "<u8"),
    ("seal_idx", "<u8"),
    ("ret", "<u8"),
    ("state", "<u4"),
    ("status", "<u4"),
    ("scope_start", "<u4"),
    ("scope_count", "<u4"),
])
RING_SLOT_BYTES = RING_DTYPE.itemsize  # 56

# u64-word aliasing of a slot: 7 words; fields that share a word are
# packed little-endian (low half first).
_SLOT_WORDS = RING_SLOT_BYTES // 8
_W_RET = 4       # ret
_W_STATE = 5     # state (low 32) | status (high 32)
_M32 = 0xFFFFFFFF

# slot states
R_EMPTY = 0
R_REQ = 1
R_DONE = 2
R_ERR = 3

# flags
F_SEALED = 1 << 0
F_SANDBOXED = 1 << 1
F_TYPED = 1 << 2     # arg is a typed marshalled request (core/marshal.py)
F_BYVAL = 1 << 3     # typed request travelled by value (serial-encoded)
F_DEADLINE = 1 << 4  # the slot's ret word carries the request deadline
                     # (µs, monotonic clock) at post time; the receiver
                     # drops expired requests with E_DEADLINE before
                     # touching the arguments
F_STREAM = 1 << 5    # streaming reply: the handler is a generator and the
                     # reply is a chain of generation-tagged chunks hung
                     # off the request's stream anchor (core/marshal.py);
                     # the slot completes only when the chain ends

# RPC status codes
OK = 0
E_UNSEALED = 1      # receiver demanded a seal, region was not sealed
E_SANDBOX = 2       # sandbox violation while processing (SIGSEGV→error)
E_NOFUNC = 3
E_EXCEPTION = 4
E_DEADLINE = 5      # request deadline lapsed (dropped server-side, or a
                    # handler raised DeadlineExceeded mid-flight)
E_OVERLOAD = 6      # admission control shed the request pre-dispatch
                    # (§5.4); the reply's ret word carries the suggested
                    # retry-after in µs — the shed cost one descriptor
                    # word, never a handler


def _now_us() -> int:
    """Descriptor deadline clock: µs on the monotonic clock (all
    endpoints are in-process, so one clock serves the whole 'cluster')."""
    return int(time.monotonic() * 1e6)


# client-side wait: GIL-yield polls spent before the §5.8 policy back-off
# kicks in (a reply that lands promptly never pays a real sleep)
_WAIT_SPIN_POLLS = 256


class BusyWaitPolicy:
    """§5.8 adaptive busy-wait: no sleep below 25% load, 5µs between 25–50%,
    150µs above 50%. "Load" is approximated by the poll duty cycle over a
    sliding window. A fixed sleep can be forced for the Fig. 13 sweep."""

    def __init__(self, fixed_sleep_us: Optional[float] = None,
                 window: int = 256):
        self.fixed = fixed_sleep_us
        self.window = window
        self._hits = 0
        self._polls = 0

    def record(self, found_work: bool) -> None:
        self._polls += 1
        if found_work:
            self._hits += 1
        if self._polls >= self.window:
            self._hits //= 2
            self._polls //= 2

    def delay_s(self) -> float:
        """The back-off the policy prescribes right now, in seconds
        (0.0 = spin). Callers may spend it blocked on a doorbell instead
        of a blind nap — the budget is the same either way."""
        if self.fixed is not None:
            return self.fixed * 1e-6 if self.fixed > 0 else 0.0
        load = self._hits / max(1, self._polls)
        if load < 0.25:
            return 0.0
        return 5e-6 if load < 0.5 else 150e-6

    def sleep(self) -> None:
        # time.sleep(0) is a bare GIL yield — the CPython stand-in for
        # "no sleep, keep spinning" (a hardware spin would starve the
        # other thread of the interpreter lock entirely).
        time.sleep(self.delay_s())


def _serve_event_loop(serve_pending: Callable[[], int],
                      sweep_once: Callable[[], int],
                      channels, policy: BusyWaitPolicy,
                      stop: threading.Event, ev: threading.Event) -> None:
    """The one §5.8 busy-wait/doorbell protocol, shared by
    ``Channel.listen`` (one channel) and ``ServerLoop.run`` (many).

    The policy-prescribed back-off is spent blocked on the doorbell event
    rather than in a blind nap: a post that lands while the server is
    backing off wakes it immediately, so the high-load 150µs budget
    bounds the wait instead of gating every batch. The clear → park →
    re-sweep → wait sequence is race-sensitive (a post may land between
    the clear and the park flag), so it lives here exactly once.
    """
    while not stop.is_set():
        n = serve_pending()
        policy.record(n > 0)
        if n == 0:
            delay = policy.delay_s()
            if delay <= 0:
                time.sleep(0)  # spin, but yield the GIL
                continue
            ev.clear()
            for ch in channels:
                ch._parked = True
            # re-check after parking: a post may have raced the clear
            # (posts from here on see _parked and ring the doorbell)
            if sweep_once():
                for ch in channels:
                    ch._parked = False
                policy.record(True)
                continue
            ev.wait(delay)
            for ch in channels:
                ch._parked = False


class DescriptorRing:
    """SPSC descriptor ring: a structured-dtype view over heap bytes.

    ``arr`` is the slot table; each field (``seq``, ``fn``, ``state``, …)
    is also exposed as a strided NumPy view so callers can do field-sliced
    loads/stores (``ring.seq[slot] = …``) or vectorized sweeps
    (``ring.state == R_REQ``) with no repacking. The hottest scalar ops
    additionally go through a u64 word alias of the same bytes: one load
    polls state+status, one store publishes them.
    """

    __slots__ = ("heap", "capacity", "head", "start_page", "arr",
                 "seq", "fn", "flags", "arg", "seal_idx", "ret",
                 "state", "status", "scope_start", "scope_count",
                 "_words", "_w0")

    def __init__(self, heap: SharedHeap, capacity: int = 256):
        self.heap = heap
        self.capacity = capacity
        self.head = 1  # next slot the server will serve (seq starts at 1)
        nbytes = capacity * RING_SLOT_BYTES
        pages = (nbytes + heap.page_size - 1) // heap.page_size
        self.start_page = heap.alloc_pages(pages, owner=0)
        base = self.start_page * heap.page_size
        # raw views — daemon-owned, never sealed (see module docstring)
        self.arr = heap.buf[base : base + nbytes].view(RING_DTYPE)
        for name in RING_DTYPE.names:
            setattr(self, name, self.arr[name])
        # u64 word alias (page-aligned base, so always 8-aligned)
        self._words = heap.buf.data.cast("Q")
        self._w0 = base // 8

    # -- hot-path scalar ops -------------------------------------------
    def post(self, slot: int, seq: int, fn: int, flags: int, arg: int,
             seal_idx: int, sc_start: int, sc_count: int,
             ret: int = 0) -> None:
        """Publish a request: one record store (state=R_REQ included).
        ``ret`` is dead weight until completion, so a posted deadline
        (F_DEADLINE) travels there — zero extra layout, zero extra
        stores."""
        self.arr[slot] = (seq, fn, flags, arg, seal_idx,
                          ret, R_REQ, OK, sc_start, sc_count)

    def load(self, slot: int) -> Tuple:
        """Full-slot load as a tuple of Python scalars."""
        return self.arr[slot].item()

    def load_req(self, slot: int) -> Tuple[int, int, int, int, int, int]:
        """Request-half load: (fn, flags, arg, seal_idx, sc_start, sc_count)
        — the fields the receiver dispatches on, as five word loads."""
        words = self._words
        w = self._w0 + slot * _SLOT_WORDS
        ff = words[w + 1]
        sc = words[w + 6]
        return (ff & _M32, ff >> 32, words[w + 2], words[w + 3],
                sc & _M32, sc >> 32)

    def state_of(self, slot: int) -> int:
        """u32 slot state (one word load; status shares the word)."""
        return self._words[self._w0 + slot * _SLOT_WORDS + _W_STATE] & _M32

    def complete(self, slot: int, ret: int, state: int, status: int) -> None:
        """Receiver half: ret, then state+status in one publishing store."""
        w = self._w0 + slot * _SLOT_WORDS
        self._words[w + _W_RET] = ret
        self._words[w + _W_STATE] = (status << 32) | state

    def consume(self, slot: int) -> Tuple[int, int, int]:
        """Sender half: read (ret, state, status) and free the slot."""
        w = self._w0 + slot * _SLOT_WORDS
        ret = self._words[w + _W_RET]
        ss = self._words[w + _W_STATE]
        self._words[w + _W_STATE] = R_EMPTY  # status resets to OK too
        return ret, ss & _M32, ss >> 32


class RpcError(ChannelError):
    def __init__(self, status: int):
        super().__init__(f"RPC failed with status {status}")
        self.status = status


class _Pending:
    """Client-side record of one tracked async token (``invoke_async``
    futures; raw ``call_async`` tokens stay registry-free so the no-op
    hot path pays nothing). Exists so ``close()`` can drain a pending
    future's scopes exactly once and the reaper can recycle the reply
    of a cancelled/abandoned token when its completion lands."""

    __slots__ = ("sealed", "seal_idx", "typed", "cleanup")

    def __init__(self, sealed: bool = False, seal_idx: int = 0,
                 typed: bool = False,
                 cleanup: Optional[Callable[[], None]] = None):
        self.sealed = sealed
        self.seal_idx = seal_idx
        self.typed = typed
        self.cleanup = cleanup


def _admission_park(conn, ring, slot: int, deadline_us: int,
                    reap: Optional[Callable[[], None]] = None) -> None:
    """Bounded backpressure (§5.4): park the caller of a full ring in a
    bounded admission queue until its slot frees, instead of failing the
    post outright.

    The wait budget derives from the descriptor deadline when the call
    posted one (past that instant the request could not complete in time
    anyway), capped by the connection's ``admission_wait_s``; the poll
    cadence reuses the §5.8 ``BusyWaitPolicy`` after a GIL-yield spin
    budget. Three exits: the slot frees (return, the post proceeds), the
    queue is already at ``admission_max_waiters`` or the budget lapses
    (``Overloaded`` with a suggested retry-after), or the connection is
    closed under the waiter (``ChannelError``). All raising exits happen
    before the seq is claimed — a turned-away post burns no seq.
    """
    if conn._admission_waiters >= conn.admission_max_waiters:
        conn.n_overloads += 1
        raise Overloaded(
            "ring overflow: admission queue full "
            f"({conn.admission_max_waiters} parked waiters)",
            retry_after_s=conn.admission_wait_s)
    budget = conn.admission_wait_s
    if deadline_us:
        budget = min(budget, deadline_us * 1e-6 - time.monotonic())
    policy = conn.wait_policy
    give_up = time.monotonic() + max(0.0, budget)
    spins = _WAIT_SPIN_POLLS
    conn._admission_waiters += 1
    conn.n_admission_waits += 1
    try:
        while ring.state_of(slot) != R_EMPTY:
            if conn.closed:
                raise ChannelError(
                    "connection closed while parked in the admission "
                    "queue")
            if reap is not None:
                reap()   # completions of abandoned tokens free slots
                if ring.state_of(slot) == R_EMPTY:
                    return
            if time.monotonic() > give_up:
                conn.n_overloads += 1
                raise Overloaded(
                    "ring overflow: admission budget lapsed with the "
                    "slot still in flight",
                    retry_after_s=conn.admission_wait_s)
            if spins:
                spins -= 1
                time.sleep(0)
            else:
                # delay_s() may prescribe a pure spin (0.0) — floor it at
                # a 5µs nap so a long park cannot hard-spin the GIL
                time.sleep(policy.delay_s() or 5e-6)
    finally:
        conn._admission_waiters -= 1


class Connection:
    """One client's connection: heap + ring + seal/sandbox managers."""

    def __init__(self, channel: "Channel", heap: SharedHeap, client_pid: int,
                 ring_capacity: int = 256):
        self.channel = channel
        self.heap = heap
        self.client_pid = client_pid
        self.ring = DescriptorRing(heap, ring_capacity)
        self.seals = SealManager(heap)
        self.sandboxes = SandboxManager(heap)
        self._next_seq = 1
        self._scope_pool: Optional[ScopePool] = None
        self.closed = False
        self.last_seal_idx = 0  # seal idx of the most recent sealed call
        self._ctx: Optional["ServerCtx"] = ServerCtx(channel, self, 0)
        # typed data plane (core/marshal.py): pooled argument scopes,
        # server reply scopes recycled through the client, and the
        # implicit-allocation scope backing scope-less new_bytes calls.
        self._marshal_pool: Optional[ScopePool] = None
        self._reply_free: List[Scope] = []
        self._reply_live: Dict[int, Scope] = {}
        # streaming replies: recycled chunk-chain scopes + the per-call
        # generation counter that tags every chunk of a stream
        self._chain_free: List[Scope] = []
        self._stream_gen = 0
        self._implicit: Optional[Scope] = None
        self._implicit_scopes: List[Scope] = []
        # pipelined-futures bookkeeping: every async token is tracked so
        # close() fails its waiter instead of stranding it, and abandoned
        # tokens (timeout/cancel) are reaped once their reply lands
        self._pending_async: Dict[int, _Pending] = {}
        self._abandoned: Dict[int, _Pending] = {}
        # §5.8 back-off for client-side waits (shared across this
        # connection's in-flight futures — one poll duty cycle). Public:
        # assign a BusyWaitPolicy(fixed_sleep_us=...) to pin the client
        # poll cadence, exactly like passing a policy to listen().
        # Defaults come from the channel's ReproConfig; assigning the
        # attributes afterwards still overrides per connection.
        cfg = getattr(channel, "config", None) or global_config
        self.wait_policy = BusyWaitPolicy(
            fixed_sleep_us=cfg.wait_fixed_sleep_us, window=cfg.wait_window)
        # bounded admission queue for a full ring (§5.4 backpressure):
        # a post that wraps onto an in-flight slot parks up to
        # ``admission_wait_s`` (or the remaining descriptor deadline,
        # whichever is shorter) for at most ``admission_max_waiters``
        # concurrent parkers, then surfaces typed ``Overloaded``.
        self.admission_wait_s = cfg.admission_wait_s
        self.admission_max_waiters = cfg.admission_max_waiters
        self._admission_waiters = 0
        # round-trip stats
        self.n_calls = 0
        self.n_invokes = 0
        self.marshal_bytes = 0
        self.n_admission_waits = 0
        self.n_overloads = 0

    # -- client-side object construction --------------------------------
    def create_scope(self, size_bytes: int) -> Scope:
        return create_scope(self.heap, size_bytes, owner=self.client_pid)

    def scope_pool(self, scope_pages: int = 1) -> ScopePool:
        if self._scope_pool is None or \
                self._scope_pool.scope_pages != scope_pages:
            self._scope_pool = ScopePool(self.heap, scope_pages,
                                         owner=self.client_pid,
                                         seals=self.seals)
        return self._scope_pool

    def new_bytes(self, data: bytes, scope: Optional[Scope] = None) -> int:
        """``conn->new_<T>(...)`` — allocate an object in the heap/scope.

        With no explicit scope the object goes into a connection-owned
        implicit scope that is tracked and returned to the heap when the
        connection closes. Consecutive scope-less allocations share the
        current implicit scope until it fills.
        """
        if scope is None:
            scope = implicit_scope(self, len(data), self.heap.page_size)
        return scope.write_bytes(data, pid=self.client_pid)

    # -- the RPC itself ---------------------------------------------------
    def call(
        self,
        fn_id: int,
        arg_addr: int = gaddr.NULL,
        scope: Optional[Scope] = None,
        sealed: bool = False,
        sandboxed: bool = False,
        batch_release: bool = False,
        timeout: float = 10.0,
        spin_sleep_us: float = 0.0,
        flags_extra: int = 0,
        deadline_us: int = 0,
    ) -> int:
        """``conn->call<T>(fn_id, arg)``. Returns the ret GlobalAddr/value.

        ``sealed``: seal the scope for the flight of the RPC (§4.5).
        ``sandboxed``: ask the server to process inside a sandbox (§4.4).
        ``batch_release``: defer the seal release to the scope-pool batch
        (§5.3) rather than releasing on return.
        ``flags_extra``: extra descriptor flag bits (the typed data plane
        sets F_TYPED/F_BYVAL here — see core/marshal.py).
        ``deadline_us``: absolute request deadline (µs, monotonic); the
        receiver drops the request with E_DEADLINE once it lapses.
        """
        slot, seal_idx = self._post(fn_id, arg_addr, scope, sealed, sandboxed,
                                    flags_extra, deadline_us)
        # spin for the response (client side of §5.8); time.sleep(0) is the
        # CPython GIL-yield stand-in for a hardware pause-loop. The poll is
        # one u64 word load (state|status) with everything hoisted.
        ring = self.ring
        words = ring._words
        widx = ring._w0 + slot * _SLOT_WORDS + _W_STATE
        sleep_s = spin_sleep_us * 1e-6 if spin_sleep_us else 0
        deadline = time.monotonic() + timeout
        dl_s = deadline_us * 1e-6 if deadline_us else 0.0
        if dl_s and dl_s < deadline:
            deadline = dl_s
        while words[widx] & _M32 < R_DONE:
            if time.monotonic() > deadline:
                if dl_s and deadline == dl_s:
                    # the REQUEST deadline lapsed, not the caller's
                    # patience: terminal, never retryable (the budget
                    # is gone — retrying would mint a fresh one)
                    raise DeadlineExceeded("RPC deadline lapsed")
                raise ChannelError(f"RPC {fn_id} timed out")
            time.sleep(sleep_s)
        return self._complete(slot, sealed, seal_idx, batch_release)

    def call_inline(self, fn_id: int, arg_addr: int = gaddr.NULL,
                    scope: Optional[Scope] = None, sealed: bool = False,
                    sandboxed: bool = False,
                    batch_release: bool = False,
                    flags_extra: int = 0,
                    deadline_us: int = 0) -> int:
        """Same data path as ``call`` but the server half runs on this
        thread immediately after the descriptor is posted — the two-core
        zero-scheduling-noise configuration used for RTT microbenchmarks
        (a dedicated server core picks the descriptor up instantly; CPython
        threads would add GIL handoff latency that the hardware does not
        have)."""
        slot, seal_idx = self._post(fn_id, arg_addr, scope, sealed, sandboxed,
                                    flags_extra, deadline_us)
        self.channel._process(self, slot)
        self.ring.head += 1
        return self._complete(slot, sealed, seal_idx, batch_release)

    def call_async(self, fn_id: int, arg_addr: int = gaddr.NULL,
                   scope: Optional[Scope] = None, sealed: bool = False,
                   sandboxed: bool = False,
                   flags_extra: int = 0,
                   deadline_us: int = 0) -> Tuple[int, int]:
        """Post without waiting; returns a (slot, seal_idx) token. Multiple
        RPCs may be in flight on one connection (per-thread MPK permissions
        make this safe in the paper, §5.2). Closing the connection fails
        every outstanding ``wait`` with ``ChannelError`` instead of
        leaving it to spin on a destroyed ring."""
        return self._post(fn_id, arg_addr, scope, sealed, sandboxed,
                          flags_extra, deadline_us)

    def _track_async(self, token: Tuple[int, int], sealed: bool = False,
                     typed: bool = False,
                     cleanup: Optional[Callable[[], None]] = None
                     ) -> "_Pending":
        """Register close()/reap bookkeeping for an async token (the
        futures layer calls this; raw tokens stay registry-free)."""
        p = _Pending(sealed, token[1], typed, cleanup)
        self._pending_async[token[0]] = p
        return p

    # -- typed data plane (core/marshal.py) -------------------------------
    def invoke(self, fn_id: int, *args, **kw):
        """``conn->invoke(fn_id, *values)`` — typed zero-copy RPC.

        Arguments (arbitrary nested Python values, or pre-built
        ``GraphRef`` container graphs) are materialized ONCE as a
        ``containers`` graph in a pooled scope and passed as a single
        GlobalAddr — no serialization. The reply is marshalled back the
        same way. Handlers must be registered with ``Channel.add_typed``.
        Keywords: ``sealed``, ``sandboxed``, ``batch_release``,
        ``timeout``, ``inline`` (use the two-core inline data path).
        """
        return _get_marshal().invoke_cxl(self, fn_id, args, **kw)

    def invoke_async(self, fn_id: int, *args, **kw):
        """Pipelined typed invoke: post now, settle later. Returns an
        ``RpcFuture``; N futures may be in flight on one connection and
        complete out of order (``marshal.gather`` drains them as they
        land). Keywords: ``sealed``, ``sandboxed``, ``deadline``
        (seconds of budget, propagated into the descriptor), ``timeout``."""
        return _get_marshal().invoke_async_cxl(self, fn_id, args, **kw)

    def invoke_stream(self, fn_id: int, *args, **kw):
        """Streaming typed invoke: the handler is a generator and every
        yielded value arrives as one generation-tagged chunk on a reply
        chain the server grows while the call is still in flight. Returns
        an ``RpcStream`` iterator — chunks are consumed **as they land**
        (time-to-first-token, not time-to-last). Keywords: ``sealed``,
        ``sandboxed``, ``deadline``, ``timeout``, ``window`` (bounded
        chunk window — server-side backpressure), ``inline`` (pump the
        server stream from the consuming thread; the two-core analogue
        for single-threaded setups)."""
        return _get_marshal().invoke_stream_cxl(self, fn_id, args, **kw)

    def invoke_serialized(self, fn_id: int, *args, **kw):
        """The Fig. 11 serializing baseline over the SAME descriptor ring:
        args are ``serial.encode``d, copied into a scope, decoded by the
        receiver — everything the typed pointer path avoids."""
        return _get_marshal().invoke_serialized(self, fn_id, args, **kw)

    def serve(self, instance, interceptors=()):
        """Register every method of a ``@service``-decorated instance as
        a typed handler on this connection's channel (see
        core/service.py). The raw integer ``add``/``add_typed`` API stays
        as the low-level escape hatch."""
        return self.channel.serve(instance, interceptors)

    def poll(self, token: Tuple[int, int]) -> bool:
        """Non-blocking completion probe for an async token (one word
        load). True once the result may be consumed with ``wait``."""
        ring = self.ring
        return ring._words[ring._w0 + token[0] * _SLOT_WORDS + _W_STATE] \
            & _M32 >= R_DONE

    def wait(self, token: Tuple[int, int], sealed: bool = False,
             batch_release: bool = False, timeout: float = 10.0) -> int:
        if self.closed:
            raise ChannelError("wait on closed connection")
        slot, seal_idx = token
        ring = self.ring
        words = ring._words
        widx = ring._w0 + slot * _SLOT_WORDS + _W_STATE
        if words[widx] & _M32 < R_DONE:  # not already done: back-off spin
            # §5.8 on the client side, through the same BusyWaitPolicy
            # the serve loops use: a bounded GIL-yield spin absorbs
            # promptly-landing replies (the pipelined steady state pays
            # nothing beyond the old hard spin), then the policy back-off
            # takes over so a stalled wait stops burning a core. The
            # policy's duty sample is one bit per wait — did this wait
            # overrun its spin budget? — so sustained stalls escalate to
            # the 5µs/150µs naps while a healthy pipeline keeps spinning.
            # A fixed-cadence policy (wait_policy with fixed_sleep_us)
            # skips the spin budget: the caller pinned the poll interval.
            policy = self.wait_policy
            deadline = time.monotonic() + timeout
            spins = _WAIT_SPIN_POLLS if policy.fixed is None else 0
            overran = spins == 0
            while words[widx] & _M32 < R_DONE:
                if time.monotonic() > deadline:
                    raise WaitTimeout("RPC timed out")
                if self.closed:
                    raise ChannelError("connection closed while waiting")
                if spins:
                    spins -= 1
                    time.sleep(0)
                    continue
                if not overran:
                    overran = True
                    policy.record(True)
                time.sleep(policy.delay_s())
            if not overran:
                policy.record(False)
        if self._pending_async:
            self._pending_async.pop(slot, None)
        return self._complete(slot, sealed, seal_idx, batch_release)

    def end_seal_window(self) -> int:
        """Close a ``batch_release`` pipeline window: flush every queued
        seal release in ONE permission epoch (§5.3 composed with
        pipelining). Returns the number of releases applied."""
        n = self.seals.pending_releases()
        if n:
            self.seals.flush()
        return n

    # -- abandoned-token reaping (timeout / cancel hygiene) ----------------
    def _abandon(self, token: Tuple[int, int], pending: "_Pending") -> None:
        """Give up on an async token (future cancelled or its waiter timed
        out for good): the slot cannot be un-posted from an SPSC ring, so
        it is parked and reaped — consumed, reply scope recycled, seal
        released — as soon as the server's completion lands."""
        slot = token[0]
        self._pending_async.pop(slot, None)
        self._abandoned[slot] = pending
        self._reap_abandoned()

    def _reap_abandoned(self) -> None:
        if not self._abandoned:
            return
        ring = self.ring
        for slot in list(self._abandoned):
            if ring.state_of(slot) < R_DONE:
                continue   # still in flight; reap on a later pass
            p = self._abandoned.pop(slot)
            tr = self.heap._tracer
            if tr is not None:
                tr.sync_acquire(("rep", id(ring), slot))
            ret, state, _status = ring.consume(slot)
            if p.sealed:
                try:
                    self.seals.release(p.seal_idx, holder=self.client_pid)
                except SealViolation:
                    pass
            if p.typed and state == R_DONE:
                _get_marshal()._recycle_reply(self, ret)
            if p.cleanup is not None:
                p.cleanup()
                p.cleanup = None

    # -- data-path halves ---------------------------------------------------
    def _post(self, fn_id, arg_addr, scope, sealed, sandboxed,
              flags_extra=0, deadline_us=0):
        if self.closed:
            raise ChannelError("call on closed connection")
        if self._abandoned:
            self._reap_abandoned()   # free slots stranded by cancel/timeout
        if deadline_us:
            flags_extra |= F_DEADLINE
        ring = self.ring
        seq = self._next_seq
        slot = seq % ring.capacity
        # a slot is free only once its result was consumed: R_REQ means the
        # window wrapped onto a pending request, R_DONE/R_ERR onto a result
        # nobody waited on — overwriting either would alias two calls.
        # A full ring no longer fails instantly: the caller parks in the
        # bounded admission queue (§5.4) and only a full queue or a
        # lapsed budget surfaces Overloaded.
        if ring._words[ring._w0 + slot * _SLOT_WORDS + _W_STATE] & _M32 \
                != R_EMPTY:
            _admission_park(self, ring, slot, deadline_us,
                            reap=self._reap_abandoned)

        # The seq is claimed only after every raising path (overflow,
        # missing scope, seal failure): a rejected post must not burn a
        # seq, or the server head would wait forever on a request that
        # was never written.
        if scope is None:  # plain-call fast path: no pages, no seal
            if sealed:
                raise SealViolation("sealed call requires a scope (§4.5)")
            self._next_seq = seq + 1
            tr = self.heap._tracer
            if tr is not None:  # ShmCheck: post publishes the args
                tr.sync_release(("req", id(ring), slot))
            ring.arr[slot] = (seq, fn_id,
                              (F_SANDBOXED if sandboxed else 0) | flags_extra,
                              arg_addr, 0, deadline_us, R_REQ, OK, 0, 0)
            ch = self.channel
            if ch._parked:  # doorbell only when the server is waiting on it
                ch._event.set()
            return slot, 0

        flags = flags_extra
        seal_idx = 0
        sc_start, sc_count = scope.page_range()
        if sealed:
            seal_idx = self.seals.seal(scope, holder=self.client_pid)
            self.last_seal_idx = seal_idx
            flags |= F_SEALED
        if sandboxed:
            flags |= F_SANDBOXED

        self._next_seq = seq + 1
        tr = self.heap._tracer
        if tr is not None:  # ShmCheck: post publishes the scope's bytes
            tr.sync_release(("req", id(ring), slot))
        ring.post(slot, seq, fn_id, flags, arg_addr, seal_idx,
                  sc_start, sc_count, ret=deadline_us)
        ch = self.channel
        if ch._parked:
            ch._event.set()
        return slot, seal_idx

    def _complete(self, slot, sealed, seal_idx, batch_release):
        tr = self.heap._tracer
        if tr is not None:  # ShmCheck: consume observes the reply bytes
            tr.sync_acquire(("rep", id(self.ring), slot))
        ret, state, status = self.ring.consume(slot)
        self.n_calls += 1

        if sealed:
            if batch_release:
                self.seals.release_batched(seal_idx, holder=self.client_pid)
            else:
                self.seals.release(seal_idx, holder=self.client_pid)

        if state == R_ERR:
            if status == E_DEADLINE:
                raise DeadlineExceeded("RPC deadline lapsed")
            if status == E_OVERLOAD:
                # the shed reply's ret word is the server-suggested
                # retry-after in µs (§5.4)
                raise Overloaded("server shed the request (E_OVERLOAD)",
                                 retry_after_s=ret * 1e-6)
            raise RpcError(status)
        return ret

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if not self.closed:
            self.closed = True
            # drain every tracked in-flight future FIRST: ``closed`` makes
            # a later wait()/result() raise ChannelError instead of
            # spinning on a torn-down ring, and each token's marshal
            # scope is drained exactly once (the cleanup callback is
            # one-shot) before the pools it belongs to are destroyed
            # below.
            for p in (*self._pending_async.values(),
                      *self._abandoned.values()):
                if p.cleanup is not None:
                    p.cleanup()
                    p.cleanup = None
            self._abandoned.clear()
            # return every connection-owned page range to the heap: the
            # implicit new_bytes scopes, the marshal scope pool, and any
            # reply scopes the server handed back through this client.
            for s in self._implicit_scopes:
                if s.live:
                    s.destroy()
            self._implicit_scopes.clear()
            self._implicit = None
            if self._marshal_pool is not None:
                self._marshal_pool.drain()
                self._marshal_pool = None
            for s in (*self._reply_free, *self._chain_free):
                if s.live:
                    s.destroy()
            self._reply_free.clear()
            self._chain_free.clear()
            for s in self._reply_live.values():
                if s.live:
                    s.destroy()
            self._reply_live.clear()
            # the user-facing scope_pool() pool is connection-owned too:
            # its pre-created pages must not outlive the connection
            if self._scope_pool is not None:
                self._scope_pool.drain()
                self._scope_pool = None
            tr = self.heap._tracer
            if tr is not None:
                tr.on_conn_close(self.heap, self.client_pid, self.seals)
            self.channel._drop_connection(self)


class Channel:
    """A named RPC endpoint. ``Channel.open`` ≈ binding a port (§4.2)."""

    def __init__(self, orch: Orchestrator, name: str, server_pid: int,
                 heap_pages: int = 4096, page_size: int = 4096,
                 shared_heap: bool = False,
                 config: Optional[ReproConfig] = None):
        self.orch = orch
        self.name = name
        # tuning defaults for this channel and its connections; explicit
        # kwargs / attribute assignment still override per instance
        self.config = config or global_config
        self.server_pid = server_pid
        self.heap_pages = heap_pages
        self.page_size = page_size
        self.shared_heap = shared_heap  # Fig. 4b channel-wide heap
        self._shared: Optional[SharedHeap] = None
        self.functions: Dict[int, Callable[["ServerCtx", int], int]] = {}
        self.connections: List[Connection] = []
        self._event = threading.Event()
        self._parked = False  # True only while listen waits on the doorbell
        self._stop = threading.Event()
        self._sweep_scratch: Optional[np.ndarray] = None
        self._conn_version = 0  # bumped on accept/drop; ServerLoop caches
        # active streaming replies (ServerStream, core/marshal.py): the
        # serve loops advance every registered generator a bounded number
        # of chunks per sweep, so streams interleave with ordinary RPCs
        self._streams: List = []
        # pre-dispatch admission gate (§5.4): an AdmissionInterceptor
        # (core/service.py) wired here sheds requests with E_OVERLOAD —
        # one descriptor word, never a handler. Anything exposing
        # admit(client_pid, fn_id) -> Optional[retry_after_us] / release()
        # plugs in.
        self.admission = None
        # push-mode per-pump chunk cap applied to every stream this
        # channel registers (None = the client's full window). A serving
        # transport whose stream generators share one scheduler (e.g.
        # continuous batching) sets 1 so all live streams advance in
        # lockstep, one batched step per sweep.
        self.stream_pump_burst: Optional[int] = self.config.stream_pump_burst
        # the served instance (recorded by serve()): what snapshot()
        # checkpoints and the lifecycle Endpoint handle manages
        self.served_instance = None
        self.served_def = None
        self.serve_interceptors: Tuple = ()
        self.lifecycle = None  # back-reference set by lifecycle.Endpoint
        orch.register_channel(name, self)

    # -- server API (Fig. 6 left) -------------------------------------------
    def add(self, fn_id: int, fn: Callable[["ServerCtx", int], int]) -> None:
        self.functions[fn_id] = fn

    def add_typed(self, fn_id: int, fn) -> None:
        """Register a typed handler: ``fn(ctx, args)`` receives an
        ``ArgView`` (lazy, bounds-checked when sandboxed) over the
        marshalled argument tuple and returns a Python value, which is
        marshalled back to the caller. Serves both the pointer-passing
        (``invoke``) and the serialized (``invoke_serialized`` /
        fallback-route) forms of the request."""
        self.functions[fn_id] = _get_marshal().typed_handler(fn)

    def serve(self, instance, interceptors=()):
        """Register every method of a ``@service``-decorated instance
        (or anything carrying a ``ServiceDef``) as a typed handler —
        the declarative face of ``add_typed`` (core/service.py). Returns
        the ``ServiceDef``. The raw integer ``fn_id`` API above remains
        the documented low-level escape hatch."""
        from .service import service_def
        sdef = service_def(instance)
        sdef.serve(self, instance, interceptors)
        self.served_instance = instance
        self.served_def = sdef
        self.serve_interceptors = tuple(interceptors)
        return sdef

    def accept(self, client_pid: int, ring_capacity: int = 256) -> Connection:
        """Create the connection object for a connecting client: on its
        own heap (Fig. 4a), or on the channel-wide heap (Fig. 4b)."""
        if self.shared_heap:
            if self._shared is None:
                self._shared = self.orch.create_heap(
                    self.heap_pages, self.page_size,
                    name=f"{self.name}/shared")
                self.orch.map_heap(self.server_pid, self._shared)
            heap = self._shared
        else:
            heap = self.orch.create_heap(
                self.heap_pages, self.page_size,
                name=f"{self.name}/conn{len(self.connections)}")
            self.orch.map_heap(self.server_pid, heap)
        self.orch.map_heap(client_pid, heap)
        conn = Connection(self, heap, client_pid, ring_capacity)
        self.connections.append(conn)
        self._conn_version += 1
        return conn

    def _drop_connection(self, conn: Connection) -> None:
        if conn in self.connections:
            self.connections.remove(conn)
            self._conn_version += 1
            if self._streams:
                # a dropped client's streams must never pump again (their
                # chain pages are going back to the heap)
                for st in [s for s in self._streams if s.conn is conn]:
                    st.abort()
                    self._streams.remove(st)
            self.orch.unmap_heap(conn.client_pid, conn.heap.heap_id)
            if not self.shared_heap:
                self.orch.unmap_heap(self.server_pid, conn.heap.heap_id)

    # Doorbell contract (no helper — Connection._post inlines it): a post
    # rings self._event only when self._parked is set, i.e. while listen()
    # is blocked on the event; posts during a sweep are found by the next
    # sweep.

    # -- serve loop ------------------------------------------------------------
    def serve_once(self) -> int:
        """One vectorized sweep: gather every connection ring's head-slot
        state, find ready rings with a single NumPy compare, and drain each
        ready ring inline. Rings are SPSC and clients claim slots in seq
        order, so only each ring's head needs inspecting. Returns the
        number of RPCs served."""
        conns = self.connections
        n = len(conns)
        if n == 0:
            return self.pump_streams()
        if n == 1:  # common case: skip the gather entirely
            return self._drain(conns[0]) + self.pump_streams()
        conns = list(conns)  # handlers may drop connections mid-drain
        scratch = self._sweep_scratch
        if scratch is None or scratch.shape[0] < n:
            self._sweep_scratch = scratch = np.empty(max(8, 2 * n),
                                                     dtype=np.uint32)
        for i, conn in enumerate(conns):
            ring = conn.ring
            scratch[i] = ring.state_of(ring.head % ring.capacity)
        ready = np.flatnonzero(scratch[:n] == R_REQ)  # ONE compare
        served = 0
        for i in ready:
            served += self._drain(conns[i])
        return served + self.pump_streams()

    def pump_streams(self) -> int:
        """Advance every active streaming reply: each registered generator
        emits chunks up to its client's open window (bounded — a stalled
        consumer cannot pin the sweep), streams that finish are dropped.
        Returns the number of chunks emitted, which counts as served work
        for the §5.8 policy so a mid-stream server never backs off."""
        if not self._streams:
            return 0
        emitted = 0
        for st in list(self._streams):
            emitted += st.pump()
            if st.done:
                self._streams.remove(st)
        return emitted

    def _drain(self, conn: Connection) -> int:
        """Process every pending slot of one ring (batched head advance).
        The readiness poll is a single hoisted u64 word load per slot."""
        ring = conn.ring
        cap = ring.capacity
        words = ring._words
        w0 = ring._w0 + _W_STATE
        head = ring.head
        served = 0
        while True:
            slot = head % cap
            if words[w0 + slot * _SLOT_WORDS] & _M32 != R_REQ:
                break
            self._process(conn, slot)
            head += 1
            served += 1
        ring.head = head
        return served

    def serve_many(self, max_sweeps: Optional[int] = None) -> int:
        """Drain every ready slot found, sweep after sweep, until the
        channel is idle (or ``max_sweeps`` sweeps have run). Requests that
        arrive while a batch is being drained are picked up by the next
        sweep without returning to the caller."""
        total = 0
        sweeps = 0
        while True:
            n = self.serve_once()
            total += n
            sweeps += 1
            if n == 0 or (max_sweeps is not None and sweeps >= max_sweeps):
                return total

    def listen(self, policy: Optional[BusyWaitPolicy] = None,
               stop: Optional[threading.Event] = None) -> None:
        """``conn->listen()`` — busy-wait loop with §5.8 adaptive back-off
        spent parked on the doorbell (see ``_serve_event_loop``)."""
        _serve_event_loop(self.serve_many, self.serve_once, (self,),
                          policy or BusyWaitPolicy(), stop or self._stop,
                          self._event)

    def listen_in_thread(self, policy: Optional[BusyWaitPolicy] = None
                         ) -> threading.Thread:
        self._stop.clear()
        t = threading.Thread(target=self.listen, args=(policy,), daemon=True)
        t.start()
        return t

    @classmethod
    def serve_all(cls, channels: List["Channel"],
                  policy: Optional[BusyWaitPolicy] = None) -> "ServerLoop":
        """Serve every ring of every channel in ``channels`` from ONE
        background thread (a started ``ServerLoop``). The cluster-scale
        replacement for one ``listen_in_thread`` per channel."""
        loop = ServerLoop(channels, policy)
        loop.run_in_thread()
        return loop

    def stop(self) -> None:
        self._stop.set()

    def destroy(self) -> None:
        self.stop()
        for st in self._streams:
            st.abort()   # close the generators; chain pages die with heap
        self._streams.clear()
        for conn in list(self.connections):
            conn.close()
        self.orch.unregister_channel(self.name)

    # -- request processing (receiver half of Fig. 8) ---------------------------
    def _process(self, conn: Connection, slot: int) -> None:
        ring = conn.ring
        fn_id, flags, arg, seal_idx, sc_start, sc_count = ring.load_req(slot)
        tr = conn.heap._tracer
        if tr is not None:  # ShmCheck: the load observes the posted args
            tr.sync_acquire(("req", id(ring), slot))

        fn = self.functions.get(fn_id)
        if fn is None:
            ring.complete(slot, 0, R_ERR, E_NOFUNC)
            return

        # Deadline gate (pipelined futures): a request whose propagated
        # deadline lapsed while queued is dropped before its seal/args
        # are even touched — the client already gave up on it.
        deadline_us = 0
        if flags & F_DEADLINE:
            deadline_us = int(
                ring._words[ring._w0 + slot * _SLOT_WORDS + _W_RET])
            if _now_us() > deadline_us:
                ring.complete(slot, 0, R_ERR, E_DEADLINE)
                return

        # Fig. 8 step 4: verify the seal before touching the arguments.
        if flags & F_SEALED:
            if not conn.seals.is_sealed(seal_idx):
                ring.complete(slot, 0, R_ERR, E_UNSEALED)
                return

        # Admission gate (§5.4): shed BEFORE dispatch — the reply is one
        # descriptor word (the suggested retry-after, µs) and the handler
        # never runs. Sits after the early-return gates above so an
        # admitted slot always reaches the release below (or hands its
        # release to the stream it started).
        gate = self.admission
        if gate is not None:
            retry_after_us = gate.admit(conn.client_pid, fn_id)
            if retry_after_us is not None:
                ring.complete(slot, retry_after_us, R_ERR, E_OVERLOAD)
                return

        # Reuse the connection's ServerCtx (allocation-free steady state);
        # a nested call_inline from inside a handler sees None and gets a
        # fresh one.
        ctx = conn._ctx
        if ctx is None:
            ctx = ServerCtx(self, conn, flags)
        else:
            conn._ctx = None
            ctx.flags = flags
            ctx.sandbox = None
        ctx.deadline_us = deadline_us
        try:
            if flags & F_SANDBOXED and not gaddr.is_null(arg):
                if sc_count:
                    start, count = sc_start, sc_count
                else:
                    # no scope advertised: sandbox the argument's extent
                    start, count = self._arg_scope(conn, arg)
                with conn.sandboxes.enter(start, count) as sb:
                    ctx.sandbox = sb
                    ret = fn(ctx, arg)
            else:
                ret = fn(ctx, arg)
            if getattr(ret, "_server_stream", False):
                # streaming reply: the slot stays open (and its seal
                # held) until the chunk chain ends; the serve loops pump
                # the generator from here on. The ctx travels with the
                # stream, so it is NOT returned to the connection.
                ret.bind(conn, ring, slot, seal_idx, flags,
                         sc_start, sc_count)
                ret.burst = self.stream_pump_burst
                if gate is not None:
                    # the stream stays admitted until its chain ends:
                    # abort()/completion fires the release exactly once
                    ret.release_cb = gate.release
                    gate = None
                self._streams.append(ret)
                ret.pump()   # first chunks flow before the sweep returns
                if ret.done:
                    self._streams.remove(ret)
                return
            status, state = OK, R_DONE
        except SandboxViolation:
            # the SIGSEGV→error-reply path (§4.4)
            ret, status, state = 0, E_SANDBOX, R_ERR
        except DeadlineExceeded:
            # a handler/interceptor aborting past the budget keeps the
            # dedicated status so clients see a deadline, not a crash
            ret, status, state = 0, E_DEADLINE, R_ERR
        except Overloaded as e:
            # a handler shedding on resource pressure (e.g. pool pages,
            # §5.4) rides the same typed E_OVERLOAD reply as the
            # pre-dispatch gate: the ret word carries retry-after µs
            ret = max(0, int(e.retry_after_s * 1e6))
            status, state = E_OVERLOAD, R_ERR
        except Exception:
            ret, status, state = 0, E_EXCEPTION, R_ERR

        # Fig. 8 step 6: mark complete before replying.
        if flags & F_SEALED:
            try:
                conn.seals.mark_complete(seal_idx)
            except SealViolation:
                pass
        if tr is not None:  # ShmCheck: completion publishes the reply
            tr.sync_release(("rep", id(ring), slot))
        ring.complete(slot, ret, state, status)
        if gate is not None:
            gate.release()
        conn._ctx = ctx

    @staticmethod
    def _arg_scope(conn: Connection, arg: int,
                   max_pages: int = 64) -> Tuple[int, int]:
        """Best-effort scope bounds for an argument address: the contiguous
        USED extent around its page (scopes are contiguous allocations),
        bounded to ``max_pages`` each way."""
        page = gaddr.page_of(arg)
        heap = conn.heap
        lo = page
        while lo > 0 and page - lo < max_pages and \
                heap.state[lo - 1] == 1 and \
                heap.owner[lo - 1] == heap.owner[page]:
            lo -= 1
        hi = page + 1
        while hi < heap.num_pages and hi - page < max_pages and \
                heap.state[hi] == 1 and \
                heap.owner[hi] == heap.owner[page]:
            hi += 1
        return lo, hi - lo


class ServerLoop:
    """One server thread serving *all* rings of N channels (§4.6 scale-out).

    Extends ``Channel.serve_once``'s per-channel sweep **across channels**:
    each iteration gathers the head-slot state of every accepted ring of
    every attached channel into one scratch array and finds the ready rings
    with a single vectorized NumPy compare. The §5.8 busy-wait budget and
    the doorbell are likewise shared: attaching a channel rebinds its
    doorbell event to the loop's, so while the loop is parked a post on
    ANY attached channel wakes it immediately.

    The flat connection list is cached and invalidated by the channels'
    ``_conn_version`` counters, so the steady state does no list rebuilds —
    the sweep is one Python loop of word loads plus ONE compare, as
    ``Channel.serve_once``'s single-channel sweep, just wider.
    """

    def __init__(self, channels: Optional[List[Channel]] = None,
                 policy: Optional[BusyWaitPolicy] = None):
        self.channels: List[Channel] = []
        self.policy = policy or BusyWaitPolicy()
        self._event = threading.Event()   # the one shared doorbell
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: List[Connection] = []
        self._versions: List[int] = []
        self._scratch: Optional[np.ndarray] = None
        # stats
        self.n_sweeps = 0
        self.n_served = 0
        for ch in (channels or []):
            self.attach(ch)

    # -- channel set --------------------------------------------------------
    def attach(self, channel: Channel) -> None:
        if channel not in self.channels:
            self.channels.append(channel)
            channel._event = self._event  # posts now ring the shared bell
            self._versions = []           # force a conn-list rebuild

    def detach(self, channel: Channel) -> None:
        if channel in self.channels:
            self.channels.remove(channel)
            channel._event = threading.Event()
            channel._parked = False
            self._versions = []

    def _refresh_conns(self) -> None:
        chs = self.channels
        if len(self._versions) == len(chs) and all(
                v == ch._conn_version
                for v, ch in zip(self._versions, chs)):
            return
        # snapshot versions BEFORE reading the connection lists: an accept
        # racing this rebuild then at worst forces one extra rebuild next
        # sweep, instead of being cached out (and never served) forever
        self._versions = [ch._conn_version for ch in chs]
        self._conns = [c for ch in chs for c in ch.connections]
        n = len(self._conns)
        if n > 1 and (self._scratch is None or self._scratch.shape[0] < n):
            self._scratch = np.empty(max(8, 2 * n), dtype=np.uint32)

    # -- sweeps -------------------------------------------------------------
    def sweep_once(self) -> int:
        """One vectorized sweep over every ring of every channel; drains
        each ready ring inline. Returns the number of RPCs served."""
        self._refresh_conns()
        conns = self._conns
        n = len(conns)
        self.n_sweeps += 1
        if n == 0:
            return 0
        if n == 1:  # common case: skip the gather
            conn = conns[0]
            served = conn.channel._drain(conn)
        else:
            scratch = self._scratch
            for i, conn in enumerate(conns):
                ring = conn.ring
                scratch[i] = ring.state_of(ring.head % ring.capacity)
            ready = np.flatnonzero(scratch[:n] == R_REQ)  # ONE compare
            served = 0
            for i in ready:
                conn = conns[i]
                served += conn.channel._drain(conn)
        for ch in self.channels:
            if ch._streams:
                served += ch.pump_streams()
        self.n_served += served
        return served

    def serve_pending(self, max_sweeps: Optional[int] = None) -> int:
        """Sweep until idle (cf. ``Channel.serve_many``, across channels)."""
        total = 0
        sweeps = 0
        while True:
            n = self.sweep_once()
            total += n
            sweeps += 1
            if n == 0 or (max_sweeps is not None and sweeps >= max_sweeps):
                return total

    # -- the event loop ------------------------------------------------------
    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Busy-wait loop with the §5.8 back-off spent parked on the shared
        doorbell (same protocol as ``Channel.listen``, across channels)."""
        _serve_event_loop(self.serve_pending, self.sweep_once,
                          self.channels, self.policy, stop or self._stop,
                          self._event)

    def run_in_thread(self) -> threading.Thread:
        self._stop.clear()
        t = threading.Thread(target=self.run, daemon=True,
                             name="rpcool-serverloop")
        self._thread = t
        t.start()
        return t

    def stop(self, join: bool = True, timeout: float = 2.0) -> None:
        """Stop the loop; by default join the serving thread (clean
        shutdown — no leaked listener threads)."""
        self._stop.set()
        self._event.set()  # wake a parked loop immediately
        t = self._thread
        if join and t is not None and t is not threading.current_thread():
            t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class ServerCtx:
    """What an RPC handler sees: checked access to the connection heap."""

    __slots__ = ("channel", "conn", "flags", "sandbox", "deadline_us")

    def __init__(self, channel: Channel, conn: Connection, flags: int):
        self.channel = channel
        self.conn = conn
        self.flags = flags
        self.sandbox = None  # set when sandboxed
        self.deadline_us = 0  # propagated request deadline (0 = none)

    def read(self, a: int, nbytes: int):
        if self.sandbox is not None:
            return self.sandbox.read(a, nbytes)
        heap = self.conn.heap
        if heap._tracer is not None:
            # ShmCheck: an invalid pointer reaching an unsandboxed
            # handler is the §4.4 wild-dereference bug class
            return heap._tracer.checked_deref(heap, a, nbytes)
        return heap.read(a, nbytes)

    def write(self, a: int, data) -> None:
        """Handler-facing store: sandbox-confined exactly like ``read``
        — a sandboxed handler must not write outside its pages (§4.4)."""
        if self.sandbox is not None:
            self.sandbox.check(a, SharedHeap._payload_nbytes(data))
        self.conn.heap.write(a, data)

    def _daemon_write(self, a: int, data) -> None:
        """Privileged runtime store (reply marshalling): librpcool writes
        the reply outside the handler's sandbox, after SB_END semantics."""
        self.conn.heap.write(a, data)

    def heap(self) -> SharedHeap:
        return self.conn.heap


class RPC:
    """Top-level API mirroring Fig. 6."""

    def __init__(self, orch: Orchestrator, pid: int):
        self.orch = orch
        self.pid = pid
        self._channel: Optional[Channel] = None

    # server: rpc.open("mychannel"); rpc.add(100, fn); rpc.accept(); listen()
    def open(self, name: str, **kw) -> Channel:
        self._channel = Channel(self.orch, name, self.pid, **kw)
        return self._channel

    # client: rpc.connect("mychannel")
    def connect(self, name: str, **kw) -> Connection:
        ch = self.orch.lookup_channel(name)
        return ch.accept(self.pid, **kw)
