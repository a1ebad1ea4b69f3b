"""Typed zero-copy argument marshalling — the unified data plane.

The paper's headline claim is serialization *avoidance* (§4.1, Fig. 11):
an RPC passes a pointer to a pointer-rich structure living in shared
memory; seals and sandboxes restore the isolation that copying used to
provide. This module is the layer that makes that the *default calling
convention* instead of a bytes-in/int-out one:

* ``conn.invoke(fn_id, *values)`` — arguments (arbitrary nested Python
  values, or pre-built ``GraphRef`` container graphs) are materialized
  ONCE as a ``containers`` graph inside a pooled scope, optionally
  sealed, and passed as a single GlobalAddr. Zero serialization.
* On a ``FallbackConnection`` the *same surface* transparently routes by
  value: ``serial.encode`` → one blob copy over the link → decode (the
  §5.6 ``copy_from`` semantics). ``RoutedConnection`` therefore picks
  pointer-passing vs copy per route with no caller change.
* Handler side, ``Channel.add_typed`` handlers receive an ``ArgView``:
  a lazy view that chases pointers on demand. Under a sandboxed request
  every dereference goes through a bounds-checked reader (the §4.3
  wild-pointer attack path surfaces as ``SandboxViolation`` → E_SANDBOX,
  never as server memory disclosure); replies are marshalled back into a
  recycled reply scope the same way.
* ``invoke_serialized`` runs the gRPC-analogue baseline over the SAME
  descriptor ring, so the two differ by exactly the
  serialize+copy+deserialize of Fig. 11 / Table 1a.
* ``invoke_async`` returns a future (``RpcFuture`` on the ring,
  ``FallbackRpcFuture`` staged for the link's next flight); ``gather``
  settles a batch as the completions land. ``invoke_stream`` returns a
  chunk iterator (``RpcStream`` pushed by the serve loop,
  ``FallbackRpcStream`` pulled in staged chunk flights).

Reply protocol: the ring's 64-bit ``ret`` word carries the GlobalAddr of
either a 16-byte boxed Value (pointer route) or a ``[u32 len][bytes]``
blob (by-value route). Reply scopes are popped from a per-connection
freelist by the server and pushed back by the client after decoding —
the steady state allocates nothing.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional, Tuple

import time

from . import addr as gaddr
from . import containers as C
from . import serial
from .channel import Connection, E_DEADLINE, E_EXCEPTION, E_OVERLOAD, \
    E_SANDBOX, F_BYVAL, F_SANDBOXED, F_SEALED, F_STREAM, F_TYPED, OK, \
    R_DONE, R_ERR, RpcError, _now_us
from .errors import AllocationError, ChannelError, DeadlineExceeded, \
    InvalidPointer, Overloaded, SandboxViolation, SealViolation, WaitTimeout
from .scope import Scope, ScopePool, create_scope

# Pooled argument scopes: 4 pages (16 KiB with the default page size)
# covers typical pointer-rich documents; bigger argument sets fall back
# to a dedicated right-sized scope.
MARSHAL_SCOPE_PAGES = 4
REPLY_SCOPE_PAGES = 1
_REPLY_FREELIST_MAX = 4
# replies the client never consumed (timeouts, decode errors) are capped:
# past this many live reply scopes the oldest is reclaimed — invoke is
# synchronous, so anything that old is garbage, not in flight
_REPLY_LIVE_MAX = 64

_BOX = struct.Struct("<IIQ")      # boxed reply Value (= containers layout)
_BLOB_HDR = struct.Struct("<I")   # length prefix of a by-value payload

_MISSING = object()


class GraphRef:
    """A pre-built argument-tuple graph resident in a connection's heap.

    ``build_graph(conn, *values)`` materializes the argument tuple once;
    passing the ref to ``invoke`` afterwards is pure pointer passing —
    zero per-call marshalling, the paper's steady-state hot path. On a
    copy-route connection (no shared heap) the ref simply retains the
    plain values and each invoke serializes them, keeping the surface
    identical across routes.
    """

    __slots__ = ("scope", "value", "plain")

    def __init__(self, scope: Optional[Scope], value: Optional[C.Value],
                 plain: Optional[list] = None):
        self.scope = scope
        self.value = value
        self.plain = plain

    @property
    def root(self) -> int:
        return self.value[1]

    @property
    def heap(self):
        return None if self.scope is None else self.scope.heap

    def to_python(self) -> list:
        """The argument tuple as plain values (§5.6 copy-out half)."""
        if self.scope is None:
            return list(self.plain)
        return C.to_python(self.scope.heap, self.value)

    def destroy(self) -> None:
        if self.scope is not None and self.scope.live:
            self.scope.destroy()


class ArgView:
    """Uniform lazy view over typed RPC arguments.

    Graph-backed (pointer route): every access walks the ``containers``
    graph through a reader — the connection heap when trusted, a
    bounds-checked sandbox reader when the request is sandboxed. Nothing
    is deserialized; the handler touches only what it dereferences.

    Python-backed (by-value route): wraps the already-decoded object so
    the same handler code serves both routes.

    Scalars (ints, floats, strings, None) unwrap to Python values on
    access; Vec/Map nodes come back as nested ``ArgView``s.
    """

    __slots__ = ("_reader", "_val", "_py")

    def __init__(self, reader, val: Optional[C.Value], py=_MISSING):
        self._reader = reader
        self._val = val
        self._py = py

    # -- constructors ----------------------------------------------------
    @classmethod
    def graph(cls, reader, value: C.Value) -> "ArgView":
        return cls(reader, value)

    @classmethod
    def python(cls, obj) -> "ArgView":
        return cls(None, None, obj)

    # -- wrapping --------------------------------------------------------
    def _wrap(self, v: C.Value):
        tag, p = v
        if tag == C.T_NULL:
            return None
        if tag == C.T_I64:
            return p - (1 << 64) if p >= (1 << 63) else p
        if tag == C.T_F64:
            return C._unpack_f64(p)
        if tag == C.T_STR:
            return C.read_str(self._reader, p)
        if tag == C.T_BYTES:
            return C.read_bytes(self._reader, p)
        return ArgView(self._reader, v)

    @staticmethod
    def _wrap_py(obj):
        if isinstance(obj, (dict, list, tuple)):
            return ArgView.python(obj)
        return obj

    # -- the access surface ----------------------------------------------
    def __len__(self) -> int:
        if self._reader is None:
            return len(self._py)
        tag, p = self._val
        if tag == C.T_VEC:
            return C.vec_len(self._reader, p)
        if tag == C.T_MAP:
            return C.map_len(self._reader, p)
        raise InvalidPointer(f"len() of non-container value tag {tag}")

    def __getitem__(self, key):
        if self._reader is None:
            return self._wrap_py(self._py[key])
        tag, p = self._val
        if isinstance(key, str):
            if tag != C.T_MAP:
                raise InvalidPointer(f"string index into value tag {tag}")
            v = C.map_get(self._reader, p, key)
            if v is None:
                raise KeyError(key)
            return self._wrap(v)
        if tag != C.T_VEC:
            raise InvalidPointer(f"integer index into value tag {tag}")
        n = C.vec_len(self._reader, p)
        if key < 0:
            key += n
        return self._wrap(C.vec_get(self._reader, p, key))

    def get(self, key: str, default=None):
        if self._reader is None:
            return self._wrap_py(self._py.get(key, default))
        tag, p = self._val
        if tag != C.T_MAP:
            raise InvalidPointer(f"get() on value tag {tag}")
        v = C.map_get(self._reader, p, key)
        return default if v is None else self._wrap(v)

    def keys(self) -> List[str]:
        if self._reader is None:
            return list(self._py.keys())
        tag, p = self._val
        if tag != C.T_MAP:
            raise InvalidPointer(f"keys() on value tag {tag}")
        return [k for k, _ in C.map_items(self._reader, p)]

    def __iter__(self) -> Iterator:
        if self._reader is None:
            if isinstance(self._py, dict):
                return iter(self._py.keys())
            return (self._wrap_py(v) for v in self._py)
        tag, p = self._val
        if tag == C.T_MAP:
            return iter(self.keys())
        if tag == C.T_VEC:
            return (self._wrap(C.vec_get(self._reader, p, i))
                    for i in range(C.vec_len(self._reader, p)))
        raise InvalidPointer(f"iteration over value tag {tag}")

    def __contains__(self, key: str) -> bool:
        if self._reader is None:
            if not isinstance(self._py, dict):
                raise InvalidPointer("`in` requires a map value")
            return key in self._py
        tag, p = self._val
        if tag != C.T_MAP:
            raise InvalidPointer(f"`in` on value tag {tag}")
        return C.map_get(self._reader, p, key) is not None

    def to_python(self):
        """Materialize the whole subtree (the explicit opt-in to a full
        deserialize — what the lazy surface otherwise avoids)."""
        if self._reader is None:
            obj = self._py
            if isinstance(obj, tuple):
                return list(obj)
            return obj
        return C.to_python(self._reader, self._val)


# ---------------------------------------------------------------------------
# argument marshalling (client side)
# ---------------------------------------------------------------------------
def _build_arg(scope: Scope, v, pid: int, force_copy: bool) -> C.Value:
    """One argument → Value in ``scope``.

    A ``GraphRef`` living in the same heap is pointer-embedded for free
    (the whole point); one in a foreign heap — or any graph under a
    sandboxed call, whose sandbox covers only the call scope — is
    ``deep_copy``'d into the scope (§5.6 ``copy_from``).
    """
    if isinstance(v, GraphRef):
        if v.scope is None:   # plain ref: rebuild its retained values
            return C.build_value(scope, v.plain, pid)
        if v.scope.heap is scope.heap and not force_copy:
            return v.value
        return C.deep_copy(v.scope.heap, scope, v.value, pid)
    return C.build_value(scope, v, pid)


def marshal_args(scope: Scope, args: Tuple, pid: int = 0,
                 force_copy: bool = False) -> int:
    """Materialize the argument tuple as a Vec graph; returns its root."""
    vals = [_build_arg(scope, v, pid, force_copy) for v in args]
    return C.build_vec(scope, vals, pid)[1]


def build_graph(conn, *values) -> GraphRef:
    """Materialize an argument tuple once in ``conn``'s heap.

    The returned ``GraphRef`` can be passed to ``invoke`` any number of
    times — each call is then pure pointer passing. Works on CXL and
    routed connections (``RoutedConnection.build_graph`` delegates here
    against the live target); a copy-route target gets a plain-value ref
    since there is no shared heap to materialize into."""
    heap = getattr(conn, "heap", None)
    if heap is None:  # FallbackConnection: the route copies either way
        return GraphRef(None, None, plain=[_to_plain(v) for v in values])
    pages = MARSHAL_SCOPE_PAGES
    while True:
        scope = conn.create_scope(pages * heap.page_size)
        try:
            root = marshal_args(scope, values, pid=conn.client_pid)
            return GraphRef(scope, (C.T_VEC, root))
        except AllocationError:
            scope.destroy()
            if pages > (1 << 16):
                raise
            pages *= 4
        except BaseException:
            scope.destroy()   # unsupported value etc. — no page leak
            raise


def _marshal_pool(conn: Connection) -> ScopePool:
    pool = conn._marshal_pool
    if pool is None or pool.scope_pages != MARSHAL_SCOPE_PAGES:
        pool = conn._marshal_pool = ScopePool(
            conn.heap, MARSHAL_SCOPE_PAGES, owner=conn.client_pid,
            seals=conn.seals)
    return pool


def _pool_recycle(conn: Connection, scope: Scope, pooled: bool,
                  seal_idx: Optional[int] = None) -> None:
    """Return a marshal scope to its pool, tolerating a connection that
    closed mid-call (a teardown while a straggler op is still in
    flight). With the pool already gone the scope is destroyed instead,
    so its page range never leaks into the dying heap."""
    if pooled:
        pool = conn._marshal_pool
        if pool is not None:
            if seal_idx is not None:
                pool.push_sealed(scope, seal_idx)
            else:
                pool.push(scope)
        elif scope.live:
            try:
                scope.destroy()
            except Exception:
                pass  # already-torn-down heap; nothing left to leak into
    elif scope.live:
        scope.destroy()


def _fill_pooled(conn: Connection, pid: int, fill) -> Tuple[Any, Scope, bool]:
    """Run ``fill(scope)`` in a pooled marshal scope, retrying in a
    geometrically larger dedicated scope on overflow. Returns
    (fill result, scope, pooled?); exception-safe — a failing fill never
    leaks its scope."""
    pool = _marshal_pool(conn)
    scope = pool.pop()
    try:
        return fill(scope), scope, True
    except AllocationError:
        pool.push(scope)
    except BaseException:
        pool.push(scope)      # bad value (TypeError, …) — no scope leak
        raise
    pages = MARSHAL_SCOPE_PAGES * 4
    while True:
        scope = create_scope(conn.heap, pages * conn.heap.page_size,
                             owner=pid)
        try:
            return fill(scope), scope, False
        except AllocationError:
            scope.destroy()
            if pages > (1 << 16):
                raise
            pages *= 4
        except BaseException:
            scope.destroy()
            raise


def _pooled_marshal(conn: Connection, args: Tuple, pid: int,
                    force_copy: bool) -> Tuple[int, Scope, bool]:
    """(root, scope, pooled?) — pooled fast path, dedicated on overflow."""
    return _fill_pooled(
        conn, pid, lambda scope: marshal_args(scope, args, pid, force_copy))


# ---------------------------------------------------------------------------
# reply marshalling (server side) + decoding (client side)
# ---------------------------------------------------------------------------
def _reply_heap(conn):
    heap = getattr(conn, "heap", None)
    return heap if heap is not None else conn.client.heap


def _pop_reply_scope(conn, nbytes: int) -> Tuple[Scope, bool]:
    heap = _reply_heap(conn)
    if nbytes <= REPLY_SCOPE_PAGES * heap.page_size:
        free = conn._reply_free
        if free:
            s = free.pop()
            tr = heap._tracer
            if tr is not None:
                # freelist hand-off: the recycler's accesses (the client
                # reading the previous reply) happen-before this reuse
                tr.sync_acquire(("scope", id(s)))
            s.reset()
            return s, True
        return create_scope(heap, REPLY_SCOPE_PAGES * heap.page_size), True
    return create_scope(heap, nbytes), False


def _release_reply_scope(conn, scope: Scope) -> None:
    """The one push-or-destroy policy for reply scopes."""
    if scope.num_pages == REPLY_SCOPE_PAGES and \
            len(conn._reply_free) < _REPLY_FREELIST_MAX:
        tr = _reply_heap(conn)._tracer
        if tr is not None:
            tr.sync_release(("scope", id(scope)))
        conn._reply_free.append(scope)
    elif scope.live:
        scope.destroy()


def _track_reply(conn, addr: int, scope: Scope) -> None:
    live = conn._reply_live
    if len(live) >= _REPLY_LIVE_MAX:
        # a client that errored before decoding (timeout, link failure)
        # strands its reply scope here; reclaim the oldest so repeated
        # errors cannot pin the channel heap
        oldest = next(iter(live))
        _release_reply_scope(conn, live.pop(oldest))
    live[addr] = scope


def _recycle_reply(conn, addr: int) -> None:
    scope = conn._reply_live.pop(addr, None)
    if scope is not None:
        _release_reply_scope(conn, scope)


def _write_reply_graph(ctx, ret) -> int:
    """Marshal a handler's return value as a boxed Value + graph."""
    conn = ctx.conn
    scope, _pooled = _pop_reply_scope(conn, REPLY_SCOPE_PAGES)
    heap = _reply_heap(conn)
    nbytes = REPLY_SCOPE_PAGES * heap.page_size
    while True:
        try:
            val = C.build_value(scope, ret)
            box = scope.alloc(C.VALUE_SIZE)
            scope.heap.write(box, _BOX.pack(val[0], 0, val[1]))
            break
        except AllocationError:
            # big reply: retry in a geometrically larger dedicated scope
            # (serial length is NOT a bound — e.g. None is 1 B on the
            # wire but a 16 B containers Value)
            _release_reply_scope(conn, scope)
            nbytes *= 8
            if nbytes > heap.num_pages * heap.page_size:
                raise
            scope, _pooled = _pop_reply_scope(conn, nbytes)
    _track_reply(conn, box, scope)
    return box


def _read_reply_graph(conn, box: int):
    heap = conn.heap
    tag, _, payload = _BOX.unpack(bytes(heap.read(box, C.VALUE_SIZE)))
    out = C.to_python(heap, (tag, payload))
    _recycle_reply(conn, box)
    return out


def _write_reply_blob(ctx, raw: bytes) -> int:
    conn = ctx.conn
    scope, _pooled = _pop_reply_scope(conn, _BLOB_HDR.size + len(raw))
    a = scope.alloc(_BLOB_HDR.size + len(raw))
    # privileged runtime store — the reply lands outside the handler's
    # sandbox, like librpcool writing after SB_END
    ctx._daemon_write(a, _BLOB_HDR.pack(len(raw)) + raw)
    _track_reply(conn, a, scope)
    return a


def _read_blob(reader, a: int, psize: int) -> bytes:
    n = _BLOB_HDR.unpack(bytes(reader.read(a, _BLOB_HDR.size)))[0]
    return bytes(reader.read(gaddr.add(a, _BLOB_HDR.size, psize), n))


# ---------------------------------------------------------------------------
# the typed handler wrapper (receiver half)
# ---------------------------------------------------------------------------
def _reader_for(ctx):
    """The §4.4 contract: a sandboxed request chases pointers through a
    bounds-checked reader (one range check per dereference — the MMU
    fault check under the MPK cost model); a trusted request gets the
    raw-view reader over the whole heap (hardware loads cost nothing
    extra once the mapping exists). A fallback-route ctx reads through
    itself so page faults keep migrating pages."""
    sb = ctx.sandbox
    if sb is not None:
        return C.fast_reader_for_sandbox(sb)
    heap = ctx.heap()
    if getattr(ctx, "conn", None) is not None and \
            getattr(ctx.conn, "server", None) is not None:
        return ctx   # DSM node: reads must fault pages across the link
    return C.FastReader(heap)


def typed_handler(fn):
    """Wrap ``fn(ctx, args: ArgView) -> value`` as a raw ring handler.

    The wrapper dispatches on the descriptor flags, so ONE registration
    serves both routes: F_TYPED alone = pointer-passing (graph view),
    F_TYPED|F_BYVAL = serialized by-value (fallback route / baseline).
    """
    def wrapper(ctx, arg: int) -> int:
        flags = ctx.flags
        if not flags & F_TYPED:
            raise ChannelError(
                "typed handler called through the raw data path "
                "(use conn.invoke, not conn.call)")
        if flags & F_STREAM:
            # streaming reply: hand the transport a ServerStream — the
            # slot completes only when the chunk chain ends
            return _start_stream(ctx, fn, arg, flags)
        if flags & F_BYVAL:
            heap = ctx.heap()
            raw = _read_blob(ctx, arg, heap.page_size)
            view = ArgView.python(serial.decode(raw))   # full deserialize
            ret = fn(ctx, view)
            return _write_reply_blob(ctx, serial.encode(ret))
        view = ArgView.graph(_reader_for(ctx), (C.T_VEC, arg))
        try:
            ret = fn(ctx, view)
        except InvalidPointer as e:
            if ctx.sandbox is not None:
                # the §4.3 wild-pointer attack path: a bad pointer inside
                # a sandboxed request is a sandbox fault (→ E_SANDBOX
                # reply), never an exception class that leaks less intent
                raise SandboxViolation(str(e)) from e
            raise
        return _write_reply_graph(ctx, ret)

    wrapper.__wrapped__ = fn
    wrapper.typed = True
    return wrapper


# ---------------------------------------------------------------------------
# pipelined futures (invoke_async / gather)
# ---------------------------------------------------------------------------
_PENDING, _DONE, _FAILED, _CANCELLED = range(4)


def _deadline_word(deadline: Optional[float]) -> int:
    """Relative seconds of budget → the descriptor's absolute-µs word."""
    return 0 if deadline is None else _now_us() + int(deadline * 1e6)


class RpcFuture:
    """One in-flight typed RPC on a CXL ring connection.

    Many futures may be outstanding on one connection (the whole point of
    per-thread MPK permissions, §5.2) and they complete in whatever order
    the server drains slots; ``gather`` consumes them as they land. A
    future owns its marshal scope until settlement: ``result`` releases
    it back to the pool, ``cancel``/terminal errors release it exactly
    once, and a wait timeout leaves it alive (the server may still be
    reading the arguments mid-flight).
    """

    __slots__ = ("conn", "fn_id", "token", "_scope", "_pooled", "_sealed",
                 "_timeout", "_deadline_us", "_state", "_value", "_exc",
                 "_scope_released", "_batch_release")

    def __init__(self, conn, fn_id: int, token: Tuple[int, int],
                 scope: Optional[Scope], pooled: bool, sealed: bool,
                 timeout: float, deadline_us: int,
                 batch_release: bool = False):
        self.conn = conn
        self.fn_id = fn_id
        self.token = token
        self._scope = scope
        self._pooled = pooled
        self._sealed = sealed
        self._timeout = timeout
        self._deadline_us = deadline_us
        self._state = _PENDING
        self._value = None
        self._exc: Optional[BaseException] = None
        self._scope_released = scope is None
        # §5.3 composed with pipelining: queue this future's seal release
        # for the window flush (``gather``/``end_seal_window``) instead
        # of paying a permission epoch at settlement
        self._batch_release = batch_release

    # -- scope hygiene (the one-shot close()/reap cleanup hook) ----------
    def _release_scope_once(self) -> None:
        if self._scope_released:
            return
        self._scope_released = True
        scope = self._scope
        _pool_recycle(self.conn, scope, self._pooled)

    def _fail(self, exc: BaseException) -> None:
        self._state = _FAILED
        self._exc = exc
        self._release_scope_once()

    # -- the future surface ----------------------------------------------
    def done(self) -> bool:
        """Non-blocking: True once ``result`` will not wait."""
        return self._state != _PENDING or self.conn.poll(self.token)

    def _kick(self) -> None:
        """Transport hook: push any batched flight onto the wire (no-op
        on the CXL ring — the descriptor was posted at invoke time)."""

    def cancel(self) -> bool:
        """Abandon the call. Best-effort (an SPSC slot cannot be
        un-posted, so the server may still execute the handler); the
        reply scope and ring slot are reaped the moment the completion
        lands, and the marshal scope is recycled exactly once."""
        if self._state != _PENDING:
            return False
        conn = self.conn
        pending = conn._pending_async.get(self.token[0])
        self._state = _CANCELLED
        self._exc = ChannelError("future cancelled")
        if pending is not None:
            pending.cleanup = self._release_scope_once
            conn._abandon(self.token, pending)
        else:
            self._release_scope_once()
        return True

    def result(self, timeout: Optional[float] = None):
        """Block (with the §5.8 client back-off) until the reply lands;
        returns the decoded value or raises the RPC's error. A timeout
        raises ``ChannelError`` but leaves the future pending — call
        again, or ``cancel()`` to hand the slot to the reaper."""
        if self._state == _DONE:
            return self._value
        if self._state != _PENDING:
            raise self._exc
        conn = self.conn
        tmo = self._timeout if timeout is None else timeout
        if self._deadline_us:
            tmo = min(tmo, max(0.0,
                               self._deadline_us * 1e-6 - time.monotonic()))
        try:
            ret = conn.wait(self.token, sealed=self._sealed,
                            batch_release=self._batch_release, timeout=tmo)
        except (DeadlineExceeded, Overloaded, RpcError) as e:
            # terminal typed failures: the reply landed (or the server
            # shed the request with E_OVERLOAD) — never a wait timeout
            self._fail(e)
            raise
        except ChannelError as e:
            if not conn.closed and \
                    self.token[0] in conn._pending_async:
                if self._deadline_us and _now_us() > self._deadline_us:
                    # the REQUEST deadline lapsed mid-wait: terminal.
                    # The slot cannot be un-posted, so hand it to the
                    # reaper (scope recycled when the completion lands)
                    # instead of leaving a zombie waiter.
                    exc = DeadlineExceeded("RPC deadline lapsed")
                    self._state = _FAILED
                    self._exc = exc
                    pending = conn._pending_async[self.token[0]]
                    pending.cleanup = self._release_scope_once
                    conn._abandon(self.token, pending)
                    raise exc from e
                raise   # pure wait timeout: still in flight, retryable
            self._fail(e)
            raise
        self._release_scope_once()
        self._value = _read_reply_graph(conn, ret)
        self._state = _DONE
        return self._value


def invoke_async_cxl(conn: Connection, fn_id: int, args: Tuple,
                     sealed: bool = False, sandboxed: bool = False,
                     batch_release: bool = False,
                     deadline: Optional[float] = None,
                     timeout: float = 10.0) -> RpcFuture:
    """Pipelined typed invoke on the shared-memory ring: marshal (or
    pointer-pass a prebuilt graph), post, return — the reply is decoded
    whenever the future is settled. Up to ring-capacity invokes may be
    in flight per connection. ``batch_release`` queues each sealed
    future's release for the window flush (one permission epoch per
    ``gather``, §5.3) instead of one epoch per settlement."""
    deadline_us = _deadline_word(deadline)

    if len(args) == 1 and isinstance(args[0], GraphRef):
        g = args[0]
        if g.scope is not None and g.scope.heap is conn.heap:
            conn.n_invokes += 1
            token = conn.call_async(fn_id, g.root, scope=g.scope,
                                    sealed=sealed, sandboxed=sandboxed,
                                    flags_extra=F_TYPED,
                                    deadline_us=deadline_us)
            fut = RpcFuture(conn, fn_id, token, None, False, sealed,
                            timeout, deadline_us,
                            batch_release=batch_release)
            conn._track_async(token, sealed=sealed, typed=True)
            return fut
        args = tuple(g.to_python())

    root, scope, pooled = _pooled_marshal(conn, args, conn.client_pid,
                                          force_copy=sandboxed or sealed)
    try:
        token = conn.call_async(fn_id, root, scope=scope, sealed=sealed,
                                sandboxed=sandboxed, flags_extra=F_TYPED,
                                deadline_us=deadline_us)
    except BaseException:
        _pool_recycle(conn, scope, pooled)
        raise
    conn.n_invokes += 1
    conn.marshal_bytes += scope.used_bytes()
    fut = RpcFuture(conn, fn_id, token, scope, pooled, sealed,
                    timeout, deadline_us, batch_release=batch_release)
    # close()/reap cleanup hook: drain this future's scope exactly once
    conn._track_async(token, sealed=sealed, typed=True,
                      cleanup=fut._release_scope_once)
    return fut


def gather(futures, timeout: float = 10.0) -> list:
    """Settle a batch of futures, consuming completions **as they land**
    (out-of-order draining — a slow first RPC never blocks the reaping
    of the seven behind it). Returns results in the order given; the
    first failed future raises after everything already completed was
    drained."""
    results = [None] * len(futures)
    pending = dict(enumerate(futures))
    deadline = time.monotonic() + timeout
    # Window epoch batching (§5.3 composed with pipelining): futures
    # created with ``batch_release=True`` queue their seal releases
    # instead of bumping one permission epoch each; the whole window is
    # flushed in ONE epoch once the gather drains (see finally below).
    window_conns = []
    for f in futures:
        conn = getattr(f, "conn", None)
        if (getattr(f, "_batch_release", False) and conn is not None
                and conn not in window_conns):
            window_conns.append(conn)
    try:
        _gather_drain(results, pending, deadline, timeout)
    finally:
        for conn in window_conns:
            end = getattr(conn, "end_seal_window", None)
            if end is not None:
                end()
    return results


def _gather_drain(results, pending, deadline, timeout) -> None:
    failed: Optional[BaseException] = None
    while pending:
        progressed = False
        for i, f in list(pending.items()):
            if not f.done():
                continue
            del pending[i]
            progressed = True
            try:
                results[i] = f.result(timeout=timeout)
            except BaseException as e:
                failed = failed or e
        if not pending:
            break
        if failed is not None:
            break   # drain what's already done, then surface the error
        if time.monotonic() > deadline:
            raise ChannelError(f"gather timed out with {len(pending)} "
                               "futures unsettled")
        if not progressed:
            # nothing ready: block on the oldest pending future in a
            # bounded slice (its result() waits through the connection's
            # §5.8 wait policy — no busy-poll here) after kicking any
            # batched flight onto the wire
            i, f = next(iter(pending.items()))
            f._kick()
            slice_s = min(0.05, max(0.005,
                                    deadline - time.monotonic()))
            try:
                results[i] = f.result(timeout=slice_s)
                del pending[i]
            except (DeadlineExceeded, RpcError) as e:
                failed = failed or e
                del pending[i]
            except WaitTimeout:
                pass   # wait-timeout slice: still in flight, re-loop
            except BaseException as e:
                failed = failed or e
                del pending[i]
    if failed is not None:
        raise failed


# ---------------------------------------------------------------------------
# streaming replies — generation-tagged chunk chains (invoke_stream)
# ---------------------------------------------------------------------------
# A streaming RPC posts ONE descriptor whose argument is a *stream anchor*
# living in the request scope; the server grows a singly-linked chain of
# chunks off the anchor while the call is still in flight — each chunk is
# one pointer flip (store the new chunk's address into the predecessor's
# ``next`` word), the same publication primitive the paper's reply path
# uses. The ring slot completes only when the chain ends, so ordinary
# sweeps keep working and close()/reap hygiene is inherited unchanged.
#
#   anchor (32 B, client scope): [head u64][gen u32][consumed u32]
#                                [args u64][window u32][pad u32]
#   chunk  (32 B + payload):     [next u64][gen u32][seq u32][cflags u32]
#                                [aux u32][vpayload u64]
#
# ``gen`` tags every chunk with the call's generation so a chunk left
# over from an abandoned stream can never be mistaken for a live one.
# ``consumed`` is the client's running count of value chunks taken — the
# server stalls once ``seq - consumed`` reaches ``window`` (bounded-chunk
# backpressure); the sentinel value cancels the stream. CH_VALUE chunks
# carry a boxed containers Value in ``aux``/``vpayload`` (pointer route)
# or a blob address + length (by-value route); CH_ERR carries the RPC
# status in ``aux``.

_ANCHOR = struct.Struct("<QIIQII")   # head, gen, consumed, args, window, pad
_CHUNK = struct.Struct("<QIIIIQ")    # next, gen, seq, cflags, aux, vpayload
CHUNK_HDR_BYTES = _CHUNK.size
_ANCHOR_CONSUMED_OFF = 12
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")

CH_VALUE = 0
CH_END = 1
CH_ERR = 2

DEFAULT_STREAM_WINDOW = 16    # CXL push mode: max unconsumed chunks
STREAM_FLIGHT_CHUNKS = 8      # fallback pull mode: chunks per wire flight
_CHAIN_FREELIST_MAX = 32
_STREAM_CANCEL = 0xFFFFFFFF   # consumed-word sentinel: client cancelled


def _pop_chain_scope(conn, nbytes: int) -> Scope:
    """A recycled chunk-chain scope (one page) or a dedicated right-sized
    one for oversized chunk payloads."""
    heap = _reply_heap(conn)
    if nbytes <= REPLY_SCOPE_PAGES * heap.page_size:
        free = conn._chain_free
        if free:
            s = free.pop()
            s.reset()
            return s
        s = create_scope(heap, REPLY_SCOPE_PAGES * heap.page_size)
    else:
        s = create_scope(heap, nbytes)
    tr = heap._tracer
    if tr is not None:
        # chunk chains are synchronization fabric: the next-word flips
        # race with the consumer's chase by design — ordering comes from
        # the explicit ("chk", ...) publish/consume edges
        tr.sync_pages(heap, *s.page_range())
    return s


def _release_chain_scope(conn, scope: Scope) -> None:
    if scope.num_pages == REPLY_SCOPE_PAGES and \
            len(conn._chain_free) < _CHAIN_FREELIST_MAX:
        conn._chain_free.append(scope)
    elif scope.live:
        scope.destroy()


def _recycle_chunk(conn, addr: int) -> None:
    scope = conn._reply_live.pop(addr, None)
    if scope is not None:
        _release_chain_scope(conn, scope)


class ServerStream:
    """Server half of one streaming reply: the handler's generator plus
    the growing chunk chain.

    Created by ``typed_handler`` when the descriptor carries F_STREAM and
    registered with the serving transport, which *pumps* it: push mode
    (CXL serve loops) emits until the client's bounded window fills, pull
    mode (fallback flights) emits exactly the requested batch. Terminal
    chunks (CH_END / CH_ERR) complete the ring slot, release the seal
    hold, and close the generator.
    """

    _server_stream = True

    __slots__ = ("ctx", "it", "anchor", "gen_tag", "window", "byval",
                 "conn", "ring", "slot", "seal_idx", "flags",
                 "_sc_start", "_sc_count", "_consumed_addr",
                 "seq", "prev", "done", "release_cb", "burst")

    def __init__(self, ctx, it, anchor: int, gen_tag: int, window: int,
                 byval: bool):
        self.ctx = ctx
        self.it = it
        self.anchor = anchor
        self.gen_tag = gen_tag
        self.window = window or DEFAULT_STREAM_WINDOW
        self.byval = byval
        self.conn = None
        self.ring = None
        self.slot = 0
        self.seal_idx = 0
        self.flags = 0
        self._sc_start = 0
        self._sc_count = 0
        self._consumed_addr = 0
        self.seq = 0     # value chunks emitted
        self.prev = 0    # last published chunk (0 = publish to anchor)
        self.done = False
        # admission-gate release (§5.4): a stream stays admitted until
        # its chain ends; every terminal path funnels through abort()
        self.release_cb = None
        # push-mode per-pump emission cap; None = a full window. Serving
        # transports lower it (Channel.stream_pump_burst) when the
        # generators behind concurrent streams share state — e.g. a
        # continuous-batching scheduler — and one stream running a whole
        # window ahead per pump would defeat the batching.
        self.burst = None

    def bind(self, conn, ring, slot: int, seal_idx: int, flags: int,
             sc_start: int, sc_count: int) -> None:
        """Attach the transport half (called by the serve path once the
        descriptor's slot identity is known)."""
        self.conn = conn
        self.ring = ring
        self.slot = slot
        self.seal_idx = seal_idx
        self.flags = flags
        self._sc_start = sc_start
        self._sc_count = sc_count
        self._consumed_addr = gaddr.add(
            self.anchor, _ANCHOR_CONSUMED_OFF,
            _reply_heap(conn).page_size)

    # -- pumping ---------------------------------------------------------
    def pump(self, max_chunks: Optional[int] = None,
             collect: Optional[List[int]] = None) -> int:
        """Advance the generator. Push mode (``max_chunks=None``): emit
        until the client's window is full or the stream ends. Pull mode:
        emit up to ``max_chunks`` value chunks, appending every emitted
        chunk address to ``collect``. Returns the chunks emitted."""
        if self.done:
            return 0
        emitted = 0
        while True:
            if max_chunks is not None:
                if emitted >= max_chunks:
                    break
            else:
                if emitted >= (self.burst or self.window):
                    # push-mode fairness: one pump emits at most a
                    # window's worth (or the transport's tighter burst)
                    # even when a fast consumer keeps the window open —
                    # otherwise the serving thread runs THIS generator
                    # to completion while every other stream (and the
                    # continuous-batching scheduler behind them)
                    # starves. The sweep re-pumps next pass.
                    break
                try:
                    consumed = self._read_consumed()
                except (InvalidPointer, ChannelError):
                    # the client closed mid-stream and its anchor pages
                    # went back to the heap: drop the stream instead of
                    # killing the serving thread
                    self.abort()
                    break
                if consumed == _STREAM_CANCEL:
                    self._complete(R_ERR, E_EXCEPTION)
                    break
                if self.seq - consumed >= self.window:
                    break   # backpressure: bounded chunk window is full
            dl = getattr(self.ctx, "deadline_us", 0)
            if dl and _now_us() > dl:
                self._finish(CH_ERR, E_DEADLINE, collect)
                emitted += 1
                break
            try:
                value = self._next_value()
            except StopIteration:
                self._finish(CH_END, OK, collect)
                emitted += 1
                break
            except DeadlineExceeded:
                self._finish(CH_ERR, E_DEADLINE, collect)
                emitted += 1
                break
            except Overloaded as e:
                # pool-pressure shed from inside the handler (the §5.4
                # retry-after path): the terminal chunk's value word
                # carries the suggested back-off in microseconds
                self._finish(CH_ERR, E_OVERLOAD, collect,
                             val=max(0, int(e.retry_after_s * 1e6)))
                emitted += 1
                break
            except SandboxViolation:
                self._finish(CH_ERR, E_SANDBOX, collect)
                emitted += 1
                break
            except InvalidPointer:
                status = E_SANDBOX if self.flags & F_SANDBOXED \
                    else E_EXCEPTION
                self._finish(CH_ERR, status, collect)
                emitted += 1
                break
            except BaseException:
                self._finish(CH_ERR, E_EXCEPTION, collect)
                emitted += 1
                break
            try:
                self._emit_value(value, collect)
            except (InvalidPointer, ChannelError):
                # the client tore the connection down mid-stream: the
                # chain pages are gone — just drop the generator
                self.abort()
                break
            emitted += 1
        return emitted

    def _next_value(self):
        if self.flags & F_SANDBOXED and self._sc_count:
            # re-enter the request's sandbox for this slice of handler
            # code (cached key ⇒ the O(1) PKRU-write path, §5.2)
            with self.conn.sandboxes.enter(self._sc_start,
                                           self._sc_count) as sb:
                self.ctx.sandbox = sb
                return next(self.it)
        return next(self.it)

    def _read_consumed(self) -> int:
        heap = _reply_heap(self.conn)
        tr = heap._tracer
        if tr is not None:
            tr.sync_acquire(("cons", tr._space(heap), self._consumed_addr))
        return _U32.unpack(bytes(heap.read(self._consumed_addr, 4)))[0]

    # -- chunk emission --------------------------------------------------
    def _emit_value(self, value, collect) -> None:
        conn = self.conn
        if self.byval:
            raw = serial.encode(value)
            scope = _pop_chain_scope(conn, _CHUNK.size + len(raw))
            hdr = scope.alloc(_CHUNK.size)
            blob = scope.alloc(len(raw))
            self.ctx._daemon_write(blob, raw)
            self.ctx._daemon_write(hdr, _CHUNK.pack(
                0, self.gen_tag, self.seq, CH_VALUE, len(raw), blob))
        else:
            scope, hdr, val = self._build_graph_chunk(conn, value)
            self.ctx._daemon_write(hdr, _CHUNK.pack(
                0, self.gen_tag, self.seq, CH_VALUE, val[0], val[1]))
        conn._reply_live[hdr] = scope
        self.seq += 1
        self._publish(hdr, collect)

    def _build_graph_chunk(self, conn, value):
        heap = _reply_heap(conn)
        nbytes = REPLY_SCOPE_PAGES * heap.page_size
        scope = _pop_chain_scope(conn, nbytes)
        while True:
            try:
                hdr = scope.alloc(_CHUNK.size)
                return scope, hdr, C.build_value(scope, value)
            except AllocationError:
                # big chunk: geometrically larger dedicated scope
                _release_chain_scope(conn, scope)
                nbytes *= 8
                if nbytes > heap.num_pages * heap.page_size:
                    raise
                scope = _pop_chain_scope(conn, nbytes)

    def _publish(self, hdr: int, collect) -> None:
        """The pointer flip: store the chunk's address into its
        predecessor's ``next`` word (or the anchor's head)."""
        target = self.anchor if self.prev == 0 else self.prev
        heap = _reply_heap(self.conn)
        tr = heap._tracer
        if tr is not None:
            # the pointer flip publishes the chunk: everything written
            # into it happens-before the client's chase of this word
            tr.sync_release(("chk", tr._space(heap), hdr))
        self.ctx._daemon_write(target, _U64.pack(hdr))
        self.prev = hdr
        if collect is not None:
            collect.append(hdr)

    # -- termination -----------------------------------------------------
    def _finish(self, cflags: int, status: int, collect,
                val: int = 0) -> None:
        conn = self.conn
        try:
            scope = _pop_chain_scope(conn, _CHUNK.size)
            hdr = scope.alloc(_CHUNK.size)
            self.ctx._daemon_write(hdr, _CHUNK.pack(
                0, self.gen_tag, self.seq, cflags, status, val))
            conn._reply_live[hdr] = scope
            self._publish(hdr, collect)
        except (InvalidPointer, ChannelError):
            self.abort()
            return
        self._complete(R_DONE if cflags == CH_END else R_ERR, status, val)

    def _complete(self, state: int, status: int, ret: int = 0) -> None:
        if self.flags & F_SEALED:
            try:
                self.conn.seals.mark_complete(self.seal_idx)
            except SealViolation:
                pass
        # the ret word mirrors the terminal chunk's value word (e.g. the
        # E_OVERLOAD retry-after µs) so a client that settles via the
        # slot sees the same typed hint as one that read the chain
        tr = _reply_heap(self.conn)._tracer
        if tr is not None:
            tr.sync_release(("rep", id(self.ring), self.slot))
        self.ring.complete(self.slot, ret, state, status)
        self.abort()

    def abort(self) -> None:
        """Drop the stream without touching the ring (client gone, or
        terminal chunk already published)."""
        self.done = True
        cb, self.release_cb = self.release_cb, None  # fire exactly once
        if cb is not None:
            cb()
        try:
            self.it.close()
        except Exception:
            pass


def _start_stream(ctx, fn, arg: int, flags: int) -> ServerStream:
    """Receiver half of a streaming invoke: decode the anchor, build the
    handler's ArgView, call it, and wrap the returned iterable."""
    heap = ctx.heap()
    if flags & F_BYVAL:
        reader = ctx   # fallback route: reads fault pages across the link
    else:
        reader = _reader_for(ctx)
    (_head, gen_tag, _consumed, args_addr, window, _pad) = _ANCHOR.unpack(
        bytes(reader.read(arg, _ANCHOR.size)))
    if flags & F_BYVAL:
        raw = _read_blob(reader, args_addr, heap.page_size)
        view = ArgView.python(serial.decode(raw))
    else:
        view = ArgView.graph(reader, (C.T_VEC, args_addr))
    try:
        result = fn(ctx, view)
    except InvalidPointer as e:
        if ctx.sandbox is not None:
            raise SandboxViolation(str(e)) from e
        raise
    return ServerStream(ctx, iter(result), arg, gen_tag, window,
                        byval=bool(flags & F_BYVAL))


class RpcStream:
    """Client half of a streaming RPC on the CXL ring — an iterator that
    yields chunks **as the server publishes them** (time-to-first-token,
    not time-to-last).

    A per-``next`` ``timeout`` raises ``ChannelError`` and leaves the
    stream consumable (retry the wait); a lapsed stream *deadline* is
    terminal and hands the slot to the reaper. ``close()`` cancels: the
    sentinel store makes the server abort the generator at its next pump
    and the slot is reaped once that completion lands.
    """

    __slots__ = ("conn", "fn_id", "token", "_scope", "_pooled", "_sealed",
                 "_gen", "_timeout", "_deadline_us", "_pump", "_words",
                 "_watch", "_consumed_addr", "_prev", "_seq", "_state",
                 "_exc", "_scope_released")

    def __init__(self, conn, fn_id: int, token: Tuple[int, int],
                 anchor: int, scope: Scope, pooled: bool, sealed: bool,
                 gen_tag: int, timeout: float, deadline_us: int,
                 pump=None):
        self.conn = conn
        self.fn_id = fn_id
        self.token = token
        self._scope = scope
        self._pooled = pooled
        self._sealed = sealed
        self._gen = gen_tag
        self._timeout = timeout
        self._deadline_us = deadline_us
        self._pump = pump
        heap = conn.heap
        self._words = heap.buf.data.cast("Q")
        self._watch = gaddr.linear(anchor, heap.page_size) // 8
        self._consumed_addr = gaddr.add(anchor, _ANCHOR_CONSUMED_OFF,
                                        heap.page_size)
        tr = heap._tracer
        if tr is not None:
            # the anchor page carries the head/consumed watch words —
            # racy-by-design sync fabric, like the descriptor ring
            tr.sync_pages(heap,
                          gaddr.linear(anchor, heap.page_size)
                          // heap.page_size, 1)
        self._prev = 0   # last consumed chunk (recycled with a lag of one)
        self._seq = 0
        self._state = _PENDING
        self._exc: Optional[BaseException] = None
        self._scope_released = False

    def __iter__(self) -> "RpcStream":
        return self

    def __next__(self):
        return self.next()

    def next(self, timeout: Optional[float] = None):
        """The next chunk value; raises ``StopIteration`` at stream end,
        the RPC's mapped error on failure."""
        if self._state == _DONE:
            raise StopIteration
        if self._state != _PENDING:
            raise self._exc
        conn = self.conn
        ring = conn.ring
        slot = self.token[0]
        words = self._words
        policy = conn.wait_policy
        deadline = time.monotonic() + \
            (self._timeout if timeout is None else timeout)
        # a fixed-cadence policy asks for polite polling: skip the bare
        # GIL-yield prelude entirely — N streaming consumers spinning
        # sleep(0) between chunks would starve the serving thread's
        # dispatch path of the interpreter lock
        spins = 0 if policy.fixed is not None else 256
        while True:
            if conn.closed:
                # checked BEFORE touching the chain: close() freed the
                # chunk pages, so a stale watch word must not be chased
                self._fail_cleanup(ChannelError(
                    "connection closed with the stream in flight"))
                raise self._exc
            addr = words[self._watch]
            if addr:
                return self._consume_chunk(int(addr))
            if ring.state_of(slot) >= R_DONE:
                return self._settle_no_chunk()
            if self._deadline_us and _now_us() > self._deadline_us:
                self._lapse()
            if time.monotonic() > deadline:
                raise WaitTimeout("stream chunk timed out")
            if self._pump is not None:
                self._pump()   # inline mode: this thread IS the server
                continue
            if spins:
                spins -= 1
                time.sleep(0)
                continue
            time.sleep(policy.delay_s())

    # -- chunk consumption -----------------------------------------------
    def _consume_chunk(self, addr: int):
        conn = self.conn
        heap = conn.heap
        tr = heap._tracer
        if tr is not None:
            tr.sync_acquire(("chk", tr._space(heap), addr))
        try:
            (_nxt, cgen, seq, cflags, aux, vpayload) = _CHUNK.unpack(
                bytes(heap.read(addr, _CHUNK.size)))
        except InvalidPointer:
            if conn.closed:   # close() raced the read: chain pages gone
                self._fail_cleanup(ChannelError(
                    "connection closed with the stream in flight"))
                raise self._exc from None
            raise
        if cgen != self._gen:
            self._fail_cleanup(ChannelError(
                f"stale stream chunk: generation {cgen} != {self._gen}"))
            raise self._exc
        if cflags == CH_VALUE:
            if seq != self._seq:
                self._fail_cleanup(ChannelError(
                    f"stream chunk out of order: {seq} != {self._seq}"))
                raise self._exc
            value = C.to_python(heap, (aux, vpayload))
            self._seq += 1
            # open the server's bounded window (runtime metadata — a
            # daemon store, legal even while the anchor scope is sealed)
            if tr is not None:
                tr.sync_release(("cons", tr._space(heap),
                                 self._consumed_addr))
            heap.write(self._consumed_addr, _U32.pack(self._seq))
            if self._prev:
                # recycle lag of one: a chunk scope is reusable only once
                # its ``next`` word has been read
                _recycle_chunk(conn, self._prev)
            self._prev = addr
            self._watch = gaddr.linear(addr, heap.page_size) // 8
            return value
        if cflags == CH_END:
            self._settle(addr, None)
            if self._state == _FAILED:
                raise self._exc
            raise StopIteration
        # CH_ERR: aux carries the status, vpayload the retry-after hint
        self._settle(addr, aux, vpayload)
        raise self._exc

    def _settle(self, last_addr: int, status: Optional[int],
                val: int = 0) -> None:
        """Consume the completed ring slot (releasing the seal) and
        recycle the tail of the chain."""
        conn = self.conn
        exc: Optional[BaseException] = None
        try:
            conn.wait(self.token, sealed=self._sealed,
                      timeout=self._timeout)
        except BaseException as e:
            exc = e
        if self._prev:
            _recycle_chunk(conn, self._prev)
            self._prev = 0
        _recycle_chunk(conn, last_addr)
        self._release_scope_once()
        if exc is None and status is not None:
            if status == E_DEADLINE:
                exc = DeadlineExceeded("RPC deadline lapsed")
            elif status == E_OVERLOAD:
                exc = Overloaded("server shed the stream (E_OVERLOAD)",
                                 retry_after_s=val / 1e6)
            else:
                exc = RpcError(status)
        if exc is not None:
            self._state = _FAILED
            self._exc = exc
        else:
            self._state = _DONE

    def _settle_no_chunk(self):
        # the slot completed with no chunk pending: either this lost a
        # race with the final publish (re-check), or a non-streaming
        # handler answered with a single boxed reply
        addr = self._words[self._watch]
        if addr:
            return self._consume_chunk(int(addr))
        conn = self.conn
        try:
            ret = conn.wait(self.token, sealed=self._sealed,
                            timeout=self._timeout)
        except BaseException as e:
            self._fail_cleanup(e)
            raise
        _recycle_reply(conn, ret)
        self._fail_cleanup(ChannelError(
            "handler completed without streaming (declare the method "
            "with @method(streaming=True))"))
        raise self._exc

    def _lapse(self) -> None:
        """The stream *deadline* lapsed mid-wait: terminal — hand the
        slot to the reaper (the server's own deadline check completes
        it) and fail the iterator."""
        conn = self.conn
        exc = DeadlineExceeded("stream deadline lapsed")
        pending = conn._pending_async.get(self.token[0])
        if pending is not None:
            pending.cleanup = self._release_scope_once
            conn._abandon(self.token, pending)
        else:
            self._release_scope_once()
        if self._prev:
            _recycle_chunk(conn, self._prev)
            self._prev = 0
        self._state = _FAILED
        self._exc = exc
        raise exc

    # -- cancellation / hygiene ------------------------------------------
    def close(self) -> None:
        """Abandon the stream (best-effort cancel): the sentinel store
        aborts the server generator at its next pump; the ring slot is
        reaped when that completion lands."""
        if self._state != _PENDING:
            return
        conn = self.conn
        if not conn.closed:
            try:
                conn.heap.write(self._consumed_addr,
                                _U32.pack(_STREAM_CANCEL))
            except InvalidPointer:
                pass
            pending = conn._pending_async.get(self.token[0])
            if pending is not None:
                pending.cleanup = self._release_scope_once
                conn._abandon(self.token, pending)
        if self._prev:
            _recycle_chunk(conn, self._prev)
            self._prev = 0
        self._state = _FAILED
        self._exc = ChannelError("stream cancelled")

    def _fail_cleanup(self, exc: BaseException) -> None:
        if self._prev:
            _recycle_chunk(self.conn, self._prev)
            self._prev = 0
        self._release_scope_once()
        self._state = _FAILED
        self._exc = exc

    def _release_scope_once(self) -> None:
        if self._scope_released:
            return
        self._scope_released = True
        scope = self._scope
        _pool_recycle(self.conn, scope, self._pooled)


def _marshal_stream(conn: Connection, args: Tuple, gen_tag: int,
                    window: int, force_copy: bool):
    """(anchor, scope, pooled) — the stream anchor and the marshalled
    argument tuple, together in one (pooled when possible) scope."""
    pid = conn.client_pid

    def _fill(scope: Scope) -> int:
        anchor = scope.alloc(_ANCHOR.size)
        root = marshal_args(scope, args, pid, force_copy)
        conn.heap.write(anchor, _ANCHOR.pack(0, gen_tag, 0, root,
                                             window, 0), pid=pid)
        return anchor

    return _fill_pooled(conn, pid, _fill)


def invoke_stream_cxl(conn: Connection, fn_id: int, args: Tuple,
                      sealed: bool = False, sandboxed: bool = False,
                      deadline: Optional[float] = None,
                      timeout: float = 10.0,
                      window: int = DEFAULT_STREAM_WINDOW,
                      inline: bool = False) -> RpcStream:
    """Streaming typed invoke on the shared-memory ring: marshal (or
    pointer-pass) the arguments once, post one descriptor, and consume
    the server's reply chain chunk by chunk as it grows."""
    deadline_us = _deadline_word(deadline)
    conn._stream_gen += 1
    gen_tag = conn._stream_gen
    force_copy = sandboxed or sealed

    if len(args) == 1 and isinstance(args[0], GraphRef):
        g = args[0]
        if g.scope is not None and g.scope.heap is conn.heap and \
                not force_copy:
            # steady-state hot path: anchor-only scope, args by pointer
            pool = _marshal_pool(conn)
            scope = pool.pop()
            try:
                anchor = scope.alloc(_ANCHOR.size)
                conn.heap.write(anchor, _ANCHOR.pack(
                    0, gen_tag, 0, g.root, window, 0),
                    pid=conn.client_pid)
            except BaseException:
                pool.push(scope)
                raise
            return _post_stream(conn, fn_id, anchor, scope, True, sealed,
                                sandboxed, deadline_us, timeout, gen_tag,
                                inline)
        if g.scope is None or g.scope.heap is not conn.heap:
            args = tuple(g.to_python())
        # same-heap ref under seal/sandbox: the generic path deep-copies

    anchor, scope, pooled = _marshal_stream(conn, args, gen_tag, window,
                                            force_copy)
    return _post_stream(conn, fn_id, anchor, scope, pooled, sealed,
                        sandboxed, deadline_us, timeout, gen_tag, inline)


def _post_stream(conn, fn_id, anchor, scope, pooled, sealed, sandboxed,
                 deadline_us, timeout, gen_tag, inline) -> RpcStream:
    try:
        token = conn.call_async(fn_id, anchor, scope=scope, sealed=sealed,
                                sandboxed=sandboxed,
                                flags_extra=F_TYPED | F_STREAM,
                                deadline_us=deadline_us)
    except BaseException:
        _pool_recycle(conn, scope, pooled)
        raise
    conn.n_invokes += 1
    conn.marshal_bytes += scope.used_bytes()
    stream = RpcStream(conn, fn_id, token, anchor, scope, pooled, sealed,
                       gen_tag, timeout, deadline_us)
    conn._track_async(token, sealed=sealed, typed=True,
                      cleanup=stream._release_scope_once)
    if inline:
        # the two-core analogue for single-threaded setups: process the
        # descriptor now and let the consuming thread pump the stream
        # (same contract — and caveats — as call_inline)
        conn.channel._process(conn, token[0])
        conn.ring.head += 1
        stream._pump = conn.channel.pump_streams
    return stream


class FallbackRpcStream:
    """Client half of a streaming RPC over the software-coherent link.

    Pull-driven: when the local chunk queue runs dry, one *staged chunk
    flight* crosses the wire — the server advances the generator up to
    ``window`` chunks and every chunk page migrates back in ONE bulk
    transfer (the cMPI amortization applied to the reply chain), so the
    link latency is paid per flight, not per token.
    """

    __slots__ = ("conn", "fn_id", "slot", "window", "_scope", "_sealed",
                 "_seal_idx", "_gen", "_deadline_us", "_timeout", "_srv",
                 "_pending", "_prev", "_seq", "_state", "_exc",
                 "_scope_released")

    def __init__(self, conn, fn_id: int, slot: int, scope: Scope,
                 sealed: bool, seal_idx: int, gen_tag: int, window: int,
                 deadline_us: int, timeout: float):
        self.conn = conn
        self.fn_id = fn_id
        self.slot = slot
        self.window = window
        self._scope = scope
        self._sealed = sealed
        self._seal_idx = seal_idx
        self._gen = gen_tag
        self._deadline_us = deadline_us
        self._timeout = timeout
        self._srv: Optional[ServerStream] = None
        self._pending: List[int] = []   # migrated, not yet consumed
        self._prev = 0
        self._seq = 0
        self._state = _PENDING
        self._exc: Optional[BaseException] = None
        self._scope_released = False

    def __iter__(self) -> "FallbackRpcStream":
        return self

    def __next__(self):
        return self.next()

    def next(self, timeout: Optional[float] = None):
        if self._state == _DONE:
            raise StopIteration
        if self._state != _PENDING:
            raise self._exc
        conn = self.conn
        if conn.closed:
            self._teardown(ChannelError(
                "connection closed with the stream in flight"))
            raise self._exc
        if not self._pending:
            if self._srv is None or self._srv.done:
                return self._settle_slot()
            self._pending.extend(conn.pump_stream(self._srv, self.window))
            if not self._pending:
                return self._settle_slot()
        return self._consume_chunk(self._pending.pop(0))

    # -- chunk consumption -----------------------------------------------
    def _consume_chunk(self, addr: int):
        conn = self.conn
        node = conn.client
        (_nxt, cgen, seq, cflags, aux, vpayload) = _CHUNK.unpack(
            bytes(node.read(addr, _CHUNK.size)))
        if cgen != self._gen:
            self._teardown(ChannelError(
                f"stale stream chunk: generation {cgen} != {self._gen}"))
            raise self._exc
        if cflags == CH_VALUE:
            if seq != self._seq:
                self._teardown(ChannelError(
                    f"stream chunk out of order: {seq} != {self._seq}"))
                raise self._exc
            value = serial.decode(bytes(node.read(vpayload, aux)))
            self._seq += 1
            if self._prev:
                _recycle_chunk(conn, self._prev)
            self._prev = addr
            return value
        self._settle(addr, None if cflags == CH_END else aux, vpayload)
        if self._state == _FAILED:
            raise self._exc
        raise StopIteration

    def _settle(self, last_addr: int, status: Optional[int],
                val: int = 0) -> None:
        conn = self.conn
        conn.link.send_msg(CHUNK_HDR_BYTES)   # completion descriptor
        tr = conn.client.heap._tracer
        if tr is not None:
            tr.sync_acquire(("rep", id(conn.ring), self.slot))
        _ret, _state, _status = conn.ring.consume(self.slot)
        self._release_seal_once()
        if self._prev:
            _recycle_chunk(conn, self._prev)
            self._prev = 0
        _recycle_chunk(conn, last_addr)
        self._release_scope_once()
        conn.n_calls += 1
        conn._drop_client_stream(self)
        if status is None:
            self._state = _DONE
            return
        self._state = _FAILED
        if status == E_DEADLINE:
            self._exc = DeadlineExceeded("RPC deadline lapsed")
        elif status == E_OVERLOAD:
            self._exc = Overloaded("server shed the stream (E_OVERLOAD)",
                                   retry_after_s=val / 1e6)
        else:
            self._exc = RpcError(status)

    def _settle_slot(self):
        """No chunks and no live server stream: the call failed before
        (or without) streaming — surface the recorded error."""
        conn = self.conn
        ring = conn.ring
        if ring.state_of(self.slot) < R_DONE:
            self._teardown(ChannelError("stream produced no chunks"))
            raise self._exc
        tr = conn.client.heap._tracer
        if tr is not None:
            tr.sync_acquire(("rep", id(ring), self.slot))
        ret, state, status = ring.consume(self.slot)
        exc = conn._flight_errors.pop(self.slot, None)
        self._release_seal_once()
        self._release_scope_once()
        conn._drop_client_stream(self)
        if state == R_DONE:
            _recycle_reply(conn, ret)
        if exc is None:
            if status == E_DEADLINE:
                exc = DeadlineExceeded("RPC deadline lapsed")
            elif status == E_OVERLOAD:
                exc = Overloaded("server shed the stream (E_OVERLOAD)")
            elif state == R_ERR:
                exc = RpcError(status)
            else:
                exc = ChannelError(
                    "handler completed without streaming (declare the "
                    "method with @method(streaming=True))")
        self._state = _FAILED
        self._exc = exc
        raise exc

    # -- cancellation / hygiene ------------------------------------------
    def close(self) -> None:
        """Abandon the stream: abort the server generator, consume the
        slot, and drain every client-held resource exactly once."""
        if self._state != _PENDING:
            return
        conn = self.conn
        if self._srv is not None and not self._srv.done:
            self._srv.abort()
            if conn.ring.state_of(self.slot) < R_DONE:
                conn.ring.complete(self.slot, 0, R_ERR, E_EXCEPTION)
        if conn.ring.state_of(self.slot) >= R_DONE:
            conn.ring.consume(self.slot)
        conn._flight_errors.pop(self.slot, None)
        self._teardown(ChannelError("stream cancelled"))

    def _fail_on_close(self) -> None:
        """Connection-close hook: fail the waiter with ChannelError and
        drain the argument scope exactly once (chunk scopes die with the
        connection's reply/chain registries)."""
        if self._srv is not None:
            self._srv.abort()
        if self._state == _PENDING:
            self._state = _FAILED
            self._exc = ChannelError(
                "connection closed with the stream in flight")
        self._release_scope_once()

    def _teardown(self, exc: BaseException) -> None:
        conn = self.conn
        self._release_seal_once()
        for addr in (*([self._prev] if self._prev else ()),
                     *self._pending):
            _recycle_chunk(conn, addr)
        self._prev = 0
        self._pending.clear()
        self._release_scope_once()
        conn._drop_client_stream(self)
        self._state = _FAILED
        self._exc = exc

    def _release_seal_once(self) -> None:
        if self._sealed:
            self._sealed = False
            try:
                self.conn.seals.release(self._seal_idx,
                                        holder=self.conn.client_pid)
            except SealViolation:
                pass

    def _release_scope_once(self) -> None:
        if not self._scope_released:
            self._scope_released = True
            if self._scope.live:
                self._scope.destroy()


def invoke_stream_fallback(conn, fn_id: int, args: Tuple,
                           sealed: bool = False, sandboxed: bool = False,
                           deadline: Optional[float] = None,
                           timeout: float = 10.0,
                           window: int = STREAM_FLIGHT_CHUNKS,
                           **_ignored) -> FallbackRpcStream:
    """Streaming typed invoke over the link: by-value args cross once,
    then the reply chain comes back in staged flights of up to ``window``
    chunks per wire flush."""
    payload = serial.encode(_args_to_plain(args))
    nbytes = _ANCHOR.size + _BLOB_HDR.size + len(payload)
    scope = conn.create_scope(nbytes)
    conn._stream_gen += 1
    gen_tag = conn._stream_gen
    deadline_us = _deadline_word(deadline)
    try:
        anchor = scope.alloc(_ANCHOR.size)
        a = scope.alloc(_BLOB_HDR.size + len(payload))
        conn.client.write(a, _BLOB_HDR.pack(len(payload)) + payload,
                          pid=conn.client_pid)
        conn.client.write(anchor,
                          _ANCHOR.pack(0, gen_tag, 0, a, window, 0),
                          pid=conn.client_pid)
        slot, seal_idx = conn._post(fn_id, anchor, scope, sealed,
                                    sandboxed,
                                    F_TYPED | F_BYVAL | F_STREAM,
                                    deadline_us)
    except BaseException:
        scope.destroy()
        raise
    conn.n_invokes += 1
    conn.marshal_bytes += len(payload)
    stream = FallbackRpcStream(conn, fn_id, slot, scope, sealed, seal_idx,
                               gen_tag, window, deadline_us, timeout)
    conn.start_stream(stream)
    return stream


# ---------------------------------------------------------------------------
# invoke — CXL route (pointer passing)
# ---------------------------------------------------------------------------
def invoke_cxl(conn: Connection, fn_id: int, args: Tuple,
               sealed: bool = False, sandboxed: bool = False,
               batch_release: bool = False, timeout: float = 10.0,
               inline: bool = False, spin_sleep_us: float = 0.0,
               deadline: Optional[float] = None):
    """Typed invoke on the shared-memory ring: materialize-once, pass a
    pointer, decode the marshalled reply."""
    caller = conn.call_inline if inline else conn.call
    kw: Dict[str, Any] = {} if inline else \
        {"timeout": timeout, "spin_sleep_us": spin_sleep_us}
    if deadline is not None:
        kw["deadline_us"] = _deadline_word(deadline)

    # steady-state hot path: a single pre-built graph in this heap is
    # passed by pointer — zero marshalling work per call
    if len(args) == 1 and isinstance(args[0], GraphRef):
        g = args[0]
        if g.scope is not None and g.scope.heap is conn.heap:
            conn.n_invokes += 1
            ret = caller(fn_id, g.root, scope=g.scope, sealed=sealed,
                         sandboxed=sandboxed, batch_release=batch_release,
                         flags_extra=F_TYPED, **kw)
            return _read_reply_graph(conn, ret)
        # foreign-heap / plain ref: deep-copy the tuple across (§5.6)
        args = tuple(g.to_python())

    pid = conn.client_pid
    # sandboxed: the sandbox covers only the call scope, so embedded
    # graphs must be copied into it; sealed: the seal likewise protects
    # only the call scope — a pointer-embedded graph would stay sender-
    # writable mid-flight, the exact §4.5 TOCTOU sealing prevents
    root, scope, pooled = _pooled_marshal(conn, args, pid,
                                          force_copy=sandboxed or sealed)
    conn.n_invokes += 1
    conn.marshal_bytes += scope.used_bytes()
    try:
        ret = caller(fn_id, root, scope=scope, sealed=sealed,
                     sandboxed=sandboxed, batch_release=batch_release,
                     flags_extra=F_TYPED, **kw)
    finally:
        if pooled and sealed and batch_release:
            # pages stay write-protected until the batch flush (§5.3)
            _pool_recycle(conn, scope, True, seal_idx=conn.last_seal_idx)
        else:
            _pool_recycle(conn, scope, pooled)
    return _read_reply_graph(conn, ret)


# ---------------------------------------------------------------------------
# invoke — serialized routes (fallback transport + Fig. 11 baseline)
# ---------------------------------------------------------------------------
def _to_plain(v):
    """§5.6 copy semantics for a graph crossing a coherence boundary:
    the structural traversal materializes it (the ``deep_copy`` read
    half) and the result travels by value."""
    if isinstance(v, GraphRef):
        return v.to_python()
    return v


def _args_to_plain(args: Tuple) -> list:
    if len(args) == 1 and isinstance(args[0], GraphRef):
        return args[0].to_python()   # the ref IS the argument tuple
    return [_to_plain(v) for v in args]


def invoke_fallback(conn, fn_id: int, args: Tuple, sealed: bool = False,
                    sandboxed: bool = False, batch_release: bool = False,
                    timeout: float = 10.0, inline: bool = False,
                    deadline: Optional[float] = None, **_ignored):
    """Typed invoke over the software-coherent link: same surface, but
    the arguments are serial-encoded and travel by value (one blob copy
    over the wire instead of N page ping-pongs chasing pointers)."""
    payload = serial.encode(_args_to_plain(args))
    nbytes = _BLOB_HDR.size + len(payload)
    scope = conn.create_scope(nbytes)
    conn.n_invokes += 1
    conn.marshal_bytes += len(payload)
    try:
        a = scope.alloc(nbytes)
        conn.client.write(a, _BLOB_HDR.pack(len(payload)) + payload,
                          pid=conn.client_pid)
        ret = conn.call(fn_id, a, scope=scope, sealed=sealed,
                        sandboxed=sandboxed, batch_release=batch_release,
                        flags_extra=F_TYPED | F_BYVAL,
                        deadline_us=_deadline_word(deadline))
        # the reply blob faults its pages back over the link — the copy
        raw = _read_blob(conn.client, ret, conn.client.page_size)
        _recycle_reply(conn, ret)
        return serial.decode(raw)
    finally:
        scope.destroy()


class FallbackRpcFuture:
    """A pipelined invoke on the software-coherent link. Same surface as
    ``RpcFuture``; underneath, the descriptor+payload are *staged* and
    the whole flight crosses the wire on the first settlement (or an
    explicit ``conn.flush()``) — N staged invokes share one link-latency
    round trip instead of paying it N times."""

    __slots__ = ("conn", "fn_id", "slot", "_scope", "_sealed", "_seal_idx",
                 "_deadline_us", "_state", "_value", "_exc")

    def __init__(self, conn, fn_id: int, slot: int, scope: Scope,
                 sealed: bool, seal_idx: int, deadline_us: int):
        self.conn = conn
        self.fn_id = fn_id
        self.slot = slot
        self._scope = scope
        self._sealed = sealed
        self._seal_idx = seal_idx
        self._deadline_us = deadline_us
        self._state = _PENDING
        self._value = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        if self._state != _PENDING:
            return True
        return not self.conn.in_flight(self.slot) and \
            self.conn.ring.state_of(self.slot) >= R_DONE

    def _kick(self) -> None:
        self.conn.flush()

    def cancel(self) -> bool:
        if self._state != _PENDING:
            return False
        self._state = _CANCELLED
        self._exc = ChannelError("future cancelled")
        self.conn.abandon_flight_entry(self.slot, self._scope,
                                       self._sealed, self._seal_idx)
        return True

    def result(self, timeout: Optional[float] = None):
        if self._state == _DONE:
            return self._value
        if self._state != _PENDING:
            raise self._exc
        conn = self.conn
        if conn.closed:
            self._state = _FAILED
            self._exc = ChannelError(
                "connection closed with the RPC in flight")
            raise self._exc
        if conn.in_flight(self.slot):
            conn.flush()
        tr = conn.client.heap._tracer
        if tr is not None:
            tr.sync_acquire(("rep", id(conn.ring), self.slot))
        ret, state, status = conn.ring.consume(self.slot)
        if self._sealed and not conn._consume_window_release(self._seal_idx):
            # the window flush did not cover this seal (error path, or
            # window batching disabled): fall back to a per-future release
            conn.seals.release(self._seal_idx, holder=conn.client_pid)
        try:
            exc = conn._flight_errors.pop(self.slot, None)
            if exc is not None:
                raise exc
            if state == R_ERR:
                if status == E_DEADLINE:
                    raise DeadlineExceeded("RPC deadline lapsed")
                if status == E_OVERLOAD:
                    raise Overloaded(
                        "server shed the request (E_OVERLOAD)",
                        retry_after_s=ret * 1e-6)
                raise RpcError(status)
            # the reply pages were bulk-migrated back by the flush; this
            # read is local (a straggler still faults correctly)
            raw = _read_blob(conn.client, ret, conn.client.page_size)
            _recycle_reply(conn, ret)
            self._value = serial.decode(raw)
        except BaseException as e:
            self._state = _FAILED
            self._exc = e
            raise
        finally:
            if self._scope.live:
                self._scope.destroy()
            conn.n_calls += 1
        self._state = _DONE
        return self._value


def invoke_async_fallback(conn, fn_id: int, args: Tuple,
                          sealed: bool = False, sandboxed: bool = False,
                          deadline: Optional[float] = None,
                          timeout: float = 10.0,
                          **_ignored) -> FallbackRpcFuture:
    """Stage a typed by-value invoke for the next pipelined flight (§5.6
    copy semantics, cMPI-style latency amortization)."""
    payload = serial.encode(_args_to_plain(args))
    nbytes = _BLOB_HDR.size + len(payload)
    scope = conn.create_scope(nbytes)
    deadline_us = _deadline_word(deadline)
    try:
        a = scope.alloc(nbytes)
        conn.client.write(a, _BLOB_HDR.pack(len(payload)) + payload,
                          pid=conn.client_pid)
        slot = conn.post_async(fn_id, a, scope, sealed=sealed,
                               sandboxed=sandboxed,
                               flags_extra=F_TYPED | F_BYVAL,
                               deadline_us=deadline_us)
    except BaseException:
        scope.destroy()
        raise
    conn.n_invokes += 1
    conn.marshal_bytes += len(payload)
    seal_idx = conn.ring.seal_idx[slot]
    return FallbackRpcFuture(conn, fn_id, slot, scope, sealed,
                             int(seal_idx), deadline_us)


def invoke_serialized(conn: Connection, fn_id: int, args: Tuple,
                      sealed: bool = False, sandboxed: bool = False,
                      timeout: float = 10.0, inline: bool = False,
                      spin_sleep_us: float = 0.0,
                      deadline: Optional[float] = None):
    """The serializing baseline on the SAME CXL descriptor ring: encode,
    copy the blob through shared memory, full decode on the receiver,
    encode+decode the reply. Everything Fig. 11 shows RPCool avoiding,
    with the ring machinery held identical."""
    caller = conn.call_inline if inline else conn.call
    kw: Dict[str, Any] = {} if inline else \
        {"timeout": timeout, "spin_sleep_us": spin_sleep_us}
    if deadline is not None:
        kw["deadline_us"] = _deadline_word(deadline)
    payload = serial.encode(_args_to_plain(args))
    nbytes = _BLOB_HDR.size + len(payload)

    pid = conn.client_pid
    pooled = nbytes <= MARSHAL_SCOPE_PAGES * conn.heap.page_size
    if pooled:
        scope = _marshal_pool(conn).pop()
    else:
        scope = create_scope(conn.heap, nbytes, owner=pid)
    try:
        a = scope.alloc(nbytes)
        conn.heap.write(a, _BLOB_HDR.pack(len(payload)) + payload, pid=pid)
        ret = caller(fn_id, a, scope=scope, sealed=sealed,
                     sandboxed=sandboxed, flags_extra=F_TYPED | F_BYVAL,
                     **kw)
    finally:
        _pool_recycle(conn, scope, pooled)
    raw = _read_blob(conn.heap, ret, conn.heap.page_size)
    _recycle_reply(conn, ret)
    return serial.decode(raw)
