"""Declarative service layer — named methods over the typed data plane.

RPCool's client API (paper §5) is channels + in-flight RPCs; what a
*programmer* wants on top is a service: named methods with options, a
client proxy, futures. This module is that surface — a thin, fully
declarative layer over ``conn.invoke`` / ``conn.invoke_async`` that
leaves the raw integer ``fn_id`` API intact underneath as the documented
low-level escape hatch.

Server::

    @service
    class KV:
        def get(self, ctx, key):            # default options
            return self.store.get(key)

        @method(sealed=True, sandboxed=True, deadline=2.0)
        def put(self, ctx, key, val):
            self.store[key] = val

    channel.serve(KV())                     # registers every method

Client::

    stub = router.stub("/pod0/kv", KV, pid=7)   # or ServiceStub(conn, KV)
    stub.put("k", 1)                            # sync typed invoke
    f = stub.get.future("k")                    # pipelined RpcFuture
    gather([f, stub.get.future("j")])           # out-of-order drain

Method *names* map to **stable fn ids**: a hash of ``service.method``
pinned into the upper half of the u32 fn space, so ids survive method
reordering/insertion and never collide with hand-wired small integers.
Per-method options: ``sealed``/``sandboxed`` (the §4.5/§4.4 protections),
``byval`` (force copy semantics — the failover-retry-safe form),
``deadline`` (seconds of budget, propagated into the descriptor),
``retry`` (client retries across failover for retry-safe calls),
``streaming`` (a generator handler) and ``byref`` (pool-page reference
arguments resolved against the route).

Both stub dispatch and handler dispatch run through a small interceptor
chain (``intercept(call, proceed)``); ``StatsInterceptor``,
``DeadlineEnforcer``, ``AdmissionInterceptor`` and ``RetryInterceptor``
are the built-ins.
"""

from __future__ import annotations

import inspect
import random
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from .channel import _now_us
from .errors import ChannelError, DeadlineExceeded

# service fn ids live in [0x4000_0000, 0x7FFF_FFFF]: stable hashes that
# can never collide with hand-wired small integer fn ids (the escape
# hatch keeps the bottom of the space)
_FN_BASE = 0x4000_0000
_FN_MASK = 0x3FFF_FFFF


def stable_fn_id(service_name: str, method_name: str) -> int:
    """Deterministic fn id for ``service.method`` — stable across method
    reordering, insertion, and processes (it is a pure name hash)."""
    key = f"{service_name}.{method_name}".encode()
    return _FN_BASE | (zlib.crc32(key) & _FN_MASK)


class MethodSpec:
    """One method's wire identity + per-method options."""

    __slots__ = ("name", "fn_id", "sealed", "sandboxed", "byval",
                 "deadline", "retry", "streaming", "byref")

    def __init__(self, name: str, fn_id: int, sealed: bool = False,
                 sandboxed: bool = False, byval: bool = False,
                 deadline: Optional[float] = None, retry: int = 0,
                 streaming: bool = False, byref: bool = False):
        self.name = name
        self.fn_id = fn_id
        self.sealed = sealed
        self.sandboxed = sandboxed
        self.byval = byval
        self.deadline = deadline
        self.retry = retry
        self.streaming = streaming
        self.byref = byref

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<MethodSpec {self.name} fn_id=0x{self.fn_id:08x} "
                f"sealed={self.sealed} sandboxed={self.sandboxed} "
                f"byval={self.byval} deadline={self.deadline} "
                f"retry={self.retry} streaming={self.streaming} "
                f"byref={self.byref}>")


def method(fn=None, *, fn_id: Optional[int] = None, sealed: bool = False,
           sandboxed: bool = False, byval: bool = False,
           deadline: Optional[float] = None, retry: int = 0,
           streaming: bool = False, byref: bool = False):
    """Set a service method's per-method options. Usable bare
    (``@method``) or parameterized (``@method(sealed=True)``). Every
    public method of a ``@service`` class is exported either way —
    undecorated methods get the defaults; underscore-prefixed methods
    stay private helpers. ``streaming=True`` declares a generator
    handler: clients consume it with ``stub.m.stream(...)`` (or drain it
    to a list with a plain sync call). ``byref=True`` declares pool-page
    reference arguments: at dispatch, any argument exposing
    ``__byref_resolve__(conn)`` (e.g. ``serving.kv_pool.PoolPages``) is
    resolved against the route — same-pod calls pass the raw page
    indices, cross-pod calls bulk-migrate the pages first and pass the
    destination indices."""
    def deco(f):
        f.__rpc_method__ = dict(fn_id=fn_id, sealed=sealed,
                                sandboxed=sandboxed, byval=byval,
                                deadline=deadline, retry=retry,
                                streaming=streaming, byref=byref)
        return f
    return deco(fn) if fn is not None else deco


class ServiceDef:
    """A named bundle of MethodSpecs — what ``@service`` attaches to the
    class, what ``Channel.serve`` registers, what a stub proxies."""

    def __init__(self, name: str, methods: Dict[str, MethodSpec]):
        self.name = name
        self.methods = methods
        by_id: Dict[int, str] = {}
        for spec in methods.values():
            other = by_id.get(spec.fn_id)
            if other is not None:
                raise ChannelError(
                    f"service {name!r}: methods {other!r} and "
                    f"{spec.name!r} collide on fn_id 0x{spec.fn_id:08x} "
                    "— pin one with @method(fn_id=...)")
            by_id[spec.fn_id] = spec.name

    # -- server half -----------------------------------------------------
    def serve(self, channel, instance, interceptors=()) -> None:
        """Register every method as a typed handler on ``channel`` (a
        ``Channel`` or a ``FallbackConnection`` — anything with
        ``add_typed``), dispatching through the server interceptor
        chain. An ``AdmissionInterceptor`` in the list is wired to the
        transport's pre-dispatch gate instead of the per-handler chain:
        shedding must cost one descriptor word, never an unmarshal or a
        handler (§5.4)."""
        chain = []
        for icpt in interceptors:
            if isinstance(icpt, AdmissionInterceptor):
                channel.admission = icpt
            else:
                chain.append(icpt)
        chain = tuple(chain)
        for spec in self.methods.values():
            channel.add_typed(spec.fn_id,
                              self._make_handler(instance, spec, chain))

    def _make_handler(self, instance, spec: MethodSpec, interceptors):
        bound = getattr(instance, spec.name)
        svc = self.name

        def final(call: "ServerCall"):
            return bound(call.ctx, *call.args)

        run = _build_chain(interceptors, final)

        def handler(ctx, view):
            # unpack the top-level tuple only: scalars unwrap, nested
            # containers stay lazy ArgViews — handlers keep the
            # touch-only-what-you-dereference property
            args = [view[i] for i in range(len(view))]
            return run(ServerCall(svc, spec, ctx, args))

        handler.__name__ = f"{svc}.{spec.name}"
        return handler

    # -- client half -----------------------------------------------------
    def stub(self, conn, interceptors=()) -> "ServiceStub":
        return ServiceStub(conn, self, interceptors)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<ServiceDef {self.name} methods={sorted(self.methods)}>"


def service(cls=None, *, name: Optional[str] = None):
    """Class decorator: derive a ``ServiceDef`` from the class's methods
    and attach it as ``cls.__service_def__``."""
    def deco(klass):
        svc_name = name or klass.__name__
        # definition order, subclasses overriding base methods
        funcs: Dict[str, Callable] = {}
        for k in reversed(klass.__mro__[:-1]):   # skip object
            for nm, fn in vars(k).items():
                if inspect.isfunction(fn) and not nm.startswith("_"):
                    funcs[nm] = fn
        exported = funcs
        if not exported:
            raise ChannelError(
                f"@service class {klass.__name__} exports no methods")
        methods = {}
        for nm, fn in exported.items():
            opts = getattr(fn, "__rpc_method__", None) or {}
            fid = opts.get("fn_id")
            methods[nm] = MethodSpec(
                nm,
                fid if fid is not None else stable_fn_id(svc_name, nm),
                sealed=opts.get("sealed", False),
                sandboxed=opts.get("sandboxed", False),
                byval=opts.get("byval", False),
                deadline=opts.get("deadline"),
                retry=opts.get("retry", 0),
                streaming=opts.get("streaming", False),
                byref=opts.get("byref", False))
        klass.__service_def__ = ServiceDef(svc_name, methods)
        return klass
    return deco(cls) if cls is not None else deco


def service_def(obj) -> ServiceDef:
    """Resolve anything service-shaped — a ``ServiceDef``, a ``@service``
    class, or an instance of one — to its ``ServiceDef``."""
    if isinstance(obj, ServiceDef):
        return obj
    sdef = getattr(obj, "__service_def__", None)
    if sdef is None:
        raise ChannelError(
            f"{obj!r} is not a service (decorate the class with @service "
            "or pass a ServiceDef)")
    return sdef


# ---------------------------------------------------------------------------
# the interceptor chain (shared client/server machinery)
# ---------------------------------------------------------------------------
class ClientCall:
    """What a client interceptor sees for one stub dispatch."""

    __slots__ = ("service", "spec", "args", "kwargs", "is_future", "conn",
                 "is_stream")

    def __init__(self, svc: str, spec: MethodSpec, args: Tuple,
                 kwargs: dict, is_future: bool, conn,
                 is_stream: bool = False):
        self.service = svc
        self.spec = spec
        self.args = args
        self.kwargs = kwargs
        self.is_future = is_future
        self.conn = conn
        self.is_stream = is_stream

    @property
    def method(self) -> str:
        return self.spec.name


class ServerCall:
    """What a server interceptor sees for one handler dispatch."""

    __slots__ = ("service", "spec", "ctx", "args")

    def __init__(self, svc: str, spec: MethodSpec, ctx, args: List):
        self.service = svc
        self.spec = spec
        self.ctx = ctx
        self.args = args

    @property
    def method(self) -> str:
        return self.spec.name


def _build_chain(interceptors, final):
    """Fold ``interceptors`` around ``final`` once, at registration —
    dispatch walks plain closures, no per-call list handling."""
    run = final
    for icpt in reversed(tuple(interceptors)):
        def run(call, _icpt=icpt, _next=run):
            return _icpt.intercept(call, lambda: _next(call))
    return run


class Interceptor:
    """Base/no-op interceptor: override ``intercept`` and either return
    ``proceed()`` (continue the chain) or short-circuit/raise."""

    def intercept(self, call, proceed):
        return proceed()


class StatsInterceptor(Interceptor):
    """Per-method call/error/latency accounting; usable on either side
    of the wire (hook the same instance into stub and serve to compare
    client-observed vs server-side time)."""

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self.errors: Dict[str, int] = {}
        self.total_us: Dict[str, float] = {}
        # live dispatch gauge (drops back on return/raise) — the same
        # in-flight signal the replica balancer keeps per replica
        self.inflight: Dict[str, int] = {}

    def intercept(self, call, proceed):
        key = f"{call.service}.{call.method}"
        t0 = time.perf_counter()
        self.inflight[key] = self.inflight.get(key, 0) + 1
        try:
            return proceed()
        except BaseException:
            self.errors[key] = self.errors.get(key, 0) + 1
            raise
        finally:
            self.inflight[key] -= 1
            self.calls[key] = self.calls.get(key, 0) + 1
            self.total_us[key] = self.total_us.get(key, 0.0) \
                + (time.perf_counter() - t0) * 1e6

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": n, "errors": self.errors.get(k, 0),
                    "mean_us": self.total_us.get(k, 0.0) / n}
                for k, n in self.calls.items()}


class DeadlineEnforcer(Interceptor):
    """Server-side deadline enforcement: refuse to start a handler whose
    descriptor-propagated deadline already lapsed (the ring layer also
    pre-gates this before dispatch; the interceptor re-checks after any
    earlier interceptors spent time). Raising ``DeadlineExceeded`` maps
    to the dedicated E_DEADLINE reply status."""

    def intercept(self, call, proceed):
        dl = getattr(call.ctx, "deadline_us", 0)
        if dl and _now_us() > dl:
            raise DeadlineExceeded(
                f"{call.service}.{call.method}: deadline lapsed before "
                "dispatch")
        return proceed()


class AdmissionInterceptor(Interceptor):
    """Server-side admission control (§5.4): shed load with E_OVERLOAD
    *before* dispatch — a shed request costs one descriptor word, never
    an unmarshal or a handler. Two gates:

    * ``max_in_flight`` caps concurrently admitted dispatches of the
      transport (a stream stays admitted until its chunk chain ends).
    * per-client-pid request quotas from the orchestrator's §5.4 table
      (``orch.set_request_quota(pid, per_second)``), enforced as a token
      bucket ``burst`` seconds of rate deep, on the orchestrator's
      injected clock.

    ``ServiceDef.serve`` wires it to the transport's pre-dispatch gate
    rather than the per-handler chain. Shed replies carry the suggested
    retry-after (µs) in the descriptor's ret word: the bucket's time to
    one token for quota sheds, ``retry_after_s`` for in-flight sheds."""

    def __init__(self, max_in_flight: Optional[int] = None,
                 orch=None, retry_after_s: float = 0.005,
                 burst: float = 1.0):
        self.max_in_flight = max_in_flight
        self.orch = orch
        self.retry_after_s = retry_after_s
        self.burst = burst            # bucket depth, in seconds of rate
        self.in_flight = 0
        self._buckets: Dict[int, List[float]] = {}  # pid -> [tokens, t]
        self.n_admitted = 0
        self.n_shed_inflight = 0
        self.n_shed_quota = 0

    # -- the transport-facing gate (called before dispatch) --------------
    def admit(self, client_pid: int, fn_id: int) -> Optional[int]:
        """``None`` = admitted (the transport must ``release()`` when
        the dispatch — or the stream it started — completes); otherwise
        the suggested retry-after in µs and the request is shed."""
        if self.max_in_flight is not None and \
                self.in_flight >= self.max_in_flight:
            self.n_shed_inflight += 1
            return max(1, int(self.retry_after_s * 1e6))
        orch = self.orch
        if orch is not None:
            rate = orch.request_quota(client_pid)
            if rate is not None:
                now = orch.clock()
                cap = rate * self.burst
                bucket = self._buckets.get(client_pid)
                if bucket is None:
                    bucket = self._buckets[client_pid] = [cap, now]
                tokens = min(cap, bucket[0] + (now - bucket[1]) * rate)
                if tokens < 1.0:
                    bucket[0], bucket[1] = tokens, now
                    self.n_shed_quota += 1
                    if rate > 0:
                        return max(1, int((1.0 - tokens) / rate * 1e6))
                    return max(1, int(self.retry_after_s * 1e6))
                bucket[0], bucket[1] = tokens - 1.0, now
        self.in_flight += 1
        self.n_admitted += 1
        return None

    def release(self) -> None:
        self.in_flight -= 1


class RetryInterceptor(Interceptor):
    """Client-side retry with capped jittered exponential backoff.

    Re-runs a *retry-safe* sync dispatch on ``ChannelError`` up to the
    method's ``retry`` budget (or this interceptor's default when the
    method sets none). Retry-safe means nothing in the request pins a
    heap: ``byval`` methods always, other methods only when no argument
    is a ``GraphRef``. An ``Overloaded`` failure honors the suggested
    retry-after as a floor on the next pause (§5.4); other channel
    errors follow the exponential schedule.

    Three things never retry: ``DeadlineExceeded`` (the budget is
    gone), a streaming dispatch that already yielded chunks (delivered
    chunks cannot be un-delivered — ``_client_final`` annotates the
    failure with ``chunks_delivered``), and any attempt whose pause
    would overshoot the method deadline's worth of wall time. Futures
    and stream iterators pass through: a routed future already
    re-invokes across failover on settlement."""

    def __init__(self, default_retries: int = 0,
                 backoff_base_s: float = 0.001,
                 backoff_cap_s: float = 0.25,
                 backoff_multiplier: float = 2.0,
                 jitter: float = 0.5,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.default_retries = default_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_multiplier = backoff_multiplier
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._sleep = sleep

    def intercept(self, call, proceed):
        retries = call.spec.retry or self.default_retries
        if call.is_future or call.is_stream or retries <= 0 or \
                not _retry_safe(call):
            # stream iterators pass through: delivered chunks cannot be
            # un-delivered, so a failed stream is the caller's restart
            return proceed()
        budget = call.kwargs.get("deadline", call.spec.deadline)
        give_up = None if budget is None \
            else time.monotonic() + budget
        delay = self.backoff_base_s
        for attempt in range(retries + 1):
            try:
                return proceed()
            except DeadlineExceeded:
                raise
            except ChannelError as e:
                if attempt == retries:
                    raise
                if getattr(e, "chunks_delivered", 0):
                    # a buffered streaming dispatch failed after
                    # yielding: a replay would duplicate the prefix
                    raise
                pause = min(
                    delay * (1.0 + self.jitter * self._rng.random()),
                    self.backoff_cap_s)
                retry_after = getattr(e, "retry_after_s", 0.0)
                if retry_after:
                    pause = max(pause, retry_after)
                if give_up is not None and \
                        time.monotonic() + pause >= give_up:
                    # the method deadline's wall budget is spent: a
                    # retry could not complete inside it
                    raise
                self._sleep(pause)
                delay = min(delay * self.backoff_multiplier,
                            self.backoff_cap_s)


def _retry_safe(call: ClientCall) -> bool:
    if call.spec.byval:
        return True
    from .marshal import GraphRef
    return not any(isinstance(a, GraphRef) for a in call.args)


# ---------------------------------------------------------------------------
# the client proxy
# ---------------------------------------------------------------------------
class StubMethod:
    """One method proxy: ``stub.get(k)`` is a sync typed invoke,
    ``stub.get.future(k)`` a pipelined one, ``stub.get.stream(k)`` the
    chunk iterator of a ``streaming=True`` method. Per-call overrides:
    ``timeout``, ``deadline``, ``inline`` (sync/stream), ``window``
    (stream only)."""

    __slots__ = ("_conn", "_spec", "_run", "_svc", "spec")

    def __init__(self, conn, svc: str, spec: MethodSpec, interceptors):
        self._conn = conn
        self._spec = spec
        self.spec = spec   # public: introspection / tests
        self._svc = svc
        self._run = _build_chain(interceptors, _client_final)

    def __call__(self, *args, **overrides):
        return self._run(ClientCall(self._svc, self._spec, args,
                                    overrides, False, self._conn))

    def future(self, *args, **overrides):
        if self._spec.streaming:
            raise ChannelError(
                f"{self._svc}.{self._spec.name} is streaming — consume "
                "it with .stream(...) (or a sync call to buffer it)")
        overrides.pop("inline", None)   # futures never run inline
        return self._run(ClientCall(self._svc, self._spec, args,
                                    overrides, True, self._conn))

    def stream(self, *args, **overrides):
        """Server-push streaming dispatch: returns the route-appropriate
        ``RpcStream`` / ``FallbackRpcStream`` / ``RoutedRpcStream``."""
        if not self._spec.streaming:
            raise ChannelError(
                f"{self._svc}.{self._spec.name} is not a streaming "
                "method (declare it with @method(streaming=True))")
        return self._run(ClientCall(self._svc, self._spec, args,
                                    overrides, False, self._conn,
                                    is_stream=True))


def _client_final(call: ClientCall):
    """The innermost client dispatch: method options → invoke kwargs →
    the route-appropriate typed entry point."""
    spec = call.spec
    conn = call.conn
    if spec.byref:
        # pool-page reference arguments resolve against the route the
        # connection actually took: pointer-pass in pod, one bulk
        # scope_copy migration (then destination indices) across pods.
        # Resolution happens per dispatch, so a retry after a failover
        # re-resolves against the replica's pod.
        call.args = tuple(
            a.__byref_resolve__(conn)
            if hasattr(a, "__byref_resolve__") else a
            for a in call.args)
    kw = dict(call.kwargs)
    if spec.sealed:
        kw.setdefault("sealed", True)
    if spec.sandboxed:
        kw.setdefault("sandboxed", True)
    if spec.deadline is not None:
        kw.setdefault("deadline", spec.deadline)
    if call.is_stream or (spec.streaming and not call.is_future):
        args = call.args
        if spec.byval:
            from .marshal import _args_to_plain
            args = tuple(_args_to_plain(args))
        stream = conn.invoke_stream(spec.fn_id, *args, **kw)
        if call.is_stream:
            return stream
        # sync dispatch of a streaming method buffers the whole chain —
        # the baseline arm of the TTFT comparison, and a convenience.
        # A mid-chain failure is annotated with the delivered-chunk
        # count: retry layers must never replay a partial stream.
        out = []
        try:
            for v in stream:
                out.append(v)
        except ChannelError as e:
            if out:
                e.chunks_delivered = len(out)
            raise
        return out
    if call.is_future:
        args = call.args
        if spec.byval:
            # byval's contract is copy semantics — nothing in the request
            # may pin a heap. Futures honor it by snapshotting GraphRef
            # args to plain values at dispatch, which also keeps the
            # routed future failover-retryable.
            from .marshal import _args_to_plain
            args = tuple(_args_to_plain(args))
        return conn.invoke_async(spec.fn_id, *args, **kw)
    if spec.byval:
        serialized = getattr(conn, "invoke_serialized", None)
        if serialized is not None:
            return serialized(spec.fn_id, *call.args, **kw)
        # a bare FallbackConnection is by-value natively
    return conn.invoke(spec.fn_id, *call.args, **kw)


class ServiceStub:
    """Client proxy for a service over ANY connection type — plain CXL
    ``Connection``, ``FallbackConnection``, or a ``RoutedConnection``
    (same-pod/cross-pod/failover, §5.6: identical surface). Method
    proxies are attributes; ``connection`` / ``close`` are the only
    reserved names."""

    def __init__(self, conn, sdef: ServiceDef, interceptors=()):
        icpts = tuple(interceptors)
        if not any(isinstance(i, RetryInterceptor) for i in icpts):
            # method-level `retry=` works out of the box; an explicit
            # RetryInterceptor in `interceptors` takes over the policy
            icpts = icpts + (RetryInterceptor(),)
        self._conn = conn
        self._def = sdef
        self._methods = {
            nm: StubMethod(conn, sdef.name, spec, icpts)
            for nm, spec in sdef.methods.items()
        }

    def __getattr__(self, name: str) -> StubMethod:
        try:
            return self.__dict__["_methods"][name]
        except KeyError:
            raise AttributeError(
                f"service {self._def.name!r} has no method {name!r}")

    @property
    def connection(self):
        """The underlying connection — the raw escape hatch."""
        return self._conn

    @property
    def definition(self) -> ServiceDef:
        return self._def

    def close(self) -> None:
        self._conn.close()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<ServiceStub {self._def.name} over "
                f"{type(self._conn).__name__}>")
