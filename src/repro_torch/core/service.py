"""Declarative service layer — named methods over the typed data plane.

What a programmer wants on top of channels and in-flight RPCs is a
service: named methods with options and a client proxy. This module is
that surface — a thin layer over ``conn.invoke`` / ``conn.invoke_stream``
that leaves the raw integer ``fn_id`` API intact underneath.

Server::

    @service(name="decode")
    class DecodeService:
        @method(fn_id=100, sealed=True, sandboxed=True, deadline=30.0)
        def attach(self, ctx, rid, prompt_len, pages): ...

    channel.serve(DecodeService(engine))      # registers every method

Client::

    stub = router.stub("/pod0/decode", DecodeService, pid=11)
    stub.attach(rid, n, pages)                # sync typed invoke
    for tok in stub.generate_stream.stream(prompt, 16): ...

Method *names* map to **stable fn ids**: a hash of ``service.method``
pinned into the upper half of the u32 fn space, so ids survive method
reordering and never collide with hand-wired small integers. Per-method
options: ``sealed``/``sandboxed`` (the §4.5/§4.4 protections),
``deadline`` (seconds of budget, propagated into the descriptor),
``streaming`` (a generator handler) and ``byref`` (pool-page reference
arguments resolved against the route). Dispatch runs through a small
interceptor chain (``intercept(call, proceed)``); ``DeadlineEnforcer``
and ``AdmissionInterceptor`` are the built-ins.
"""

from __future__ import annotations

import inspect
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

    __slots__ = ("name", "fn_id", "sealed", "sandboxed", "deadline",
                 "streaming", "byref")

    def __init__(self, name: str, fn_id: int, sealed: bool = False,
                 sandboxed: bool = False, deadline: Optional[float] = None,
                 streaming: bool = False, byref: bool = False):
        self.name = name
        self.fn_id = fn_id
        self.sealed = sealed
        self.sandboxed = sandboxed
        self.deadline = deadline
        self.streaming = streaming
        self.byref = byref


def method(fn=None, *, fn_id: Optional[int] = None, sealed: bool = False,
           sandboxed: bool = False, deadline: Optional[float] = None,
           streaming: bool = False, byref: bool = False):
    """Set a service method's per-method options. Usable bare
    (``@method``) or parameterized (``@method(sealed=True)``). Every
    public method of a ``@service`` class is exported either way;
    underscore-prefixed methods stay private helpers. ``streaming=True``
    declares a generator handler: clients consume it with
    ``stub.m.stream(...)`` (or drain it to a list with a plain call).
    ``byref=True`` declares pool-page reference arguments: at dispatch,
    any argument exposing ``__byref_resolve__(conn)`` (e.g.
    ``serving.kv_pool.PoolPages``) is resolved against the route —
    same-pod calls pass the raw page indices, cross-pod calls migrate the
    pages first and pass the destination indices."""
    def deco(f):
        f.__rpc_method__ = dict(fn_id=fn_id, sealed=sealed,
                                sandboxed=sandboxed, deadline=deadline,
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
        if not funcs:
            raise ChannelError(
                f"@service class {klass.__name__} exports no methods")
        methods = {}
        for nm, fn in funcs.items():
            opts = getattr(fn, "__rpc_method__", None) or {}
            fid = opts.get("fn_id")
            methods[nm] = MethodSpec(
                nm,
                fid if fid is not None else stable_fn_id(svc_name, nm),
                sealed=opts.get("sealed", False),
                sandboxed=opts.get("sandboxed", False),
                deadline=opts.get("deadline"),
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

    __slots__ = ("service", "spec", "args", "kwargs", "conn", "is_stream")

    def __init__(self, svc: str, spec: MethodSpec, args: Tuple,
                 kwargs: dict, conn, is_stream: bool = False):
        self.service = svc
        self.spec = spec
        self.args = args
        self.kwargs = kwargs
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
    an unmarshal or a handler. The gate caps concurrently admitted
    dispatches of the transport (``max_in_flight``; a stream stays
    admitted until its chunk chain ends). ``ServiceDef.serve`` wires it
    to the transport's pre-dispatch gate rather than the per-handler
    chain. Shed replies carry the suggested retry-after (µs) in the
    descriptor's ret word."""

    def __init__(self, max_in_flight: Optional[int] = None,
                 retry_after_s: float = 0.005):
        self.max_in_flight = max_in_flight
        self.retry_after_s = retry_after_s
        self.in_flight = 0
        self.n_admitted = 0
        self.n_shed_inflight = 0

    # -- the transport-facing gate (called before dispatch) --------------
    def admit(self, client_pid: int, fn_id: int) -> Optional[int]:
        """``None`` = admitted (the transport must ``release()`` when
        the dispatch — or the stream it started — completes); otherwise
        the suggested retry-after in µs and the request is shed."""
        if self.max_in_flight is not None and \
                self.in_flight >= self.max_in_flight:
            self.n_shed_inflight += 1
            return max(1, int(self.retry_after_s * 1e6))
        self.in_flight += 1
        self.n_admitted += 1
        return None

    def release(self) -> None:
        self.in_flight -= 1


# ---------------------------------------------------------------------------
# the client proxy
# ---------------------------------------------------------------------------
class StubMethod:
    """One method proxy: ``stub.get(k)`` is a sync typed invoke,
    ``stub.get.stream(k)`` the chunk iterator of a ``streaming=True``
    method. Per-call overrides: ``timeout``, ``deadline``, ``inline``,
    ``window`` (stream only)."""

    __slots__ = ("_conn", "_spec", "_run", "_svc")

    def __init__(self, conn, svc: str, spec: MethodSpec, interceptors):
        self._conn = conn
        self._spec = spec
        self._svc = svc
        self._run = _build_chain(interceptors, _client_final)

    def __call__(self, *args, **overrides):
        return self._run(ClientCall(self._svc, self._spec, args,
                                    overrides, self._conn))

    def stream(self, *args, **overrides):
        """Server-push streaming dispatch: returns the ``RpcStream``."""
        if not self._spec.streaming:
            raise ChannelError(
                f"{self._svc}.{self._spec.name} is not a streaming "
                "method (declare it with @method(streaming=True))")
        return self._run(ClientCall(self._svc, self._spec, args,
                                    overrides, self._conn, is_stream=True))


def _client_final(call: ClientCall):
    """The innermost client dispatch: method options → invoke kwargs →
    the route-appropriate typed entry point."""
    spec = call.spec
    conn = call.conn
    if spec.byref:
        # pool-page reference arguments resolve against the route the
        # connection actually took: pointer-pass in pod, one bulk
        # page migration (then destination indices) across pods
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
    if spec.streaming:
        stream = conn.invoke_stream(spec.fn_id, *call.args, **kw)
        if call.is_stream:
            return stream
        # a sync dispatch of a streaming method buffers the whole chain
        return list(stream)
    return conn.invoke(spec.fn_id, *call.args, **kw)


class ServiceStub:
    """Client proxy for a service over any connection type — a CXL
    ``Connection``, a ``FallbackConnection``, or a ``RoutedConnection``
    (same-pod or cross-pod, §5.6: identical surface). Method proxies are
    attributes; ``connection`` / ``close`` are the only reserved names."""

    def __init__(self, conn, sdef: ServiceDef, interceptors=()):
        icpts = tuple(interceptors)
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
