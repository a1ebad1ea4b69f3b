"""The port's RPC plane (``repro_torch.core``) against the reference's
(``repro.core``): addresses, heap byte I/O, scopes, seals, sandboxes,
container graphs, the serial wire format, typed invokes and streams on
the ring, the router's transport choice, and the fallback link's
accounting. Behaviour tests run on both packages (``pkg``); where the
result is a value (an address, heap bytes, wire bytes, a counter) the
port's must equal the reference's. Scenarios follow tests/test_core_rpc.py,
tests/test_marshal_roundtrip.py, tests/test_streaming.py,
tests/test_cluster_router.py and tests/test_fallback_transport.py."""

import random
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import channel as R_channel  # noqa: E402
from repro.core import fallback as R_fallback  # noqa: E402
from repro.core import marshal as R_marshal  # noqa: E402
from repro_torch.core import channel as T_channel  # noqa: E402
from repro_torch.core import fallback as T_fallback  # noqa: E402
from repro_torch.core import marshal as T_marshal  # noqa: E402

PKGS = {
    "ref": SimpleNamespace(core=R, addr=R.addr, C=R.containers, serial=R.serial,
                           channel=R_channel, fallback=R_fallback,
                           marshal=R_marshal),
    "port": SimpleNamespace(core=T, addr=T.addr, C=T.containers, serial=T.serial,
                            channel=T_channel, fallback=T_fallback,
                            marshal=T_marshal),
}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])

# nested values the handoff and the tests pass: scalars, strings, bytes,
# maps, and vectors of page ids (the block table is one)
VALUES = [
    None, 0, -1, 2**63 - 1, -(2**63), 3.5, -0.0, "", "κλειδί", "a" * 300,
    b"\x00\xff" * 9, [3, 9, 17, 40], [[1, 2], [3], []],
    (11, 471, [5, 6, 7, 8, 9, 10, 11, 12]),
    {"rid": 7, "pages": [4, 5, 6], "meta": {"n": 2.5, "tag": "x"}},
    [{"k": [None, "v"]}, {}, [[[]]]],
]


def _random_value(rng: random.Random, depth: int = 0):
    r = rng.random()
    if depth >= 3 or r < 0.45:
        return rng.choice([None, 0, 7, -(2**40), 1.5e300, "tok", "", b"raw"])
    if r < 0.7:
        return [_random_value(rng, depth + 1) for _ in range(rng.randrange(0, 6))]
    return {f"k{rng.randrange(100)}_{i}": _random_value(rng, depth + 1)
            for i in range(rng.randrange(0, 6))}


# ---------------------------------------------------------------------------
# addr
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("heap_id,page,offset,step,psize", [
    (3, 17, 123, 0, 4096), (1, 0, 4000, 200, 4096), (7, 2, 255, 1, 256),
    (65534, (1 << 24) - 2, 10, 300, 4096), (9, 5, 0, 1 << 20, 4096)])
def test_addr_arithmetic_matches_reference(heap_id, page, offset, step, psize):
    got, want = [], []
    for ga, out in ((T.addr, got), (R.addr, want)):
        a = ga.pack(heap_id, page, offset)
        b = ga.add(a, step, page_size=psize)
        out += [a, b, tuple(ga.unpack(b)), ga.linear(b, psize), ga.heap_of(b),
                ga.page_of(b), ga.offset_of(b), ga.is_null(ga.NULL)]
    assert got == want


@BOTH
def test_addr_range_checks(pkg):
    ga = PKGS[pkg].addr
    for args in ((ga.MAX_HEAPS, 0, 0), (0, ga.MAX_PAGES, 0), (0, 0, ga.MAX_OFFSET)):
        with pytest.raises(ValueError):
            ga.pack(*args)
    with pytest.raises(ValueError):
        ga.unpack(ga.NULL)
    with pytest.raises(ValueError):
        ga.add(ga.pack(1, ga.MAX_PAGES - 1, 0), 8192, page_size=4096)


# ---------------------------------------------------------------------------
# heap byte I/O, scope, seal
# ---------------------------------------------------------------------------
@BOTH
def test_heap_write_read_and_checks(pkg):
    core, ga = PKGS[pkg].core, PKGS[pkg].addr
    h = core.SharedHeap(5, 16)
    p = h.alloc_pages(2, owner=7)
    a = h.addr_of_page(p, 4090)            # crosses into the next page
    h.write(a, b"hello world")
    assert bytes(h.read(a, 11)) == b"hello world"
    h.write_fast(h.addr_of_page(p, 0), np.arange(4, dtype=np.uint32))
    assert h.read(h.addr_of_page(p), 16).view(np.uint32).tolist() == [0, 1, 2, 3]
    with pytest.raises(core.InvalidPointer):
        h.read(ga.pack(6, 0, 0), 4)        # another heap's pointer
    with pytest.raises(core.InvalidPointer):
        h.read(h.addr_of_page(15, 4000), 200)   # past the end
    h.protect_range(p, 2, holder=7)
    with pytest.raises(core.SealedPageError):
        h.write(a, b"x", pid=7)            # the sealing sender
    h.write(a, b"x", pid=9)                # the receiver may still write
    h.unprotect_range(p, 2)
    h.write(a, b"y", pid=7)
    h.free_extent(p, 2)
    with pytest.raises(core.InvalidPointer):
        h.read(a, 4)                       # freed page


def test_heap_bytes_scope_and_seal_descriptors_match_reference():
    """The same allocations, writes, scopes and seals leave byte-identical
    heaps (descriptor ring included) and equal addresses and seal idxs."""
    out = {}
    for name in ("ref", "port"):
        core = PKGS[name].core
        h = core.SharedHeap(2, 64, page_size=256)
        sm = core.SealManager(h, capacity=16, batch_threshold=3)
        s1 = core.create_scope(h, 600, owner=1)
        addrs = [s1.alloc(100), s1.alloc(3), s1.write_bytes(b"payload", pid=1)]
        with pytest.raises(core.AllocationError):
            s1.alloc(1000)
        s2 = core.create_scope(h, 256, owner=1)
        idxs = []
        for sc in (s1, s2, s1):
            i = sm.seal(sc, holder=1)
            assert sm.is_sealed(i, sc)
            sm.mark_complete(i)
            idxs.append((i, sm.release_batched(i, holder=1)))
        assert not sm.is_sealed(idxs[0][0])
        i = sm.seal(s2, holder=1)          # a fresh seal after the flush
        assert not sm.is_sealed(i, s1)     # a seal over s2 does not cover s1
        idxs.append((i, sm.state_of(i), sm.pending_releases(), sm.flush_gen))
        s1.destroy()
        out[name] = (addrs, idxs, h.stats(), h.buf.tobytes(), h.perm.tolist())
    assert out["port"] == out["ref"]


@BOTH
def test_seal_protocol_rejections(pkg):
    core = PKGS[pkg].core
    h = core.SharedHeap(1, 256)
    sm = core.SealManager(h, capacity=64, batch_threshold=4)
    s = core.create_scope(h, 2 * h.page_size, owner=1)
    idx = sm.seal(s, holder=1)
    with pytest.raises(core.SealViolation):
        sm.release(idx, holder=1)          # Fig. 8 step 8: not complete
    sm.mark_complete(idx)
    with pytest.raises(core.SealViolation):
        sm.release(idx, holder=2)          # wrong holder
    sm.release(idx, holder=1)
    with pytest.raises(core.SealViolation):
        sm.release(idx, holder=1)          # double release


@BOTH
def test_scope_pool_quarantines_sealed_scopes(pkg):
    core = PKGS[pkg].core
    h = core.SharedHeap(1, 64)
    sm = core.SealManager(h, capacity=64, batch_threshold=100)
    pool = core.ScopePool(h, 1, seals=sm)
    s = pool.pop()
    i = sm.seal(s, holder=1)
    sm.mark_complete(i)
    sm.release_batched(i, holder=1)
    pool.push_sealed(s, i)
    assert pool.pop() is not s             # still write-protected
    sm.flush()
    assert pool.pop() is s                 # released by the flush
    pool.drain()


# ---------------------------------------------------------------------------
# sandbox
# ---------------------------------------------------------------------------
@BOTH
def test_sandbox_confines_and_recycles_keys(pkg):
    core, ga = PKGS[pkg].core, PKGS[pkg].addr
    h = core.SharedHeap(1, 256)
    sm = core.SandboxManager(h)
    p = h.alloc_pages(2)
    a = h.addr_of_page(p)
    h.write(a, b"data")
    with sm.enter(p, 2) as sb:
        assert bytes(sb.read(a, 4)) == b"data"
        assert sm.in_sandbox()
        with pytest.raises(core.SandboxViolation):
            sb.read(h.addr_of_page(p + 2), 1)      # one page past
        with pytest.raises(core.SandboxViolation):
            sb.read(ga.pack(9, 0, 0), 1)           # wild pointer
        with pytest.raises(core.SandboxViolation):
            sm.check_private_access()
    assert not sm.in_sandbox()
    with sm.enter(p, 2):
        pass
    assert (sm.cache_hits, sm.cache_misses) == (1, 1)
    ranges = [(h.alloc_pages(1), 1) for _ in range(20)]
    for r in ranges:                               # 20 > 14 cached keys
        with sm.enter(*r):
            pass
    for r in ranges[-14:]:                         # the 14 newest: cached
        with sm.enter(*r):
            pass
    assert (sm.cache_hits, sm.cache_misses) == (15, 21)
    with sm.enter(*ranges[0]):                     # evicted: a miss
        pass
    assert sm.cache_misses == 22
    held = [sm.enter(*r) for r in ranges[:14]]
    for sb in held:
        sb.__enter__()
    with pytest.raises(core.SandboxViolation, match="14"):
        sm.enter(*ranges[15])                      # every key active
    for sb in held:
        sb.__exit__(None, None, None)


def test_sandbox_key_table_matches_reference():
    out = {}
    for name in ("ref", "port"):
        core = PKGS[name].core
        h = core.SharedHeap(1, 128)
        sm = core.SandboxManager(h)
        ranges = [(h.alloc_pages(2), 2) for _ in range(18)]
        hits = []
        for r in ranges + ranges[3:6] + ranges[:2] + ranges[-3:]:
            with sm.enter(*r) as sb:
                hits.append(sb.cached_hit)
        h.free_extent(*ranges[4])
        out[name] = (h.key.tolist(), hits, sm.cache_misses, h.perm_epoch)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# containers and the serial wire format
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__)
def test_container_graph_bytes_match_reference(value):
    """The same Python value built into the same scope: the same Value
    word, the same bytes at the same offsets, and both read back."""
    out = {}
    for name in ("ref", "port"):
        core, C = PKGS[name].core, PKGS[name].C
        h = core.SharedHeap(3, 64)
        s = core.create_scope(h, 8 * 4096)
        s.alloc(24)                        # an odd start offset
        v = C.build_value(s, value)
        vec = C.build_vec(s, [v, C.build_value(s, 5)])
        out[name] = (v, vec, s.used_bytes(), h.buf.tobytes(), C.to_python(h, v))
    assert out["port"] == out["ref"]
    assert out["port"][4] == PKGS["ref"].serial.decode(PKGS["ref"].serial.encode(value))


@BOTH
def test_container_readers_check_tags_and_bounds(pkg):
    core, C, ga = PKGS[pkg].core, PKGS[pkg].C, PKGS[pkg].addr
    h = core.SharedHeap(1, 64)
    s = core.create_scope(h, 4 * 4096)
    tag, root = C.build_value(s, {"a": {"b": [1, 2, 41]}, "d": "no"})
    assert tag == C.T_MAP
    assert C.to_python(h, C.map_get(h, root, "a")) == {"b": [1, 2, 41]}
    assert C.map_get(h, root, "zz") is None
    with pytest.raises(core.InvalidPointer):
        C.read_str(h, root)                # a map node read as a string
    reader = C.FastReader(h, s.start_page, s.num_pages)
    assert C.to_python(reader, (C.T_MAP, root))["d"] == "no"
    with pytest.raises(core.InvalidPointer):
        reader.read(ga.pack(2, 0, 0), 8)   # another heap: SIGSEGV analogue


def test_serial_bytes_match_reference():
    rng = random.Random(0xC001)
    for value in VALUES + [_random_value(rng) for _ in range(100)]:
        raw = T.serial.encode(value)
        assert raw == R.serial.encode(value)
        assert T.serial.decode(raw) == R.serial.decode(raw)
    assert T.serial.decode(T.serial.encode([True, False])) == [1, 0]
    with pytest.raises(TypeError):
        T.serial.encode({1j})


# ---------------------------------------------------------------------------
# typed invokes and streams on the ring
# ---------------------------------------------------------------------------
def _svc(core):
    @core.service(name="svc")
    class Svc:
        @core.method(fn_id=9)
        def echo(self, ctx, v):
            return v.to_python() if isinstance(v, PKGS_ARGVIEW) else v

        @core.method(fn_id=10, sealed=True, sandboxed=True, deadline=5.0)
        def attach(self, ctx, rid, n, pages):
            return [int(rid), int(n), pages.to_python()]

        @core.method(fn_id=11)
        def shed(self, ctx, ms):
            raise core.Overloaded("full", retry_after_s=ms / 1e3)

        @core.method(streaming=True)
        def count(self, ctx, n):
            for i in range(n):
                yield {"i": i, "tok": "t%d" % i}

        @core.method(streaming=True)
        def explode(self, ctx, n):
            yield from range(n)
            raise RuntimeError("boom")

    return Svc


PKGS_ARGVIEW = (R.marshal.ArgView, T.marshal.ArgView)


def _open(pkg, pages=256):
    core = PKGS[pkg].core
    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=1).open("/pod0/svc", heap_pages=pages)
    Svc = _svc(core)
    ch.serve(Svc())
    router = core.ClusterRouter(orch)
    router.register("/pod0/svc", ch, pod="pod0")
    return orch, ch, router, Svc


def test_typed_invokes_match_reference_bytes():
    """Pointer-passing invokes of the same values: equal replies, equal
    ``marshal_bytes``, and byte-identical channel heaps (ring slots,
    argument scopes, reply graphs, seal descriptors)."""
    rng = random.Random(7)
    values = VALUES + [_random_value(rng) for _ in range(20)]
    out = {}
    for name in ("ref", "port"):
        _, ch, router, Svc = _open(name)
        stub = router.stub("/pod0/svc", Svc, pid=2, pod="pod0")
        conn = stub.connection
        replies, sizes = [], []
        for v in values:
            b0 = conn.marshal_bytes
            replies.append(stub.echo(v, inline=True))
            sizes.append(conn.marshal_bytes - b0)
        b0 = conn.marshal_bytes
        replies.append(stub.attach(7, 471, [3, 9, 17, 40], inline=True))
        sizes.append(conn.marshal_bytes - b0)
        out[name] = (replies, sizes, conn.target.n_invokes, conn.heap.stats(),
                     conn.heap.buf.tobytes())
    assert out["port"][:4] == out["ref"][:4]
    assert out["port"][4] == out["ref"][4]
    norm = [R.serial.decode(R.serial.encode(v)) for v in values]
    assert out["port"][0][:-1] == norm
    # (rid, n, 4 page ids): a 3-value vec (56 B) + a 4-value vec (72 B)
    assert out["port"][1][-1] == 128


@BOTH
def test_ring_errors_are_typed(pkg):
    core, chan = PKGS[pkg].core, PKGS[pkg].channel
    orch, ch, router, Svc = _open(pkg)
    conn = core.RPC(orch, pid=2).connect("/pod0/svc")   # the raw Fig. 6 API
    with pytest.raises(core.RpcError) as e:
        conn.call_inline(99)
    assert e.value.status == chan.E_NOFUNC
    ch.add(5, lambda ctx, a: 1 // 0)
    with pytest.raises(core.RpcError) as e:
        conn.call_inline(5)
    assert e.value.status == chan.E_EXCEPTION
    sc = conn.create_scope(4096)
    arg = PKGS[pkg].C.build_value(sc, {"next": 1})[1]

    def evil(ctx, a):                      # chase a pointer to another heap
        PKGS[pkg].C.read_str(ctx, PKGS[pkg].addr.pack(50, 0, 0))

    ch.add(6, evil)
    with pytest.raises(core.RpcError) as e:
        conn.call_inline(6, arg, scope=sc, sandboxed=True)
    assert e.value.status == chan.E_SANDBOX
    with pytest.raises(core.DeadlineExceeded):
        conn.invoke(9, 1, inline=True, deadline=-1.0)   # pre-lapsed


@BOTH
def test_deadline_enforcer_refuses_a_lapsed_dispatch(pkg):
    """A deadline that lapses between the ring's gate and the handler
    (here inside an earlier interceptor) comes back as DeadlineExceeded."""
    core = PKGS[pkg].core
    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=1).open("/pod0/svc")

    class Slow(core.Interceptor):
        def intercept(self, call, proceed):
            time.sleep(0.02)
            return proceed()

    ch.serve(_svc(core)(), interceptors=[Slow(), core.DeadlineEnforcer()])
    conn = core.RPC(orch, pid=2).connect("/pod0/svc")
    assert conn.invoke(9, 4, inline=True, deadline=5.0) == 4
    with pytest.raises(core.DeadlineExceeded):
        conn.invoke(9, 4, inline=True, deadline=0.01)


def test_overloaded_crosses_the_wire_with_retry_after():
    """A handler's typed shed, and the pre-dispatch admission gate's, come
    back as ``Overloaded`` with the same retry-after on both packages
    and on both transports."""
    got = {}
    for name in ("ref", "port"):
        core = PKGS[name].core
        _, ch, router, Svc = _open(name)
        cxl = router.stub("/pod0/svc", Svc, pid=2, pod="pod0")
        fb = router.stub("/pod0/svc", Svc, pid=3, pod="pod1")
        seen = []
        for stub, kw in ((cxl, {"inline": True}), (fb, {})):
            with pytest.raises(core.Overloaded) as e:
                stub.shed(20, **kw)
            seen.append(e.value.retry_after_s)
        ch.admission = core.AdmissionInterceptor(max_in_flight=0)
        with pytest.raises(core.Overloaded) as e:
            cxl.echo(1, inline=True)
        seen.append(e.value.retry_after_s)
        got[name] = seen
    assert got["port"] == got["ref"] == [0.02, 0.02, 0.005]


@BOTH
def test_inline_stream_in_order_without_leaks(pkg):
    core, chan = PKGS[pkg].core, PKGS[pkg].channel
    _, ch, router, Svc = _open(pkg)
    stub = router.stub("/pod0/svc", Svc, pid=2, pod="pod0")
    heap = stub.connection.heap
    want = [{"i": i, "tok": "t%d" % i} for i in range(10)]
    assert list(stub.count.stream(10, inline=True)) == want
    used = heap.used_pages()
    s1 = stub.count.stream(3, inline=True)
    assert list(s1) == want[:3]
    s2 = stub.count.stream(3, inline=True)
    gen = [getattr(st, "inner", st)._gen for st in (s1, s2)]   # the reference wraps it
    assert gen[1] > gen[0] and list(s2) == want[:3]
    assert heap.used_pages() == used       # chain scopes were recycled
    assert stub.count(4, inline=True) == want[:4]   # sync call buffers it
    s = stub.explode.stream(2, inline=True)
    assert [next(s), next(s)] == [0, 1]
    with pytest.raises(core.RpcError) as e:
        next(s)
    assert e.value.status == chan.E_EXCEPTION
    with pytest.raises(core.ChannelError, match="not a streaming"):
        stub.echo.stream(1)


@BOTH
def test_stream_cancel_aborts_the_server_generator(pkg):
    core = PKGS[pkg].core
    _, ch, router, Svc = _open(pkg)
    stub = router.stub("/pod0/svc", Svc, pid=2, pod="pod0")
    s = stub.count.stream(100, inline=True)
    assert next(s)["i"] == 0
    s.close()
    ch.pump_streams()                      # the server sees the sentinel
    assert ch._streams == []
    with pytest.raises(core.ChannelError):
        next(s)


@BOTH
def test_threaded_streams_through_server_loop(pkg):
    """Three client threads, each with its own stub, stream through one
    ServerLoop thread; the loop stops and its thread is joined."""
    core = PKGS[pkg].core
    _, ch, router, Svc = _open(pkg)
    loop = core.ServerLoop([ch], core.BusyWaitPolicy(fixed_sleep_us=5.0))
    thread = loop.run_in_thread()
    outs, errors = [None] * 3, []

    def client(i):
        try:
            stub = router.stub("/pod0/svc", Svc, pid=30 + i, pod="pod0")
            outs[i] = (list(stub.count.stream(5 + i, timeout=30.0)),
                       stub.attach(i, 3, [i, i + 1], timeout=30.0))
        except Exception as e:   # surfaced below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "client thread wedged"
    finally:
        loop.stop(timeout=10.0)
    thread.join(timeout=10.0)
    assert not thread.is_alive()
    assert not errors, errors
    for i, (chunks, reply) in enumerate(outs):
        assert [c["i"] for c in chunks] == list(range(5 + i))
        assert reply == [i, 3, [i, i + 1]]


# ---------------------------------------------------------------------------
# router and fallback link
# ---------------------------------------------------------------------------
@BOTH
def test_router_transport_is_pure_pod_metadata(pkg):
    core = PKGS[pkg].core
    orch, ch, router, Svc = _open(pkg)
    a = router.connect("/pod0/svc", pid=5, pod="pod0")
    assert a.transport == "cxl" and isinstance(a.target, core.Connection)
    orch.assign_pod(5, "pod9")             # same pid, new coherence domain
    b = router.connect("/pod0/svc", pid=5)
    assert b.transport == "fallback"
    assert isinstance(b.target, core.FallbackConnection)
    assert b.target.functions is ch.functions   # the same live handlers
    assert router.connect("/pod0/svc", pid=6).transport == "cxl"  # no pod
    router.register("/pod1/kv/a", core.RPC(orch, pid=8).open("/pod1/kv/a"))
    assert router.list_endpoints("/pod1/") == ["/pod1/kv/a"]
    with pytest.raises(core.ChannelError, match="no endpoint"):
        router.connect("/pod0/none", pid=9)
    with pytest.raises(core.ChannelError, match="hierarchical"):
        router.register("flat", ch)
    st = router.stats()
    assert (st["cxl_connects"], st["fallback_connects"]) == (2, 1)


@BOTH
def test_fallback_ownership_flips_and_exact_bytes(pkg):
    core, fbm = PKGS[pkg].core, PKGS[pkg].fallback
    fb = core.FallbackConnection(num_pages=64, link_latency_us=0.0)
    sc = fb.create_scope(4096)
    a = sc.alloc(3000)
    fb.client.write(a, b"q" * 3000, pid=fb.client_pid)
    page = PKGS[pkg].addr.unpack(a).page
    fb.add(1, lambda ctx, arg: len(bytes(ctx.read(arg, 3000))))
    b0, m0 = fb.link.bytes_moved, fb.link.msgs
    assert fb.call(1, a, scope=sc) == 3000
    assert fb.link.owner[page] == fbm.OWNER_SERVER
    assert fb.link.msgs - m0 == 2
    assert fb.link.bytes_moved - b0 == 2 * PKGS[pkg].channel.RING_SLOT_BYTES + 4096
    with pytest.raises(core.OwnershipMiss):
        fb.client.read_owned(a, 8)         # the server holds it now
    fb.client.write(a, b"r" * 4, pid=fb.client_pid)
    assert fb.link.owner[page] == fbm.OWNER_CLIENT
    assert fb.link.page_faults == 2 and fb.link.ownership_misses == 2


def test_fallback_invokes_and_puts_match_reference():
    """Cross-pod typed invokes (sealed, sandboxed) over the router's link
    pool, then a one-sided bulk put: equal replies, marshal bytes, link
    bytes, messages, faults, puts and completion words."""
    out = {}
    for name in ("ref", "port"):
        _, ch, router, Svc = _open(name)
        stub = router.stub("/pod0/svc", Svc, pid=21, pod="ppod")
        conn = stub.connection
        assert conn.transport == "fallback"
        link = conn.target.link
        replies = [stub.echo({"x": [1, 2]}), stub.attach(5, 9, [4, 5, 6]),
                   stub.echo("s" * 5000)]
        link.put_bytes(1 << 20, to=1)
        out[name] = (replies, conn.marshal_bytes, link.bytes_moved, link.msgs,
                     link.page_faults, link.n_puts, link.completion.tolist(),
                     link.replica[0].heap_id, conn.target.seals.state_of(1))
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# the permission mirror
# ---------------------------------------------------------------------------
class _BumpDuringUpload(T.SharedHeap):
    """Lands one epoch bump (as a seal from another thread would) after
    the perm snapshot is taken and before the dirty flag is cleared."""

    inject = None

    def _upload(self, perm):
        mirror = super()._upload(perm)
        inject, self.inject = self.inject, None
        if inject is not None:
            inject()
        return mirror


def test_device_perm_mirror_keeps_a_bump_that_lands_mid_upload():
    h = _BumpDuringUpload(1, 8)
    p = h.alloc_pages(2)
    h.attach_device_perm(torch.device("cpu"))
    assert h.device_perm().tolist() == [0] * 8
    h.protect_range(p, 1, holder=3)        # dirty: the next read re-pushes
    h.inject = lambda: h.protect_range(p + 1, 1, holder=3)
    first = h.device_perm()                # snapshot before the 2nd seal
    assert first.tolist()[p:p + 2] == [1, 0]
    # the injected bump kept the mirror dirty: the next read sees it
    assert h.device_perm().tolist()[p:p + 2] == [1, 1]
    h.unprotect_ranges([(p, 2)])
    assert h.device_perm().tolist() == [0] * 8


def test_device_perm_mirror_drops_an_upload_older_than_the_installed_one():
    h = _BumpDuringUpload(1, 8)
    p = h.alloc_pages(2)
    h.attach_device_perm(torch.device("cpu"))
    h.protect_range(p, 1, holder=3)

    def newer_sync_finishes_first():
        # another thread seals the second page and pushes its own,
        # newer mirror while the first upload is still in flight
        h.protect_range(p + 1, 1, holder=3)
        assert h.device_perm().tolist()[p:p + 2] == [1, 1]

    h.inject = newer_sync_finishes_first
    # the older snapshot lands last and must not overwrite the newer one
    assert h.device_perm().tolist()[p:p + 2] == [1, 1]
    assert not h._device_dirty
    assert h.device_perm().tolist()[p:p + 2] == [1, 1]


def test_device_perm_mirror_under_concurrent_bumps():
    h = T.SharedHeap(1, 64)
    pages = [h.alloc_pages(1) for _ in range(64)]
    h.attach_device_perm(torch.device("cpu"))
    stop = threading.Event()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def reader():
            while not stop.is_set():
                h.device_perm()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for p in pages:
            h.protect_range(p, 1, holder=1)
        stop.set()
        t.join(timeout=10.0)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert h.device_perm().tolist() == h.perm.astype(np.int32).tolist() == [1] * 64
