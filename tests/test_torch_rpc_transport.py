"""The port's asynchronous RPC surface (``repro_torch.core``) against the
reference's (``repro.core``): futures and ``gather``, streams and staged
flights over both transports, the serve loops, ``invoke_serialized``,
``build_graph``/``GraphRef``, link striping, one-sided framing, window
seal epochs, the stats and retry interceptors, ``SerialChannel`` and
``ReproConfig``. Every scenario runs on both packages; where the result
is a value (a reply, a counter, a page count, an exception type) the
port's must equal the reference's. Scenarios follow tests/test_streaming.py,
tests/test_link_pool.py, tests/test_service.py, tests/test_marshal.py and
tests/test_core_rpc.py. Every blocking call and join has a timeout."""

import inspect
import random
import sys
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import channel as R_channel  # noqa: E402
from repro.core import fallback as R_fallback  # noqa: E402
from repro.core import marshal as R_marshal  # noqa: E402
from repro.core import router as R_router  # noqa: E402
from repro.core import seal as R_seal  # noqa: E402
from repro.core import service as R_service  # noqa: E402
from repro_torch.core import channel as T_channel  # noqa: E402
from repro_torch.core import fallback as T_fallback  # noqa: E402
from repro_torch.core import marshal as T_marshal  # noqa: E402
from repro_torch.core import router as T_router  # noqa: E402
from repro_torch.core import seal as T_seal  # noqa: E402
from repro_torch.core import service as T_service  # noqa: E402

R_gcfg = sys.modules["repro.configs.global_config"]
T_gcfg = sys.modules["repro_torch.configs.global_config"]

PKGS = {
    "ref": SimpleNamespace(core=R, channel=R_channel, fallback=R_fallback,
                           marshal=R_marshal, router=R_router, seal=R_seal,
                           service=R_service, serial=R.serial, gcfg=R_gcfg),
    "port": SimpleNamespace(core=T, channel=T_channel, fallback=T_fallback,
                            marshal=T_marshal, router=T_router, seal=T_seal,
                            service=T_service, serial=T.serial, gcfg=T_gcfg),
}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])
TMO = 10.0   # every blocking wait in this file


def _both(scenario, *args):
    """Run ``scenario(pkg_namespace, *args)`` on both packages; the port's
    observations must equal the reference's. Returns them."""
    out = {name: scenario(PKGS[name], *args) for name in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


# ---------------------------------------------------------------------------
# services, built per package
# ---------------------------------------------------------------------------
def _stream_svc(core):
    @core.service
    class StreamSvc:
        @core.method(streaming=True)
        def count(self, ctx, n):
            for i in range(n):
                yield i * 10

        @core.method(streaming=True)
        def docs(self, ctx, n):
            for i in range(n):
                yield {"i": i, "text": "tok%d" % i}

        @core.method(streaming=True)
        def explode(self, ctx, n):
            for i in range(n):
                yield i
            raise RuntimeError("boom after %d" % n)

        @core.method(streaming=True, deadline=0.05)
        def slow(self, ctx, n):
            for i in range(n):
                time.sleep(0.02)
                yield i

        @core.method(streaming=True, sandboxed=True)
        def echo_each(self, ctx, items):
            for i in range(len(items)):
                yield items[i]

        @core.method(streaming=True, sealed=True)
        def sealed_count(self, ctx, n):
            for i in range(n):
                yield i + 100

        def plain(self, ctx, x):
            return x + 1

    return StreamSvc


def _kv_svc(core):
    @core.service
    class KV:
        def __init__(self):
            self.store = {}

        def get(self, ctx, key):
            return self.store.get(key)

        @core.method(sealed=True, sandboxed=True)
        def put(self, ctx, key, val):
            self.store[key] = val
            return len(self.store)

        @core.method(byval=True, retry=2)
        def get_byval(self, ctx, key):
            return self.store.get(key)

        def boom(self, ctx):
            raise RuntimeError("handler crash")

        def _helper(self, x):   # underscore: not exported
            return x

    return KV


def _kv_cxl(p, name="svc"):
    core = p.core
    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=1).open(name, heap_pages=256)
    KV = _kv_svc(core)
    inst = KV()
    ch.serve(inst)
    conn = core.RPC(orch, pid=2).connect(name)
    return orch, ch, inst, conn, KV


def _fb_stream(p, latency=0.0):
    core = p.core
    fb = core.FallbackConnection(num_pages=1 << 10, link_latency_us=latency)
    Svc = _stream_svc(core)
    fb.serve(Svc())
    return fb, core.ServiceStub(fb, core.service_def(Svc)), Svc


def _link_stats(link):
    return (link.bytes_moved, link.msgs, link.page_faults,
            link.ownership_misses, link.n_puts, link.n_gets,
            link.migrate_rtts_saved, link.completion.tolist())


def _used(heap):
    return int((heap.state == 1).sum())


# ---------------------------------------------------------------------------
# streams over the fallback link (tests/test_streaming.py:323)
# ---------------------------------------------------------------------------
def test_fallback_stream_flights_and_counters_match_reference():
    """20 chunks in windows of 4: 6 staged flights (5 of values, one for
    the end), the chunk pages crossing in bulk; equal values, flights,
    link counters and heap pages on both packages, and a second stream
    leaks no page."""
    def scenario(p):
        fb, stub, _ = _fb_stream(p)
        vals = list(stub.count.stream(20, window=4))
        flights, stats = fb.n_stream_flights, fb.stats()
        f0 = fb.link.page_faults
        eight = list(stub.count.stream(8, window=8))
        faults = fb.link.page_faults - f0
        used = fb.client.heap.used_pages()
        docs = list(stub.docs.stream(3, window=2))
        list(stub.count.stream(10, window=4))
        out = (vals, flights, stats, eight, faults, docs, used,
               fb.client.heap.used_pages(), fb.n_invokes, fb.marshal_bytes,
               _link_stats(fb.link))
        fb.close()
        return out

    got = _both(scenario)
    assert got[0] == [i * 10 for i in range(20)] and got[1] == 6
    assert got[4] <= 4
    assert got[5] == [{"i": i, "text": "tok%d" % i} for i in range(3)]


@BOTH
def test_fallback_stream_failures_are_typed(pkg):
    p = PKGS[pkg]
    core = p.core
    fb, stub, _ = _fb_stream(p)
    s = stub.explode.stream(2, window=8)
    assert next(s) == 0 and next(s) == 1
    with pytest.raises(core.RpcError) as e:
        next(s)
    assert e.value.status == p.channel.E_EXCEPTION
    with pytest.raises(core.DeadlineExceeded):
        next(stub.count.stream(3, deadline=-0.001))
    got = []
    with pytest.raises(core.DeadlineExceeded):
        for v in stub.slow.stream(50, window=2):   # 20 ms a token, 50 ms budget
            got.append(v)
    assert 0 < len(got) < 50
    s = stub.count.stream(30, window=4)
    assert next(s) == 0
    s.close()
    with pytest.raises(core.ChannelError, match="cancelled"):
        next(s)
    assert stub.plain(9) == 10                     # the link stays usable
    fb.close()


@BOTH
def test_fallback_close_mid_stream_fails_waiters_exactly_once(pkg):
    p = PKGS[pkg]
    core = p.core
    fb, stub, Svc = _fb_stream(p)
    fut = fb.invoke_async(core.service_def(Svc).methods["plain"].fn_id, 1)
    s = stub.count.stream(10, window=2)
    assert next(s) == 0
    fb.close()
    for _ in range(2):                             # re-settling re-raises
        with pytest.raises(core.ChannelError):
            next(s)
        with pytest.raises(core.ChannelError):
            fut.result()
    assert not fb._client_streams and not fb._flight


def test_fallback_sealed_and_sandboxed_streams_match_reference():
    def scenario(p):
        fb, stub, _ = _fb_stream(p)
        a = list(stub.sealed_count.stream(4, window=2))
        b = list(stub.echo_each.stream(["a", "bb", "ccc"], window=2))
        out = (a, b, fb.stats(), fb.seals.n_seals, fb.seals.n_releases,
               fb.seals.pending_releases(), _used(fb.client.heap),
               int(fb.client.heap.perm.sum()))
        fb.close()
        return out

    got = _both(scenario)
    assert got[:2] == ([100, 101, 102, 103], ["a", "bb", "ccc"])
    assert got[7] == 0                             # no page left sealed


# ---------------------------------------------------------------------------
# routed streams (tests/test_streaming.py:427)
# ---------------------------------------------------------------------------
def _cluster(p, **kw):
    core = p.core
    orch = core.Orchestrator()
    router = core.ClusterRouter(orch, fallback_link_latency_us=0.0, **kw)
    ch = core.RPC(orch, pid=10).open("/pod0/svc", heap_pages=512)
    Svc = _stream_svc(core)
    ch.serve(Svc())
    router.register("/pod0/svc", ch, pod="pod0")
    return orch, router, ch, Svc


def test_routed_streams_ride_either_transport_as_the_reference():
    def scenario(p):
        _, router, ch, Svc = _cluster(p)
        same = router.stub("/pod0/svc", Svc, pid=20, pod="pod0")
        cross = router.stub("/pod0/svc", Svc, pid=21, pod="pod1")
        a = list(same.count.stream(5, inline=True))
        b = list(cross.count.stream(5))
        c = list(cross.docs.stream(4, window=3))
        d = cross.count(3)                         # a sync call buffers it
        st = cross.connection.target.stats()
        out = (same.connection.transport, cross.connection.transport, a, b,
               c, d, st, cross.connection.n_invokes, cross.connection.n_calls,
               cross.connection.marshal_bytes, same.connection.marshal_bytes)
        return out

    got = _both(scenario)
    assert got[:4] == ("cxl", "fallback", [0, 10, 20, 30, 40],
                       [0, 10, 20, 30, 40])


@BOTH
def test_routed_stream_deadline_and_interceptors(pkg):
    p = PKGS[pkg]
    core = p.core
    _, router, ch, Svc = _cluster(p)
    seen = []

    class Spy(core.Interceptor):
        def intercept(self, call, proceed):
            seen.append((call.method, call.is_stream, call.is_future))
            return proceed()

    for pid, pod in ((20, "pod0"), (21, "pod1")):
        stub = router.stub("/pod0/svc", Svc, pid=pid, pod=pod,
                           interceptors=(Spy(),))
        with pytest.raises(core.DeadlineExceeded):
            next(stub.count.stream(3, deadline=-0.001, inline=True))
        assert list(stub.count.stream(2, inline=True)) == [0, 10]
        if pod == "pod1":                          # the link settles futures
            assert stub.plain.future(4).result(timeout=TMO) == 5
        with pytest.raises(core.ChannelError, match="streaming"):
            stub.count.future(3)
    assert seen[:2] == [("count", True, False)] * 2
    assert ("plain", False, True) in seen


# ---------------------------------------------------------------------------
# streams on the ring under the serve loops (tests/test_streaming.py:512)
# ---------------------------------------------------------------------------
@BOTH
def test_ring_stream_slot_stays_open_until_the_chain_ends(pkg):
    p = PKGS[pkg]
    core = p.core
    orch = core.Orchestrator()
    Svc = _stream_svc(core)
    ch = core.RPC(orch, pid=1).open("/pod0/stream", heap_pages=512)
    ch.serve(Svc())
    conn = core.RPC(orch, pid=2).connect("/pod0/stream")
    stub = core.ServiceStub(conn, core.service_def(Svc))
    s = stub.count.stream(2, window=4)
    with pytest.raises(core.ChannelError, match="timed out"):
        s.next(timeout=0.05)                       # nobody serves yet
    ch.serve_many()
    assert list(s) == [0, 10]                      # the same stream recovers
    s = stub.count.stream(6, window=2)
    ch.serve_many()
    slot = s.token[0]
    assert conn.ring.state_of(slot) < p.channel.R_DONE
    rest = []
    while True:
        ch.serve_many()
        try:
            rest.append(s.next(timeout=TMO))
        except StopIteration:
            break
    assert rest == [i * 10 for i in range(6)]
    assert conn.ring.state_of(slot) == 0
    for _ in range(conn.ring.capacity + 5):        # more streams than slots
        assert list(stub.count.stream(2, inline=True)) == [0, 10]


# ---------------------------------------------------------------------------
# LinkPool striping and shared flushes (tests/test_link_pool.py)
# ---------------------------------------------------------------------------
def _fns(p):
    th = p.marshal.typed_handler
    return {1: th(lambda ctx, a: a[0] + a[1]), 2: th(lambda ctx, a: list(a))}


def _pool(p, pool_size=2, stripe="rr"):
    return p.fallback.LinkPool(num_pages=1 << 12, link_latency_us=0.0,
                               pool_size=pool_size, stripe=stripe)


@BOTH
def test_link_pool_striping(pkg):
    p = PKGS[pkg]
    with pytest.raises(p.core.ChannelError, match=">= 1 link"):
        _pool(p, pool_size=0)
    with pytest.raises(p.core.ChannelError, match="stripe policy"):
        _pool(p, stripe="hash-of-the-moon")
    pool = _pool(p)
    conns = [pool.connect(client_pid=10 + i, server_pid=2, functions=_fns(p))
             for i in range(4)]
    assert [c._stripe for c in conns] == [0, 1, 0, 1]
    assert conns[0].link is conns[2].link is not conns[1].link
    conns[0].close()
    assert conns[0] not in pool.members[0] + pool.members[1]
    pool = _pool(p, stripe="pid")
    assert [pool.connect(client_pid=pid)._stripe for pid in (10, 11, 13)] == [0, 1, 1]
    assert pool.stats()["connects"] == 3


def test_shared_flush_carries_every_members_flight():
    def scenario(p):
        pool = _pool(p, pool_size=1)
        c1 = pool.connect(client_pid=10, functions=_fns(p))
        c2 = pool.connect(client_pid=11, functions=_fns(p))
        f1 = c1.invoke_async(1, 1, 2)
        f2 = c2.invoke_async(1, 30, 40)
        served = c1.flush()            # c1's flush flies c2's flight too
        staged = (len(c1._flight), len(c2._flight))
        out = (served, staged, f1.result(), f2.result(), pool.stats(),
               pool.flush_all(), c1.stats(), c2.n_flushes)
        c1.close()
        c2.close()
        return out

    got = _both(scenario)
    assert got[:4] == (2, (0, 0), 3, 70)
    assert got[4]["shared_flushes"] == 1 and got[5] == 0


class _PoolModel:
    """Two clients on ONE stripe, random posts, stripe flushes through a
    random member and random settlement order (tests/test_link_pool.py's
    driver); records every settled value and the link's counters."""

    def __init__(self, p, seed):
        self.rng = random.Random(seed)
        self.p = p
        self.pool = _pool(p, pool_size=1)
        self.conns = [self.pool.connect(client_pid=10 + i, server_pid=2,
                                        ring_capacity=16, functions=_fns(p))
                      for i in range(2)]
        for c in self.conns:
            c.admission_wait_s = 0.0   # a slot still unsettled: shed at once
        self.next_val = 0
        self.live, self.log = [], []

    def post(self):
        ci = self.rng.randrange(2)
        if sum(1 for c, _, _ in self.live if c == ci) >= 12:
            return
        a, b = self.next_val, self.next_val * 7 + 3
        try:
            fut = self.conns[ci].invoke_async(1, a, b,
                                              sealed=self.rng.random() < 0.5)
        except self.p.core.Overloaded:
            self.log.append("shed")
            return
        self.next_val += 1
        self.live.append((ci, fut, a + b))

    def flush(self):
        self.conns[self.rng.randrange(2)].flush()
        assert not any(c._flight for c in self.conns)

    def settle(self):
        self.rng.shuffle(self.live)
        keep = []
        for ci, fut, want in self.live:
            if self.rng.random() < 0.5 and fut.done():
                got = fut.result(timeout=TMO)
                assert got == want, "reply lost or cross-delivered"
                self.log.append(got)
            else:
                keep.append((ci, fut, want))
        self.live = keep


@pytest.mark.parametrize("seed", [0xC0FFEE, 1, 2])
def test_interleaved_flights_on_a_shared_link_match_reference(seed):
    def scenario(p):
        m = _PoolModel(p, seed)
        steps = 0
        while sum(1 for x in m.log if x != "shed") < 60:
            steps += 1
            assert steps < 100_000, "driver wedged"
            r = m.rng.random()
            (m.post if r < 0.5 else m.flush if r < 0.75 else m.settle)()
            owners = set(m.pool.links[0].owner.tolist())
            assert owners <= {p.fallback.OWNER_CLIENT, p.fallback.OWNER_SERVER}
        for c in m.conns:
            c.flush()
        for _, fut, want in m.live:
            assert fut.result(timeout=TMO) == want
        out = (m.log, steps, m.pool.stats(),
               [c.seals.n_batch_flushes for c in m.conns],
               [c.n_window_seal_flushes for c in m.conns])
        for c in m.conns:
            c.close()
        return out

    _both(scenario)


# ---------------------------------------------------------------------------
# one-sided framing, run batching, window seal epochs
# ---------------------------------------------------------------------------
def test_one_sided_and_legacy_framing_match_reference():
    def scenario(p):
        fb = p.fallback
        out = []
        for one_sided in (True, False):
            conn = fb.FallbackConnection(num_pages=1 << 10, link_latency_us=0.0,
                                         functions=_fns(p), one_sided=one_sided)
            futs = [conn.invoke_async(1, k, k) for k in range(8)]
            before = _link_stats(conn.link)
            conn.flush()
            out.append((before, _link_stats(conn.link),
                         [f.result() for f in futs], conn.stats()))
            conn.close()
        link = fb.DSMLink(num_pages=64, link_latency_us=0.0)
        link.put([], to=fb.OWNER_SERVER, payload_bytes=100)
        link.owner[:] = fb.OWNER_SERVER
        link.get([5, 6, 9], frm=fb.OWNER_SERVER, payload_bytes=16, msgs=2)
        out.append(_link_stats(link))
        return out

    got = _both(scenario)
    (b0, a0, vals, _), (b1, a1, _, _) = got[:2]
    assert vals == [2 * k for k in range(8)]
    assert a0[4] - b0[4] == 2 and a1[4] == b1[4]   # 2 puts one-sided, 0 legacy
    assert got[2][0] == 100 + T_fallback.COMPLETION_WORD_BYTES + 3 * 4096 + 16 + 8


def test_migrate_run_batching_matches_reference():
    def scenario(p):
        fb = p.fallback
        link = fb.DSMLink(num_pages=64, link_latency_us=0.0)
        link.owner[:] = fb.OWNER_SERVER
        a = link.migrate([3, 4, 5, 9, 10, 20], to=fb.OWNER_CLIENT)
        b = link.migrate([30, 31, 32], to=fb.OWNER_CLIENT)
        conn = fb.FallbackConnection(num_pages=256, link_latency_us=0.0,
                                     functions=_fns(p))
        conn.link.owner[16:24] = fb.OWNER_SERVER
        conn.link.owner[30:32] = fb.OWNER_SERVER
        conn.client.read(conn.client.heap.addr_of_page(16),
                         16 * conn.link.page_size)
        out = (a, b, _link_stats(link), _link_stats(conn.link),
               conn.client.owns(16), conn.server.owns(16))
        conn.close()
        return out

    got = _both(scenario)
    assert got[:2] == (6, 3) and got[2][6] == 2 and got[3][6] == 1


def test_window_seal_epochs_match_reference():
    """A sealed pipelined window releases all its seals in ONE permission
    epoch at flush; settling futures never release again; with window
    batching off every future pays its own release."""
    def scenario(p):
        fb = p.fallback
        out = []
        for batching in (True, False):
            conn = fb.FallbackConnection(num_pages=1 << 10, link_latency_us=0.0,
                                         functions=_fns(p),
                                         window_seal_batching=batching)
            sealed = [conn.invoke_async(1, k, 1, sealed=True) for k in range(6)]
            plain = [conn.invoke_async(1, k, 5) for k in range(2)]
            s0 = (conn.seals.n_batch_flushes, conn.client.heap.perm_epoch,
                  conn.seals.n_releases)
            conn.flush()
            s1 = (conn.seals.n_batch_flushes, conn.client.heap.perm_epoch,
                  conn.seals.n_releases)
            vals = [f.result() for f in sealed + plain]
            out.append((s0, s1, conn.seals.n_releases, conn.n_window_seal_flushes,
                        vals, conn.stats()))
            conn.close()
        pool = _pool(p, pool_size=1)
        c1 = pool.connect(client_pid=10, functions=_fns(p))
        c2 = pool.connect(client_pid=11, functions=_fns(p))
        f = [c.invoke_async(1, k, i, sealed=True) for i, c in enumerate((c1, c2))
             for k in range(4)]
        c1.flush()
        out.append(([c.seals.n_batch_flushes for c in (c1, c2)],
                    [x.result() for x in f]))
        return out

    got = _both(scenario)
    (s0, s1, rel, wins, vals, _), off = got[0], got[1]
    assert (s1[0] - s0[0], s1[1] - s0[1], wins) == (1, 1, 1)
    assert rel == s1[2] and vals == [k + 1 for k in range(6)] + [5, 6]
    assert off[3] == 0 and off[2] - off[1][2] == 6
    assert got[2][0] == [1, 1]


# ---------------------------------------------------------------------------
# futures on the ring and on the link (tests/test_service.py:288, :373)
# ---------------------------------------------------------------------------
def test_ring_futures_pipeline_and_gather_match_reference():
    def scenario(p):
        core = p.core
        orch, ch, inst, conn, KV = _kv_cxl(p)
        stub = core.ServiceStub(conn, core.service_def(KV))
        stub.put("k", 1, inline=True)
        futs = [stub.get.future("k") for _ in range(8)]
        pending = [f.done() for f in futs]
        served = ch.serve_many()
        landed = [f.done() for f in futs]
        rev = [futs[i].result() for i in reversed(range(8))]
        futs = [stub.get.future("k") for _ in range(4)]
        ch.serve_many()
        g = core.gather(futs, timeout=TMO)
        fn = core.service_def(KV).methods["get"].fn_id
        graph = core.build_graph(conn, "k")
        b0 = conn.marshal_bytes
        futs = [conn.invoke_async(fn, graph) for _ in range(4)]
        ch.serve_many()
        gvals = [f.result() for f in futs]
        zero = conn.marshal_bytes - b0             # pointer-passed
        sealed = stub.put.future("k", 11)
        ch.serve_many()
        return (any(pending), served, all(landed), rev, g, gvals,
                zero, sealed.result(), inst.store["k"],
                conn.marshal_bytes, conn.n_invokes, conn.heap.stats())

    got = _both(scenario)
    assert got[:9] == (False, 8, True, [1] * 8, [1] * 4, [1] * 4, 0, 1, 11)


@BOTH
def test_ring_future_timeout_cancel_and_close(pkg):
    p = PKGS[pkg]
    core = p.core
    orch, ch, inst, conn, KV = _kv_cxl(p)
    fn = core.service_def(KV).methods["get"].fn_id
    f = conn.invoke_async(fn, "k")
    with pytest.raises(core.ChannelError, match="timed out"):
        f.result(timeout=0.01)
    ch.serve_many()                                # the same future settles
    assert f.result(timeout=TMO) is None
    f2 = conn.invoke_async(fn, "k")
    assert f2.cancel() is True and f2.cancel() is False
    with pytest.raises(core.ChannelError, match="cancelled"):
        f2.result()
    ch.serve_many()
    conn._reap_abandoned()
    assert not conn._abandoned
    futs = [conn.invoke_async(fn, "k") for _ in range(8)]
    ch.serve_many()
    assert [x.result() for x in futs] == [None] * 8
    conn.invoke(fn, "warm", inline=True)
    used = _used(conn.heap)
    futs = [conn.invoke_async(fn, "k") for _ in range(4)]
    conn.close()
    for x in futs:
        with pytest.raises(core.ChannelError):
            x.result()
    assert _used(conn.heap) < used


@BOTH
def test_ring_gather_drains_under_listen_in_thread(pkg):
    p = PKGS[pkg]
    core = p.core
    orch, ch, inst, conn, KV = _kv_cxl(p)
    th = ch.listen_in_thread()
    try:
        stub = core.ServiceStub(conn, core.service_def(KV))
        stub.put("k", 2, timeout=TMO)
        assert core.gather([stub.get.future("k", timeout=TMO)
                            for _ in range(16)], timeout=TMO) == [2] * 16
    finally:
        ch.stop()
        th.join(timeout=TMO)
    assert not th.is_alive()


def test_link_futures_staged_flight_match_reference():
    def scenario(p):
        core = p.core
        fb = core.FallbackConnection(num_pages=512, link_latency_us=0.0)
        KV = _kv_svc(core)
        fb.serve(KV())
        stub = core.ServiceStub(fb, core.service_def(KV))
        stub.put("k", 6)
        before = _link_stats(fb.link)
        futs = [stub.get.future("k") for _ in range(8)]
        staged = fb.n_flushes
        vals = core.gather(futs, timeout=TMO)
        out = [staged, vals, fb.n_flushes, before, _link_stats(fb.link)]
        good, bad, good2 = (stub.get.future("k"), stub.boom.future(),
                            stub.get.future("k"))
        out.append(good.result(timeout=TMO))
        with pytest.raises(RuntimeError, match="handler crash"):
            bad.result()
        out += [good2.result(), fb.stats(), fb.marshal_bytes]
        used = _used(fb.client.heap)
        f = stub.get.future("k")
        out.append(_used(fb.client.heap) > used)
        fb.close()
        with pytest.raises(core.ChannelError):
            f.result()
        out.append(_used(fb.client.heap) <= used)  # the staged scope drained
        return out

    got = _both(scenario)
    assert got[:3] == [0, [6] * 8, 1]
    assert got[4][1] - got[3][1] == 16 and got[4][2] - got[3][2] <= 2
    assert got[5] == got[6] == 6 and got[-2:] == [True, True]


# ---------------------------------------------------------------------------
# deadlines (tests/test_service.py:424)
# ---------------------------------------------------------------------------
@BOTH
def test_deadlines_on_both_transports(pkg):
    p = PKGS[pkg]
    core = p.core
    orch, ch, inst, conn, KV = _kv_cxl(p)
    fn = core.service_def(KV).methods["get"].fn_id
    with pytest.raises(core.DeadlineExceeded):
        conn.invoke(fn, "k", deadline=-0.001, inline=True)
    fb = core.FallbackConnection(num_pages=256, link_latency_us=0.0)
    fb.serve(KV())
    with pytest.raises(core.DeadlineExceeded):
        fb.invoke(fn, "k", deadline=-0.001)
    with pytest.raises(core.DeadlineExceeded):
        fb.invoke_async(fn, "k", deadline=-0.001).result()
    fb.close()
    f = conn.invoke_async(fn, "k", deadline=0.0001)
    time.sleep(0.01)                               # lapses while queued
    ch.serve_many()
    with pytest.raises(core.DeadlineExceeded):
        f.result()
    f = conn.invoke_async(fn, "k", deadline=0.05)  # lapses mid-wait
    with pytest.raises(core.DeadlineExceeded):
        f.result(timeout=TMO)
    with pytest.raises(core.DeadlineExceeded):
        f.result()
    ch.serve_many()
    conn._reap_abandoned()
    assert not conn._abandoned
    futs = [conn.invoke_async(fn, "k") for _ in range(8)]
    ch.serve_many()
    assert [x.result() for x in futs] == [None] * 8


@BOTH
def test_client_side_deadline_lapse_is_not_retried(pkg):
    p = PKGS[pkg]
    core = p.core
    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=1).open("svc-cdl", heap_pages=128)
    KV = _kv_svc(core)
    ch.serve(KV())                                 # never served
    conn = core.RPC(orch, pid=2).connect("svc-cdl")
    dispatches = []

    class Count(core.Interceptor):
        def intercept(self, call, proceed):
            dispatches.append(1)
            return proceed()

    stub = core.ServiceStub(conn, core.service_def(KV),
                            interceptors=[core.RetryInterceptor(3), Count()])
    with pytest.raises(core.DeadlineExceeded):
        stub.get_byval("k", deadline=0.05)
    assert len(dispatches) == 1


# ---------------------------------------------------------------------------
# interceptors (tests/test_service.py:508)
# ---------------------------------------------------------------------------
def test_stats_interceptor_counts_match_reference():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch = core.RPC(orch, pid=1).open("svc-stats", heap_pages=128)
        KV = _kv_svc(core)
        server = core.StatsInterceptor()
        ch.serve(KV(), interceptors=[server])
        conn = core.RPC(orch, pid=2).connect("svc-stats")
        client = core.StatsInterceptor()
        stub = core.ServiceStub(conn, core.service_def(KV), interceptors=[client])
        stub.put("k", 1, inline=True)
        stub.get("k", inline=True)
        stub.get("k", inline=True)
        with pytest.raises(core.RpcError):
            stub.boom(inline=True)
        sc, ss = client.snapshot(), server.snapshot()
        assert sc["KV.get"]["mean_us"] >= ss["KV.get"]["mean_us"]
        assert stub.definition is core.service_def(KV)
        stub.close()
        assert conn.closed
        return ({k: (v["calls"], v["errors"]) for k, v in sc.items()},
                {k: (v["calls"], v["errors"]) for k, v in ss.items()},
                client.inflight, server.inflight)

    got = _both(scenario)
    assert got[0] == {"KV.put": (1, 0), "KV.get": (2, 0), "KV.boom": (1, 1)}
    assert got[1]["KV.boom"] == (1, 1)


@BOTH
def test_retry_interceptor_honors_specs_and_never_retries_deadline(pkg):
    p = PKGS[pkg]
    core = p.core
    calls, attempts = [], []

    @core.service
    class Flaky:
        @core.method(byval=True, retry=2)
        def f(self, ctx):
            calls.append(1)
            if len(calls) < 3:
                raise core.ChannelError("transient")
            return 7

        @core.method(byval=True, retry=3)
        def dl(self, ctx):
            attempts.append(1)
            raise core.DeadlineExceeded("budget gone")

    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=1).open("svc-flaky", heap_pages=128)
    ch.serve(Flaky())
    conn = core.RPC(orch, pid=2).connect("svc-flaky")
    stub = core.ServiceStub(conn, core.service_def(Flaky))
    assert stub.f(inline=True) == 7 and len(calls) == 3
    stub = core.ServiceStub(conn, core.service_def(Flaky),
                            interceptors=[core.RetryInterceptor(3)])
    with pytest.raises(core.DeadlineExceeded):
        stub.dl(inline=True)
    assert len(attempts) == 1
    sleeps = []
    retry = core.RetryInterceptor(2, seed=5, sleep=sleeps.append)
    stub = core.ServiceStub(conn, core.service_def(Flaky), interceptors=[retry])
    calls.clear()
    assert stub.f(inline=True) == 7 and len(sleeps) == 2
    assert sleeps == sorted(sleeps) and all(0 < s <= 0.25 for s in sleeps)


# ---------------------------------------------------------------------------
# GraphRef, build_graph, invoke_serialized (tests/test_marshal.py)
# ---------------------------------------------------------------------------
DOC = {"ts": 99, "user": "u1", "media": [3, 1, 4, 1, 5],
       "meta": {"tags": ["x", "y"], "depth": 2}}


def _lookup(ctx, args):
    doc = args[0]
    return doc["ts"] + doc["media"][2] + args[1]


def test_graphref_and_serialized_baseline_match_reference():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch = core.RPC(orch, pid=1).open("marshal_t")
        ch.add_typed(10, _lookup)
        ch.add_typed(19, lambda ctx, args: args[0][0]["n"] + args[1])
        observed = []

        def check(ctx, args):
            doc = args[0][0]
            page = p.core.addr.page_of(doc._val[1])
            observed.append(bool(ctx.conn.heap.perm[page] & core.PERM_SEALED))
            return doc["ts"]

        ch.add_typed(30, check)
        conn = core.RPC(orch, pid=2).connect("marshal_t")
        g = core.build_graph(conn, DOC, 7)
        first = conn.invoke(10, g, inline=True)
        b0 = conn.marshal_bytes
        again = [conn.invoke(10, g, inline=True) for _ in range(5)]
        zero = conn.marshal_bytes - b0
        ptr = conn.invoke(10, DOC, 2, inline=True)
        ser = conn.invoke_serialized(10, DOC, 2, inline=True)
        plain = conn.invoke(19, core.GraphRef(None, None, plain=[{"n": 4}]), 10,
                            inline=True)
        g2 = core.build_graph(conn, DOC)
        sealed = conn.invoke(30, g2, 1, sealed=True, inline=True)
        fb = core.FallbackConnection(num_pages=256, link_latency_us=0.0)
        fb.add_typed(10, _lookup)
        gf = core.build_graph(fb, DOC, 6)
        via_link = fb.invoke(10, gf)
        out = (first, again, zero, ptr, ser, plain, sealed, list(observed),
               gf.scope is None, via_link, g.to_python(), conn.marshal_bytes,
               conn.heap.stats(), fb.marshal_bytes, _link_stats(fb.link))
        g.destroy()
        g2.destroy()
        return out

    got = _both(scenario)
    assert got[:10] == (110, [110] * 5, 0, 105, 105, 14, 99, [True], True, 109)


@BOTH
def test_graphref_built_in_pod_crosses_pods_under_serve_all(pkg):
    p = PKGS[pkg]
    core = p.core
    orch = core.Orchestrator()
    router = core.ClusterRouter(orch, fallback_link_latency_us=0.0)
    ch = core.RPC(orch, pid=1).open("/pod0/m")
    ch.add_typed(10, _lookup)
    router.register("/pod0/m", ch, pod="pod0")
    loop = core.Channel.serve_all([ch])
    try:
        same = router.connect("/pod0/m", pid=2, pod="pod0")
        cross = router.connect("/pod0/m", pid=3, pod="pod8")
        g = same.build_graph(DOC, 1)
        assert same.invoke(10, g, timeout=TMO) == cross.invoke(10, g) == 104
        assert same.invoke(10, DOC, 1, timeout=TMO) == cross.invoke(10, DOC, 1)
        assert same.invoke_serialized(10, DOC, 1, timeout=TMO) == 104
        assert cross.invoke_serialized(10, DOC, 1) == 104
        assert cross.target.link.bytes_moved > 0
        assert same.invoke_async(10, DOC, 1).result(timeout=TMO) == 104
        assert core.gather([cross.invoke_async(10, DOC, k) for k in range(3)],
                           timeout=TMO) == [103, 104, 105]
        tok = same.call_async(10, 0)
        with pytest.raises(core.RpcError):
            same.wait(tok, timeout=TMO)            # a raw call of a typed handler
        with pytest.raises(core.ChannelError, match="CXL ring"):
            cross.call_async(10)
        with pytest.raises(core.ChannelError, match="CXL-path"):
            cross.scope_pool()
        assert same.scope_pool(1).scope_pages == 1
        assert same.seals is same.target.seals
        a = cross.new_bytes(b"xyz")
        assert bytes(cross.target.client.read(a, 3)) == b"xyz"
        assert (same.n_calls, cross.n_invokes) == (same.target.n_calls, 6)
    finally:
        loop.stop(timeout=TMO)
    assert not loop.running


# ---------------------------------------------------------------------------
# the serve loops (tests/test_core_rpc.py)
# ---------------------------------------------------------------------------
def test_serve_once_and_serve_many_match_reference():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch = core.RPC(orch, pid=1).open("sweep")
        ch.add(1, lambda ctx, a: int(a) * 2 + 1)
        conns = [core.RPC(orch, pid=10 + i).connect("sweep", ring_capacity=16)
                 for i in range(4)]
        toks = {0: conns[0].call_async(1, 3), 2: conns[2].call_async(1, 4)}
        first = ch.serve_once()
        vals = [conns[i].wait(t) for i, t in toks.items()]
        idle = ch.serve_once()
        toks = [(c, c.call_async(1, k)) for c in conns[:3] for k in range(5)]
        many = ch.serve_many()
        out = (first, vals, idle, many, [c.wait(t) for c, t in toks],
               ch.serve_many(max_sweeps=1), [c.n_calls for c in conns])
        ch.destroy()
        return out + (conns[0].closed, "sweep" in orch.channels)

    got = _both(scenario)
    assert got[:4] == (2, [7, 9], 0, 15) and got[-2:] == (True, False)


@BOTH
def test_listen_in_thread_call_stop_cycles(pkg):
    p = PKGS[pkg]
    core = p.core
    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=100).open("svc")
    conn = core.RPC(orch, pid=200).connect("svc")
    ch.add(1, lambda ctx, a: int(a) + 1)
    for cycle in range(3):
        th = ch.listen_in_thread(core.BusyWaitPolicy(fixed_sleep_us=5.0))
        try:
            assert [conn.call(1, k, timeout=TMO) for k in range(20)] == \
                list(range(1, 21))
            toks = [conn.call_async(1, k) for k in range(32)]
            assert [conn.wait(t, timeout=TMO) for t in toks] == list(range(1, 33))
            tok = conn.call_async(1, 0)
            deadline = time.monotonic() + TMO
            while not conn.poll(tok):              # one word load a probe
                assert time.monotonic() < deadline
                time.sleep(1e-4)
            assert conn.wait(tok, timeout=TMO) == 1
        finally:
            ch.stop()
            th.join(timeout=TMO)
        assert not th.is_alive()
    assert conn.n_calls == 3 * 53


@BOTH
def test_server_loop_attach_detach(pkg):
    p = PKGS[pkg]
    core = p.core
    orch = core.Orchestrator()
    a = core.RPC(orch, pid=1).open("a")
    b = core.RPC(orch, pid=2).open("b")
    a.add(1, lambda ctx, x: 10)
    b.add(1, lambda ctx, x: 20)
    ca = core.RPC(orch, pid=3).connect("a")
    cb = core.RPC(orch, pid=4).connect("b")
    loop = core.ServerLoop(None, core.BusyWaitPolicy(fixed_sleep_us=5.0))
    assert not loop.running
    loop.attach(a)
    loop.attach(a)                                 # idempotent
    loop.run_in_thread()
    try:
        assert loop.running and loop.channels == [a]
        assert ca.call(1, timeout=TMO) == 10
        loop.attach(b)
        assert cb.call(1, timeout=TMO) == 20
        loop.detach(a)
        with pytest.raises(core.ChannelError, match="timed out"):
            ca.call(1, timeout=0.05)               # nobody serves a now
        assert loop.channels == [b] and a._event is not loop._event
    finally:
        loop.stop(timeout=TMO)
    assert not loop.running and loop.n_served >= 2


@BOTH
def test_connection_helpers(pkg):
    p = PKGS[pkg]
    core = p.core
    orch = core.Orchestrator()
    ch = core.RPC(orch, pid=1).open("h")
    seen = []

    def write(ctx, a):
        ctx.write(a, b"ok!")
        seen.append(bytes(ctx.read(a, 3)))
        return 0

    ch.add(1, write)
    conn = core.RPC(orch, pid=2).connect("h")
    sc = conn.create_scope(4096)
    a = conn.new_bytes(b"abc", sc)
    implicit = conn.new_bytes(b"def")
    assert conn.call_inline(1, a, scope=sc) == 0 and seen == [b"ok!"]
    assert bytes(conn.heap.read(implicit, 3)) == b"def"
    ch.add(2, lambda ctx, x: write(ctx, implicit))  # a store past the scope
    with pytest.raises(core.RpcError) as e:
        conn.call_inline(2, a, scope=sc, sandboxed=True)
    assert e.value.status == p.channel.E_SANDBOX
    assert bytes(conn.heap.read(implicit, 3)) == b"def"
    pool = conn.scope_pool(1)
    s = pool.pop()
    x = s.write_bytes(b"z" * 16, pid=conn.client_pid)
    conn.call_inline(1, x, scope=s, sealed=True, batch_release=True)
    assert conn.seals.pending_releases() == 1
    assert conn.end_seal_window() == 1 and conn.end_seal_window() == 0
    assert ch.serve(_kv_svc(core)()).name == "KV"
    used = conn.heap.used_pages()
    conn.close()
    assert conn.heap.used_pages() < used


# ---------------------------------------------------------------------------
# SerialChannel, SealManager.release_window, ReproConfig
# ---------------------------------------------------------------------------
def test_serial_channel_matches_reference():
    def scenario(p):
        ch = p.serial.SerialChannel()
        ch.add(1, lambda obj: {"echo": obj["msg"], "n": len(obj["msg"])})
        ch.add(2, lambda obj: 1 // 0)
        th = ch.listen_in_thread()
        try:
            a = ch.call(1, {"msg": "hi" * 50}, timeout=TMO)
            with pytest.raises(p.core.ChannelError, match="remote error"):
                ch.call(2, None, timeout=TMO)
            with pytest.raises(p.core.ChannelError, match="too large"):
                ch.call(1, {"msg": "x" * (2 << 20)}, timeout=TMO)
        finally:
            ch.stop()
            th.join(timeout=TMO)
        assert not th.is_alive()
        return a, ch.bytes_sent, ch.n_calls

    assert _both(scenario)[0] == {"echo": "hi" * 50, "n": 100}


def test_release_window_matches_reference():
    def scenario(p):
        core = p.core
        h = core.SharedHeap(1, 256)
        sm = core.SealManager(h, capacity=64, batch_threshold=4)
        scopes = [core.create_scope(h, h.page_size, owner=1) for _ in range(6)]
        idxs = [sm.seal(s, holder=1) for s in scopes]
        for i in idxs:
            sm.mark_complete(i)
        e0 = h.perm_epoch
        with pytest.raises(core.SealViolation):
            sm.release_window([idxs[0]], holder=2)   # wrong holder
        epochs = sm.release_window(idxs[:2], holder=1)
        big = sm.release_window(idxs[2:], holder=1)  # crosses the threshold
        bumps = h.perm_epoch - e0
        again = sm.seal(scopes[0], holder=1)
        return (epochs, big, bumps, [sm.state_of(i) for i in idxs],
                sm.n_seals, sm.n_fast_seals, sm.n_releases, sm.n_batch_flushes,
                again, int(h.perm.sum()))

    got = _both(scenario)
    assert got[:3] == (1, 1, 2)


# knobs that nothing reads: the reference's ``lease_ttl_s`` has no reader
# in either package (the orchestrator takes its TTL as an argument), so the
# port leaves it out and setting it fails instead of doing nothing
UNREAD_KNOBS = ("lease_ttl_s",)


def _read_knobs(cfg):
    return {k: v for k, v in vars(cfg).items() if k not in UNREAD_KNOBS}


def test_repro_config_matches_reference(monkeypatch):
    assert vars(T.global_config) == _read_knobs(R_gcfg.global_config)
    for knob in UNREAD_KNOBS:
        with pytest.raises(AttributeError, match="unknown config knob"):
            T.global_config.clone(**{knob: 1.0})
    cfg = T.global_config.clone(fallback_pool_size=0, admission_wait_s=0.2)
    assert (cfg.fallback_pool_size, cfg.admission_wait_s) == (0, 0.2)
    assert T.global_config.fallback_pool_size == 2
    with pytest.raises(AttributeError, match="unknown config knob"):
        T.global_config.clone(no_such_knob=1)
    monkeypatch.setenv("REPRO_FALLBACK_LINK_LATENCY_US", "0")
    monkeypatch.setenv("REPRO_FALLBACK_ONE_SIDED", "off")
    monkeypatch.setenv("REPRO_FALLBACK_STRIPE", "pid")
    env = (T_gcfg.ReproConfig(), R_gcfg.ReproConfig())
    assert vars(env[0]) == _read_knobs(env[1])
    assert (env[0].fallback_link_latency_us, env[0].fallback_one_sided,
            env[0].fallback_stripe) == (0.0, False, "pid")

    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        c = p.gcfg.global_config.clone(fallback_pool_size=0,
                                       fallback_link_latency_us=0.0,
                                       fallback_ring_capacity=8,
                                       admission_wait_s=0.0)
        router = core.ClusterRouter(orch, config=c, fallback_one_sided=False)
        ch = core.RPC(orch, pid=1).open("/pod0/c", config=c)
        ch.add_typed(10, _lookup)
        router.register("/pod0/c", ch, pod="pod0")
        rc = router.connect("/pod0/c", pid=5, pod="pod1")
        same = router.connect("/pod0/c", pid=6, pod="pod0")
        pooled = core.ClusterRouter(orch, fallback_link_latency_us=0.0)
        return (router.fallback_pool_size, router.fallback_one_sided,
                type(rc.target).__name__, rc.target._pool is None,
                rc.target.ring.capacity, rc.target.one_sided,
                same.target.admission_wait_s, rc.target.admission_wait_s,
                pooled.fallback_pool_size, pooled.fallback_link_latency_us,
                rc.invoke(10, DOC, 0))

    got = _both(scenario)
    assert got[:6] == (0, False, "FallbackConnection", True, 8, False)


# ---------------------------------------------------------------------------
# every name ported here keeps the reference's signature
# ---------------------------------------------------------------------------
PORTED = {
    "configs.global_config": ["ReproConfig.__init__", "ReproConfig.clone"],
    "core.seal": ["SealManager.release_window"],
    "core.serial": ["SerialChannel.__init__", "SerialChannel.add",
                    "SerialChannel.call", "SerialChannel.serve_once",
                    "SerialChannel.listen_in_thread", "SerialChannel.stop"],
    "core.containers": ["deep_copy"],
    "core.channel": [
        "_serve_event_loop", "Channel.serve_once",
        "Channel.serve_many", "Channel.listen", "Channel.listen_in_thread",
        "Channel.serve_all", "Channel.stop", "Channel.destroy",
        "ServerLoop.__init__", "ServerLoop.attach", "ServerLoop.detach",
        "ServerLoop.serve_pending", "ServerLoop.run", "Connection.invoke_async",
        "Connection.invoke_serialized", "Connection.serve", "Connection.poll",
        "Connection.end_seal_window", "Connection.scope_pool",
        "Connection.new_bytes", "ServerCtx.write"],
    "core.marshal": [
        "GraphRef.__init__", "GraphRef.to_python", "GraphRef.destroy",
        "build_graph", "marshal_args", "ArgView.get", "ArgView.keys",
        "ArgView.__iter__", "ArgView.__contains__", "RpcFuture.__init__",
        "RpcFuture.done", "RpcFuture.cancel", "RpcFuture.result",
        "invoke_async_cxl", "gather", "_gather_drain", "invoke_serialized",
        "ServerStream.__init__", "ServerStream.pump", "_start_stream",
        "FallbackRpcStream.__init__", "FallbackRpcStream.next",
        "FallbackRpcStream.close", "invoke_stream_fallback",
        "FallbackRpcFuture.__init__", "FallbackRpcFuture.done",
        "FallbackRpcFuture.cancel", "FallbackRpcFuture.result",
        "invoke_async_fallback", "_to_plain", "_args_to_plain",
        "invoke_stream_cxl", "invoke_cxl"],
    "core.fallback": [
        "_FlightEntry.__init__", "DSMLink.send_batch", "DSMLink.put",
        "DSMLink.get", "DSMLink._one_sided", "DSMLink._copy_pages",
        "DSMNode.owns", "FallbackConnection.__init__",
        "FallbackConnection.new_bytes", "FallbackConnection.add_typed",
        "FallbackConnection.invoke_async", "FallbackConnection.invoke_stream",
        "FallbackConnection.serve", "FallbackConnection.post_async",
        "FallbackConnection.in_flight", "FallbackConnection.flush",
        "FallbackConnection._serve_flight", "FallbackConnection._end_flight",
        "FallbackConnection.abandon_flight_entry",
        "FallbackConnection._reap_abandoned_flight",
        "FallbackConnection.start_stream", "FallbackConnection._serve_stream_start",
        "FallbackConnection.pump_stream", "FallbackConnection.stats",
        "LinkPool.__init__", "LinkPool._pick_stripe", "LinkPool.connect",
        "LinkPool.flush_stripe", "LinkPool.flush_all", "LinkPool.stats"],
    "core.service": [
        "method", "MethodSpec.__init__", "StubMethod.future",
        "StatsInterceptor.__init__", "StatsInterceptor.intercept",
        "StatsInterceptor.snapshot", "RetryInterceptor.__init__",
        "RetryInterceptor.intercept", "_retry_safe", "ServiceDef.stub",
        "ServiceStub.close", "ClientCall.__init__"],
    "core.router": [
        "ClusterRouter.__init__", "RoutedConnection.invoke_stream",
        "RoutedConnection.invoke_async", "RoutedConnection.call_async",
        "RoutedConnection.wait", "RoutedConnection.invoke_serialized",
        "RoutedConnection.build_graph", "RoutedConnection.new_bytes",
        "RoutedConnection.scope_pool"],
}
PORTED_ATTRS = ["ServiceStub.definition", "RoutedConnection.seals",
                "RoutedConnection.n_calls", "RoutedConnection.n_invokes",
                "ServerLoop.running"]


def _resolve(root, module, dotted):
    obj = __import__(f"{root}.{module}", fromlist=["_"])
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("module,name", [(m, n) for m, names in PORTED.items()
                                         for n in names],
                         ids=lambda v: v)
def test_ported_name_keeps_the_reference_signature(module, name):
    port = _resolve("repro_torch", module, name)
    ref = _resolve("repro", module, name)
    assert inspect.signature(port) == inspect.signature(ref)


@pytest.mark.parametrize("dotted", PORTED_ATTRS)
def test_ported_property_exists(dotted):
    cls, attr = dotted.split(".")
    mod = "core.service" if cls == "ServiceStub" else \
        "core.channel" if cls == "ServerLoop" else "core.router"
    assert isinstance(getattr(_resolve("repro_torch", mod, cls), attr), property)
    assert isinstance(getattr(_resolve("repro", mod, cls), attr), property)


def test_public_names_exported_as_the_reference():
    names = {"GraphRef", "RpcFuture", "FallbackRpcFuture", "FallbackRpcStream",
             "build_graph", "gather", "StatsInterceptor", "RetryInterceptor",
             "MethodSpec", "DSMNode", "RING_DTYPE", "F_STREAM", "E_OVERLOAD",
             "S_COMPLETE", "MAX_CACHED", "Lease", "RPCoolError", "marshal"}
    assert names <= set(T.__all__) and names <= set(R.__all__)
    for n in names:
        assert getattr(T, n) is not None
