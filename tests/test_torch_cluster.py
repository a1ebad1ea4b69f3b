"""The port's cluster plane (``repro_torch.core``) against the reference's
(``repro.core``): replica chains, the ttl/2 lease heartbeat, Fig. 5a
failover mid-call, mid-flight and mid-stream, Fig. 5b byte quotas, the
orchestrator's lease expiry, ``AdmissionInterceptor``'s per-pid token
buckets, ``RetryInterceptor``, replica balancing (``rr``/``power2``,
pinned streams, dead replicas) and the seeded chaos plan. Every scenario
runs on both packages with clocks injected as the reference's tests
inject them; the port's observations (values, counters, exception types
and messages) must equal the reference's. Scenarios follow
tests/test_cluster_router.py, tests/test_failure_injection.py,
tests/test_overload.py, tests/test_service.py:185-262,
tests/test_marshal.py:386-445 and tests/test_streaming.py:447-477. Every
blocking call and join has a timeout."""

import inspect
import sys
import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402

PKGS = {"ref": SimpleNamespace(core=R), "port": SimpleNamespace(core=T)}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])
TMO = 10.0   # every blocking wait in this file
FN = 1
DOC = {"ts": 99, "user": "u1", "media": [3, 1, 4, 1, 5],
       "meta": {"tags": ["x", "y"], "depth": 2}}


def _lookup(ctx, args):
    doc = args[0]
    return doc["ts"] + doc["media"][2] + args[1]


def _both(scenario, *args):
    """Run ``scenario(pkg_namespace, *args)`` on both packages; the port's
    observations must equal the reference's. Returns them."""
    out = {name: scenario(PKGS[name], *args) for name in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


def _outcome(fn, *args, **kw):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:   # compared across packages
        return (type(e).__name__, str(e))


def _cluster(core, lease_ttl=6.0, **kw):
    clock = [0.0]
    orch = core.Orchestrator(clock=lambda: clock[0], lease_ttl=lease_ttl)
    return clock, orch, core.ClusterRouter(orch, **kw)


def _pump_to(clock, router, times):
    for t in times:
        clock[0] = t
        router.pump()


def _open(core, orch, pid, name, ret):
    ch = core.RPC(orch, pid=pid).open(name, heap_pages=128)
    ch.add(FN, lambda ctx, a: ret)
    return ch


# ---------------------------------------------------------------------------
# services, built per package
# ---------------------------------------------------------------------------
def _ovl_svc(core):
    @core.service(name="ovl")
    class OvlSvc:
        def __init__(self):
            self.calls = 0
            self.stream_attempts = 0
            self.partial_attempts = 0
            self.fail_streams = 0

        @core.method(retry=2)
        def ping(self, ctx, x):
            self.calls += 1
            return x + 1

        @core.method
        def once(self, ctx, x):
            self.calls += 1
            return x

        @core.method(byval=True, retry=2, deadline=1.0)
        def echo(self, ctx, x):
            self.calls += 1
            return x

        @core.method(streaming=True, retry=2)
        def toks(self, ctx, n):
            self.stream_attempts += 1
            if self.fail_streams > 0:
                self.fail_streams -= 1
                raise RuntimeError("flaky stream start")
            for i in range(int(n)):
                yield i

        @core.method(streaming=True, retry=2)
        def partial(self, ctx, n):
            self.partial_attempts += 1
            yield 0
            yield 1
            raise RuntimeError("mid-stream crash")

    return OvlSvc


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

    return KV


def _stream_svc(core):
    @core.service
    class StreamSvc:
        @core.method(streaming=True)
        def count(self, ctx, n):
            for i in range(n):
                yield i * 10

    return StreamSvc


# ---------------------------------------------------------------------------
# the replica chain and the lease heartbeat (tests/test_cluster_router.py)
# ---------------------------------------------------------------------------
def test_register_same_name_appends_replica():
    def scenario(p):
        core = p.core
        _, orch, router = _cluster(core, lease_ttl=8.0)
        prim = _open(core, orch, 1, "/pod0/svc", 1)
        rep = _open(core, orch, 2, "/pod0/svc-r1", 2)
        ep = router.register("/pod0/svc", prim)
        again = router.register("/pod0/svc", rep)
        twice = router.register("/pod0/svc", rep)   # a known channel: no-op
        return (type(ep).__name__, again is ep, twice is ep, ep.channel is prim,
                ep.replicas == [rep], ep.name, ep.active_idx, ep.generation, ep.dead,
                router.resolve("/pod0/svc") is ep, router.stats())

    got = _both(scenario)
    assert got[:5] == ("EndpointRecord", True, True, True, True)


def test_autorenew_at_half_ttl():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=8.0)
        ch = _open(core, orch, 1, "/pod0/svc", 0)
        router.register("/pod0/svc", ch, pod="pod0")
        conn = router.connect("/pod0/svc", pid=2, pod="pod0")
        heap_id = conn.target.heap.heap_id
        obs = []
        for t in (3.0, 4.0, 8.0, 12.0, 16.0, 20.0):
            clock[0] = t
            obs.append(router.pump())
        obs += [heap_id in orch.heaps, orch.expired_leases, orch.live_leases(),
                orch.live_leases(heap_id)]
        router.mark_crashed(1)
        router.mark_crashed(2)
        clock[0] = 40.0
        obs += [router.pump(), heap_id in orch.heaps, orch.reclaimed_heaps,
                orch.expired_leases, orch.live_leases()]
        return obs

    got = _both(scenario)
    assert got[:6] == [0, 2, 2, 2, 2, 2]
    assert got[6] is True and got[11] is False and got[12] >= 1


def test_autorenew_thread_keeps_leases_alive():
    """The background heartbeat on the wall clock: leases survive four
    ttls without a manual pump; the thread joins on stop."""
    def scenario(p):
        core = p.core
        orch = core.Orchestrator(lease_ttl=0.1)
        router = core.ClusterRouter(orch)
        ch = _open(core, orch, 1, "/pod0/svc", 0)
        router.register("/pod0/svc", ch, pod="pod0")
        conn = router.connect("/pod0/svc", pid=2, pod="pod0")
        heap_id = conn.target.heap.heap_id
        router.start_auto_renew()
        try:
            threading.Event().wait(0.4)
            orch.tick()
            alive = heap_id in orch.heaps
        finally:
            router.stop_auto_renew(timeout=TMO)
        return alive, router._renew_thread is None, orch.expired_leases

    assert _both(scenario) == (True, True, 0)


# ---------------------------------------------------------------------------
# Fig. 5 failure injection (tests/test_failure_injection.py)
# ---------------------------------------------------------------------------
def test_lease_expiry_mid_call_then_failover():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=6.0)
        primary = core.RPC(orch, pid=10).open("/pod0/svc", heap_pages=128)
        replica = core.RPC(orch, pid=11).open("/pod0/svc-r1", heap_pages=128)
        entered, release = threading.Event(), threading.Event()

        def slow_fn(ctx, a):
            entered.set()
            release.wait(TMO)
            return 100

        primary.add(FN, slow_fn)
        replica.add(FN, lambda ctx, a: 200)
        router.register("/pod0/svc", primary, pod="pod0")
        router.register("/pod0/svc", replica, pod="pod0")
        fails = []
        orch.on_failure(lambda pid, hid: fails.append((pid, hid)))
        conn = router.connect("/pod0/svc", pid=20, pod="pod0")
        heap_id = conn.target.heap.heap_id
        loop = core.ServerLoop([primary, replica])
        loop.run_in_thread()
        try:
            result = []
            caller = threading.Thread(
                target=lambda: result.append(conn.call(FN, timeout=TMO)), daemon=True)
            caller.start()
            assert entered.wait(TMO)
            router.mark_crashed(10)
            _pump_to(clock, router, (3.0, 6.0, 9.0, 13.0))
            obs = [(10, heap_id) in fails, heap_id in orch.heaps,
                   router.resolve("/pod0/svc").generation]
            release.set()
            caller.join(TMO)
            obs += [result, conn.call(FN, timeout=TMO), conn.failovers,
                    conn.target.channel is replica, router.n_failovers, router.stats(),
                    sorted(pid for pid, _ in fails)]
        finally:
            release.set()
            loop.stop()
        return obs

    got = _both(scenario)
    assert got[:6] == [True, True, 1, [100], 200, 1]


def test_endpoint_dies_when_every_replica_lapses():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=4.0)
        primary = _open(core, orch, 10, "/pod0/kv", 1)
        replica = _open(core, orch, 11, "/pod0/kv-r1", 2)
        router.register("/pod0/kv", primary, pod="pod0")
        router.register("/pod0/kv", replica, pod="pod0")
        conn = router.connect("/pod0/kv", pid=20, pod="pod0")
        obs = [conn.call_inline(FN)]
        router.mark_crashed(10)
        _pump_to(clock, router, (2.0, 4.0, 6.0, 9.0))
        obs.append(conn.call_inline(FN))
        router.mark_crashed(11)
        _pump_to(clock, router, (12.0, 15.0, 18.0, 21.0))
        ep = router.resolve("/pod0/kv")
        obs += [ep.dead, ep.generation, ep.active_idx, sorted(router._dead_pids),
                _outcome(conn.call_inline, FN),
                _outcome(router.connect, "/pod0/kv", pid=21, pod="pod0")]
        revived = _open(core, orch, 12, "/pod0/kv-r2", 3)
        router.register("/pod0/kv", revived, pod="pod0")
        obs += [ep.dead, ep.generation, ep.active_idx,
                router.connect("/pod0/kv", pid=22, pod="pod0").call_inline(FN),
                conn.call_inline(FN), conn.failovers, router.n_failovers]
        return obs

    got = _both(scenario)
    assert got[:2] == [1, 2] and got[6][0] == "ChannelError"
    assert "replicas are gone" in got[6][1] and got[-4:-2] == [3, 3]


def test_inflight_async_token_void_after_failover():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=4.0)
        primary = _open(core, orch, 10, "/pod0/tok", 1)
        replica = _open(core, orch, 11, "/pod0/tok-r1", 2)
        router.register("/pod0/tok", primary, pod="pod0")
        router.register("/pod0/tok", replica, pod="pod0")
        conn = router.connect("/pod0/tok", pid=20, pod="pod0")
        tok = conn.call_async(FN)
        router.mark_crashed(10)
        _pump_to(clock, router, (2.0, 4.0, 6.0, 9.0))
        return _outcome(conn.wait, tok), conn.call_inline(FN), conn.failovers

    got = _both(scenario)
    assert got[0][0] == "ChannelError" and "token is void" in got[0][1]
    assert got[1:] == (2, 1)


def test_cross_pod_replica_comes_up_on_fallback():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=4.0)
        primary = _open(core, orch, 10, "/pod0/mix", 10)
        replica = _open(core, orch, 11, "/pod1/mix-r1", 20)
        router.register("/pod0/mix", primary, pod="pod0")
        router.register("/pod0/mix", replica, pod="pod1")
        conn = router.connect("/pod0/mix", pid=20, pod="pod0")
        obs = [conn.transport, conn.call_inline(FN)]
        router.mark_crashed(10)
        _pump_to(clock, router, (2.0, 4.0, 6.0, 9.0))
        obs += [conn.call(FN), conn.transport, type(conn.target).__name__,
                router.stats()]
        return obs

    assert _both(scenario)[:4] == ["cxl", 10, 20, "fallback"]


def test_quota_forces_heap_return_with_live_connections():
    def scenario(p):
        core = p.core
        _, orch, router = _cluster(core)
        for i in range(3):
            ch = core.RPC(orch, pid=10 + i).open(f"/pod0/s{i}", heap_pages=64)
            ch.add(FN, lambda ctx, a, i=i: i)
            router.register(f"/pod0/s{i}", ch, pod="pod0")
        heap_bytes = 64 * 4096
        orch.set_quota(30, 2 * heap_bytes)
        c0 = router.connect("/pod0/s0", pid=30, pod="pod0")
        c1 = router.connect("/pod0/s1", pid=30, pod="pod0")
        obs = [c0.call_inline(FN), c1.call_inline(FN),
               _outcome(router.connect, "/pod0/s2", pid=30, pod="pod0"),
               c0.call_inline(FN), orch.mapped_bytes(30)]
        c0.close()
        c2 = router.connect("/pod0/s2", pid=30, pod="pod0")
        obs += [c2.call_inline(FN), orch.mapped_bytes(30), orch.reclaimed_heaps,
                len(orch.heaps)]
        return obs

    got = _both(scenario)
    assert got[2][0] == "QuotaExceeded" and got[6] == 2 * 64 * 4096


def test_expire_leases_lapses_on_next_tick():
    def scenario(p):
        orch = p.core.Orchestrator()
        heap = orch.create_heap(16)
        orch.map_heap(42, heap)
        fired = []
        orch.on_failure(lambda pid, hid: fired.append((pid, hid)))
        return (orch.expire_leases(42), orch.tick(), fired, orch.expire_leases(42),
                orch.expired_leases, orch.reclaimed_heaps, heap.heap_id in orch.heaps,
                orch.alloc_pid(), orch.alloc_pid())

    got = _both(scenario)
    assert got[:4] == (1, [(42, 1)], [(42, 1)], 0)
    assert got[-2:] == (1_000_000, 1_000_001)


@pytest.mark.parametrize("case", ["server_crash", "total_failure", "renew", "quota",
                                  "quota_shared", "shared_heap"])
def test_orchestrator_leases_quotas_and_shared_heaps(case):
    """The orchestrator's Fig. 5 cases (tests/test_core_rpc.py's
    orchestrator tests) and the Fig. 4b channel-wide heap."""
    def scenario(p):
        core = p.core
        clock = [0.0]
        orch = core.Orchestrator(clock=lambda: clock[0], lease_ttl=5.0)
        if case == "server_crash":
            h = orch.create_heap(4)
            orch.map_heap(1, h)
            orch.map_heap(2, h)
            fails = []
            orch.on_failure(lambda pid, hid: fails.append((pid, hid)))
            clock[0] = 3.0
            orch.renew(2)
            clock[0] = 6.0
            obs = [orch.tick(), list(fails), h.heap_id in orch.heaps, orch.live_leases()]
            clock[0] = 20.0
            return obs + [orch.tick(), h.heap_id in orch.heaps, orch.reclaimed_heaps]
        if case == "total_failure":
            for i in range(3):
                orch.map_heap(10 + i, orch.create_heap(4))
            clock[0] = 10.0
            return orch.tick(), orch.reclaimed_heaps, orch.expired_leases, len(orch.heaps)
        if case == "renew":
            h = orch.create_heap(4)
            orch.map_heap(1, h)
            for t in range(1, 10):
                clock[0] = float(t)
                orch.renew(1)
                orch.tick()
            return h.heap_id in orch.heaps, orch.expired_leases
        if case == "quota":
            orch.set_quota(7, 2 * 16 * 4096)
            h1, h2, h3 = (orch.create_heap(16) for _ in range(3))
            orch.map_heap(7, h1)
            orch.map_heap(7, h2)
            obs = [_outcome(orch.map_heap, 7, h3), orch.mapped_bytes(7)]
            orch.unmap_heap(7, h1.heap_id)
            orch.map_heap(7, h3)
            return obs + [orch.mapped_bytes(7), orch.reclaimed_heaps, sorted(orch.heaps)]
        if case == "quota_shared":
            h = orch.create_heap(16)
            orch.set_quota(1, 16 * 4096)
            orch.set_quota(2, 16 * 4096)
            orch.map_heap(1, h)
            orch.map_heap(2, h)
            return orch.mapped_bytes(1), orch.mapped_bytes(2), orch.live_leases(h.heap_id)
        ch = core.RPC(orch, pid=1).open("shared", shared_heap=True)
        c1 = core.RPC(orch, pid=2).connect("shared")
        c2 = core.RPC(orch, pid=3).connect("shared")
        ch.add(FN, lambda ctx, a: a + 1)
        obs = [c1.heap is c2.heap, c1.heap.name, c1.call_inline(FN, 4),
               c2.call_inline(FN, 5), orch.live_leases(c1.heap.heap_id)]
        c1.close()
        obs += [orch.live_leases(c2.heap.heap_id), c2.heap.heap_id in orch.heaps]
        return obs

    got = _both(scenario)
    if case == "quota":
        assert got[0][0] == "QuotaExceeded" and "close existing channels" in got[0][1]
    if case == "shared_heap":
        assert got[:5] == [True, "shared/shared", 5, 6, 3] and got[5:] == [2, True]


# ---------------------------------------------------------------------------
# failover through stubs, typed invokes and streams
# (tests/test_service.py:185-262, test_marshal.py:386-445,
# test_streaming.py:447-477)
# ---------------------------------------------------------------------------
def _kv_mesh(core):
    clock, orch, router = _cluster(core, lease_ttl=5.0, fallback_link_latency_us=0.0)
    KV = _kv_svc(core)
    primary = core.RPC(orch, pid=10).open("/pod0/kv", heap_pages=128)
    primary.serve(KV())
    router.register("/pod0/kv", primary, pod="pod0")
    replica = core.RPC(orch, pid=11).open("/pod1/kv-r1", heap_pages=128)
    replica.serve(KV())
    router.register("/pod0/kv", replica, pod="pod1")
    return clock, orch, router, primary, replica, KV


def test_failover_mid_call_byval_retries():
    def scenario(p):
        core = p.core
        clock, orch, router, primary, replica, KV = _kv_mesh(core)
        loop = core.Channel.serve_all([primary, replica])
        try:
            local = router.stub("/pod0/kv", KV, pid=20, pod="pod0")
            obs = [local.put("k", 9)]
            router.mark_crashed(10)
            _pump_to(clock, router, (2.5, 5.0, 7.5, 10.0))
            obs += [local.get_byval("k"), local.put("k", 7), local.connection.failovers,
                    local.connection.transport]
        finally:
            loop.stop()
        return obs

    assert _both(scenario) == [1, None, 1, 1, "fallback"]


def test_failover_future_settles_on_replica():
    def scenario(p):
        core = p.core
        clock, orch, router, primary, replica, KV = _kv_mesh(core)
        local = router.stub("/pod0/kv", KV, pid=20, pod="pod0")
        f = local.get_byval.future("k")   # posted, never served
        router.mark_crashed(10)
        _pump_to(clock, router, (2.5, 5.0, 7.5, 10.0))
        loop = core.Channel.serve_all([replica])
        try:
            got = f.result(timeout=TMO)
        finally:
            loop.stop()
        return type(f).__name__, f.retryable, got, f.done(), local.connection.failovers

    assert _both(scenario) == ("RoutedRpcFuture", True, None, True, 1)


def test_cancelled_routed_future_never_reexecutes():
    def scenario(p):
        core = p.core
        clock, orch, router, primary, replica, KV = _kv_mesh(core)
        local = router.stub("/pod0/kv", KV, pid=20, pod="pod0")
        f = local.put.future("k", 1)
        cancelled = f.cancel()
        router.mark_crashed(10)
        _pump_to(clock, router, (2.5, 5.0, 7.5, 10.0))
        loop = core.Channel.serve_all([replica])
        try:
            res = _outcome(f.result, timeout=2.0)
        finally:
            loop.stop()
        return cancelled, f.retryable, res, f.cancel()

    got = _both(scenario)
    assert got[0] is True and got[2][0] == "ChannelError" and "cancelled" in got[2][1]


def test_byval_future_snapshots_graphref_and_stale_graphref_surfaces():
    def scenario(p):
        core = p.core
        clock, orch, router, primary, replica, KV = _kv_mesh(core)
        loop = core.Channel.serve_all([primary, replica])
        try:
            local = router.stub("/pod0/kv", KV, pid=20, pod="pod0")
            local.put("k", 8)
            g = local.connection.build_graph("k")
            f = local.get_byval.future(g)
            obs = [f.retryable, f.result(timeout=TMO)]
            rc = router.connect("/pod0/kv", pid=21, pod="pod0")
            g2 = rc.build_graph("k")
            fn = core.service_def(KV).methods["get"].fn_id
            obs.append(rc.invoke(fn, g2))
            router.mark_crashed(10)
            _pump_to(clock, router, (2.5, 5.0, 7.5, 10.0))
            obs.append(_outcome(rc.invoke, fn, g2))
            obs.append(_outcome(rc.invoke_async, fn, g2))
            obs.append(_outcome(rc.invoke_stream, fn, g2))
            obs.append(rc.invoke(fn, rc.build_graph("k")))   # rebuilt: the replica's
        finally:
            loop.stop()
        return obs

    got = _both(scenario)
    assert got[:3] == [True, 8, 8] and got[-1] is None
    assert all(o[0] == "ChannelError" and "stale GraphRef" in o[1] for o in got[3:6])


def test_plain_value_invoke_retries_and_graphref_pins_retry():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=4.0, fallback_link_latency_us=0.0)
        primary = core.RPC(orch, pid=1).open("/pod0/kv")
        replica = core.RPC(orch, pid=5).open("/pod0/kv-r1")
        for ch in (primary, replica):
            ch.add_typed(10, _lookup)
        router.register("/pod0/kv", primary, pod="pod0")
        router.register("/pod0/kv", replica, pod="pod0")
        loop = core.Channel.serve_all([primary, replica])
        try:
            conn = router.connect("/pod0/kv", pid=2, pod="pod0")
            pinned = router.connect("/pod0/kv", pid=3, pod="pod0")
            g = pinned.build_graph(DOC, 1)
            obs = [conn.invoke(10, DOC, 1), pinned.invoke(10, g)]
            router.mark_crashed(1)
            _pump_to(clock, router, (2.0, 4.0, 6.0, 8.0))
            obs += [conn.invoke(10, DOC, 2), conn.failovers,
                    conn.invoke_serialized(10, DOC, 3),
                    _outcome(pinned.invoke, 10, g),
                    pinned.invoke(10, pinned.build_graph(DOC, 1)), pinned.failovers]
        finally:
            loop.stop()
        return obs

    got = _both(scenario)
    assert got[:5] == [104, 104, 105, 1, 106] and got[5][0] == "ChannelError"


def test_mid_stream_failover_surfaces_channel_error():
    def scenario(p):
        core = p.core
        clock, orch, router = _cluster(core, lease_ttl=4.0, fallback_link_latency_us=0.0)
        Svc = _stream_svc(core)
        ch1 = core.RPC(orch, pid=10).open("/pod0/svc", heap_pages=512)
        ch1.serve(Svc())
        ch2 = core.RPC(orch, pid=11).open("/pod0/svc-replica", heap_pages=512)
        ch2.serve(Svc())
        router.register("/pod0/svc", ch1, pod="pod0")
        router.register("/pod0/svc", ch2)
        orch.assign_pod(11, "pod0")
        stub = router.stub("/pod0/svc", Svc, pid=20, pod="pod0")
        s = stub.count.stream(10, window=2)
        ch1.serve_many()
        obs = [type(s).__name__, s.next(timeout=1.0)]
        router.mark_crashed(10)
        _pump_to(clock, router, (1.0, 2.0, 3.0, 5.0, 7.0))
        obs += [router.n_failovers, _outcome(s.next, timeout=1.0),
                list(stub.count.stream(4, inline=True)), stub.connection.failovers]
        return obs

    got = _both(scenario)
    assert got[:3] == ["RoutedRpcStream", 0, 1]
    assert got[3][0] == "ChannelError" and "failed over mid-stream" in got[3][1]
    assert got[4] == [0, 10, 20, 30]


# ---------------------------------------------------------------------------
# AdmissionInterceptor and RetryInterceptor (tests/test_overload.py)
# ---------------------------------------------------------------------------
def _ovl_service(core, gate=None, clock=None):
    orch = core.Orchestrator(clock=clock)
    ch = core.RPC(orch, pid=1).open("ovl", heap_pages=256)
    Svc = _ovl_svc(core)
    inst = Svc()
    ch.serve(inst, interceptors=(gate,) if gate is not None else ())
    conn = core.RPC(orch, pid=7).connect("ovl")
    return orch, inst, conn, Svc


def _shed(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:   # compared across packages
        return (type(e).__name__, getattr(e, "retry_after_s", None))


def test_quota_token_bucket_on_injected_clock():
    def scenario(p):
        core = p.core
        clk = [0.0]
        gate = core.AdmissionInterceptor(orch=None, retry_after_s=0.005)
        orch, inst, conn, Svc = _ovl_service(core, gate, clock=lambda: clk[0])
        gate.orch = orch
        orch.set_request_quota(7, per_second=1.0)
        stub = core.ServiceStub(conn, core.service_def(Svc))
        obs = [stub.once(1, inline=True), _shed(stub.once, 2, inline=True)]
        clk[0] = 1.5
        obs += [stub.once(3, inline=True), gate.n_shed_quota, gate.n_admitted,
                inst.calls, orch.request_quota(7), orch.request_quota(8)]
        clk[0] = 1.75   # a quarter token: the retry-after is the time to one
        obs.append(_shed(stub.once, 4, inline=True))
        return obs

    got = _both(scenario)
    assert got[0] == 1 and got[1] == ("Overloaded", pytest.approx(1.0, rel=0.01))
    assert got[2:6] == [3, 1, 2, 2]
    assert got[8] == ("Overloaded", pytest.approx(0.75, rel=0.01))


def test_zero_rate_quota_and_unquotad_pids():
    def scenario(p):
        core = p.core
        clk = [0.0]
        gate = core.AdmissionInterceptor(retry_after_s=0.004)
        orch, inst, conn, Svc = _ovl_service(core, gate, clock=lambda: clk[0])
        gate.orch = orch
        stub = core.ServiceStub(conn, core.service_def(Svc))
        orch.set_request_quota(12345, per_second=0.0)   # another pid
        obs = [stub.once(4, inline=True)]
        orch.set_request_quota(7, per_second=0.0)
        obs += [_shed(stub.once, i, inline=True) for i in range(3)]
        obs.append(inst.calls)
        orch.set_request_quota(7, None)
        obs += [stub.once(9, inline=True), gate.n_shed_quota, gate.burst]
        return obs

    got = _both(scenario)
    assert got[1:4] == [("Overloaded", 0.004)] * 3 and got[4:7] == [1, 9, 3]


def test_burst_deepens_the_bucket():
    def scenario(p):
        core = p.core
        clk = [0.0]
        gate = core.AdmissionInterceptor(retry_after_s=0.004, burst=3.0)
        orch, inst, conn, Svc = _ovl_service(core, gate, clock=lambda: clk[0])
        gate.orch = orch
        orch.set_request_quota(7, per_second=1.0)
        stub = core.ServiceStub(conn, core.service_def(Svc))
        obs = [_shed(stub.once, i, inline=True) for i in range(4)]
        clk[0] = 2.0
        obs += [_shed(stub.once, i, inline=True) for i in range(3)]
        return obs + [gate.n_shed_quota, gate.n_admitted]

    got = _both(scenario)
    assert [o[0] for o in got[:4]] == ["ok"] * 3 + ["Overloaded"]


def test_inflight_cap_and_fallback_route_shed_identically():
    def scenario(p):
        core = p.core
        gate = core.AdmissionInterceptor(max_in_flight=0, retry_after_s=0.02)
        _, inst, conn, Svc = _ovl_service(core, gate)
        stub = core.ServiceStub(conn, core.service_def(Svc))
        obs = [_shed(stub.once, 5, inline=True), inst.calls, gate.n_shed_inflight]
        orch = core.Orchestrator()
        router = core.ClusterRouter(orch)
        ch = core.RPC(orch, pid=1).open("/pod0/f", heap_pages=256)
        inst2 = Svc()
        gate2 = core.AdmissionInterceptor(max_in_flight=0, retry_after_s=0.01)
        ch.serve(inst2, interceptors=(gate2,))
        router.register("/pod0/f", ch, pod="pod0")
        far = router.stub("/pod0/f", Svc, pid=9, pod="pod1")
        obs += [far.connection.transport, _shed(far.once, 5), inst2.calls]
        return obs

    assert _both(scenario) == [("Overloaded", 0.02), 0, 1, "fallback",
                               ("Overloaded", 0.01), 0]


def test_stream_admission_held_until_chain_ends():
    def scenario(p):
        core = p.core
        gate = core.AdmissionInterceptor(max_in_flight=1, retry_after_s=0.003)
        _, inst, conn, Svc = _ovl_service(core, gate)
        stub = core.ServiceStub(conn, core.service_def(Svc))
        s1 = stub.toks.stream(3, inline=True, window=1)
        obs = [next(s1), gate.in_flight]
        s2 = stub.toks.stream(3, inline=True, window=1)
        obs += [_shed(next, s2), list(s1), gate.in_flight,
                list(stub.toks.stream(2, inline=True))]
        return obs

    assert _both(scenario) == [0, 1, ("Overloaded", 0.003), [1, 2], 0, [0, 1]]


@pytest.mark.parametrize("case", ["retry_after_floor", "deadline_cap", "zero_chunk",
                                  "partial", "deadline"])
def test_retry_interceptor(case):
    def scenario(p):
        core = p.core
        gate = None
        if case in ("retry_after_floor", "deadline_cap"):
            gate = core.AdmissionInterceptor(
                max_in_flight=0, retry_after_s=0.02 if case == "retry_after_floor" else 0.05)
        _, inst, conn, Svc = _ovl_service(core, gate)
        sleeps = []
        ri = core.RetryInterceptor(jitter=0.0, seed=0, sleep=sleeps.append)
        stub = core.ServiceStub(conn, core.service_def(Svc), (ri,))
        if case == "retry_after_floor":
            out = _shed(stub.ping, 1, inline=True)
        elif case == "deadline_cap":
            out = _shed(stub.echo, 1, deadline=0.001, inline=True)
        elif case == "zero_chunk":
            inst.fail_streams = 1
            out = stub.toks(3, inline=True)
        elif case == "partial":
            try:
                stub.partial(5, inline=True)
                out = None
            except core.ChannelError as e:
                out = (type(e).__name__, getattr(e, "chunks_delivered", 0))
        else:
            out = _shed(stub.echo, 1, deadline=-0.001, inline=True)
        return (out, [round(s, 9) for s in sleeps], inst.calls, inst.stream_attempts,
                inst.partial_attempts, gate.n_shed_inflight if gate else None)

    got = _both(scenario)
    want = {"retry_after_floor": (("Overloaded", 0.02), [0.02, 0.02], 0, 0, 0, 3),
            "deadline_cap": (("Overloaded", 0.05), [], 0, 0, 0, 1),
            "zero_chunk": ([0, 1, 2], [0.001], 0, 2, 0, None),
            "partial": (("RpcError", 2), [], 0, 0, 1, None),
            "deadline": (("DeadlineExceeded", None), [], 0, 0, 0, None)}[case]
    assert got[0][0] == want[0][0] and got[1:] == want[1:]


# ---------------------------------------------------------------------------
# replica balancing (tests/test_overload.py::TestReplicaBalancing)
# ---------------------------------------------------------------------------
def _replica_mesh(core, n=3, balance="rr", seed=0):
    orch = core.Orchestrator()
    router = core.ClusterRouter(orch)
    Svc = _ovl_svc(core)
    insts, chans = [], []
    for r in range(n):
        ch = core.RPC(orch, pid=1 + r).open(f"/pod0/bal/r{r}", heap_pages=256)
        inst = Svc()
        ch.serve(inst)
        router.register("/pod0/bal", ch, pod="pod0")
        insts.append(inst)
        chans.append(ch)
    stub = router.stub("/pod0/bal", Svc, pid=50, pod="pod0", balance=balance,
                       balance_seed=seed)
    return orch, router, chans, insts, stub, Svc


def test_rr_spreads_and_power2_prefers_lower_inflight():
    def scenario(p):
        core = p.core
        _, _, _, insts, stub, _ = _replica_mesh(core, balance="rr")
        obs = [[stub.ping(i, inline=True) for i in range(9)], [i.calls for i in insts],
               dict(stub.connection.dispatched), stub.connection.transport,
               type(stub.connection).__name__, stub.connection.n_invokes]
        _, _, _, _, stub2, _ = _replica_mesh(core, balance="power2", seed=4)
        conn = stub2.connection
        picks_even = [conn._pick([0, 1, 2]) for _ in range(12)]
        conn.inflight.update({0: 5, 1: 0})
        obs += [picks_even, {conn._pick([0, 1]) for _ in range(10)}]
        return obs

    got = _both(scenario)
    assert got[1] == [3, 3, 3] and got[2] == {0: 3, 1: 3, 2: 3} and got[-1] == {1}


def test_balance_policy_and_wildcard_guards():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        router = core.ClusterRouter(orch)
        Svc = _ovl_svc(core)
        ch = core.RPC(orch, pid=1).open("/pod0/x", heap_pages=64)
        ch.serve(Svc())
        router.register("/pod0/x", ch, pod="pod0")
        return (_outcome(router.stub, "/pod0/x", Svc, pid=5, pod="pod0", balance="random"),
                _outcome(router.stub, "/pod0/*", Svc, pid=5, balance="rr"))

    got = _both(scenario)
    assert "balance policy" in got[0][1] and got[1][0] == "ChannelError"


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_streams_stay_pinned_to_one_replica(seed):
    def scenario(p):
        _, _, _, insts, stub, _ = _replica_mesh(p.core, balance="power2", seed=seed)
        toks = [stub.toks(3, inline=True) for _ in range(4)]
        return (toks, [i.stream_attempts for i in insts], stub.connection._stream_pin,
                dict(stub.connection.dispatched))

    got = _both(scenario)
    assert sorted(got[1]) == [0, 0, 4] and got[2] is not None


def test_dead_replica_drops_out_and_revives():
    def scenario(p):
        core = p.core
        orch, router, _, insts, stub, Svc = _replica_mesh(core, balance="rr")
        conn = stub.connection
        obs = [conn.prime()]
        router.mark_crashed(3)
        orch.expire_leases(3)
        orch.tick()
        obs += [conn._live(), sorted(router._dead_pids)]
        before = insts[2].calls
        obs += [[stub.ping(i, inline=True) for i in range(6)], insts[2].calls - before,
                [insts[0].calls, insts[1].calls], conn.n_degraded]
        ch = core.RPC(orch, pid=3).open("/pod0/bal/r2b", heap_pages=256)
        ch.serve(Svc())
        router.register("/pod0/bal", ch, pod="pod0")
        obs += [3 in router._dead_pids, conn._live(), router.stats()]
        return obs

    got = _both(scenario)
    assert got[:3] == [3, [0, 1], [3]] and got[4:6] == [0, [3, 3]]
    assert got[7:9] == [False, [0, 1, 2, 3]]


def test_pinned_sub_surfaces_replica_death_and_degraded_dispatch():
    def scenario(p):
        core = p.core
        orch, router, chans, insts, stub, Svc = _replica_mesh(core, balance="rr")
        conn = stub.connection
        rc = conn._sub(2)
        fn = stub.definition.methods["ping"].fn_id
        router.mark_crashed(3)
        orch.expire_leases(3)
        orch.tick()
        obs = [_outcome(rc.invoke, fn, 1), rc.pin_idx]
        # a dispatch that lands on the dead replica degrades to a live one
        conn._rr = 2
        obs += [stub.ping(10, inline=True), conn.n_degraded, [i.calls for i in insts]]
        return obs

    got = _both(scenario)
    assert got[0][0] == "ChannelError" and "replica #2" in got[0][1] and "gone" in got[0][1]


def test_balanced_future_holds_and_releases_inflight_gauge():
    def scenario(p):
        _, _, chans, _, stub, _ = _replica_mesh(p.core, balance="power2", seed=1)
        conn = stub.connection
        fut = stub.ping.future(41)
        obs = [type(fut).__name__, sum(conn.inflight.values())]
        for ch in chans:
            ch.serve_many()
        obs += [fut.done(), fut.result(timeout=TMO), sum(conn.inflight.values()),
                fut.result(timeout=TMO), sum(conn.inflight.values())]
        fut2 = stub.ping.future(1)
        obs += [fut2.cancel(), sum(conn.inflight.values())]
        return obs

    assert _both(scenario) == ["_BalancedFuture", 1, True, 42, 0, 42, 0, True, 0]


def test_balanced_connection_refuses_heap_pinning_and_close():
    def scenario(p):
        _, _, _, _, stub, _ = _replica_mesh(p.core)
        conn = stub.connection
        obs = [_outcome(conn.create_scope, 4096), _outcome(conn.new_bytes, b"x"),
               _outcome(conn.build_graph, (1, 2))]
        stub.close()
        obs += [conn.closed, _outcome(stub.ping, 1, inline=True)]
        return obs

    got = _both(scenario)
    assert all("no single target heap" in o[1] for o in got[:3])
    assert got[3] is True and "closed" in got[4][1]


# ---------------------------------------------------------------------------
# the chaos plan and injector (tests/test_overload.py::TestChaos)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5, 6, 1234])
def test_default_plan_matches_reference(seed):
    def scenario(p):
        plan = p.core.FaultPlan.default(seed, targets={"lease_lapse": 3})
        return [(f.kind, f.at, f.duration, f.target, f.until) for f in plan], len(plan)

    got = _both(scenario)
    assert [k for k, *_ in got[0]] == ["slow_handler", "ring_stall", "quota_exhaust",
                                       "lease_lapse"]


def test_fault_validation_and_unbound_kinds():
    def scenario(p):
        core = p.core
        inj = core.ChaosInjector(core.FaultPlan([core.Fault("ring_stall", at=0.1)]))
        return (_outcome(core.Fault, "meteor_strike", at=0.5),
                _outcome(core.Fault, "ring_stall", at=1.5),
                _outcome(core.Fault, "ring_stall", at=0.2, duration=-1.0),
                _outcome(inj.poke, 0.5), _outcome(inj.bind, "nope", print),
                core.KINDS)

    got = _both(scenario)
    assert "unknown fault kind" in got[0][1] and "must satisfy" in got[1][1]
    assert "no binding" in got[3][1]


def test_quota_exhaust_applies_reverts_and_finish():
    def scenario(p):
        core = p.core
        clk = [0.0]
        orch = core.Orchestrator(clock=lambda: clk[0])
        orch.set_request_quota(7, 5.0)
        plan = core.FaultPlan([core.Fault("quota_exhaust", at=0.5, duration=0.2, target=7),
                               core.Fault("quota_exhaust", at=0.1, duration=5.0, target=9)])
        inj = core.ChaosInjector(plan, orch=orch)
        obs = [[f.kind for f in inj.poke(0.05)], [f.target for f in inj.poke(0.4)],
               orch.request_quota(9), [f.target for f in inj.poke(0.55)],
               orch.request_quota(7)]
        inj.poke(0.71)
        obs += [orch.request_quota(7), inj.n_fired, [f.target for f in inj.reverted]]
        inj.finish()
        obs += [orch.request_quota(9), [f.target for f in inj.reverted]]
        bound = []
        inj2 = core.ChaosInjector(core.FaultPlan([core.Fault("slow_handler", at=0.2,
                                                             duration=0.1)]))
        inj2.bind("slow_handler", lambda f: bound.append("on"), lambda f: bound.append("off"))
        inj2.poke(0.25)
        inj2.poke(0.5)
        return obs + [bound]

    assert _both(scenario) == [[], [9], 0.0, [7], 0.0, 5.0, 2, [7], None, [7, 9],
                               ["on", "off"]]


def test_lease_lapse_and_endpoint_death_builtins():
    def scenario(p):
        core = p.core
        orch, router, _, _, stub, _ = _replica_mesh(core, balance="rr")
        stub.connection.prime()
        inj = core.ChaosInjector(core.FaultPlan([core.Fault("lease_lapse", at=0.3, target=3)]),
                                 orch=orch, router=router)
        obs = [[f.kind for f in inj.poke(0.3)], sorted(router._dead_pids),
               stub.connection._live(), router.n_failovers]
        plain = router.connect("/pod0/bal", pid=60, pod="pod0")
        death = core.ChaosInjector(core.FaultPlan([core.Fault("endpoint_death", at=0.0,
                                                              target="/pod0/bal")]),
                                   orch=orch, router=router)
        death.poke(0.0)
        ep = router.resolve("/pod0/bal")
        obs += [ep.dead, ep.generation, router.n_failovers, sorted(router._dead_pids),
                _outcome(plain.invoke, stub.definition.methods["ping"].fn_id, 1),
                _outcome(stub.ping, 1, inline=True)]
        return obs

    got = _both(scenario)
    assert got[:3] == [["lease_lapse"], [3], [0, 1]] and got[4] is True


# ---------------------------------------------------------------------------
# every name ported here keeps the reference's signature
# ---------------------------------------------------------------------------
PORTED = {
    "core.orchestrator": [
        "Orchestrator.__init__", "Orchestrator.alloc_pid", "Orchestrator.map_heap",
        "Orchestrator.unmap_heap", "Orchestrator.set_quota",
        "Orchestrator.set_request_quota", "Orchestrator.request_quota",
        "Orchestrator.mapped_bytes", "Orchestrator.on_failure",
        "Orchestrator.expire_leases", "Orchestrator.tick", "Orchestrator._maybe_reclaim",
        "Orchestrator.live_leases"],
    "core.service": ["AdmissionInterceptor.__init__", "AdmissionInterceptor.admit",
                     "AdmissionInterceptor.release"],
    "core.channel": ["Channel.__init__", "Channel.serve", "Channel.accept"],
    "core.router": [
        "EndpointRecord", "MigrationReport", "ClusterRouter.register",
        "ClusterRouter.resolve", "ClusterRouter.connect", "ClusterRouter.stub",
        "ClusterRouter.stats", "ClusterRouter._track", "ClusterRouter.mark_crashed",
        "ClusterRouter.pump", "ClusterRouter.start_auto_renew",
        "ClusterRouter.stop_auto_renew", "ClusterRouter._on_lease_lapse",
        "ClusterRouter._fail_over", "ClusterRouter.migrate",
        "RoutedConnection.__init__", "RoutedConnection._attach",
        "RoutedConnection._ensure", "RoutedConnection._can_retry",
        "RoutedConnection.call", "RoutedConnection.call_inline",
        "RoutedConnection.invoke", "RoutedConnection._check_graph_args",
        "RoutedRpcFuture.__init__", "RoutedRpcFuture.done", "RoutedRpcFuture._kick",
        "RoutedRpcFuture.cancel", "RoutedRpcFuture._wire_stale",
        "RoutedRpcFuture.result", "RoutedRpcStream.__init__", "RoutedRpcStream.next",
        "RoutedRpcStream.close", "BalancedConnection.__init__",
        "BalancedConnection._live", "BalancedConnection._pick",
        "BalancedConnection._sub", "BalancedConnection._drop_replica",
        "BalancedConnection.prime", "BalancedConnection._dispatch",
        "BalancedConnection.call", "BalancedConnection.call_inline",
        "BalancedConnection.invoke", "BalancedConnection.invoke_serialized",
        "BalancedConnection.invoke_async", "BalancedConnection.invoke_stream",
        "BalancedConnection.create_scope", "BalancedConnection.new_bytes",
        "BalancedConnection.build_graph", "BalancedConnection.close",
        "WildcardConnection.__init__", "WildcardConnection.endpoints",
        "WildcardConnection._sub", "WildcardConnection._drop_sub",
        "WildcardConnection._dispatch", "WildcardConnection.call",
        "WildcardConnection.call_inline", "WildcardConnection.invoke",
        "WildcardConnection.invoke_serialized", "WildcardConnection.invoke_async",
        "WildcardConnection.invoke_stream", "WildcardConnection.create_scope",
        "WildcardConnection.new_bytes", "WildcardConnection.build_graph",
        "WildcardConnection.close", "_BalancedFuture.__init__",
        "_BalancedFuture._release", "_BalancedFuture.done", "_BalancedFuture._kick",
        "_BalancedFuture.cancel", "_BalancedFuture.result"],
    "core.lifecycle": [
        "QuiesceGate.__init__", "QuiesceGate.admit", "QuiesceGate.release",
        "_channel_busy", "Endpoint.__init__", "Endpoint.serve", "Endpoint.start",
        "Endpoint.quiesce", "Endpoint.resume", "Endpoint.drain", "Endpoint.close",
        "Endpoint.__enter__", "Endpoint.__exit__"],
    "core.snapshot": [
        "_pack", "_unpack", "_class_path", "_load_class", "_capture_state",
        "_apply_state", "sync_state", "Snapshot", "Snapshot.instantiate",
        "Snapshot.to_bytes", "Snapshot.from_bytes", "_resolve_channel", "snapshot",
        "RestoredEndpoint", "RestoredEndpoint.close", "_fresh_channel_name", "restore"],
    "core.chaos": [
        "Fault", "FaultPlan.__init__", "FaultPlan.default", "FaultPlan.__iter__",
        "FaultPlan.__len__", "ChaosInjector.__init__", "ChaosInjector.bind",
        "ChaosInjector._quota_apply", "ChaosInjector._quota_revert",
        "ChaosInjector._kill_pid", "ChaosInjector._lapse_apply",
        "ChaosInjector._death_apply", "ChaosInjector.poke", "ChaosInjector.finish"],
}
PORTED_ATTRS = ["core.router:EndpointRecord.channel", "core.router:EndpointRecord.replicas",
                "core.router:MigrationReport.handoff_epochs",
                "core.router:BalancedConnection.n_calls",
                "core.router:BalancedConnection.n_invokes",
                "core.router:BalancedConnection.marshal_bytes",
                "core.router:WildcardConnection.n_calls",
                "core.router:WildcardConnection.marshal_bytes",
                "core.lifecycle:Endpoint.state", "core.lifecycle:Endpoint.loop",
                "core.snapshot:Snapshot.service", "core.chaos:Fault.until",
                "core.chaos:ChaosInjector.n_fired"]


def _resolve(root, module, dotted):
    obj = __import__(f"{root}.{module}", fromlist=["_"])
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("module,name", [(m, n) for m, names in PORTED.items()
                                         for n in names], ids=lambda v: v)
def test_ported_name_keeps_the_reference_signature(module, name):
    port = _resolve("repro_torch", module, name)
    ref = _resolve("repro", module, name)
    assert inspect.signature(port) == inspect.signature(ref)


@pytest.mark.parametrize("dotted", PORTED_ATTRS)
def test_ported_property_exists(dotted):
    module, name = dotted.split(":")
    cls, attr = name.split(".")
    for root in ("repro_torch", "repro"):
        assert isinstance(getattr(_resolve(root, module, cls), attr), property)


def test_module_constants_match_reference():
    # ``core.snapshot`` names the function in both packages' namespaces
    Rc, Rl, Rr, Rs, Tc, Tl, Tr, Ts = (sys.modules[f"{root}.core.{m}"]
                                      for root in ("repro", "repro_torch")
                                      for m in ("chaos", "lifecycle", "router", "snapshot"))
    assert Tc.KINDS == Rc.KINDS and Tc._DEFAULT_BANDS == Rc._DEFAULT_BANDS
    assert (Tl.SERVING, Tl.QUIESCED, Tl.DRAINED, Tl.CLOSED) == \
        (Rl.SERVING, Rl.QUIESCED, Rl.DRAINED, Rl.CLOSED)
    assert Ts.SNAPSHOT_VERSION == Rs.SNAPSHOT_VERSION
    assert [e.__name__ for e in Tr._FAILOVER_ERRORS] == \
        [e.__name__ for e in Rr._FAILOVER_ERRORS]
    assert [c.__name__ for c in T.LeaseExpired.__mro__] == \
        [c.__name__ for c in R.LeaseExpired.__mro__]
    assert set(R.__all__) <= set(T.__all__)


@BOTH
def test_pump_timing_stays_host_side(pkg):
    """A heartbeat over a few dozen tracked pids is host work measured in
    microseconds, not a wait: bounded at 50 ms on either package."""
    core = PKGS[pkg].core
    clock, orch, router = _cluster(core, lease_ttl=2.0)
    ch = _open(core, orch, 1, "/pod0/svc", 0)
    router.register("/pod0/svc", ch, pod="pod0")
    for pid in range(2, 34):
        router.connect("/pod0/svc", pid=pid, pod="pod0")
    clock[0] = 1.0
    t0 = time.perf_counter()
    assert router.pump() == 33
    assert time.perf_counter() - t0 < 0.05
    assert orch.live_leases() == 2 * 32


def _definitions(path):
    """Module-level functions, classes, their methods and assigned names."""
    import ast

    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def _missing(*rel):
    """Definitions of the reference's ``rel`` (a package directory or one
    module) that the port's counterpart lacks, by module."""
    from pathlib import Path

    ref = Path(R.__file__).parent.parent.joinpath(*rel)
    port = Path(T.__file__).parent.parent.joinpath(*rel)
    missing = {}
    for path in sorted(ref.glob("*.py")) if ref.is_dir() else [ref]:
        other = port / path.name if ref.is_dir() else port
        assert other.exists(), f"no counterpart for {path}"
        gone = _definitions(path) - _definitions(other)
        if gone:
            missing[path.name] = gone
    return missing


def test_every_core_definition_has_a_counterpart():
    """Nothing of the reference's ``core/`` is left to it alone."""
    assert _missing("core") == {}


def test_every_analysis_definition_has_a_counterpart():
    """ShmCheck (``analysis/``): every module, function, class, method
    and assigned name."""
    assert _missing("analysis") == {}


def test_every_kv_pool_definition_has_a_counterpart():
    assert _missing("serving", "kv_pool.py") == {}


def test_every_configs_definition_has_a_counterpart():
    """The config registry (``configs/__init__.py``) and ``ModelConfig``
    (``models/config.py``): every name, and ``all_configs()`` equal on both
    packages, each config's fields and its ``q_per_kv`` (a ZeroDivisionError
    on both where there are no KV heads)."""
    import dataclasses

    import repro.configs as Rc
    import repro_torch.configs as Tc

    assert _missing("configs", "__init__.py") == {}
    assert _missing("models", "config.py") == {}
    assert set(Rc.__all__) <= set(Tc.__all__)
    ref, port = Rc.all_configs(), Tc.all_configs()
    assert sorted(ref) == sorted(port)

    def q_per_kv(cfg):
        try:
            return cfg.q_per_kv
        except ZeroDivisionError:
            return ZeroDivisionError
    for arch, cfg in ref.items():
        assert dataclasses.asdict(port[arch]) == dataclasses.asdict(cfg), arch
        assert q_per_kv(port[arch]) == q_per_kv(cfg), arch
    assert Tc.get_config("gemma3_12b").q_per_kv == 2
