"""The port's lifecycle, snapshot/restore and live migration
(``repro_torch.core``) against the reference's (``repro.core``): the
``Endpoint`` serve/quiesce/drain/close states, exact state round trips
(a fixed corpus, a seeded corpus and a Hypothesis strategy, each through
both packages' encoders, bytes equal), snapshots' metadata and refusals,
warm replicas, ``ClusterRouter.migrate`` in one generation bump with
in-flight futures settled exactly once and mid-stream calls failing over
as documented, wildcard prefix stubs, and the migration knobs of
``ReproConfig``. Every scenario runs on both packages; the port's
observations must equal the reference's. Scenarios follow
tests/test_snapshot_migrate.py (all but its ShmCheck case). Every blocking
call and join has a timeout."""

import random
import sys
import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402

R_snap = sys.modules["repro.core.snapshot"]
T_snap = sys.modules["repro_torch.core.snapshot"]
R_gcfg = sys.modules["repro.configs.global_config"]
T_gcfg = sys.modules["repro_torch.configs.global_config"]
TMO = 10.0   # every blocking wait in this file


# ---------------------------------------------------------------------------
# services at module level: a portable snapshot names its class by path
# ---------------------------------------------------------------------------
def _kv_cls(core, qualname):
    @core.service(name="kv")
    class KV:
        def __init__(self):
            self.data = {}
            self.meta = {"epoch": (1, 2), "tags": {7: "x"}, "flags": {True}}

        @core.method(byval=True, retry=3)
        def put(self, ctx, k, v):
            self.data[k] = v
            return v

        @core.method(byval=True, retry=3)
        def get(self, ctx, k):
            return self.data.get(k, -1)

        @core.method(byval=True, streaming=True)
        def scan(self, ctx, n):
            for i in range(int(n)):
                yield i

    KV.__name__ = KV.__qualname__ = qualname
    return KV


def _hooked_cls(core, qualname):
    @core.service(name="hooked")
    class Hooked:
        def __init__(self):
            self.big = object()   # never captured
            self.n = 3

        @core.method
        def bump(self, ctx):
            self.n += 1
            return self.n

        def __snapshot__(self):
            return {"n": self.n}

        def __restore__(self, state):
            self.n = state["n"]
            self.big = None

    Hooked.__name__ = Hooked.__qualname__ = qualname
    return Hooked


RefKV, PortKV = _kv_cls(R, "RefKV"), _kv_cls(T, "PortKV")
RefHooked, PortHooked = _hooked_cls(R, "RefHooked"), _hooked_cls(T, "PortHooked")

PKGS = {
    "ref": SimpleNamespace(core=R, snap=R_snap, gcfg=R_gcfg, KV=RefKV, Hooked=RefHooked),
    "port": SimpleNamespace(core=T, snap=T_snap, gcfg=T_gcfg, KV=PortKV,
                            Hooked=PortHooked),
}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


def _both(scenario, *args):
    """Run ``scenario(pkg_namespace, *args)`` on both packages; the port's
    observations must equal the reference's. Returns them."""
    out = {name: scenario(PKGS[name], *args) for name in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:   # compared across packages
        return (type(e).__name__, str(e))


def _serve(p, orch, name="/pod0/kv", pid=1, pod="pod0", router=None):
    core = p.core
    ch = core.Channel(orch, name, server_pid=pid, heap_pages=512)
    kv = p.KV()
    ep = core.Endpoint.serve(ch, kv)
    if router is not None:
        router.register(name, ch, pod=pod)
    return ch, kv, ep


# ---------------------------------------------------------------------------
# ReproConfig's migration knobs
# ---------------------------------------------------------------------------
def test_migrate_knobs_match_reference(monkeypatch):
    def scenario(p):
        cfg = p.gcfg.ReproConfig()
        c2 = cfg.clone(migrate_drain_timeout_s=0.5, migrate_retry_after_s=0.01)
        return (cfg.migrate_drain_timeout_s, cfg.migrate_retry_after_s,
                c2.migrate_drain_timeout_s, c2.migrate_retry_after_s,
                p.gcfg.global_config.migrate_retry_after_s)

    assert _both(scenario) == (2.0, 0.002, 0.5, 0.01, 0.002)
    monkeypatch.setenv("REPRO_MIGRATE_DRAIN_TIMEOUT_S", "0.75")
    monkeypatch.setenv("REPRO_MIGRATE_RETRY_AFTER_S", "0.125")
    assert _both(scenario)[:2] == (0.75, 0.125)


# ---------------------------------------------------------------------------
# the Endpoint lifecycle
# ---------------------------------------------------------------------------
def test_serve_quiesce_resume_drain_close():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch, kv, ep = _serve(p, orch)
        conn = core.RPC(orch, pid=2).connect("/pod0/kv")
        stub = core.service_def(p.KV).stub(conn)
        obs = [ep.state, ch.lifecycle is ep, ch.served_instance is kv,
               ch.served_def.name, ch.serve_interceptors, stub.put(1, 7)]
        obs.append(ep.quiesce())
        obs += [ep.state, type(ch.admission).__name__, ep.quiesce()]
        try:
            stub.get(1)
            obs.append("admitted")
        except core.Overloaded as e:
            obs.append(("Overloaded", e.retry_after_s))
        ep.resume()
        obs += [ep.state, stub.get(1), ep.n_shed, ch.admission,
                ep.drain(timeout_s=1.0), ep.state]
        ep.close()
        obs += [ep.state, "/pod0/kv" in orch.channels, ch.lifecycle, ep.loop]
        ep.close()   # idempotent
        return obs

    got = _both(scenario)
    assert got[:6] == ["serving", True, True, "kv", (), 7]
    assert got[6:11] == [1, "quiesced", "QuiesceGate", 0, ("Overloaded", 0.002)]
    assert got[11:13] == ["serving", 7] and got[13] >= 1
    assert got[14:17] == [None, True, "drained"]
    assert got[17:] == ["closed", False, None, None]


def test_closed_endpoint_rejects_transitions_and_context_manager():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        _, _, ep = _serve(p, orch, name="/t/lc2")
        ep.close()
        obs = [_outcome(fn) for fn in (ep.start, ep.quiesce, ep.resume, ep.drain)]
        with core.Endpoint.serve(core.Channel(orch, "/t/lc3", server_pid=1,
                                              heap_pages=64), p.KV()) as ep2:
            obs.append(ep2.state)
        obs += [ep2.state, _outcome(core.Endpoint, [])]
        idle = core.Endpoint(core.Channel(orch, "/t/lc4", server_pid=2, heap_pages=64),
                             p.KV(), start=False)
        obs += [idle.state, idle.loop, idle.start().state, idle.loop.running]
        idle.close()
        return obs

    got = _both(scenario)
    assert all(o == ("ChannelError", "Endpoint is closed") for o in got[:4])
    assert got[4:6] == ["serving", "closed"] and got[6][0] == "ChannelError"
    assert got[7:] == ["quiesced", None, "serving", True]


def test_old_entry_points_still_work():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch = core.Channel(orch, "/t/legacy", server_pid=1, heap_pages=64)
        ch.serve(p.KV())
        loop = core.Channel.serve_all([ch])
        try:
            conn = core.RPC(orch, pid=2).connect("/t/legacy")
            got = core.service_def(p.KV).stub(conn).put(5, 25)
        finally:
            loop.stop()
            ch.destroy()
        return got, ch.lifecycle

    assert _both(scenario) == (25, None)


def test_drain_waits_for_live_streams():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        lc = sys.modules[f"{core.__name__}.lifecycle"]
        ch, kv, ep = _serve(p, orch, name="/t/drain")
        conn = core.RPC(orch, pid=2).connect("/t/drain")
        stub = core.service_def(p.KV).stub(conn)
        s = stub.scan.stream(100, window=1)
        first = s.next(timeout=TMO)
        busy = lc._channel_busy(ch)
        drained = ep.drain(timeout_s=0.05, poll_s=0.005)
        s.close()
        return first, busy, drained, ep.state, ep.drain(timeout_s=TMO), ep.state

    got = _both(scenario)
    assert got[:4] == (0, True, False, "quiesced") and got[4:] == (True, "drained")


# ---------------------------------------------------------------------------
# snapshot / restore
# ---------------------------------------------------------------------------
def _served(p, orch):
    core = p.core
    ch, kv, ep = _serve(p, orch, name="/t/snap", pid=10)
    conn = core.RPC(orch, pid=11).connect("/t/snap")
    stub = core.service_def(p.KV).stub(conn)
    for k in range(8):
        stub.put(k, k * 31)
    kv.data[-5] = 99
    return ch, kv, ep, stub


def test_state_roundtrip_through_bytes_is_exact():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch, kv, ep, _ = _served(p, orch)
        snap = core.snapshot(ch)
        raw = snap.to_bytes()
        back = core.Snapshot.from_bytes(raw)
        r = core.restore(back, orch=orch, start=False)
        inst = r.instance
        obs = [inst.data == kv.data, [type(k).__name__ for k in inst.data],
               inst.meta == kv.meta, type(inst.meta["epoch"]).__name__,
               inst.meta["flags"], type(inst).__name__ == type(kv).__name__,
               back.cls_path == snap.cls_path, back.blob == snap.blob,
               back.meta == snap.meta, snap.skipped, r.server_pid, r.channel.name,
               r.endpoint_name, r.lifecycle, snap.blob,
               raw == back.to_bytes(), snap.cls_path.split(":")[1] == type(kv).__name__]
        r.channel.destroy()
        ep.close()
        return obs

    got = _both(scenario)
    assert got[:10] == [True, ["int"] * 9, True, "tuple", {True}, True, True, True, True, []]
    assert got[10:14] == [1_000_000, "/t/snap~r1", None, None] and got[15:] == [True, True]


def test_snapshot_meta_and_refusals():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch, kv, ep, _ = _served(p, orch)
        snap = core.snapshot(ch)
        obs = [snap.service, snap.meta, core.snapshot(ep).meta == snap.meta]
        bare = core.Channel(orch, "/t/bare", server_pid=1, heap_pages=64)
        obs += [_outcome(core.snapshot, bare), _outcome(core.snapshot, object()),
                _outcome(core.Snapshot.from_bytes,
                         core.serial.encode([99, "m:C", b"", {}, []])),
                _outcome(core.restore, snap)]
        kv.hook = lambda: None
        snap2 = core.snapshot(ch)
        r = core.restore(snap2, orch=orch, start=False)
        obs += [snap2.skipped, hasattr(r.instance, "hook")]
        r.channel.destroy()
        bare.destroy()
        ep.close()
        return obs

    got = _both(scenario)
    assert got[0] == "kv" and got[2] is True
    meta = got[1]
    assert (meta["channel"], meta["heap_pages"], meta["connections"],
            meta["shared_heap"]) == ("/t/snap", 512, 1, False)
    assert meta["pages_used"] > 0 and meta["fn_ids"] and meta["live_streams"] == []
    assert [o[0] for o in got[3:7]] == ["ChannelError"] * 4
    assert got[7:] == [["hook"], False]


def test_snapshot_restore_hooks_override_walk():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch = core.Channel(orch, "/t/hooked", server_pid=1, heap_pages=64)
        ep = core.Endpoint.serve(ch, p.Hooked())
        snap = core.snapshot(ch)
        r = core.restore(core.Snapshot.from_bytes(snap.to_bytes()), orch=orch,
                         start=False)
        obs = [snap.skipped, snap.cls_path.split(":")[1] == type(r.instance).__name__,
               r.instance.n, r.instance.big, snap.blob]
        r.channel.destroy()
        ep.close()
        return obs

    got = _both(scenario)
    assert got[:4] == [[], True, 3, None]


def test_restored_replica_serves_identical_replies():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch, kv, ep, stub = _served(p, orch)
        r = core.restore(core.snapshot(ch), orch=orch, start=True)
        conn2 = core.RPC(orch, pid=12).connect(r.channel.name)
        stub2 = core.service_def(p.KV).stub(conn2)
        obs = []
        for k in list(range(8)) + [12345]:
            a, b = stub.get(k), stub2.get(k)
            obs.append((a, b, core.serial.encode(a) == core.serial.encode(b)))
        obs += [r.lifecycle.state, r.channel.served_instance is r.instance]
        r.close()
        ep.close()
        return obs

    got = _both(scenario)
    assert all(a == b and same for a, b, same in got[:9]) and got[9:] == ["serving", True]


def test_restore_mints_fresh_names_pids_and_pods():
    def scenario(p):
        core = p.core
        orch = core.Orchestrator()
        ch, kv, ep, _ = _served(p, orch)
        r1 = core.restore(core.snapshot(ch), orch=orch, start=False)
        r2 = core.restore(core.snapshot(ch), orch=orch, start=False, pod="pod3",
                          server_pid=77)
        obs = [r1.channel.name, r2.channel.name, r1.server_pid, r2.server_pid,
               orch.pod_of(77), orch.pod_of(r1.server_pid)]
        r1.channel.destroy()
        r2.channel.destroy()
        ep.close()
        return obs

    assert _both(scenario) == ["/t/snap~r1", "/t/snap~r2", 1_000_000, 77, "pod3", None]


def test_sync_state_stop_and_copy():
    def scenario(p):
        a, b = p.KV(), p.KV()
        a.data = {1: 2, 3: 4}
        n = p.core.sync_state(a, b)
        h1, h2 = p.Hooked(), p.Hooked()
        h1.n = 9
        return n, b.data, p.core.sync_state(h1, h2), h2.n, h2.big

    assert _both(scenario) == (2, {1: 2, 3: 4}, 1, 9, None)


# ---------------------------------------------------------------------------
# exact-state property: fixed + seeded corpus and Hypothesis, both packages
# ---------------------------------------------------------------------------
def _roundtrip_state(value):
    """Each package's pack → serial bytes → unpack preserves the value and
    its type exactly, and the two packages' bytes are equal."""
    blobs = []
    for snap, serial in ((T_snap, T.serial), (R_snap, R.serial)):
        raw = serial.encode(snap._pack(value))
        got = snap._unpack(serial.decode(raw))
        assert got == value
        assert type(got) is type(value)
        blobs.append(raw)
    assert blobs[0] == blobs[1]


FIXED_CORPUS = [
    {},
    {1: 2, -3: 4},
    {True: "t", False: "f"},
    {(1, 2): [3, 4], "s": {5, 6}},
    {None: b"bytes", 2.5: (1, (2, (3,)))},
    [{"nested": {7: {8: {9: ()}}}}],
    ({"a": 1}, [2.0, -0.0], {b"k": None}),
]


@pytest.mark.parametrize("value", FIXED_CORPUS,
                         ids=[f"fixed{i}" for i in range(len(FIXED_CORPUS))])
def test_state_roundtrip_fixed_corpus(value):
    _roundtrip_state(value)


def _rand_value(rng, depth=0):
    leaf = (lambda: None, lambda: rng.choice([True, False]),
            lambda: rng.randint(-2**40, 2**40),
            lambda: rng.random() * 1e6,
            lambda: "s" * rng.randrange(4),
            lambda: bytes(rng.randrange(256) for _ in range(3)))
    if depth >= 3 or rng.random() < 0.4:
        return rng.choice(leaf)()
    kind = rng.randrange(4)
    n = rng.randrange(4)
    if kind == 0:
        return [_rand_value(rng, depth + 1) for _ in range(n)]
    if kind == 1:
        return tuple(_rand_value(rng, depth + 1) for _ in range(n))
    if kind == 2:
        return {rng.randint(-999, 999): _rand_value(rng, depth + 1) for _ in range(n)}
    return {str(i): _rand_value(rng, depth + 1) for i in range(n)}


def test_state_roundtrip_seeded_corpus():
    rng = random.Random(1234)
    for _ in range(200):
        _roundtrip_state(_rand_value(rng))


@BOTH
def test_unpackable_values_are_refused(pkg):
    snap = PKGS[pkg].snap
    with pytest.raises(TypeError, match="cannot capture"):
        snap._pack(object())
    with pytest.raises(PKGS[pkg].core.ChannelError, match="corrupt snapshot"):
        snap._unpack(["?", 1])


def test_state_roundtrip_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    keys = (st.none() | st.booleans() | st.integers(-2**40, 2**40) | st.text(max_size=6)
            | st.binary(max_size=6))
    values = st.recursive(
        keys | st.floats(allow_nan=False, allow_infinity=False),
        lambda inner: st.lists(inner, max_size=4) | st.dictionaries(keys, inner, max_size=4)
        | st.tuples(inner, inner),
        max_leaves=16)

    @hyp.settings(max_examples=150, derandomize=True, deadline=None, database=None)
    @hyp.given(values)
    def check(value):
        _roundtrip_state(value)

    check()


# ---------------------------------------------------------------------------
# live migration
# ---------------------------------------------------------------------------
def _mig_cluster(p):
    core = p.core
    orch = core.Orchestrator()
    router = core.ClusterRouter(orch)
    ch, kv, ep = _serve(p, orch, router=router)
    orch.assign_pod(1, "pod0")
    stub = router.stub("/pod0/kv", p.KV, pid=200, pod="pod0")
    return orch, router, ch, kv, ep, stub


def _report(rep):
    return (type(rep).__name__, rep.name, rep.src_channel, rep.dst_channel, rep.src_pid,
            rep.dst_pid, rep.dst_pod, rep.generation_before, rep.generation_after,
            rep.handoff_epochs, rep.drained, rep.synced_attrs,
            type(rep.restored).__name__, rep.duration_s >= 0)


def test_migrate_hands_off_in_one_epoch():
    def scenario(p):
        orch, router, ch, kv, ep, stub = _mig_cluster(p)
        for k in range(16):
            stub.put(k, k * 31)
        rep = router.migrate("/pod0/kv", dst_pod="pod0")
        obs = [_report(rep), rep.shed_during_drain, router.n_migrations,
               [stub.get(k) for k in range(16)], stub.put(99, 1),
               "/pod0/kv" in orch.channels, "/pod0/kv~r1" in orch.channels,
               ep.state, stub.connection.failovers, sorted(router._dead_pids),
               router.resolve("/pod0/kv").chain == [rep.restored.channel],
               rep.restored.instance.data == kv.data, router.stats()]
        stub.close()
        rep.restored.close()
        return obs

    got = _both(scenario)
    assert got[0][2:4] == ("/pod0/kv", "/pod0/kv~r1") and got[0][9:11] == (1, True)
    assert got[2] == 1 and got[5:8] == [False, True, "closed"]


def test_in_flight_futures_settle_exactly_once():
    def scenario(p):
        core = p.core
        orch, router, ch, kv, ep, stub = _mig_cluster(p)
        results, lock, errors = [], threading.Lock(), []
        n = 24

        def worker(i):
            try:
                deadline = time.monotonic() + TMO
                while time.monotonic() < deadline:
                    fut = stub.put.future(i, i * 7)
                    try:
                        got = fut.result(timeout=4.0)
                        break
                    except core.Overloaded as e:
                        time.sleep(e.retry_after_s or 0.002)
                with lock:
                    results.append((i, got))
            except Exception as e:   # surfaced below
                errors.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        rep = router.migrate("/pod0/kv", dst_pod="pod0")
        for t in threads:
            t.join(TMO)
        obs = [errors, rep.handoff_epochs, sorted(results),
               [stub.get(i) for i in range(n)], any(t.is_alive() for t in threads)]
        stub.close()
        rep.restored.close()
        return obs

    got = _both(scenario)
    assert got[0] == [] and got[1] == 1 and got[2] == [(i, i * 7) for i in range(24)]


def test_mid_stream_migrate_surfaces_documented_error():
    def scenario(p):
        core = p.core
        orch, router, ch, kv, ep, stub = _mig_cluster(p)
        stream = stub.scan.stream(1000)
        first = next(stream)
        rep = router.migrate("/pod0/kv", dst_pod="pod0", drain_timeout_s=0.2)
        err = None
        try:
            for _ in range(2000):
                stream.next(timeout=0.5)
        except core.ChannelError as e:
            err = (type(e).__name__, str(e))
        obs = [first, rep.drained, err, list(stub.scan.stream(4)), rep.handoff_epochs]
        stub.close()
        rep.restored.close()
        return obs

    got = _both(scenario)
    assert got[:2] == [0, False] and "failed over mid-stream" in got[2][1]
    assert got[3:] == [[0, 1, 2, 3], 1]


def test_drain_window_sheds_and_migrate_refusals():
    def scenario(p):
        core = p.core
        orch, router, ch, kv, ep, stub = _mig_cluster(p)
        rep = router.migrate("/pod0/kv", dst_pod="pod1", close_source=False,
                             server_pid=500)
        obs = [_report(rep), rep.shed_during_drain, stub.put(5, 6),
               stub.connection.transport, ep.state, type(ch.admission).__name__,
               orch.pod_of(500)]
        stub.close()
        rep.restored.close()
        ep.close()
        empty = core.ClusterRouter(core.Orchestrator())
        obs.append(_outcome(empty.migrate, "/no/such", dst_pod="pod0"))
        o2 = core.Orchestrator()
        r2 = core.ClusterRouter(o2)
        c2 = core.Channel(o2, "/pod0/d", server_pid=3, heap_pages=64)
        c2.serve(p.KV())
        r2.register("/pod0/d", c2, pod="pod0")
        r2.connect("/pod0/d", pid=4, pod="pod0")   # pid 3 now holds a lease
        r2.mark_crashed(3)
        o2.expire_leases(3)
        o2.tick()
        obs.append(_outcome(r2.migrate, "/pod0/d", dst_pod="pod0"))
        return obs

    got = _both(scenario)
    assert got[0][5:7] == (500, "pod1") and got[2:4] == [6, "fallback"]
    assert got[4:6] == ["serving", "QuiesceGate"] and got[6] == "pod1"
    assert got[7][0] == "ChannelError" and "dead" in got[8][1]


# ---------------------------------------------------------------------------
# wildcard prefix stubs
# ---------------------------------------------------------------------------
def _wc_cluster(p):
    core = p.core
    orch = core.Orchestrator()
    router = core.ClusterRouter(orch)
    eps = []
    for i in range(3):
        ch = core.Channel(orch, f"/pod0/kv/s{i}", server_pid=1 + i, heap_pages=256)
        eps.append(core.Endpoint.serve(ch, p.KV()))
        router.register(f"/pod0/kv/s{i}", ch, pod="pod0")
        orch.assign_pod(1 + i, "pod0")
    return orch, router, eps


def test_wildcard_spreads_over_prefix_and_sees_migrated_sibling():
    def scenario(p):
        orch, router, eps = _wc_cluster(p)
        stub = router.stub("/pod0/kv/*", p.KV, pid=300, pod="pod0")
        wc = stub.connection
        obs = [[stub.put(i, i + 1) for i in range(9)], wc.transport,
               type(wc).__name__, dict(wc.dispatched), wc.endpoints(), wc.prefix]
        rep = router.migrate("/pod0/kv/s1", dst_pod="pod0")
        obs += [[stub.put(10 + i, i) for i in range(6)], wc.endpoints(),
                dict(wc.dispatched), wc.n_invokes, rep.dst_channel]
        stub.close()
        rep.restored.close()
        for ep in eps:
            ep.close()
        return obs

    got = _both(scenario)
    assert got[1:4] == ["wildcard", "WildcardConnection", {f"/pod0/kv/s{i}": 3
                                                            for i in range(3)}]


def test_wildcard_degrades_past_dead_endpoints_and_refuses_scopes():
    def scenario(p):
        core = p.core
        orch, router, eps = _wc_cluster(p)
        obs = [_outcome(router.stub, "/pod0/kv/*", p.KV, pid=301, balance="power2")]
        wc = router.connect("/pod0/kv/*", pid=302)
        obs += [_outcome(wc.create_scope, 64), _outcome(wc.new_bytes, b"x"),
                _outcome(wc.build_graph, 1)]
        wc.close()
        obs.append(_outcome(core.WildcardConnection, router, "/pod0/kv", 5))
        obs.append(_outcome(core.WildcardConnection, router, "pod0*", 5))
        stub = router.stub("/pod0/kv/*", p.KV, pid=303, pod="pod0")
        obs.append([stub.put(i, i) for i in range(3)])   # one connect an endpoint
        router.mark_crashed(2)
        orch.expire_leases(2)
        orch.tick()
        obs += [stub.connection.endpoints(), [stub.put(i, i) for i in range(4)],
                dict(stub.connection.dispatched)]
        for pid in (1, 3):
            router.mark_crashed(pid)
            orch.expire_leases(pid)
        orch.tick()
        obs.append(_outcome(stub.put, 1, 1))
        stub.close()
        for ep in eps:
            ep.close()
        return obs

    got = _both(scenario)
    assert all(o[0] == "ChannelError" for o in got[:6])
    assert got[7] == ["/pod0/kv/s0", "/pod0/kv/s2"] and "no live endpoint" in got[10][1]
