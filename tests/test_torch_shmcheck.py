"""The port's ShmCheck sanitizer (``repro_torch.analysis``) and its hooks in
``repro_torch.core`` against the reference's (``repro.analysis`` over
``repro.core``), plus the leftovers of ``core/`` and the KV pool ported
with it. Every scenario runs on both packages (``pkg``):

* the seeded-bug corpus of tests/test_shmcheck_corpus.py (SHM102, SHM103,
  SHM104, SHM105 both ways, SHM107, SHM108) fires on both with equal
  findings by rule and count, and its clean counterparts stay silent;
* in the single-threaded scenarios both tracers record the same count of
  every event kind (the first field of a ``Tracer.events`` record), which
  is what shows each hook sits where the reference's does;
* the seeded drivers and Hypothesis strategies of
  tests/test_shmcheck_interleaving.py and the migrate scenario of
  tests/test_snapshot_migrate.py:560 give no false positive;
* the sandbox temp heap, ``build_doc``/``doc_matches``, ``used_bytes``,
  ``write_u64``/``view``, ``cached_regions``/``device_bitmap``,
  ``extend_seq``, ``write_token`` and ``PoolPages._server_pid`` give the
  reference's values and exceptions.
"""

import inspect
import os
import random
import sys
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis as RA  # noqa: E402
import repro.core as R  # noqa: E402
import repro_torch.analysis as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.fallback import FallbackConnection as R_Fallback  # noqa: E402
from repro_torch.core.fallback import FallbackConnection as T_Fallback  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

PKGS = {
    "ref": SimpleNamespace(core=R, analysis=RA, Fallback=R_Fallback,
                           sandbox=sys.modules["repro.core.sandbox"],
                           scope=sys.modules["repro.core.scope"]),
    "port": SimpleNamespace(core=T, analysis=TA, Fallback=T_Fallback,
                            sandbox=sys.modules["repro_torch.core.sandbox"],
                            scope=sys.modules["repro_torch.core.scope"]),
}
BOTH = pytest.mark.parametrize("pkg", ["ref", "port"])


@pytest.fixture
def shmcheck():
    """A per-test session of the port's sanitizer that fails the test on
    any finding (the port's counterpart of tests/conftest.py's)."""
    with TA.session() as tr:
        yield tr
    if tr.findings:
        lines = "\n".join(str(f) for f in tr.findings)
        pytest.fail(f"ShmCheck findings:\n{lines}", pytrace=False)


def _rules(tr):
    return Counter(f.rule for f in tr.findings)


def _kinds(tr):
    return Counter(rec[0] for rec in tr.events)


def _both(scenario, *, events=True):
    """Run ``scenario(pkg_namespace)`` inside a session of each package's
    own sanitizer. Findings must be equal by rule and count on both, and,
    for a single-threaded scenario (``events``), so must the count of each
    event kind. Returns the port's tracer."""
    trs = {}
    for name, p in PKGS.items():
        with p.analysis.session() as tr:
            scenario(p)
        trs[name] = tr
    assert _rules(trs["port"]) == _rules(trs["ref"]), \
        [str(f) for f in trs["port"].findings]
    if events:
        assert _kinds(trs["port"]) == _kinds(trs["ref"])
        assert trs["port"].n_events == trs["ref"].n_events
    return trs["port"]


def _mk_pair(p, name="svc"):
    orch = p.core.Orchestrator()
    ch = p.core.RPC(orch, pid=100).open(name)
    conn = p.core.RPC(orch, pid=200).connect(name)
    return orch, ch, conn


# ---------------------------------------------------------------------------
# the seeded-bug corpus (tests/test_shmcheck_corpus.py) and its clean twins
# ---------------------------------------------------------------------------
def _leak_at_close(p):
    _, ch, conn = _mk_pair(p)
    conn.create_scope(4096)            # never destroyed
    conn.create_scope(8192)            # the leak
    conn.close()


def test_partial_alloc_leak_at_close_fires_shm104():
    tr = _both(_leak_at_close)
    # both leaks were created at one site (Scope.__init__): one finding
    assert _rules(tr) == {"SHM104": 1}
    # it carries the creation stack, not the close site, and no frame of
    # the tracer itself
    (f,) = tr.findings
    assert any("_leak_at_close" in fr for fr in f.stack)
    assert not any("/repro_torch/analysis/" in fr for fr in f.stack)
    assert "core/scope.py" in f.site


def test_no_leak_when_scopes_are_destroyed():
    def scenario(p):
        _, ch, conn = _mk_pair(p)
        conn.create_scope(4096).destroy()
        conn.close()

    assert not _both(scenario).findings


def _sealed_scope(p):
    h = p.core.SharedHeap(1, 128)
    sm = p.core.SealManager(h)
    sc = p.scope.create_scope(h, 2 * h.page_size)
    idx = sm.seal(sc, holder=7)
    sm.mark_complete(idx)
    return sm, idx


def test_double_release_direct_fires_shm105():
    def scenario(p):
        sm, idx = _sealed_scope(p)
        sm.release(idx, holder=7)
        with pytest.raises(p.core.SealViolation):
            sm.release(idx, holder=7)

    assert _rules(_both(scenario)) == {"SHM105": 1}


def test_release_after_queued_batch_fires_shm105():
    def scenario(p):
        sm, idx = _sealed_scope(p)
        sm.release_batched(idx, holder=7)
        with pytest.raises(p.core.SealViolation):
            sm.release(idx, holder=7)

    assert _rules(_both(scenario)) == {"SHM105": 1}


def test_single_release_and_flush_are_clean():
    def scenario(p):
        sm, idx = _sealed_scope(p)
        sm.release_batched(idx, holder=7)
        sm.flush()
        sm2, idx2 = _sealed_scope(p)
        sm2.release(idx2, holder=7)

    assert not _both(scenario).findings


def _toctou(p, mutate):
    _, ch, conn = _mk_pair(p)
    ch.add(1, lambda ctx, a: len(bytes(ctx.read(a, 4))))
    th = ch.listen_in_thread()
    try:
        sc = conn.create_scope(4096)
        a = sc.alloc(16)
        conn.heap.write(a, b"good", pid=conn.client_pid)
        token = conn.call_async(1, a, scope=sc)          # NOT sealed
        if mutate:                                       # the §4.5 TOCTOU
            conn.heap.write(a, b"evil", pid=conn.client_pid)
        assert conn.wait(token) == 4
    finally:
        ch.stop()
        th.join(timeout=5)


def test_unsealed_midcall_mutation_fires_shm102():
    tr = _both(lambda p: _toctou(p, True), events=False)
    assert _rules(tr) == {"SHM102": 1}


def test_prepost_writes_are_not_flagged():
    assert not _both(lambda p: _toctou(p, False), events=False).findings


def test_recycled_sandbox_key_fires_shm108():
    def scenario(p):
        h = p.core.SharedHeap(1, 512)
        mgr = p.sandbox.SandboxManager(h)
        scope = p.scope.create_scope(h, 2 * h.page_size)
        stale = mgr.enter(*scope.page_range())
        with stale:
            pass
        for _ in range(p.core.MAX_CACHED):     # cycle every key
            s = h.alloc_pages(2)
            with mgr.enter(s, 2):
                pass
        with pytest.raises(p.core.SandboxViolation, match="stale"):
            with stale:
                pass  # pragma: no cover

    assert _rules(_both(scenario)) == {"SHM108": 1}


def test_cached_sandbox_reentry_is_clean():
    def scenario(p):
        h = p.core.SharedHeap(1, 64)
        mgr = p.sandbox.SandboxManager(h)
        s = h.alloc_pages(2)
        for _ in range(3):
            with mgr.enter(s, 2):
                pass
        assert mgr.cache_hits == 2

    assert not _both(scenario).findings


def test_stale_scope_over_recycled_pages_fires_shm103():
    def scenario(p):
        h = p.core.SharedHeap(1, 64)
        sc = p.scope.create_scope(h, 2 * h.page_size)
        sc.alloc(8)
        sc.destroy()
        sc2 = p.scope.create_scope(h, 2 * h.page_size)   # recycles the pages
        assert sc2.page_range() == (0, 2)
        sc.view()

    assert _rules(_both(scenario)) == {"SHM103": 1}


def test_pooled_and_destroyed_scope_use_fires_shm103():
    def scenario(p):
        h = p.core.SharedHeap(1, 64)
        pool = p.scope.ScopePool(h, scope_pages=1)
        s = pool.pop()
        pool.push(s)
        s.view()                                   # through the pool
        d = p.scope.create_scope(h, h.page_size)
        d.destroy()
        with pytest.raises(p.core.InvalidPointer):
            d.alloc(8)                             # through a dead scope

    assert _rules(_both(scenario)) == {"SHM103": 2}


def test_live_scope_use_is_clean():
    def scenario(p):
        h = p.core.SharedHeap(1, 64)
        pool = p.scope.ScopePool(h, scope_pages=1)
        s = pool.pop()
        s.alloc(8)
        s.view()
        pool.push(s)
        s2 = pool.pop()
        assert s2 is s
        s2.alloc(8)
        pool.drain()

    assert not _both(scenario).findings


def test_unsandboxed_wild_pointer_fires_shm107():
    def scenario(p):
        _, ch, conn = _mk_pair(p)
        dead = conn.create_scope(4096)
        bogus = dead.alloc(8)
        dead.destroy()                  # the address points at freed pages
        ch.add(1, lambda ctx, a: len(bytes(ctx.read(bogus, 8))))
        with pytest.raises(p.core.RpcError):
            conn.call_inline(1)

    assert _rules(_both(scenario)) == {"SHM107": 1}


def test_fallback_wild_pointer_fires_shm107():
    def scenario(p):
        fb = p.Fallback(num_pages=256)
        dead = fb.create_scope(4096)
        bogus = dead.alloc(8)
        dead.destroy()
        fb.add(1, lambda ctx, a: len(bytes(ctx.read(bogus, 8))))
        with pytest.raises(p.core.InvalidPointer):
            fb.call(1)
        fb.close()

    assert _rules(_both(scenario))["SHM107"] == 1


def test_valid_unsandboxed_reads_are_clean():
    def scenario(p):
        _, ch, conn = _mk_pair(p)
        sc = conn.create_scope(4096)
        a = sc.write_bytes(b"payload!", pid=conn.client_pid)
        ch.add(1, lambda ctx, x: len(bytes(ctx.read(a, 8))))
        assert conn.call_inline(1) == 8
        assert conn.call_inline(1, a, scope=sc, sealed=True) == 8
        sc.destroy()
        conn.close()

    assert not _both(scenario).findings


def test_inline_typed_calls_futures_and_streams_count_equal_events():
    """The typed plane inline: invokes (plain and sealed) with their reply
    freelist, a stream's chunk chain and consumed word, plain calls, and
    the fallback link's futures, flights and ownership transfers."""
    def gen(ctx, args):
        for i in range(args[0]):
            yield i * 3

    def scenario(p):
        _, ch, conn = _mk_pair(p)
        ch.add(1, lambda ctx, a: len(bytes(ctx.read(a, 32))))
        ch.add_typed(2, lambda ctx, args: sum(args[0]))
        ch.add_typed(3, gen)
        assert conn.invoke(2, [1, 2, 3], inline=True) == 6
        assert conn.invoke(2, [2, 2], sealed=True, inline=True) == 4
        assert list(conn.invoke_stream(3, 4, inline=True)) == [0, 3, 6, 9]
        sc = conn.create_scope(4096)
        a = sc.alloc(32)
        conn.heap.write(a, b"x" * 32, pid=conn.client_pid)
        for _ in range(3):
            assert conn.call_inline(1, a) == 32
        sc.destroy()
        conn.seals.flush()
        conn.close()
        fb = p.Fallback(num_pages=2048)
        fb.add_typed(2, lambda ctx, args: sum(args[0]))
        futs = [fb.invoke_async(2, [i, i]) for i in range(3)]
        fb.flush()
        assert [f.result() for f in futs] == [0, 2, 4]
        assert fb.invoke(2, [2, 2], sealed=True) == 4
        fb.seals.flush()
        fb.close()

    tr = _both(scenario)
    kinds = _kinds(tr)
    for kind in ("acq", "rel", "sync-pages", "dsm-xfer", "seal", "close"):
        assert kinds[kind] > 0, kind


# ---------------------------------------------------------------------------
# zero false positives: tests/test_shmcheck_interleaving.py's drivers
# ---------------------------------------------------------------------------
CXL_OPS = ("call", "sealed", "sealed_batch", "invoke", "invoke_sealed",
           "async_pair", "stream")
FB_OPS = ("invoke", "invoke_sealed", "async_batch")


def _gen(ctx, args):
    for i in range(args[0]):
        yield i * 3


def _drive_cxl(p, ops):
    """Execute ``ops`` against a threaded CXL server; returns findings."""
    core = p.core
    with p.analysis.session() as tr:
        orch = core.Orchestrator()
        ch = core.RPC(orch, pid=1).open("prop")
        ch.add(1, lambda ctx, a: 7)
        ch.add_typed(2, lambda ctx, args: sum(args[0]))
        ch.add_typed(3, _gen)
        conn = core.RPC(orch, pid=2).connect("prop")
        th = ch.listen_in_thread()
        try:
            for op in ops:
                if op == "call":
                    assert conn.call(1) == 7
                elif op in ("sealed", "sealed_batch"):
                    sc = conn.create_scope(4096)
                    a = sc.alloc(32)
                    conn.heap.write(a, b"x" * 32, pid=conn.client_pid)
                    assert conn.call(1, a, scope=sc, sealed=True,
                                     batch_release=(op == "sealed_batch")) == 7
                    sc.destroy()
                elif op == "invoke":
                    assert conn.invoke(2, [1, 2, 3]) == 6
                elif op == "invoke_sealed":
                    assert conn.invoke(2, [2, 2], sealed=True) == 4
                elif op == "async_pair":
                    futs = [conn.invoke_async(2, [i, i]) for i in range(3)]
                    assert [f.result() for f in futs] == [0, 2, 4]
                elif op == "stream":
                    assert list(conn.invoke_stream(3, 4)) == [0, 3, 6, 9]
            conn.seals.flush()
        finally:
            ch.stop()
            th.join(timeout=5)
        conn.close()
    return tr.findings


def _drive_fallback(p, ops):
    with p.analysis.session() as tr:
        fb = p.Fallback(num_pages=2048)
        fb.add_typed(2, lambda ctx, args: sum(args[0]))
        for op in ops:
            if op == "invoke":
                assert fb.invoke(2, [1, 2, 3]) == 6
            elif op == "invoke_sealed":
                assert fb.invoke(2, [2, 2], sealed=True) == 4
            elif op == "async_batch":
                futs = [fb.invoke_async(2, [i, i]) for i in range(3)]
                fb.flush()
                assert [f.result() for f in futs] == [0, 2, 4]
        fb.seals.flush()
        fb.close()
    return tr.findings


def _fmt(findings):
    return "\n".join(str(f) for f in findings)


@BOTH
@pytest.mark.parametrize("seed", range(6))
def test_seeded_cxl_flows_stay_clean(pkg, seed):
    rng = random.Random(seed)
    ops = [rng.choice(CXL_OPS) for _ in range(rng.randint(6, 18))]
    findings = _drive_cxl(PKGS[pkg], ops)
    assert not findings, f"false positives on {ops}:\n{_fmt(findings)}"


@BOTH
@pytest.mark.parametrize("seed", range(4))
def test_seeded_fallback_flows_stay_clean(pkg, seed):
    rng = random.Random(100 + seed)
    ops = [rng.choice(FB_OPS) for _ in range(rng.randint(6, 18))]
    findings = _drive_fallback(PKGS[pkg], ops)
    assert not findings, f"false positives on {ops}:\n{_fmt(findings)}"


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis is not installed")
@BOTH
def test_hypothesis_cxl_flows_stay_clean(pkg):
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.sampled_from(CXL_OPS), min_size=1, max_size=12))
    def check(ops):
        findings = _drive_cxl(PKGS[pkg], ops)
        assert not findings, _fmt(findings)

    check()


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis is not installed")
@BOTH
def test_hypothesis_fallback_flows_stay_clean(pkg):
    @settings(max_examples=15, deadline=None)
    @given(st.lists(st.sampled_from(FB_OPS), min_size=1, max_size=12))
    def check(ops):
        findings = _drive_fallback(PKGS[pkg], ops)
        assert not findings, _fmt(findings)

    check()


# services at module level: a snapshot names its class by path
def _kv_cls(core, qualname):
    @core.service(name="kv")
    class KV:
        def __init__(self):
            self.data = {}

        @core.method(byval=True, retry=3)
        def put(self, ctx, k, v):
            self.data[k] = v
            return v

        @core.method(byval=True, retry=3)
        def get(self, ctx, k):
            return self.data.get(k, -1)

    KV.__name__ = KV.__qualname__ = qualname
    return KV


ShmRefKV, ShmPortKV = _kv_cls(R, "ShmRefKV"), _kv_cls(T, "ShmPortKV")


@BOTH
def test_migrate_is_shmcheck_clean(pkg):
    """tests/test_snapshot_migrate.py:560: a live migration leaves no
    stale-scope or leak finding."""
    p = PKGS[pkg]
    core, KV = p.core, (ShmRefKV if pkg == "ref" else ShmPortKV)
    with p.analysis.session() as tr:
        orch = core.Orchestrator()
        router = core.ClusterRouter(orch)
        ch = core.Channel(orch, "/pod0/kv", server_pid=1, heap_pages=512)
        core.Endpoint.serve(ch, KV())
        router.register("/pod0/kv", ch, pod="pod0")
        orch.assign_pod(1, "pod0")
        stub = router.stub("/pod0/kv", KV, pid=200, pod="pod0")
        for k in range(12):
            stub.put(k, k)
        rep = router.migrate("/pod0/kv", dst_pod="pod0")
        for k in range(12):
            assert stub.get(k) == k
        stub.close()
        rep.restored.close()
    rules = _rules(tr)
    assert "SHM103" not in rules and "SHM104" not in rules, _fmt(tr.findings)


def test_port_fixture_session_attaches_heaps(shmcheck):
    h = T.SharedHeap(1, 16)
    assert h._tracer is shmcheck
    sc = T.create_scope(h, h.page_size)
    sc.write_bytes(b"abc")
    sc.destroy()
    assert _kinds(shmcheck) == {"alloc": 1, "scope+": 1, "w": 1, "free": 1,
                                "scope-": 1}


# ---------------------------------------------------------------------------
# the switch: sanitize=, sessions, REPRO_SANITIZE
# ---------------------------------------------------------------------------
@BOTH
def test_sanitize_off_leaves_no_tracer(pkg, monkeypatch):
    p = PKGS[pkg]
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    # sanitize=True below makes an ambient session: keep it to this test
    monkeypatch.setattr(p.analysis.runtime, "_ambient", None)
    monkeypatch.setattr(p.analysis.runtime, "_stack", [])
    assert p.core.SharedHeap(1, 8)._tracer is None
    with p.analysis.session():
        assert p.core.SharedHeap(1, 8, sanitize=False)._tracer is None
    forced = p.core.SharedHeap(1, 8, sanitize=True)
    assert forced._tracer is p.analysis.runtime.ambient()


def test_each_package_keeps_its_own_sessions(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    with RA.session() as rtr:
        assert T.SharedHeap(1, 8)._tracer is None
        assert R.SharedHeap(1, 8)._tracer is rtr
    with TA.session() as ttr:
        assert R.SharedHeap(1, 8)._tracer is None
        with TA.session(max_events=4) as inner:
            h = T.SharedHeap(1, 8)
            for _ in range(6):
                h.alloc_pages(1)
        assert h._tracer is inner and inner.n_events == 6 and len(inner.events) == 4
        assert T.SharedHeap(1, 8)._tracer is ttr


def test_repro_sanitize_is_the_switch_of_both(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert RA.sanitize_enabled() and TA.sanitize_enabled()
    for off in ("0", "false", "off", ""):
        monkeypatch.setenv("REPRO_SANITIZE", off)
        assert not RA.sanitize_enabled() and not TA.sanitize_enabled()
    # a heap made under the switch attaches to its package's ambient
    # session (fresh per process here: restore it after)
    rt = TA.runtime
    monkeypatch.setattr(rt, "_ambient", None)
    monkeypatch.setattr(rt, "_stack", [])
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    h = T.SharedHeap(1, 8)
    assert h._tracer is rt.ambient() is not None
    assert h._tracer is not RA.runtime.ambient()


def test_rules_report_and_summary_match_reference():
    assert TA.RULES == RA.RULES and sorted(TA.RULES) == [f"SHM10{i}" for i in range(1, 9)]
    trs = {}
    for name, p in PKGS.items():
        with p.analysis.session() as tr:
            _leak_at_close(p)
        trs[name] = tr
    r, t = trs["ref"].report(), trs["port"].report()
    for rep in (r, t):
        for f in rep["findings"]:
            f.pop("stack")
    assert t == r
    assert trs["port"].summary() == trs["ref"].summary()
    with TA.session() as clean:
        T.SharedHeap(1, 8).alloc_pages(1)
    assert clean.summary() == "ShmCheck: clean — 1 events, 1 spaces, 0 findings"
    f = trs["port"].findings[0]
    assert str(f).startswith("SHM104 space=0 page=") and f.dedup_key()[0] == "SHM104"
    assert f.to_dict()["title"] == RA.RULES["SHM104"]


def test_dedup_by_rule_space_and_site():
    with TA.session() as tr:
        h = T.SharedHeap(1, 64)
        sc = T.create_scope(h, h.page_size)
        sc.destroy()
        for _ in range(5):           # one site (Scope.view), five hits
            sc.view()
        with pytest.raises(T.InvalidPointer):
            sc.alloc(8)              # a second site (Scope.alloc)
    assert _rules(tr) == {"SHM103": 2}


def test_stack_elides_the_port_analysis_frames():
    from repro_torch.analysis.findings import _ANALYSIS_DIR, capture_stack
    assert _ANALYSIS_DIR == "/repro_torch/analysis/"
    assert os.path.dirname(TA.__file__).replace("\\", "/").endswith(_ANALYSIS_DIR[:-1])
    stack = capture_stack()
    assert "test_stack_elides_the_port_analysis_frames" in stack[-1]


def test_dsm_replicas_share_one_space():
    with TA.session() as tr:
        fb = T_Fallback(num_pages=64)
        link = fb.link
        assert link.replica[0]._shm_space == link.replica[1]._shm_space
        fb.close()
    assert not tr.findings


# ---------------------------------------------------------------------------
# the leftovers of core/, held on both packages
# ---------------------------------------------------------------------------
@BOTH
def test_temp_heap_malloc_is_lost_across_enters(pkg):
    p = PKGS[pkg]
    h = p.core.SharedHeap(1, 64)
    sm = p.sandbox.SandboxManager(h, temp_heap_bytes=256)
    pg = h.alloc_pages(1)
    with sm.enter(pg, 1) as sb:
        mv = sb.malloc(64)
        mv[:4] = b"abcd"
        assert sb.temp.bump == 64
        with pytest.raises(p.core.SandboxViolation, match="exhausted"):
            sb.malloc(256)
    assert sb.temp.bump == 0
    with pytest.raises(p.core.SandboxViolation, match="outside"):
        sb.malloc(8)
    with sm.enter(pg, 1) as sb2:           # contents lost, bump reset
        assert sb2.temp is sb.temp and len(sb2.malloc(64)) == 64


@BOTH
def test_copied_private_vars(pkg):
    p = PKGS[pkg]
    h = p.core.SharedHeap(1, 64)
    sm = p.sandbox.SandboxManager(h)
    pg = h.alloc_pages(1)
    with sm.enter(pg, 1, secret=b"k3y", other=bytearray(b"xy")) as sb:
        assert sb.var("secret") == b"k3y" and sb.var("other") == b"xy"
        assert sb.temp.bump == 10   # 3 bytes, aligned to 8, then 2
        with pytest.raises(p.core.SandboxViolation, match="not copied"):
            sb.var("missing")


def _leftover_values(p):
    core, C = p.core, p.core.containers
    h = core.SharedHeap(3, 64, page_size=256)
    s = core.create_scope(h, 4 * h.page_size)
    doc = {"id": 1, "name": "x" * 100,
           "items": [{"q": i, "w": float(i)} for i in range(4)],
           "a": {"b": {"c": 41}}, "d": "no"}
    root = C.build_doc(s, doc)
    with pytest.raises(TypeError, match="root must be a dict"):
        C.build_doc(s, [1, 2])
    u64 = s.write_u64([1, 2**64 - 1, 7])
    view = s.view()
    mgr = p.sandbox.SandboxManager(h)
    pages = [h.alloc_pages(2) for _ in range(3)]
    sbs = [mgr.enter(pg, 2) for pg in pages]
    mgr.enter(pages[0], 2)
    bitmap = sbs[1].device_bitmap()
    return dict(
        doc=C.to_python(h, (C.T_MAP, root)),
        hit=C.doc_matches(h, root, ["a", "b", "c"], lambda v: v == 41),
        miss=C.doc_matches(h, root, ["a", "b", "zzz"], lambda v: True),
        through_leaf=C.doc_matches(h, root, ["d", "e"], lambda v: True),
        items=C.doc_matches(h, root, ["items"], lambda v: len(v) == 4),
        u64=(u64, bytes(h.read(u64, 24))),
        view=(view.shape, bytes(view[:64]), view.base is h.buf or
              np.shares_memory(view, h.buf)),
        used=(h.used_bytes(), h.used_pages() * h.page_size, s.used_bytes()),
        cached=mgr.cached_regions(),
        bitmap=np.asarray(bitmap).tolist(),
        bitmap_np=mgr._bitmap_for(sbs[1]).tolist(),
        page_size=sbs[1].page_size,
        noaccess=core.heap.PERM_NOACCESS,
        heap_repr=repr(h),
        scope_repr=repr(s),
        buf=bytes(h.buf),
    )


def test_leftovers_give_the_reference_values():
    ref, port = _leftover_values(PKGS["ref"]), _leftover_values(PKGS["port"])
    assert port == ref
    assert port["hit"] and not port["miss"] and not port["through_leaf"]
    assert port["noaccess"] == 2 and port["cached"] == 3
    assert port["bitmap"] == [0] * 6 + [1, 1] + [0] * 56
    assert port["heap_repr"].startswith("<SharedHeap heap3 pages=10/64")


@BOTH
def test_device_bitmap_is_the_managers_array(pkg):
    """As in the reference: the manager's own uint8 numpy table for the
    sandbox's key, 1 on the sandbox's pages and 0 elsewhere."""
    p = PKGS[pkg]
    h = p.core.SharedHeap(1, 16)
    mgr = p.sandbox.SandboxManager(h)
    h.alloc_pages(2)
    start = h.alloc_pages(3)
    bm = mgr.enter(start, 3).device_bitmap()
    assert isinstance(bm, np.ndarray) and bm.dtype == np.uint8
    assert bm is mgr._bitmap_for(mgr.enter(start, 3))
    assert np.flatnonzero(bm).tolist() == list(range(start, start + 3))


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------
PORTED = {
    "analysis": ["Finding", "Tracer", "maybe_attach", "sanitize_enabled", "session"],
    "analysis.findings": ["capture_stack", "Finding.dedup_key", "Finding.to_dict"],
    "analysis.hb": ["HBGraph.__init__", "HBGraph.clock", "HBGraph.tick",
                    "HBGraph.release", "HBGraph.acquire", "RaceDetector.__init__",
                    "RaceDetector.release", "RaceDetector.acquire",
                    "RaceDetector.reset_pages", "RaceDetector.access"],
    "analysis.runtime": ["current", "push", "pop", "ambient", "_ensure_ambient"],
    "analysis.tracer": [
        f"Tracer.{m}" for m in (
            "__init__", "register_heap", "alias_space", "_report", "_event",
            "_data_pages", "on_write", "on_read", "sync_pages", "_race_finding",
            "checked_deref", "checked_deref_node", "sync_release", "sync_acquire",
            "on_alloc", "on_free", "on_protect", "on_unprotect", "reset_pages",
            "on_scope_create", "on_scope_destroy", "on_pool_pop", "on_pool_push",
            "on_scope_use", "on_seal", "on_seal_check", "on_seal_complete",
            "on_seal_release", "on_seal_flush", "on_double_release",
            "on_sandbox_enter", "on_sandbox_exit", "on_sandbox_stale",
            "on_conn_close", "report", "summary")] + ["_ScopeRec.__init__"],
    "core.heap": ["SharedHeap.__init__", "SharedHeap.used_bytes"],
    "core.scope": ["Scope.write_u64", "Scope.view"],
    "core.sandbox": ["_TempHeap.__init__", "_TempHeap.reset", "_TempHeap.alloc",
                     "Sandbox.__init__", "Sandbox.malloc", "Sandbox.var",
                     "Sandbox.device_bitmap", "SandboxManager.__init__",
                     "SandboxManager.enter", "SandboxManager._bitmap_for",
                     "SandboxManager.cached_regions"],
    "core.containers": ["build_doc", "doc_matches"],
    "serving.kv_pool": ["PagedKVPool.extend_seq", "PagedKVPool.write_token",
                        "PoolPages._server_pid"],
}


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


def test_page_size_is_a_property_on_both():
    for root in ("repro", "repro_torch"):
        assert isinstance(_resolve(root, "core.sandbox", "Sandbox").page_size, property)


# ---------------------------------------------------------------------------
# the KV pool's leftovers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pools():
    """A yi_9b smoke-size pool of each package, on fresh orchestrators."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.serving import PagedKVPool as JaxPool
    from repro.serving import PoolConfig as JaxPoolConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import PagedKVPool, PoolConfig

    def make(name, num_pages=32):
        pc = dict(num_pages=num_pages, page_tokens=8, max_pages_per_seq=6)
        if name == "ref":
            return JaxPool(R.Orchestrator(), jax_smoke("yi_9b"), JaxPoolConfig(**pc), 1)
        return PagedKVPool(T.Orchestrator(), get_smoke_config("yi_9b"),
                           PoolConfig(**pc), 1, device="cpu")
    return make


def _extend_scenario(pool, core):
    out = []
    pages = pool.alloc_seq(5, 7)
    same = pool.extend_seq(pages, 8, 7)               # fits: no growth
    out.append((same is pages, list(pages)))
    pool.extend_seq(pages, 30, 7)                     # 4 pages
    out.append(list(pages))
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        pool.extend_seq(pages, 49, 7)
    pool.orch.set_page_quota(7, 5)
    with pytest.raises(core.Overloaded) as e:
        pool.extend_seq(pages, 48, 7)
    out.append((list(pages), e.value.retry_after_s, str(e.value)))
    pool.orch.set_page_quota(7, None)
    # exhaust the heap so the growth fails midway: the list comes back
    while pool.heap.free_pages() > 1:
        pool.heap.alloc_pages(1, owner=99)
    free0, before = pool.heap.free_pages(), list(pages)
    with pytest.raises(core.AllocationError):
        pool.extend_seq(pages, 48, 7)
    out.append((pages == before, pool.heap.free_pages() == free0, free0))
    return out


def test_extend_seq_grows_sheds_and_rolls_back_as_the_reference(pools):
    got = {name: _extend_scenario(pools(name), core)
           for name, core in (("ref", R), ("port", T))}
    assert got["port"] == got["ref"]
    first = got["port"][0][1]
    assert len(first) == 1 and got["port"][1] == [first[0] + i for i in range(4)]


def test_write_token_is_bitwise_the_reference(pools):
    import jax.numpy as jnp

    ref, port = pools("ref"), pools("port")
    L, P, Tk, Hkv, D = port.k.shape
    B, MAXP = 3, 6
    rng = np.random.default_rng(11)
    tab = rng.permutation(P)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    pos = np.array([0, 13, 41], np.int32)
    kn = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((L, B, Hkv, D)).astype(np.float32)
    ref.write_token(jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(tab), jnp.asarray(pos))
    port.write_token(torch.from_numpy(kn), torch.from_numpy(vn),
                     torch.from_numpy(tab), torch.from_numpy(pos))
    assert port.k.dtype == torch.bfloat16
    page, slot = tab[np.arange(B), pos // Tk], pos % Tk
    for got, want in ((port.k, ref.k), (port.v, ref.v)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        np.testing.assert_array_equal(got, want)       # whole pool, bitwise
        assert np.abs(got[:, page, slot]).min() > 0    # the slots were written
        assert np.count_nonzero(got.reshape(L, P * Tk, -1).any(-1)) == L * B


@pytest.mark.parametrize("conn", ["bare", "routed_bare"])
def test_server_pid_raises_channel_error_as_the_reference(pools, conn):
    from repro.serving.kv_pool import PoolPages as JaxPoolPages
    from repro_torch.serving import PoolPages

    link = object()
    c = (SimpleNamespace(transport="fallback", link=link) if conn == "bare"
         else SimpleNamespace(transport="fallback",
                              target=SimpleNamespace(link=link)))
    got = {}
    for name, cls, exc in (("ref", JaxPoolPages, R.ChannelError),
                           ("port", PoolPages, T.ChannelError)):
        with pytest.raises(exc) as e:
            cls(pools(name), [3, 4]).__byref_resolve__(c)
        got[name] = (type(e.value).__name__, str(e.value))
    assert got["port"] == got["ref"]
    assert got["port"][0] == "ChannelError" and "server pid" in got["port"][1]


def test_server_pid_reads_a_routed_target(pools):
    from repro_torch.serving import PoolPages

    pp = PoolPages(pools("port"), [1])
    assert pp._server_pid(SimpleNamespace(server_pid=4)) == 4
    assert pp._server_pid(SimpleNamespace(target=SimpleNamespace(server_pid=9))) == 9
