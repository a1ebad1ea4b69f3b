"""The port's serving engine over its RPC plane against the reference
engine: the prefill → decode handoff through ``stub.attach`` on the
shared-memory ring, ``decode.generate_stream`` over reply chains (inline
and from a ``ServerLoop`` thread), the ``PoolPages`` byref handoff in
pod and across pods, and a client in another pod streaming and posting
``attach_remote`` futures over the fallback link. Scenarios follow
tests/test_serving.py (:64, :122, :160), tests/test_serve_batching.py
(:104, :143, :185-236, :266, :291, :315) and tests/test_streaming.py
(:438). Both engines run the 2-layer smoke yi-9b on the same fp32 weights
and prompts, so tokens must be equal exactly; handoff bytes, page ids,
seal indices, migrated bytes and link counters must be equal too."""

import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.errors import ChannelError as JaxChannelError  # noqa: E402
from repro.core.errors import Overloaded as JaxOverloaded  # noqa: E402
from repro.core.fallback import DSMLink as JaxLink  # noqa: E402
from repro.core.marshal import gather as R_gather  # noqa: E402
from repro.core.orchestrator import Orchestrator as JaxOrchestrator  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import PagedKVPool as JaxPool  # noqa: E402
from repro.serving import PoolConfig as JaxPoolConfig  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving.kv_pool import PoolPages as JaxPoolPages  # noqa: E402
from repro.serving.kv_pool import transfer_pages_cross_pod as jax_transfer  # noqa: E402
from repro.serving.paged_model import prefill_kv as jax_prefill  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.errors import ChannelError, Overloaded  # noqa: E402
from repro_torch.core.fallback import DSMLink  # noqa: E402
from repro_torch.core.marshal import gather as T_gather  # noqa: E402
from repro_torch.core.orchestrator import Orchestrator  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (FN_ATTACH, DecodeService, PagedKVPool,  # noqa: E402
                                 PoolConfig, PoolPages, Request, ServeEngine,
                                 prefill_kv, transfer_pages_cross_pod)

FP32 = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def lm():
    """The smoke yi-9b (2 layers) on both packages, fp32 weights from one
    seed: a faithful port gives the same tokens, not near-ties."""
    jcfg, tcfg = jax_smoke("yi_9b"), get_smoke_config("yi_9b")
    assert jcfg.num_layers == tcfg.num_layers == 2
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tm = build_model(tcfg).load_params(p32, device="cpu").float()
    return jcfg, jax.tree.map(jnp.asarray, p32), tcfg, tm


def _pool(num_pages=64, page_tokens=8, maxp=8):
    return dict(num_pages=num_pages, page_tokens=page_tokens,
                max_pages_per_seq=maxp)


def _engines(lm, pool=None, **kw):
    jcfg, params, tcfg, tm = lm
    pc = pool or _pool()
    je = JaxEngine(jcfg, params, JaxPoolConfig(**pc), backend="ref", **kw)
    te = ServeEngine(tcfg, tm, PoolConfig(**pc), device="cpu", **kw)
    return {"ref": je, "port": te}


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, size=int(rng.integers(3, 20)))]
            for _ in range(n)]


def _alloc_stats(pool):
    """heap.stats() minus the monotonic epoch counter."""
    st = dict(pool.heap.stats())
    st.pop("perm_epoch", None)
    return st


def _prefill_pages(eng, pool, owner, prompt, max_new):
    """Prefill ``prompt`` into fresh pages of ``pool``; returns (pages,
    first token), on either package."""
    pages = pool.alloc_seq(len(prompt) + max_new, owner)
    if isinstance(eng, ServeEngine):
        logits, k, v = prefill_kv(eng.model, torch.tensor([prompt], dtype=torch.int32))
        first = int(logits[0].argmax())
    else:
        logits, k, v = jax_prefill(eng.model, eng.params, jnp.asarray([prompt], jnp.int32))
        first = int(jnp.argmax(logits[0]))
    pool.write_prefill(k[:, 0], v[:, 0], pages, len(prompt))
    return pages, first


def test_fp32_prefill_logits_match_reference(lm):
    jcfg, params, tcfg, tm = lm
    engs = _engines(lm)
    for prompt in _prompts(3, seed=4):
        lj, kj, _ = jax_prefill(engs["ref"].model, params, jnp.asarray([prompt], jnp.int32))
        lt, kt, _ = prefill_kv(tm, torch.tensor([prompt], dtype=torch.int32))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FP32)
        np.testing.assert_allclose(kt.float().numpy(), np.asarray(kj, np.float32), **FP32)


# -- the handoff over the ring (tests/test_serving.py:64) ----------------------
def test_global_quota_pages_is_the_engines_default(lm, monkeypatch):
    """``global_config.quota_pages`` is the engine's page quota when the
    constructor is given none, and an explicit ``quota_pages`` wins."""
    monkeypatch.setattr(sys.modules["repro.configs.global_config"].global_config,
                        "quota_pages", 2)
    monkeypatch.setattr(sys.modules["repro_torch.configs.global_config"].global_config,
                        "quota_pages", 2)
    got, wides = {}, _engines(lm, quota_pages=5)
    for name, eng in _engines(lm).items():
        with pytest.raises((JaxOverloaded, Overloaded), match="quota") as err:
            list(eng.generate_tokens(list(range(1, 20)), 4))   # needs 3 pages
        wide = wides[name]
        got[name] = (eng.orch.page_quota(eng.conn_id), type(err.value).__name__,
                     wide.orch.page_quota(wide.conn_id),
                     len(list(wide.generate_tokens(list(range(1, 20)), 4))),
                     _alloc_stats(eng.pool), _alloc_stats(wide.pool))
        eng.shutdown()
        wide.shutdown()
    assert got["port"] == got["ref"]
    assert got["port"][:4] == (2, "Overloaded", 5, 4)


def test_handoff_is_pointer_sized_and_matches_reference(lm):
    """``_handoff`` goes through ``stub.attach`` over a "cxl" connection:
    the marshalled pointer set is under 200 bytes a request, byte for byte
    the reference's, with equal tokens, page ids and seal indices."""
    engs = _engines(lm, max_active=3)
    prompts = _prompts(4) + [list(range(1, 17))]
    out = {}
    for name, eng in engs.items():
        assert eng.conn.transport == "cxl"
        free0 = eng.pool.heap.free_pages()
        rids = [eng.submit(p, 6) for p in prompts]
        eng.run_until_drained()
        reqs = [eng.finished[r] for r in rids]
        out[name] = ([r.out for r in reqs], [r.pages for r in reqs],
                     [r.seal_idxs for r in reqs], eng.handoff_bytes,
                     eng.decode_steps, eng.conn.target.n_invokes)
        assert eng.pool.stats()["sealed_pages"] == 0
        assert eng.pool.heap.free_pages() == free0
    assert out["port"] == out["ref"]
    handoff = out["port"][3]
    assert handoff < 200 * len(prompts)
    cfg = lm[2]
    kv_bytes = 2 * cfg.num_layers * 16 * cfg.num_kv_heads * cfg.head_dim * 2
    assert kv_bytes > 10 * handoff / len(prompts)
    assert engs["port"].oob_events == 0


# -- decode.generate_stream over the ring (tests/test_serving.py:122) --------
def test_generate_stream_over_the_ring_matches_reference(lm):
    engs = _engines(lm)
    prompt = [5, 6, 7, 8]
    out = {}
    for name, eng in engs.items():
        rid = eng.submit(prompt, max_new=6)
        eng.run_until_drained()
        free0 = eng.pool.heap.free_pages()
        streamed = list(eng.stub.generate_stream.stream(prompt, 6, inline=True))
        assert streamed == eng.result(rid)
        assert eng.pool.heap.free_pages() == free0
        assert eng.pool.stats()["sealed_pages"] == 0
        assert list(eng.generate_tokens(prompt, max_new=0)) == []
        out[name] = (streamed, eng.stream_steps, eng.conn.marshal_bytes)
    assert out["port"] == out["ref"]


# -- zero-copy vs the fallback's bytes (tests/test_serving.py:160) -----------
def test_zero_copy_vs_fallback_bytes_and_link_counters(lm):
    """A cross-pod transfer charged to the link moves L·n pages of K and
    V, one one-sided put of those bytes plus its completion word: equal
    on both packages, and ≫ the pointer bytes the CXL route passes."""
    jcfg, _, tcfg, _ = lm
    pc = _pool(num_pages=32)
    out = {}
    for name, (Orch, Pool, Cfg, transfer, Link, cfg) in {
            "ref": (JaxOrchestrator, JaxPool, JaxPoolConfig,
                    lambda *a, **k: jax_transfer(*a, backend="ref", **k), JaxLink, jcfg),
            "port": (Orchestrator, PagedKVPool, PoolConfig, transfer_pages_cross_pod,
                     DSMLink, tcfg)}.items():
        orch = Orch()
        kw = {"device": "cpu"} if name == "port" else {}
        src = Pool(orch, cfg, Cfg(**pc), 1, **kw)
        dst = Pool(orch, cfg, Cfg(**pc), 2, **kw)
        link = Link(64, link_latency_us=0.0)
        moved = transfer(src, dst, [3, 9], [4, 5], link=link)
        out[name] = (moved, link.bytes_moved, link.n_puts, link.msgs,
                     link.completion.tolist(), src.byref_bytes_out, dst.byref_bytes_in)
    assert out["port"] == out["ref"]
    moved = out["port"][0]
    assert out["port"][1] == moved + 8 and moved / (8 * 2) > 100


# -- stream shed with retry-after (tests/test_serve_batching.py:104) ---------
def test_stream_shed_carries_retry_after_over_the_ring(lm):
    engs = _engines(lm, pool=_pool(num_pages=16, maxp=16))
    out = {}
    for name, eng in engs.items():
        shed_type = Overloaded if name == "port" else JaxOverloaded
        f0 = eng.pool.heap.free_pages()
        hog_new = (f0 - 2) * eng.pool.pc.page_tokens - 3
        ga = eng.generate_tokens([1, 2, 3], hog_new)
        next(ga)
        assert eng.pool.heap.free_pages() == 2
        with pytest.raises(shed_type) as e:
            list(eng.stub.generate_stream.stream([4, 5, 6, 7], 17, inline=True))
        ga.close()
        retry = list(eng.stub.generate_stream.stream([4, 5, 6, 7], 17, inline=True))
        assert eng.pool.heap.free_pages() == f0
        out[name] = (f0, e.value.retry_after_s, eng.shed_admits, retry)
    assert out["port"] == out["ref"]
    assert out["port"][1] == 0.02 and len(out["port"][3]) == 17


# -- threaded client streams (tests/test_serve_batching.py:143) --------------
def _client_streams(eng, prompts, max_new, service):
    outs, errors = [None] * len(prompts), []
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            stub = eng.router.stub(eng.endpoint_name, service, pid=30 + i, pod="pod0")
            barrier.wait()
            outs[i] = list(stub.generate_stream.stream(prompts[i], max_new, timeout=60.0))
        except Exception as e:   # surfaced below
            errors.append((i, e))
            barrier.abort()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
        assert not t.is_alive(), "client thread wedged"
    assert not errors, f"client failures: {errors!r}"
    return outs


def test_threaded_client_streams_match_solo_and_reference(lm):
    """Three client threads, each with its own stub, stream through one
    threaded decode worker: every stream equals its solo run and the
    reference's; ``shutdown()`` stops the serving thread and nothing
    leaks."""
    engs = _engines(lm, serve_threaded=True, max_active=4)
    prompts = [[i + 1, i + 2, i + 3] for i in range(3)]
    out = {}
    for name, eng in engs.items():
        thread = eng.serve_loop._thread
        try:
            refs = [list(eng.generate_tokens(p, 12)) for p in prompts]
            free0 = eng.pool.heap.free_pages()
            service = DecodeService if name == "port" else jax_engine.DecodeService
            outs = _client_streams(eng, prompts, 12, service)
            assert outs == refs
            assert eng.scheduler.slots == []
            assert eng.pool.heap.free_pages() == free0
        finally:
            eng.shutdown()
        thread.join(timeout=10.0)
        assert not thread.is_alive()
        assert eng.pool.stats()["sealed_pages"] == 0
        out[name] = outs
    assert out["port"] == out["ref"]


def test_threaded_submit_handoffs_cross_threads(lm):
    """The batched plane with a serving thread: ``stub.attach`` crosses
    from the caller's thread to the ServerLoop thread."""
    engs = _engines(lm, serve_threaded=True, max_active=2)
    out = {}
    for name, eng in engs.items():
        try:
            rids = [eng.submit(p, 5) for p in _prompts(3, seed=2)]
            eng.run_until_drained(timeout=60.0)
        finally:
            eng.shutdown()
        assert eng.serve_loop is None
        out[name] = ([eng.result(r) for r in rids], eng.handoff_bytes)
    assert out["port"] == out["ref"]


def test_threaded_streams_beside_submits_share_the_seal_manager(lm):
    """Mixed traffic on the port's threaded engine: client streams admit,
    seal and release on the ServerLoop thread while the caller's thread
    submits, seals in ``_handoff`` and drains. Both seal the one pool
    SealManager under the engine lock, so every seal index is minted
    once, every stream and request matches its solo run, and no page or
    seal is left."""
    _, _, tcfg, tm = lm
    pc = PoolConfig(**_pool(num_pages=96))
    solo = ServeEngine(tcfg, tm, pc, max_active=4, device="cpu")
    eng = ServeEngine(tcfg, tm, pc, max_active=4, serve_threaded=True,
                      device="cpu")
    stream_prompts = [[i + 1, i + 2, i + 3] for i in range(3)]
    submit_prompts = _prompts(4, seed=6)
    stream_refs = [list(solo.generate_tokens(p, 10)) for p in stream_prompts]
    rids = [solo.submit(p, 6) for p in submit_prompts]
    solo.run_until_drained()
    submit_refs = [solo.result(r) for r in rids]

    # every mutation of the seal state, instrumented: a call that starts
    # while another thread is inside one is an overlap; each holds its
    # section a little longer, so an unlocked caller would race into it
    minted, inside, overlaps, lock = [], [], [], threading.Lock()

    def instrument(obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            with lock:
                if inside:
                    overlaps.append((name, list(inside)))
                inside.append(name)
            try:
                time.sleep(5e-3)
                out = fn(*a, **kw)
                if name == "seal_seq":
                    minted.extend(out)
                return out
            finally:
                with lock:
                    inside.remove(name)

        setattr(obj, name, wrapped)

    instrument(eng.pool, "seal_seq")
    instrument(eng.pool, "complete_and_release")
    instrument(eng.pool.seals, "flush")
    thread = eng.serve_loop._thread
    free0 = eng.pool.heap.free_pages()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        streams = {}
        t = threading.Thread(
            target=lambda: streams.update(
                out=_client_streams(eng, stream_prompts, 10, DecodeService)),
            daemon=True)
        t.start()
        rids = [eng.submit(p, 6) for p in submit_prompts]
        eng.run_until_drained(timeout=60.0)
        t.join(timeout=120.0)
        assert not t.is_alive(), "stream clients wedged"
    finally:
        sys.setswitchinterval(switch)
        eng.shutdown()
    thread.join(timeout=10.0)
    assert not thread.is_alive()
    assert streams["out"] == stream_refs
    assert [eng.result(r) for r in rids] == submit_refs
    assert overlaps == []
    assert len(minted) == len(set(minted)) > 0
    assert eng.scheduler.slots == [] and eng._pending_attach == {}
    assert eng.pool.heap.free_pages() == free0
    assert eng.pool.stats()["sealed_pages"] == 0
    assert eng.pool.seals._pending == []


# -- the attach table through the stub (tests/test_serve_batching.py:185-236)
def test_attach_table_through_the_stub(lm):
    engs = _engines(lm, max_active=4)
    out = {}
    for name, eng in engs.items():
        Req = Request if name == "port" else jax_engine.Request
        err = ChannelError if name == "port" else JaxChannelError
        reqs = []
        for prompt in ([1, 2, 3], [4, 5, 6]):
            req = Req(eng._mint_rid(), list(prompt), 4)
            req.pages = eng.pool.alloc_seq(len(prompt) + 4, eng.conn_id)
            req.out = [1]
            req.pos = len(prompt)
            eng._pending_attach[req.rid] = req
            reqs.append(req)
        for req in reversed(reqs):             # land out of order
            eng._handoff(req)
        assert [r.rid for r in eng.active] == [reqs[1].rid, reqs[0].rid]
        assert eng._pending_attach == {}
        eng.run_until_drained()
        with pytest.raises(err):
            eng.stub.attach(999, 4, [1, 2], timeout=5.0, inline=True)
        forged = Req(eng._mint_rid(), [1, 2, 3], 4)
        forged.pages = eng.pool.alloc_seq(7, eng.conn_id)
        eng._pending_attach[forged.rid] = forged
        with pytest.raises(err):
            eng.stub.attach(forged.rid, 3, [(p + 1) % 64 for p in forged.pages],
                            timeout=5.0, inline=True)
        assert eng.active == []
        eng.pool.free_seq(forged.pages)
        out[name] = ([eng.result(r.rid) for r in reqs], [r.seal_idxs for r in reqs],
                     eng.handoff_bytes)
    assert out["port"] == out["ref"]


# -- a fault in the attach RPC (tests/test_serve_batching.py:266) ------------
def test_handoff_fault_releases_seals_and_pages(lm):
    engs = _engines(lm)
    out = {}
    for name, eng in engs.items():
        base = _alloc_stats(eng.pool)
        fn_id = FN_ATTACH if name == "port" else jax_engine.FN_ATTACH
        orig = eng.channel.functions[fn_id]

        def boom(ctx, arg):
            raise RuntimeError("injected attach fault")

        eng.channel.functions[fn_id] = boom
        try:
            rid = eng.submit([1, 2, 3, 4], max_new=4)
            assert eng._admit() == 0
            assert eng._pending_attach == {} and eng.queue
            assert _alloc_stats(eng.pool) == base
        finally:
            eng.channel.functions[fn_id] = orig
        eng.run_until_drained()
        out[name] = (eng.result(rid), eng.pool.seals._next_seq)
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 4


# -- byref handoff in pod and across pods (tests/test_serve_batching.py:291, :315)
def test_same_pod_byref_is_pointer_passing(lm):
    engs = _engines(lm)
    prompt = [5, 6, 7, 8]
    out = {}
    for name, eng in engs.items():
        ref = list(eng.generate_tokens(prompt, 6))
        pages, first = _prefill_pages(eng, eng.pool, eng.conn_id, prompt, 6)
        pp = PoolPages(eng.pool, pages) if name == "port" else \
            JaxPoolPages(eng.pool, pages, backend="ref")
        b0 = eng.conn.marshal_bytes
        eng.stub.attach_remote(7001, prompt, first, 6, pp, timeout=10.0, inline=True)
        assert pp.last_moved_bytes == 0 and eng.pool.byref_bytes_in == 0
        assert [r.rid for r in eng.active] == [7001]
        assert eng.active[0].pages == pages    # the SAME pages
        seals = list(eng.active[0].seal_idxs)
        eng.run_until_drained()
        assert eng.result(7001) == ref
        out[name] = (ref, pages, seals, eng.conn.marshal_bytes - b0)
    assert out["port"] == out["ref"]


def test_cross_pod_byref_migrates_once_and_accounts_bytes(lm):
    """Prefill in pod ``ppod``, decode in ``dpod``, the same stub surface:
    the byref argument moves the KV once (one gather and one scatter per
    tensor, one put on the link), byte counts equal pages × page_bytes on
    both pools and on the link (plus its completion word), and the tokens
    equal the same-pod generation exactly."""
    jcfg, _, tcfg, _ = lm
    engs = _engines(lm, pod="dpod")
    prompt = [5, 6, 7, 8]
    out = {}
    for name, eng in engs.items():
        ref = list(eng.generate_tokens(prompt, 6))
        if name == "port":
            src = PagedKVPool(eng.orch, tcfg, eng.pool.pc, 21, pod="ppod", device="cpu")
            stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=21, pod="ppod")
        else:
            src = JaxPool(eng.orch, jcfg, eng.pool.pc, owner_pid=21, pod="ppod")
            stub = eng.router.stub(eng.endpoint_name, jax_engine.DecodeService,
                                   pid=21, pod="ppod")
        assert stub.connection.transport == "fallback"
        link = stub.connection.target.link
        pages, first = _prefill_pages(eng, src, 21, prompt, 6)
        dst_free0 = eng.pool.heap.free_pages()
        pp = PoolPages(src, pages) if name == "port" else \
            JaxPoolPages(src, pages, backend="ref")
        b0, p0 = link.bytes_moved, link.n_puts
        stub.attach_remote(7002, prompt, first, 6, pp, timeout=10.0)
        expected = len(pages) * src.page_bytes
        assert pp.last_moved_bytes == src.byref_bytes_out == expected
        assert eng.pool.byref_bytes_in == expected
        assert link.n_puts - p0 == 1
        dst_pages = list(eng.active[0].pages)
        assert eng.pool.heap.free_pages() == dst_free0 - len(pages)
        eng.run_until_drained()
        assert eng.result(7002) == ref         # the migrated KV decodes the same
        assert eng.pool.heap.free_pages() == dst_free0
        assert eng.pool.stats()["sealed_pages"] == 0
        src.free_seq(pages)
        out[name] = (ref, pages, dst_pages, expected, link.bytes_moved - b0,
                     stub.connection.marshal_bytes)
    assert out["port"] == out["ref"]


# -- decode.generate_stream across pods (the fallback link's staged chunk
# flights; tests/test_streaming.py:438 on the served model) ------------------
@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_cross_pod_generate_stream_matches_reference(lm, threaded):
    """A client in pod ``pod9`` streams from the engine in ``pod0``: the
    stub rides the fallback link, the tokens equal the in-pod generation,
    and the link's counters equal the reference engine's for the same
    weights and calls. Pages and seals all come back."""
    engs = _engines(lm, pool=_pool(num_pages=32), serve_threaded=threaded)
    prompt = [3, 4, 5, 6]
    out = {}
    for name, eng in engs.items():
        service = DecodeService if name == "port" else jax_engine.DecodeService
        try:
            solo = list(eng.generate_tokens(prompt, 6))
            free0 = eng.pool.heap.free_pages()
            stub = eng.router.stub(eng.endpoint_name, service, pid=77, pod="pod9")
            assert stub.connection.transport == "fallback"
            toks = list(stub.generate_stream.stream(prompt, 6, timeout=60.0))
            again = list(stub.generate_stream.stream(prompt[:3], 4, window=2,
                                                     timeout=60.0))
            assert eng.pool.heap.free_pages() == free0
            assert eng.pool.stats()["sealed_pages"] == 0
            assert eng.scheduler.slots == []
            target = stub.connection.target
            out[name] = (toks, solo, again, target.stats(), target.n_stream_flights,
                         stub.connection.marshal_bytes, eng.stream_steps)
        finally:
            if threaded:
                eng.shutdown()
    assert out["port"] == out["ref"]
    toks, solo = out["port"][:2]
    assert toks == solo and len(toks) == 6


def test_cross_pod_attach_remote_futures_gather_like_the_reference(lm):
    """Three prefills in pod ``ppod`` hand off to the decode worker in
    ``dpod`` as ``attach_remote.future`` calls settled by one ``gather``:
    one staged flight, one window seal flush, one put a KV transfer; the
    decoded tokens equal the in-pod generation, and results, link
    counters, page ids and seals equal the reference's."""
    jcfg, _, tcfg, _ = lm
    engs = _engines(lm, pod="dpod")
    prompts = [[3, 4, 5, 6], [7, 8, 9], [10, 11, 12, 13, 14]]
    out = {}
    for name, eng in engs.items():
        if name == "port":
            src = PagedKVPool(eng.orch, tcfg, eng.pool.pc, 21, pod="ppod", device="cpu")
            stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=21, pod="ppod")
            gather = T_gather
        else:
            src = JaxPool(eng.orch, jcfg, eng.pool.pc, owner_pid=21, pod="ppod")
            stub = eng.router.stub(eng.endpoint_name, jax_engine.DecodeService,
                                   pid=21, pod="ppod")
            gather = R_gather
        refs = [list(eng.generate_tokens(p, 6)) for p in prompts]
        dst_free0 = eng.pool.heap.free_pages()
        futs, src_pages = [], []
        for i, prompt in enumerate(prompts):
            pages, first = _prefill_pages(eng, src, 21, prompt, 6)
            pp = PoolPages(src, pages) if name == "port" else \
                JaxPoolPages(src, pages, backend="ref")
            futs.append(stub.attach_remote.future(8000 + i, prompt, first, 6, pp))
            src_pages.append(pages)
        target = stub.connection.target
        staged = (target.n_flushes, len(target._flight))
        results = gather(futs, timeout=30.0)
        adopted = [list(r.pages) for r in eng.active]
        seals = [list(r.seal_idxs) for r in eng.active]
        eng.run_until_drained()
        outs = [eng.result(8000 + i) for i in range(len(prompts))]
        assert eng.pool.heap.free_pages() == dst_free0
        assert eng.pool.stats()["sealed_pages"] == 0
        assert target.seals.pending_releases() == 0
        for pages in src_pages:
            src.free_seq(pages)
        out[name] = (results, outs, refs, staged, target.stats(), target.n_flushes,
                     adopted, seals, src.byref_bytes_out, eng.pool.byref_bytes_in,
                     stub.connection.marshal_bytes)
    assert out["port"] == out["ref"]
    results, outs, refs, staged, stats = out["port"][:5]
    assert results == [0, 0, 0] and outs == refs and staged == (0, 3)
    assert (stats["one_sided_puts"], stats["window_seal_flushes"], stats["calls"]) \
        == (2 + len(prompts), 1, len(prompts))


# -- a standby decode replica and a lease lapse mid-stream (Fig. 5a on the
# served model; tests/test_streaming.py:447 and tests/test_failure_injection.py)
def _await_reaped(channel, conn, timeout=60.0):
    """Wait until the serving thread has reaped ``conn``'s cancelled
    streams, so the client's re-wire never closes a generator that thread
    is running."""
    deadline = time.monotonic() + timeout
    while any(st.conn is conn for st in list(channel._streams)):
        assert time.monotonic() < deadline, "the cancelled stream was never reaped"
        time.sleep(0.001)


def _inject_lease_clock(eng):
    """Put the engine's orchestrator on an injected clock frozen at 0 and
    renew every tracked pid there, so no lease lapses by wall time and only
    an explicit ``expire_leases`` makes one lapse at the next ``tick``."""
    eng.orch.clock = lambda: 0.0
    for pid in list(eng.router._renew_last):
        eng.orch.renew(pid)
        eng.router._renew_last[pid] = 0.0


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_decode_endpoint_fails_over_to_a_standby_as_the_reference(lm, threaded):
    """A standby ``DecodeService`` (pid 13) registered under the engine's
    endpoint name joins the replica chain. The primary's lease lapses two
    tokens into a stream: the stream raises the documented mid-stream
    ``ChannelError`` once, the restart on the same stub lands on pid 13
    with the tokens of a stream without the fault, the killed stream's
    slot, pages and seals come back, and later handoffs go over pid 13's
    ring. Tokens, exceptions, router stats, pool stats, page ids and seal
    indices equal the reference engine's."""
    import repro.core as R_core
    import repro_torch.core as T_core

    engs = _engines(lm, serve_threaded=threaded)
    prompt = [3, 4, 5, 6]
    kw = {"timeout": 60.0} if threaded else {"inline": True}
    out = {}
    for name, eng in engs.items():
        core, service = (T_core, DecodeService) if name == "port" else \
            (R_core, jax_engine.DecodeService)
        try:
            _inject_lease_clock(eng)
            standby = core.RPC(eng.orch, pid=13).open("/pod0/decode-standby",
                                                      heap_pages=256)
            standby.stream_pump_burst = 1
            standby.serve(service(eng))
            rec = eng.router.register(eng.endpoint_name, standby)
            if threaded:
                eng.serve_loop.attach(standby)
            stub = eng.router.stub(eng.endpoint_name, service, pid=40, pod="pod0")
            start = _alloc_stats(eng.pool)
            s = stub.generate_stream.stream(prompt, 6, **kw)
            before = [next(s), next(s)]
            slot = eng.scheduler.slots[0]
            mid = (_alloc_stats(eng.pool), list(slot.pages), list(slot.seal_idxs))
            old = stub.connection.target
            eng.router.mark_crashed(12)
            lapse = (eng.orch.expire_leases(12), eng.orch.tick(), rec.generation,
                     rec.active_idx, eng.router.n_failovers)
            errors = []
            for _ in range(2):
                try:
                    next(s)
                except Exception as e:   # compared across packages
                    errors.append((type(e).__name__, str(e)))
            if threaded:
                _await_reaped(eng.channel, old)
            restarted = list(stub.generate_stream.stream(prompt, 6, **kw))
            after = (_alloc_stats(eng.pool), eng.scheduler.slots == [],
                     stub.connection.failovers, stub.connection.target.channel is standby)
            rids = [eng.submit(p, 4) for p in ([7, 8, 9], [1, 2], [9, 9, 9, 9, 9])]
            eng.run_until_drained()
            reqs = [eng.finished[r] for r in rids]
            submits = ([r.out for r in reqs], [r.pages for r in reqs],
                       [r.seal_idxs for r in reqs], eng.conn.target.channel is standby,
                       eng.conn.failovers, eng.handoff_bytes, eng.oob_events)
            gen = list(eng.generate_tokens([7, 8, 9], 4))
            # a snapshot keeps no engine: a restored replica could not serve
            skipped = core.snapshot(standby).skipped
            out[name] = (before, mid, lapse, errors, restarted, start, after, submits, gen,
                         eng.router.stats(), eng.pool.stats()["sealed_pages"],
                         sorted(eng.router._dead_pids), skipped)
        finally:
            if threaded:
                eng.shutdown()
    assert out["port"] == out["ref"]
    before, mid, lapse, errors, restarted, start, after = out["port"][:7]
    solo = list(engs["port"].generate_tokens(prompt, 6))
    assert restarted == solo and restarted[:2] == before
    assert lapse[2:] == (1, 1, 1) and mid[0]["sealed_pages"] > 0
    assert len(errors) == 2 and all(t == "ChannelError" and "mid-stream" in m
                                    for t, m in errors)
    assert after[0] == start and after[1:] == (True, 1, True)
    assert out["port"][7][3] and out["port"][7][6] == 0 and out["port"][10] == 0
    assert out["port"][12] == ["_engine"]
