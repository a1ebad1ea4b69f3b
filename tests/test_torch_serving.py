"""The port's serving plane against the reference's: pool page ids and
seals, the cross-pod transfer, one paged decode step, and the engine's
token streams on the same weights and prompts, for each configuration
the paged engine serves (yi-9b, olmo-1b, yi-6b and qwen2-vl-7b at smoke
size; qwen2-vl's q/k/v biases set nonzero on both sides)."""

import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.orchestrator import Orchestrator as JaxOrchestrator  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import PagedKVPool as JaxPool  # noqa: E402
from repro.serving import PoolConfig as JaxPoolConfig  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.serving.kv_pool import transfer_pages_cross_pod as jax_transfer  # noqa: E402
from repro.serving.paged_model import paged_decode_step as jax_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import array_from_numpy  # noqa: E402
from repro_torch.core.channel import E_EXCEPTION, BusyWaitPolicy, RpcError  # noqa: E402
from repro_torch.core.errors import ChannelError, Overloaded  # noqa: E402
from repro_torch.core.orchestrator import Orchestrator  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import PagedKVPool, PoolConfig, ServeEngine  # noqa: E402
from repro_torch.serving import paged_decode_step, transfer_pages_cross_pod  # noqa: E402

BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:29
POOL = dict(num_pages=64, page_tokens=8, max_pages_per_seq=8)


PAGED_ARCHS = ["yi_9b", "olmo_1b", "yi_6b", "qwen2_vl_7b"]


def with_nonzero_biases(params, seed=0):
    """The reference initialises q/k/v biases to zero (attention.py:51-56),
    so a comparison at init would not see them: give each a draw of
    N(0, 0.5) in its own dtype."""
    attn = params["stack"]["pos0"]["attn"]
    if "bq" not in attn:
        return params
    rng = np.random.default_rng(seed)
    attn = dict(attn, **{n: jnp.asarray(0.5 * rng.standard_normal(attn[n].shape),
                                        attn[n].dtype) for n in ("bq", "bk", "bv")})
    stack = dict(params["stack"], pos0=dict(params["stack"]["pos0"], attn=attn))
    return dict(params, stack=stack)


@pytest.fixture(scope="module", params=PAGED_ARCHS)
def lm(request):
    jcfg, tcfg = jax_smoke(request.param), get_smoke_config(request.param)
    jm = jax_build(jcfg)
    params = with_nonzero_biases(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg).load_params(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return jcfg, jm, params, tcfg, tm


def _engines(lm, **kw):
    jcfg, _, params, tcfg, tm = lm
    pool = dict(POOL, num_pages=kw.pop("num_pages", POOL["num_pages"]))
    je = JaxEngine(jcfg, params, JaxPoolConfig(**pool), backend="ref", **kw)
    te = ServeEngine(tcfg, tm, PoolConfig(**pool), device="cpu", **kw)
    return je, te


def _torch_engine(lm, **kw):
    _, _, _, tcfg, tm = lm
    pool = dict(POOL, num_pages=kw.pop("num_pages", POOL["num_pages"]))
    return ServeEngine(tcfg, tm, PoolConfig(**pool), device="cpu", **kw)


def _assert_streams_agree(lm, prompt, ref, got):
    """Token for token up to the first mismatch; a mismatch is allowed
    only at a near-tie: the reference dense chain's top-2 logit gap at
    that step is within the bf16 tolerance of its top logit."""
    if got == ref:
        return
    i = next(k for k, (a, b) in enumerate(zip(ref, got)) if a != b)
    _, jm, params, _, _ = lm
    lg, cache = jm.prefill(params, {"tokens": jnp.asarray([prompt], jnp.int32)},
                           cache_len=len(prompt) + len(ref))
    for k in range(i):
        lg, cache = jm.decode_step(params, jnp.asarray([ref[k]], jnp.int32),
                                   jnp.asarray([len(prompt) + k], jnp.int32),
                                   cache)
    top2 = np.sort(np.asarray(lg[0]))[-2:]
    assert top2[1] - top2[0] <= BF16["atol"] + BF16["rtol"] * abs(top2[1]), \
        f"stream diverged at step {i} without a near-tie: {ref} vs {got}"


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, size=int(rng.integers(3, 20)))]
            for _ in range(n)]


# -- pool -------------------------------------------------------------------
def test_pool_page_ids_and_seals_match_reference(lm):
    jcfg, _, _, tcfg, _ = lm
    jp = JaxPool(JaxOrchestrator(), jcfg, JaxPoolConfig(**POOL), owner_pid=7)
    tp = PagedKVPool(Orchestrator(), tcfg, PoolConfig(**POOL), owner_pid=7,
                     device="cpu")
    for pool in (jp, tp):
        a = pool.alloc_seq(20, 7)
        b = pool.alloc_seq(9, 7)
        pool.free_seq(a)
        c = pool.alloc_seq(40, 7)
        seals = pool.seal_seq(b + c, holder=11)
        pool.complete_and_release(seals[:2], 11, batched=True)
        pool.seals.flush()
        pool.record = (a, b, c, seals, pool.stats(),
                       np.asarray(pool.perm_bits()).tolist(),
                       np.asarray(pool.sandbox_bitmap(7)).tolist(),
                       np.asarray(pool.sandbox_desc()).tolist())
    assert tp.record == jp.record
    assert tp.page_bytes == jp.page_bytes


def test_pool_device_none_requires_cuda(lm):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    tcfg, tm = lm[3], lm[4]
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKVPool(Orchestrator(), tcfg, PoolConfig(**POOL), owner_pid=1)
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tcfg, tm, PoolConfig(**POOL))


@pytest.mark.parametrize("src_pages,dst_pages", [([3, 9, 17], [5, 6, 7]),
                                                 ([3, 9], [4, 5])])
def test_transfer_cross_pod_matches_reference(lm, src_pages, dst_pages):
    """tests/test_serving.py:142-172 on both packages, same pool bytes."""
    jcfg, _, _, tcfg, _ = lm
    pc = dict(num_pages=32, page_tokens=8, max_pages_per_seq=8)
    jo, to = JaxOrchestrator(), Orchestrator()
    jsrc, jdst = (JaxPool(jo, jcfg, JaxPoolConfig(**pc), owner_pid=p)
                  for p in (1, 2))
    tsrc, tdst = (PagedKVPool(to, tcfg, PoolConfig(**pc), owner_pid=p,
                              device="cpu") for p in (1, 2))
    rng = np.random.default_rng(1)
    for name in ("k", "v"):
        vals = np.asarray(jnp.asarray(rng.standard_normal(jsrc.k.shape),
                                      jnp.bfloat16))
        setattr(jsrc, name, jnp.asarray(vals))
        getattr(tsrc, name).copy_(array_from_numpy(vals, "cpu"))
    moved_j = jax_transfer(jsrc, jdst, src_pages, dst_pages, backend="ref")
    k_before = tdst.k.data_ptr()
    moved_t = transfer_pages_cross_pod(tsrc, tdst, src_pages, dst_pages)
    assert moved_t == moved_j == 2 * tcfg.num_layers * len(src_pages) * \
        8 * tcfg.num_kv_heads * tcfg.head_dim * 2
    assert tdst.k.data_ptr() == k_before       # scattered in place
    for name in ("k", "v"):
        got = getattr(tdst, name).view(torch.int16).numpy()
        want = np.asarray(getattr(jdst, name)).view(np.int16)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got[:, dst_pages],
            getattr(tsrc, name).view(torch.int16).numpy()[:, src_pages])
    assert (tsrc.byref_bytes_out, tdst.byref_bytes_in) == (moved_t, moved_t)


# -- one paged decode step ----------------------------------------------------
@pytest.mark.parametrize("forge", [False, True, "negative"])
def test_paged_decode_step_matches_reference(lm, forge):
    """One paged decode step on both packages. ``True`` forges another
    connection's page and a wild page id; ``"negative"`` forges page id -1
    where row 2 writes its new K/V. Both sides mask and count the read of
    page -1, and the port drops the write. The reference's scatter wraps a
    negative id, so it writes row 2's K/V into page P - 1: a known
    divergence, asserted here so that a change on either side shows."""
    jcfg, _, params, tcfg, tm = lm
    rng = np.random.default_rng(5)
    L, P, T = tcfg.num_layers, 32, 8
    shape = (L, P, T, tcfg.num_kv_heads, tcfg.head_dim)
    kp = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    vp = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    B, MAXP = 3, 4
    n_pages = P - 1 if forge == "negative" else P     # page P - 1 in no block table
    bt = rng.permutation(n_pages)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    pos = np.array([5, 17, 30], np.int32)
    toks = rng.integers(1, 128, size=B).astype(np.int32)
    perm = np.ones(P, np.int32)
    bitmap = np.ones(P, np.int32)
    sandbox = np.array([0, P, 1], np.int32)
    if forge is True:
        bitmap[bt[1, 0]] = 0      # another connection's page, in use
        bt[2, 1] = 1000           # wild pointer, in use
    if forge == "negative":
        bt[2, 3] = -1             # the page of row 2's position 30 (slot 6)
    kp0, vp0 = kp.astype(np.float32), vp.astype(np.float32)
    args = [toks, pos, bt, pos + 1, kp, vp, perm, sandbox, bitmap]
    lj, kj, vj, oj = jax_step(jcfg, params, *[jnp.asarray(a) for a in args],
                              backend="ref")
    targs = [array_from_numpy(a, "cpu") for a in args]
    lt, kt, vt, ot = paged_decode_step(tcfg, tm, *targs)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    # one violation per row, counted once per layer
    assert ot.tolist() == {False: [0, 0, 0], True: [0, L, L], "negative": [0, 0, L]}[forge]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    assert kt.data_ptr() == targs[4].data_ptr()    # the pool, in place
    pages = list(range(P))
    if forge == "negative":
        pages.remove(P - 1)
        for got, want, before in ((kt, kj, kp0), (vt, vj, vp0)):
            # the port's page P - 1 is unchanged ...
            np.testing.assert_array_equal(got[:, P - 1].float().numpy(), before[:, P - 1])
            # ... the reference's holds row 2's new K/V in slot 6 and only there
            moved = np.asarray(want, np.float32)[:, P - 1] != before[:, P - 1]
            assert moved.any(axis=(0, 2, 3)).tolist() == [t == 6 for t in range(T)]
    for got, want in ((kt, kj), (vt, vj)):
        np.testing.assert_allclose(got.float().numpy()[:, pages],
                                   np.asarray(want, np.float32)[:, pages], **BF16)


# -- the engine ----------------------------------------------------------------
def test_submit_streams_match_reference_engine(lm):
    je, te = _engines(lm, max_active=3)
    prompts = _prompts(5)
    jr = [je.submit(p, 6) for p in prompts]
    tr = [te.submit(p, 6) for p in prompts]
    je.run_until_drained()
    te.run_until_drained()
    for p, a, b in zip(prompts, jr, tr):
        _assert_streams_agree(lm, p, je.result(a), te.result(b))
    assert te.oob_events == 0 and te.pool.stats()["sealed_pages"] == 0
    assert te.decode_steps == je.decode_steps


def test_generate_tokens_match_reference_engine(lm):
    je, te = _engines(lm)
    prompts = _prompts(4, seed=1)
    free0 = te.pool.heap.free_pages()
    outs = {}
    for name, eng in (("jax", je), ("torch", te)):
        gens = [eng.generate_tokens(p, 6) for p in prompts]
        outs[name] = [[] for _ in prompts]
        for _ in range(6):              # round-robin: one batched step each
            for o, g in zip(outs[name], gens):
                o.append(next(g))
        for g in gens:
            assert next(g, None) is None
    for p, a, b in zip(prompts, outs["jax"], outs["torch"]):
        _assert_streams_agree(lm, p, a, b)
    assert te.peak_stream_batch == 4 and te.stream_steps == je.stream_steps
    assert te.pool.heap.free_pages() == free0
    assert te.pool.stats()["sealed_pages"] == 0


def test_midbatch_admit_retire_matches_solo(lm):
    """Streams admitted and retired mid-batch yield their solo tokens."""
    te = _torch_engine(lm)
    pa, pb = [5, 6, 7, 8], [9, 10, 11]
    ref_a, ref_b = list(te.generate_tokens(pa, 8)), list(te.generate_tokens(pb, 4))
    ga = te.generate_tokens(pa, 8)
    a = [next(ga), next(ga)]
    gb = te.generate_tokens(pb, 4)
    b = list(gb)
    a += list(ga)
    assert (a, b) == (ref_a, ref_b)


def test_oob_flagged_for_forged_block_table(lm):
    te = _torch_engine(lm)
    te.submit([1, 2, 3, 4], max_new=8)
    te._admit()
    req = te.active[0]
    req.pages[0] = (req.pages[0] + 37) % te.pool.pc.num_pages
    te._decode_batch()
    assert te.oob_events >= 1


def test_pool_exhaustion_queues_instead_of_crashing(lm):
    te = _torch_engine(lm, num_pages=16, max_active=16)
    rids = [te.submit([1, 2, 3, 4], max_new=4) for _ in range(12)]
    te.run_until_drained()
    assert all(len(te.result(r)) == 4 for r in rids)
    assert te.pool.stats()["sealed_pages"] == 0


def test_stream_admission_sheds_typed(lm):
    te = _torch_engine(lm, num_pages=16, max_active=2)
    g1 = te.generate_tokens([1, 2, 3], 4)
    te.generate_tokens([4, 5, 6], 4)
    with pytest.raises(Overloaded) as e:
        te.generate_tokens([7, 8, 9], 4)          # slots full
    assert e.value.retry_after_s > 0
    g1.close()
    with pytest.raises(Overloaded):
        te.generate_tokens(list(range(1, 60)), 4)  # pool exhausted
    assert te.shed_admits == 2
    quota = _torch_engine(lm, quota_pages=2)
    with pytest.raises(Overloaded, match="quota"):
        quota.generate_tokens(list(range(1, 20)), 4)   # needs 3 pages


def test_cancel_frees_pages_and_seals_exactly_once(lm):
    te = _torch_engine(lm)
    free0 = te.pool.heap.free_pages()
    g = te.generate_tokens([5, 6, 7, 8], 8)
    next(g)
    next(g)
    assert te.pool.stats()["sealed_pages"] > 0
    g.close()
    g.close()                                 # idempotent
    assert te.pool.heap.free_pages() == free0
    assert te.pool.stats()["sealed_pages"] == 0
    assert te.scheduler.slots == []


def test_attach_rejects_unknown_or_mismatched_handoff(lm):
    """decode.attach rejects an unknown rid ("no pending") and a forged
    block table ("mismatch") with a typed ChannelError and adopts
    nothing: called directly on the handler, and over the ring, where
    the handler's error fails the RPC with E_EXCEPTION and the forged
    handoff's pending record is consumed."""
    te = _torch_engine(lm)
    with pytest.raises(ChannelError, match="no pending"):
        te.service.attach(None, 99, 4, _PageView([1]))
    with pytest.raises(RpcError) as e:
        te.stub.attach(99, 4, [1], inline=True)
    assert e.value.status == E_EXCEPTION and te.active == []
    te.submit([1, 2, 3, 4], max_new=4)
    te._admit()
    req = te.active.pop()
    te._pending_attach[req.rid] = req
    with pytest.raises(ChannelError, match="mismatch"):
        te.service.attach(None, req.rid, 4, _PageView(req.pages + [0]))
    assert te.active == [] and req.rid not in te._pending_attach
    te._pending_attach[req.rid] = req
    with pytest.raises(RpcError) as e:
        te.stub.attach(req.rid, 4, req.pages + [0], inline=True)
    assert e.value.status == E_EXCEPTION and te.active == []
    assert req.rid not in te._pending_attach


class _PageView:
    """The handler's view of a marshalled page list (``to_python``)."""

    def __init__(self, pages):
        self._pages = pages

    def to_python(self):
        return list(self._pages)


# -- idle back-off -------------------------------------------------------------------
def test_idle_ticks_back_off_as_the_reference(monkeypatch):
    """Two requests keep ``step`` busy for a few ticks, then it idles: each
    idle tick sleeps once, for what a ``BusyWaitPolicy`` fed the same
    ticks prescribes (150 µs while the recent load is above 1/2, then 5
    µs, then a bare yield), and the reference's engine sleeps the same."""
    jcfg, tcfg = jax_smoke("yi_9b"), get_smoke_config("yi_9b")
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tm = build_model(tcfg).load_params(jax.tree.map(np.asarray, params), device="cpu")
    engines = {"reference": JaxEngine(jcfg, params, JaxPoolConfig(**POOL), backend="ref"),
               "port": ServeEngine(tcfg, tm, PoolConfig(**POOL), device="cpu")}
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    runs = {}
    for name, eng in engines.items():
        sleeps.clear()
        for prompt in _prompts(2):
            eng.submit(prompt, max_new=6)
        ticks = [eng.step() for _ in range(40)]
        policy, want = BusyWaitPolicy(), []
        for worked in ticks:
            policy.record(worked)
            if not worked:
                want.append(policy.delay_s())
        assert sleeps == want, name
        runs[name] = (ticks, list(sleeps))
    assert runs["port"] == runs["reference"]
    ticks, got = runs["port"]
    assert ticks == [True] * 5 + [False] * 35
    assert [d for i, d in enumerate(got) if i == 0 or d != got[i - 1]] == [150e-6, 5e-6, 0.0]
