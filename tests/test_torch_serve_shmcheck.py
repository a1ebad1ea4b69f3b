"""The port's serving engine over its RPC plane under the port's ShmCheck
sanitizer, against the reference engine under the reference's: the smoke
yi-9b (2 layers, the same fp32 weights on both packages) streams
``decode.generate_stream`` inline and to client threads through a
``ServerLoop`` thread, each engine built inside its package's
``session()`` (heaps attach only when they are created). Both runs must
end with no finding and equal tokens; inline, both tracers must count
every event kind equally, which places each hook of the port where the
reference's sits. Scenarios follow tests/test_torch_serve_rpc.py."""

import threading
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.analysis as RA  # noqa: E402
import repro_torch.analysis as TA  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import PoolConfig as JaxPoolConfig  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import DecodeService, PoolConfig, ServeEngine  # noqa: E402

POOL = dict(num_pages=64, page_tokens=8, max_pages_per_seq=8)
PROMPTS = [[i + 1, i + 2, i + 3, 40 + i] for i in range(3)]
MAX_NEW = 8


@pytest.fixture(scope="module")
def lm():
    jcfg, tcfg = jax_smoke("yi_9b"), get_smoke_config("yi_9b")
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tm = build_model(tcfg).load_params(p32, device="cpu").float()
    return jcfg, jax.tree.map(jnp.asarray, p32), tcfg, tm


def _engine(lm, name, **kw):
    jcfg, params, tcfg, tm = lm
    if name == "ref":
        return JaxEngine(jcfg, params, JaxPoolConfig(**POOL), backend="ref", **kw), \
            jax_engine.DecodeService
    return ServeEngine(tcfg, tm, PoolConfig(**POOL), device="cpu", **kw), DecodeService


def _streams(eng, service, threaded):
    if not threaded:
        return [list(eng.stub.generate_stream.stream(p, MAX_NEW, inline=True))
                for p in PROMPTS]
    outs, errors = [None] * len(PROMPTS), []

    def client(i):
        try:
            stub = eng.router.stub(eng.endpoint_name, service, pid=30 + i, pod="pod0")
            outs[i] = list(stub.generate_stream.stream(PROMPTS[i], MAX_NEW, timeout=60.0))
        except Exception as e:   # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
        assert not t.is_alive(), "client thread wedged"
    assert not errors, errors
    return outs


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_served_streams_are_shmcheck_clean_as_the_reference(lm, threaded):
    out = {}
    for name, analysis in (("ref", RA), ("port", TA)):
        with analysis.session() as tr:
            eng, service = _engine(lm, name, serve_threaded=threaded, max_active=4)
            assert eng.pool.heap._tracer is tr and eng.conn.heap._tracer is tr
            free0 = eng.pool.heap.free_pages()
            try:
                toks = _streams(eng, service, threaded)
            finally:
                eng.shutdown()
            assert eng.pool.heap.free_pages() == free0
            assert eng.pool.stats()["sealed_pages"] == 0
            assert eng.scheduler.slots == []
        assert tr.findings == [], "\n".join(str(f) for f in tr.findings)
        assert tr.n_events > 0
        out[name] = (toks, Counter(rec[0] for rec in tr.events))
    assert out["port"][0] == out["ref"][0]
    assert all(len(t) == MAX_NEW for t in out["port"][0])
    kinds = out["port"][1]
    for kind in ("alloc", "seal", "seal-release", "rel", "acq", "w", "r"):
        assert kinds[kind] > 0, kind
    if not threaded:
        assert kinds == out["ref"][1]


def test_engine_outside_a_session_is_not_traced(lm, monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    eng, _ = _engine(lm, "port")
    try:
        assert eng.pool.heap._tracer is None and eng.conn.heap._tracer is None
        assert len(list(eng.generate_tokens(PROMPTS[0], 3))) == 3
    finally:
        eng.shutdown()
