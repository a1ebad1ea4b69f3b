"""The port's CUDA kernels, its paged decode, its serving engine in pod,
across pods, failing over to a standby replica and under the ShmCheck
sanitizer, its Mamba-2 prefill, its gemma3, MoE and jamba prefill and
decode, and its training (the kernels' ``autograd.Function``s,
``Model.loss_fn``'s gradients, train steps, the training CLI) on the
card, held against the port's plain PyTorch versions on the same
inputs. Needs a CUDA card and nvcc; skips without one. Imports nothing
of jax, so it also runs on a machine with the card and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import copy
import shutil
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.orchestrator import Orchestrator  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref  # noqa: E402
from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref  # noqa: E402
from repro_torch.kernels.scope_copy import gather_pages, scatter_pages  # noqa: E402
from repro_torch.kernels.scope_copy.ref import gather_pages_ref, scatter_pages_ref  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked, ssd_intra_chunk_ref, ssd_sequential_ref  # noqa: E402
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import PagedKVPool, PoolConfig, ServeEngine, paged_decode_step  # noqa: E402
from repro_torch.serving import transfer_pages_cross_pod  # noqa: E402
from torch_forcing import TorchSide, check_forced, expert_draws, forced  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=5e-5, rtol=1e-4),     # fp32 accumulation order
       torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}    # tests/test_kernels.py:29
# the kernel alone in bf16: both sides accumulate in fp32, so they differ by
# about the output's bf16 rounding
K1_TOL = {torch.float32: TOL[torch.float32],
          torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
# the sequence lengths chip_smoke.py serves (prompt + 16 new tokens): up to
# 30 in-use pages of 16, split over the bf16 kernel's cluster
SLICE_LENS = [471, 244, 419, 422, 292, 343, 340, 342]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(B, Hq, Hkv, D, T, dtype, P=64, MAXP=6, seed=0, lens=None):
    g = torch.Generator().manual_seed(seed)
    return [
        torch.randn((B, Hq, D), generator=g).to(dtype),
        torch.randn((P, T, Hkv, D), generator=g).to(dtype),
        torch.randn((P, T, Hkv, D), generator=g).to(dtype),
        torch.randperm(P, generator=g)[: B * MAXP].reshape(B, MAXP).to(torch.int32),
        (torch.randint(1, MAXP * T + 1, (B,), generator=g, dtype=torch.int32)
         if lens is None else torch.tensor(lens, dtype=torch.int32)),
        torch.ones(P, dtype=torch.int32),
        torch.tensor([0, P, 1], dtype=torch.int32),
        torch.ones(P, dtype=torch.int32),
    ]


def _k1_check(args, dev, tol):
    """Kernel on the card against the plain version on the same inputs."""
    n0 = paged_attention.launches
    out, oob = paged_attention(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    ref_out, ref_oob = paged_attention_ref(*[a.to(dev) for a in args])
    assert oob.tolist() == ref_oob.tolist()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    return oob.tolist()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_matches_plain_at_slice_shape(dev, dtype):
    """yi-9b decode at B=8, MAXP=64 and the main path's lengths."""
    args = _k1_inputs(8, 32, 4, 128, 16, dtype, P=512, MAXP=64, lens=SLICE_LENS)
    _k1_check(args, dev, K1_TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,D,T,dtype", [
    (8, 32, 4, 128, 16, torch.bfloat16),     # yi-9b heads
    (8, 16, 16, 128, 16, torch.bfloat16),    # olmo-1b: 128 pairs, a cluster of 1
    (8, 28, 4, 128, 16, torch.bfloat16),     # qwen2-vl-7b: 7 query rows a KV head
    (2, 4, 1, 64, 8, torch.float32),
    (3, 8, 8, 128, 16, torch.float32),
    (2, 16, 2, 64, 8, torch.bfloat16),
])
def test_paged_attention_kernel_matches_plain(dev, B, Hq, Hkv, D, T, dtype):
    _k1_check(_k1_inputs(B, Hq, Hkv, D, T, dtype, seed=B + D), dev, K1_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,expect", [
    ("wild_pointer", [1, 0]), ("unsealed_page", [0, 1]),
    ("sandbox_off", [0, 0]), ("foreign_bitmap", [1, 0]), ("empty_row", [0, 2]),
])
def test_paged_attention_kernel_sandbox_cases(dev, case, expect, dtype):
    """tests/test_kernels.py:70-99, plus rows with no valid token (zeros)."""
    args = _k1_inputs(2, 4, 2, 64, 16, dtype, P=32, MAXP=4)
    bt, perm, bitmap = args[3], args[5], args[7]
    if case == "wild_pointer":
        bt[0, 0] = 999
    elif case == "unsealed_page":
        perm[bt[1, 0]] = 0
    elif case == "sandbox_off":
        perm.zero_()
        args[6] = torch.tensor([0, 32, 0], dtype=torch.int32)
    elif case == "foreign_bitmap":
        bitmap[bt[0, 0]] = 0
    else:
        args[4] = torch.tensor([0, 20], dtype=torch.int32)
        bitmap[bt[1, :2].long()] = 0
    assert _k1_check(args, dev, K1_TOL[dtype]) == expect


def test_paged_attention_bf16_rejected_pages_off_rank_0(dev):
    """The bf16 kernel gives page i of a sequence to cluster rank i mod C
    (C up to 8): rejected pages 1, 6 and 13 and an unsealed page 3 fall to
    ranks other than 0, and each is still counted once."""
    args = _k1_inputs(2, 32, 4, 128, 16, torch.bfloat16, P=128, MAXP=32, lens=[470, 300])
    bt, perm, bitmap = args[3], args[5], args[7]
    bitmap[bt[0, [1, 6, 13]].long()] = 0
    perm[bt[1, 3]] = 0
    assert _k1_check(args, dev, K1_TOL[torch.bfloat16]) == [3, 1]


@pytest.mark.parametrize("lens,MAXP", [
    ([10, 471], 32),        # one page beside thirty: most ranks of one cluster idle
    ([8 * 16 + 37, 5], 8),  # seq_len past MAXP·T: the pages past MAXP are not read
])
def test_paged_attention_bf16_split_edges(dev, lens, MAXP):
    args = _k1_inputs(2, 32, 4, 128, 16, torch.bfloat16, P=128, MAXP=MAXP, lens=lens)
    assert _k1_check(args, dev, K1_TOL[torch.bfloat16]) == [0, 0]


@pytest.mark.parametrize("D", [64, 128])
# 1, 8 and 7 query rows a KV head
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (16, 2), (28, 4)])
def test_paged_attention_bf16_group_sizes(dev, Hq, Hkv, D):
    args = _k1_inputs(3, Hq, Hkv, D, 16, torch.bfloat16, P=128, MAXP=32, seed=Hq + D)
    _k1_check(args, dev, K1_TOL[torch.bfloat16])


@pytest.mark.parametrize("Hq,Hkv,C", [(16, 16, 1), (28, 4, 4), (32, 4, 4)])
def test_paged_attention_bf16_cluster_size_at_served_shapes(dev, Hq, Hkv, C):
    """At B=8 and the served lengths, olmo-1b's 128 (sequence, KV head)
    pairs fill the card alone, so each pair's 30 pages stay with one block
    (a cluster of 1); qwen2-vl-7b's and yi-9b's 32 pairs split over 4."""
    from repro_torch.kernels.paged_attention.kernel import cluster_size
    assert cluster_size(8, Hkv) == C
    args = _k1_inputs(8, Hq, Hkv, 128, 16, torch.bfloat16, P=512, MAXP=64, lens=SLICE_LENS)
    _k1_check(args, dev, K1_TOL[torch.bfloat16])


def test_paged_attention_kernel_rejects_what_it_does_not_take(dev):
    args = [a.to(dev) for a in _k1_inputs(2, 4, 1, 64, 8, torch.float32)]
    with pytest.raises(ValueError, match="dtype"):
        paged_attention(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(args[0][..., :48].contiguous(), args[1][..., :48].contiguous(),
                        args[2][..., :48].contiguous(), *args[3:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32])
@pytest.mark.parametrize("W", [8192, 7])     # 16-byte vector path, byte path
def test_scope_copy_kernels_bitwise(dev, dtype, W):
    g = torch.Generator().manual_seed(W)
    pool = (torch.randn((256, W), generator=g) * 1000).to(dtype).to(dev)
    pages = torch.tensor([3, 255, -5, 4000, 17], dtype=torch.int32, device=dev)
    # distinct rows once clamped: duplicate scatter ids land in no set order
    dst = torch.tensor([17, 4000, -5, 100, 3], dtype=torch.int32, device=dev)
    buf = (torch.randn((5, W), generator=g) * 1000).to(dtype).to(dev)
    n0 = (gather_pages.launches, scatter_pages.launches)
    got = gather_pages(pool, pages)
    scattered = scatter_pages(pool.clone(), dst, buf)
    torch.cuda.synchronize()
    assert (gather_pages.launches, scatter_pages.launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(got, gather_pages_ref(pool, pages))
    assert torch.equal(scattered, scatter_pages_ref(pool.clone(), dst, buf))


def test_transfer_cross_pod_on_card_is_two_gathers_and_two_scatters(dev):
    """One gather and one scatter a tensor over all layers' rows: the bytes
    of every layer land bitwise, and nothing outside the destination pages
    is written."""
    cfg = get_smoke_config("yi_9b")
    pc = PoolConfig(num_pages=32, page_tokens=8, max_pages_per_seq=8)
    orch = Orchestrator()
    src = PagedKVPool(orch, cfg, pc, owner_pid=1, device=dev)
    dst = PagedKVPool(orch, cfg, pc, owner_pid=2, device=dev)
    g = torch.Generator().manual_seed(2)
    for t in (src.k, src.v):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    sp, dp = [3, 9, 17, 30], [5, 6, 7, 31]
    n0 = (gather_pages.launches, scatter_pages.launches)
    moved = transfer_pages_cross_pod(src, dst, sp, dp)
    torch.cuda.synchronize()
    assert (gather_pages.launches - n0[0], scatter_pages.launches - n0[1]) == (2, 2)
    L = cfg.num_layers
    assert moved == 2 * L * len(sp) * 8 * cfg.num_kv_heads * cfg.head_dim * 2
    assert src.byref_bytes_out == dst.byref_bytes_in == moved
    rest = torch.ones(pc.num_pages, dtype=torch.bool)
    rest[dp] = False
    for a, b in ((src.k, dst.k), (src.v, dst.v)):
        assert torch.equal(a[:, sp].view(torch.int16), b[:, dp].view(torch.int16))
        assert b[:, rest.to(dev)].abs().sum().item() == 0


def _card_config():
    """yi-9b's smoke shape with the kernel's smallest head_dim (64)."""
    return replace(get_smoke_config("yi_9b"), head_dim=64)


def test_paged_decode_step_on_card_matches_cpu(dev):
    cfg = _card_config()
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    L, P, T, B, MAXP = cfg.num_layers, 32, 8, 3, 4
    shape = (L, P, T, cfg.num_kv_heads, cfg.head_dim)
    kp = torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()
    vp = torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()
    bt = torch.from_numpy(rng.permutation(P)[: B * MAXP].reshape(B, MAXP).astype(np.int32))
    pos = torch.tensor([5, 17, 30], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=B).astype(np.int32))
    bitmap = torch.ones(P, dtype=torch.int32)
    bitmap[bt[1, 0]] = 0                      # another connection's page, in use
    args = [toks, pos, bt, pos + 1, kp, vp, torch.ones(P, dtype=torch.int32),
            torch.tensor([0, P, 1], dtype=torch.int32), bitmap]
    lc, kc, vc, oc = paged_decode_step(cfg, model, *[a.clone() for a in args])
    model_d = copy.deepcopy(model).to(dev)
    n0 = paged_attention.launches
    ld, kd, vd, od = paged_decode_step(cfg, model_d, *[a.to(dev) for a in args])
    assert paged_attention.launches == n0 + L
    assert od.tolist() == oc.tolist() == [0, L, 0]
    torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])
    for got, want in ((kd, kc), (vd, vc)):
        torch.testing.assert_close(got.cpu().float(), want.float(), **TOL[torch.bfloat16])


def test_engine_on_card_serves_through_the_kernel(dev):
    cfg = _card_config()
    model = build_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)
    eng = ServeEngine(cfg, model, PoolConfig(num_pages=64, page_tokens=8,
                                             max_pages_per_seq=8), max_active=4,
                      device=dev)
    free0 = eng.pool.heap.free_pages()
    n0, f0 = paged_attention.launches, flash_prefill_cuda.launches
    gens = [eng.generate_tokens(list(range(1, 4 + 3 * i)), 6) for i in range(4)]
    outs = [list(g) for g in gens]
    rid = eng.submit([7, 8, 9], 5)
    eng.run_until_drained(timeout=120)
    assert [len(o) for o in outs] == [6] * 4 and len(eng.result(rid)) == 5
    assert paged_attention.launches - n0 == cfg.num_layers * eng.decode_steps
    assert flash_prefill_cuda.launches - f0 == cfg.num_layers * 5   # one per prefill
    assert eng.oob_events == 0
    assert eng.pool.heap.free_pages() == free0
    assert eng.pool.stats()["sealed_pages"] == 0


def test_qwen2_vl_engine_on_card_serves_through_the_kernels(dev):
    """qwen2-vl's smoke family at the kernels' head_dim 64 with 7 query
    heads a KV head (14/2) and sections (8, 12, 12): the engine on the
    card serves 3 streams and a submit through K3 and K1, each launched L
    times per prefill and per step, and the tokens equal the same engine's
    on the CPU outside near-ties of the CPU dense chain. Then one prefill
    with image-like position triples takes the positions path (no K3
    launch) and agrees with the CPU's."""
    from repro_torch.models.attention import attention_full
    from repro_torch.models.layers import image_positions
    cfg = replace(get_smoke_config("qwen2_vl_7b"), head_dim=64, num_heads=14,
                  num_kv_heads=2, mrope_sections=(8, 12, 12))
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for name in ("bq", "bk", "bv"):   # zeros at init: make them count
        b = model["stack"]["pos0"]["attn"][name]
        b.copy_(0.5 * torch.randn(b.shape, generator=g))
    model_d = copy.deepcopy(model).to(dev)
    pc = PoolConfig(num_pages=64, page_tokens=8, max_pages_per_seq=8)
    prompts = [list(range(1, 4 + 5 * i)) for i in range(3)]
    out = {}
    for where, m in (("cpu", model), ("cuda", model_d)):
        eng = ServeEngine(cfg, m, pc, max_active=4, device=where)
        n0, f0 = paged_attention.launches, flash_prefill_cuda.launches
        gens = [eng.generate_tokens(p, 6) for p in prompts]
        out[where] = [list(gen) for gen in gens]
        rid = eng.submit([7, 8, 9], 5)
        eng.run_until_drained(timeout=120)
        out[where].append(eng.result(rid))
        if where == "cuda":
            assert paged_attention.launches - n0 == cfg.num_layers * eng.decode_steps
            assert flash_prefill_cuda.launches - f0 == cfg.num_layers * 4
        assert eng.oob_events == 0 and eng.pool.stats()["sealed_pages"] == 0
    for p, a, b in zip(prompts + [[7, 8, 9]], out["cpu"], out["cuda"]):
        if a != b:
            i = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            lg, cache = model.prefill(torch.tensor([p], dtype=torch.int32),
                                      cache_len=len(p) + len(a))
            for k in range(i):
                lg, cache = model.decode_step(torch.tensor([a[k]], dtype=torch.int32),
                                              torch.tensor([len(p) + k], dtype=torch.int32),
                                              cache)
            top2 = lg[0].sort().values[-2:]
            assert top2[1] - top2[0] <= 5e-2 + 5e-2 * top2[1].abs(), (a, b)
    pos = image_positions(2, (3, 3), 3)[:, None].expand(3, 2, 14).contiguous()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, size=(2, 14)).astype(np.int32))
    lc, _ = model.prefill(toks, positions=pos)
    paths, f0 = dict(attention_full.paths), flash_prefill_cuda.launches
    ld, _ = model_d.prefill(toks.to(dev), positions=pos.to(dev))
    assert flash_prefill_cuda.launches == f0
    assert attention_full.paths["positions"] - paths["positions"] == cfg.num_layers
    torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_6b", "qwen2_vl_7b"])
def test_full_width_init_on_card(dev, arch):
    """Each paged family's published config initialises on the card, its
    parameter count within 0.1% of the analytic one (which counts norms
    approximately and no biases), with empty norm subtrees for olmo and
    zero biases for qwen2-vl."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    model = build_model(cfg).init(torch.Generator(dev).manual_seed(0))
    assert model.device.type == "cuda"
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - cfg.param_count()) <= 1e-3 * cfg.param_count()
    attn = model["stack"]["pos0"]["attn"]
    assert ("bq" in attn) == cfg.attn_bias
    if cfg.attn_bias:
        assert not attn["bq"].any()
    assert (len(model["norm_f"]) == 0) == (cfg.norm_kind == "layernorm_np")
    del model
    torch.cuda.empty_cache()


def test_threaded_engine_on_card_streams_over_the_ring(dev):
    """The decode service on a ServerLoop thread: 4 client threads, each
    with its own stub, stream over the ring on the card, token for token
    the solo in-process streams; K1 and K3 launch L x steps and L x
    prefills; ``shutdown()`` joins the serving thread."""
    import threading

    from repro_torch.serving import DecodeService

    cfg = _card_config()
    model = build_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)
    pc = PoolConfig(num_pages=64, page_tokens=8, max_pages_per_seq=8)
    prompts = [list(range(1, 4 + 3 * i)) for i in range(4)]
    solo = ServeEngine(cfg, model, pc, max_active=4, device=dev)
    want = [list(solo.generate_tokens(p, 6)) for p in prompts]
    eng = ServeEngine(cfg, model, pc, max_active=4, serve_threaded=True, device=dev)
    thread = eng.serve_loop._thread
    outs, errors = [None] * 4, []

    def client(i):
        try:
            stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=30 + i)
            outs[i] = list(stub.generate_stream.stream(prompts[i], 6, timeout=120.0))
        except Exception as e:   # surfaced below
            errors.append((i, e))

    n0, f0 = paged_attention.launches, flash_prefill_cuda.launches
    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        eng.shutdown()
    assert not thread.is_alive()
    assert not errors, errors
    assert outs == want
    assert paged_attention.launches - n0 == cfg.num_layers * eng.decode_steps
    assert flash_prefill_cuda.launches - f0 == cfg.num_layers * 4
    assert eng.oob_events == 0 and eng.pool.stats()["sealed_pages"] == 0


def _cross_pod_streams(cfg, model, prompts, max_new, threaded=True):
    """One thread a prompt, each a stub in pod ``pod9``, streaming from a
    threaded engine in ``pod0`` over the fallback link. Returns the token
    lists, the engine, and each stub's connection."""
    import threading

    from repro_torch.serving import DecodeService

    pc = PoolConfig(num_pages=64, page_tokens=8, max_pages_per_seq=8)
    eng = ServeEngine(cfg, model, pc, max_active=4, serve_threaded=threaded,
                      device=model.device)
    free0 = eng.pool.heap.free_pages()
    outs, conns, errors = [None] * len(prompts), [None] * len(prompts), []

    def client(i):
        try:
            stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=60 + i, pod="pod9")
            conns[i] = stub.connection
            outs[i] = list(stub.generate_stream.stream(prompts[i], max_new, timeout=120.0))
        except Exception as e:   # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        eng.shutdown()
    assert not errors, errors
    assert eng.pool.heap.free_pages() == free0
    assert eng.pool.stats()["sealed_pages"] == 0
    return outs, eng, conns


def test_cross_pod_streams_on_card_match_cpu(dev):
    """Phase 40 (a) at the smoke size: four client threads in another pod
    stream from a threaded engine on the card over the fallback link.
    The transport is the link, the tokens equal the CPU engine's
    cross-pod streams (a row may part only at a near-tie of the CPU's
    logits), K3 launches L x 4 and K1 L x the decode steps, no sandbox
    violation, and every page and seal comes back."""
    cfg = _card_config()
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [list(range(1, 4 + 3 * i)) for i in range(4)]
    want, _, _ = _cross_pod_streams(cfg, model, prompts, 6)
    n0, f0 = paged_attention.launches, flash_prefill_cuda.launches
    got, eng, conns = _cross_pod_streams(cfg, copy.deepcopy(model).to(dev), prompts, 6)
    assert {c.transport for c in conns} == {"fallback"}
    assert [c.target.n_calls for c in conns] == [1] * 4
    assert paged_attention.launches - n0 == cfg.num_layers * eng.decode_steps
    assert flash_prefill_cuda.launches - f0 == cfg.num_layers * 4
    assert eng.oob_events == 0
    tol = TOL[torch.bfloat16]
    for prompt, a, b in zip(prompts, want, got):
        assert len(b) == 6
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        toks = torch.tensor([prompt + a[:k]], dtype=torch.int32)
        top2 = torch.topk(model.prefill(toks)[0][0].float(), 2).values.tolist()
        assert top2[0] - top2[1] <= tol["atol"] + tol["rtol"] * abs(top2[0]), \
            f"row parts at step {k} without a near-tie: {b} vs {a}"


def _failover_streams(cfg, model, prompts, max_new):
    """Phase 41 (b) at the smoke size: an engine without a serving thread
    and a standby ``DecodeService`` (pid 13) under its endpoint name, both
    served by one lifecycle ``Endpoint``; one routed stub a prompt streams
    from the primary (pid 12) until a chaos fault lapses its lease half-way
    through the tokens, then restarts once on the standby. The
    orchestrator runs on an injected clock, so only the fault lapses a
    lease. Returns the final tokens, the restarts, the serving pids and
    the engine."""
    import threading
    import time

    from repro_torch.core import RPC, ChannelError, ChaosInjector, Endpoint, Fault, FaultPlan
    from repro_torch.serving import DecodeService

    pc = PoolConfig(num_pages=64, page_tokens=8, max_pages_per_seq=8)
    eng = ServeEngine(cfg, model, pc, max_active=len(prompts), device=model.device)
    eng.orch.clock = lambda: 0.0
    for pid in list(eng.router._renew_last):
        eng.orch.renew(pid)
    free0 = eng.pool.heap.free_pages()
    standby = RPC(eng.orch, pid=13).open("/pod0/decode-standby", heap_pages=256)
    standby.stream_pump_burst = 1
    standby.serve(DecodeService(eng))
    eng.router.register(eng.endpoint_name, standby)
    ep = Endpoint.serve([eng.channel, standby])
    inj = ChaosInjector(FaultPlan([Fault("lease_lapse", at=0.5, target=12)]),
                        orch=eng.orch, router=eng.router)
    lock, delivered = threading.Lock(), [0]
    outs, restarts, served_by, errors = ([None] * len(prompts), [0] * len(prompts),
                                         [None] * len(prompts), [])

    def client(i):
        try:
            with lock:
                stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=80 + i)
            while True:
                old = stub.connection.target
                with lock:
                    s = stub.generate_stream.stream(prompts[i], max_new, timeout=120.0)
                toks = []
                try:
                    for tok in s:
                        toks.append(tok)
                        with lock:
                            delivered[0] += 1
                            inj.poke(delivered[0] / (len(prompts) * max_new))
                    break
                except ChannelError as e:
                    assert restarts[i] == 0 and "failed over mid-stream" in str(e)
                    restarts[i] += 1
                    deadline = time.monotonic() + 60.0
                    while any(st.conn is old for st in list(old.channel._streams)):
                        assert time.monotonic() < deadline
                        time.sleep(0.001)
            outs[i], served_by[i] = toks, stub.connection.target.channel.server_pid
        except Exception as e:   # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        ep.close()
    assert not errors, errors
    assert eng.router.n_failovers == 1 and inj.n_fired == 1
    assert eng.pool.heap.free_pages() == free0
    assert eng.pool.stats()["sealed_pages"] == 0 and eng.scheduler.slots == []
    return outs, restarts, served_by, eng


def test_standby_failover_on_card_matches_cpu(dev):
    """Phase 41 (b) at the smoke size: four streams on the card's primary
    each raise the mid-stream ``ChannelError`` once when its lease lapses
    and restart on the standby; the restarted tokens equal the CPU
    engine's under the same fault (a row may part only at a near-tie of
    the CPU's logits), K3 launches L x 8 (four prefills and four
    restarts) and K1 L x the decode steps, and every page and seal comes
    back."""
    cfg = _card_config()
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [list(range(1, 4 + 3 * i)) for i in range(4)]
    want, r_cpu, s_cpu, _ = _failover_streams(cfg, model, prompts, 6)
    n0, f0 = paged_attention.launches, flash_prefill_cuda.launches
    got, restarts, served_by, eng = _failover_streams(cfg, copy.deepcopy(model).to(dev),
                                                      prompts, 6)
    assert restarts == r_cpu == [1] * 4 and served_by == s_cpu == [13] * 4
    assert paged_attention.launches - n0 == cfg.num_layers * eng.decode_steps
    assert flash_prefill_cuda.launches - f0 == cfg.num_layers * 8
    assert eng.oob_events == 0
    tol = TOL[torch.bfloat16]
    for prompt, a, b in zip(prompts, want, got):
        assert len(b) == 6
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        toks = torch.tensor([prompt + a[:k]], dtype=torch.int32)
        top2 = torch.topk(model.prefill(toks)[0][0].float(), 2).values.tolist()
        assert top2[0] - top2[1] <= tol["atol"] + tol["rtol"] * abs(top2[0]), \
            f"row parts at step {k} without a near-tie: {b} vs {a}"



def _sanitized_streams(cfg, model, prompts, max_new):
    """Phase 42 at the smoke size: a threaded engine built inside a
    ShmCheck session of the port; one client thread a prompt, polling at
    200 µs through the wait policy of its stub's connection. Returns the
    token lists, the engine and the tracer."""
    import threading

    from repro_torch.analysis import session
    from repro_torch.core.channel import BusyWaitPolicy
    from repro_torch.serving import DecodeService

    pc = PoolConfig(num_pages=64, page_tokens=8, max_pages_per_seq=8)
    outs, errors = [None] * len(prompts), []

    def client(i):
        try:
            stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=50 + i)
            stub.connection.target.wait_policy = BusyWaitPolicy(fixed_sleep_us=200.0)
            outs[i] = list(stub.generate_stream.stream(prompts[i], max_new, timeout=120.0))
        except Exception as e:   # surfaced below
            errors.append((i, e))

    with session() as tr:
        eng = ServeEngine(cfg, model, pc, max_active=4, serve_threaded=True,
                          device=model.device)
        assert eng.pool.heap._tracer is tr
        free0 = eng.pool.heap.free_pages()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
                assert not t.is_alive()
        finally:
            eng.shutdown()
    assert not errors, errors
    assert eng.pool.heap.free_pages() == free0
    assert eng.pool.stats()["sealed_pages"] == 0 and eng.scheduler.slots == []
    return outs, eng, tr


def test_sanitized_streams_on_card_match_cpu(dev):
    """Phase 42 at the smoke size: four client threads stream from a
    threaded engine on the card under the port's ShmCheck session; no
    finding on either device, the tokens equal the CPU engine's (a row may
    part only at a near-tie of the CPU's logits), K3 launches L x 4 and K1
    L x the decode steps, oob 0, and every page, seal and slot comes
    back."""
    cfg = _card_config()
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [list(range(1, 4 + 3 * i)) for i in range(4)]
    want, _, tr_cpu = _sanitized_streams(cfg, model, prompts, 6)
    n0, f0 = paged_attention.launches, flash_prefill_cuda.launches
    got, eng, tr = _sanitized_streams(cfg, copy.deepcopy(model).to(dev), prompts, 6)
    assert tr_cpu.findings == [] and tr.findings == [], [str(f) for f in tr.findings]
    assert tr.n_events > 0
    assert paged_attention.launches - n0 == cfg.num_layers * eng.decode_steps
    assert flash_prefill_cuda.launches - f0 == cfg.num_layers * 4
    assert eng.oob_events == 0
    tol = TOL[torch.bfloat16]
    for prompt, a, b in zip(prompts, want, got):
        assert len(b) == 6
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        toks = torch.tensor([prompt + a[:k]], dtype=torch.int32)
        top2 = torch.topk(model.prefill(toks)[0][0].float(), 2).values.tolist()
        assert top2[0] - top2[1] <= tol["atol"] + tol["rtol"] * abs(top2[0]), \
            f"row parts at step {k} without a near-tie: {b} vs {a}"

# -- K4: the SSD intra-chunk kernel ------------------------------------------
def _ssd_inputs(B, S, H, P, N, dtype, seed=0, decay="strong"):
    """``strong``: mamba2's init (A = -linspace(1, 16), dt = softplus(N(0,1)
    + dt_bias)), whose 128-token chunk decays pass 88; ``weak``: small
    steps, so each chunk carries most of its state into the next."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g)
    Bm = torch.randn((B, S, N), generator=g)
    Cm = torch.randn((B, S, N), generator=g)
    if decay == "strong":
        u = torch.rand((H,), generator=g)
        dt_bias = torch.log(torch.expm1(torch.exp(-6.9078 + u * 4.6052)))
        dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g) + dt_bias)
        A = -torch.linspace(1.0, 16.0, H)
    else:
        dt = 0.005 + 0.045 * torch.rand((B, S, H), generator=g)
        A = -torch.linspace(0.1, 1.0, H)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


def _close_scaled(got, want, rel=1e-4):
    """Kernel and plain version see the same inputs and both accumulate in
    fp32: they differ by summation order, so atol scales with the output."""
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rel,
                               atol=rel * max(want.abs().max().item(), 1.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_matches_plain_at_slice_shape(dev, dtype):
    """mamba2-1.3b's SSD at B 8, S 512 (4 chunks of 128), H 64, P 64, N 128,
    with chunk decays that overflow an unmasked exp."""
    args = [a.to(dev) for a in _ssd_inputs(8, 512, 64, 64, 128, dtype)]
    cum_last = (args[1] * args[2]).reshape(8, 4, 128, 64).sum(2)
    assert (-cum_last > 88).any()
    n0 = ssd_intra_chunk_cuda.launches
    got = ssd_intra_chunk_cuda(*args, 128)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_cuda.launches == n0 + 1
    for g, w in zip(got, ssd_intra_chunk_ref(*args, 128)):
        _close_scaled(g, w)


# (S, chunk, H, P, N) for the bf16 kernel alone: the ragged shapes of the
# chunked sweep below at one and at three chunks, a chunk of 100 (not a
# multiple of 16) and odd P and N (element loads, 4-byte stores)
K4_BF16_CASES = [(m * Q, Q, H, P, N) for Q, H, P, N in ((16, 8, 16, 16), (16, 64, 16, 128),
                                                        (128, 8, 64, 16), (128, 12, 24, 17))
                 for m in (1, 3)] + [(100, 128, 12, 24, 17), (100, 128, 64, 64, 128),
                                     (120, 40, 3, 17, 9)]


@pytest.mark.parametrize("S,chunk,H,P,N", K4_BF16_CASES)
def test_ssd_kernel_bf16_matches_plain_at_ragged_shapes(dev, S, chunk, H, P, N):
    """The tensor-core bf16 kernel at every tile edge it zero-fills, with
    mamba2's strong decays, against the plain version at the slice test's
    tolerance."""
    args = [a.to(dev) for a in _ssd_inputs(2, S, H, P, N, torch.bfloat16, seed=S + H)]
    n0 = ssd_intra_chunk_cuda.launches
    got = ssd_intra_chunk_cuda(*args, chunk)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_cuda.launches == n0 + 1
    for g, w in zip(got, ssd_intra_chunk_ref(*args, chunk)):
        _close_scaled(g, w)


@pytest.mark.parametrize("S", [16, 100, 300])
@pytest.mark.parametrize("Q,H,P,N", [(16, 8, 16, 16), (128, 64, 64, 128),
                                     (16, 64, 16, 128), (128, 8, 64, 16),
                                     (128, 12, 24, 17)])   # ragged head block and tiles
def test_ssd_chunked_on_card_matches_recurrence(dev, S, Q, H, P, N):
    """The kernel through ``ops.ssd_chunked`` (pad path, S < Q) against the
    token-by-token recurrence, at tests/test_kernels.py:165's 2e-3."""
    x, dt, A, Bm, Cm = [a.to(dev) for a in _ssd_inputs(2, S, H, P, N, torch.float32,
                                                        seed=S + Q, decay="weak")]
    n0 = ssd_intra_chunk_cuda.launches
    y, s = ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], chunk=Q)
    assert ssd_intra_chunk_cuda.launches == n0 + 1
    ys, ss = ssd_sequential_ref(x, dt, A, Bm[:, :, None], Cm[:, :, None])
    torch.testing.assert_close(y, ys, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(s, ss, atol=2e-3, rtol=2e-3)


def test_ssd_chunked_on_card_continues_from_a_state(dev):
    x, dt, A, Bm, Cm = [a.to(dev) for a in _ssd_inputs(2, 300, 8, 64, 128, torch.float32,
                                                        seed=5, decay="weak")]
    Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    _, s1 = ssd_chunked(x[:, :200], dt[:, :200], A, Bm[:, :200], Cm[:, :200], chunk=128)
    y2, s2 = ssd_chunked(x[:, 200:], dt[:, 200:], A, Bm[:, 200:], Cm[:, 200:], chunk=128,
                         init_state=s1)
    ys, ss = ssd_sequential_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y2, ys[:, 200:], atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(s2, ss, atol=2e-3, rtol=2e-3)


def test_mamba2_prefill_on_card_runs_the_kernel_and_matches_cpu(dev):
    cfg = get_smoke_config("mamba2_1p3b")
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab_size, size=(2, 37)).astype(np.int32))
    lc, cc = model.prefill(toks)
    model_d = copy.deepcopy(model).to(dev)
    n0 = ssd_intra_chunk_cuda.launches
    ld, cd = model_d.prefill(toks.to(dev))
    assert ssd_intra_chunk_cuda.launches == n0 + cfg.num_layers
    torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])
    torch.testing.assert_close(cd["pos0"]["ssm"]["ssd"].cpu(), cc["pos0"]["ssm"]["ssd"],
                               **TOL[torch.bfloat16])


# -- K3: the flash-prefill kernel --------------------------------------------
def _k3_inputs(B, S, Hq, Hkv, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])     # 256 in f32: 216 KB of shared memory
@pytest.mark.parametrize("heads", [(4, 2), (8, 8), (4, 1), (32, 4), (16, 8), (16, 16),
                                   (28, 4)])
def test_flash_prefill_kernel_matches_plain(dev, dtype, D, heads):
    """S 64/100/256/1000 (ragged tiles at 100 and 1000), window 0/32,
    softcap 0/30: the kernel against its plain version on the card, at
    K1's kernel tolerance (both sides accumulate in fp32)."""
    Hq, Hkv = heads
    for S in (64, 100, 256, 1000):
        q, k, v = [t.to(dev) for t in _k3_inputs(2 if S < 1000 else 1, S, Hq, Hkv, D,
                                                   dtype, seed=S + D)]
        for window in (0, 32):
            for softcap in (0.0, 30.0):
                n0 = flash_prefill_cuda.launches
                got = flash_prefill(q, k, v, window=window, softcap=softcap)
                torch.cuda.synchronize()
                assert flash_prefill_cuda.launches == n0 + 1
                assert got.dtype == dtype and torch.isfinite(got.float()).all()
                want = flash_prefill_ref(q, k, v, window=window, softcap=softcap)
                torch.testing.assert_close(got.float(), want.float(), **K1_TOL[dtype],
                                           msg=lambda m: f"S={S} window={window} "
                                                         f"softcap={softcap}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,window,softcap", [
    (1, 0, 0.0), (1, 5, 0.0), (65, 1, 0.0), (130, 64, 0.0), (200, 65, 0.0), (300, 17, 0.0),
    (1, 0, 30.0), (37, 0, 30.0), (37, 16, 30.0)])
def test_flash_prefill_kernel_edge_windows(dev, S, window, softcap, D, dtype):
    """A single token, a window of one (each row sees only itself), a
    window narrower than a tile (rows of a tile that see none of its keys
    keep m = -inf), windows at the tile size, where whole key tiles fall
    below the window for some rows of a query tile and not for others, and
    fewer rows than one query tile with a softcap (the key tile is zero
    past S)."""
    q, k, v = [t.to(dev) for t in _k3_inputs(2, S, 4, 2, D, dtype, seed=S)]
    got = flash_prefill_cuda(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = flash_prefill_ref(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL[dtype])
    if window == 1 or S == 1:
        torch.testing.assert_close(got, v.repeat_interleave(2, dim=2), **K1_TOL[dtype])


def test_flash_prefill_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = [t.to(dev) for t in _k3_inputs(1, 70, 4, 2, 64, torch.float32)]
    n0 = flash_prefill_cuda.launches
    with pytest.raises(ValueError, match="dtype"):
        flash_prefill(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill(*[t[..., :48] for t in (q, k, v)])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_prefill(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="share a dtype"):
        flash_prefill(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="window"):
        flash_prefill(q, k, v, window=-1)
    assert flash_prefill_cuda.launches == n0


def test_gemma3_prefill_and_decode_on_card_match_cpu(dev):
    """gemma3's smoke shape with the kernel's smallest head_dim (64):
    5 local layers (window 8) and 1 global. Prefill 20 tokens (past the
    window) on the card through the kernel, then 6 decode steps through
    the rings, against the same model on the CPU."""
    cfg = replace(get_smoke_config("gemma3_12b"), head_dim=64)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(2, 26)).astype(np.int32))
    lc, cc = model.prefill(toks[:, :20], cache_len=26)
    model_d = copy.deepcopy(model).to(dev)
    n0 = flash_prefill_cuda.launches
    ld, cd = model_d.prefill(toks[:, :20].to(dev), cache_len=26)
    assert flash_prefill_cuda.launches == n0 + cfg.num_layers
    torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])
    for t in range(20, 26):
        pos = torch.full((2,), t, dtype=torch.int32)
        lc, cc = model.decode_step(toks[:, t], pos, cc)
        ld, cd = model_d.decode_step(toks[:, t].to(dev), pos.to(dev), cd)
        torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])
    for i in range(cfg.num_layers):
        assert torch.equal(cd[f"pos{i}"]["self"]["pos"].cpu(), cc[f"pos{i}"]["self"]["pos"])


# -- the MoE families ----------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq,Hkv,D", [(16, 8, 64), (32, 4, 128)])
def test_flash_prefill_kernel_at_moe_prefill_shapes(dev, Hq, Hkv, D, dtype):
    """granite-moe-1b-a400m's (16/8 at head_dim 64) and qwen3-moe-30b-a3b's
    (32/4 at 128) prefill of a 509-token prompt, at K1's kernel tolerance."""
    q, k, v = [t.to(dev) for t in _k3_inputs(1, 509, Hq, Hkv, D, dtype, seed=D)]
    n0 = flash_prefill_cuda.launches
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill_cuda.launches == n0 + 1
    want = flash_prefill_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **K1_TOL[dtype])


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_moe_prefill_and_decode_on_card_match_cpu(dev, arch, dropless):
    """The smoke config at head_dim 64 (the kernel's smallest): a prefill
    through the kernel and 6 decode steps on the card, with capacity
    routing or under ``dropless_moe()``, against the same model on the
    CPU."""
    from repro_torch.models.moe import dropless_moe

    cfg = replace(get_smoke_config(arch), head_dim=64)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(2, 26)).astype(np.int32))
    model_d = copy.deepcopy(model).to(dev)
    with dropless_moe(dropless):
        lc, cc = model.prefill(toks[:, :20], cache_len=26)
        n0 = flash_prefill_cuda.launches
        ld, cd = model_d.prefill(toks[:, :20].to(dev), cache_len=26)
        assert flash_prefill_cuda.launches == n0 + cfg.num_layers
        torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])
        for t in range(20, 26):
            pos = torch.full((2,), t, dtype=torch.int32)
            lc, cc = model.decode_step(toks[:, t], pos, cc)
            ld, cd = model_d.decode_step(toks[:, t].to(dev), pos.to(dev), cd)
            torch.testing.assert_close(ld.cpu(), lc, **TOL[torch.bfloat16])


# -- the hybrid (jamba-v0.1-52b) -----------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_matches_plain_at_jamba_shape(dev, dtype):
    """jamba's SSD at B 8, S 512 (4 chunks of 128), H 128, P 64, N 16 (the
    bf16 kernel's N tiles mostly zero fill), with its init's chunk decays,
    which pass 88."""
    args = [a.to(dev) for a in _ssd_inputs(8, 512, 128, 64, 16, dtype, seed=16)]
    cum_last = (args[1] * args[2]).reshape(8, 4, 128, 128).sum(2)
    assert (-cum_last > 88).any()
    n0 = ssd_intra_chunk_cuda.launches
    got = ssd_intra_chunk_cuda(*args, 128)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_cuda.launches == n0 + 1
    for g, w in zip(got, ssd_intra_chunk_ref(*args, 128)):
        _close_scaled(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_prefill_kernel_at_jamba_prefill_shape(dev, dtype):
    """jamba's attention layer (32/8 heads at head_dim 128, no positions)
    over a 509-token prompt, at K1's kernel tolerance."""
    q, k, v = [t.to(dev) for t in _k3_inputs(1, 509, 32, 8, 128, dtype, seed=8)]
    n0 = flash_prefill_cuda.launches
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill_cuda.launches == n0 + 1
    torch.testing.assert_close(got.float(), flash_prefill_ref(q, k, v).float(), **K1_TOL[dtype])


@pytest.mark.parametrize("layers", [8, 16])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_jamba_prefill_and_decode_on_card_match_cpu(dev, layers, dropless):
    """jamba's smoke config at head_dim 64 (the kernel's smallest), 8 and
    16 layers: a 20-token prefill through K3 (one launch an attention
    layer) and K4 (one an SSM layer), then 6 decode steps, with capacity
    routing or under ``dropless_moe()``, against the same model on the
    CPU. In fp32 at the decode-chain tolerance (tests/test_arch_smoke.py:
    113); bf16 is held layer by layer by the next test."""
    from repro_torch.models.moe import dropless_moe

    cfg = replace(get_smoke_config("jamba_v01_52b"), head_dim=64, num_layers=layers)
    pattern = cfg.block_pattern()
    n_attn = cfg.num_blocks * sum(s.kind == "attn" for s in pattern)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu").float()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, size=(2, 26)).astype(np.int32))
    model_d = copy.deepcopy(model).to(dev)
    chain = dict(atol=1e-3, rtol=0)
    with dropless_moe(dropless):
        lc, cc = model.prefill(toks[:, :20], cache_len=26)
        f0, s0 = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
        ld, cd = model_d.prefill(toks[:, :20].to(dev), cache_len=26)
        assert flash_prefill_cuda.launches - f0 == n_attn
        assert ssd_intra_chunk_cuda.launches - s0 == cfg.num_layers - n_attn
        torch.testing.assert_close(ld.cpu(), lc, **chain)
        for t in range(20, 26):
            pos = torch.full((2,), t, dtype=torch.int32)
            lc, cc = model.decode_step(toks[:, t], pos, cc)
            ld, cd = model_d.decode_step(toks[:, t].to(dev), pos.to(dev), cd)
            torch.testing.assert_close(ld.cpu(), lc, **chain)
    torch.testing.assert_close(cd["pos0"]["ssm"]["ssd"].cpu(), cc["pos0"]["ssm"]["ssd"], **chain)
    assert torch.equal(cd["pos4"]["self"]["pos"].cpu(), cc["pos4"]["self"]["pos"])


@pytest.mark.parametrize("layers", [8, 16])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_jamba_bf16_layers_on_card_match_cpu(dev, layers, dropless):
    """jamba's smoke config at head_dim 64 in bf16, the experts redrawn at
    std 1/√fan-in (``torch_forcing.expert_draws``): a 20-token prefill and
    6 decode steps, each layer on the card taking the CPU's input to that
    layer (``torch_forcing.forced``). Every layer's output, every leaf of
    its cache and the logits, at the prefill and after every step, at the
    bf16 tolerance; at the MoE layers a token the two routers keep on
    different experts is exempt, and only on a near-tie. Two whole bf16
    chains part past that tolerance (tests/test_torch_hybrid.py). The
    prefill launches K3 once an attention layer and K4 once an SSM layer,
    and once more an MoE layer, where the router's input is recomputed."""
    cfg = replace(get_smoke_config("jamba_v01_52b"), head_dim=64, num_layers=layers)
    pattern = cfg.block_pattern()
    n_attn = cfg.num_blocks * sum(s.kind == "attn" for s in pattern)
    n_moe = cfg.num_blocks * sum(s.moe for s in pattern)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for pos, draws in expert_draws(cfg).items():
            for name, w in draws.items():
                model["stack"][pos]["moe"][name].copy_(torch.from_numpy(w))
    assert model["stack"]["pos1"]["moe"]["w_gate"].dtype == torch.bfloat16
    model_d = copy.deepcopy(model).to(dev)
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, size=(2, 26)).astype(np.int32)
    f0, s0 = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
    rows, ties = forced(TorchSide(model), TorchSide(model_d), toks, 20, dropless)
    assert flash_prefill_cuda.launches - f0 == n_attn
    assert ssd_intra_chunk_cuda.launches - s0 == cfg.num_layers - n_attn + n_moe
    check_forced(rows, ties, TOL[torch.bfloat16])


# -- the encoder–decoder (whisper-base) and the serving CLI ------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 4, 63, 224])
def test_flash_prefill_kernel_at_whisper_decoder_shapes(dev, S, dtype):
    """whisper's decoder self-attention prefill (8/8 heads at head_dim 64)
    over prompts of 1 to 224 tokens, the shortest a fraction of one
    64-query tile, at K1's kernel tolerance."""
    q, k, v = [t.to(dev) for t in _k3_inputs(1, S, 8, 8, 64, dtype, seed=S)]
    n0 = flash_prefill_cuda.launches
    got = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill_cuda.launches == n0 + 1
    torch.testing.assert_close(got.float(), flash_prefill_ref(q, k, v).float(), **K1_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_prefill_and_decode_on_card_match_cpu(dev, dtype):
    """whisper's smoke config at head_dim 64 (the kernel's smallest): a
    20-token prefill over 32 frames on the card (the decoder's
    self-attention through K3, one launch a decoder layer; the encoder and
    the cross-attention through ``_attend``), then 6 decode steps, against
    the same model on the CPU: every cache leaf and the logits, fp32 at
    the decode-chain tolerance (tests/test_arch_smoke.py:113), bf16 at
    5e-2 + 5e-2·|x|. Decode leaves the cross caches on the card bitwise as
    the prefill wrote them."""
    cfg = replace(get_smoke_config("whisper_base"), head_dim=64)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu").to(dtype)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, 26)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)).to(dtype)
    tol = dict(atol=1e-3, rtol=0) if dtype == torch.float32 else TOL[torch.bfloat16]
    model_d = copy.deepcopy(model).to(dev)
    lc, cc = model.prefill(toks[:, :20], cache_len=26, frames=frames)
    n0 = flash_prefill_cuda.launches
    ld, cd = model_d.prefill(toks[:, :20].to(dev), cache_len=26, frames=frames.to(dev))
    assert flash_prefill_cuda.launches == n0 + cfg.num_layers
    torch.testing.assert_close(ld.cpu(), lc, **tol)
    for part in ("self", "cross"):
        for name, leaf in cc["pos0"][part].items():
            torch.testing.assert_close(cd["pos0"][part][name].cpu(), leaf, **tol)
    cross = {k: v.clone() for k, v in cd["pos0"]["cross"].items()}
    for t in range(20, 26):
        pos = torch.full((2,), t, dtype=torch.int32)
        lc, cc = model.decode_step(toks[:, t], pos, cc)
        ld, cd = model_d.decode_step(toks[:, t].to(dev), pos.to(dev), cd)
        torch.testing.assert_close(ld.cpu(), lc, **tol)
    assert all(torch.equal(cd["pos0"]["cross"][k], v) for k, v in cross.items())


def test_serve_cli_on_card_runs_through_the_kernels(dev, capsys):
    """``repro_torch.launch.serve.main`` with no ``--device`` serves on the
    card: K3 once a layer per prefill, K1 once a layer per decode step, no
    sandbox violation."""
    from repro_torch.launch import serve

    k1, k3 = paged_attention.launches, flash_prefill_cuda.launches
    eng = serve.main(["--requests", "4", "--max-new", "4", "--layers", "2"])
    out = capsys.readouterr().out
    assert eng.device.type == "cuda" and eng.oob_events == 0
    assert "sandbox violations: 0" in out
    assert flash_prefill_cuda.launches - k3 == 2 * 4
    assert paged_attention.launches - k1 == 2 * eng.decode_steps > 0


# -- training: the kernels' gradients, loss_fn, train steps, the CLI ----------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 0.0), (0, 30.0)])
def test_flash_prefill_function_grads_on_card(dev, dtype, window, softcap):
    """``ops.flash_prefill`` on the card goes through ``FlashPrefillFn``: one
    launch, an output with a ``grad_fn``, and the grads of
    ``flash_prefill_vjp`` applied to the plain forward, at K3's tolerance."""
    from repro_torch.kernels.flash_prefill import flash_prefill_vjp

    q, k, v = [t.to(dev).requires_grad_() for t in _k3_inputs(2, 300, 8, 4, 128, dtype, seed=9)]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(dev, dtype)
    n0 = flash_prefill_cuda.launches
    out = flash_prefill(q, k, v, window=window, softcap=softcap)
    assert flash_prefill_cuda.launches == n0 + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    with torch.no_grad():
        plain = flash_prefill_ref(q, k, v, window=window, softcap=softcap)
        want = flash_prefill_vjp(q, k, v, plain, dout, window=window, softcap=softcap)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_prefill_kernel_lse_matches_plain(dev, dtype, D):
    """The forward's row log-sum-exp against the plain version's, its
    output bitwise the one without it; S 100 and 300 (ragged tiles), GQA
    2, window 0/32, softcap 0/30."""
    for S in (100, 300):
        q, k, v = [t.to(dev) for t in _k3_inputs(2, S, 4, 2, D, dtype, seed=S + D)]
        for window in (0, 32):
            for softcap in (0.0, 30.0):
                out, lse = flash_prefill_cuda(q, k, v, window=window, softcap=softcap,
                                              return_lse=True)
                assert lse.dtype == torch.float32 and lse.shape == (2, 4, S)
                assert torch.equal(out, flash_prefill_cuda(q, k, v, window=window,
                                                           softcap=softcap))
                _, want = flash_prefill_ref(q, k, v, window=window, softcap=softcap,
                                            return_lse=True)
                torch.testing.assert_close(lse, want, **TOL[torch.float32])


# (S, window, softcap): ragged S, windows narrower and wider than a tile,
# a window of one, a softcap with and without a window
K3_BWD_EDGES = [(1, 0, 0.0), (37, 0, 30.0), (65, 1, 0.0), (100, 32, 0.0), (130, 64, 0.0),
                (200, 65, 5.0), (300, 0, 0.0), (300, 17, 0.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["gqa1", "gqa2"])
def test_flash_prefill_bwd_kernel_matches_plain(dev, dtype, D, heads):
    """The backward kernel against ``flash_prefill_vjp`` given the same
    forward output and lse (its formulation), at K3's kernel tolerance:
    both sides accumulate in fp32; bf16 grads differ by their rounding."""
    from repro_torch.kernels.flash_prefill import flash_prefill_vjp
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda

    Hq, Hkv = heads
    for S, window, softcap in K3_BWD_EDGES:
        q, k, v = [t.to(dev) for t in _k3_inputs(2, S, Hq, Hkv, D, dtype, seed=S + D)]
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(S)).to(dev, dtype)
        out, lse = flash_prefill_cuda(q, k, v, window=window, softcap=softcap, return_lse=True)
        n0 = flash_prefill_bwd_cuda.launches
        got = flash_prefill_bwd_cuda(q, k, v, out, dout, lse, window=window, softcap=softcap)
        torch.cuda.synchronize()
        assert flash_prefill_bwd_cuda.launches == n0 + 1
        want = flash_prefill_vjp(q, k, v, out, dout, window=window, softcap=softcap, lse=lse)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dtype and torch.isfinite(g.float()).all()
            torch.testing.assert_close(g.float(), w.float(), **K1_TOL[dtype],
                                       msg=lambda m: f"{name} S={S} window={window} "
                                                     f"softcap={softcap}: {m}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [128, 256])
def test_flash_prefill_bwd_kernel_is_bitwise_repeatable(dev, dtype, D):
    """Two calls on the same inputs give the same bits (no atomics): the
    training CLI's resume and the sharded losses rest on it."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda

    q, k, v = [t.to(dev) for t in _k3_inputs(2, 333, 8, 4, D, dtype, seed=4)]
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)).to(dev, dtype)
    out, lse = flash_prefill_cuda(q, k, v, window=100, softcap=20.0, return_lse=True)
    first = flash_prefill_bwd_cuda(q, k, v, out, dout, lse, window=100, softcap=20.0)
    again = flash_prefill_bwd_cuda(q, k, v, out, dout, lse, window=100, softcap=20.0)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_prefill_function_backward_is_one_kernel_call(dev, monkeypatch):
    """On the card ``FlashPrefillFn``'s backward is one call of the backward
    kernel's wrapper and never the plain gradient."""
    import repro_torch.kernels.flash_prefill.ops as k3_ops
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda

    def plain(*a, **kw):
        raise AssertionError("flash_prefill_vjp ran on the card")
    monkeypatch.setattr(k3_ops, "flash_prefill_vjp", plain)
    q, k, v = [t.to(dev).requires_grad_()
               for t in _k3_inputs(2, 200, 8, 4, 128, torch.bfloat16, seed=6)]
    out = flash_prefill(q, k, v, window=64)
    n0 = flash_prefill_bwd_cuda.launches
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert flash_prefill_bwd_cuda.launches == n0 + 1
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_grads_on_card_stay_finite_above_88(dev, dtype):
    """``ssd_chunked`` on the card goes through ``SsdIntraChunkFn``: one K4
    launch, and finite grads at chunk decays above 88 equal to those of
    the plain version's chunked scan on the card."""
    import repro_torch.kernels.ssd.ops as ssd_ops

    x, dt, A, Bm, Cm = [a.to(dev) for a in _ssd_inputs(2, 256, 16, 64, 128, dtype, seed=5)]
    Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    w = torch.randn((2, 256, 16, 64), generator=torch.Generator().manual_seed(2)).to(dev)

    def grads(intra):
        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        saved = ssd_ops.ssd_intra_chunk
        ssd_ops.ssd_intra_chunk = intra
        try:
            y, s = ssd_chunked(*leaves, chunk=128)
        finally:
            ssd_ops.ssd_intra_chunk = saved
        return torch.autograd.grad((y.float() * w).sum() + s.sum(), leaves)

    n0 = ssd_intra_chunk_cuda.launches
    got = grads(ssd_ops.ssd_intra_chunk)
    assert ssd_intra_chunk_cuda.launches == n0 + 1
    want = grads(ssd_intra_chunk_ref)
    for g, ww in zip(got, want):
        assert g.dtype == ww.dtype and torch.isfinite(g.float()).all()
        if dtype == torch.float32:
            _close_scaled(g, ww, rel=1e-3)
        else:
            torch.testing.assert_close(g.float(), ww.float(), **TOL[torch.bfloat16])


def test_kernel_wrappers_refuse_inputs_that_require_grad_on_card(dev):
    q, k, v = [t.to(dev) for t in _k3_inputs(1, 64, 2, 2, 64, torch.bfloat16)]
    n0 = flash_prefill_cuda.launches
    with pytest.raises(ValueError, match="require grad"):
        flash_prefill_cuda(q.requires_grad_(), k, v)
    x, dt, A, Bm, Cm = [a.to(dev) for a in _ssd_inputs(1, 128, 8, 16, 16, torch.float32)]
    with pytest.raises(ValueError, match="require grad"):
        ssd_intra_chunk_cuda(x.requires_grad_(), dt, A, Bm, Cm, 128)
    with torch.no_grad():
        flash_prefill_cuda(q, k, v)
    assert flash_prefill_cuda.launches == n0 + 1


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_1p3b", "jamba_v01_52b", "gemma3_12b"])
def test_loss_and_grads_on_card_match_cpu(dev, arch):
    """fp32 smoke model: ``loss_fn`` and every gradient on the card (K3 and
    K4 forwards, their Functions' backwards, two launches a kernel layer
    under remat) against the CPU's plain path; head_dim 64, the kernel's
    smallest."""
    cfg = replace(get_smoke_config(arch), head_dim=64)
    cpu = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    for prm in cpu.parameters():
        prm.data = prm.data.float()
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    grads = {}
    for name, m in (("cpu", cpu), ("card", card)):
        m.trainable()
        b = {k: v.to(m.device) for k, v in batch.items()}
        n3, n4 = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
        loss, _ = m.loss_fn(b)
        leaves = list(m.parameters())
        grads[name] = (loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(loss, leaves)])
        launches = (flash_prefill_cuda.launches - n3, ssd_intra_chunk_cuda.launches - n4)
    attn = sum(spec.kind == "attn" for spec in cfg.block_pattern()) * cfg.num_blocks
    assert launches == (2 * attn, 2 * (cfg.num_layers - attn))
    torch.testing.assert_close(grads["card"][0], grads["cpu"][0], rtol=1e-5, atol=1e-5)
    for g, w in zip(grads["card"][1], grads["cpu"][1]):
        _close_scaled(g, w, rel=1e-3)


def test_train_steps_on_card_lower_the_loss(dev):
    """bf16 olmo smoke on the card, one batch, 30 steps at lr 3e-3: the
    reference's bar (the loss falls by 0.5), K3 twice a layer a step;
    head_dim 64."""
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticPackedDataset,
                                      init_opt_state, make_train_step)

    cfg = replace(get_smoke_config("olmo_1b"), head_dim=64)
    m = build_model(cfg).init(torch.Generator().manual_seed(0), dev)
    step = make_train_step(m, AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                                          weight_decay=0.0))
    state = init_opt_state(m.params())
    batch = SyntheticPackedDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                              global_batch=8, seed=1)).batch_at(0)
    n0, losses = flash_prefill_cuda.launches, []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert flash_prefill_cuda.launches - n0 == 30 * 2 * cfg.num_layers
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert state["m"]["embed"]["tok"].device.type == "cuda"


def test_train_cli_on_card_resumes_bitwise(dev, capsys, tmp_path):
    """``repro_torch.launch.train.main`` with no ``--device`` trains on the
    card through K3; a run that crashed after step 2's checkpoint and
    resumed ends with the uninterrupted run's parameters."""
    from repro_torch.launch import train

    argv = ["--steps", "4", "--d-model", "128", "--layers", "2", "--batch", "2", "--seq",
            "64", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    n0 = flash_prefill_cuda.launches
    whole = train.main(argv)
    assert whole["model"].device.type == "cuda"
    assert flash_prefill_cuda.launches - n0 == 4 * 2 * 2
    shutil.rmtree(tmp_path / "step_000000004")
    resumed = train.main(argv + ["--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    for a, b in zip(resumed["model"].parameters(), whole["model"].parameters()):
        assert torch.equal(a, b)


@pytest.fixture
def mesh111(dev, tmp_path):
    """A (1, 1, 1) pod/data/model mesh on a world-size-1 NCCL group (a
    FileStore rendezvous, no network)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_1p3b"])
def test_sharded_loss_and_grads_on_card_equal_the_unsharded_bitwise(dev, mesh111, arch):
    """Two layers at full width, bf16: ``loss_fn`` and every gradient with
    DTensor parameters under the rules on a (1, 1, 1) mesh, K3/K4 on the
    local shards (twice a layer under remat), equal to the unsharded
    model's bitwise."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (distribute, distribute_model, input_specs,
                                             rules_for, sharding_tree)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import use_rules

    cfg = replace(get_config(arch), num_layers=2)
    B, S = 2, 256
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    rules = rules_for(cfg, ShapeConfig("t", S, B, "train"), mesh111)
    out = {}
    for name in ("plain", "sharded"):
        m = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
        if name == "sharded":
            distribute_model(m, sharding_tree(m.axes(), rules, mesh111))
        m.trainable()
        leaves = list(m.parameters())
        n3, n4 = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
        if name == "plain":
            loss, _ = m.loss_fn(batch)
            grads = torch.autograd.grad(loss, leaves)
        else:
            _, shardings = input_specs(cfg, ShapeConfig("t", S, B, "train"), rules, mesh111)
            with use_rules(rules, mesh111), implicit_replication():
                loss, _ = m.loss_fn({k: distribute(v, shardings[k]) for k, v in batch.items()})
                grads = torch.autograd.grad(loss, leaves)
            loss, grads = loss.full_tensor(), [g.full_tensor() for g in grads]
        out[name] = (loss, grads, (flash_prefill_cuda.launches - n3,
                                   ssd_intra_chunk_cuda.launches - n4))
        del m
    attn = sum(spec.kind == "attn" for spec in cfg.block_pattern()) * cfg.num_blocks
    assert out["sharded"][2] == out["plain"][2] == (2 * attn, 2 * (cfg.num_layers - attn))
    assert torch.equal(out["sharded"][0], out["plain"][0])
    for g, w in zip(out["sharded"][1], out["plain"][1]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_shards", [1, None])
def test_compressed_psum_on_card_equals_the_cpu(dev, mesh111, n_shards):
    """Two rounds of ``compressed_psum`` with error feedback over the pod
    axis (NCCL, world size 1) on a smoke tree of bf16 and fp32 leaves,
    against the same on the CPU over a gloo group: the codes' dtype on the
    wire, and ĝ and the error state equal outside half-integer ties."""
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.training.grad_comp import compressed_psum, init_error_state

    rng = np.random.default_rng(4)
    shapes = {"w": ((64, 48), torch.bfloat16), "b": ((48,), torch.float32),
              "stack": ((2, 16, 32), torch.bfloat16)}
    cpu = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
           for k, (s, dt) in shapes.items()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    gloo = dist.new_group(ranks=[0], backend="gloo")
    wires = []
    real = dist.all_reduce

    def spy(tensor, *args, **kwargs):
        wires.append((tensor.device.type, tensor.dtype))
        return real(tensor, *args, **kwargs)

    e_cpu, e_card = init_error_state(cpu), init_error_state(card)
    with mock.patch.object(dist, "all_reduce", spy):
        for _ in range(2):
            g_cpu, e_cpu_new = compressed_psum(cpu, e_cpu, gloo, n_shards=n_shards)
            g_card, e_card_new = compressed_psum(card, e_card, mesh111.get_group("pod"),
                                                 n_shards=n_shards)
            for k in cpu:
                gf = cpu[k].float() + e_cpu[k]
                scale = gf.abs().max() / 127.0 + 1e-12
                t = (gf / scale).abs()
                fine = (torch.abs(t - torch.floor(t) - 0.5) >= 2e-5)
                assert g_card[k].dtype == cpu[k].dtype
                torch.testing.assert_close(g_card[k].cpu()[fine], g_cpu[k][fine], atol=0, rtol=0)
                torch.testing.assert_close(e_card_new[k].cpu()[fine], e_cpu_new[k][fine],
                                           atol=1e-7, rtol=0)
            e_cpu, e_card = e_cpu_new, e_card_new
    want = torch.int8 if n_shards else torch.int32
    for device in ("cpu", "cuda"):
        seen = [d for t, d in wires if t == device]
        assert seen == [torch.float32, want, want, want] * 2


def test_pipeline_on_card_equals_the_cpu(dev, mesh111):
    """``pipeline_apply`` with yi_9b smoke's stack (fp32, the kernel's
    smallest head_dim 64) as the one stage of the pod axis, 8 rows in 4
    microbatches: the card (K3, L x 4 launches) against the CPU (the plain
    version) at fp32's tolerance, and the card bitwise the stack on each
    microbatch in turn."""
    from repro_torch.models.transformer import apply_stack_full
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.pipeline import pipeline_apply

    cfg = replace(get_smoke_config("yi_9b"), head_dim=64)
    m = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    stack_cpu = tree_map(lambda a: a.detach().float(), m.params()["stack"])
    x_cpu = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8, 24, cfg.d_model)).astype(np.float32))

    def stage(h, params):
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)[None].expand(
            h.shape[0], -1)
        return apply_stack_full(h, params, cfg, pos)[0]

    out = {}
    for name, d in (("cpu", "cpu"), ("card", dev)):
        stack = tree_map(lambda a: a.to(d), stack_cpu)
        n0 = flash_prefill_cuda.launches
        with torch.no_grad():
            out[name] = pipeline_apply(stage, x_cpu.to(d), tree_map(lambda a: a[None], stack),
                                       mesh=mesh111, axis="pod", n_micro=4)
            if name == "card":
                assert flash_prefill_cuda.launches - n0 == cfg.num_layers * 4
                want = torch.cat([stage(x_cpu[i:i + 2].to(d), stack) for i in range(0, 8, 2)])
                assert torch.equal(out[name], want)
    torch.testing.assert_close(out["card"].cpu(), out["cpu"], **TOL[torch.float32])
