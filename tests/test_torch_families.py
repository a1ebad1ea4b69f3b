"""The model families the paged engine serves beside yi-9b — olmo-1b
(non-parametric LayerNorm, MHA), yi-6b and qwen2-vl-7b (M-RoPE, q/k/v
biases, caller-given position triples) — in the port against the
reference on the same weights and inputs: the building blocks, the init
tree, prefill logits and caches, fp32 teacher-forced decode, image-like
M-RoPE prefill, and what the paged engine refuses.

Tolerances: bf16 logits and caches ``atol=rtol=5e-2``
(tests/test_kernels.py:30), fp32 decode chains ``1e-3``
(tests/test_arch_smoke.py:113), fp32 functions ``1e-5``.
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import array_from_numpy  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.attention import attention_full  # noqa: E402
from repro_torch.models.model import check_ported  # noqa: E402
from repro_torch.serving import PoolConfig, ServeEngine  # noqa: E402
from test_torch_serving import with_nonzero_biases  # noqa: E402

BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:30
FP32_CHAIN = dict(atol=1e-3, rtol=0)   # tests/test_arch_smoke.py:113
FP32_FN = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["olmo_1b", "yi_6b", "qwen2_vl_7b"]
ALIAS = {"olmo_1b": "olmo-1b", "yi_6b": "yi-6b", "qwen2_vl_7b": "qwen2-vl-7b"}


def _pair(arch, fp32=False):
    jm = jax_build(jax_smoke(arch))
    params = jm.init(jax.random.PRNGKey(0))
    if fp32:
        params = jax.tree.map(lambda x: x.astype(jnp.float32)
                              if x.dtype == jnp.bfloat16 else x, params)
    params = with_nonzero_biases(params)
    tm = build_model(get_smoke_config(arch)).load_params(
        jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return (request.param,) + _pair(request.param)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if hasattr(v, "items"):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


# -- building blocks ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layernorm_np_matches_reference(dtype, eps):
    rng = np.random.default_rng(0)
    xj = jnp.asarray(rng.standard_normal((2, 5, 64)) * 3 + 1.5, getattr(jnp, dtype))
    xt = array_from_numpy(np.asarray(xj), "cpu")
    tol = FP32_FN if dtype == "float32" else BF16
    for got, want in ((tl.layernorm_np(xt, eps), jl.layernorm_np(xj, eps)),
                      (tl.apply_norm(xt, {}, "layernorm_np", eps),
                       jl.apply_norm(xj, {}, "layernorm_np", eps)),
                      (tl.apply_norm(xt, None, "layernorm_np", eps),
                       jl.apply_norm(xj, None, "layernorm_np", eps))):
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    assert tl.init_norm(64, "layernorm_np") == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(D, sections, dtype):
    """Three distinct position streams, so every section turns by its own."""
    rng = np.random.default_rng(D)
    xj = jnp.asarray(rng.standard_normal((2, 7, 3, D)), getattr(jnp, dtype))
    xt = array_from_numpy(np.asarray(xj), "cpu")
    pos = np.stack([rng.integers(0, 900, size=(2, 7)) for _ in range(3)]).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos}) == 3
    want = jl.apply_mrope(xj, jnp.asarray(pos), 1e6, sections)
    got = tl.apply_mrope(xt, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == xt.dtype
    tol = FP32_FN if dtype == "float32" else BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_apply_mrope_with_equal_streams_is_rope():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 2, 128)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 4000, size=(2, 6)).astype(np.int32))
    torch.testing.assert_close(tl.apply_mrope(x, pos[None].expand(3, 2, 6), 1e6, (16, 24, 24)),
                               tl.apply_rope(x, pos, 1e6), atol=0, rtol=0)
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(x, pos[None].expand(3, 2, 6), 1e6, (16, 24, 23))


# -- configs and init --------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for name in (arch, ALIAS[arch]):
        assert get_config(name).__dict__ == jax_config(name).__dict__
    assert get_smoke_config(arch).__dict__ == jax_smoke(arch).__dict__
    assert get_config(arch).param_count() == jax_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_param_shapes(arch):
    """Key paths, shapes and dtypes of the torch-side init equal the
    reference's, empty norm subtrees (olmo) and biases (qwen2-vl)
    included; the biases start at zero, as the reference's do."""
    cfg = get_smoke_config(arch)
    jshapes = dict(_leaves(jax_build(jax_smoke(arch)).param_shapes()))
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in tm.named_parameters()}
    want = {n: (tuple(s.shape), str(s.dtype)) for n, s in jshapes.items()}
    assert got == want
    if cfg.norm_kind == "layernorm_np":
        assert len(tm["norm_f"]) == 0 and len(tm["stack"]["pos0"]["norm_in"]) == 0
    if cfg.attn_bias:
        assert not tm["stack"]["pos0"]["attn"]["bq"].any()


def test_load_params_keeps_empty_subtrees():
    jm = jax_build(jax_smoke("olmo_1b"))
    params = jm.init(jax.random.PRNGKey(0))
    assert params["norm_f"] == {} and params["stack"]["pos0"]["norm_in"] == {}
    tm = build_model(get_smoke_config("olmo_1b")).load_params(
        jax.tree.map(np.asarray, params), device="cpu")
    assert set(tm.keys()) == set(params.keys())
    assert set(tm["stack"]["pos0"].keys()) == set(params["stack"]["pos0"].keys())
    assert dict(_leaves(tm)).keys() == dict(_leaves(params)).keys()


# -- prefill and decode against the reference --------------------------------------
@pytest.mark.parametrize("prompt_len,cache_len", [(7, 7), (16, 20)])
def test_prefill_matches_reference(pair, prompt_len, cache_len):
    arch, jm, params, tm = pair
    if arch == "qwen2_vl_7b":   # the biases count: nonzero, the same on both sides
        for name in ("bq", "bk", "bv"):
            b = tm["stack"]["pos0"]["attn"][name]
            assert b.abs().min() > 0
            np.testing.assert_array_equal(
                b.float().numpy(), np.asarray(params["stack"]["pos0"]["attn"][name], np.float32))
    toks = np.random.default_rng(prompt_len).integers(
        1, 128, size=(2, prompt_len)).astype(np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=cache_len)
    lt, ct = tm.prefill(torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct["pos0"]["self"][name].float().numpy(),
                                   np.asarray(cj["pos0"]["self"][name], np.float32), **BF16)
    np.testing.assert_array_equal(ct["pos0"]["self"]["pos"].numpy(),
                                  np.asarray(cj["pos0"]["self"]["pos"]))


def _near_tie(logits) -> bool:
    """The top-2 gap is within the bf16 tolerance of the top logit."""
    top2 = np.sort(np.asarray(logits, np.float32))[-2:]
    return top2[1] - top2[0] <= BF16["atol"] + BF16["rtol"] * abs(top2[1])


def test_bf16_decode_chain_matches_reference(pair):
    """Greedy decode from a prefill, both packages fed the reference's
    tokens: logits within the bf16 tolerance at every step, and the same
    greedy token unless the reference's top two are a near-tie."""
    _, jm, params, tm = pair
    prompt = [5, 6, 7, 8]
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray([prompt], jnp.int32)}, cache_len=16)
    lt, ct = tm.prefill(torch.tensor([prompt], dtype=torch.int32), cache_len=16)
    for pos in range(len(prompt), len(prompt) + 6):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
        tok = int(jnp.argmax(lj[0]))
        assert int(lt[0].argmax()) == tok or _near_tie(lj[0])
        lj, cj = jm.decode_step(params, jnp.asarray([tok], jnp.int32),
                                jnp.asarray([pos], jnp.int32), cj)
        lt, ct = tm.decode_step(torch.tensor([tok], dtype=torch.int32),
                                torch.tensor([pos], dtype=torch.int32), ct)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_teacher_forced_decode(arch):
    """tests/test_arch_smoke.py:101-150 on the port: at fp32, each decode
    step from a prefilled cache gives the logits of a prefill of the same
    prefix, and the reference's decode step's, within 1e-3."""
    jm, params, tm = _pair(arch, fp32=True)
    assert tm["embed"]["tok"].dtype == torch.float32
    B, S, K = 2, 20, 10
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, 128), np.int32)
    tt = torch.from_numpy(toks)
    _, ct = tm.prefill(tt[:, :K], cache_len=S)
    _, cj = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=S))(
        params, jnp.asarray(toks[:, :K]))
    dec = jax.jit(jm.decode_step)
    for t in range(K, S):
        want, _ = tm.prefill(tt[:, : t + 1])
        pos = np.full((B,), t, np.int32)
        got, ct = tm.decode_step(tt[:, t], torch.from_numpy(pos), ct)
        lj, cj = dec(params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **FP32_CHAIN)
        np.testing.assert_allclose(got.numpy(), np.asarray(lj), **FP32_CHAIN)


# -- M-RoPE position triples -----------------------------------------------------------
@pytest.mark.parametrize("grid", [(2, 3), (4, 4)])
def test_qwen2_vl_prefill_with_image_positions_matches_reference(grid):
    """Text, an image's patch grid (temporal fixed, height x width
    varying) and text again, through both packages' ``prefill`` with the
    same position triples: the port takes the positions path, not the
    kernel's, and its logits and cache positions equal the reference's.
    The reference's cache writes patches that share a temporal position to
    one slot, in an order neither package fixes, so K and V are compared at
    the slots written once."""
    jm, params, tm = _pair("qwen2_vl_7b")
    B, n0, n1 = 2, 3, 4
    pos = tl.image_positions(n0, grid, n1)[:, None].expand(3, B, -1).numpy().copy()
    S = pos.shape[2]
    assert len(set(pos[0, 0].tolist())) < S          # the temporal stream repeats
    toks = np.random.default_rng(7).integers(1, 128, size=(B, S)).astype(np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)},
                        cache_len=S)
    paths = dict(attention_full.paths)
    lt, ct = tm.prefill(torch.from_numpy(toks), cache_len=S, positions=torch.from_numpy(pos))
    L = tm.cfg.num_layers
    assert attention_full.paths == dict(paths, positions=paths["positions"] + L)
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    cpos = ct["pos0"]["self"]["pos"].numpy()
    np.testing.assert_array_equal(cpos, np.asarray(cj["pos0"]["self"]["pos"]))
    once = np.array([[np.sum(pos[0, b] == p) == 1 for p in cpos[0, b]] for b in range(B)])
    for name in ("k", "v"):
        got = ct["pos0"]["self"][name].float().numpy()
        want = np.asarray(cj["pos0"]["self"][name], np.float32)
        np.testing.assert_allclose(got[:, once], want[:, once], **BF16)


def test_qwen2_vl_arange_triples_take_the_positions_path_and_agree_with_the_kernel_path():
    """Explicit 0..S-1 triples run ``_attend`` with the temporal mask; no
    positions run the flash-prefill path (its plain version on the CPU).
    Both give the same logits and caches."""
    _, _, tm = _pair("qwen2_vl_7b")
    B, S = 2, 11
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, 128, size=(B, S)).astype(np.int32))
    arange3 = torch.arange(S, dtype=torch.int32)[None, None].expand(3, B, S)
    L = tm.cfg.num_layers
    p0 = dict(attention_full.paths)
    lk, ck = tm.prefill(toks, cache_len=S + 4)
    p1 = dict(attention_full.paths)
    lp, cp = tm.prefill(toks, cache_len=S + 4, positions=arange3)
    p2 = dict(attention_full.paths)
    assert (p1["flash_prefill"] - p0["flash_prefill"], p1["positions"] - p0["positions"]) == (L, 0)
    assert (p2["flash_prefill"] - p1["flash_prefill"], p2["positions"] - p1["positions"]) == (0, L)
    torch.testing.assert_close(lp, lk, **BF16)
    for name in ("k", "v", "pos"):
        torch.testing.assert_close(cp["pos0"]["self"][name], ck["pos0"]["self"][name], **BF16)


def test_caller_positions_only_for_mrope():
    _, _, tm = _pair("yi_6b")
    toks = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="M-RoPE"):
        tm.prefill(toks, positions=torch.zeros((3, 1, 3), dtype=torch.int32))
    _, _, qm = _pair("qwen2_vl_7b")
    with pytest.raises(ValueError, match=r"\(3, 1, 3\)"):
        qm.prefill(toks, positions=torch.zeros((1, 3), dtype=torch.int32))


# -- what the paged engine refuses ---------------------------------------------------
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b",
                                  "jamba_v01_52b", "whisper_base"])
def test_moe_hybrid_and_encoder_configs_build_and_the_paged_engine_refuses_them(arch):
    """The MoE, hybrid and encoder–decoder configurations are ported
    (``check_ported`` admits them and the model builds), but the paged
    engine refuses them with ``ValueError``: they decode over dense
    caches, the MoE and hybrid ones as the reference's ``PagedLM``
    refuses them, whisper because the paged step has no cross-attention
    (the reference's accepts it and drops the cross-attention; ROADMAP
    Queue 3 entry 12)."""
    cfg = ModelConfig(**jax_config(arch).__dict__)
    yi = get_smoke_config("yi_9b")
    model = build_model(yi).init(torch.Generator().manual_seed(0), device="cpu")
    pool = PoolConfig(num_pages=16, page_tokens=8, max_pages_per_seq=4)
    check_ported(cfg)
    assert build_model(cfg).cfg == cfg
    with pytest.raises(ValueError, match="uniform dense-attention"):
        ServeEngine(cfg, model, pool, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "gemma3_12b"])
def test_engine_refuses_non_uniform_stacks(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        ServeEngine(cfg, model, PoolConfig(num_pages=16, page_tokens=8, max_pages_per_seq=4),
                    device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_accepts_the_family_with_torch_init(arch):
    """``ServeEngine`` takes each configuration with torch-side weights
    and streams a few tokens; every page comes back."""
    cfg = replace(get_smoke_config(arch), num_layers=1)
    model = build_model(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    eng = ServeEngine(cfg, model, PoolConfig(num_pages=16, page_tokens=8, max_pages_per_seq=4),
                      device="cpu")
    free0 = eng.pool.heap.free_pages()
    out = list(eng.generate_tokens([3, 4, 5, 6, 7], 4))
    assert len(out) == 4 and all(0 <= t < cfg.vocab_size for t in out)
    assert eng.pool.heap.free_pages() == free0
