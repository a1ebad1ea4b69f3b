"""The port's remaining self-attention decode variants against the
reference's on the same weights and inputs: uniform scalar-position
decode, the int8 KV cache, and the logit softcap in decode attention
(tests/test_decode_variants.py:12-60 run on both packages).

Tolerances: the reference's own where its test states one (uniform vs
vector positions ``atol=1e-2``; int8 against bf16 by top-1 agreement);
bf16 logits between the packages ``atol=rtol=5e-2``
(tests/test_kernels.py:30); int8 cache entries within one quantisation
step; the fp32 functions ``1e-5``.
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import array_from_numpy  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

BF16 = dict(atol=5e-2, rtol=5e-2)     # tests/test_kernels.py:30
UNIFORM = dict(atol=1e-2, rtol=0)     # tests/test_decode_variants.py:31
FP32_FN = dict(atol=1e-5, rtol=1e-5)


def _pair(arch, cfg_change=None, fp32=False):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    if cfg_change:
        jcfg, tcfg = replace(jcfg, **cfg_change), replace(tcfg, **cfg_change)
    jm = jax_build(jcfg)
    jm.decode_step = jax.jit(jm.decode_step)   # one compile a position rank
    params = jm.init(jax.random.PRNGKey(0))
    if fp32:
        params = jax.tree.map(lambda x: x.astype(jnp.float32)
                              if x.dtype == jnp.bfloat16 else x, params)
    tm = build_model(tcfg).load_params(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _tokens(B, S):
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, 128), np.int32)


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in cache.items()}


# -- uniform scalar-position decode -----------------------------------------------
@pytest.mark.parametrize("arch", ["yi_9b", "gemma3_12b", "olmo_1b", "qwen2_vl_7b"])
def test_uniform_pos_matches_vector_pos(arch):
    """TestUniformPosDecode on the port: a 0-d position gives the (B,)
    position's logits within 1e-2 at every step, through gemma3's ring
    caches too, and the reference's uniform logits within the bf16
    tolerance; the two caches' positions are equal."""
    jm, params, tm = _pair(arch)
    B, S, K = 2, 20, 8
    toks = _tokens(B, S)
    _, cache_v = tm.prefill(torch.from_numpy(toks[:, :K]), cache_len=S)
    cache_u = _clone(cache_v)
    _, cj = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :K])}, cache_len=S)
    for t in range(K, S):
        tok = torch.from_numpy(toks[:, t])
        lv, cache_v = tm.decode_step(tok, torch.full((B,), t, dtype=torch.int32), cache_v)
        lu, cache_u = tm.decode_step(tok, torch.tensor(t, dtype=torch.int32), cache_u)
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32), cj)
        np.testing.assert_allclose(lu.numpy(), lv.numpy(), **UNIFORM)
        np.testing.assert_allclose(lu.numpy(), np.asarray(lj), **BF16)
    for key, c in cache_u.items():
        assert torch.equal(c["self"]["pos"], cache_v[key]["self"]["pos"])
        np.testing.assert_array_equal(c["self"]["pos"].numpy(), np.asarray(cj[key]["self"]["pos"]))


def test_uniform_pos_writes_one_slot_of_every_row():
    _, _, tm = _pair("yi_9b")
    cache = tm.empty_cache(3, 6)
    tm.decode_step(torch.tensor([1, 2, 3], dtype=torch.int32), torch.tensor(4, dtype=torch.int32),
                   cache)
    assert cache["pos0"]["self"]["pos"][0].tolist() == [[-1, -1, -1, -1, 4, -1]] * 3
    k = cache["pos0"]["self"]["k"]
    assert k[:, :, 4].abs().sum() > 0 and k[:, :, :4].abs().sum() == 0


# -- int8 KV cache ------------------------------------------------------------------
def test_kv_int8_store_and_load_match_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 3, 4, 16)) * 4).astype(np.float32)
    x[0, 0, 0, :4] = [0.025, -0.075, 100.0, -100.0]    # ties to even, and the clip
    for dt in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x, dt)
        q_t = ta._kv_store(array_from_numpy(np.asarray(xj), "cpu"), torch.int8)
        q_j = ja._kv_store(xj, jnp.int8)
        assert q_t.dtype == torch.int8
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        back_t, back_j = ta._kv_load(q_t), ja._kv_load(q_j)
        assert back_t.dtype == torch.bfloat16
        np.testing.assert_allclose(back_t.float().numpy(), np.asarray(back_j, np.float32),
                                   **FP32_FN)
    assert ta.KV_INT8_SCALE == ja.KV_INT8_SCALE
    plain = torch.ones(3, dtype=torch.bfloat16)
    assert ta._kv_load(plain) is plain


def test_int8_cache_decode_close_to_bf16_and_matches_reference():
    """TestInt8KVCache on both packages: the prefilled cache quantised into
    an int8 cache, one decode step at a scalar position. The port's int8
    step picks the bf16 step's top-1 token, keeps the cache int8, and
    matches the reference's int8 step (logits within the bf16 tolerance,
    the new cache entries within one quantisation step)."""
    jm, params, tm = _pair("yi_9b")
    B, S, K = 2, 16, 8
    toks = _tokens(B, S)
    _, c16 = tm.prefill(torch.from_numpy(toks[:, :K]), cache_len=S)
    _, c16j = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :K])}, cache_len=S)
    c8 = tm.empty_cache(B, S, kv_dtype=torch.int8)
    for name in ("k", "v"):
        c8["pos0"]["self"][name].copy_(ta._kv_store(c16["pos0"]["self"][name], torch.int8))
    c8["pos0"]["self"]["pos"].copy_(c16["pos0"]["self"]["pos"])
    c8j = jax.tree.map(lambda d, s: ja._kv_store(s, jnp.int8) if d.dtype == jnp.int8 else s,
                       jm.empty_cache(B, S, kv_dtype=jnp.int8), c16j)
    tok, pos = torch.from_numpy(toks[:, K]), torch.tensor(K, dtype=torch.int32)
    l16, _ = tm.decode_step(tok, pos, c16)
    l8, c8 = tm.decode_step(tok, pos, c8)
    l8j, c8j = jm.decode_step(params, jnp.asarray(toks[:, K]), jnp.asarray(K, jnp.int32), c8j)
    assert int(l8[0].argmax()) == int(l16[0].argmax())
    assert c8["pos0"]["self"]["k"].dtype == torch.int8
    np.testing.assert_allclose(l8.numpy(), np.asarray(l8j), **BF16)
    for name in ("k", "v"):
        got = c8["pos0"]["self"][name].numpy().astype(np.int32)
        want = np.asarray(c8j["pos0"]["self"][name]).astype(np.int32)
        assert np.abs(got - want).max() <= 1
    np.testing.assert_array_equal(c8["pos0"]["self"]["pos"].numpy(),
                                  np.asarray(c8j["pos0"]["self"]["pos"]))


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("arch", ["yi_9b", "gemma3_12b"])
def test_fp32_weights_over_a_narrow_cache_match_reference(arch, kv_dtype):
    """A chain of vector-position decode steps into empty int8 or bf16
    caches under fp32 weights, both packages fed the same tokens. The
    attention output is in the cache's load dtype (bf16) and its
    projection promotes to fp32, as the reference's einsum does; so the
    logits carry bf16 rounding and are held at the bf16 tolerance, and the
    int8 codes within one quantisation step. (On bf16 weights a one-ulp
    difference in a K value flips its int8 code by a whole step, 0.05,
    already in the first layer of the first step, which moves gemma3's
    logits past the bf16 tolerance; fp32 weights keep the codes within a
    step.)"""
    jm, params, tm = _pair(arch, fp32=True)
    B, S = 2, 12
    toks = _tokens(B, S)
    ct = tm.empty_cache(B, S, kv_dtype=getattr(torch, kv_dtype))
    cj = jm.empty_cache(B, S, kv_dtype=getattr(jnp, kv_dtype))
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, t]), torch.from_numpy(pos), ct)
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for key, c in ct.items():
        assert c["self"]["k"].dtype == getattr(torch, kv_dtype)
        if kv_dtype == "int8":
            for name in ("k", "v"):
                got = c["self"][name].numpy().astype(np.int32)
                assert np.abs(got - np.asarray(cj[key]["self"][name], np.int32)).max() <= 1


# -- softcap -------------------------------------------------------------------------
@pytest.mark.parametrize("softcap", [0.0, 0.5, 30.0])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attend_with_softcap_matches_reference(softcap, window):
    """The decode ``_attend`` (one query row, GQA 4/2, invalid slots) on
    both packages in fp32."""
    rng = np.random.default_rng(int(softcap * 10) + window)
    B, Skv, H, Hkv, D = 3, 9, 4, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32) * 3
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32) * 3
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    kv_pos = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    kv_pos[1, 6:] = -1
    q_pos = np.array([[8], [5], [3]], np.int32)
    valid = kv_pos >= 0
    want = ja._attend(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)), causal=True, window=window,
                      softcap=softcap, kv_valid=jnp.asarray(valid))
    got = ta._attend(*map(torch.from_numpy, (q, k, v, q_pos, kv_pos)), causal=True,
                     window=window, softcap=softcap, kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_FN)


@pytest.mark.parametrize("arch", ["yi_9b", "gemma3_12b"])
def test_softcap_prefill_and_decode_match_reference(arch):
    """A config with ``attn_logit_softcap`` = 0.5 (small enough to bind at
    smoke widths): prefill (the flash-prefill path's plain version) and a
    decode chain, both packages, logits within the bf16 tolerance."""
    jm, params, tm = _pair(arch, {"attn_logit_softcap": 0.5})
    B, S, K = 2, 14, 9
    toks = _tokens(B, S)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :K]), cache_len=S)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :K])}, cache_len=S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    _, plain = _pair(arch)[1:]
    l_nocap, _ = plain.prefill(torch.from_numpy(toks[:, :K]), cache_len=S)
    assert (l_nocap - lt).abs().max() > BF16["atol"]      # the cap changes the logits
    for t in range(K, S):
        pos = np.full((B,), t, np.int32)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, t]), torch.from_numpy(pos), ct)
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
