"""The port's Mamba-2 model (mamba2 smoke config) against the reference's
on the same weights: the SSM block's parameters, its full-sequence and
one-step forms, prefill logits and cache, a greedy decode chain, and the
port's own teacher-forced prefill/decode agreement in fp32."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

ARCH = "mamba2_1p3b"
BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:29
# fp32 on both sides: matmul and scan summation order only
F32 = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if a.dtype == jnp.bfloat16 else a, tree)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_smoke(ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config(ARCH)).load_params(_np(params), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def block():
    """One SSM block's reference parameters and a (B, S, D) input."""
    cfg = jax_smoke(ARCH)
    p, _ = jax_ssm.init_ssm(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(0).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


def _spec(a):
    return tuple(a.shape), str(a.dtype).replace("torch.", "")


def test_init_ssm_matches_reference_tree():
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp, _ = jax_ssm.init_ssm(jax.random.PRNGKey(0), jcfg)
    tp = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: _spec(v) for k, v in tp.items()} == {k: _spec(v) for k, v in jp.items()}
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]), rtol=1e-6)
    # dt_bias = softplus⁻¹ of a draw in [1e-3, 1e-1]
    dt0 = torch.nn.functional.softplus(tp["dt_bias"])
    assert bool(((dt0 >= 1e-3 - 1e-9) & (dt0 <= 1e-1 + 1e-9)).all())


@pytest.mark.parametrize("layers", [2, 3])
def test_model_init_tree_matches_param_shapes(layers):
    cfg = replace(get_smoke_config(ARCH), num_layers=layers)
    jshapes = dict(_leaves(jax_build(replace(jax_smoke(ARCH),
                                             num_layers=layers)).param_shapes()))
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    got = {n: _spec(p) for n, p in tm.named_parameters()}
    assert got == {n: _spec(s) for n, s in jshapes.items()}
    assert "embed.unembed" not in got and not any("mlp" in n for n in got)


def test_params_from_numpy_keeps_dtypes(pair):
    _, params, tm = pair
    for name, leaf in _leaves(_np(params)):
        got = tm.get_parameter(name)
        assert _spec(got) == _spec(leaf)
        np.testing.assert_array_equal(got.float().numpy(), leaf.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_matches_reference(block, dtype):
    jcfg, p, x = block
    cfg = get_smoke_config(ARCH)
    tol = F32 if dtype == "float32" else BF16
    if dtype == "float32":
        p = _f32(p)
    xj = jnp.asarray(x, dtype)
    out_j, st_j = jax_ssm.ssm_forward(xj, p, jcfg, want_state=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out_t, st_t = ssm.ssm_forward(xt, params_from_numpy(_np(p), "cpu"), cfg,
                                  want_state=True)
    assert out_t.dtype == xt.dtype
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32), **tol)
    for k in ("conv_x", "conv_B", "conv_C", "ssd"):
        assert _spec(st_t[k]) == _spec(st_j[k])
        np.testing.assert_allclose(st_t[k].float().numpy(),
                                   np.asarray(st_j[k], np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_reference(block, dtype):
    jcfg, p, x = block
    cfg = get_smoke_config(ARCH)
    tol = F32 if dtype == "float32" else BF16
    if dtype == "float32":
        p = _f32(p)
    _, st_j = jax_ssm.ssm_forward(jnp.asarray(x, dtype), p, jcfg, want_state=True)
    pt = params_from_numpy(_np(p), "cpu")
    st_t = params_from_numpy(_np(st_j), "cpu")
    step = np.random.default_rng(1).standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    for _ in range(3):
        out_j, st_j = jax_ssm.ssm_decode_step(jnp.asarray(step, dtype), p, jcfg, st_j)
        out_t, st_t = ssm.ssm_decode_step(torch.from_numpy(step).to(getattr(torch, dtype)),
                                          pt, cfg, st_t)
        np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                                   **tol)
        for k in st_t:
            assert _spec(st_t[k]) == _spec(st_j[k])
            np.testing.assert_allclose(st_t[k].float().numpy(),
                                       np.asarray(st_j[k], np.float32), **tol)
        step = np.array(out_j, np.float32)


@pytest.mark.parametrize("prompt_len", [2, 16, 37])
def test_prefill_matches_reference(pair, prompt_len):
    """Shorter than the conv tail (K-1 = 3, so the tail is padded), one
    chunk exactly, and a padded third chunk."""
    jm, params, tm = pair
    toks = np.random.default_rng(prompt_len).integers(
        1, 128, size=(2, prompt_len)).astype(np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill(torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for k in ("conv_x", "conv_B", "conv_C", "ssd"):
        got, want = ct["pos0"]["ssm"][k], cj["pos0"]["ssm"][k]
        assert _spec(got) == _spec(want)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   **BF16)


def _near_tie(logits, tol=BF16):
    top2 = np.sort(logits)[-2:]
    return top2[1] - top2[0] <= tol["atol"] + tol["rtol"] * abs(top2[1])


def test_greedy_decode_chain_matches_reference(pair):
    """Ten greedy steps from a shared prompt: the tokens agree until a
    near-tie of the reference's logits, and the logits stay within the
    bf16 tolerance while they do."""
    jm, params, tm = pair
    prompt = np.array([[5, 6, 7, 8, 9, 10, 11]], np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(prompt)})
    lt, ct = tm.prefill(torch.from_numpy(prompt))
    pos = prompt.shape[1]
    agreed = 0
    for _ in range(10):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
        tj, tt = int(jnp.argmax(lj[0])), int(lt[0].argmax())
        if tj != tt:
            assert _near_tie(np.asarray(lj[0]))
            break
        agreed += 1
        lj, cj = jm.decode_step(params, jnp.asarray([tj], jnp.int32),
                                jnp.asarray([pos], jnp.int32), cj)
        lt, ct = tm.decode_step(torch.tensor([tt], dtype=torch.int32),
                                torch.tensor([pos], dtype=torch.int32), ct)
        pos += 1
    assert agreed >= 5


def test_empty_cache_matches_reference_and_decodes(pair):
    jm, params, tm = pair
    cj, ct = jm.empty_cache(2, 10), tm.empty_cache(2, 10)
    for k, want in cj["pos0"]["ssm"].items():
        got = ct["pos0"]["ssm"][k]
        assert _spec(got) == _spec(want)
        assert not got.float().abs().sum()
    toks, pos = np.array([3, 77], np.int32), np.array([0, 0], np.int32)
    lj, _ = jm.decode_step(params, jnp.asarray(toks), jnp.asarray(pos), cj)
    lt, ct = tm.decode_step(torch.from_numpy(toks), torch.from_numpy(pos), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    assert ct["pos0"]["ssm"]["ssd"].abs().sum() > 0   # updated in place


def test_teacher_forced_decode_matches_prefill_fp32():
    """tests/test_arch_smoke.py:109-149 on the port alone: in fp32, each
    decode step's logits equal a prefill of the prefix plus that token."""
    cfg = get_smoke_config(ARCH)
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tm = tm.float()
    B, S, K = 2, 20, 10
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32))
    logits, cache = tm.prefill(toks[:, :K])
    assert cache["pos0"]["ssm"]["conv_x"].dtype == torch.float32
    for t in range(K, S):
        ref, _ = tm.prefill(toks[:, : t + 1])
        logits, cache = tm.decode_step(toks[:, t], torch.full((B,), t, dtype=torch.int32),
                                       cache)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-3, rtol=0)
