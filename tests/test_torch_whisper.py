"""The port's encoder–decoder family (whisper-base at smoke size: 2
encoder and 2 decoder layers, d_model 64, 4/4 heads at 16, d_ff 128,
vocab 128, 32 encoder frames) against the reference on the same weights
and inputs: the config and parameter tree, parametric LayerNorm, the GELU
MLP, the sinusoidal positions, non-causal ``_attend`` past ``Q_CHUNK``,
the encoder, ``Model.prefill`` with and without frames (logits and every
self and cross cache leaf), 10 decode steps, the empty caches' cross
leaves, the cross caches left as they are by decode, and the paged
engine's refusal.

Weights come from the reference's init, with every norm scale and bias
and every MLP bias redrawn away from its init's ones and zeros so the
comparison sees them, and reach the port through
``convert.params_from_numpy``. Frames and tokens are drawn from numpy
seeds. Tolerances: fp32 functions ``atol=rtol=1e-5``, fp32 model outputs
and decode chains ``atol=1e-3`` (tests/test_arch_smoke.py:113), bf16
``atol=rtol=5e-2`` (tests/test_kernels.py:30).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import array_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.model import check_ported  # noqa: E402
from repro_torch.serving import PoolConfig, ServeEngine, check_paged_compatible  # noqa: E402

ARCH = "whisper_base"
FP32_FN = dict(atol=1e-5, rtol=1e-5)
FP32_CHAIN = dict(atol=1e-3, rtol=0)   # tests/test_arch_smoke.py:113
BF16 = dict(atol=5e-2, rtol=5e-2)      # tests/test_kernels.py:30
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return FP32_CHAIN if dtype == "float32" else BF16


def _perturbed(params, seed=3):
    """Every LayerNorm scale and bias and every MLP bias redrawn: the
    reference initialises them to ones and zeros, which would hide a
    scale or a bias applied in the wrong place."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = getattr(path[-1], "key", "")
        if name not in ("scale", "bias", "bi", "bo"):
            return x
        centre = 1.0 if name == "scale" else 0.0
        return jnp.asarray(centre + 0.2 * rng.standard_normal(x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


def _pair(dtype):
    jm = jax_build(jax_smoke(ARCH))
    params = _perturbed(jm.init(jax.random.PRNGKey(0)))
    if dtype == "float32":
        params = jax.tree.map(lambda x: x.astype(jnp.float32)
                              if x.dtype == jnp.bfloat16 else x, params)
    tm = build_model(get_smoke_config(ARCH)).load_params(
        jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module", params=DTYPES)
def pair(request):
    return (request.param,) + _pair(request.param)


def _both(a, dtype):
    """One numpy array as the same values on both sides, in ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    return j, array_from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(cfg, dtype, B=2, S=7, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    return toks, _both(frames, dtype)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# -- config and parameter tree ----------------------------------------------
@pytest.mark.parametrize("name", ["whisper_base", "whisper-base"])
def test_config_matches_reference(name):
    assert get_config(name).__dict__ == jax_config(name).__dict__
    assert get_config(name).param_count() == jax_config(name).param_count()
    assert get_smoke_config(name).__dict__ == jax_smoke(name).__dict__
    assert get_smoke_config(name).param_count() == jax_smoke(name).param_count()
    check_ported(get_config(name))


def test_torch_init_tree_matches_reference():
    """``Model.init``'s leaves have the reference tree's key paths, shapes
    and dtypes, the encoder's and the cross-attention's included."""
    want = {n: (tuple(v.shape), str(v.dtype))
            for n, v in _leaves(jax_build(jax_smoke(ARCH)).param_shapes())}
    tm = build_model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0), "cpu")
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in tm.named_parameters()}
    assert got == want
    assert {"encoder.norm_out.scale", "encoder.blocks.attn.wq", "encoder.blocks.mlp.bi",
            "stack.pos0.cross.wk", "stack.pos0.norm_cross.bias"} <= set(got)


# -- building blocks -------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layernorm_matches_reference(dtype, eps):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((2, 5, 64)) * 3 + 1.5, dtype)
    wj, wt = _both(1 + 0.3 * rng.standard_normal(64), "bfloat16")
    bj, bt = _both(0.3 * rng.standard_normal(64), "bfloat16")
    tol = FP32_FN if dtype == "float32" else BF16
    for got, want in ((tl.layernorm(xt, wt, bt, eps), jl.layernorm(xj, wj, bj, eps)),
                      (tl.apply_norm(xt, {"scale": wt, "bias": bt}, "layernorm", eps),
                       jl.apply_norm(xj, {"scale": wj, "bias": bj}, "layernorm", eps))):
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    p = tl.init_norm(64, "layernorm")
    assert p["scale"].dtype == p["bias"].dtype == torch.bfloat16
    assert torch.equal(p["scale"], torch.ones(64, dtype=torch.bfloat16))
    assert torch.equal(p["bias"], torch.zeros(64, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    """The tanh-approximate GELU between ``wi`` + ``bi`` and ``wo`` +
    ``bo``, on the reference's weights with the biases redrawn."""
    rng = np.random.default_rng(1)
    p = _perturbed(jl.init_mlp(jax.random.PRNGKey(2), 64, 128, "gelu")[0])
    p = {k: v.astype(getattr(jnp, dtype)) for k, v in p.items()}
    pt = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    xj, xt = _both(rng.standard_normal((2, 5, 64)), dtype)
    got, want = tl.mlp_apply(xt, pt, "gelu"), jl.mlp_apply(xj, p, "gelu")
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **(FP32_FN if dtype == "float32" else BF16))
    init = tl.init_mlp(torch.Generator().manual_seed(0), 64, 128, "gelu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        "wi": ((64, 128), torch.bfloat16), "bi": ((128,), torch.bfloat16),
        "wo": ((128, 64), torch.bfloat16), "bo": ((64,), torch.bfloat16)}
    assert not init["bi"].any() and not init["bo"].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sinusoid_positions_match_reference(dtype):
    """At whisper-base's full 1,500 x 512: angles reach 1,499 rad, where
    sin and cos of the two libraries may part by an ulp, so float32 is
    held at the fp32 function tolerance and bf16 after its rounding."""
    got = ttr.sinusoid_positions(1500, 512, getattr(torch, dtype))
    want = jtr.sinusoid_positions(1500, 512, getattr(jnp, dtype))
    assert got.shape == (1500, 512) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **(FP32_FN if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_attend_without_positions_past_q_chunk_matches_reference(dtype):
    """Non-causal ``_attend`` with ``q_pos=None`` at Sq 1,100 > ``Q_CHUNK``
    (two query chunks), GQA 4/2, a softcap; the reference pads its chunks."""
    assert tattn.Q_CHUNK < 1100
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng.standard_normal(s), dtype) for s in
                                    ((2, 1100, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    for softcap in (0.0, 5.0):
        got = tattn._attend(qt, kt, vt, None, None, causal=False, softcap=softcap)
        want = jattn._attend(qj, kj, vj, None, None, causal=False, window=0, softcap=softcap)
        assert got.shape == (2, 1100, 4, 16)
        np.testing.assert_allclose(_np(got), _np(want),
                                   **(FP32_FN if dtype == "float32" else BF16))


def test_encode_matches_reference(pair):
    dtype, jm, params, tm = pair
    cfg = tm.cfg
    _, (fj, ft) = _inputs(cfg, dtype)
    p0 = dict(tattn.attention_full.paths)
    got = ttr.encode(tm["encoder"], cfg, ft)
    assert tattn.attention_full.paths == dict(p0, memory=p0["memory"] + cfg.encoder_layers)
    want = jtr.encode(params["encoder"], jax_smoke(ARCH), fj)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model) and got.dtype == ft.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# -- the model -----------------------------------------------------------------------
def test_prefill_with_frames_and_decode_match_reference(pair):
    """Logits and every self and cross cache leaf of a prefill with frames,
    then 10 decode steps' logits. The decoder's self-attention runs the
    flash-prefill path (its plain version here), one a layer; the encoder
    and the cross-attention the memory path."""
    dtype, jm, params, tm = pair
    cfg = tm.cfg
    toks, (fj, ft) = _inputs(cfg, dtype)
    S, steps = toks.shape[1], 10
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks), "frames": fj},
                        cache_len=S + steps)
    p0 = dict(tattn.attention_full.paths)
    lt, ct = tm.prefill(torch.from_numpy(toks), cache_len=S + steps, frames=ft)
    p1 = tattn.attention_full.paths
    assert (p1["flash_prefill"] - p0["flash_prefill"], p1["memory"] - p0["memory"],
            p1["positions"] - p0["positions"]) == (
        cfg.num_layers, cfg.num_layers + cfg.encoder_layers, 0)
    tol = _tol(dtype)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    want = dict(_leaves(cj))
    got = dict(_leaves(ct))
    assert set(got) == set(want) == {"pos0.self.k", "pos0.self.v", "pos0.self.pos",
                                     "pos0.cross.k", "pos0.cross.v"}
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype).replace("torch.", "") == str(want[name].dtype), name
        np.testing.assert_allclose(_np(leaf), _np(want[name]), err_msg=name, **tol)
    assert got["pos0.cross.k"].shape == (cfg.num_layers, 2, cfg.encoder_seq,
                                         cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(9)
    for t in range(S, S + steps):
        tok = rng.integers(1, cfg.vocab_size, size=(2,)).astype(np.int32)
        pos = np.full((2,), t, np.int32)
        lj, cj = jm.decode_step(params, jnp.asarray(tok), jnp.asarray(pos), cj)
        lt, ct = tm.decode_step(torch.from_numpy(tok), torch.from_numpy(pos), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), err_msg=f"step {t}", **tol)


def test_prefill_without_frames_has_no_cross_cache_and_matches_reference(pair):
    dtype, jm, params, tm = pair
    toks, _ = _inputs(tm.cfg, dtype, seed=1)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=9)
    p0 = dict(tattn.attention_full.paths)
    lt, ct = tm.prefill(torch.from_numpy(toks), cache_len=9)
    assert tattn.attention_full.paths["memory"] == p0["memory"]
    assert set(ct["pos0"]) == set(cj["pos0"]) == {"self"}
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **_tol(dtype))


def test_decode_leaves_the_cross_cache_unchanged(pair):
    """The cross K/V are sealed at prefill: 4 decode steps write the self
    cache and leave every cross leaf bitwise as it was."""
    dtype, _, _, tm = pair
    toks, (_, ft) = _inputs(tm.cfg, dtype, seed=2)
    _, cache = tm.prefill(torch.from_numpy(toks), cache_len=12, frames=ft)
    before = {k: v.clone() for k, v in cache["pos0"]["cross"].items()}
    self_k = cache["pos0"]["self"]["k"].clone()
    for t in range(7, 11):
        _, cache = tm.decode_step(torch.full((2,), 5, dtype=torch.int32),
                                  torch.full((2,), t, dtype=torch.int32), cache)
    for k, v in before.items():
        assert torch.equal(cache["pos0"]["cross"][k], v), k
    assert not torch.equal(cache["pos0"]["self"]["k"], self_k)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32", "int8"])
def test_empty_cache_has_bf16_cross_leaves_as_the_reference(kv_dtype):
    """``empty_cache`` gives the cross K and V ``encoder_seq`` bf16 slots
    whatever ``kv_dtype`` is; the self leaves take ``kv_dtype``."""
    cfg = get_smoke_config(ARCH)
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    want = jax_build(jax_smoke(ARCH)).empty_cache(2, 10, kv_dtype=getattr(jnp, kv_dtype))
    got = tm.empty_cache(2, 10, kv_dtype=getattr(torch, kv_dtype))
    assert {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for n, v in _leaves(got)} == {n: (v.shape, str(v.dtype))
                                          for n, v in _leaves(want)}
    assert got["pos0"]["cross"]["k"].shape == (cfg.num_layers, 2, cfg.encoder_seq,
                                               cfg.num_kv_heads, cfg.head_dim)
    assert got["pos0"]["cross"]["v"].dtype == torch.bfloat16
    assert not got["pos0"]["cross"]["k"].any()


def test_decode_from_an_empty_cache_matches_reference():
    """Decode steps from ``empty_cache`` (zeroed cross K/V of
    ``encoder_seq`` slots, as the reference's) give the reference's logits."""
    jm, params, tm = _pair("float32")
    cfg = tm.cfg
    cj = jm.empty_cache(2, 4, kv_dtype=jnp.float32)
    ct = tm.empty_cache(2, 4, kv_dtype=torch.float32)
    for t, tok in enumerate(([3, 4], [5, 6], [7, 8])):
        tok, pos = np.array(tok, np.int32), np.full((2,), t, np.int32)
        lj, cj = jm.decode_step(params, jnp.asarray(tok), jnp.asarray(pos), cj)
        lt, ct = tm.decode_step(torch.from_numpy(tok), torch.from_numpy(pos), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FP32_CHAIN)
    assert ct["pos0"]["cross"]["k"].shape[2] == cfg.encoder_seq


def test_paged_engine_refuses_whisper():
    """The paged decode step has no cross-attention, so the engine refuses
    an encoder–decoder with ``ValueError``; the reference's accepts it and
    decodes without the cross-attention (ROADMAP Queue 3 entry 12)."""
    cfg = get_smoke_config(ARCH)
    check_ported(cfg)
    with pytest.raises(ValueError, match="cross-attention"):
        check_paged_compatible(cfg)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="cross-attention"):
        ServeEngine(cfg, model, PoolConfig(num_pages=16, page_tokens=8, max_pages_per_seq=4),
                    device="cpu")
