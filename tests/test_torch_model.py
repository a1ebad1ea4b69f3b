"""The port's dense model against the reference's on the same weights:
prefill logits and cache, the dense decode chain, and the torch-side
parameter init's tree (key paths, shapes, dtypes)."""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:29


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke("yi_9b")
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_smoke_config("yi_9b")).load_params(
        jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def test_config_matches_reference():
    from repro.configs import get_config as jax_config
    for name in ("yi_9b", "yi-9b", "mamba2_1p3b", "mamba2-1.3b", "gemma3_12b",
                 "gemma3-12b", "olmo_1b", "olmo-1b", "yi_6b", "yi-6b", "qwen2_vl_7b",
                 "qwen2-vl-7b", "granite_moe_1b_a400m", "granite-moe-1b-a400m",
                 "qwen3_moe_30b_a3b", "qwen3-moe-30b-a3b", "jamba_v01_52b",
                 "jamba-v0.1-52b", "whisper_base", "whisper-base"):
        assert get_config(name).__dict__ == jax_config(name).__dict__
        assert get_config(name).param_count() == jax_config(name).param_count()
    for name in ("yi_9b", "mamba2_1p3b", "gemma3_12b", "olmo_1b", "yi_6b", "qwen2_vl_7b",
                 "granite_moe_1b_a400m", "qwen3_moe_30b_a3b", "jamba_v01_52b",
                 "whisper_base"):
        assert get_smoke_config(name).__dict__ == jax_smoke(name).__dict__
        assert get_smoke_config(name).param_count() == jax_smoke(name).param_count()
    cfg = get_config("mamba2_1p3b")
    assert (cfg.d_inner, cfg.ssm_heads) == (4096, 64)
    with pytest.raises(KeyError, match="not ported"):
        get_config("whisper_large")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


@pytest.mark.parametrize("layers", [2, 3])
def test_torch_init_tree_matches_param_shapes(layers):
    cfg = replace(get_smoke_config("yi_9b"), num_layers=layers)
    jshapes = dict(_leaves(jax_build(replace(jax_smoke("yi_9b"),
                                             num_layers=layers)).param_shapes()))
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in tm.named_parameters()}
    want = {n: (tuple(s.shape), str(s.dtype)) for n, s in jshapes.items()}
    assert got == want
    assert all(not p.requires_grad for p in tm.parameters())
    # seeded: the same generator seed gives the same weights
    again = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(tm["stack"]["pos0"]["attn"]["wq"],
                       again["stack"]["pos0"]["attn"]["wq"])


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_smoke_config("yi_9b")).init(torch.Generator())


@pytest.mark.parametrize("prompt_len,cache_len", [(7, 7), (5, 12), (16, 20)])
def test_prefill_matches_reference(pair, prompt_len, cache_len):
    jm, params, tm = pair
    toks = np.random.default_rng(prompt_len).integers(
        1, 128, size=(2, prompt_len)).astype(np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                        cache_len=cache_len)
    lt, ct = tm.prefill(torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            ct["pos0"]["self"][name].float().numpy(),
            np.asarray(cj["pos0"]["self"][name], np.float32), **BF16)
    np.testing.assert_array_equal(ct["pos0"]["self"]["pos"].numpy(),
                                  np.asarray(cj["pos0"]["self"]["pos"]))


def test_dense_decode_chain_matches_reference(pair):
    """tests/test_serving.py:33's dense chain, run by both packages."""
    jm, params, tm = pair
    prompt = [5, 6, 7, 8]
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray([prompt], jnp.int32)},
                        cache_len=16)
    lt, ct = tm.prefill(torch.tensor([prompt], dtype=torch.int32),
                        cache_len=16)
    seq_j, seq_t = [int(jnp.argmax(lj[0]))], [int(lt[0].argmax())]
    pos = len(prompt)
    for _ in range(5):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
        assert seq_t == seq_j
        lj, cj = jm.decode_step(params, jnp.asarray([seq_j[-1]], jnp.int32),
                                jnp.asarray([pos], jnp.int32), cj)
        lt, ct = tm.decode_step(torch.tensor([seq_t[-1]], dtype=torch.int32),
                                torch.tensor([pos], dtype=torch.int32), ct)
        seq_j.append(int(jnp.argmax(lj[0])))
        seq_t.append(int(lt[0].argmax()))
        pos += 1
    assert seq_t == seq_j


def test_empty_cache_and_decode_from_it_match_reference(pair):
    jm, params, tm = pair
    cj, ct = jm.empty_cache(2, 10), tm.empty_cache(2, 10)
    for name in ("k", "v", "pos"):
        a, b = cj["pos0"]["self"][name], ct["pos0"]["self"][name]
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    toks, pos = np.array([3, 77], np.int32), np.array([0, 4], np.int32)
    lj, _ = jm.decode_step(params, jnp.asarray(toks), jnp.asarray(pos), cj)
    lt, ct = tm.decode_step(torch.from_numpy(toks), torch.from_numpy(pos), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    assert ct["pos0"]["self"]["pos"][:, :, :5].tolist() == \
        [[[0, -1, -1, -1, -1], [-1, -1, -1, -1, 4]]] * 2


@pytest.mark.parametrize("arch", ["yi_9b", "gemma3_12b"])
def test_decode_past_the_dense_cache_raises(pair, arch):
    """Decoding at a position past the end of a global layer's cache: the
    reference's scatter drops the write and returns finite logits that
    attend without the current token; the port refuses with a typed error
    that names the position and the cache size, before any layer writes
    (gemma3's local layers come first in its pattern, and their rings stay
    as the prefill left them)."""
    if arch == "yi_9b":
        jm, params, tm = pair
    else:
        jm = jax_build(jax_smoke(arch))
        params = jm.init(jax.random.PRNGKey(0))
        tm = build_model(get_smoke_config(arch)).load_params(
            jax.tree.map(np.asarray, params), device="cpu")
    prompt, tok, pos = [[3, 4, 5, 6]], [7], [4]
    _, cj = jm.prefill(params, {"tokens": jnp.asarray(prompt, jnp.int32)}, cache_len=4)
    lj, _ = jm.decode_step(params, jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32), cj)
    assert np.isfinite(np.asarray(lj)).all()
    _, ct = tm.prefill(torch.tensor(prompt, dtype=torch.int32), cache_len=4)
    before = [(path, leaf.clone()) for path, leaf in _leaves(ct)]
    with pytest.raises(ValueError, match=r"decode position 4 .*\(4 slots\)"):
        tm.decode_step(torch.tensor(tok, dtype=torch.int32), torch.tensor(pos, dtype=torch.int32),
                       ct)
    after = dict(_leaves(ct))
    for path, leaf in before:
        assert torch.equal(after[path], leaf), path
