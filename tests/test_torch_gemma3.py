"""The port's gemma3 (smoke config: one super-block of 5 local layers with
an 8-token window and 1 global layer) against the reference's on the same
weights: the config, the init tree, prefill logits and every cache leaf
(the local layers' rings included) under and past the window, a decode
chain across the ring wrap, and the port's own fp32 teacher forcing.

The reference's init sets the gemma norm scales to zeros and qk-norm
scales to ones; both packages get the same numpy-seeded scales on top, so
the ``1 + w`` form and the qk-norm weights are exercised."""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import apply_norm, init_norm  # noqa: E402

ARCH = "gemma3_12b"
BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:29
NORMS = ("norm_in", "norm_mlp", "norm_f", "q_norm", "k_norm")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + ".")
        else:
            yield path, v


def _spec(a):
    return tuple(a.shape), str(a.dtype).replace("torch.", "")


def _perturb_norms(tree, rng):
    """Every norm scale plus N(0, 0.3), rounded to bf16 on the numpy side."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_norms(v, rng)
        elif k == "scale" or k in NORMS:
            noise = rng.normal(0, 0.3, v.shape).astype(np.float32)
            out[k] = np.asarray(jnp.asarray(v.astype(np.float32) + noise, v.dtype))
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(jax_smoke(ARCH))
    tree = _perturb_norms(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))),
                          np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, tree)
    tm = build_model(get_smoke_config(ARCH)).load_params(tree, device="cpu")
    return jm, params, tm


def test_config_matches_reference():
    for name in (ARCH, "gemma3-12b"):
        assert get_config(name).__dict__ == jax_config(name).__dict__
    assert get_smoke_config(ARCH).__dict__ == jax_smoke(ARCH).__dict__
    cfg = get_config(ARCH)
    assert [s.sliding_window for s in cfg.block_pattern()] == [1024] * 5 + [0]
    assert [s.rope_theta for s in cfg.block_pattern()] == [1e4] * 5 + [1e6]
    assert 11.5e9 < cfg.param_count() < 12.1e9


def test_init_tree_matches_reference():
    """Key paths, shapes and dtypes; gemma norm scales are zeros and the
    qk-norm scales ones, as the reference initialises them."""
    jshapes = dict(_leaves(jax_build(jax_smoke(ARCH)).param_shapes()))
    tm = build_model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0),
                                                  device="cpu")
    got = {n: _spec(p) for n, p in tm.named_parameters()}
    assert got == {n: (tuple(s.shape), str(s.dtype)) for n, s in jshapes.items()}
    for name, p in tm.named_parameters():
        last = name.split(".")[-1]
        if last == "scale":
            assert not p.any(), name
        elif last in ("q_norm", "k_norm"):
            assert bool((p == 1).all()), name


def test_load_params_carries_every_leaf(pair):
    """``params_from_numpy`` on the gemma3 tree: the six super-block
    positions, the qk-norm scales and the gemma norm scales, bitwise."""
    _, params, tm = pair
    leaves = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert {n.split(".")[1] for n in leaves if n.startswith("stack.")} == \
        {f"pos{i}" for i in range(6)}
    assert sum(n.endswith(("q_norm", "k_norm")) for n in leaves) == 12
    for name, leaf in leaves.items():
        got = tm.get_parameter(name)
        assert _spec(got) == (tuple(leaf.shape), str(leaf.dtype)), name
        np.testing.assert_array_equal(got.float().numpy(), leaf.astype(np.float32))


def test_gemma_norm_scales_by_one_plus_w():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 8)).astype(np.float32))
    p = init_norm(8, "rmsnorm_gemma", device="cpu")
    torch.testing.assert_close(apply_norm(x, p, "rmsnorm_gemma", 1e-6),
                               apply_norm(x, {"scale": torch.ones(8)}, "rmsnorm", 1e-6))
    p["scale"] = torch.full((8,), 0.5)
    torch.testing.assert_close(apply_norm(x, p, "rmsnorm_gemma", 1e-6),
                               1.5 * apply_norm(x, init_norm(8, "rmsnorm", "cpu"),
                                                "rmsnorm", 1e-6).float())


def _assert_caches_close(ct, cj):
    for i, spec in enumerate(jax_smoke(ARCH).block_pattern()):
        got, want = ct[f"pos{i}"]["self"], cj[f"pos{i}"]["self"]
        for name in ("k", "v", "pos"):
            assert _spec(got[name]) == _spec(want[name]), (i, name)
        if spec.sliding_window:
            assert got["k"].shape[2] <= spec.sliding_window
        np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name].float().numpy(),
                                       np.asarray(want[name], np.float32), **BF16)


@pytest.mark.parametrize("S,cache_len", [(6, 16), (20, 30)])
def test_prefill_matches_reference(pair, S, cache_len):
    """S = 6 stays under the local window of 8; S = 20 is past it, so the
    rings keep the last 8 tokens at slot pos % 8."""
    jm, params, tm = pair
    toks = np.random.default_rng(S).integers(1, 256, size=(2, S)).astype(np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks)}, cache_len=cache_len)
    lt, ct = tm.prefill(torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    _assert_caches_close(ct, cj)
    if S > 8:
        ring = ct["pos0"]["self"]["pos"][0, 0].tolist()
        assert sorted(ring) == list(range(S - 8, S))
        assert all(p % 8 == slot for slot, p in enumerate(ring))


def test_decode_chain_across_the_ring_wrap_matches_reference(pair):
    """Prefill 6 tokens, then 10 teacher-forced decode steps (positions
    6..15): the local rings of 8 slots wrap at position 8."""
    jm, params, tm = pair
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, cache_len=16)
    lt, ct = tm.prefill(torch.from_numpy(toks[:, :6]), cache_len=16)
    for t in range(6, 16):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
        pos = np.full((2,), t, np.int32)
        lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        lt, ct = tm.decode_step(torch.from_numpy(toks[:, t]), torch.from_numpy(pos), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16)
    _assert_caches_close(ct, cj)
    assert sorted(ct["pos0"]["self"]["pos"][0, 0].tolist()) == list(range(8, 16))


def test_empty_cache_matches_reference(pair):
    jm, _, tm = pair
    cj, ct = jm.empty_cache(2, 12), tm.empty_cache(2, 12)
    for i in range(6):
        for name in ("k", "v", "pos"):
            got, want = ct[f"pos{i}"]["self"][name], cj[f"pos{i}"]["self"][name]
            assert _spec(got) == _spec(want)
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("window", [8, 3])
def test_teacher_forced_decode_matches_prefill_fp32(window):
    """tests/test_arch_smoke.py:103-150 on the port alone: in fp32, each
    decode step through the ring caches equals a prefill of the prefix
    (the flash-prefill path) plus that token."""
    cfg = replace(get_smoke_config(ARCH), sliding_window=window)
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu").float()
    B, S, K = 2, 20, 10
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32))
    logits, cache = tm.prefill(toks[:, :K], cache_len=S)
    assert cache["pos0"]["self"]["k"].shape[2] == window
    for t in range(K, S):
        ref, _ = tm.prefill(toks[:, : t + 1])
        logits, cache = tm.decode_step(toks[:, t], torch.full((B,), t, dtype=torch.int32),
                                       cache)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-3, rtol=0)
