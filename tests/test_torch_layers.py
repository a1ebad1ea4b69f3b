"""Parity of the port's building blocks (norm, RoPE, SwiGLU, embedding,
unembedding) with the reference's, on identical numpy inputs."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.convert import array_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

# the reference's own kernel-test tolerances (tests/test_kernels.py:29)
TOL = {"float32": dict(atol=5e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a CPU torch tensor."""
    j = jnp.asarray(a, dtype=getattr(jnp, dtype))
    return j, array_from_numpy(np.asarray(j), device="cpu")


def _close(j, t, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, dtype=np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 5, 64)) * 3, dtype)
    wj, wt = _pair(1 + 0.1 * rng.standard_normal(64), dtype)
    _close(jl.rmsnorm(xj, wj, 1e-5), tl.rmsnorm(xt, wt, 1e-5), dtype)
    _close(jl.apply_norm(xj, {"scale": wj}, "rmsnorm", 1e-5),
           tl.apply_norm(xt, {"scale": wt}, "rmsnorm", 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope(dtype, theta):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 7, 4, 16)), dtype)
    pos = rng.integers(0, 600, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(tl.rope_freqs(16, theta).numpy(),
                               np.asarray(jl.rope_freqs(16, theta)),
                               **TOL["float32"])
    _close(jl.apply_rope(xj, jnp.asarray(pos), theta),
           tl.apply_rope(xt, torch.from_numpy(pos), theta), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 3, 64)), dtype)
    pj, pt = {}, {}
    for name, shape in (("wi_gate", (64, 128)), ("wi_up", (64, 128)),
                        ("wo", (128, 64))):
        pj[name], pt[name] = _pair(rng.standard_normal(shape) / 8, dtype)
    _close(jl.mlp_apply(xj, pj, "swiglu"), tl.mlp_apply(xt, pt, "swiglu"),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [False, True])
def test_embed_unembed(dtype, scale):
    rng = np.random.default_rng(3)
    pj, pt = {}, {}
    pj["tok"], pt["tok"] = _pair(rng.standard_normal((128, 64)), dtype)
    pj["unembed"], pt["unembed"] = _pair(rng.standard_normal((64, 128)) / 8,
                                         dtype)
    toks = rng.integers(0, 128, size=(2, 9)).astype(np.int32)
    ej = jl.embed_tokens(jnp.asarray(toks), pj, scale, 64)
    et = tl.embed_tokens(torch.from_numpy(toks), pt, scale, 64)
    _close(ej, et, dtype)
    _close(jl.unembed(ej, pj), tl.unembed(et, pt), dtype)
    # tied embeddings: the transposed token table
    tied_j, tied_t = {"tok": pj["tok"]}, {"tok": pt["tok"]}
    _close(jl.unembed(ej, tied_j), tl.unembed(et, tied_t), dtype)


def test_dense_init_scale_and_dtype():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (256, 4, 32), device="cpu")
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (256, 4, 32)
    # normal × 1/√fan_in: std ≈ 1/16 over 32k draws
    assert abs(w.float().std().item() - 1 / 16) < 2e-3
