"""The port's plain paged attention (what the CUDA kernel is held to on
the card, and what its wrapper runs on CPU tensors) against the
reference's oracle and its Pallas kernel in interpret mode."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.ops import paged_attention as jax_paged  # noqa: E402
from repro_torch.convert import array_from_numpy  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref  # noqa: E402

TOL = {"float32": dict(atol=5e-5, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _inputs(B, Hq, Hkv, D, P, T, MAXP, dtype, seed=0):
    """numpy inputs shared by both packages (random ragged lengths,
    distinct pages, everything sealed and owned)."""
    rng = np.random.default_rng(seed)
    cast = lambda a: np.asarray(jnp.asarray(a, getattr(jnp, dtype)))
    return [
        cast(rng.standard_normal((B, Hq, D))),
        cast(rng.standard_normal((P, T, Hkv, D))),
        cast(rng.standard_normal((P, T, Hkv, D))),
        rng.permutation(P)[: B * MAXP].reshape(B, MAXP).astype(np.int32),
        rng.integers(1, MAXP * T + 1, size=B).astype(np.int32),
        np.ones(P, np.int32),
        np.array([0, P, 1], np.int32),
        np.ones(P, np.int32),
    ]


def _run_both(args, backend):
    o_j, b_j = jax_paged(*[jnp.asarray(a) for a in args], backend=backend)
    o_t, b_t = paged_attention(*[array_from_numpy(a, "cpu") for a in args])
    return (np.asarray(o_j, np.float32), np.asarray(b_j),
            o_t.float().numpy(), b_t.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("heads", [(4, 1), (4, 2), (8, 8)])
@pytest.mark.parametrize("B", [1, 2])
def test_matches_reference_sweep(B, heads, D, dtype):
    Hq, Hkv = heads
    args = _inputs(B, Hq, Hkv, D, P=16, T=8, MAXP=4, dtype=dtype,
                   seed=B * 100 + Hq * 10 + Hkv + D)
    for backend in ("ref", "interpret"):
        o_j, b_j, o_t, b_t = _run_both(args, backend)
        np.testing.assert_array_equal(b_t, b_j)
        np.testing.assert_allclose(o_t, o_j, **TOL[dtype])


def _semantic_case(name):
    """The four sandbox cases of tests/test_kernels.py:70-99."""
    args = _inputs(2, 4, 2, 64, P=32, T=16, MAXP=4, dtype="float32")
    if name == "wild_pointer":
        args[3][0, 0] = 999                      # out of pool bounds
    elif name == "unsealed_page":
        args[5][args[3][1, 0]] = 0               # clear SEALED bit
    elif name == "sandbox_off":
        args[5][:] = 0                           # nothing sealed ...
        args[6] = np.array([0, 32, 0], np.int32)  # ... but enforce=0
    elif name == "foreign_bitmap":
        args[7][args[3][0, 0]] = 0               # another connection's page
    return args


@pytest.mark.parametrize("name", ["wild_pointer", "unsealed_page",
                                  "sandbox_off", "foreign_bitmap"])
def test_sandbox_semantics(name):
    args = _semantic_case(name)
    o_j, b_j, o_t, b_t = _run_both(args, "interpret")
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_allclose(o_t, o_j, **TOL["float32"])
    assert np.isfinite(o_t).all()
    expect = {"wild_pointer": [1, 0], "unsealed_page": [0, 1],
              "sandbox_off": [0, 0], "foreign_bitmap": [1, 0]}[name]
    assert b_t.tolist() == expect


def test_row_without_valid_tokens_is_zero():
    """seq_len 0, or every in-use page rejected: zeros, never NaN."""
    args = _inputs(2, 4, 2, 16, P=16, T=8, MAXP=4, dtype="float32")
    args[4] = np.array([0, 9], np.int32)
    args[7][args[3][1, :2]] = 0       # both in-use pages of row 1 foreign
    o_j, b_j, o_t, b_t = _run_both(args, "interpret")
    assert b_t.tolist() == b_j.tolist() == [0, 2]
    assert (o_t == 0).all() and (o_j == 0).all()


def test_wrapper_dispatches_cpu_to_plain_version():
    args = [array_from_numpy(a, "cpu") for a in
            _inputs(1, 4, 2, 16, P=16, T=8, MAXP=4, dtype="float32")]
    before = paged_attention.launches
    o1, b1 = paged_attention(*args)
    o2, b2 = paged_attention_ref(*args)
    assert torch.equal(o1, o2) and torch.equal(b1, b2)
    assert paged_attention.launches == before   # no kernel on the CPU
