"""The port's plain causal prefill attention (``flash_prefill_ref``, what
the CUDA kernel is held to) against the reference's: its own plain
version and its Pallas kernel in interpret mode, over a parametrised
subset of tests/test_kernels.py:106-126's sweep; and against the port's
decode-path ``_attend`` with a window. Inputs come from numpy seeds."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill.ops import flash_prefill as jax_flash_prefill  # noqa: E402
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref  # noqa: E402
from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda  # noqa: E402
from repro_torch.models.attention import _attend  # noqa: E402


def _tol(dtype):
    """tests/test_kernels.py:29: bf16 at the reference's model tolerance,
    f32 at accumulation order."""
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=5e-5, rtol=1e-4)


# S × heads × dtype in full; D, (window, softcap) and B cycle so that every
# value of each appears and every (window, softcap) pair meets each S
WINDOW_SOFTCAP = list(itertools.product((0, 32), (0.0, 30.0)))
CASES = [
    (S, heads, D, window, softcap, dtype, B)
    for n, (S, heads, dtype) in enumerate(itertools.product(
        (64, 100, 256), ((4, 2), (8, 8), (4, 1)), ("float32", "bfloat16")))
    for D, (window, softcap), B in [((64, 128)[(n // 2) % 2],
                                     WINDOW_SOFTCAP[(n + n // 6) % 4], 1 + (n // 3) % 2)]
]


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def _run_both(case, backend, **kw):
    S, (Hq, Hkv), D, window, softcap, dtype, B = case
    arrays = _inputs(B, S, Hq, Hkv, D, seed=S + 7 * Hq + D)
    want = jax_flash_prefill(*[jnp.asarray(a, dtype) for a in arrays], window=window,
                             softcap=softcap, backend=backend, **kw)
    got = flash_prefill_ref(*[torch.from_numpy(a).to(getattr(torch, dtype))
                              for a in arrays], window=window, softcap=softcap)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **_tol(dtype))


def test_sweep_covers_every_value():
    for i, values in enumerate(((64, 100, 256), ((4, 2), (8, 8), (4, 1)), (64, 128),
                                (0, 32), (0.0, 30.0), ("float32", "bfloat16"))):
        assert {c[i] for c in CASES} == set(values)
    assert {(c[0], c[3], c[4]) for c in CASES} == set(
        itertools.product((64, 100, 256), (0, 32), (0.0, 30.0)))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ref_matches_reference_ref(case):
    _run_both(case, "ref")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_ref_matches_reference_kernel_interpret(case):
    """The reference's Pallas kernel at 64-row blocks: S = 100 pads."""
    _run_both(case, "interpret", bq=64, bk=64)


@pytest.mark.parametrize("S,window", [(37, 0), (37, 8), (100, 32), (100, 1)])
@pytest.mark.parametrize("heads", [(4, 2), (4, 1)])
def test_ref_matches_attend_with_window(S, window, heads):
    """The prefill kernel's plain version against the decode path's
    ``_attend`` over the same causal window, in f32."""
    Hq, Hkv = heads
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, S, Hq, Hkv, 16, seed=S + window))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    want = _attend(q, k, v, pos, pos, causal=True, window=window)
    got = flash_prefill_ref(q, k, v, window=window)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (40, 30.0)])
@pytest.mark.parametrize("S", [48, 100])
def test_ref_query_chunks_agree_with_one_chunk(S, window, softcap):
    """Chunks of 16 query rows, each against only the keys its rows can
    see, give the one-chunk result to f32 summation order (1e-6)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, S, 4, 2, 16, seed=S + window))
    whole = flash_prefill_ref(q, k, v, window=window, softcap=softcap, q_chunk=S)
    got = flash_prefill_ref(q, k, v, window=window, softcap=softcap, q_chunk=16)
    torch.testing.assert_close(got, whole, atol=1e-6, rtol=1e-6)


def test_cpu_tensor_takes_the_plain_version_and_the_kernel_refuses_it():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 20, 4, 2, 64, seed=3))
    n0 = flash_prefill_cuda.launches
    torch.testing.assert_close(flash_prefill(q, k, v, window=5, softcap=30.0),
                               flash_prefill_ref(q, k, v, window=5, softcap=30.0),
                               atol=0, rtol=0)
    assert flash_prefill_cuda.launches == n0
    with pytest.raises(ValueError, match="CUDA device"):
        flash_prefill_cuda(q, k, v)
