"""The port's page gather/scatter against the reference's oracle and its
Pallas kernels in interpret mode: bitwise, ids clamped to [0, P-1]."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.scope_copy.ops import gather_pages as jax_gather  # noqa: E402
from repro.kernels.scope_copy.ops import scatter_pages as jax_scatter  # noqa: E402
from repro_torch.convert import array_from_numpy  # noqa: E402
from repro_torch.kernels.scope_copy import gather_pages, scatter_pages  # noqa: E402


def _pool(rng, shape, dtype):
    if dtype == "int32":
        return rng.integers(-1000, 1000, size=shape).astype(np.int32)
    return np.asarray(jnp.asarray(rng.standard_normal(shape),
                                  getattr(jnp, dtype)))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ids include out-of-range entries on both sides, which both clamp
PAGES = {1: [5], 4: [3, 9, -2, 40], 6: [0, 15, 7, 2, 99, 11]}


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("n", [1, 4, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_gather_matches_reference(dtype, n, backend):
    rng = np.random.default_rng(n)
    pool = _pool(rng, (16, 128), dtype)
    pages = np.array(PAGES[n], np.int32)
    g_j = jax_gather(jnp.asarray(pool), jnp.asarray(pages), backend=backend)
    g_t = gather_pages(array_from_numpy(pool, "cpu"),
                       array_from_numpy(pages, "cpu"))
    np.testing.assert_array_equal(_bits(g_t.view(torch.int16)
                                        if g_t.dtype == torch.bfloat16
                                        else g_t).view(_bits(g_j).dtype),
                                  _bits(g_j))


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_scatter_matches_reference_in_place(dtype, backend):
    rng = np.random.default_rng(1)
    pool = _pool(rng, (16, 128), dtype)
    buf = _pool(rng, (4, 128), dtype)
    pages = np.array([3, 9, -2, 40], np.int32)   # distinct after clamping
    s_j = jax_scatter(jnp.asarray(pool), jnp.asarray(pages),
                      jnp.asarray(buf), backend=backend)
    pool_t = array_from_numpy(pool, "cpu")
    out = scatter_pages(pool_t, array_from_numpy(pages, "cpu"),
                        array_from_numpy(buf, "cpu"))
    assert out.data_ptr() == pool_t.data_ptr()   # updated in place
    want = _bits(s_j)
    got = pool_t.view(torch.int16).numpy() if pool_t.dtype == torch.bfloat16 \
        else pool_t.numpy()
    np.testing.assert_array_equal(got.view(want.dtype), want)


def test_wrappers_take_plain_version_on_cpu():
    pool = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    pages = torch.tensor([1, 7], dtype=torch.int32)
    g0, s0 = gather_pages.launches, scatter_pages.launches
    wire = gather_pages(pool, pages)
    scatter_pages(pool, torch.tensor([0, 2], dtype=torch.int32), wire)
    assert torch.equal(pool[0], pool[1]) and torch.equal(pool[2], pool[7])
    assert (gather_pages.launches, scatter_pages.launches) == (g0, s0)
