"""The port's SSD scan (``repro_torch.kernels.ssd``) against the reference's
on the same numpy inputs: the intra-chunk plain version against the Pallas
kernel in interpret mode, the chunked scan against the reference's and
against the sequential recurrence, strong decays that overflow an
unmasked exp, state continuation, chunk-size invariance and padding."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.kernel import ssd_intra_chunk_pallas  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunked as jax_ops_chunked  # noqa: E402
from repro.kernels.ssd.ref import ssd_sequential_ref as jax_sequential  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_model_chunked  # noqa: E402
from repro_torch.kernels.ssd import (  # noqa: E402
    ssd_chunked,
    ssd_chunked_ref,
    ssd_intra_chunk_ref,
    ssd_sequential_ref,
)
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda  # noqa: E402

SCAN = dict(atol=2e-3, rtol=2e-3)    # chunked vs sequential, tests/test_kernels.py:165


def _close_f32(got, want, rel=1e-5):
    """One fp32 formulation against another: they differ by summation
    order, so the absolute tolerance scales with the output's magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1.0))


def _inputs(B, S, H, P, N, seed=0, decay="mild"):
    """numpy inputs. ``mild``: tests/test_kernels.py:137's distribution;
    ``weak``: small steps, so a chunk carries most of its state into the
    next and a dropped chunk shows; ``strong``: mamba2's own init
    (A = -linspace(1, 16), dt = softplus(N(0,1) + dt_bias)), whose
    128-token chunk decays pass 88."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    if decay == "mild":
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        A = -np.exp(rng.standard_normal(H) * 0.5)
    elif decay == "weak":
        dt = rng.uniform(0.005, 0.05, (B, S, H))
        A = -np.linspace(0.1, 1.0, H)
    else:
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
        dt_bias = np.log(np.expm1(dt0))
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_bias))
        A = -np.linspace(1.0, 16.0, H)
    return x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _max_chunk_decay(dt, A, Q):
    B, S, H = dt.shape
    return float((-(dt * A)).reshape(B, S // Q, Q, H).sum(axis=2).max())


@pytest.mark.parametrize("B,S,H,P,N,Q,decay", [
    (1, 32, 8, 16, 16, 16, "mild"), (2, 64, 8, 64, 32, 32, "mild"),
    (1, 96, 16, 16, 32, 32, "mild"), (2, 128, 8, 64, 128, 128, "weak"),
])
def test_intra_chunk_ref_matches_pallas_interpret(B, S, H, P, N, Q, decay):
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, seed=S + N, decay=decay)
    assert _max_chunk_decay(dt, A, Q) < 88.0   # where the reference is finite
    args = (x, dt, A, Bm[:, :, 0], Cm[:, :, 0])
    want = ssd_intra_chunk_pallas(*_j(args), chunk=Q, interpret=True)
    got = ssd_intra_chunk_ref(*_t(args), Q)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_f32(g.numpy(), w)


@pytest.mark.parametrize("B,S,H,P,N,Q,decay", [
    (1, 32, 8, 16, 16, 16, "mild"), (2, 64, 16, 64, 32, 16, "mild"),
    (2, 96, 8, 16, 32, 16, "mild"), (1, 64, 16, 64, 16, 32, "mild"),
    (2, 96, 8, 64, 32, 32, "weak"), (1, 64, 8, 16, 16, 16, "weak"),
])
def test_ssd_chunked_matches_reference_and_sequential(B, S, H, P, N, Q, decay):
    inputs = _inputs(B, S, H, P, N, seed=B * S + H, decay=decay)
    assert _max_chunk_decay(inputs[1], inputs[2], Q) < 88.0   # reference finite
    y, s = ssd_chunked(*_t(inputs), chunk=Q)
    yj, sj = jax_ops_chunked(*_j(inputs), chunk=Q, backend="interpret")
    ys, ss = jax_sequential(*_j(inputs))
    for got, want in ((y, yj), (s, sj), (y, ys), (s, ss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    # the port's own two plain formulations agree to fp32 order
    y2, s2 = ssd_chunked_ref(*_t(inputs), chunk=Q)
    _close_f32(y.numpy(), y2.numpy())
    _close_f32(s.numpy(), s2.numpy())


def test_sequential_ref_matches_reference():
    inputs = _inputs(2, 40, 8, 16, 16, seed=3)
    init = np.random.default_rng(4).standard_normal((2, 8, 16, 16)).astype(np.float32)
    y, s = ssd_sequential_ref(*_t(inputs), init_state=torch.from_numpy(init))
    yj, sj = jax_sequential(*_j(inputs), init_state=jnp.asarray(init))
    _close_f32(y.numpy(), yj)
    _close_f32(s.numpy(), sj)


@pytest.mark.parametrize("B,S,H,Q", [(1, 128, 64, 128), (2, 256, 64, 128)])
def test_strong_decay_stays_finite_and_exact(B, S, H, Q):
    """mamba2's init draws 128-token chunk decays above 88, where exp of
    the unmasked upper triangle overflows (src/repro/kernels/ssd/
    kernel.py:48). The port masks before the exp: finite, and equal to
    the reference's masked formulation and to the recurrence."""
    inputs = _inputs(B, S, H, 64, 128, seed=S, decay="strong")
    assert _max_chunk_decay(inputs[1], inputs[2], Q) > 88.0
    y_diag, states, decay = ssd_intra_chunk_ref(
        *_t((inputs[0], inputs[1], inputs[2], inputs[3][:, :, 0], inputs[4][:, :, 0])), Q)
    assert all(torch.isfinite(t).all() for t in (y_diag, states, decay))
    y, s = ssd_chunked(*_t(inputs), chunk=Q)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yj, sj = jax_model_chunked(*_j(inputs), chunk=Q, use_kernel=False)
    ys, ss = jax_sequential(*_j(inputs))
    for got, want in ((y, yj), (s, sj)):
        _close_f32(got.numpy(), want)
    for got, want in ((y, ys), (s, ss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


def test_constant_step_strong_decay_matches_recurrence():
    """dt = 0.15 everywhere and A = -linspace(1, 16, 8): the chunk decays
    of 6 of the 8 heads pass 88 (0.15 · 128 · |A| > 88 for |A| > 4.6)."""
    rng = np.random.default_rng(11)
    B, S, H, P, N, Q = 1, 128, 8, 64, 128, 128
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), 0.15, np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    inputs = (x, dt, A, Bm, Cm)
    assert int((0.15 * 128 * -A > 88).sum()) == 6
    y, s = ssd_chunked(*_t(inputs), chunk=Q)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yj, sj = jax_model_chunked(*_j(inputs), chunk=Q, use_kernel=False)
    ys, ss = jax_sequential(*_j(inputs))
    for got, want in ((y, yj), (s, sj)):
        _close_f32(got.numpy(), want)
    for got, want in ((y, ys), (s, ss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)


def test_init_state_continuation():
    """Two calls with the state carried equal one call over the whole
    sequence (tests/test_kernels.py:173), and match the reference's."""
    inputs = _inputs(2, 64, 8, 16, 16, seed=7, decay="weak")
    x, dt, A, Bm, Cm = _t(inputs)
    y_full, s_full = ssd_chunked(x, dt, A, Bm, Cm, chunk=16)
    _, s1 = ssd_chunked(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=16)
    y2, s2 = ssd_chunked(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=16,
                         init_state=s1)
    np.testing.assert_allclose(y2.numpy(), y_full[:, 32:].numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4, rtol=1e-4)
    xj, dtj, Aj, Bj, Cj = _j(inputs)
    _, sj1 = jax_ops_chunked(xj[:, :32], dtj[:, :32], Aj, Bj[:, :32], Cj[:, :32],
                             chunk=16, backend="ref")
    yj2, sj2 = jax_ops_chunked(xj[:, 32:], dtj[:, 32:], Aj, Bj[:, 32:], Cj[:, 32:],
                               chunk=16, backend="ref", init_state=sj1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(yj2), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(sj2), atol=1e-4, rtol=1e-4)


def test_chunk_size_invariance():
    inputs = _t(_inputs(1, 96, 8, 16, 16, seed=9, decay="weak"))
    outs = [ssd_chunked(*inputs, chunk=q) for q in (16, 32, 96)]
    for y, s in outs[1:]:
        np.testing.assert_allclose(y.numpy(), outs[0][0].numpy(), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(s.numpy(), outs[0][1].numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("S,Q", [(100, 16), (10, 16), (300, 128)])
def test_padding_leaves_output_and_state_unchanged(S, Q):
    """S not a multiple of Q, and S < Q: padded steps (dt = 0) must not
    touch y or the final state."""
    inputs = _inputs(2, S, 8, 16, 16, seed=S, decay="weak")
    y, s = ssd_chunked(*_t(inputs), chunk=Q)
    assert y.shape == (2, S, 8, 16)
    ys, ss = jax_sequential(*_j(inputs))
    np.testing.assert_allclose(y.numpy(), np.asarray(ys), **SCAN)
    np.testing.assert_allclose(s.numpy(), np.asarray(ss), **SCAN)
    yj, sj = jax_ops_chunked(*_j(inputs), chunk=Q, backend="interpret")
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-4, rtol=1e-4)


def test_bf16_inputs_keep_dtype():
    x, dt, A, Bm, Cm = _t(_inputs(1, 48, 8, 16, 16, seed=2))
    y, s = ssd_chunked(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y32, _ = ssd_chunked(x.bfloat16().float(), dt, A, Bm.bfloat16().float(),
                         Cm.bfloat16().float(), chunk=16)
    np.testing.assert_allclose(y.float().numpy(), y32.bfloat16().float().numpy(),
                               atol=1e-2, rtol=1e-2)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The plain version runs only because a tensor lies on the CPU; the
    kernel's wrapper itself never falls back."""
    x, dt, A, Bm, Cm = _t(_inputs(1, 16, 8, 16, 16))
    n0 = ssd_intra_chunk_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_intra_chunk_cuda(x, dt, A, Bm[:, :, 0], Cm[:, :, 0], 16)
    assert ssd_intra_chunk_cuda.launches == n0
