"""K3's backward on the CPU: the row log-sum-exp the forward now saves,
the plain gradient (``flash_prefill_vjp``) given it, ``FlashPrefillFn``
saving it (also under ``torch.utils.checkpoint``), and the backward
kernel's wrapper refusing what it does not take. Inputs are numpy arrays
from a seed, fed to the reference (``jax.nn.logsumexp`` over the scores
its ``_attend`` builds, ``jax.grad`` of its attention) and to the port.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref  # noqa: E402
import repro_torch.kernels.flash_prefill.ops as k3_ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_prefill import (FlashPrefillFn, flash_prefill_ref,  # noqa: E402
                                               flash_prefill_vjp)
from repro_torch.kernels.flash_prefill.kernel import (flash_prefill_bwd_cuda,  # noqa: E402
                                                      flash_prefill_cuda)

BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:29


def _close_f32(got, want, rel=1e-4):
    """test_torch_train_grads.py's fp32 gradient tolerance: the absolute
    part scales with the gradient's magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1e-6))


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D))]


def _jax_lse(q, k, window, softcap):
    """logsumexp over keys of the scores the reference's ``_attend`` builds
    (src/repro/models/attention.py: fp32 q·k scaled by 1/sqrt(D), the tanh
    softcap, then the causal and window mask with -inf), as (B, Hq, S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, Hkv, Hq // Hkv, D)
    s = jnp.einsum("bqgpd,bkgd->bgpqk", qg, jnp.asarray(k)) * (1.0 / math.sqrt(D))
    if softcap:
        s = jnp.tanh(s / softcap) * softcap
    qp, kp = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
    mask = qp >= kp
    if window:
        mask &= qp - kp < window
    s = jnp.where(mask, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, Hq, S)


# (B, S, Hq, Hkv, D, window, softcap, q_chunk): GQA 1, 2 and 4, windows
# narrower and wider than a chunk, softcaps, S not a multiple of 64 or of
# the query chunk
CASES = [
    (2, 40, 4, 2, 16, 0, 0.0, 1024), (2, 40, 4, 2, 16, 7, 0.0, 16),
    (2, 70, 4, 1, 16, 0, 5.0, 1024), (1, 65, 4, 4, 16, 9, 3.0, 16),
    (1, 100, 6, 3, 8, 33, 0.0, 32), (2, 33, 2, 2, 32, 0, 2.0, 8),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,q_chunk", CASES)
def test_plain_forward_lse_matches_jax_logsumexp(B, S, Hq, Hkv, D, window, softcap, q_chunk):
    """``flash_prefill_ref(..., return_lse=True)``: the row log-sum-exp of
    the reference's masked scores, natural log, fp32 (B, Hq, S); its output
    bitwise the one without it."""
    q, k, v, _ = _inputs(B, S, Hq, Hkv, D, seed=S + D)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_prefill_ref(tq, tk, tv, window=window, softcap=softcap, q_chunk=q_chunk,
                                 return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, Hq, S)
    assert torch.equal(out, flash_prefill_ref(tq, tk, tv, window=window, softcap=softcap,
                                              q_chunk=q_chunk))
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, window, softcap), rtol=1e-5,
                               atol=1e-5)


def _jax_grads(q, k, v, dout, window, softcap):
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, window=window, softcap=softcap),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,q_chunk", CASES)
def test_vjp_given_lse_matches_jax_grad(B, S, Hq, Hkv, D, window, softcap, q_chunk):
    """``flash_prefill_vjp`` with the saved lse (P = exp(s - lse), the
    kernel's formulation) against ``jax.grad`` of the reference attention,
    at test_flash_prefill_vjp_matches_jax_grad's tolerance; and within
    fp32 rounding of the softmax formulation it takes without one."""
    q, k, v, dout = _inputs(B, S, Hq, Hkv, D, seed=S + D + 1)
    tq, tk, tv, td = map(torch.from_numpy, (q, k, v, dout))
    out, lse = flash_prefill_ref(tq, tk, tv, window=window, softcap=softcap, return_lse=True)
    got = flash_prefill_vjp(tq, tk, tv, out, td, window=window, softcap=softcap,
                            q_chunk=q_chunk, lse=lse)
    softmax = flash_prefill_vjp(tq, tk, tv, out, td, window=window, softcap=softcap,
                                q_chunk=q_chunk)
    for g, w, s, t in zip(got, _jax_grads(q, k, v, dout, window, softcap), softmax, (q, k, v)):
        assert g.dtype == torch.float32 and tuple(g.shape) == t.shape
        _close_f32(g.numpy(), w)
        _close_f32(g.numpy(), s.numpy(), rel=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 4.0)])
def test_vjp_given_lse_bf16_matches_jax_grad(window, softcap):
    """bf16 q, k, v: the forward's lse in fp32, grads rounded to bf16,
    against ``jax.grad`` in bf16 at the reference's bf16 tolerance."""
    q, k, v, dout = _inputs(2, 48, 4, 2, 32, seed=7)
    tq, tk, tv, td = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, dout))
    out, lse = flash_prefill_ref(tq, tk, tv, window=window, softcap=softcap, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = flash_prefill_vjp(tq, tk, tv, out, td, window=window, softcap=softcap, lse=lse)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, window=window, softcap=softcap),
                     as_jax(tq), as_jax(tk), as_jax(tv))
    for g, w in zip(got, vjp(as_jax(td))):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **BF16)


def _recording_forward(calls):
    """``flash_prefill_ref`` that records each call's lse request and the
    lse it returns."""
    def forward(*a, **kw):
        res = flash_prefill_ref(*a, **kw)
        calls.append(res[1] if kw.get("return_lse") else None)
        return res
    return forward


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 2.5)])
def test_function_on_cpu_saves_the_lse_and_its_backward_takes_it(window, softcap, monkeypatch):
    """On CPU tensors ``FlashPrefillFn``'s forward asks for the lse where an
    input needs its gradient, and its backward hands that lse to
    ``flash_prefill_vjp``; the grads are ``jax.grad``'s."""
    q, k, v, dout = _inputs(2, 30, 4, 2, 16, seed=3)
    calls, seen = [], []

    def vjp(*a, **kw):
        seen.append(kw["lse"])
        return flash_prefill_vjp(*a, **kw)
    monkeypatch.setattr(k3_ops, "flash_prefill_vjp", vjp)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FlashPrefillFn.apply(*leaves, window, softcap, _recording_forward(calls))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    assert len(calls) == 1 and calls[0] is not None and len(seen) == 1
    assert seen[0] is calls[0]
    for g, w in zip(got, _jax_grads(q, k, v, dout, window, softcap)):
        _close_f32(g.numpy(), w)


def test_function_without_grad_asks_for_no_lse():
    """Inputs that need no gradient (the serving prefill): the forward is
    called as before, without ``return_lse``, and saves nothing."""
    q, k, v, _ = _inputs(1, 20, 4, 2, 16, seed=4)
    calls = []
    out = FlashPrefillFn.apply(*map(torch.from_numpy, (q, k, v)), 0, 0.0,
                               _recording_forward(calls))
    assert calls == [None] and out.grad_fn is None


def test_function_under_checkpoint_uses_the_recomputed_lse(monkeypatch):
    """Under ``torch.utils.checkpoint`` the forward runs twice (the forward,
    then the recompute in the backward), each asking for the lse; the
    backward takes the recomputed forward's, and the grads equal those
    without checkpointing bitwise."""
    q, k, v, dout = _inputs(1, 24, 4, 2, 16, seed=5)
    calls, seen = [], []

    def vjp(*a, **kw):
        seen.append(kw["lse"])
        return flash_prefill_vjp(*a, **kw)
    monkeypatch.setattr(k3_ops, "flash_prefill_vjp", vjp)
    forward = _recording_forward(calls)

    def block(a, b, c):
        return FlashPrefillFn.apply(a * 2.0, b, c, 0, 0.0, forward) * 0.5

    def grads(remat):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = (torch.utils.checkpoint.checkpoint(block, *leaves, use_reentrant=False)
               if remat else block(*leaves))
        return torch.autograd.grad(out, leaves, torch.from_numpy(dout))

    plain = grads(False)
    remat = grads(True)
    assert len(calls) == 3 and all(c is not None for c in calls)
    assert len(seen) == 2 and seen[0] is calls[0] and seen[1] is calls[2]
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def _bwd_args(D=64, dtype=torch.float32, S=20):
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in _inputs(1, S, 4, 2, D, seed=6))
    return [q, k, v, q.clone(), dout, torch.zeros((1, 4, S))]


@pytest.mark.parametrize("change,match", [
    (lambda a: a, "CUDA device"),
    (lambda a: _bwd_args(D=48), "head_dim"),
    (lambda a: [a[0], a[1].bfloat16()] + a[2:], "share a dtype"),
    (lambda a: a[:5] + [a[5].double()], "lse must be float32"),
    (lambda a: a[:5] + [a[5][:, :, :-1]], r"lse must be \(B, Hq, S\)"),
    (lambda a: [a[0].transpose(1, 2).contiguous().transpose(1, 2)] + a[1:], "contiguous"),
    (lambda a: [t[:, :, :3] for t in a[:1]] + a[1:3] + [t[:, :, :3] for t in a[3:5]]
     + [a[5][:, :3]], "multiple of Hkv"),
    (lambda a: [t.half() for t in a[:5]] + a[5:], "unsupported dtype"),
], ids=["cpu", "head_dim", "mixed", "lse_dtype", "lse_shape", "strided", "heads", "half"])
def test_bwd_wrapper_refuses_without_building(change, match, monkeypatch):
    """``flash_prefill_bwd_cuda`` checks its inputs before the kernels are
    built: CPU tensors, a head_dim it has no instantiation for, mixed
    dtypes, an lse of another dtype or shape, inputs that are not
    contiguous, Hq not a multiple of Hkv, fp16. Nothing launches."""
    def no_build():
        raise AssertionError("the kernels were built")
    monkeypatch.setattr(build, "library", no_build)
    n0, n1 = flash_prefill_bwd_cuda.launches, flash_prefill_cuda.launches
    with pytest.raises(ValueError, match=match):
        flash_prefill_bwd_cuda(*change(_bwd_args()), window=3, softcap=0.0)
    assert (flash_prefill_bwd_cuda.launches, flash_prefill_cuda.launches) == (n0, n1)


def test_forward_wrapper_with_lse_refuses_cpu_tensors(monkeypatch):
    """``flash_prefill_cuda(..., return_lse=True)`` is still the kernel or an
    error: on CPU tensors it raises before building anything."""
    monkeypatch.setattr(build, "library", lambda: pytest.fail("the kernels were built"))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 20, 4, 2, 64, seed=8))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_prefill_cuda(q, k, v, return_lse=True)
