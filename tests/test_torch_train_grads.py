"""Gradients of the port against the reference's ``jax.grad`` on the same
numpy inputs: K3's and K4's gradients (``flash_prefill_vjp``,
``ssd_intra_chunk_vjp``) and their ``autograd.Function``s, run here with
the plain forward in the kernel's place; the kernel wrappers' refusal of
inputs that require grad; the MoE FFN repaired for autograd (the gate
and the dropless products equal to the in-place formulas they replace);
and ``Model.loss_fn`` with its gradients for every smoke configuration.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref  # noqa: E402
from repro.kernels.ssd.ref import ssd_sequential_ref as jax_sequential  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_model_chunked  # noqa: E402
import repro_torch.kernels.ssd.ops as ssd_ops  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_prefill import (FlashPrefillFn, flash_prefill,  # noqa: E402
                                               flash_prefill_ref, flash_prefill_vjp)
from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda  # noqa: E402
from repro_torch.kernels.ssd import (SsdIntraChunkFn, ssd_chunked,  # noqa: E402
                                     ssd_intra_chunk_ref, ssd_intra_chunk_vjp)
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import image_positions  # noqa: E402

BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:29
# the model's gradients, fp32 on both sides: the reference's own
# test_grad_accum_matches_full_batch tolerance
GRAD = dict(atol=2e-5, rtol=2e-4)


def _close_f32(got, want, rel=1e-4):
    """One fp32 gradient against another computed in another order: the
    absolute tolerance scales with the gradient's magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1e-6))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# K3: flash_prefill
# ---------------------------------------------------------------------------
def _k3_inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    dout = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    return q, k, v, dout


def _jax_k3_grads(q, k, v, dout, window, softcap):
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, window=window, softcap=softcap),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(dout))


# (B, S, Hq, Hkv, D, window, softcap, q_chunk): GQA, a window, a softcap,
# both with S not a multiple of the query chunk, MHA
K3_GRAD_CASES = [
    (2, 40, 4, 2, 16, 0, 0.0, 1024), (2, 40, 4, 2, 16, 7, 0.0, 1024),
    (2, 40, 4, 1, 16, 0, 5.0, 1024), (1, 37, 4, 2, 16, 9, 3.0, 16),
    (1, 50, 6, 3, 8, 0, 0.0, 16), (2, 33, 2, 2, 32, 0, 2.0, 8),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,q_chunk", K3_GRAD_CASES)
def test_flash_prefill_vjp_matches_jax_grad(B, S, Hq, Hkv, D, window, softcap, q_chunk):
    q, k, v, dout = _k3_inputs(B, S, Hq, Hkv, D, seed=S + D)
    out = flash_prefill_ref(*map(torch.from_numpy, (q, k, v)), window=window,
                            softcap=softcap)
    got = flash_prefill_vjp(*map(torch.from_numpy, (q, k, v)), out, torch.from_numpy(dout),
                            window=window, softcap=softcap, q_chunk=q_chunk)
    want = _jax_k3_grads(q, k, v, dout, window, softcap)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and tuple(g.shape) == t.shape
        _close_f32(g.numpy(), w)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 4.0)])
def test_flash_prefill_vjp_bf16_matches_jax_grad(window, softcap):
    """bf16 q, k, v: both sides compute in fp32 from the bf16 inputs and
    round the grads to bf16 (the reference's ``flash_prefill_ref`` has
    the same rounding points; its model's ``_attend`` also rounds the
    softmax to bf16 before P·V, which this kernel's plain version does
    not)."""
    q, k, v, dout = _k3_inputs(2, 48, 4, 2, 32, seed=7)
    tq, tk, tv, td = map(_bf16, (q, k, v, dout))
    out = flash_prefill_ref(tq, tk, tv, window=window, softcap=softcap)
    got = flash_prefill_vjp(tq, tk, tv, out, td, window=window, softcap=softcap)
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, window=window, softcap=softcap),
                     as_jax(tq), as_jax(tk), as_jax(tv))
    want = vjp(as_jax(td))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **BF16)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 2.5)])
def test_flash_prefill_function_on_cpu(window, softcap):
    """``FlashPrefillFn`` with the plain forward in the kernel's place: the
    forward is the plain version's, the grads are autograd's through it;
    ``ops.flash_prefill`` on a CPU tensor is the plain version under plain
    autograd."""
    q, k, v, dout = _k3_inputs(2, 30, 4, 2, 16, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FlashPrefillFn.apply(*leaves, window, softcap, flash_prefill_ref)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out2 = flash_prefill(*plain, window=window, softcap=softcap)
    assert out2.grad_fn is not None
    assert torch.equal(out, out2)
    want = torch.autograd.grad(out2, plain, torch.from_numpy(dout))
    for g, w in zip(got, want):
        _close_f32(g.numpy(), w.numpy())


def test_flash_prefill_function_saves_the_recomputed_forward():
    """Under ``torch.utils.checkpoint`` the Function's forward runs twice
    (the forward, then the recompute in the backward) and the backward
    gives the grads of the run without it."""
    q, k, v, dout = _k3_inputs(1, 24, 4, 2, 16, seed=5)
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return flash_prefill_ref(*a, **kw)

    def block(a, b, c):
        return FlashPrefillFn.apply(a * 2.0, b, c, 0, 0.0, counting) * 0.5

    def grads(remat):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = (torch.utils.checkpoint.checkpoint(block, *leaves, use_reentrant=False)
               if remat else block(*leaves))
        return torch.autograd.grad(out, leaves, torch.from_numpy(dout))

    plain = grads(False)
    assert len(calls) == 1
    remat = grads(True)
    assert len(calls) == 3
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """With grad mode on, neither kernel wrapper takes an input that
    requires grad (its output would have none); without grad mode the
    same call reaches the device check."""
    q = torch.zeros((1, 8, 2, 64), requires_grad=True)
    k = v = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="require grad"):
        flash_prefill_cuda(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        flash_prefill_cuda(q, k, v)
    x = torch.zeros((1, 16, 2, 8))
    dt = torch.zeros((1, 16, 2), requires_grad=True)
    A, Bm = torch.zeros(2), torch.zeros((1, 16, 4))
    with pytest.raises(ValueError, match="require grad"):
        ssd_intra_chunk_cuda(x, dt, A, Bm, Bm, 16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        ssd_intra_chunk_cuda(x, dt, A, Bm, Bm, 16)
    assert flash_prefill_cuda.launches == 0 and ssd_intra_chunk_cuda.launches == 0


# ---------------------------------------------------------------------------
# K4: the SSD intra-chunk step, through the port's ssd_chunked
# ---------------------------------------------------------------------------
def _ssd_inputs(B, S, H, P, N, seed, decay):
    """``mild``: tests/test_kernels.py:137's distribution; ``strong``:
    mamba2's init (A = -linspace(1, 16), dt = softplus(N(0,1) + dt_bias)),
    whose chunk decays pass 88 at a chunk of 128."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    if decay == "mild":
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
        A = -np.exp(rng.standard_normal(H) * 0.5)
    else:
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + np.log(np.expm1(dt0))))
        A = -np.linspace(1.0, 16.0, H)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return (x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm), (wy, ws)


def _max_chunk_decay(dt, A, Q):
    B, S, H = dt.shape
    pad = (-S) % Q
    d = np.pad(-(dt * A), ((0, 0), (0, pad), (0, 0)))
    return float(d.reshape(B, -1, Q, H).sum(axis=2).max())


def _port_ssd_grads(inputs, weights, Q, monkeypatch):
    """Grads of Σ y·wy + Σ state·ws through the port's ``ssd_chunked``
    with the intra-chunk step through ``SsdIntraChunkFn`` (plain forward)."""
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk",
                        lambda *a: SsdIntraChunkFn.apply(*a, ssd_intra_chunk_ref))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, s = ssd_chunked(*leaves, chunk=Q)
    wy, ws = map(torch.from_numpy, weights)
    loss = (y * wy).sum() + (s * ws).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_ssd_grads(fn, inputs, weights):
    wy, ws = map(jnp.asarray, weights)

    def loss(*args):
        y, s = fn(*args)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, inputs))


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (1, 32, 4, 8, 8, 16), (2, 48, 4, 16, 16, 16), (1, 40, 8, 8, 16, 32)])
def test_ssd_grads_match_jax_grad_of_the_masked_formulation(B, S, H, P, N, Q, monkeypatch):
    """Below a chunk decay of 88, where the reference's gradient is finite:
    against ``jax.grad`` of ``ssd_chunked(use_kernel=False)``; S = 40 at a
    chunk of 32 pads its last chunk."""
    inputs, weights = _ssd_inputs(B, S, H, P, N, seed=S + H, decay="mild")
    assert _max_chunk_decay(inputs[1], inputs[2], Q) < 88.0   # the premise
    got = _port_ssd_grads(inputs, weights, Q, monkeypatch)
    want = _jax_ssd_grads(lambda *a: jax_model_chunked(*a, chunk=Q), inputs, weights)
    for g, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        _close_f32(g, w)


def test_ssd_grads_stay_finite_above_a_decay_of_88(monkeypatch):
    """ROADMAP Queue 3 entry 13's inputs: seed 11, B 1, S 128, Q 128, H 8,
    mamba2's decays. The reference's masked formulation gives NaN in its
    ``dt`` and ``A`` grads (the premise); the port's grads are finite and
    match ``jax.grad`` of the reference's sequential recurrence."""
    Q = 128
    inputs, weights = _ssd_inputs(1, 128, 8, 16, 16, seed=11, decay="strong")
    assert _max_chunk_decay(inputs[1], inputs[2], Q) > 88.0
    masked = _jax_ssd_grads(lambda *a: jax_model_chunked(*a, chunk=Q), inputs, weights)
    assert np.isnan(np.asarray(masked[1])).any() and np.isnan(np.asarray(masked[2])).any()
    got = _port_ssd_grads(inputs, weights, Q, monkeypatch)
    want = _jax_ssd_grads(jax_sequential, inputs, weights)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        _close_f32(g, w, rel=2e-3)     # chunked vs sequential (tests/test_kernels.py:165)


def test_ssd_vjp_takes_missing_output_grads():
    """Any of the three output grads may be ``None``: the missing ones
    count as zeros."""
    inputs, _ = _ssd_inputs(1, 32, 4, 8, 8, seed=2, decay="mild")
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in inputs)
    args = (x, dt, A, Bm[:, :, 0].contiguous(), Cm[:, :, 0].contiguous())
    outs = ssd_intra_chunk_ref(*args, 16)
    rng = np.random.default_rng(0)
    douts = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)) for o in outs]
    full = ssd_intra_chunk_vjp(*args, 16, *douts)
    parts = [ssd_intra_chunk_vjp(*args, 16, *[d if j == i else None for j, d in enumerate(douts)])
             for i in range(3)]
    for n, g in enumerate(full):
        assert g.dtype == args[n].dtype and g.shape == args[n].shape
        _close_f32(sum(p[n] for p in parts).numpy(), g.numpy(), rel=1e-5)
    assert all(torch.count_nonzero(g) == 0
               for g in ssd_intra_chunk_vjp(*args, 16, None, None, None))


# ---------------------------------------------------------------------------
# the MoE FFN repaired for autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_gate_and_dropless_products_equal_the_in_place_formulas(dtype):
    """The out-of-place gate equals the in-place chain it replaced, and the
    dropless path's per-expert products (``torch.cat`` over the spans)
    equal those written with ``out=`` into the expert-sorted rows."""
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32)).to(dtype)
            for _ in range(2))
    with torch.no_grad():
        yardstick = torch.exp(-a).add_(1).reciprocal_().mul_(a).mul_(b)
    assert torch.equal(moe.swiglu_gate(a, b), yardstick)

    cfg = get_smoke_config("granite_moe_1b_a400m")
    p = {k: v if k == "router" else v.to(dtype) for k, v in
         moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu").items()}
    x = torch.from_numpy(rng.standard_normal((40, cfg.d_model)).astype(np.float32)).to(dtype)
    y, aux = moe._dispatch_dropless(x, p, cfg)
    with torch.no_grad():   # the formulas of the serving-only path
        E, k = cfg.num_experts, cfg.top_k
        probs, weights, idx = moe.route(x, p["router"], k)
        order, _, _, counts = moe.capacity_slots(idx.reshape(1, -1), E, x.shape[0] * k)
        order, counts = order[0], counts[0]
        spans, start = [], 0
        for e, n in enumerate(counts.tolist()):
            if n:
                spans.append((e, slice(start, start + n)))
                start += n
        xs = x[order // k]
        ga = xs.new_empty((xs.shape[0], cfg.moe_d_ff))
        gb = torch.empty_like(ga)
        for e, rows in spans:
            torch.matmul(xs[rows], p["w_gate"][e], out=ga[rows])
            torch.matmul(xs[rows], p["w_up"][e], out=gb[rows])
        h = torch.exp(-ga).add_(1).reciprocal_().mul_(ga).mul_(gb)
        out = torch.empty_like(xs)
        for e, rows in spans:
            torch.matmul(h[rows], p["w_down"][e], out=out[rows])
        w_slot = weights.reshape(-1)[order].to(out.dtype)
        want = moe._combine(out * w_slot[:, None], order // k, k)
    assert torch.equal(y, want)


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_is_differentiable(dropless):
    """Both routings run backward and reach every expert weight that took
    rows, the router and the input."""
    cfg = get_smoke_config("granite_moe_1b_a400m")
    p = {k: v.float().requires_grad_() for k, v in
         moe.init_moe(torch.Generator().manual_seed(1), cfg, "cpu").items()}
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    with moe.dropless_moe(dropless):
        y, aux = moe.moe_apply(x, p, cfg)
    grads = torch.autograd.grad((y * y).sum() + aux, [x, *p.values()])
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


# ---------------------------------------------------------------------------
# Model.loss_fn and its gradients, every smoke configuration
# ---------------------------------------------------------------------------
def _batch(cfg, B=2, S=24, seed=0):
    """numpy tokens and labels (a few masked with -1); M-RoPE positions of
    text, a 2 x 3 image and text; whisper's frames."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    b["labels"][:, :3] = -1
    if cfg.rope_kind == "mrope":
        pos = image_positions(5, (2, 3), S - 11).numpy()
        b["positions"] = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))
    if cfg.encoder_layers:
        b["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """fp32 params converted from the reference's init, the same batch:
    the loss within 1e-5 relative, metrics equal, every gradient within the
    reference's own accumulation tolerance."""
    jcfg = jax_smoke(arch)
    jm = jax_build(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(jax.random.PRNGKey(0)))
    batch = _batch(jcfg, seed=len(arch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb), has_aux=True)(jparams)

    tm = build_model(get_smoke_config(arch)).load_params(
        jax.tree.map(np.asarray, jparams), device="cpu").trainable()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = tm.loss_fn(tb)
    names, leaves = zip(*_flat(tm.params()))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    assert math.isclose(float(loss), float(jloss), rel_tol=1e-5)
    assert float(met["tokens"]) == float(jmet["tokens"]) == batch["labels"].size - 6
    assert math.isclose(float(met["aux"]), float(jmet["aux"]), rel_tol=1e-5, abs_tol=1e-6)
    want = dict(_flat(jgrads))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        w = np.asarray(want[name])
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, **GRAD, err_msg=name)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_1p3b", "granite_moe_1b_a400m",
                                  "whisper_base"])
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """Recomputing each super-block in the backward, whole or all but its
    matmul outputs, changes no bit of the loss or the grads on the CPU."""
    cfg = get_smoke_config(arch)
    tm = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu").trainable()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=1).items()}
    if "frames" in batch:
        batch["frames"] = batch["frames"].to(torch.bfloat16)
    leaves = [v for _, v in _flat(tm.params())]
    runs = []
    for remat in (False, True, "dots"):
        loss, _ = tm.loss_fn(batch, remat=remat)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(batch, remat="offload")
