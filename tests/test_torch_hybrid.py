"""The port's hybrid family (jamba-v0.1-52b at smoke size: one super-block
of 8 layers, SSM at 0-3 and 5-7, attention without positions at 4, MoE
FFNs at the odd positions, dense FFNs at the even ones) against the
reference on the same weights and inputs: the config and parameter tree,
attention with ``rope_kind="none"`` (prefill and decode), an SSM layer
with a dense and with an MoE FFN (prefill and decode), the SSD scan at
the hybrid's shapes, ``Model.prefill`` logits and every cache leaf, 10
decode steps at 8 and 16 layers under capacity routing and
``dropless_moe()``, the slots capacity routing drops, the aux loss summed
over the MoE layers, and fp32 decode against prefill on the port alone.

Inputs are drawn from numpy seeds; weights come from the reference's init
and reach the port through ``convert.params_from_numpy``. Tolerances are
``tests/test_torch_moe.py``'s: fp32 layer outputs ``atol=1e-4,
rtol=1e-5``, fp32 aux ``1e-6``, fp32 outputs of a whole stack and decode
chains ``1e-3`` (tests/test_arch_smoke.py:113), bf16 ``atol=rtol=5e-2``
(tests/test_kernels.py:30). In bf16 the reference's MoE FFNs (expert
weights at std 1/√E) amplify any rounding past the bf16 tolerance, the
reference's own eager and compiled runs included: the single-layer bf16
cases keep the MoE FFN's input equal on both sides and assert that
premise, and the whole-model bf16 cases redraw the experts and hold the
model layer by layer (``torch_forcing``).
"""

from dataclasses import replace
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunked as jax_ops_chunked  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import array_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.models.model import check_ported  # noqa: E402
from test_torch_moe import _x  # noqa: E402
from torch_forcing import TorchSide, check_forced, expert_draws, forced, leaves  # noqa: E402

ARCH = "jamba_v01_52b"
FP32 = dict(atol=1e-4, rtol=1e-5)      # tests/test_torch_moe.py FP32_STACK
AUX = dict(atol=1e-6, rtol=0)
BF16 = dict(atol=5e-2, rtol=5e-2)      # tests/test_kernels.py:30
FP32_CHAIN = dict(atol=1e-3, rtol=0)   # tests/test_arch_smoke.py:113
SCAN = dict(atol=2e-3, rtol=2e-3)      # tests/test_kernels.py:165
DTYPES = {"float32": (jnp.float32, FP32), "bfloat16": (jnp.bfloat16, BF16)}
SSM_DENSE = LayerSpec(kind="ssm")
SSM_MOE = LayerSpec(kind="ssm", moe=True)
ATTN = LayerSpec(kind="attn")


def _cast(tree, dtype):
    """bf16 leaves in ``dtype`` (fp32 leaves, the router and the SSM's
    A_log/D/dt_bias, stay fp32), as numpy."""
    return jax.tree.map(lambda a: np.asarray(a.astype(dtype) if a.dtype == jnp.bfloat16
                                             else a), tree)


def _f32(a):
    return np.asarray(a, dtype=np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _cfgs(layers=8):
    return (replace(jax_smoke(ARCH), num_layers=layers),
            replace(get_smoke_config(ARCH), num_layers=layers))


# -- config and parameter tree ------------------------------------------------------
def test_config_block_pattern_and_tree_match_reference():
    """The published config and the smoke config equal the reference's, as
    do ``param_count()`` and the super-block; the port builds the
    reference's parameter tree (an SSM layer with ``mlp`` at the even SSM
    positions, with ``moe`` at the odd ones; attention at 4)."""
    for name in (ARCH, "jamba-v0.1-52b"):
        assert get_config(name).__dict__ == jax_config(name).__dict__
        assert get_config(name).param_count() == jax_config(name).param_count()
    cfg_j, cfg_t = _cfgs()
    assert cfg_t.__dict__ == cfg_j.__dict__
    check_ported(get_config(ARCH))
    pattern = cfg_t.block_pattern()
    assert [(s.kind, s.moe) for s in pattern] == [(s.kind, s.moe) for s in
                                                  cfg_j.block_pattern()]
    assert [s.kind for s in pattern] == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [s.moe for s in pattern] == [False, True] * 4

    def shapes(tree):
        return {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for n, v in leaves(tree)}

    want = shapes(jax_build(cfg_j).param_shapes())
    tm = build_model(cfg_t).init(torch.Generator().manual_seed(0), "cpu")
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in tm.named_parameters()}
    assert got == want
    for i, spec in enumerate(pattern):
        keys = set(tm["stack"][f"pos{i}"].keys())
        ffn = "moe" if spec.moe else "mlp"
        assert keys == {"norm_in", "norm_mlp", "attn" if spec.kind == "attn" else "ssm", ffn}


# -- attention without positions ------------------------------------------------------
@pytest.fixture(scope="module")
def attn_params():
    p, _ = jattn.init_attention(jax.random.PRNGKey(3), jax_smoke(ARCH))
    return _cast(p, jnp.float32)


def test_rope_none_passes_q_and_k_unchanged():
    cfg = get_smoke_config(ARCH)
    q, k = torch.randn(2, 5, 4, 16), torch.randn(2, 5, 2, 16)
    pos = torch.arange(5)[None].expand(2, 5)
    q2, k2 = tattn._rope_qk(q, k, pos, cfg, ATTN)
    assert q2 is q and k2 is k


def test_rope_none_prefill_matches_reference(attn_params):
    """Prefill through the flash-prefill path (its plain version on the
    CPU) with no rotation: output and cache against the reference's
    ``attention_full``."""
    cfg_j, cfg_t = _cfgs()
    x = _x((2, 21, 64), jnp.float32, seed=4)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32)[None], (2, 21))
    yj, cj = jattn.attention_full(jnp.asarray(x), jax.tree.map(jnp.asarray, attn_params),
                                  cfg_j, ATTN, jnp.asarray(pos), want_cache=True,
                                  cache_len=30)
    yt, ct = tattn.attention_full(torch.from_numpy(x), params_from_numpy(attn_params, "cpu"),
                                  cfg_t, ATTN, torch.from_numpy(pos.copy()),
                                  want_cache=True, cache_len=30)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(_f32(ct[name]), _f32(cj[name]), **FP32)


def test_rope_none_decode_matches_reference(attn_params):
    """Three decode steps into a prefilled cache, rows at different
    positions; with no rotation the output does not depend on where the
    cache's keys sit, only on which slots are valid."""
    cfg_j, cfg_t = _cfgs()
    x = _x((2, 9, 64), jnp.float32, seed=5)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None], (2, 9))
    pj = jax.tree.map(jnp.asarray, attn_params)
    pt = params_from_numpy(attn_params, "cpu")
    _, cj = jattn.attention_full(jnp.asarray(x), pj, cfg_j, ATTN, jnp.asarray(pos),
                                 want_cache=True, cache_len=16)
    _, ct = tattn.attention_full(torch.from_numpy(x), pt, cfg_t, ATTN,
                                 torch.from_numpy(pos.copy()), want_cache=True, cache_len=16)
    for step in range(3):
        xt = _x((2, 1, 64), jnp.float32, seed=10 + step)
        p = np.array([9 + step, 9 + step], np.int32)
        yj, cj = jattn.attention_decode(jnp.asarray(xt), pj, cfg_j, ATTN, cj, jnp.asarray(p))
        yt, ct = tattn.attention_decode(torch.from_numpy(xt), pt, cfg_t, ATTN, ct,
                                        torch.from_numpy(p))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(_f32(ct[name]), _f32(cj[name]), **FP32)


# -- an SSM layer with an FFN ----------------------------------------------------------
def _layer(spec, dtype, seed=2):
    """One layer's reference parameters (bf16 leaves in ``dtype``), numpy."""
    cfg_j, cfg_t = _cfgs()
    p, _ = jtr.init_layer(jax.random.PRNGKey(seed), cfg_j, spec)
    return cfg_j, cfg_t, _cast(p, dtype)


@pytest.mark.parametrize("spec", [SSM_DENSE, SSM_MOE], ids=["dense_ffn", "moe_ffn"])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_layer_with_ffn_matches_reference(spec, dropless, dtype):
    """``apply_layer_full`` over 37 tokens (two chunks of 16 and a padded
    third) and three ``apply_layer_decode`` steps from its cache, on both
    sides: output, aux (the MoE layer's own; ``None`` for the dense FFN)
    and the SSM cache.

    In bf16 the MoE layer's SSM output projection is zeroed, so both MoE
    FFNs see the same input: the reference's own bf16 SSM rounds apart
    between its eager and compiled runs, and its MoE FFN amplifies that
    past the bf16 tolerance (asserted by the next test). The SSM half in
    bf16 is held by the dense case."""
    jdt, tol = DTYPES[dtype]
    cfg_j, cfg_t, pj_np = _layer(spec, jdt)
    if spec.moe and dtype == "bfloat16":
        pj_np["ssm"]["out_proj"] = np.zeros_like(pj_np["ssm"]["out_proj"])
    pj, pt = jax.tree.map(jnp.asarray, pj_np), params_from_numpy(pj_np, "cpu")
    assert ("moe" in pt) == spec.moe and ("mlp" in pt) != spec.moe and "ssm" in pt
    x = _x((2, 37, 64), jdt, seed=6)
    pos = np.broadcast_to(np.arange(37, dtype=np.int32)[None], (2, 37))
    with jmoe.dropless_moe(dropless):
        xj, aj, cj = jtr.apply_layer_full(jnp.asarray(x), pj, cfg_j, spec, jnp.asarray(pos),
                                          want_cache=True, cache_len=40)
    with tmoe.dropless_moe(dropless):
        xt, at, ct = ttr.apply_layer_full(array_from_numpy(x, "cpu"), pt, cfg_t, spec,
                                          torch.from_numpy(pos.copy()), want_cache=True,
                                          cache_len=40)
    np.testing.assert_allclose(_f32(xt), _f32(xj), **tol)
    if spec.moe:
        np.testing.assert_allclose(float(at), float(aj), **AUX)
    else:
        assert at is None and float(aj) == 0.0
    for name in ("conv_x", "conv_B", "conv_C", "ssd"):
        np.testing.assert_allclose(_f32(ct["ssm"][name]), _f32(cj["ssm"][name]), **tol)
    for step in range(3):
        x1 = _x((2, 1, 64), jdt, seed=20 + step)
        with jmoe.dropless_moe(dropless):
            yj, cj = jtr.apply_layer_decode(jnp.asarray(x1), pj, cfg_j, spec, cj,
                                            jnp.full((2,), 37 + step, jnp.int32))
        with tmoe.dropless_moe(dropless):
            yt = ttr.apply_layer_decode(array_from_numpy(x1, "cpu"), pt, cfg_t, spec, ct,
                                        torch.full((2,), 37 + step, dtype=torch.int32))
        np.testing.assert_allclose(_f32(yt), _f32(yj), **tol,
                                   err_msg=f"decode step {step}")
    np.testing.assert_allclose(_f32(ct["ssm"]["ssd"]), _f32(cj["ssm"]["ssd"]), **tol)


def _beyond(got, want, tol):
    """Share of elements outside ``tol`` (numpy's allclose rule)."""
    got, want = _f32(got), _f32(want)
    return float((np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)).mean())


def test_bf16_moe_amplifies_the_references_own_ssm_rounding():
    """The premise of the bf16 cases that keep the MoE FFN's input equal on
    both sides: at the reference's init (expert weights at std 1/√E, so
    the MoE output reaches ~150 at smoke size) the reference's own SSM +
    MoE layer in bf16, run eagerly and compiled, differs past the bf16
    tolerance, while in fp32 the two runs agree."""
    spec = SSM_MOE
    cfg_j, _, p = _layer(spec, jnp.bfloat16)
    x = _x((2, 37, 64), jnp.bfloat16, seed=6)
    pos = jnp.broadcast_to(jnp.arange(37, dtype=jnp.int32)[None], (2, 37))
    spread = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        pd = jax.tree.map(lambda a, dt=dt: jnp.asarray(a.astype(dt) if a.dtype == jnp.bfloat16
                                                       else a), p)

        def layer(x, pd=pd):
            return jtr.apply_layer_full(x, pd, cfg_j, spec, pos)[0]

        xd = jnp.asarray(x, dt)
        spread[name] = (layer(xd), jax.jit(layer)(xd))
    assert _beyond(*spread["bf16"], BF16) > 0.01
    assert float(jnp.abs(spread["bf16"][1]).max()) > 100
    np.testing.assert_allclose(_f32(spread["fp32"][0]), _f32(spread["fp32"][1]), **FP32)


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_dropped_slots_on_an_ssm_layer_equal_the_reference(factor):
    """An SSM layer's MoE FFN under capacity routing keeps the reference's
    (token, expert) slots exactly. The SSM's output projection is zeroed,
    so the layer adds only the MoE output to its input, and expert e's
    down projection writes only output column e: column e of (output -
    input) is nonzero exactly where a token's slot on expert e was kept.
    Both factors drop slots over one group of 2 x 40 tokens."""
    cfg_j, cfg_t = (replace(c, capacity_factor=factor) for c in _cfgs())
    p, _ = jtr.init_layer(jax.random.PRNGKey(7), cfg_j, SSM_MOE)
    p = _cast(p, jnp.float32)
    p["ssm"]["out_proj"] = np.zeros_like(p["ssm"]["out_proj"])
    E, Fd, D = p["moe"]["w_down"].shape
    w = np.zeros((E, Fd, D), np.float32)
    for e in range(E):
        w[e, :, e] = 1.0
    p["moe"]["w_down"] = w
    x = _x((2, 40, 64), jnp.float32, seed=8)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32)[None], (2, 40))
    xj, _, _ = jtr.apply_layer_full(jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg_j,
                                    SSM_MOE, jnp.asarray(pos))
    xt, _, _ = ttr.apply_layer_full(torch.from_numpy(x), params_from_numpy(p, "cpu"), cfg_t,
                                    SSM_MOE, torch.from_numpy(pos.copy()))
    kept_j = (np.asarray(xj) - x).reshape(-1, D)[:, :E] != 0
    kept_t = (xt.numpy() - x).reshape(-1, D)[:, :E] != 0
    np.testing.assert_array_equal(kept_t, kept_j)
    k = cfg_t.top_k
    assert kept_j.sum(-1).max() <= k and kept_j.sum() < 80 * k     # slots dropped


# -- the SSD scan at the hybrid's shapes ---------------------------------------------
def _jamba_ssd_inputs(B, S, H, P, N, seed):
    """The hybrid's SSM init: A = -linspace(1, 16, H), dt = softplus(N(0,1)
    + dt_bias) with dt_bias drawn as ``init_ssm`` draws it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + np.log(np.expm1(dt0))))
    A = -np.linspace(1.0, 16.0, H)
    return x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm


def _max_chunk_decay(dt, A, Q):
    B, S, H = dt.shape
    return float((-(dt * A)).reshape(B, S // Q, Q, H).sum(axis=2).max())


@pytest.mark.parametrize("shape,interpret", [
    ((2, 48, 8, 16, 8, 16), True),        # smoke: H 8, P 16, N 8, chunk 16
    ((1, 256, 128, 64, 16, 128), False),  # published: H 128, P 64, N 16, chunk 128
], ids=["smoke", "published"])
def test_ssd_scan_at_hybrid_shapes_matches_reference(shape, interpret):
    """At smoke size every chunk's summed decay stays under 88, so the
    reference's Pallas kernel (interpret mode) is finite and the port is
    held to it. At the published heads and chunk the decay passes 88
    (ROADMAP Queue 3 entry 1), so the port is held to the reference's
    masked formulation (``use_kernel=False``) instead."""
    B, S, H, P, N, Q = shape
    inputs = _jamba_ssd_inputs(B, S, H, P, N, seed=S + H)
    decay = _max_chunk_decay(inputs[1], inputs[2], Q)
    assert (decay < 88.0) if interpret else (decay > 88.0)
    y, s = ssd_chunked(*(torch.from_numpy(a) for a in inputs), chunk=Q)
    j = [jnp.asarray(a) for a in inputs]
    if interpret:
        yj, sj = jax_ops_chunked(*j, chunk=Q, backend="interpret")
    else:
        yj, sj = jssm.ssd_chunked(*j, chunk=Q, use_kernel=False)
    assert np.isfinite(y.numpy()).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **SCAN)


# -- the stack and the whole model --------------------------------------------------
def _pair(layers=8, fp32=False):
    cfg_j, cfg_t = _cfgs(layers)
    jm = jax_build(cfg_j)
    params = jm.init(jax.random.PRNGKey(0))
    if fp32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                              else a, params)
    tm = build_model(cfg_t).load_params(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_apply_stack_full_sums_aux_over_the_moe_layers(dropless):
    """fp32 weights, one super-block (4 MoE layers): the stack's output and
    its aux against the reference's ``apply_stack_full``, and the aux
    equal to the sum of the port's MoE layers' own losses. The output, of
    magnitude ~150 after four MoE FFNs, is held at the whole-model fp32
    tolerance."""
    jm, params, tm = _pair(fp32=True)
    cfg_t = tm.cfg
    x = _x((2, 24, 64), jnp.float32, seed=9)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    with jmoe.dropless_moe(dropless):
        xj, aj, _ = jtr.apply_stack_full(jnp.asarray(x), params["stack"], jm.cfg,
                                         jnp.asarray(pos))
    with tmoe.dropless_moe(dropless):
        xt, at, cache = ttr.apply_stack_full(torch.from_numpy(x), tm["stack"], cfg_t,
                                             torch.from_numpy(pos.copy()))
        h, layer_aux = torch.from_numpy(x), []
        for i, spec in enumerate(cfg_t.block_pattern()):
            h, a, _ = ttr.apply_layer_full(h, ttr.tree_index(tm["stack"][f"pos{i}"], 0),
                                           cfg_t, spec, torch.from_numpy(pos.copy()))
            assert (a is not None) == spec.moe
            if a is not None:
                layer_aux.append(float(a))
    assert cache is None and at.shape == () and at.dtype == torch.float32
    assert len(layer_aux) == 4
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **FP32_CHAIN)
    np.testing.assert_allclose(float(at), float(aj), **AUX)
    np.testing.assert_allclose(float(at), sum(layer_aux), **AUX)


def _run_both(jm, params, tm, dropless, toks, t0=20):
    """Prefill ``toks[:, :t0]`` then decode the rest on both sides; yields
    (step, reference logits, port logits, reference cache, port cache).
    The reference's steps are compiled once, inside the routing mode (the
    mode is read while tracing; fresh lambdas share no trace)."""
    n = toks.shape[1]
    with jmoe.dropless_moe(dropless):
        prefill = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=n))
        decode = jax.jit(lambda p, t, pos, c: jm.decode_step(p, t, pos, c))
        lj, cj = prefill(params, jnp.asarray(toks[:, :t0]))
    with tmoe.dropless_moe(dropless):
        lt, ct = tm.prefill(torch.from_numpy(toks[:, :t0]), cache_len=n)
    yield "prefill", lj, lt, cj, ct
    for t in range(t0, n):
        pos = np.full((toks.shape[0],), t, np.int32)
        with jmoe.dropless_moe(dropless):
            lj, cj = decode(params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        with tmoe.dropless_moe(dropless):
            lt, ct = tm.decode_step(torch.from_numpy(toks[:, t]), torch.from_numpy(pos), ct)
        yield f"decode at {t}", lj, lt, cj, ct


def _assert_caches_close(ct, cj, tol):
    leaves_t, leaves_j = dict(leaves(ct)), dict(leaves(cj))
    assert leaves_t.keys() == leaves_j.keys()
    for name, leaf in leaves_t.items():
        want = leaves_j[name]
        assert tuple(leaf.shape) == want.shape, name
        if name.endswith(".pos"):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want), err_msg=name)
        else:
            np.testing.assert_allclose(_f32(leaf), _f32(want), **tol, err_msg=name)


@pytest.mark.parametrize("layers", [8, 16])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_model_prefill_caches_and_decode_match_reference(layers, dropless):
    """fp32 weights: prefill 2 x 20 tokens (two SSD chunks of 16, the second
    padded), then 10 decode steps, on both sides: the logits at every step,
    and every cache leaf (the attention layers' K, V and slot positions;
    the SSM layers' conv tails and SSD state) after the prefill and after
    the last step. Without ``dropless_moe()`` decode routes with capacity
    over a group of B = 2 tokens (capacity 1 at top-2 of 4), so both sides
    drop the same slots."""
    jm, params, tm = _pair(layers, fp32=True)
    toks = np.random.default_rng(2).integers(1, 128, size=(2, 30)).astype(np.int32)
    for step, lj, lt, cj, ct in _run_both(jm, params, tm, dropless, toks):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj, np.float32), **FP32_CHAIN,
                                   err_msg=step)
        if step == "prefill":
            _assert_caches_close(ct, cj, FP32_CHAIN)
            assert {n: tuple(v.shape) for n, v in leaves(ct)} == \
                {n: tuple(v.shape) for n, v in leaves(tm.empty_cache(2, 30))}
    _assert_caches_close(ct, cj, FP32_CHAIN)


class _JaxSide:
    """The reference's model as the leading side of ``torch_forcing.forced``:
    each layer compiled on its own."""

    def __init__(self, jm, params, dropless):
        cfg = self.cfg = jm.cfg
        self.dropless = dropless
        self.p = jax.tree.map(jnp.asarray, params)
        pattern = cfg.block_pattern()
        blocks = range(cfg.num_layers // len(pattern))
        self.specs = [s for _ in blocks for s in pattern]
        self.params = [jax.tree.map(lambda a, b=b: a[b], self.p["stack"][f"pos{i}"])
                       for b in blocks for i in range(len(pattern))]
        self._full = {}
        self._decode = {s: jax.jit(partial(jtr.apply_layer_decode, cfg=cfg, spec=s))
                        for s in set(self.specs)}
        self._router, self._head = jax.jit(self._router_fn), jax.jit(self._head_fn)

    def routing(self, dropless):
        assert dropless == self.dropless      # read while the layers are traced
        return jmoe.dropless_moe(dropless)

    def embed(self, toks):
        return jl.embed_tokens(jnp.asarray(toks), self.p["embed"], self.cfg.embed_scale,
                               self.cfg.d_model)

    def full(self, L, x, pos, cache_len):
        key = (self.specs[L], cache_len)
        if key not in self._full:
            self._full[key] = jax.jit(partial(jtr.apply_layer_full, cfg=self.cfg, spec=key[0],
                                              want_cache=True, cache_len=cache_len))
        y, _, cache = self._full[key](x, self.params[L], positions=jnp.asarray(pos))
        return y, cache

    def decode(self, L, x, cache, pos):
        return self._decode[self.specs[L]](x, self.params[L], cache=cache, pos=jnp.asarray(pos))

    def _router_fn(self, x, p, state):
        cfg = self.cfg
        h = jl.apply_norm(x, p["norm_in"], cfg.norm_kind, cfg.norm_eps)
        a = (jssm.ssm_forward(h, p["ssm"], cfg) if state is None
             else jssm.ssm_decode_step(h, p["ssm"], cfg, state))[0]
        h = jl.apply_norm(x + a, p["norm_mlp"], cfg.norm_kind, cfg.norm_eps)
        logits = h.reshape(-1, h.shape[-1]).astype(jnp.float32) @ p["moe"]["router"]
        return logits, jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]

    def router(self, L, x, state=None):
        return tuple(np.asarray(a) for a in self._router(x, self.params[L], state))

    def _head_fn(self, x):
        cfg = self.cfg
        x = jl.apply_norm(x, self.p.get("norm_f"), cfg.norm_kind, cfg.norm_eps)
        return jl.unembed(x, self.p["embed"])[:, 0].astype(jnp.float32)

    def head(self, x):
        return self._head(x)

    @staticmethod
    def record(a):
        return np.asarray(a, np.float32), str(a.dtype)


@pytest.mark.parametrize("layers", [8, 16])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_bf16_model_prefill_and_decode_against_reference(layers, dropless):
    """bf16 weights with the experts redrawn at std 1/√fan-in
    (``torch_forcing.expert_draws``, the same numpy arrays on both sides),
    the fp32 test's tokens, prefill and 10 decode steps. Held at the bf16
    tolerance layer by layer, the port's layers on the reference's inputs
    (``torch_forcing.forced``): every layer's output, every leaf of its
    cache (slot positions exactly) at the prefill and after every step,
    and the logits at every step; at the MoE layers a token the two
    routers keep on different experts is exempt, and only on a near-tie.
    The port's own chain through ``Model.prefill``/``decode_step``: every
    cache's paths, shapes, dtypes and slot positions exactly, finite
    logits at every step. The two whole chains are not held elementwise
    against each other: the reference's whole-model compiled run and its
    layer-by-layer run (the same weights, the same inputs) already differ
    past the bf16 tolerance, as asserted here."""
    jm, params, tm = _pair(layers)
    params = jax.tree.map(np.asarray, params)
    for pos, draws in expert_draws(jm.cfg).items():
        for name, w in draws.items():
            params["stack"][pos]["moe"][name] = np.asarray(jnp.asarray(w, jnp.bfloat16))
    tm.load_params(params, device="cpu")
    toks = np.random.default_rng(2).integers(1, 128, size=(2, 30)).astype(np.int32)
    rows, ties = forced(_JaxSide(jm, params, dropless), TorchSide(tm), toks, 20, dropless)
    check_forced(rows, ties, BF16)
    by_layer = {what: want for what, (want, _), _, _ in rows}
    spread = 0.0
    for step, lj, lt, cj, ct in _run_both(jm, jax.tree.map(jnp.asarray, params), tm,
                                          dropless, toks):
        assert lt.dtype == torch.float32 and torch.isfinite(lt).all(), step
        spec = {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for n, v in leaves(ct)}
        assert spec == {n: (tuple(v.shape), str(v.dtype)) for n, v in leaves(cj)}, step
        assert spec["pos0.ssm.conv_x"][1] == "bfloat16" and spec["pos0.ssm.ssd"][1] == "float32"
        np.testing.assert_array_equal(ct["pos4"]["self"]["pos"].numpy(),
                                      np.asarray(cj["pos4"]["self"]["pos"]), err_msg=step)
        spread = max(spread, _beyond(lj, by_layer[f"{step} logits"], BF16))
    assert spread > 0.05       # the reference's own two runs, past the bf16 tolerance


def test_empty_cache_matches_reference():
    """The dense decode cache of 16 layers: the reference's leaf paths,
    shapes and dtypes (KV (L, B, T, Hkv, D) at the attention position,
    conv tails (L, B, K-1, C) and SSD state (L, B, H, N, P) elsewhere)."""
    cfg_j, cfg_t = _cfgs(16)
    want = {n: (tuple(v.shape), str(v.dtype))
            for n, v in leaves(jtr.empty_stack_cache(cfg_j, 3, 12))}
    got = {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for n, v in leaves(ttr.empty_stack_cache(cfg_t, 3, 12, device="cpu"))}
    assert got == want
    assert got["pos4.self.k"] == ((2, 3, 12, 2, 16), "bfloat16")
    assert got["pos0.ssm.conv_x"] == ((2, 3, 3, 128), "bfloat16")
    assert got["pos7.ssm.ssd"] == ((2, 3, 8, 8, 16), "float32")


@pytest.mark.parametrize("layers", [8, 16])
def test_fp32_decode_equals_prefill_under_dropless(layers):
    """The reference's rule (tests/test_arch_smoke.py:108-115) on the port
    alone: under ``dropless_moe()`` each decode step's logits equal a
    prefill of the prefix plus that token within 1e-3."""
    _, _, tm = _pair(layers, fp32=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, size=(2, 30)).astype(np.int32))
    with tmoe.dropless_moe():
        logits, cache = tm.prefill(toks[:, :20], cache_len=30)
        for t in range(20, 30):
            ref, _ = tm.prefill(toks[:, : t + 1])
            logits, cache = tm.decode_step(toks[:, t], torch.full((2,), t, dtype=torch.int32),
                                           cache)
            torch.testing.assert_close(logits, ref, **FP32_CHAIN)
