"""The port's MoE FFN (``repro_torch.models.moe``) and the two MoE
families (granite-moe-1b-a400m, qwen3-moe-30b-a3b at smoke size) against
the reference on the same weights and inputs: ``moe_apply`` in capacity
and dropless mode, the padded last group, the exact set of slots dropped
under capacity, the aux loss, ``apply_stack_full``'s summed aux, whole
model prefill and decode, and fp32 decode against prefill under
``dropless_moe()``.

Inputs are drawn from numpy seeds; weights come from the reference's init
and reach the port through ``convert.params_from_numpy``. Tolerances: fp32
functions ``atol=rtol=1e-5``, fp32 aux ``1e-6``, the fp32 stack's output
``atol=1e-4, rtol=1e-5``, bf16 ``atol=rtol=5e-2``
(tests/test_kernels.py:30), fp32 decode chains ``1e-3``
(tests/test_arch_smoke.py:113).
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import array_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402

ARCHS = ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"]
FP32 = dict(atol=1e-5, rtol=1e-5)
AUX = dict(atol=1e-6, rtol=0)
# fp32 through two layers (attention and MoE), outputs of magnitude ~10
FP32_STACK = dict(atol=1e-4, rtol=1e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)   # tests/test_kernels.py:30
FP32_CHAIN = dict(atol=1e-3, rtol=0)   # tests/test_arch_smoke.py:113
DTYPES = {"float32": (jnp.float32, FP32), "bfloat16": (jnp.bfloat16, BF16)}


def _fp32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x,
                        tree)


def _moe_params(arch, dtype=jnp.float32, seed=0):
    """One MoE layer's reference params (router fp32, experts in
    ``dtype``), as numpy."""
    p, _ = jmoe.init_moe(jax.random.PRNGKey(seed), jax_smoke(arch))
    p = {k: v if k == "router" else v.astype(dtype) for k, v in p.items()}
    return jax.tree.map(np.asarray, p)


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, dtype))


def _both(arch, x, p, dropless, group_size=4096):
    """``moe_apply`` on both sides; returns ((y, aux) reference, port) as
    fp32 numpy."""
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    with jmoe.dropless_moe(dropless):
        yj, aj = jmoe.moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg_j,
                                group_size=group_size)
    with tmoe.dropless_moe(dropless):
        yt, at = tmoe.moe_apply(array_from_numpy(x, "cpu"), params_from_numpy(p, "cpu"),
                                cfg_t, group_size=group_size)
    assert yt.dtype == array_from_numpy(x, "cpu").dtype and at.dtype == torch.float32
    return ((np.asarray(yj.astype(jnp.float32)), float(aj)),
            (yt.float().numpy(), float(at)))


# -- configs and init --------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """Key paths, shapes and dtypes of the whole model: an MoE layer has
    ``norm_mlp`` and ``moe`` (router fp32, experts bf16) and no ``mlp``."""
    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if hasattr(v, "items"):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", (tuple(v.shape), str(v.dtype).replace("torch.", ""))

    want = dict(leaves(jax_build(jax_smoke(arch)).param_shapes()))
    tm = build_model(get_smoke_config(arch)).init(torch.Generator().manual_seed(0), "cpu")
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in tm.named_parameters()}
    assert got == want
    assert got["stack.pos0.moe.router"][1] == "float32"
    assert not any(".mlp." in n for n in got)


def test_moe_on_an_ssm_layer_builds_and_ignores_cross_attn():
    """An SSM layer with an MoE FFN (jamba's odd positions) builds: its
    ``ssm`` block, ``norm_mlp`` and ``moe``, no dense ``mlp``. Asked for
    cross-attention it builds the same tree, as the reference's
    ``init_layer`` does: only an attention layer gets ``cross``."""
    cfg = get_smoke_config("jamba_v01_52b")
    p = ttr.init_layer(torch.Generator().manual_seed(0), cfg,
                       LayerSpec(kind="ssm", moe=True), "cpu")
    assert set(p) == {"norm_in", "ssm", "norm_mlp", "moe"}
    assert p["moe"]["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    crossed = ttr.init_layer(torch.Generator().manual_seed(0), cfg,
                             LayerSpec(kind="ssm", moe=True, cross_attn=True), "cpu")
    assert set(crossed) == set(p)
    assert all(torch.equal(crossed["moe"][k], p["moe"][k]) for k in p["moe"])


# -- routing ---------------------------------------------------------------------
def test_route_breaks_ties_as_jax_top_k():
    """Equal probabilities go to the lower expert id first: a zero row's
    uniform probabilities pick experts 0..k-1, and a row with repeated
    values orders them as ``jax.lax.top_k`` does."""
    router = array_from_numpy(_x((16, 8), jnp.float32, seed=3), "cpu")
    x = torch.zeros((2, 16))
    _, w, idx = tmoe.route(x, router, 3)
    assert idx.tolist() == [[0, 1, 2]] * 2
    torch.testing.assert_close(w, torch.full((2, 3), 1 / 3))
    logits = np.array([[0.5, 2.0, 0.5, 2.0, 0.5, 1.0, 2.0, 0.5]], np.float32)
    eye = torch.eye(8)
    _, _, idx = tmoe.route(torch.from_numpy(logits), eye, 5)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), 5)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 3, 6, 5, 0]]


# -- moe_apply against the reference ------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_apply_matches_reference(arch, dropless, dtype):
    """(B, S) = (3, 40) in one group: at factor 1.25 a few slots drop."""
    jdt, tol = DTYPES[dtype]
    p = _moe_params(arch, jdt)
    x = _x((3, 40, 64), jdt)
    (yj, aj), (yt, at) = _both(arch, x, p, dropless)
    np.testing.assert_allclose(yt, yj, **tol)
    np.testing.assert_allclose(at, aj, **AUX)   # the router runs in fp32 on both sides


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_apply_padded_last_group_matches_reference(arch, dtype):
    """B·S = 20 tokens in groups of 16: the second group holds 4 tokens
    and 12 zero rows, whose uniform probabilities route them to experts
    0..k-1 on both sides; they take capacity from real tokens and count
    in the aux loss."""
    jdt, tol = DTYPES[dtype]
    p = _moe_params(arch, jdt)
    x = _x((2, 10, 64), jdt, seed=5)
    (yj, aj), (yt, at) = _both(arch, x, p, dropless=False, group_size=16)
    np.testing.assert_allclose(yt, yj, **tol)
    np.testing.assert_allclose(at, aj, **AUX)


def _tagging_params(arch, seed=0):
    """Expert e's down projection writes only output column e, so column
    e of ``y`` is nonzero exactly where a token's slot on expert e was
    kept (d_model 64 ≥ E 8)."""
    p = _moe_params(arch, jnp.float32, seed)
    E, Fd, D = p["w_down"].shape
    w = np.zeros((E, Fd, D), np.float32)
    for e in range(E):
        w[e, :, e] = 1.0
    return dict(p, w_down=w)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor,group_size,shape", [
    (1.25, 4096, (4, 32)), (0.5, 4096, (4, 32)), (0.5, 16, (2, 10)), (1.0, 8, (2, 8))])
def test_dropped_slots_equal_the_reference(arch, factor, group_size, shape):
    """The set of kept (token, expert) slots under capacity is the
    reference's exactly, read from which output columns are nonzero; it
    also equals what ``capacity_slots`` keeps. Every case drops slots (6 of
    256 at factor 1.25, half at 0.5); the group of 16 over 20 tokens pads,
    and groups of 8 give a capacity of 2."""
    p = _tagging_params(arch)
    cfg_j = replace(jax_smoke(arch), capacity_factor=factor)
    cfg_t = replace(get_smoke_config(arch), capacity_factor=factor)
    x = _x(shape + (64,), jnp.float32, seed=7)
    yj, _ = jmoe.moe_apply(jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg_j,
                           group_size=group_size)
    yt, _ = tmoe.moe_apply(array_from_numpy(x, "cpu"), params_from_numpy(p, "cpu"), cfg_t,
                           group_size=group_size)
    E, k = cfg_t.num_experts, cfg_t.top_k
    kept_j = np.asarray(yj).reshape(-1, 64)[:, :E] != 0
    kept_t = yt.reshape(-1, 64)[:, :E].numpy() != 0
    np.testing.assert_array_equal(kept_t, kept_j)

    # what capacity_slots keeps, mapped back to (token, expert)
    T = shape[0] * shape[1]
    G = min(group_size, T)
    ng = -(-T // G)
    xt = torch.nn.functional.pad(array_from_numpy(x, "cpu").reshape(T, 64), (0, 0, 0, ng * G - T))
    C = max(1, int(k * G / E * factor))
    _, _, idx = tmoe.route(xt.reshape(ng, G, 64), params_from_numpy(p, "cpu")["router"], k)
    order, _, keep, _ = tmoe.capacity_slots(idx.reshape(ng, G * k), E, C)
    kept = np.zeros((ng * G, E), bool)
    for g in range(ng):
        for s, kp in zip(order[g].tolist(), keep[g].tolist()):
            if kp:
                kept[g * G + s // k, int(idx.reshape(ng, G * k)[g, s])] = True
    np.testing.assert_array_equal(kept[:T], kept_j)
    assert kept_j.sum() < T * k      # every case drops slots


# -- the stack and the whole model --------------------------------------------------
def _pair(arch, fp32=False):
    jm = jax_build(jax_smoke(arch))
    params = jm.init(jax.random.PRNGKey(0))
    if fp32:
        params = _fp32(params)
    tm = build_model(get_smoke_config(arch)).load_params(jax.tree.map(np.asarray, params),
                                                         device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_apply_stack_full_sums_aux_as_reference(arch, dropless):
    """fp32 weights: the stack's output and its aux summed over the MoE
    layers (two here), against the reference's ``apply_stack_full``."""
    jm, params, tm = _pair(arch, fp32=True)
    cfg_j, cfg_t = jax_smoke(arch), tm.cfg
    x = _x((2, 24, 64), jnp.float32, seed=9)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    with jmoe.dropless_moe(dropless):
        xj, aj, _ = jtr.apply_stack_full(jnp.asarray(x), params["stack"], cfg_j,
                                         jnp.asarray(pos))
    with tmoe.dropless_moe(dropless):
        xt, at, cache = ttr.apply_stack_full(array_from_numpy(x, "cpu"), tm["stack"], cfg_t,
                                             torch.from_numpy(pos.copy()))
    assert cache is None and at.shape == () and at.dtype == torch.float32
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **FP32_STACK)
    np.testing.assert_allclose(float(at), float(aj), **AUX)
    # the sum of the layers' own losses, not one layer's
    assert float(at) > 1.5


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("fp32", [False, True], ids=["bf16", "fp32"])
def test_model_prefill_and_decode_match_reference(arch, dropless, fp32):
    """Prefill 2 x 12 tokens, then 6 decode steps, on both sides. Without
    ``dropless_moe()`` decode routes with capacity over a group of B = 2
    tokens (capacity 1 at top-2 of 8), so both sides drop the same slots."""
    jm, params, tm = _pair(arch, fp32=fp32)
    tol = FP32_CHAIN if fp32 else BF16
    toks = np.random.default_rng(2).integers(1, 128, size=(2, 18)).astype(np.int32)
    with jmoe.dropless_moe(dropless):
        lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :12])}, cache_len=18)
    with tmoe.dropless_moe(dropless):
        lt, ct = tm.prefill(torch.from_numpy(toks[:, :12]), cache_len=18)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj, np.float32), **tol)
    for t in range(12, 18):
        pos = np.full((2,), t, np.int32)
        with jmoe.dropless_moe(dropless):
            lj, cj = jm.decode_step(params, jnp.asarray(toks[:, t]), jnp.asarray(pos), cj)
        with tmoe.dropless_moe(dropless):
            lt, ct = tm.decode_step(torch.from_numpy(toks[:, t]), torch.from_numpy(pos), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj, np.float32), **tol,
                                   err_msg=f"decode step at position {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_decode_equals_prefill_under_dropless(arch):
    """The reference's rule (tests/test_arch_smoke.py:108-115) on the port
    alone: under ``dropless_moe()`` each decode step's logits equal a
    prefill of the prefix plus that token within 1e-3."""
    _, _, tm = _pair(arch, fp32=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, size=(2, 20)).astype(np.int32))
    with tmoe.dropless_moe():
        logits, cache = tm.prefill(toks[:, :10], cache_len=20)
        for t in range(10, 20):
            ref, _ = tm.prefill(toks[:, : t + 1])
            logits, cache = tm.decode_step(toks[:, t], torch.full((2,), t, dtype=torch.int32),
                                           cache)
            torch.testing.assert_close(logits, ref, **FP32_CHAIN)


def test_dropless_context_nests_and_resets():
    assert not tmoe._dropless.get()
    with tmoe.dropless_moe():
        assert tmoe._dropless.get()
        with tmoe.dropless_moe(False):
            assert not tmoe._dropless.get()
        assert tmoe._dropless.get()
    assert not tmoe._dropless.get()
