"""The port's training substrate (``repro_torch.training``) against the
reference's (``repro.training``) on the same inputs: ``lr_at`` under its
three schedules, ``adamw_update`` on identical trees in fp32 and bf16,
train steps from the same parameters and batch (with accumulation and
M-RoPE positions), the data pipeline bitwise, and checkpoints that either
package writes restoring in the other. Also the reference's own
optimizer, train-loop, data and checkpoint tests, run on the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.training import DataConfig as JaxDataConfig  # noqa: E402
from repro.training import SyntheticPackedDataset as JaxDataset  # noqa: E402
from repro.training import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.training import lr_at as jax_lr_at  # noqa: E402
from repro.training import make_eval_step as jax_make_eval_step  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.optimizer import adamw_update as jax_adamw_update  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import image_positions  # noqa: E402
from repro_torch.training import (AdamWConfig, Checkpointer, DataConfig,  # noqa: E402
                                  PrefetchLoader, SyntheticPackedDataset, adamw_update,
                                  init_opt_state, lr_at, make_eval_step, make_train_step)

GRAD = dict(atol=2e-5, rtol=2e-4)   # tests/test_training.py: grad accumulation
F32 = dict(atol=1e-7, rtol=1e-6)    # one fp32 op sequence, an ulp apart at most


def _flat(tree, prefix=""):
    for k in sorted(tree.keys()):
        v = tree[k]
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _np(x):
    """A tensor or jax array as numpy; bf16 as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _pair(arch, dtype=jnp.float32):
    """The reference's smoke model and params (cast to ``dtype``), and the
    port's model on the same params."""
    jm = jax_build(jax_smoke(arch))
    params = jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_smoke_config(arch)).load_params(
        jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tm


def _jax_opt_to_torch(state):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), state)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
class TestOptimizer:
    """tests/test_training.py::TestOptimizer, on the port."""

    def test_lr_schedule_shape(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        lrs = [float(lr_at(cfg, torch.tensor(s))) for s in range(100)]
        assert lrs[0] < lrs[9]                      # warmup rising
        assert abs(lrs[9] - 1.0) < 0.05             # peak ≈ lr
        assert lrs[50] > lrs[99]                    # decaying
        assert lrs[99] >= 0.1 - 1e-3                # floor

    def test_convergence_on_toy_problem(self):
        # AdamW must drive a quadratic to ~0
        cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, schedule="constant")
        params = {"w": torch.tensor([3.0, -2.0])}
        state = init_opt_state(params)
        for _ in range(150):
            w = params["w"].detach().requires_grad_()
            (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
            params, state, _ = adamw_update(cfg, params, {"w": g}, state)
        assert float(torch.sum(params["w"] ** 2)) < 1e-3

    def test_grad_clip(self):
        cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
        params = {"w": torch.zeros(4)}
        state = init_opt_state(params)
        g = {"w": torch.full((4,), 1e6)}
        p2, state, m = adamw_update(cfg, params, g, state)
        assert float(m["grad_norm"]) > 1e5
        assert np.all(np.abs(p2["w"].numpy()) < 1.0)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1, schedule=schedule)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    got = [float(lr_at(cfg, s)) for s in range(0, 130, 3)]
    want = [float(jax_lr_at(jcfg, jnp.asarray(s, jnp.int32))) for s in range(0, 130, 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_tree(rng, dtype):
    """Leaves of the shapes a model has: a matrix, a stacked (L, ...)
    weight, a stacked (L, d) norm scale and an unstacked (d,) one."""
    shapes = {"w": (16, 8), "stack": {"wq": (2, 8, 4), "norm": {"scale": (2, 8)}},
              "norm_f": {"scale": (8,)}}

    def draw(s):
        return {k: draw(v) for k, v in s.items()} if isinstance(s, dict) else \
            rng.standard_normal(s).astype(np.float32)
    params, grads = draw(shapes), draw(shapes)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    return jp, jax.tree.map(jnp.asarray, grads)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_adamw_update_matches_reference(dtype):
    """Three updates of the same tree, grads of the same values, from fresh
    state: params, m, v, step, grad norm and lr as the reference's. A bf16
    parameter may land one bf16 step away where the two fp32 updates
    straddle a rounding boundary."""
    rng = np.random.default_rng(0)
    jp, jg = _opt_tree(rng, dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jstate = jax_init_opt_state(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), jp)
    tg = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jg)
    tstate = init_opt_state(tp)
    for _ in range(3):
        jp, jstate, jm = jax_adamw_update(JaxAdamWConfig(**kw), jp, jg, jstate)
        tp, tstate, tm = adamw_update(AdamWConfig(**kw), tp, tg, tstate)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    for (name, a), (_, b) in zip(_flat(tp), _flat(jp)):
        assert a.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        tol = dict(atol=1e-7, rtol=2 ** -8) if dtype == jnp.bfloat16 else F32
        np.testing.assert_allclose(_f32(a), _f32(b), **tol, err_msg=name)
    for key in ("m", "v"):
        for (name, a), (_, b) in zip(_flat(tstate[key]), _flat(jstate[key])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-9, err_msg=name)


def test_weight_decay_reaches_stacked_norm_scales_as_in_the_reference():
    """The reference decays every leaf with ndim >= 2, so a stacked (L, d)
    norm scale is decayed and an unstacked (d,) one is not (ROADMAP Queue 3
    entry 14); the port keeps the rule."""
    tp = {"stack": {"norm": {"scale": torch.ones((2, 8))}}, "norm_f": {"scale": torch.ones(8)}}
    zero = jax.tree.map(torch.zeros_like, tp)
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5, schedule="constant")
    tp, _, _ = adamw_update(cfg, tp, zero, init_opt_state(tp))
    jp = {"stack": {"norm": {"scale": jnp.ones((2, 8))}}, "norm_f": {"scale": jnp.ones(8)}}
    jp, _, _ = jax_adamw_update(JaxAdamWConfig(**cfg.__dict__), jp,
                                jax.tree.map(jnp.zeros_like, jp), jax_init_opt_state(jp))
    assert torch.all(tp["stack"]["norm"]["scale"] < 1) and torch.all(tp["norm_f"]["scale"] == 1)
    np.testing.assert_array_equal(_f32(tp["stack"]["norm"]["scale"]),
                                  _f32(jp["stack"]["norm"]["scale"]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _lm_batch(cfg, B, S, seed, step=0):
    b = SyntheticPackedDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                          global_batch=B, seed=seed)).batch_at(step)
    if cfg.rope_kind == "mrope":
        pos = image_positions(4, (2, 2), S - 8).numpy()
        b["positions"] = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))
    return b


def _assert_stepped_params_close(got_tree, params, jstate, lr, where):
    """Params after an AdamW step against the reference's: the gradient
    tolerance, except where the gradient's RMS √v̂ lies in (0, 1e-6), held
    to |Δp| ≤ 2·lr (``test_train_steps_match_reference``)."""
    bc2 = 1.0 - 0.95 ** int(jstate["step"])
    ill = total = 0
    for (name, a), (_, b), (_, v) in zip(_flat(got_tree), _flat(params), _flat(jstate["v"])):
        got, want = _f32(a), _f32(b)
        rms = np.sqrt(_f32(v) / bc2)
        near_eps = (rms > 0) & (rms < 1e-6)     # no gradient at all: no doubt
        ill, total = ill + int(near_eps.sum()), total + near_eps.size
        assert np.all(np.abs(got - want)[near_eps] <= 2 * lr), f"{where} {name}"
        np.testing.assert_allclose(got[~near_eps], want[~near_eps], **GRAD,
                                   err_msg=f"{where} {name}")
    assert ill <= 2e-2 * total, (ill, total)


@pytest.mark.parametrize("arch,grad_accum", [("olmo_1b", 1), ("mamba2_1p3b", 1),
                                             ("granite_moe_1b_a400m", 1), ("qwen2_vl_7b", 2)])
def test_train_steps_match_reference(arch, grad_accum):
    """Three steps on fp32 params, each from the same params and optimizer
    state in both packages (the port's are reset to the reference's before
    each step; qwen2-vl with M-RoPE image positions, split (3, B, S) →
    (accum, 3, B/accum, S)): loss, grad norm and lr, then m, v and the
    params after the step.

    AdamW divides m̂ by √v̂ + eps. Where a gradient's RMS √v̂ is within 100×
    of eps (1e-8) but not 0, that quotient turns the gradients' fp32
    summation-order differences into a step of up to lr either way; those
    elements (0.2-1.2% of them here, the tail of small gradients; asserted
    under 2%) are held to |Δp| ≤ 2·lr, every other element to the gradient
    tolerance."""
    jm, params, tm = _pair(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**kw), grad_accum=grad_accum))
    tstep = make_train_step(tm, AdamWConfig(**kw), grad_accum=grad_accum)
    jstate = jax_init_opt_state(params)
    for i in range(3):
        tm.load_state(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params))
        tstate = _jax_opt_to_torch(jstate)
        batch = _lm_batch(jm.cfg, 4, 16, seed=5, step=i)
        params, jstate, jmet = jstep(params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=2e-5,
                                       err_msg=f"step {i} {key}")
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1
        for key in ("m", "v"):
            for (name, a), (_, b) in zip(_flat(tstate[key]), _flat(jstate[key])):
                w = _f32(b)
                np.testing.assert_allclose(_f32(a), w, rtol=2e-4,
                                           atol=2e-4 * float(np.abs(w).max()),
                                           err_msg=f"step {i} {key}.{name}")
        _assert_stepped_params_close(tm.params(), params, jstate, kw["lr"], f"step {i}")


def test_grad_accum_and_remat_match_the_full_batch():
    """tests/test_training.py::test_grad_accum_matches_full_batch on the
    port, and remat on against remat off: bitwise on the CPU."""
    _, params, _ = _pair("olmo_1b")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, grad_clip=0.0, weight_decay=0.0)
    batch = _lm_batch(get_smoke_config("olmo_1b"), 8, 16, seed=2)
    out = {}
    for accum, remat in ((1, False), (4, False), (1, True)):
        tm = build_model(get_smoke_config("olmo_1b")).load_params(
            jax.tree.map(np.asarray, params), device="cpu")
        step = make_train_step(tm, opt_cfg, grad_accum=accum, remat=remat)
        _, met = step(init_opt_state(tm.params()), batch)
        out[accum, remat] = (dict(_flat(tm.params())), float(met["loss"]))
    full, acc4, remat = out[1, False], out[4, False], out[1, True]
    for name, a in full[0].items():
        np.testing.assert_allclose(_f32(acc4[0][name]), _f32(a), **GRAD, err_msg=name)
        assert torch.equal(remat[0][name], a), name
    np.testing.assert_allclose(acc4[1], full[1], rtol=1e-6)
    assert remat[1] == full[1]


def test_loss_decreases_tiny_lm():
    """tests/test_training.py::test_loss_decreases_tiny_lm on the port."""
    cfg = get_smoke_config("olmo_1b")
    m = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60, weight_decay=0.0)
    step = make_train_step(m, opt_cfg)
    state = init_opt_state(m.params())
    ds = SyntheticPackedDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                           global_batch=8, seed=1))
    batch = ds.batch_at(0)  # overfit one batch
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert all(p.dtype == torch.bfloat16 for p in m.parameters() if p.dim() > 1)


def test_eval_step_matches_reference():
    jm, params, tm = _pair("yi_9b")
    batch = _lm_batch(jm.cfg, 2, 16, seed=9)
    want = jax_make_eval_step(jm)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(tm)(batch)
    assert not any(t.requires_grad for t in got.values())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(got["tokens"]) == float(want["tokens"])


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,vocab,S,B", [
    (0, 0, 1000, 64, 4), (1, 3, 128, 32, 8), (7, 11, 50304, 128, 2), (123, 2, 100, 16, 2)])
def test_batches_bitwise_equal_the_reference(seed, step, vocab, S, B):
    kw = dict(vocab_size=vocab, seq_len=S, global_batch=B, seed=seed)
    got = SyntheticPackedDataset(DataConfig(**kw)).batch_at(step)
    want = JaxDataset(JaxDataConfig(**kw)).batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


class TestData:
    """tests/test_training.py::TestData, on the port."""

    def test_determinism_across_restore(self):
        dc = DataConfig(vocab_size=1000, seq_len=64, global_batch=4, seed=7)
        it1 = iter(SyntheticPackedDataset(dc))
        _, b1 = next(it1), next(it1)
        ds2 = SyntheticPackedDataset(dc)
        ds2.restore({"seed": 7, "step": 1})
        np.testing.assert_array_equal(b1["tokens"], next(iter(ds2))["tokens"])

    def test_labels_are_shifted_tokens(self):
        dc = DataConfig(vocab_size=100, seq_len=32, global_batch=2, seed=0)
        b = SyntheticPackedDataset(dc).batch_at(0)
        assert b["tokens"].shape == b["labels"].shape == (2, 32)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_prefetch_and_straggler_skip(self):
        dc = DataConfig(vocab_size=100, seq_len=16, global_batch=2, seed=0)
        loader = PrefetchLoader(SyntheticPackedDataset(dc), depth=2, deadline_s=5.0)
        try:
            for _ in range(5):
                assert loader.next()["tokens"].shape == (2, 16)
        finally:
            loader.close()

    def test_straggler_is_synthesized_inline(self):
        """A batch that misses its deadline is built inline and counted."""
        ds = SyntheticPackedDataset(DataConfig(vocab_size=100, seq_len=16, global_batch=2))
        loader = PrefetchLoader(ds, depth=1, deadline_s=1e-9)
        loader._stop.set()          # the worker makes nothing more
        loader._thread.join(timeout=5)
        while not loader._q.empty():
            loader._q.get_nowait()
        try:
            step = ds.step
            b = loader.next()
            assert loader.stragglers_skipped == 1 and ds.step == step + 1
            np.testing.assert_array_equal(b["tokens"], ds.batch_at(step)["tokens"])
        finally:
            loader.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
class TestCheckpoint:
    """tests/test_training.py::TestCheckpoint, on the port."""

    def test_atomic_save_restore_roundtrip(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep_last=2)
        tree = {"a": torch.arange(6).reshape(2, 3),
                "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
                "e": {"f8": torch.tensor([0.5, -2.0, 448.0]).to(torch.float8_e4m3fn)}}
        ck.save(5, tree, extras={"rng": 123, "data_step": 17})
        step, restored, extras = ck.restore()
        assert step == 5 and extras["data_step"] == 17
        assert torch.equal(restored["a"], torch.arange(6).reshape(2, 3))
        assert restored["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert restored["e"]["f8"].dtype == torch.float8_e4m3fn
        assert torch.equal(restored["e"]["f8"].view(torch.uint8), tree["e"]["f8"].view(torch.uint8))

    def test_keep_last_pruning(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            ck.save(s, {"x": torch.ones(2)})
        assert ck.all_steps() == [3, 4]
        assert ck.latest_step() == 4

    def test_async_save(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep_last=3)
        x = torch.ones(8)
        ck.save_async(1, {"x": x})
        x.add_(1)       # the snapshot was taken before save_async returned
        ck.wait()
        assert ck.latest_step() == 1
        assert torch.equal(ck.restore()[1]["x"], torch.ones(8))

    def test_crash_mid_save_never_corrupts(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep_last=3)
        ck.save(1, {"x": torch.ones(2)})
        os.makedirs(str(tmp_path / "step_000000002.tmp" / "arrays"))
        step, _, _ = ck.restore()
        assert step == 1

    def test_training_resume_determinism(self, tmp_path):
        """Crash/restore must reproduce the uninterrupted run exactly."""
        cfg = get_smoke_config("olmo_1b")
        _, params, _ = _pair("olmo_1b")
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3)

        def run(n0, n1, restored=None):
            tm = build_model(cfg).load_params(jax.tree.map(np.asarray, params), device="cpu")
            state = init_opt_state(tm.params())
            if restored is not None:
                tm.load_state(restored["params"])
                state = restored["opt"]
            step_fn = make_train_step(tm, opt_cfg, remat=False)
            ds = SyntheticPackedDataset(dc)
            ds.restore({"seed": 3, "step": n0})
            for i in range(n0, n1):
                batch = ds.batch_at(i)
                ds.step = i + 1
                state, _ = step_fn(state, batch)
            return tm, state, ds.state()

        tA, _, _ = run(0, 6)
        tB, sB, dstate = run(0, 3)
        ck = Checkpointer(str(tmp_path))
        ck.save(3, {"params": tB.params(), "opt": sB}, extras={"data": dstate})
        _, restored, extras = ck.restore()
        tD, _, _ = run(extras["data"]["step"], 6, restored)
        for (name, a), (_, b) in zip(_flat(tA.params()), _flat(tD.params())):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_checkpoints_restore_across_the_packages(dtype, tmp_path):
    """The reference's checkpoint of {"params", "opt"} after one step
    restores in the port bitwise (tree, shapes, dtypes, bf16 words); the
    port's checkpoint of its state restores in the reference bitwise; and
    one step from the restored state matches the reference's next step."""
    jm, params, tm = _pair("olmo_1b", dtype)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, JaxAdamWConfig(**kw)))
    batches = [_lm_batch(jm.cfg, 4, 16, seed=4, step=i) for i in range(2)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    params, jstate, _ = jstep(params, jax_init_opt_state(params), jb[0])

    JaxCheckpointer(str(tmp_path / "ref")).save(1, {"params": params, "opt": jstate},
                                                 extras={"data": {"seed": 4, "step": 1}})
    step, restored, extras = Checkpointer(str(tmp_path / "ref")).restore()
    assert step == 1 and extras == {"data": {"seed": 4, "step": 1}}
    want = dict(_flat({"params": params, "opt": jstate}))
    got = dict(_flat(restored))
    assert set(got) == set(want)
    for name, w in want.items():
        assert _np(got[name]).dtype == _np(w).dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(_np(got[name]), _np(w), err_msg=name)

    tm.load_state(restored["params"])
    tstate = restored["opt"]
    Checkpointer(str(tmp_path / "port")).save(1, {"params": tm.params(), "opt": tstate},
                                              extras={"data": {"seed": 4, "step": 1}})
    step, back, extras = JaxCheckpointer(str(tmp_path / "port")).restore()
    assert step == 1 and extras == {"data": {"seed": 4, "step": 1}}
    back = dict(_flat(back))
    assert set(back) == set(want)
    for name, w in want.items():
        assert np.asarray(back[name]).dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(_np(back[name]), _np(w), err_msg=name)

    tstep = make_train_step(tm, AdamWConfig(**kw))
    tstate, tmet = tstep(tstate, batches[1])
    params, jstate, jmet = jstep(params, jstate, jb[1])
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    if dtype == jnp.float32:
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        _assert_stepped_params_close(tm.params(), params, jstate, kw["lr"], "step 2")
    else:   # bf16 activations round at other places in the two packages
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-2)
        for (name, a), (_, b) in zip(_flat(tm.params()), _flat(params)):
            np.testing.assert_allclose(_f32(a), _f32(b), atol=5e-2, rtol=5e-2, err_msg=name)


def test_load_state_refuses_another_tree():
    tm = build_model(get_smoke_config("olmo_1b")).init(torch.Generator().manual_seed(0), "cpu")
    tree = {k: dict(v) if isinstance(v, dict) else v for k, v in tm.params().items()}
    tree["embed"] = {"tok": tree["embed"]["tok"].float()}
    with pytest.raises(ValueError, match="embed.tok"):
        tm.load_state(tree)
    del tree["norm_f"]
    with pytest.raises(ValueError, match="norm_f"):
        tm.load_state(tree)
