"""The port's sharded train step and elastic checkpoints on 8 gloo CPU
ranks, against the port's and the reference's single-device steps and
the reference's own sharded step: the scenarios of
``tests/test_distribution.py:41-123`` (yi_9b smoke in fp32, B 8, S 32,
``AdamWConfig(lr=1e-3, warmup_steps=0)``, remat off, a (2, 2, 2)
pod/data/model mesh; olmo_1b smoke saved from a (4, 2) data/model mesh
and restored onto (2, 2, 2)), with ZeRO-1 moments, qwen3_moe smoke
(experts over the model axis, token groups over the DP axes) and mamba2
smoke (SSD heads over the model axis); and K3 on local query heads
whose K/V heads cannot follow the model axis.

One launch of 8 ranks (``torch_dist.run_ranks``) runs every scenario;
the reference's sharded step runs beside it in a subprocess with 8 host
devices and ``Auto`` mesh axes (ROADMAP Queue 3 entry 16)."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_dist import ROOT, full_numpy, moe_groups, run_ranks  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.training import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step  # noqa: E402

B, S = 8, 32
LOSS_RTOL = 1e-4
PARAMS = dict(atol=3e-4, rtol=3e-3)          # tests/test_distribution.py:86-89
GQA = dict(atol=1e-5, rtol=1e-5)
# a gradient against its max |g|: the ranks' partial sums add the same
# fp32 terms in another order, so an entry near 0 moves by ~1e-7·max|g|
GQA_GRAD_OF_MAX = 1e-5
RANKS_TIMEOUT_S = 300
REFERENCE_TIMEOUT_S = 300

TRAIN = {   # name: (arch, ZeRO-1 moments, MoE group size)
    "yi_9b": ("yi_9b", False, None),
    "yi_9b_zero": ("yi_9b", True, None),
    "qwen3_moe": ("qwen3_moe_30b_a3b", False, 64),   # 256 tokens → 4 groups of 64
    "mamba2": ("mamba2_1p3b", False, None),
}
GQA_CASES = {"heads4_kv1": (4, 1), "heads6_kv3": (6, 3)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_params(arch, dtype=jnp.float32):
    jm = jax_build(jax_smoke(arch))
    return jm, jax.tree.map(lambda a: a.astype(dtype), jm.init(jax.random.PRNGKey(0)))


def _batch(vocab):
    """The reference scenario's batch (tests/test_distribution.py:62-67)."""
    return {"tokens": np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, vocab),
                               np.int32),
            "labels": np.array(jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, vocab),
                               np.int32)}


def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


REFERENCE_SHARDED = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.sharding import use_rules
from repro.training import AdamWConfig, init_opt_state, make_train_step
from repro.launch.sharding import rules_for, sharding_tree
from repro.models.config import ShapeConfig

cfg = get_smoke_config("yi_9b")
m = build_model(cfg)
params = jax.tree.map(lambda x: x.astype(jnp.float32), m.init(jax.random.PRNGKey(0)))
B, S = 8, 32
batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size),
         "labels": jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab_size)}
step = make_train_step(m, AdamWConfig(lr=1e-3, warmup_steps=0), remat=False)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
rules = rules_for(cfg, ShapeConfig("t", S, B, "train"), mesh)
p_sh = sharding_tree(m.axes(), rules, mesh)
params_s = jax.device_put(params, p_sh)
with use_rules(rules, mesh):
    p_out, _, met = jax.jit(step, in_shardings=(p_sh, None, None))(
        params_s, init_opt_state(params_s), batch)
leaves = jax.tree_util.tree_flatten_with_path(p_out)[0]
flat = {".".join(str(k.key) for k in path): np.asarray(v, np.float32) for path, v in leaves}
np.savez(sys.argv[1], **flat)
print("LOSS", float(met["loss"]), len(jax.devices()))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario's inputs, the 8 ranks' results and the reference's
    sharded step; the port's single-device steps on the same inputs."""
    wd = tmp_path_factory.mktemp("sharded")
    ref_out = wd / "reference_sharded.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref_proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE_SHARDED),
                                 str(ref_out)], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        inputs = {"train": {}, "gqa": {}}
        for name, (arch, zero, group_size) in TRAIN.items():
            _, params = _reference_params(arch)
            inputs["train"][name] = {
                "arch": arch, "zero": zero, "group_size": group_size,
                "params": params_from_numpy(_np_tree(params), "cpu"),
                "batch": _batch(get_smoke_config(arch).vocab_size)}
        rng = np.random.default_rng(7)
        for name, (H, Hkv) in GQA_CASES.items():
            d, Dh = 64, 16
            inputs["gqa"][name] = {
                "heads": H, "kv_heads": Hkv,
                "x": rng.standard_normal((B, S, d), dtype=np.float32),
                "params": {k: (rng.standard_normal(shape, dtype=np.float32) / 8)
                           for k, shape in (("wq", (d, H, Dh)), ("wk", (d, Hkv, Dh)),
                                            ("wv", (d, Hkv, Dh)), ("wo", (H, Dh, d)))}}
        _, olmo = _reference_params("olmo_1b", jnp.bfloat16)
        JaxCheckpointer(str(wd / "reference_ckpt")).save(1, olmo)
        inputs["elastic"] = {"arch": "olmo_1b", "dir": str(wd / "port_ckpt"),
                             "reference_dir": str(wd / "reference_ckpt"),
                             "params": params_from_numpy(_np_tree(olmo), "cpu"),
                             "expect": _flat_np(_np_tree(olmo))}
        torch.save(inputs, wd / "inputs.pt")
        result = run_ranks("sharded", 8, wd, timeout=RANKS_TIMEOUT_S)
        out, err = ref_proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, err[-3000:]
    loss_line = [ln for ln in out.splitlines() if ln.startswith("LOSS")][-1].split()
    reference_sharded = {"loss": float(loss_line[1]), "devices": int(loss_line[2]),
                         "params": dict(np.load(ref_out))}
    return inputs, result, reference_sharded


_SINGLE = {}


def _port_single(inputs, name):
    """The port's single-device step on the case's inputs (no rules)."""
    if name not in _SINGLE:
        case = inputs["train"][name]
        tm = build_model(get_smoke_config(case["arch"])).install(
            {k: v for k, v in _clone(case["params"]).items()})
        step = make_train_step(tm, AdamWConfig(lr=1e-3, warmup_steps=0), remat=False)
        with moe_groups(case["group_size"]):
            _, met = step(init_opt_state(tm.params()), case["batch"])
        _SINGLE[name] = (float(met["loss"]), full_numpy(tm.params()))
    return _SINGLE[name]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _assert_params_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}: {k}", **PARAMS)


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_step_matches_the_port_single_device_step(runs, name):
    inputs, result, _ = runs
    got = result["train"][name]
    loss, params = _port_single(inputs, name)
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    _assert_params_close(got["params"], params, name)


@pytest.mark.parametrize("name", ["yi_9b", "yi_9b_zero"])
def test_sharded_step_matches_the_reference_single_device_step(runs, name):
    inputs, result, _ = runs
    jm, params = _reference_params("yi_9b")
    step = jax_make_train_step(jm, JaxAdamWConfig(lr=1e-3, warmup_steps=0), remat=False)
    batch = inputs["train"][name]["batch"]
    p_ref, _, m_ref = jax.jit(step)(params, jax_init_opt_state(params),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    got = result["train"][name]
    np.testing.assert_allclose(got["loss"], float(m_ref["loss"]), rtol=LOSS_RTOL)
    _assert_params_close(got["params"], _flat_np(_np_tree(p_ref)), name)


def test_sharded_step_matches_the_reference_sharded_step(runs):
    _, result, reference = runs
    assert reference["devices"] == 8
    got = result["train"]["yi_9b"]
    np.testing.assert_allclose(got["loss"], reference["loss"], rtol=LOSS_RTOL)
    _assert_params_close(got["params"], reference["params"], "reference sharded")


def test_the_sharded_steps_ran_under_their_rules(runs):
    """The rules took the axes the scenarios are about: heads and kv_heads
    on the model axis for yi_9b, experts (and token groups on the DP axes)
    for qwen3_moe, SSD heads for mamba2; ZeRO-1 moments carry the DP axes."""
    _, result, _ = runs
    train = result["train"]
    assert train["yi_9b"]["rules"]["heads"] == "model"
    assert train["yi_9b"]["rules"]["kv_heads"] == "model"
    assert train["yi_9b"]["rules"]["batch"] == ("pod", "data")
    assert train["qwen3_moe"]["rules"]["expert"] == "model"
    assert train["mamba2"]["rules"]["ssm_heads"] == "model"
    assert all(r["redistributes"] > 0 for r in train.values())
    plain = train["yi_9b"]["moment_placements"]
    zero = train["yi_9b_zero"]["moment_placements"]
    assert not any("Shard" in p.split(",")[0] for p in plain)
    assert any(p.startswith("(Shard(dim=") and p.count("Shard") >= 2 for p in zero)
    for k in ("m", "v"):   # the same moments, whatever their layout
        _assert_params_close(train["yi_9b_zero"]["moments"][k], train["yi_9b"]["moments"][k],
                             f"ZeRO-1 {k}")


@pytest.mark.parametrize("name", list(GQA_CASES))
def test_k3_on_local_query_heads_reads_their_own_kv_heads(runs, name):
    """q's heads sharded over the model axis, K/V's replicated (kv_heads do
    not divide it): the attention and its gradients equal the unsharded
    ones."""
    inputs, result, _ = runs
    case, got = inputs["gqa"][name], result["gqa"][name]
    assert got["rules"]["heads"] == "model" and got["rules"]["kv_heads"] is None
    assert got["paths"]["flash_prefill"] == 1
    from dataclasses import replace

    cfg = replace(get_smoke_config("yi_9b"), num_heads=case["heads"],
                  num_kv_heads=case["kv_heads"])
    x = torch.from_numpy(case["x"]).requires_grad_()
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in case["params"].items()}
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    y, _ = attention.attention_full(x, p, cfg, LayerSpec(kind="attn"), pos)
    grads = torch.autograd.grad((y.float() ** 2).sum(), [x, *p.values()])
    np.testing.assert_allclose(got["y"], y.detach().numpy(), **GQA)
    for k, g, want in zip(["x", *p], [got["dx"], *got["dparams"].values()], grads):
        want = want.numpy()
        err = float(np.abs(g - want).max() / np.abs(want).max())
        assert err <= GQA_GRAD_OF_MAX, (k, err)


def test_elastic_restore_across_meshes_is_bitwise(runs):
    inputs, result, _ = runs
    el = result["elastic"]
    assert el["mesh"] == ("pod", "data", "model")
    assert any("Shard" in p for p in el["placements"])
    expect = inputs["elastic"]["expect"]
    assert set(el["restored"]) == set(expect)
    for k in expect:
        np.testing.assert_array_equal(el["restored"][k], expect[k], err_msg=k)


def test_a_reference_checkpoint_restores_on_a_mesh_bitwise(runs):
    inputs, result, _ = runs
    expect = inputs["elastic"]["expect"]
    got = result["elastic"]["from_reference"]
    assert set(got) == set(expect)
    for k in expect:
        np.testing.assert_array_equal(got[k], expect[k], err_msg=k)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """olmo_1b and mamba2 smoke (the port's bf16 init) on one rank and a
    (1, 1, 1) mesh, 3 steps with remat and ZeRO-1 moments: the CPU
    rehearsal of chip_smoke.py's phase 36."""
    from repro_torch.training import DataConfig, SyntheticPackedDataset

    wd = tmp_path_factory.mktemp("world1")
    inputs = {}
    for arch in ("olmo_1b", "mamba2_1p3b"):
        cfg = get_smoke_config(arch)
        m = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        batch = SyntheticPackedDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                                  global_batch=4, seed=0)).batch_at(0)
        inputs[arch] = {"arch": arch, "zero": True, "params": m.params(), "batch": batch,
                        "steps": 3}
    torch.save(inputs, wd / "inputs.pt")
    return inputs, run_ranks("world1", 1, wd, timeout=RANKS_TIMEOUT_S)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_1p3b"])
def test_world_size_1_sharded_steps_equal_the_unsharded_bitwise(world1, arch):
    inputs, result = world1
    case, got = inputs[arch], result[arch]
    tm = build_model(get_smoke_config(arch)).install(_clone(case["params"]))
    step = make_train_step(tm, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    state, losses = init_opt_state(tm.params()), []
    for _ in range(case["steps"]):
        state, met = step(state, case["batch"])
        losses.append(float(met["loss"]))
    assert got["losses"] == losses
    assert any("Shard" in p for p in got["moment_placements"])    # ZeRO-1 on size-1 axes
    want = full_numpy(tm.params())
    assert set(got["params"]) == set(want)
    for k in want:
        np.testing.assert_array_equal(got["params"][k], want[k], err_msg=k)
