"""The port's dry-run (``launch/dryrun.py``) and gradient-sync tool
(``launch/grad_sync.py``): the reference's cell tables; the reference's
``test_cell_on_8_devices`` on the port (qwen3_moe smoke on a (4, 2) mesh
over an 8-rank ``fake`` group, train shape 64 × 8), whose record carries
the reference's keys; the ``--costing`` extrapolation against the full
count; the pod-axis sync's bytes at 4 : 2 : 1 plus the maxima; the
kernels' wrappers on ``meta`` tensors. And the sharded serving paths the
dry-run traces, with values: prefill and decode on DTensors on 4 gloo
ranks against the unsharded model (a KV cache sharded over its sequence,
combined across ranks, and one sharded over its heads)."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch_dist import ROOT, run_ranks  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun, grad_sync  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.sharding import rules_for  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

REFERENCE_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
# the reference's record keys (src/repro/launch/dryrun.py:135-146, 234-263)
REFERENCE_KEYS = {"arch", "shape", "mesh", "mode", "costing", "variant", "devices", "params",
                  "active_params", "rules", "lower_s", "compile_s", "argument_size_in_bytes",
                  "output_size_in_bytes", "temp_size_in_bytes", "generated_code_size_in_bytes",
                  "alias_size_in_bytes", "flops", "bytes_accessed", "transcendentals",
                  "collectives", "hlo_lines"}
NO_COUNTERPART = {"lower_s", "compile_s", "generated_code_size_in_bytes", "transcendentals",
                  "hlo_lines"}
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)      # fp32 logits, sums reordered across ranks
RANKS_TIMEOUT_S = 180


def _reference_tables():
    """ARCHES, SHAPE_NAMES and SKIPS as the reference's source assigns them
    (read, not imported: importing it sets XLA_FLAGS for this process)."""
    tree = ast.parse(REFERENCE_DRYRUN.read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id in ("ARCHES", "SHAPE_NAMES", "SKIPS")}


def test_cell_tables_equal_the_reference():
    ref = _reference_tables()
    assert dryrun.ARCHES == ref["ARCHES"]
    assert dryrun.SHAPE_NAMES == ref["SHAPE_NAMES"]
    assert dryrun.SKIPS == ref["SKIPS"]


def test_artifacts_go_under_build():
    assert Path(dryrun.ARTIFACT_DIR).resolve() == ROOT / "build" / "dryrun"


@pytest.fixture(scope="module")
def fake8():
    """An 8-rank fake group, destroyed after the module's tests."""
    dryrun._fake_group(8)
    yield
    dist.destroy_process_group()


def _cell(cfg, mode, mesh, S=64, B=8, **kw):
    shape = ShapeConfig(f"{mode}_{S}", S, B, mode)
    return dryrun.record(cfg, shape, mesh, rules_for(cfg, shape, mesh), arch=cfg.name,
                         mesh_kind="host", **kw)


def test_cell_on_8_devices(fake8):
    """tests/test_distribution.py:188-220 on the port: FLOPs > 0,
    collectives counted, the reference's keys (null where there is no
    counterpart), the plain cost path, no kernel launched."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda

    mesh = make_host_mesh(model=2, data=4, device_type="cpu")
    n3 = flash_prefill_cuda.launches
    rec = _cell(get_smoke_config("qwen3_moe_30b_a3b"), "train", mesh)
    assert flash_prefill_cuda.launches == n3
    assert REFERENCE_KEYS <= set(rec)
    assert all(rec[k] is None for k in NO_COUNTERPART)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["trace_s"] > 0
    assert rec["collectives"]["count"] > 0
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVE_KINDS) | {"count"}
    assert rec["collectives"]["all-reduce"] > 0 and rec["collectives"]["all-gather"] > 0
    assert rec["devices"] == 8 and rec["cost_path"] == "plain" and rec["mode"] == "train"
    assert rec["rules"]["expert"] == "model" and rec["rules"]["batch"] == ["data"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
              "alias_size_in_bytes"):
        assert rec[k] > 0, k


@pytest.mark.parametrize("arch,mode", [("yi_9b", "train"), ("yi_9b", "decode"),
                                       ("whisper_base", "train"),
                                       ("whisper_base", "prefill")])
def test_extrapolated_flops_equal_the_full_count(fake8, arch, mode):
    """The smoke model at three blocks (whisper: three decoder and three
    encoder layers): cost(1) + 2·(cost(2) − cost(1)) from the --costing
    traces equals the full trace's FLOPs."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=3 * len(cfg.block_pattern()),
                              **({"encoder_layers": 3} if cfg.encoder_layers else {}))
    mesh = make_host_mesh(model=2, data=4, device_type="cpu")
    full = _cell(cfg, mode, mesh)
    cost = _cell(cfg, mode, mesh, costing=True)
    assert cost["cost_method"].startswith("extrapolated")
    assert full["flops"] > 0
    assert cost["flops"] == full["flops"]


def test_grad_sync_bytes_are_4_2_1_plus_the_maxima(fake8):
    """The pod-axis sync of jamba smoke's gradients on a (2, 2, 2) mesh:
    fp32, bf16 and int8 all-reduce bytes at 4 : 2 : 1 of the local
    elements, int8 plus one fp32 vector of the leaves' maxima."""
    from repro_torch.training.optimizer import tree_leaves

    cfg = get_smoke_config("jamba_v01_52b")
    mesh = make_host_mesh(model=2, data=2, pod=2, device_type="cpu")
    res = grad_sync.sync_bytes(cfg, mesh, rules_for(cfg, ShapeConfig("t", 64, 8, "train"), mesh))
    n_leaves = len(list(tree_leaves(build_model(cfg).param_shapes())))
    f32, bf16, int8 = (res[k]["all-reduce"] for k in grad_sync.VARIANTS)
    assert f32 == 2 * bf16 == 4 * (int8 - 4 * n_leaves)
    assert res["dense_f32"]["count"] == res["dense_bf16"]["count"] == n_leaves
    assert res["int8_ef"]["count"] == n_leaves + 1
    assert all(res[k]["all-reduce"] == sum(v for kk, v in res[k].items() if kk != "count")
               for k in res)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_kernels_run_their_plain_versions_on_meta():
    """K1–K4's wrappers give ``meta`` outputs of the right shapes and
    launch nothing."""
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.scope_copy import gather_pages, scatter_pages
    from repro_torch.kernels.ssd.ops import ssd_intra_chunk

    i32 = torch.int32
    before = (paged_attention.launches, gather_pages.launches, scatter_pages.launches)
    out, oob = paged_attention(_meta(2, 4, 16), _meta(8, 4, 2, 16), _meta(8, 4, 2, 16),
                               _meta(2, 3, dtype=i32), _meta(2, dtype=i32), _meta(8, dtype=i32),
                               _meta(3, dtype=i32), _meta(8, dtype=i32))
    assert (out.device.type, tuple(out.shape), tuple(oob.shape)) == ("meta", (2, 4, 16), (2,))
    rows = gather_pages(_meta(8, 32), _meta(5, dtype=i32))
    assert (rows.device.type, tuple(rows.shape)) == ("meta", (5, 32))
    pool = scatter_pages(_meta(8, 32), _meta(5, dtype=i32), _meta(5, 32))
    assert (pool.device.type, tuple(pool.shape)) == ("meta", (8, 32))
    o = flash_prefill(_meta(2, 40, 4, 16), _meta(2, 40, 2, 16), _meta(2, 40, 2, 16))
    assert (o.device.type, tuple(o.shape)) == ("meta", (2, 40, 4, 16))
    f32 = torch.float32
    y, states, decay = ssd_intra_chunk(_meta(2, 48, 4, 8), _meta(2, 48, 4, dtype=f32),
                                       _meta(4, dtype=f32), _meta(2, 48, 16), _meta(2, 48, 16), 16)
    assert {t.device.type for t in (y, states, decay)} == {"meta"}
    assert [tuple(t.shape) for t in (y, states, decay)] == [(2, 48, 4, 8), (2, 3, 4, 16, 8),
                                                             (2, 3, 4)]
    assert (paged_attention.launches, gather_pages.launches, scatter_pages.launches) == before


SERVE = {   # name: (arch, overrides): the cache's sequence or heads over "model"
    "kv_seq_sharded": ("yi_9b", {"num_kv_heads": 1}),
    "kv_heads_sharded": ("yi_9b", {}),
    "ssm": ("mamba2_1p3b", {}),
}


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(3)
    inputs = {}
    for name, (arch, overrides) in SERVE.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
        m = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        params = {k: v for k, v in m.params().items()}
        inputs[name] = {
            "arch": arch, "overrides": overrides,
            "params": _float_tree(params),
            "tokens": rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int32),
            # 12 + 4 = 16 cache slots: the sequence divides the model axis
            "steps": [rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32) for _ in range(4)]}
    torch.save(inputs, wd / "inputs.pt")
    return inputs, run_ranks("serve", 4, wd, timeout=RANKS_TIMEOUT_S)


def _float_tree(tree):
    return {k: _float_tree(v) if isinstance(v, dict) else
            (v.detach().float() if v.is_floating_point() else v.detach()) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_prefill_and_decode_match_the_unsharded_model(serve_runs, name):
    inputs, result = serve_runs
    case, got = inputs[name], result[name]
    cfg = dataclasses.replace(get_smoke_config(case["arch"]), **case["overrides"])
    m = build_model(cfg).install(case["params"])
    tokens = torch.from_numpy(case["tokens"])
    B, S = tokens.shape
    logits, cache = m.prefill(tokens, cache_len=S + len(case["steps"]))
    want = [logits.numpy()]
    for i, tok in enumerate(case["steps"]):
        logits, cache = m.decode_step(torch.from_numpy(tok),
                                      torch.full((B,), S + i, dtype=torch.int32), cache)
        want.append(logits.numpy())
    np.testing.assert_allclose(got["logits"], np.stack(want), **SERVE_TOL)
    rules = got["rules"]
    if name == "kv_seq_sharded":
        assert rules["kv_seq"] == "model" and rules["kv_heads"] is None
        assert any("Shard(dim=2)" in p for p in got["cache_placements"])   # (L, B, S, ...)
    elif name == "kv_heads_sharded":
        assert rules["kv_heads"] == "model" and rules["kv_seq"] is None
