"""Multi-rank scenarios of the port's sharded layer (training and
serving), gradient compression and pipeline on gloo CPU ranks.

``run_ranks(scenario, n, workdir)`` starts ``n`` processes of this file,
one a rank, joined by a ``FileStore`` under ``workdir`` (no network),
each with a 60 s timeout on the rendezvous and every collective, and
waits at most ``timeout`` seconds for all of them. The parent writes the
scenario's inputs to ``workdir/inputs.pt`` first; rank 0 writes its
result to ``workdir/result.pt``, which ``run_ranks`` returns. Imports
nothing of jax, so the ranks start quickly; the tests compare the
results with the reference in their own process.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
COLLECTIVE_TIMEOUT_S = 60


def run_ranks(scenario: str, n: int, workdir: Path, timeout: float = 300) -> dict:
    workdir = Path(workdir)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, __file__, scenario, str(r), str(n), str(workdir)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}):\n" + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r, rc in enumerate(rcs) if rc)
        raise RuntimeError(f"{scenario} on {n} ranks failed, rcs {rcs}:\n{tails}")
    return torch.load(workdir / "result.pt", weights_only=False)


def full_numpy(tree) -> dict:
    """{key path: numpy} of a tree of tensors or DTensors, each leaf's full
    value (a collective for a DTensor: every rank calls it)."""
    out = {}

    def walk(t, prefix):
        for k in sorted(t):
            v = t[k]
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}.")
            else:
                v = v.detach()
                if hasattr(v, "full_tensor"):
                    v = v.full_tensor()
                out[f"{prefix}{k}"] = v.float().numpy() if v.dtype == torch.bfloat16 \
                    else v.numpy().copy()
    walk(tree, "")
    return out


# ---------------------------------------------------------------------------
# scenarios (run on every rank)
# ---------------------------------------------------------------------------
def _train_case(case, mesh, steps=1, remat=False, opt_cfg=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import (distribute_model, rules_for, sharding_tree,
                                             zero_sharding_tree)
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import shard
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    cfg = get_smoke_config(case["arch"])
    model = build_model(cfg).install(case["params"])
    B, S = case["batch"]["tokens"].shape
    rules = rules_for(cfg, ShapeConfig("t", S, B, "train"), mesh)
    distribute_model(model, sharding_tree(model.axes(), rules, mesh))
    zero = (zero_sharding_tree(model.param_shapes(), model.axes(), rules, mesh)
            if case.get("zero") else None)
    state = init_opt_state(model.params(), zero)
    step = make_train_step(model, AdamWConfig(**(opt_cfg or dict(lr=1e-3, warmup_steps=0))),
                           remat=remat, rules=rules, mesh=mesh)
    shard.redistributes = 0
    losses = []
    with moe_groups(case.get("group_size")):
        for _ in range(steps):
            state, met = step(state, case["batch"])
            losses.append(float(met["loss"]))
    opt = state
    return {"loss": losses[0], "losses": losses, "grad_norm": float(met["grad_norm"]),
            "params": full_numpy(model.params()),
            "moments": {k: full_numpy(opt[k]) for k in ("m", "v")},
            "moment_placements": sorted({str(tuple(x.placements)) for x in
                                         _leaves(opt["m"])}),
            "redistributes": shard.redistributes, "rules": rules}


def moe_groups(group_size):
    """MoE token groups of ``group_size`` tokens in every layer (a smoke
    batch then makes several groups, which take the DP sharding), or the
    default with ``None``."""
    import contextlib
    import functools
    from unittest import mock

    from repro_torch.models import moe, transformer

    if group_size is None:
        return contextlib.nullcontext()
    return mock.patch.object(transformer, "moe_apply",
                             functools.partial(moe.moe_apply, group_size=group_size))


def _leaves(tree):
    for v in tree.values():
        if hasattr(v, "items"):
            yield from _leaves(v)
        else:
            yield v


def _gqa_case(case, mesh):
    """attention_full's K3 path (flash_prefill_ref on the CPU) with q's heads
    sharded over the model axis and K/V's replicated: the output and the
    gradients of x and the projections, in full."""
    from dataclasses import replace

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import distribute, rules_for, sharding_tree
    from repro_torch.models import attention
    from repro_torch.models.config import LayerSpec, ShapeConfig
    from repro_torch.sharding import MeshSharding, use_rules
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = replace(get_smoke_config("yi_9b"), num_heads=case["heads"],
                  num_kv_heads=case["kv_heads"])
    x = torch.from_numpy(case["x"])
    p = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    B, S = x.shape[:2]
    rules = rules_for(cfg, ShapeConfig("t", S, B, "train"), mesh)
    axes = {k: attention.ATTENTION_AXES[k] for k in p}
    pd = distribute(p, sharding_tree(axes, rules, mesh))
    for v in pd.values():
        v.requires_grad_()
    with use_rules(rules, mesh), implicit_replication():
        xd = distribute(x, MeshSharding(mesh, (("pod", "data"), None, None))).requires_grad_()
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        spec = LayerSpec(kind="attn", sliding_window=case.get("window", 0))
        before = dict(attention_full_paths())
        y, _ = attention.attention_full(xd, pd, cfg, spec, pos)
        paths = {k: v - before[k] for k, v in attention_full_paths().items()}
        grads = torch.autograd.grad((y.float() ** 2).sum(), [xd, *pd.values()])
    full = lambda t: t.detach().full_tensor().numpy()
    return {"y": full(y), "dx": full(grads[0]),
            "dparams": {k: full(g) for k, g in zip(pd, grads[1:])},
            "paths": paths, "rules": rules,
            "placements": {k: str(tuple(v.placements)) for k, v in pd.items()}}


def attention_full_paths():
    from repro_torch.models import attention

    return attention.attention_full.paths


def _elastic(case, meshes):
    """Save the model's parameters from the first mesh, restore them onto
    the second; restore a checkpoint the reference wrote onto the second."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import distribute_model, rules_for, sharding_tree
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training import Checkpointer

    cfg = get_smoke_config(case["arch"])
    shape = ShapeConfig("t", 32, 8, "train")
    model = build_model(cfg).install(case["params"])
    axes = model.axes()
    m1, m2 = meshes
    distribute_model(model, sharding_tree(axes, rules_for(cfg, shape, m1), m1))
    ck = Checkpointer(case["dir"])
    ck.save(1, model.params())
    sh2 = sharding_tree(axes, rules_for(cfg, shape, m2), m2)
    _, tree, _ = ck.restore(1, shardings=sh2)
    _, ref_tree, _ = Checkpointer(case["reference_dir"]).restore(shardings=sh2)
    placed = {str(tuple(x.placements)) for x in _leaves(tree)}
    return {"restored": full_numpy(tree), "from_reference": full_numpy(ref_tree),
            "placements": sorted(placed), "mesh": tuple(m2.mesh_dim_names)}


def scenario_sharded(workdir: Path, rank: int) -> dict:
    """The (2, 2, 2) scenarios: the train cases, the GQA cases, then the
    elastic round trip from (4, 2) to (2, 2, 2)."""
    from repro_torch.launch.mesh import make_host_mesh

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_host_mesh(model=2, data=2, pod=2, device_type="cpu")
    out = {"train": {}, "gqa": {}, "seconds": {}}
    for name, case in inputs["train"].items():
        t0 = time.perf_counter()
        out["train"][name] = _train_case(case, mesh)
        out["seconds"][name] = time.perf_counter() - t0
    for name, case in inputs["gqa"].items():
        out["gqa"][name] = _gqa_case(case, mesh)
    if "elastic" in inputs:
        flat = make_host_mesh(model=2, data=4, device_type="cpu")
        out["elastic"] = _elastic(inputs["elastic"], (flat, mesh))
    return out


def scenario_world1(workdir: Path, rank: int) -> dict:
    """Each case on one rank and a (1, 1, 1) mesh, as chip_smoke.py's phase
    36 runs it on the card: ``steps`` sharded steps with ZeRO-1 moments."""
    from torch.distributed.device_mesh import init_device_mesh

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    out = {}
    for name, case in inputs.items():
        out[name] = _train_case(case, mesh, steps=case["steps"], remat=True,
                                opt_cfg=dict(lr=1e-3, warmup_steps=2, total_steps=20))
    return out


def _all_ranks(x: torch.Tensor) -> np.ndarray:
    """(n, ...) numpy of every rank's ``x`` (an all-gather; every rank calls it)."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts).numpy()


def _wire_dtypes(fn):
    """``fn()``'s result and the dtypes of the tensors it handed to
    ``dist.all_reduce``, in call order."""
    from unittest import mock

    import torch.distributed as dist

    seen, real = [], dist.all_reduce

    def spy(tensor, *args, **kwargs):
        seen.append(str(tensor.dtype))
        return real(tensor, *args, **kwargs)

    with mock.patch.object(dist, "all_reduce", spy):
        out = fn()
    return out, seen


def scenario_grad_comp(workdir: Path, rank: int) -> dict:
    """``compressed_psum`` over the default group, rank r holding row r of
    the (n, ...) gradients: two rounds with error feedback, with and
    without ``n_shards``. Every rank's ĝ and error state, and the dtypes
    on the wire."""
    from repro_torch.training.grad_comp import compressed_psum, init_error_state

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    g = {"w": torch.from_numpy(inputs["g"][rank])}
    out = {}
    for name, n_shards in (("int32", None), ("int8", inputs["n"])):
        e, rounds = init_error_state(g), []
        for _ in range(2):
            (ghat, e), wire = _wire_dtypes(lambda: compressed_psum(g, e, None, n_shards=n_shards))
            rounds.append({"ghat": _all_ranks(ghat["w"]), "err": _all_ranks(e["w"]),
                           "wire": wire})
        out[name] = rounds
    return out


def scenario_pipeline(workdir: Path, rank: int) -> dict:
    """``pipeline_apply`` of ``tanh(x @ w)`` over a (n,) ``pod`` mesh,
    stage weights given whole and as a DTensor sharded over ``pod``; every
    rank's output."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.training.pipeline import pipeline_apply

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    n = len(inputs["ws"])
    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("pod",))
    x, ws = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["ws"])

    def stage(h, w):
        return torch.tanh(h @ w)

    out = {}
    for name, params in (("whole", ws), ("sharded", distribute_tensor(ws, mesh, [Shard(0)]))):
        y = pipeline_apply(stage, x, params, mesh=mesh, axis="pod", n_micro=inputs["n_micro"])
        out[name] = _all_ranks(y)
    return out


def scenario_serve(workdir: Path, rank: int) -> dict:
    """Each case's prefill and teacher-forced decode steps with DTensor
    parameters, batch and caches on a (2, 2) data/model mesh: the logits
    of every step in full, the rules, and the caches' placements."""
    from dataclasses import replace

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import distribute, distribute_model, rules_for, sharding_tree
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import MeshSharding, logical_to_spec, use_rules

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = make_host_mesh(model=2, data=2, device_type="cpu")
    out = {}
    for name, case in inputs.items():
        cfg = replace(get_smoke_config(case["arch"]), **case["overrides"])
        model = build_model(cfg).install(case["params"])
        tokens, steps = torch.from_numpy(case["tokens"]), case["steps"]
        B, S = tokens.shape
        rules = rules_for(cfg, ShapeConfig("t", S + len(steps), B, "decode"), mesh)
        distribute_model(model, sharding_tree(model.axes(), rules, mesh))
        rows = MeshSharding(mesh, logical_to_spec(("batch",), rules))
        with use_rules(rules, mesh), implicit_replication():
            logits, cache = model.prefill(
                distribute(tokens, MeshSharding(mesh, logical_to_spec(("batch", "seq"), rules))),
                cache_len=S + len(steps))
            seen = [logits.full_tensor().numpy()]
            for i, tok in enumerate(steps):
                pos = torch.full((B,), S + i, dtype=torch.int32)
                logits, cache = model.decode_step(distribute(torch.from_numpy(tok), rows),
                                                  distribute(pos, rows), cache)
                seen.append(logits.full_tensor().numpy())
        out[name] = {"logits": np.stack(seen), "rules": rules,
                     "cache_placements": sorted({str(tuple(x.placements))
                                                 for x in _leaves(cache)})}
    return out


SCENARIOS = {"sharded": scenario_sharded, "world1": scenario_world1,
             "grad_comp": scenario_grad_comp, "pipeline": scenario_pipeline,
             "serve": scenario_serve}


def _rank_main(scenario: str, rank: int, n: int, workdir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    np.random.seed(rank)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=n, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = SCENARIOS[scenario](workdir, rank)
        if rank == 0:
            torch.save(result, workdir / "result.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
