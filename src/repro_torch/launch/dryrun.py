"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on 256 or 512
placeholder ranks.

The counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell with XLA on 512 placeholder devices. Here a cell's
process joins torch's ``fake`` process group at the mesh's world size
(no communication, no other process), builds the production mesh over it
(``launch/mesh.py``) and runs the mode's own step once on DTensors whose
local tensors lie on the ``meta`` device: shapes and dtypes, nothing
allocated, no data. Per cell it

  1. builds the model and the sharding rules (``launch/sharding.rules_for``),
  2. lays out the parameters, ZeRO-1 moments, batch and caches by the
     rules' shardings (``sharding_tree``, ``zero_sharding_tree``,
     ``input_specs``, ``stack_cache_axes``) as DTensors over ``meta``,
  3. runs the step: ``make_train_step(..., rules=, mesh=)``,
     ``Model.prefill`` or ``Model.decode_step``, once to fill DTensor's
     sharding-propagation cache (its shape inference runs operators of
     its own, on the global shapes), then again under three dispatch
     modes: ``MemTracker`` (peak memory), ``FlopCounterMode`` (FLOPs) and
     ``_LocalOps``, which hands every DTensor operator on to DTensor so
     that the modes see each rank's *local* operators, and counts the
     collectives DTensor and the model issue by kind and bytes,
  4. writes ``build/dryrun/<mesh>[_tag]/<arch>__<shape>.json`` with the
     reference's record keys.

Every number is per device, as the reference's post-SPMD cost analysis
is: FLOPs of the local operators; ``bytes_accessed``, each local
operator's tensor inputs read once and outputs written once (no fusion:
above XLA's fused count); collective bytes, the local input of each
collective; memory, the local shards. A kernel's wrapper runs its plain
version on ``meta`` tensors (``cost_path: "plain"``), as the reference's
dry-run costs its plain jnp paths. Keys without a counterpart
(``compile_s``, ``lower_s``, ``hlo_lines``, ``transcendentals``,
``generated_code_size_in_bytes``) are ``null``; the trace time is
``trace_s``.

``--costing`` keeps the reference's extrapolation, cost(nb) = c1 + (nb −
1)(c2 − c1) from traces of 1- and 2-block models, for the schema: the
counter here sees every layer, so the extrapolation equals the full
count.

Usage (``--device-type cpu`` where there is no CUDA card):
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .mesh import DEFAULT_DEVICE_TYPE

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

# long_500k only runs for sub-quadratic archs
SKIPS = {
    ("qwen2-vl-7b", "long_500k"): "full attention — quadratic at 512k",
    ("yi-9b", "long_500k"): "full attention — quadratic at 512k",
    ("yi-6b", "long_500k"): "full attention — quadratic at 512k",
    ("olmo-1b", "long_500k"): "full attention — quadratic at 512k",
    ("qwen3-moe-30b-a3b", "long_500k"): "full attention — quadratic at 512k",
    ("granite-moe-1b-a400m", "long_500k"): "full attention — quadratic at 512k",
    ("whisper-base", "long_500k"): "full attention (448-pos decoder in reality)",
}

ARCHES = [
    "mamba2-1.3b", "qwen2-vl-7b", "gemma3-12b", "yi-9b", "yi-6b",
    "olmo-1b", "qwen3-moe-30b-a3b", "granite-moe-1b-a400m",
    "whisper-base", "jamba-v0.1-52b",
]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")
# operator name fragments of torch's collectives (``c10d``,
# ``_c10d_functional``, ``_dtensor``) by the reference's HLO kinds; a
# receive is the other end of a counted send
_KIND_OF = (("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
            ("allreduce", "all-reduce"), ("all_gather", "all-gather"),
            ("allgather", "all-gather"), ("all_to_all", "all-to-all"),
            ("alltoall", "all-to-all"), ("send", "collective-permute"))
_INPUT_ARGS = ("input", "input_tensor", "input_tensors", "tensor", "tensors")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(*trees) -> int:
    """Bytes of the local shards of the tensors and DTensors in ``trees``,
    each tensor counted once however often it appears."""
    seen = {id(t): t for tree in trees for t in _tensors(tree)}
    return sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t) for t in seen.values())


def _collective_kind(func) -> Optional[str]:
    if not func.namespace.startswith(("c10d", "_c10d_functional", "_dtensor")):
        return None
    name = func._schema.name.split("::")[-1]
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


class _LocalOps(TorchDispatchMode):
    """Defers every operator with a DTensor argument to DTensor
    (``NotImplemented``), so that this mode and the modes entered before
    it see the local operators DTensor runs on each rank's shards. Counts
    the collectives among them by kind, with the bytes of their local
    inputs, and the bytes every other non-view operator reads and
    writes."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: 0 for k in COLLECTIVE_KINDS}
        self.collectives["count"] = 0
        self.bytes_accessed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            names = [a.name for a in func._schema.arguments]
            arg = next(n for n in _INPUT_ARGS if n in names)
            i = names.index(arg)
            self.collectives[kind] += _nbytes(args[i] if i < len(args) else kwargs[arg])
            self.collectives["count"] += 1
        elif not func.namespace.startswith(("c10d", "_c10d_functional")) and not func.is_view:
            self.bytes_accessed += _nbytes(list(args)) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        return out


def _fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (no communication; a collective returns its input's shape)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def production_mesh(mesh_kind: str, device_type: str = DEFAULT_DEVICE_TYPE):
    from .mesh import make_production_mesh

    multi = mesh_kind == "multipod"
    _fake_group(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type=device_type)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             extra: Optional[Dict[str, Any]] = None,
             costing: bool = False,
             rules_override: Optional[Dict[str, Any]] = None,
             variant: str = "", device_type: str = DEFAULT_DEVICE_TYPE
             ) -> Dict[str, Any]:
    """variant: comma-joined hillclimb levers —
      train : remat_dots | accum8 | accum32
      decode: uniform_pos | kv8
    """
    from ..configs import get_config
    from ..models.config import SHAPES
    from .sharding import rules_for

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = production_mesh(mesh_kind, device_type)
    rules = rules_for(cfg, shape, mesh)
    if rules_override:
        rules.update(rules_override)
    return record(cfg, shape, mesh, rules, arch=arch, mesh_kind=mesh_kind, extra=extra,
                  costing=costing, variant=variant)


def record(cfg, shape, mesh, rules, *, arch: str, mesh_kind: str,
           extra: Optional[Dict[str, Any]] = None, costing: bool = False,
           variant: str = "") -> Dict[str, Any]:
    """A cell's record: ``cfg`` at ``shape`` on ``mesh`` under ``rules``,
    traced whole (``cell_metrics``) or, with ``costing``, extrapolated
    from 1 and 2 blocks (``cost_by_extrapolation``)."""
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "mode": shape.mode,
        "costing": costing, "variant": variant, "devices": int(mesh.size()),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "cost_path": "plain",
    }
    if costing:
        rec.update(cost_by_extrapolation(cfg, shape, mesh, rules, variant))
        if extra:
            rec.update(extra)
        print({k: rec.get(k) for k in ("flops", "bytes_accessed")})
        print("collectives:", rec["collectives"])
        return rec
    rec["rules"] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in rules.items()}
    if extra:
        rec.update(extra)
    rec.update(cell_metrics(cfg, shape, mesh, rules, variant, verbose=True))
    return rec


def _meta(shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device="meta")


def cell_metrics(cfg, shape, mesh, rules, variant: str = "",
                 verbose: bool = False) -> Dict[str, Any]:
    """Trace the mode's step of ``cfg`` at ``shape`` on ``mesh`` under
    ``rules`` (DTensors over ``meta``) and return its per-device metrics:
    the reference's record keys (null where there is no counterpart) and
    ``trace_s``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import build_model
    from ..models.transformer import stack_cache_axes
    from ..sharding import MeshSharding, logical_to_spec, use_rules
    from ..training import AdamWConfig, make_train_step
    from ..training.optimizer import tree_map
    from .sharding import (distribute, distribute_model, input_specs, sharding_tree,
                           zero_sharding_tree)

    v = set(variant.split(",")) if variant else set()
    B, S = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    model = build_model(cfg)
    shapes = model.param_shapes()
    axes = model.axes()
    distribute_model(model.install(shapes), sharding_tree(axes, rules, mesh))
    params = model.params()
    structs, b_shard = input_specs(cfg, shape, rules, mesh)
    batch = {k: _meta(*s) for k, s in structs.items()}

    if shape.mode == "train":
        zero = zero_sharding_tree(shapes, axes, rules, mesh)
        zeros = tree_map(lambda p: _meta(p.shape, torch.float32), shapes)
        opt = {"m": distribute(zeros, zero), "v": distribute(zeros, zero),
               "step": _meta((), torch.int32)}
        accum = 32 if "accum32" in v else (8 if "accum8" in v else 1)
        step = make_train_step(model, AdamWConfig(),
                               remat="dots" if "remat_dots" in v else True,
                               grad_accum=accum, rules=rules, mesh=mesh)
        inputs = (params, opt, batch)
        aliased = (params, opt)

        def run():
            return step(opt, batch)
    elif shape.mode == "prefill":
        inputs, aliased = (params, batch), ()

        def run():
            with use_rules(rules, mesh), implicit_replication():
                b = distribute(batch, b_shard)
                return model.prefill(b["tokens"], cache_len=S, positions=b.get("positions"),
                                     frames=b.get("frames"))
    else:  # decode
        kv_dtype = torch.int8 if "kv8" in v else torch.bfloat16
        cache = distribute(model.empty_cache(B, S, kv_dtype=kv_dtype),
                           sharding_tree(stack_cache_axes(cfg), rules, mesh))
        tok_shard = MeshSharding(mesh, logical_to_spec(("batch",), rules))
        tok = distribute(_meta((B,), torch.int32), tok_shard)
        pos = (_meta((), torch.int32) if "uniform_pos" in v
               else distribute(_meta((B,), torch.int32), tok_shard))
        inputs, aliased = (params, tok, pos, cache), (cache,)

        def run():
            with use_rules(rules, mesh), implicit_replication():
                return model.decode_step(tok, pos, cache)

    # a first run fills DTensor's sharding-propagation cache, whose shape
    # inference runs operators on the global shapes; the second is counted
    with torch.autograd.set_multithreading_enabled(False):
        run()
        ops, mem = _LocalOps(), MemTracker()
        flops = FlopCounterMode(display=False)
        with mem, flops, ops:
            out = run()
    trace_s = time.perf_counter() - t0
    peak = mem.get_tracker_snapshot("peak")
    peak_bytes = sum(d["Total"] for d in peak.values())
    out_bytes = _local_bytes(out, aliased)       # the step's results and what it updated in place
    alias_bytes = _local_bytes(aliased)
    rec: Dict[str, Any] = {
        "trace_s": round(trace_s, 2), "lower_s": None, "compile_s": None,
        "argument_size_in_bytes": _local_bytes(inputs),
        "output_size_in_bytes": out_bytes,
        # allocated during the step, less the outputs made anew
        "temp_size_in_bytes": peak_bytes - (out_bytes - alias_bytes),
        "generated_code_size_in_bytes": None,
        "alias_size_in_bytes": alias_bytes,
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(ops.bytes_accessed),
        "transcendentals": None,
        "collectives": ops.collectives,
        "hlo_lines": None,
    }
    if verbose:
        print({k: rec[k] for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                   "temp_size_in_bytes", "alias_size_in_bytes")})
        print({k: rec[k] for k in ("flops", "bytes_accessed")})
    return rec


def cost_by_extrapolation(cfg, shape, mesh, rules, variant: str = "") -> Dict[str, Any]:
    """The reference's extrapolation from 1- and 2-block traces (blocks
    are identical, so each count is affine in the number of blocks):

        total = c1 + (nb − 1) · (c2 − c1)

    A model with an encoder gets one and two encoder layers beside them,
    as in the reference."""
    from ..costing import costing_mode

    pattern = len(cfg.block_pattern())
    nb = cfg.num_blocks
    ne = cfg.encoder_layers

    def reduced(k: int):
        kw = {"num_layers": k * pattern}
        if ne:
            kw["encoder_layers"] = k
        return dataclasses.replace(cfg, **kw)

    with costing_mode():
        c1 = cell_metrics(reduced(1), shape, mesh, rules, variant)
        c2 = cell_metrics(reduced(2), shape, mesh, rules, variant)

    rec: Dict[str, Any] = {
        "cost_method": "extrapolated(nb=1,2 traced)",
        "trace_s": round(c1["trace_s"] + c2["trace_s"], 2),
        "lower_s": None, "compile_s": None, "transcendentals": None,
    }
    for f in ("flops", "bytes_accessed"):
        a, b = c1[f], c2[f]
        rec[f] = a + (nb - 1) * (b - a)
    rec["collectives"] = {k: int(c1["collectives"][k] + (nb - 1) * (c2["collectives"][k]
                                                                    - c1["collectives"][k]))
                          for k in c1["collectives"]}
    return rec


def cell_path(arch, shape_name, mesh_kind, tag="") -> str:
    d = os.path.join(ARTIFACT_DIR, mesh_kind + (f"_{tag}" if tag else ""))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--tag", default="", help="artifact subdir suffix")
    ap.add_argument("--costing", action="store_true",
                    help="1- and 2-block traces, extrapolated (the reference's schema)")
    ap.add_argument("--variant", default="",
                    help="hillclimb levers, comma-joined (see run_cell)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device-type", default=DEFAULT_DEVICE_TYPE,
                    help="the meshes' device type (cpu where there is no CUDA card)")
    args = ap.parse_args(argv)
    if not args.tag:
        parts = []
        if args.variant:
            parts.append(args.variant.replace(",", "+"))
        if args.costing:
            parts.append("cost")
        args.tag = "_".join(parts)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if not args.all:
        assert args.arch and args.shape
        if (args.arch, args.shape) in SKIPS:
            print(f"SKIP {args.arch} {args.shape}: "
                  f"{SKIPS[(args.arch, args.shape)]}")
            rec = {"arch": args.arch, "shape": args.shape,
                   "mesh": meshes[0], "skipped": True,
                   "reason": SKIPS[(args.arch, args.shape)]}
            with open(cell_path(args.arch, args.shape, meshes[0],
                                args.tag), "w") as f:
                json.dump(rec, f, indent=1)
            return 0
        for mesh_kind in meshes:
            try:
                rec = run_cell(args.arch, args.shape, mesh_kind,
                               costing=args.costing, variant=args.variant,
                               device_type=args.device_type)
                status = "OK"
            except Exception as e:
                rec = {"arch": args.arch, "shape": args.shape,
                       "mesh": mesh_kind, "error": repr(e),
                       "trace": traceback.format_exc()}
                status = "FAIL"
            with open(cell_path(args.arch, args.shape, mesh_kind,
                                args.tag), "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[{status}] {args.arch} {args.shape} {mesh_kind} "
                  f"trace={rec.get('trace_s')}s flops={rec.get('flops') or 0:.3g}")
            if status == "FAIL":
                print(rec["trace"])
                return 1
        return 0

    # orchestrator: one subprocess per cell (a fresh process group each,
    # and parallel traces)
    jobs = []
    for mesh_kind in meshes:
        for arch in ARCHES:
            for shape_name in SHAPE_NAMES:
                out = cell_path(arch, shape_name, mesh_kind, args.tag)
                if os.path.exists(out) and not args.force:
                    with open(out) as f:
                        old = json.load(f)
                    if "error" not in old:
                        continue
                jobs.append((arch, shape_name, mesh_kind))

    print(f"{len(jobs)} cells to run")
    running: list = []
    failed = []
    done = 0
    while jobs or running:
        while jobs and len(running) < args.jobs:
            arch, shape_name, mesh_kind = jobs.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", mesh_kind, "--device-type", args.device_type]
            if args.tag:
                cmd += ["--tag", args.tag]
            if args.costing:
                cmd += ["--costing"]
            if args.variant:
                cmd += ["--variant", args.variant]
            p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
            running.append((p, arch, shape_name, mesh_kind, time.time()))
        for item in list(running):
            p, arch, shape_name, mesh_kind, t0 = item
            if p.poll() is not None:
                running.remove(item)
                done += 1
                dt = time.time() - t0
                ok = p.returncode == 0
                if not ok:
                    failed.append((arch, shape_name, mesh_kind))
                print(f"[{done}] {'OK ' if ok else 'FAIL'} "
                      f"{arch} {shape_name} {mesh_kind} ({dt:.0f}s)",
                      flush=True)
        time.sleep(0.5)
    if failed:
        print("FAILED CELLS:", failed)
        return 1
    print("ALL CELLS PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
