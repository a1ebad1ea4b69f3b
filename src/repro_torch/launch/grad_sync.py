"""Cross-pod gradient sync: dense against int8 + error feedback, in bytes.

The counterpart of ``src/repro/launch/grad_sync.py``. On the multipod
mesh the data-parallel gradient reduction crosses the link between pods
once a step. This script runs three variants of the pod-axis sync over an
arch's full gradient tree and reports the all-reduce bytes a device puts
on the wire:

  dense_f32   all-reduce of the fp32 grads        (naive)
  dense_bf16  all-reduce of bf16-cast grads        (standard)
  int8_ef     compressed_psum, n_shards=2          (1 B/elem on the wire + EF state)

As the reference lowers the three on 512 placeholder devices, this runs
them on rank 0 of a 512-rank ``fake`` process group (``launch/dryrun``),
the (2, 16, 16) multipod mesh over it and the rules for ``train_4k``:
the gradients are fp32 ``meta`` tensors laid out as the parameters
(``Model.param_shapes()``, ``sharding_tree``), each rank reducing its
local shards over ``mesh.get_group("pod")``; ``dryrun._LocalOps`` counts
the collectives by kind and by the bytes of their local inputs.

Usage:
  python -m repro_torch.launch.grad_sync --arch jamba-v0.1-52b [--device-type cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch
import torch.distributed as dist

from .mesh import DEFAULT_DEVICE_TYPE

VARIANTS = ("dense_f32", "dense_bf16", "int8_ef")


def _dense(dtype):
    def run(grads, group):
        from ..training.optimizer import tree_map

        def one(g):
            w = g.to_local().to(dtype)
            dist.all_reduce(w, group=group)
            return w.float() / 2.0
        return tree_map(one, grads)
    return run


def _int8_ef(grads, group):
    from ..training.grad_comp import compressed_psum, init_error_state

    ghat, _ = compressed_psum(grads, init_error_state(grads), group, n_shards=2)
    return ghat


def sync_bytes(cfg, mesh, rules) -> Dict[str, Dict[str, int]]:
    """The collectives of each variant's pod-axis sync of ``cfg``'s
    gradients (fp32 ``meta``, laid out by ``rules`` on ``mesh``), by kind
    with ``count``: ``{variant: collectives}``."""
    from ..models import build_model
    from ..training.optimizer import tree_map
    from .dryrun import _LocalOps
    from .sharding import distribute, sharding_tree

    model = build_model(cfg)
    shapes = model.param_shapes()
    grads = distribute(tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device="meta"), shapes),
                       sharding_tree(model.axes(), rules, mesh))
    group = mesh.get_group("pod")
    fns = {"dense_f32": _dense(torch.float32), "dense_bf16": _dense(torch.bfloat16),
           "int8_ef": _int8_ef}
    results = {}
    for name in VARIANTS:
        ops = _LocalOps()
        with ops:
            fns[name](grads, group)
        results[name] = ops.collectives
    return results


def main(argv=None) -> Dict[str, Dict[str, int]]:
    from ..configs import get_config
    from ..models.config import SHAPES
    from .dryrun import production_mesh
    from .sharding import rules_for

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--out", default="")
    ap.add_argument("--device-type", default=DEFAULT_DEVICE_TYPE,
                    help="the mesh's device type (cpu where there is no CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    mesh = production_mesh("multipod", args.device_type)
    results = sync_bytes(cfg, mesh, rules_for(cfg, SHAPES["train_4k"], mesh))
    for name, cb in results.items():
        print(f"{name}: all-reduce bytes/device = "
              f"{cb['all-reduce']/1e9:.3f} GB  (ops={cb['count']})")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"arch": args.arch, "results": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
