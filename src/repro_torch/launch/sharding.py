"""Rule construction: logical axes → mesh axes, per (arch × shape × mesh).

The counterpart of ``src/repro/launch/sharding.py``. Divisibility-driven:
a logical axis maps to ``model`` only when the corresponding dimension
divides the model-axis size. Fallbacks:

  heads/kv_heads not divisible → attention stays head-replicated and the
      KV cache shards its *sequence* dim instead (``kv_seq``→model);
  vocab not divisible (mamba2 50280, granite 49155, whisper 51865) → the
      embedding table shards its d_model dim (``vocab_embed``→model);
  batch not divisible (long_500k B=1) → batch replicated.

ZeRO-1: optimizer moments extend the param spec with the DP axes folded
into the largest still-unsharded divisible dim.

A mesh here is a ``DeviceMesh`` (``launch/mesh.py``); the rules read only
its axis names and extents (``sharding.mesh_axis_sizes``). Shardings are
``MeshSharding``s: a spec on the mesh, which gives DTensor placements.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..models.config import ModelConfig, ShapeConfig
from ..models.transformer import axes_map
from ..sharding import MeshSharding, logical_to_spec, mesh_axis_sizes

Params = Any


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    axes = mesh_axis_sizes(mesh)
    model_n = axes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp_n = math.prod(axes[a] for a in dp_axes)

    def div(n):
        return bool(n) and n % model_n == 0

    batch_rule = dp_axes if shape.global_batch % dp_n == 0 else None
    kv_heads_sharded = div(cfg.num_kv_heads)

    return {
        "batch": batch_rule,
        "layer": None,
        "embed": None,
        "head_dim": None,
        "seq": None,
        "heads": "model" if div(cfg.num_heads) else None,
        # heads can't carry TP (28 ∤ 16, 8 < 16): shard attention q-rows
        "attn_q": None if div(cfg.num_heads) else "model",
        "kv_heads": "model" if kv_heads_sharded else None,
        # decode KV cache: shard seq when heads can't carry the model axis
        "kv_seq": None if kv_heads_sharded else "model",
        "mlp": "model" if div(cfg.d_ff) or div(cfg.moe_d_ff) else None,
        "vocab": "model" if div(cfg.vocab_size) else None,
        "vocab_embed": None if div(cfg.vocab_size) else "model",
        "expert": "model" if div(cfg.num_experts) else None,
        "ssm_inner": "model" if div(cfg.d_inner) else None,
        "ssm_heads": "model" if div(cfg.ssm_heads) else None,
        "ssm_state": "model" if div(cfg.ssm_state) else None,
    }


def spec_tree(axes_tree, rules):
    """Logical-axes tree → spec tree (tuples, entry for entry the
    reference's ``PartitionSpec``s)."""
    return axes_map(lambda a: logical_to_spec(a or (), rules), axes_tree)


def sharding_tree(axes_tree, rules, mesh):
    """Logical-axes tree → ``MeshSharding`` tree on ``mesh``."""
    return axes_map(lambda a: MeshSharding(mesh, logical_to_spec(a or (), rules)), axes_tree)


def zero_sharding_tree(param_shapes, axes_tree, rules, mesh):
    """ZeRO-1 shardings for optimizer moments: param spec + DP axes folded
    into the largest unsharded divisible dim. ``param_shapes``: a tree of
    the axes tree's structure whose leaves have ``.shape`` (``meta``
    tensors from ``Model.param_shapes``, or the parameters)."""
    mesh_axes = mesh_axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes)
    dp_n = math.prod(mesh_axes[a] for a in dp_axes)

    def one(la, shape_struct):
        shape = tuple(shape_struct.shape)
        base = logical_to_spec(la or (), rules)
        spec = list(base) + [None] * (len(shape) - len(base))
        if dp_axes:
            # largest unsharded dim divisible by the full DP product
            cands = [(d, s) for d, s in enumerate(shape)
                     if spec[d] is None and s % dp_n == 0 and s > 0]
            if cands:
                d = max(cands, key=lambda t: t[1])[0]
                spec[d] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        return MeshSharding(mesh, tuple(spec))

    return axes_map(one, axes_tree, param_shapes)


# ---------------------------------------------------------------------------
# input specs (shapes, dtypes and shardings) per (arch × shape)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig, rules, mesh):
    """Returns (batch_structs, batch_shardings) for the mode's step inputs:
    ``{name: (shape, dtype)}`` and ``{name: MeshSharding}``.

    train/prefill: {"tokens","labels"[,"positions"][,"frames"]}
    """
    B, S = shape.global_batch, shape.seq_len
    structs: Dict[str, Any] = {"tokens": ((B, S), torch.int32)}
    ax: Dict[str, Any] = {"tokens": ("batch", "seq")}
    if shape.mode == "train":
        structs["labels"] = ((B, S), torch.int32)
        ax["labels"] = ("batch", "seq")
    if cfg.rope_kind == "mrope":
        structs["positions"] = ((3, B, S), torch.int32)
        ax["positions"] = (None, "batch", "seq")
    if cfg.encoder_layers:
        structs["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        ax["frames"] = ("batch", None, "embed")
    shardings = {k: MeshSharding(mesh, logical_to_spec(a, rules)) for k, a in ax.items()}
    return structs, shardings


def distribute(tree, shardings):
    """Place a tree of host or device tensors onto the mesh: each leaf a
    DTensor with its ``MeshSharding``'s placements (each rank keeps its
    shard of the full value it holds; every rank must hold the same)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, sh):
        return distribute_tensor(x.detach(), sh.mesh, sh.placements(x.dim()),
                                 src_data_rank=None)

    if isinstance(shardings, MeshSharding):
        return one(tree, shardings)
    return {k: distribute(v, shardings[k]) for k, v in tree.items()}


def distribute_model(model, shardings):
    """Lay the model's parameters out on the mesh by ``shardings``
    (``sharding_tree`` of ``model.axes()``): each becomes a DTensor."""
    return model.install(distribute(model.params(), shardings))
