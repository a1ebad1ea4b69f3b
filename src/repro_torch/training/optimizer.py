"""AdamW and its learning-rate schedules, with fp32 moments.

The counterpart of ``src/repro/training/optimizer.py``, as plain
functions over the parameter tree (nested dicts of tensors, or the
``Model`` itself, which indexes the same way), run under
``torch.no_grad()``. ``torch.optim.AdamW`` is not used: it decays every
parameter, and its eps and clipping differ from the reference's.

State layout: ``{"m": tree, "v": tree, "step": 0-d int32}``. m and v are
fp32 whatever the parameter's dtype; the update is computed in fp32 and
cast back to the parameter's dtype. Unlike the reference, which returns
new trees, ``adamw_update`` writes the parameters, m and v in place (no
second copy of the model) and returns the same tensors.

Weight decay follows the reference's rule: a leaf with ``ndim >= 2`` is
decayed. The stacked norm scales are (L, d), so they are decayed too,
against the reference's comment (ROADMAP Queue 3 entry 14); the rule is
kept so that both packages take the same step.

Sharded (``repro_torch.sharding``): the parameters, grads and moments
may be DTensors. m and v may be laid out by ZeRO-1 shardings
(``launch/sharding.zero_sharding_tree``): each rank then updates its
slice of a parameter in the moments' layout and the slices are gathered
back into the parameter's. The gradient norm is a full reduction over
every shard; the arithmetic of a leaf's update is the unsharded one, on
the local shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..sharding import is_dtensor

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


def tree_leaves(tree):
    for v in tree.values():
        if hasattr(v, "items"):
            yield from tree_leaves(v)
        else:
            yield v


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if hasattr(v, "items")
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine or linear decay to
    ``min_lr_ratio·lr`` at ``total_steps`` (or constant), in fp32 as the
    reference computes it. ``step``: an int or an int tensor."""
    step = (step.float() if isinstance(step, torch.Tensor)
            else torch.tensor(step, dtype=torch.float32))
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        decay = torch.ones_like(step)
    else:
        t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                        0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
        else:  # cosine
            decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (
                1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * decay


def init_opt_state(params: Params, shardings: Params = None) -> Dict[str, Any]:
    """fp32 zeros for m and v beside every leaf, and step 0 (int32), on the
    parameters' device. A DTensor leaf's moments are DTensors laid out as
    the leaf, or by ``shardings`` (a tree of ``MeshSharding``s, ZeRO-1's
    from ``zero_sharding_tree``) when given."""
    def zeros32(p, sh=None):
        if sh is not None:
            from torch.distributed.tensor import zeros

            return zeros(p.shape, dtype=torch.float32, device_mesh=sh.mesh,
                         placements=sh.placements(p.dim()))
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    rest = (shardings,) if shardings is not None else ()
    dev = next(tree_leaves(params)).device
    return {"m": tree_map(zeros32, params, *rest), "v": tree_map(zeros32, params, *rest),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """√(Σ x²) over every leaf, in fp32; over DTensor leaves the sum runs
    over every shard and the result is a plain replicated tensor."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    if is_dtensor(total):
        total = total.full_tensor()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: Dict[str, Any]) -> Tuple[Params, Dict[str, Any],
                                                 Dict[str, torch.Tensor]]:
    """One AdamW step: grads clipped by ``grad_clip / (‖g‖ + 1e-9)`` (at
    most 1), bias-corrected moments, decay on leaves with ``ndim >= 2``.
    ``grads`` has the tree of ``params``. Returns (params, state,
    ``{grad_norm, lr}``); params, m and v are updated in place."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = lr_at(cfg, step).to(gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float() + 1
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    def upd_sharded(p, g, m, v):
        """``upd`` on the local shards in the moments' layout; a slice of
        a ZeRO-1 layout is gathered back into the parameter's."""
        if not is_dtensor(p):
            return upd(p, g, m, v)
        mesh, layout = m.device_mesh, tuple(m.placements)
        gl = g.redistribute(mesh, layout).to_local()
        if layout == tuple(p.placements):
            return upd(p.to_local(), gl, m.to_local(), v.to_local())
        pz = p.redistribute(mesh, layout)
        upd(pz.to_local(), gl, m.to_local(), v.to_local())
        p.to_local().copy_(pz.redistribute(mesh, p.placements).to_local())

    tree_map(upd_sharded, params, grads, state["m"], state["v"])
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
