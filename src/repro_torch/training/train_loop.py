"""Train-step factory: gradient accumulation, remat, AdamW, metrics.

The counterpart of ``src/repro/training/train_loop.py``. Where the
reference returns a pure ``(params, opt_state, batch) → (params,
opt_state, metrics)`` for ``jax.jit``, the port's step trains the model
it was made for in place: ``train_step(opt_state, batch) → (opt_state,
metrics)``. The gradient is ``torch.autograd.grad`` of ``Model.loss_fn``
over every parameter (zeros for one the batch does not reach, as
``jax.grad`` gives); on the card it runs through the kernels'
``autograd.Function``s.

Sharded: given ``rules`` and their ``mesh``, the step runs under
``use_rules(rules, mesh)`` on a model whose parameters are DTensors
(``launch/sharding.distribute_model``). The batch goes onto the mesh by
``input_specs``' shardings, every operation runs on DTensors (a plain
tensor the model makes, such as its positions, counts as replicated),
and each gradient is laid out as its parameter (the data-parallel
all-reduce) before AdamW. Without rules nothing of this runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from ..models.config import ShapeConfig
from ..models.model import Model
from ..sharding import is_dtensor, use_rules
from .optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map

Batch = Dict[str, Any]


def _on(batch: Mapping[str, Any], device: torch.device) -> Batch:
    """The batch's arrays (NumPy or torch) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split(key: str, x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) → (n, B/n, ...); M-RoPE's (3, B, S) → (n, 3, B/n, S), as the
    reference splits them."""
    if key == "positions" and x.dim() == 3:
        return x.reshape(3, n, x.shape[1] // n, x.shape[2]).transpose(0, 1)
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _replicated(x):
    """A plain tensor as it is; a DTensor as its full value."""
    return x.full_tensor() if is_dtensor(x) else x


def _on_mesh(batch: Batch, model: Model, rules, mesh) -> Batch:
    """The batch's tensors as DTensors laid out by ``input_specs`` (every
    rank holds the whole batch and keeps its shard)."""
    from ..launch.sharding import distribute, input_specs

    B, S = batch["tokens"].shape
    _, shardings = input_specs(model.cfg, ShapeConfig("step", S, B, "train"), rules, mesh)
    return {k: distribute(v, shardings[k]) if k in shardings else v for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    remat=True, rules=None, mesh=None) -> Callable:
    """Turns grad on for the model's floating parameters and returns its
    train step. With ``grad_accum`` > 1 the batch is cut into that many
    microbatches; their grads are summed in fp32 and divided by
    ``grad_accum``, and the loss is their mean. Metrics: ``loss``,
    ``grad_norm`` and ``lr`` (plus ``tokens`` and ``aux`` without
    accumulation), detached 0-d tensors on the device. With ``rules``
    (and their ``mesh``) the step is sharded as the module docstring
    says; the metrics are then full values on every rank."""
    model.trainable()
    params = model.params()
    leaves = list(tree_leaves(params))

    def grads_of(batch):
        loss, metrics = model.loss_fn(batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else
                 g.redistribute(p.device_mesh, p.placements) if is_dtensor(g) else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def sharded(fn):
        def run(opt_state, batch):
            from torch.distributed.tensor.experimental import implicit_replication

            with use_rules(rules, mesh), implicit_replication():
                opt_state, metrics = fn(opt_state, batch)
            return opt_state, {k: _replicated(v) for k, v in metrics.items()}
        return run

    def place(batch):
        return batch if rules is None else _on_mesh(batch, model, rules, mesh)

    def train_step(opt_state, batch):
        batch = _on(batch, model.device)
        if grad_accum == 1:
            loss, metrics, grads = grads_of(place(batch))
        else:
            mbs = {k: _split(k, v, grad_accum) for k, v in batch.items()}
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(grad_accum):
                loss_i, _, g = grads_of(place({k: v[i] for k, v in mbs.items()}))
                for a, b in zip(grads, g):
                    a.add_(b)
                lsum = lsum + loss_i
            grads = [g / grad_accum for g in grads]
            loss = lsum / grad_accum
            metrics = {}
        flat = iter(grads)
        _, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, tree_map(lambda _: next(flat), params), opt_state)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step if rules is None else sharded(train_step)


def make_eval_step(model: Model) -> Callable:
    """``eval_step(batch) → metrics`` (``loss``, ``tokens``, ``aux``),
    without grad and without remat."""
    def eval_step(batch):
        with torch.no_grad():
            _, metrics = model.loss_fn(_on(batch, model.device), remat=False)
        return metrics

    return eval_step
