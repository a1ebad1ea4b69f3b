"""GPipe-style pipeline parallelism over the ``pod`` axis (optional).

The counterpart of ``src/repro/training/pipeline.py``. At 2 pods the
default policy is data parallelism over ``pod`` (one gradient all-reduce
of the parameters a step beats an activation handoff a microbatch for
every configuration here). Pipeline parallelism is for the regimes where
it wins: models whose per-pod parameter shards do not fit, or clusters
starved of cross-pod bandwidth.

Each rank of the ``pod`` axis holds one stage of the stack; microbatches
stream through the reference's fill/drain schedule: ``n_micro +
n_stages − 1`` ticks, each stage running its slice every tick, stage 0
injecting microbatch t while t < n_micro, each output handed to the next
stage around the ring (``dist.batch_isend_irecv``; the last stage's wraps
to stage 0, which ignores it), the last stage recording microbatch
``t − (n_stages − 1)``. The final outputs reach every rank by a broadcast
from the last stage, the values of the reference's masked ``psum``.
Bubble fraction (n_stages − 1) / (n_micro + n_stages − 1).

With one stage there is no send or receive (a backend refuses a send to
its own rank): the ring is the identity, as ``ppermute`` is. Only the
forward is ported; no gradient flows through the sends, the receives or
the broadcast (nothing in either package differentiates this function).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..sharding import is_dtensor

Params = Any


def _stage_row(a, stage: int):
    """This stage's slice of a tree (dicts, lists, tuples) whose leaves
    carry a leading stage dim: the local row of a DTensor sharded
    (``Shard(0)``) over the stage axis, or row ``stage`` of a full tensor."""
    if isinstance(a, dict):
        return {k: _stage_row(v, stage) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_stage_row(v, stage) for v in a)
    if is_dtensor(a):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage-sharded leaf must hold one stage a rank, "
                             f"its local shape is {tuple(local.shape)}")
        return local[0]
    return a[stage]


def pipeline_apply(fn_stage: Callable, x, stage_params, *, mesh,
                   axis: str = "pod", n_micro: int = 4):
    """Run ``fn_stage(x, params)`` as a GPipe pipeline over ``axis`` of
    ``mesh`` (a ``DeviceMesh``; every rank of the axis calls this).

    x: (B, ...) global batch, the same on every rank; B must be a
    multiple of ``n_micro``. stage_params: a tree whose leaves carry a
    leading stage dim, full or DTensors with ``Shard(0)`` over ``axis``.
    ``fn_stage`` must keep a microbatch's shape and dtype. Returns the
    last stage's outputs, (B, ...), on every rank."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    params_here = _stage_row(stage_params, stage)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide the batch of {B}")
    micros = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    nxt_rank = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv_rank = dist.get_global_rank(group, (stage - 1) % n_stages)
    last = n_stages - 1

    buf = torch.zeros_like(micros[0])
    outs = torch.zeros_like(micros)
    for t in range(n_micro + n_stages - 1):
        cur = micros[t] if stage == 0 and t < n_micro else buf
        y = fn_stage(cur, params_here)
        if n_stages == 1:
            buf = y
        else:
            y = y.contiguous()
            buf = torch.empty_like(y)
            for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt_rank, group),
                                                dist.P2POp(dist.irecv, buf, prv_rank, group)]):
                work.wait()
        if stage == last and t >= last:
            outs[t - last] = y
    if n_stages > 1:
        dist.broadcast(outs, src=dist.get_global_rank(group, last), group=group)
    return outs.reshape(x.shape)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
