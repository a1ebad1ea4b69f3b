"""Gradient compression for the cross-pod all-reduce: int8 with error
feedback.

The counterpart of ``src/repro/training/grad_comp.py``. At 2+ pods the
data-parallel gradient sync crosses the slow link between pods once a
step. The intra-pod reduction stays dense; only the pod-axis reduction is
compressed: int8 codes with error feedback (1-bit-Adam / PowerSGD-class
residual correction).

``compressed_psum`` runs on every rank of the ``pod`` axis's process
group (``mesh.get_group("pod")``), on each rank's local tensors:

  scale = max over ranks of max|g + e| / qmax + 1e-12   (SHARED: one
                                                   all-reduce (MAX) of the
                                                   leaves' maxima; per-rank
                                                   scales could not be
                                                   dequantized after an
                                                   integer sum)
  q = clip(round_half_even((g + e) / scale), ±qmax)   int8
  ĝ = all_reduce_sum(q) · scale / n
  e ← (g + e) − q·scale                            (error feedback)

The wire dtype is part of the result: with ``n_shards`` the codes are
summed in int8 (qmax = 127 // n_shards, so the sum cannot overflow), else
in int32, as the reference sums them. A backend that refuses that dtype
raises; nothing widens it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..sharding import is_dtensor
from .optimizer import tree_leaves, tree_map

Params = Any


def _quantize(g, err, scale=None):
    """(int8 codes, scale, new error) of ``g + err`` at ``scale``, or at
    max|g + err| / 127 + 1e-12 when not given; fp32 arithmetic, rounding
    half to even as ``jnp.round``."""
    gf = g.float() + err
    if scale is None:
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _like(x, local):
    """``local`` as ``x`` is laid out: a DTensor with x's mesh and
    placements when x is one."""
    if not is_dtensor(x):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False)


def compressed_psum(grads: Params, err_state: Params, group=None,
                    n_shards: Optional[int] = None) -> Tuple[Params, Params]:
    """int8 + error-feedback mean of ``grads`` over the ranks of ``group``
    (a ``ProcessGroup``, e.g. ``mesh.get_group("pod")``; ``None``: the
    default group). Every rank calls it with its own gradients and error
    state (trees of one structure; a DTensor leaf contributes its local
    shard). The per-leaf maxima go in one all-reduce (MAX) of a vector;
    then each leaf's codes in one all-reduce (SUM), int8 on the wire when
    ``n_shards`` is given (the group's size, so the sum fits), int32
    without. Returns (ĝ in each gradient's dtype, new fp32 error state),
    laid out as the inputs."""
    n = dist.get_world_size(group)
    qmax = float(127 // n_shards) if n_shards else 127.0
    g_leaves = [_local(g) for g in tree_leaves(grads)]
    e_leaves = [_local(e) for e in tree_leaves(err_state)]
    gfs = [g.float() + e for g, e in zip(g_leaves, e_leaves)]
    maxima = torch.stack([torch.max(torch.abs(gf)) for gf in gfs])
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=group)
    scales = maxima / qmax + 1e-12
    new_g, new_e = [], []
    for g, gf, scale in zip(g_leaves, gfs, scales):
        q = torch.clamp(torch.round(gf / scale), -qmax, qmax).to(torch.int8)
        new_e.append(gf - q.float() * scale)
        wire = q if n_shards else q.to(torch.int32)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
        new_g.append((wire.float() * scale / n).to(g.dtype))
    it_g, it_e = iter(new_g), iter(new_e)
    return (tree_map(lambda x: _like(x, next(it_g)), grads),
            tree_map(lambda x: _like(x, next(it_e)), err_state))


def init_error_state(params: Params) -> Params:
    """fp32 zeros beside every leaf, on its device (a DTensor leaf's laid
    out as it is)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def estimate_bytes(params: Params) -> Dict[str, int]:
    """Cross-pod bytes a step: dense bf16 against int8-compressed."""
    n = sum(int(p.numel()) for p in tree_leaves(params))
    return {
        "dense_bf16": 2 * n,
        "int8_ef": n,
        "reduction": 2.0,
    }
