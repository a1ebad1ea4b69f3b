"""Production mesh construction over ``torch.distributed``.

The counterpart of ``src/repro/launch/mesh.py``. Functions, not module
constants: importing this module touches no process group. Each builds a
``DeviceMesh`` with ``init_device_mesh`` over the default process group,
which the caller has initialised with the mesh's world size.

Single pod:  (16, 16)    axes ("data", "model")          — 256 ranks
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model")   — 512 ranks

Axis roles:
  pod    DP across pods; the gradient all-reduce crosses it once a step.
  data   DP within the pod.
  model  TP/EP: attention heads, MoE experts, d_ff, vocab.
"""

from __future__ import annotations

import math
from typing import Sequence

DEFAULT_DEVICE_TYPE = "cuda"   # as every entry point (repro_torch.device)


def _mesh(shape: Sequence[int], names: Sequence[str], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    want = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise ValueError(f"a {tuple(shape)} {tuple(names)} mesh needs a process group of "
                         f"{want} ranks, the default group has {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = DEFAULT_DEVICE_TYPE):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, data: int = 1, pod: int = 1,
                   device_type: str = DEFAULT_DEVICE_TYPE):
    """A small mesh over the ranks of the process group: (pod, data,
    model) when ``pod`` > 1, else (data, model), as the reference's."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _mesh((data, model), ("data", "model"), device_type)
