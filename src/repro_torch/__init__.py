"""PyTorch/CUDA port of the RPCool serving data plane.

The slice ported so far serves dense GQA models (yi-9b) through a paged
KV pool that is an RPCool shared heap: prefill, write KV into pool pages,
seal them, and continuously batch decode through the sandboxed
``paged_attention`` CUDA kernel. Cross-pod handoffs move pages through
the ``scope_copy`` gather/scatter kernels.

Entry points (``build_model(cfg).init``, ``PagedKVPool``, ``ServeEngine``)
run on the card unless the caller passes ``device="cpu"``.
"""

from .convert import params_from_numpy
from .device import resolve_device

__all__ = ["params_from_numpy", "resolve_device"]
