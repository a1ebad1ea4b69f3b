"""Dispatching wrappers for page gather/scatter.

The device of ``pool`` decides: a CPU tensor takes the plain PyTorch
version, and so does a ``meta`` tensor (shapes only: the dry-run's
costing, ``launch/dryrun.py``); a CUDA tensor launches the CUDA kernel
or raises.
``gather_pages.launches`` and ``scatter_pages.launches`` count kernel
launches. Scatter updates the pool in place (the TPU kernel aliases its
pool input to its output); with duplicate page ids, which write lands
is unspecified, as on the TPU.
"""

from __future__ import annotations

from .kernel import gather_pages_cuda, scatter_pages_cuda
from .ref import gather_pages_ref, scatter_pages_ref


def gather_pages(pool, pages):
    """pool: (P, W); pages: (n,) int32 → (n, W) = pool[clip(pages)]."""
    if pool.device.type == "cpu":
        return gather_pages_ref(pool, pages)
    if pool.device.type == "meta":    # no data to run a kernel on: the plain version's shapes
        return gather_pages_ref(pool, pages)
    out = gather_pages_cuda(pool, pages)
    gather_pages.launches += 1
    return out


def scatter_pages(pool, pages, buf):
    """pool[clip(pages)] = buf, in place; returns ``pool``."""
    if pool.device.type == "cpu":
        return scatter_pages_ref(pool, pages, buf)
    if pool.device.type == "meta":    # no data to run a kernel on: the plain version's shapes
        return scatter_pages_ref(pool, pages, buf)
    out = scatter_pages_cuda(pool, pages, buf)
    scatter_pages.launches += 1
    return out


gather_pages.launches = 0
scatter_pages.launches = 0
