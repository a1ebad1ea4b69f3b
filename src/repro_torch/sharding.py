"""Logical-axis sharding rules over ``torch.distributed`` meshes.

The counterpart of ``src/repro/sharding.py``. Model code annotates
activations with *logical* axis names (``shard(x, ("batch", "seq",
"embed"))``); a launcher installs a rule set mapping logical names to
mesh-axis names (``launch/sharding.rules_for``) together with a
``DeviceMesh`` whose ``mesh_dim_names`` are those axes. With no rules
installed every annotation is the identity, so the same model code runs
unsharded on plain tensors, as it always has.

A spec is a plain tuple with one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of names (the dim split over several mesh axes,
the first the outermost), entry for entry what the reference's
``PartitionSpec`` holds. ``to_placements`` turns a spec into DTensor
placements: a dim mapped to ``("pod", "data")`` gets ``Shard(d)`` on the
pod and the data mesh dims, which DTensor splits in mesh-dim order, pod
outermost, as ``P(("pod", "data"))`` splits it.

Under rules, ``shard`` redistributes a DTensor to its rule's placements
(``shard.redistributes`` counts those that changed a placement); a plain
tensor passes unchanged, since it lies on no mesh.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

_state = threading.local()

Rule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def current_rules() -> Optional[Dict[str, Rule]]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, Rule], mesh=None):
    """Install ``rules`` (and the ``DeviceMesh`` they name) for this
    thread; nests, and restores the outer pair on exit."""
    old_r = getattr(_state, "rules", None)
    old_m = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = old_r
        _state.mesh = old_m


def rules_context():
    """A context manager that installs the rules (and mesh) current now,
    for code that runs later in another thread: a recompute under
    ``torch.utils.checkpoint`` runs in the autograd engine's thread,
    where this thread's rules are not installed. Without rules, a no-op."""
    rules, mesh = current_rules(), current_mesh()
    return use_rules(rules, mesh) if rules is not None else contextlib.nullcontext()


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: Optional[Dict[str, Rule]] = None) -> Spec:
    """Map logical axis names to a spec. A mesh axis appears at most once
    in a spec: a later dim that maps to an axis already used drops it."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return ()
    out = []
    used = set()
    for name in axes:
        r = rules.get(name) if name is not None else None
        if r is None:
            out.append(None)
            continue
        rt = (r,) if isinstance(r, str) else tuple(r)
        rt = tuple(a for a in rt if a not in used)
        used.update(rt)
        if not rt:
            out.append(None)
        elif len(rt) == 1:
            out.append(rt[0])
        else:
            out.append(rt)
    return tuple(out)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: extent} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _entry_axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def divisible_spec(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """``spec`` with every entry whose dim does not divide its mesh
    extent (the product over its axes) replaced by ``None``, and cut or
    padded to ``len(shape)`` entries: the reference's divisibility-safe
    fallback (a size-1 decode query dim under an ``attn_q`` rule stays
    unsharded instead of failing)."""
    sizes = mesh_axis_sizes(mesh)
    safe = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is not None:
            total = 1
            for a in _entry_axes(entry):
                total *= sizes.get(a, 1)
            if not total or n % total:
                entry = None
        safe.append(entry)
    return tuple(safe)


def to_placements(spec: Spec, mesh, ndim: int) -> tuple:
    """DTensor placements over ``mesh`` for a tensor of ``ndim`` dims laid
    out by ``spec``: ``Shard(d)`` on every mesh dim that dim ``d`` maps to,
    ``Replicate()`` on the others. A dim split over several axes must
    name them in mesh order (outermost first), the only order DTensor's
    placements express."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        if d >= ndim:
            raise ValueError(f"spec {spec} has an entry for dim {d} of a {ndim}-d tensor")
        unknown = [a for a in _entry_axes(entry) if a not in names]
        if unknown:
            raise ValueError(f"spec {spec} names mesh axes {unknown} not in {names}")
        idx = [names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} of spec {spec} splits over {entry} against the "
                             f"mesh's order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return tuple(placements)


@dataclass(frozen=True)
class MeshSharding:
    """A spec on a mesh: the port's ``NamedSharding``. ``placements(ndim)``
    gives the DTensor placements of a tensor laid out by it."""
    mesh: Any
    spec: Spec

    def placements(self, ndim: int) -> tuple:
        return to_placements(self.spec, self.mesh, ndim)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x, axes: Sequence[Optional[str]]):
    """Lay out an intermediate by its logical axes: the identity without
    rules or on a plain tensor; on a DTensor under rules, a redistribute
    to the rule's placements (divisibility-safe, ``divisible_spec``), or
    the DTensor itself when its placements already match."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = divisible_spec(logical_to_spec(axes, rules), x.shape, mesh)
    placements = to_placements(spec, mesh, x.dim())
    if tuple(x.placements) == placements:
        return x
    shard.redistributes += 1
    return x.redistribute(mesh, placements)


shard.redistributes = 0


def local_call(fn, args: Sequence[Tuple[Any, Sequence[Optional[str]]]],
               out_axes: Sequence[Sequence[Optional[str]]], partial_over: Sequence[str] = ()):
    """``fn`` on each rank's local shards of the DTensor ``args``, each
    given with its logical axes. Every arg is first laid out by ``shard``
    (so a dim without a rule is whole on every rank), ``fn`` runs on the
    local tensors, and each output becomes a DTensor laid out by its
    ``out_axes``, less the logical axes that no input could shard (a dim
    that does not divide its mesh extent stays whole in and out).
    Gradients flow through ``to_local`` and ``from_local``.

    An arg replicated over a mesh dim that shards another arg (A and B/C
    of the SSD scan beside its batch- and head-sharded x, K/V heads that
    the local query heads read in part) enters each rank's share of the
    work: its gradient there is the sum over the ranks (``Partial``).
    ``partial_over`` names logical axes that ``fn`` sums over without
    gathering them (the vocab of an embedding lookup): its outputs are
    partial sums (``Partial``) over the mesh dims that shard those axes.

    Without rules, or on plain tensors, ``fn`` runs on the args as they
    are."""
    tensors = [a for a, _ in args]
    rules = current_rules()
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    if rules is None:   # a kernel's wrapper would read a DTensor's pointer
        raise RuntimeError("DTensor inputs reached a local computation without sharding "
                           "rules in this thread: install them with use_rules (a "
                           "recompute in the backward does so through rules_context)")
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    laid, dropped, summed, mesh = [], set(), set(), None
    for t, ax in args:
        mesh = t.device_mesh
        want = logical_to_spec(ax, rules)
        got = divisible_spec(want, t.shape, mesh)
        dropped.update(n for n, w, g in zip(ax, want, got) if w is not None and g is None)
        t = shard(t, ax)
        summed.update(i for i, p in enumerate(t.placements) if isinstance(p, Shard)
                      and ax[p.dim] in partial_over)
        laid.append(t)
    sharded = {i for t in laid for i, p in enumerate(t.placements) if not isinstance(p, Replicate)}
    locals_ = []
    for t in laid:
        grad_pl = [Partial() if isinstance(p, Replicate) and i in sharded else p
                   for i, p in enumerate(t.placements)]
        locals_.append(_ContiguousGrad.apply(t.to_local(grad_placements=grad_pl)))
    outs = fn(*locals_)
    single = not isinstance(outs, tuple)
    wrapped = []
    for o, ax in zip((outs,) if single else outs, out_axes):
        spec = logical_to_spec([None if n in dropped else n for n in ax], rules)
        placements = [Partial() if i in summed else p
                      for i, p in enumerate(to_placements(spec, mesh, o.dim()))]
        wrapped.append(DTensor.from_local(o, mesh, placements, run_check=False))
    return wrapped[0] if single else tuple(wrapped)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a local
    computation's gradient may come out with permuted strides, and
    DTensor's reshapes upstream view their local tensors without copying."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shard_offset(x, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's shard of DTensor ``x`` along
    ``dim``, from the mesh dims that shard it, outermost first."""
    from torch.distributed.tensor import Shard

    coord = x.device_mesh.get_coordinate()
    chunk, offset = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk //= x.device_mesh.size(i)
            offset += coord[i] * chunk
    return offset, chunk
