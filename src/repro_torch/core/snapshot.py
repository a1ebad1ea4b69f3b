"""Snapshot/restore for served endpoints — warm replicas from checkpoints.

The orchestrator (§5.4) owns pods, leases and failover; left alone, a
drained pod just lapses its lease and the service state dies with the
process. CXL heaps outlive the processes attached to them ("barely
distributed, almost persistent"), so a served channel can be
checkpointed — service state, handler registration, heap/scope/seal
metadata, stream anchors — into a portable :class:`Snapshot` and brought
back warm anywhere in the cluster:

* ``snapshot(target)`` checkpoints a served ``Channel`` (or a lifecycle
  ``Endpoint`` handle). Service state is captured via the instance's
  ``__snapshot__()`` hook when present, else by walking its attributes;
  ``GraphRef`` attributes are flattened to plain Python through the
  existing ``containers`` graph walk (``GraphRef.to_python``), and the
  whole state is TLV-encoded with ``core.serial`` — the same bytes-on-
  the-wire format the fallback transport uses, so a snapshot blob is
  portable across hosts by construction.
* ``restore(snap, pod=...)`` mints a fresh server pid + channel from the
  blob, re-registers every handler, and (optionally) registers the
  channel as a warm replica of a named router endpoint and starts a
  lifecycle ``Endpoint`` serving it.
* ``sync_state(src, dst)`` re-captures and re-applies state — the
  stop-and-copy step of live migration (``ClusterRouter.migrate``),
  run after the source quiesces so writes between the warm restore and
  the handoff are never lost.

Restore semantics: state is restored, *live wires are not*. Client
connections, in-flight futures and stream chunk-chains belong to the old
process; the router's failover contract (generation bump → re-wire /
``RoutedRpcStream``'s documented mid-stream ``ChannelError``) is how
traffic moves over.

A blob names its service class by import path (``module:qualname``), so
it restores under the package that took it.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import serial
from .channel import Channel
from .errors import ChannelError
from .orchestrator import Orchestrator

SNAPSHOT_VERSION = 1

# -- type-preserving state encoding ------------------------------------------
# ``core.serial`` is the wire format: dict keys coerce to str, tuples
# land as lists, bools as ints. Fine for RPC payloads, lossy for service
# *state* (a KV dict keyed by ints must restore keyed by ints). Snapshot
# blobs therefore pack state into a tagged tree of serial-safe values
# first, so the round-trip is exact without touching the wire format.

_SCALARS = (int, float, str, bytes)


def _pack(obj: Any):
    if obj is None:
        return ["n"]
    if isinstance(obj, bool):
        return ["b", int(obj)]
    if isinstance(obj, _SCALARS):
        return ["v", obj]
    if isinstance(obj, bytearray):
        return ["v", bytes(obj)]
    if isinstance(obj, list):
        return ["l", [_pack(x) for x in obj]]
    if isinstance(obj, tuple):
        return ["t", [_pack(x) for x in obj]]
    if isinstance(obj, (set, frozenset)):
        return ["s", [_pack(x) for x in sorted(obj, key=repr)]]
    if isinstance(obj, dict):
        return ["d", [[_pack(k), _pack(v)] for k, v in obj.items()]]
    raise TypeError(f"snapshot cannot capture {type(obj).__name__}")


def _unpack(node):
    tag = node[0]
    if tag == "n":
        return None
    if tag == "b":
        return bool(node[1])
    if tag == "v":
        return node[1]
    if tag == "l":
        return [_unpack(x) for x in node[1]]
    if tag == "t":
        return tuple(_unpack(x) for x in node[1])
    if tag == "s":
        return set(_unpack(x) for x in node[1])
    if tag == "d":
        return {_unpack(k): _unpack(v) for k, v in node[1]}
    raise ChannelError(f"corrupt snapshot state tag {tag!r}")


def _class_path(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _load_class(path: str) -> type:
    mod_name, _, qualname = path.partition(":")
    obj: Any = importlib.import_module(mod_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _capture_state(instance) -> Tuple[Dict[str, Any], List[str]]:
    """The instance's serializable state + the attribute names that were
    skipped (not TLV-encodable, recorded so restore is never silently
    lossy). ``GraphRef`` attributes flatten through the containers graph
    walk; a ``__snapshot__()`` hook overrides the default walk."""
    if hasattr(instance, "__snapshot__"):
        return dict(instance.__snapshot__()), []
    from .marshal import GraphRef
    state: Dict[str, Any] = {}
    skipped: List[str] = []
    for key, val in vars(instance).items():
        if isinstance(val, GraphRef):
            # heap-resident argument graph -> plain Python (§5.6 copy-out)
            state[key] = val.to_python()
            continue
        try:
            _pack(val)
        except (TypeError, ValueError):
            skipped.append(key)
        else:
            state[key] = val
    return state, skipped


def _apply_state(instance, state: Dict[str, Any]) -> None:
    if hasattr(instance, "__restore__"):
        instance.__restore__(dict(state))
    else:
        instance.__dict__.update(state)


def sync_state(src_instance, dst_instance) -> int:
    """Stop-and-copy: re-capture ``src_instance``'s state and apply it to
    ``dst_instance``. Returns the number of attributes synced."""
    state, _ = _capture_state(src_instance)
    _apply_state(dst_instance, state)
    return len(state)


@dataclass
class Snapshot:
    """A portable checkpoint of a served channel.

    ``blob`` is the TLV-encoded service state; ``meta`` records the
    channel shape (heap geometry, fn ids, scope/seal/stream anchors) the
    restore rebuilds against. ``to_bytes``/``from_bytes`` round-trip the
    whole thing through ``core.serial`` for cross-host portability;
    in-process restores reuse the captured class/interceptors directly.
    """

    cls_path: str
    blob: bytes
    meta: Dict[str, Any]
    skipped: List[str] = field(default_factory=list)
    # in-process fast path (not part of the portable bytes)
    _cls: Optional[type] = None
    _interceptors: Tuple = ()

    @property
    def service(self) -> str:
        return self.meta.get("service", "")

    def instantiate(self):
        """A fresh instance carrying the snapshot state (no channel)."""
        cls = self._cls if self._cls is not None \
            else _load_class(self.cls_path)
        inst = cls.__new__(cls)
        _apply_state(inst, _unpack(serial.decode(self.blob)))
        return inst

    def to_bytes(self) -> bytes:
        return serial.encode([SNAPSHOT_VERSION, self.cls_path, self.blob,
                              self.meta, list(self.skipped)])

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Snapshot":
        version, cls_path, blob, meta, skipped = serial.decode(raw)
        if version != SNAPSHOT_VERSION:
            raise ChannelError(
                f"snapshot version {version} not supported "
                f"(this build reads v{SNAPSHOT_VERSION})")
        return cls(cls_path, blob, meta, list(skipped))


def _resolve_channel(target) -> Channel:
    if isinstance(target, Channel):
        return target
    channels = getattr(target, "channels", None)  # lifecycle Endpoint
    if channels:
        return channels[0]
    channel = getattr(target, "channel", None)    # EndpointRecord
    if isinstance(channel, Channel):
        return channel
    raise ChannelError(
        f"snapshot() wants a served Channel or an Endpoint handle, "
        f"got {type(target).__name__}")


def snapshot(target) -> Snapshot:
    """Checkpoint a served channel into a portable :class:`Snapshot`."""
    ch = _resolve_channel(target)
    instance = ch.served_instance
    if instance is None:
        raise ChannelError(
            f"channel {ch.name!r} serves no @service instance — only "
            "served channels can be snapshotted")
    state, skipped = _capture_state(instance)
    blob = serial.encode(_pack(state))
    heaps = {id(c.heap): c.heap for c in ch.connections}
    meta: Dict[str, Any] = {
        "channel": ch.name,
        "service": ch.served_def.name if ch.served_def is not None else "",
        "server_pid": ch.server_pid,
        "heap_pages": ch.heap_pages,
        "page_size": ch.page_size,
        "shared_heap": ch.shared_heap,
        "fn_ids": sorted(ch.functions),
        # observability anchors: what was live at checkpoint time. The
        # wires themselves are not restored (see module docstring).
        "connections": len(ch.connections),
        "pages_used": sum(h.used_pages() for h in heaps.values()),
        "live_streams": [
            {"seq": st.seq, "done": bool(st.done)} for st in ch._streams],
    }
    return Snapshot(_class_path(type(instance)), blob, meta,
                    skipped, _cls=type(instance),
                    _interceptors=ch.serve_interceptors)


@dataclass
class RestoredEndpoint:
    """What ``restore`` hands back: the fresh channel + instance, plus
    the lifecycle handle when ``start=True`` asked for a serve loop."""

    channel: Channel
    instance: Any
    server_pid: int
    endpoint_name: Optional[str] = None
    lifecycle: Optional[Any] = None

    def close(self) -> None:
        if self.lifecycle is not None:
            self.lifecycle.close()
        else:
            self.channel.destroy()


def _fresh_channel_name(orch: Orchestrator, base: str) -> str:
    if base not in orch.channels:
        return base
    n = 1
    while f"{base}~r{n}" in orch.channels:
        n += 1
    return f"{base}~r{n}"


def restore(snap: Snapshot, pod: Optional[str] = None, *,
            router=None, orch: Optional[Orchestrator] = None,
            name: Optional[str] = None,
            server_pid: Optional[int] = None,
            interceptors: Optional[Tuple] = None,
            start: bool = True,
            config=None) -> RestoredEndpoint:
    """Bring a snapshot back as a warm replica.

    ``router`` + ``name`` register the fresh channel under a router
    endpoint (appending to its replica chain); ``orch`` alone restores a
    bare channel. ``pod`` places the new server pid in a coherence
    domain; ``start=True`` serves it from a lifecycle ``Endpoint``
    handle immediately, so the replica is warm before any handoff.
    """
    if router is not None and orch is None:
        orch = router.orch
    if orch is None:
        raise ChannelError("restore() needs router= or orch=")
    pid = orch.alloc_pid() if server_pid is None else server_pid
    ch_name = _fresh_channel_name(orch, snap.meta["channel"])
    ch = Channel(orch, ch_name, pid,
                 heap_pages=snap.meta["heap_pages"],
                 page_size=snap.meta["page_size"],
                 shared_heap=snap.meta["shared_heap"],
                 config=config)
    inst = snap.instantiate()
    itc = snap._interceptors if interceptors is None else tuple(interceptors)
    ch.serve(inst, itc)
    restored_fns = set(ch.functions)
    missing = [f for f in snap.meta["fn_ids"] if f not in restored_fns]
    if missing:
        raise ChannelError(
            f"restore of {snap.service!r} lost handlers {missing}: the "
            "snapshot was taken against a different service definition")
    if pod is not None:
        orch.assign_pod(pid, pod)
    endpoint_name = name
    if router is not None and endpoint_name is not None:
        router.register(endpoint_name, ch, pod)
    lifecycle = None
    if start:
        from .lifecycle import Endpoint
        lifecycle = Endpoint.serve(ch)
    return RestoredEndpoint(ch, inst, pid, endpoint_name, lifecycle)
