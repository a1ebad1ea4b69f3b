"""Fault-tolerant checkpointing over torch tensors, in the reference's
on-disk layout (``src/repro/training/checkpoint.py``)::

    ckpt_dir/
      step_000000123/
        MANIFEST.json        tree of "leaf:i" tags, shapes/dtypes, step, extras
        arrays/0.npy ...     one file per leaf
      step_000000123.tmp/    staging dir — an atomic rename commits the step
      LATEST                 text file: last committed step

Leaves are numbered in the order ``jax.tree.flatten`` gives a nested dict
(keys sorted at every level), so a checkpoint that either package writes
restores in the other. bf16 and float8 leaves are stored as their
same-width unsigned words under the dtype name (``"bfloat16"``,
``"float8_e4m3fn"``, ``"float8_e5m2"``), as the reference's files hold
them, and rebuilt with ``Tensor.view``: no ``ml_dtypes`` needed.

  * atomicity — write to ``.tmp``, fsync, ``os.replace``; a crash mid-save
    never corrupts the latest checkpoint.
  * async     — ``save_async`` copies the tree to host memory before it
    returns and writes in a daemon thread; one write in flight at a time.
  * retention — ``keep_last`` pruning, never deleting the newest step.
  * resume    — data-pipeline state rides in the manifest's extras.
  * elastic   — a DTensor leaf is saved as its full value (``full_tensor``,
    a collective every rank joins; rank 0 writes), so the files are the
    same whatever mesh wrote them, and ``restore(shardings=)`` lays each
    leaf out on a new mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..sharding import is_dtensor
from .optimizer import tree_map

Params = Any

# torch dtype → (the reference's dtype name, the numpy dtype stored on disk,
# the torch dtype of the same width used to reach it)
_EXT_DTYPES = {
    torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8),
}
_BY_NAME = {name: (dt, store, via) for dt, (name, store, via) in _EXT_DTYPES.items()}


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    if t.dtype in _EXT_DTYPES:
        name, store, via = _EXT_DTYPES[t.dtype]
        return t.view(via).numpy().view(store), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _BY_NAME:
        dt, _, via = _BY_NAME[name]
        np_via = {torch.int16: np.int16, torch.uint8: np.uint8}[via]
        return torch.from_numpy(np.require(arr, requirements="C").view(np_via)).view(dt)
    return torch.from_numpy(np.require(arr, requirements="C"))


def _snapshot(x) -> torch.Tensor:
    """A host copy of a leaf that later in-place updates do not reach; a
    DTensor's full value."""
    if is_dtensor(x):
        x = x.detach().full_tensor()
    return torch.as_tensor(x).detach().to("cpu", copy=True)


def _distributed(leaves) -> bool:
    import torch.distributed as dist

    return any(is_dtensor(x) for x in leaves) and dist.is_initialized()


def _flatten(tree, leaves: List[Any]):
    """The tree's "leaf:i" tags (keys sorted, as ``jax.tree.flatten``
    orders a dict), appending its leaves to ``leaves`` in that order."""
    tags = {}
    for k in sorted(tree.keys()):
        v = tree[k]
        if hasattr(v, "items"):
            tags[k] = _flatten(v, leaves)
        else:
            tags[k] = f"leaf:{len(leaves)}"
            leaves.append(v)
    return tags


def _unflatten(tags, load):
    return {k: _unflatten(v, load) if isinstance(v, dict) else load(v)
            for k, v in tags.items()}


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Params,
             extras: Optional[Dict[str, Any]] = None) -> str:
        """Every rank calls it for a tree of DTensors: each joins the
        gathers, rank 0 writes, and all return once the step is committed."""
        host, shared = self._host(tree)
        path = self._write(step, host, extras or {}) if self._writer(shared) else \
            os.path.join(self.dir, f"step_{step:09d}")
        if shared:
            import torch.distributed as dist

            dist.barrier()
        return path

    def save_async(self, step: int, tree: Params,
                   extras: Optional[Dict[str, Any]] = None) -> None:
        self.wait()  # one in flight at a time
        host, shared = self._host(tree)  # snapshot before returning
        if not self._writer(shared):
            return

        def run():
            self._write(step, host, extras or {})

        self._inflight = threading.Thread(target=run, daemon=True)
        self._inflight.start()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    @staticmethod
    def _host(tree):
        """((tags, host leaves), whether the leaves lie on a mesh)."""
        leaves: List[Any] = []
        tags = _flatten(tree, leaves)
        return (tags, [_snapshot(x) for x in leaves]), _distributed(leaves)

    @staticmethod
    def _writer(shared: bool) -> bool:
        import torch.distributed as dist

        return not shared or dist.get_rank() == 0

    def _write(self, step: int, host, extras) -> str:
        tags, leaves = host
        with self._lock:
            name = f"step_{step:09d}"
            final = os.path.join(self.dir, name)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "arrays"))

            manifest = {"step": step, "treedef": tags, "leaves": {}, "extras": extras}
            for i, leaf in enumerate(leaves):
                arr, dtype_name = _to_storable(leaf)
                np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
                manifest["leaves"][str(i)] = {"shape": list(arr.shape), "dtype": dtype_name}
            mpath = os.path.join(tmp, "MANIFEST.json")
            with open(mpath, "w") as f:
                json.dump(manifest, f, default=str)
                f.flush()
                os.fsync(f.fileno())

            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)  # atomic commit
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            os.replace(os.path.join(self.dir, "LATEST.tmp"),
                       os.path.join(self.dir, "LATEST"))
            self._prune()
            return final

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(d[5:]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                s = int(f.read().strip())
            if os.path.isdir(os.path.join(self.dir, f"step_{s:09d}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device: DeviceLike = None,
                shardings: Params = None) -> Tuple[int, Params, Dict[str, Any]]:
        """(step, tree of tensors, extras) of ``step`` (default: the
        latest), the leaves on ``device`` (default: the host). With
        ``shardings`` (a tree of ``MeshSharding``s over the checkpoint's
        tree, on any mesh) each leaf becomes a DTensor laid out by its
        sharding, on the mesh's device: an elastic restore."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(base, "MANIFEST.json")) as f:
            manifest = json.load(f)

        def load_leaf(tag):
            p = tag[len("leaf:"):]
            arr = np.load(os.path.join(base, "arrays", f"{p}.npy"))
            return _from_storable(arr, manifest["leaves"][p]["dtype"])

        tree = _unflatten(manifest["treedef"], load_leaf)
        if device is not None:
            tree = tree_map(lambda a: a.to(device), tree)
        if shardings is not None:
            from ..launch.sharding import distribute

            tree = distribute(tree, shardings)
        return step, tree, manifest.get("extras", {})
