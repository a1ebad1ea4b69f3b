"""Seals — preventing sender concurrent access to in-flight RPCs (§4.5, §5.3).

Implements the Fig. 8 protocol:

  1. sender ``seal(scope)``            → descriptor written (2), pages
                                          write-protected for sender (3)
  4. receiver ``is_sealed(idx)``       → verifies the descriptor
  6. receiver ``mark_complete(idx)``   → flips the descriptor state
  7. sender ``release(idx)``           → verifies completion (8) and
                                          restores permissions (9)

The descriptor ring lives inside the heap's byte space (a daemon-owned
page range), accessed through a NumPy structured-dtype view.

``release_batched`` amortizes the permission flip + epoch bump (the
TLB-shootdown analogue) over a batch (§5.3). ``seal`` of a range whose
previous release is still queued reactivates the old descriptor in place
with zero epoch bumps: the pages never lost their write protection.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .errors import SealViolation
from .heap import SharedHeap
from .scope import Scope

# descriptor states
S_EMPTY = 0
S_SEALED = 1
S_COMPLETE = 2
S_RELEASED = 3

# seq, start_page, num_pages, holder, state, _pad (32 bytes)
SEAL_DTYPE = np.dtype([
    ("seq", "<u8"),
    ("start", "<u4"),
    ("count", "<u4"),
    ("holder", "<u8"),
    ("state", "<u4"),
    ("pad", "<u4"),
])
SEAL_DESC_BYTES = SEAL_DTYPE.itemsize  # 32

RangeLike = Union[Scope, Tuple[int, int]]


def _as_range(region: RangeLike) -> Tuple[int, int]:
    if isinstance(region, Scope):
        return region.page_range()
    start, count = region
    return int(start), int(count)


class SealManager:
    """Per-heap seal machinery shared by a sender/receiver pair."""

    def __init__(self, heap: SharedHeap, capacity: int = 4096,
                 batch_threshold: int = 1024):
        self.heap = heap
        self.capacity = capacity
        self.batch_threshold = batch_threshold

        ring_bytes = capacity * SEAL_DESC_BYTES
        ring_pages = (ring_bytes + heap.page_size - 1) // heap.page_size
        self._ring_start = heap.alloc_pages(ring_pages, owner=0)
        base = self._ring_start * heap.page_size
        self._arr = heap.buf[base : base + ring_bytes].view(SEAL_DTYPE)
        self._state = self._arr["state"]  # field-sliced view for state flips

        self._next_seq = 1
        # Pending batched releases: [idx, seq, start, count, holder, alive].
        # ``alive`` is cleared when a fast re-seal cancels the queued release.
        self._pending: List[list] = []
        self._pending_live = 0
        self._pending_dead = 0
        # (start, count, holder) → pending entry, for the seal fast path.
        self._reusable: Dict[Tuple[int, int, int], list] = {}
        # idx → live pending entry: rejects re-releasing a queued seal.
        self._queued: Dict[int, list] = {}
        # flush generation: anything queued in generation g is released
        # once flush_gen > g (scope pools test release status in O(1))
        self.flush_gen = 0
        # counters (the reference's): seals, zero-epoch re-seals,
        # releases applied, batch flushes
        self.n_seals = 0
        self.n_fast_seals = 0
        self.n_releases = 0
        self.n_batch_flushes = 0

    # -- descriptor ring I/O ----------------------------------------------
    def _read_desc(self, idx: int) -> Tuple[int, int, int, int, int]:
        seq, start, count, holder, state, _ = \
            self._arr[idx % self.capacity].item()
        return seq, start, count, holder, state

    def _write_desc(self, idx: int, seq: int, start: int, count: int,
                    holder: int, state: int) -> None:
        self._arr[idx % self.capacity] = (seq, start, count, holder, state, 0)

    # -- sender side -----------------------------------------------------
    def seal(self, region: RangeLike, holder: int) -> int:
        """``seal()`` system call. Returns the descriptor index the sender
        attaches to the RPC."""
        start, count = _as_range(region)
        ent = self._reusable.pop((start, count, holder), None)
        if ent is not None and ent[5]:
            # the previous flight's release is still queued: the pages
            # never lost their write protection — reactivate in place
            ent[5] = False
            self._pending_live -= 1
            self._pending_dead += 1
            self._queued.pop(ent[0], None)
            if self._pending_dead >= self.batch_threshold:
                self._pending = [e for e in self._pending if e[5]]
                self._pending_dead = 0
            idx = ent[0]
            self._state[idx % self.capacity] = S_SEALED
            self.n_seals += 1
            self.n_fast_seals += 1
            if self.heap._tracer is not None:
                self.heap._tracer.on_seal(self.heap, idx, start, count,
                                          holder)
            return idx
        idx = self._next_seq
        self._next_seq += 1
        _, _, _, _, state = self._read_desc(idx)
        if state not in (S_EMPTY, S_RELEASED):
            raise SealViolation(
                f"descriptor ring full: slot of seq {idx} still in state {state}"
            )
        # Fig. 8 ordering: descriptor first (2), then lock the pages (3).
        self._write_desc(idx, idx, start, count, holder, S_SEALED)
        self.heap.protect_range(start, count, holder)
        self.n_seals += 1
        if self.heap._tracer is not None:
            self.heap._tracer.on_seal(self.heap, idx, start, count, holder)
        return idx

    def release(self, idx: int, holder: int) -> None:
        """``release()`` system call: verify completion, restore perms."""
        seq, start, count, h, state = self._read_desc(idx)
        self._check_release(idx, seq, h, holder, state)
        self._check_not_queued(idx)
        self.heap.unprotect_range(start, count)
        self._write_desc(idx, seq, start, count, h, S_RELEASED)
        self.n_releases += 1
        if self.heap._tracer is not None:
            self.heap._tracer.on_seal_release(self.heap, idx, holder,
                                              queued=False)

    def release_batched(self, idx: int, holder: int) -> bool:
        """Queue a release; flush (one epoch bump) at the batch threshold.
        Returns True if this call triggered a flush."""
        seq, start, count, h, state = self._read_desc(idx)
        self._check_release(idx, seq, h, holder, state)
        self._check_not_queued(idx)
        ent = [idx, seq, start, count, h, True]
        self._pending.append(ent)
        self._reusable[(start, count, h)] = ent
        self._queued[idx] = ent
        self._pending_live += 1
        if self.heap._tracer is not None:
            self.heap._tracer.on_seal_release(self.heap, idx, holder,
                                              queued=True)
        if self._pending_live >= self.batch_threshold:
            self.flush()
            return True
        return False

    def release_window(self, idxs, holder: int) -> int:
        """Release a whole pipeline window in ONE permission epoch (§5.3
        composed with pipelined flights): every seal of the window is
        queued, then one ``flush`` applies the batch. Each release is
        still checked on its own (completion, holder, no double release);
        only the permission flip and epoch bump are shared. Returns the
        epochs spent: 1 for the window, plus any threshold flush the
        queueing itself triggered on a huge window."""
        epochs = 0
        for idx in idxs:
            if self.release_batched(idx, holder):
                epochs += 1
        if self._pending_live:
            self.flush()
            epochs += 1
        return epochs

    def flush(self) -> None:
        """Release every pending seal with a single permission epoch."""
        if not self._pending:
            return
        live = [e for e in self._pending if e[5]]
        if live:
            self.heap.unprotect_ranges([(e[2], e[3]) for e in live])
            for idx, seq, start, count, h, _ in live:
                self._write_desc(idx, seq, start, count, h, S_RELEASED)
        self.n_releases += len(live)
        self.n_batch_flushes += 1
        if live and self.heap._tracer is not None:
            self.heap._tracer.on_seal_flush(self.heap, [e[0] for e in live])
        self._pending.clear()
        self._reusable.clear()
        self._queued.clear()
        self._pending_live = 0
        self._pending_dead = 0
        self.flush_gen += 1

    def _check_release(self, idx, seq, h, holder, state) -> None:
        if seq != idx or state == S_EMPTY:
            raise SealViolation(f"release of unknown seal {idx}")
        if h != holder:
            raise SealViolation(f"pid {holder} releasing seal held by {h}")
        if state == S_RELEASED:
            if self.heap._tracer is not None:
                self.heap._tracer.on_double_release(self.heap, idx, holder)
            raise SealViolation(f"double release of seal {idx}")
        if state != S_COMPLETE:
            # Fig. 8 step 8: verify the RPC is complete.
            raise SealViolation(
                f"release of in-flight seal {idx} (state={state}): "
                "receiver has not marked the RPC complete"
            )

    def _check_not_queued(self, idx: int) -> None:
        ent = self._queued.get(idx)
        if ent is not None and ent[5]:
            if self.heap._tracer is not None:
                self.heap._tracer.on_double_release(self.heap, idx, ent[4])
            raise SealViolation(
                f"double release of seal {idx}: already queued for "
                "batched release"
            )

    # -- receiver side ----------------------------------------------------
    def is_sealed(self, idx: int, region: Optional[RangeLike] = None) -> bool:
        """Fig. 8 step 4. Optionally checks the seal covers the expected
        region — a smaller seal would let the sender mutate the tail."""
        seq, start, count, _h, state = self._read_desc(idx)
        if seq != idx or state != S_SEALED:
            return False
        if region is not None:
            want_start, want_count = _as_range(region)
            if not (start <= want_start
                    and want_start + want_count <= start + count):
                return False
        if self.heap._tracer is not None:
            self.heap._tracer.on_seal_check(self.heap, idx)
        return True

    def mark_complete(self, idx: int) -> None:
        """Fig. 8 step 6 — receiver-only write to the descriptor."""
        seq, start, count, h, state = self._read_desc(idx)
        if seq != idx or state != S_SEALED:
            raise SealViolation(f"completing non-sealed descriptor {idx}")
        self._state[idx % self.capacity] = S_COMPLETE
        if self.heap._tracer is not None:
            self.heap._tracer.on_seal_complete(self.heap, idx)

    # -- introspection ------------------------------------------------------
    def pending_releases(self) -> int:
        return self._pending_live

    def state_of(self, idx: int) -> int:
        return int(self._state[idx % self.capacity])
