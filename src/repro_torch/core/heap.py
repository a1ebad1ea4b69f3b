"""SharedHeap — the RPCool shared-memory heap (§4.1, §5.1).

A heap is a fixed array of fixed-size pages. On the GPU it is the
resident device pool (the paged KV cache) whose page layout is identical
for every process, plus this host-side byte mirror that holds the seal
descriptor ring.

Page metadata kept per page:

* ``state``      FREE / USED
* ``owner``      connection id of the allocator (0 == unowned/daemon)
* ``perm``       permission word: bit SEALED ⇒ read-only for the sealing
                 process (the paper's PTE write-protect).

Permission changes bump ``perm_epoch`` — the analogue of a TLB shootdown;
the device mirror of ``perm`` is re-pushed only after a bump.

The allocator is a first-fit extent allocator over pages, identical to
the reference package's, so both hand out the same page ids.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import addr as gaddr
from .errors import AllocationError, InvalidPointer

# page state
FREE = 0
USED = 1

# permission bits
PERM_SEALED = 1 << 0   # write-protected for the sealing (sender) process

DEFAULT_PAGE_SIZE = 4096


@dataclass
class Extent:
    start: int
    count: int

    @property
    def end(self) -> int:
        return self.start + self.count


class SharedHeap:
    """A shared-memory heap with page-granular permissions."""

    def __init__(self, heap_id: int, num_pages: int,
                 page_size: int = DEFAULT_PAGE_SIZE, name: str = ""):
        if num_pages <= 0 or num_pages > gaddr.MAX_PAGES:
            raise ValueError(f"num_pages out of range: {num_pages}")
        self.heap_id = heap_id
        self.num_pages = num_pages
        self.page_size = page_size
        self.name = name or f"heap{heap_id}"

        # The byte space (zero pages are not committed until touched, so
        # a KV-sized page costs host memory only where descriptors live).
        self.buf = np.zeros(num_pages * page_size, dtype=np.uint8)

        self.state = np.full(num_pages, FREE, dtype=np.uint8)
        self.owner = np.zeros(num_pages, dtype=np.int32)
        self.perm = np.zeros(num_pages, dtype=np.uint8)
        # Which process a seal protects against (the sender); 0 = none.
        self.seal_holder = np.zeros(num_pages, dtype=np.int64)

        self.perm_epoch = 0

        self._free: List[Extent] = [Extent(0, num_pages)]
        self._lock = threading.RLock()

        # Device mirror of the permission word (int32, bit0 = SEALED),
        # consumed by the sandboxed paged-attention kernel; attached by
        # serving/kv_pool and re-pushed lazily after an epoch bump.
        self._device = None
        self._device_perm = None
        self._device_dirty = False

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def alloc_pages(self, count: int, owner: int = 0) -> int:
        """First-fit contiguous allocation. Returns the starting page."""
        if count <= 0:
            raise AllocationError(f"bad page count {count}")
        with self._lock:
            for i, ext in enumerate(self._free):
                if ext.count >= count:
                    start = ext.start
                    if ext.count == count:
                        self._free.pop(i)
                    else:
                        ext.start += count
                        ext.count -= count
                    self.state[start : start + count] = USED
                    self.owner[start : start + count] = owner
                    self.perm[start : start + count] = 0
                    self.seal_holder[start : start + count] = 0
                    return start
            raise AllocationError(
                f"{self.name}: cannot allocate {count} contiguous pages "
                f"({self.free_pages()} free, fragmented)"
            )

    def free_extent(self, start: int, count: int) -> None:
        with self._lock:
            if np.any(self.state[start : start + count] == FREE):
                raise InvalidPointer(
                    f"double free of pages [{start},{start + count}) in {self.name}"
                )
            self.state[start : start + count] = FREE
            self.owner[start : start + count] = 0
            self.perm[start : start + count] = 0
            self.seal_holder[start : start + count] = 0
            self._insert_free(Extent(start, count))

    def _insert_free(self, ext: Extent) -> None:
        # keep the free list sorted + coalesced
        free = self._free
        lo, hi = 0, len(free)
        while lo < hi:
            mid = (lo + hi) // 2
            if free[mid].start < ext.start:
                lo = mid + 1
            else:
                hi = mid
        free.insert(lo, ext)
        if lo + 1 < len(free) and free[lo].end == free[lo + 1].start:
            free[lo].count += free[lo + 1].count
            free.pop(lo + 1)
        if lo > 0 and free[lo - 1].end == free[lo].start:
            free[lo - 1].count += free[lo].count
            free.pop(lo)

    def free_pages(self) -> int:
        return int(sum(e.count for e in self._free))

    def used_pages(self) -> int:
        return self.num_pages - self.free_pages()

    # ------------------------------------------------------------------
    # permissions (seal substrate — SealManager drives this)
    # ------------------------------------------------------------------
    def protect_range(self, start: int, count: int, holder: int) -> None:
        """Write-protect pages for ``holder`` (the sender). One epoch bump."""
        with self._lock:
            sl = slice(start, start + count)
            if np.any(self.state[sl] == FREE):
                raise InvalidPointer("sealing unallocated pages")
            self.perm[sl] |= PERM_SEALED
            self.seal_holder[sl] = holder
            self._bump_epoch()

    def unprotect_range(self, start: int, count: int) -> None:
        self.unprotect_ranges([(start, count)])

    def unprotect_ranges(self, ranges: List[Tuple[int, int]]) -> None:
        """Batched release — MANY ranges, ONE epoch bump (§5.3)."""
        with self._lock:
            for start, count in ranges:
                sl = slice(start, start + count)
                self.perm[sl] &= ~np.uint8(PERM_SEALED)
                self.seal_holder[sl] = 0
            self._bump_epoch()

    def _bump_epoch(self) -> None:
        self.perm_epoch += 1
        self._device_dirty = True

    # ------------------------------------------------------------------
    # device mirror (perm bits consumed by the sandboxed kernel)
    # ------------------------------------------------------------------
    def attach_device_perm(self, device: torch.device) -> None:
        """Mirror the perm word, widened to int32, on ``device``."""
        self._device = torch.device(device)
        self._sync_device()

    def _sync_device(self) -> None:
        self._device_perm = torch.from_numpy(
            self.perm.astype(np.int32)).to(self._device)
        self._device_dirty = False

    def device_perm(self) -> torch.Tensor:
        if self._device is None:
            raise InvalidPointer(f"{self.name}: no device perm mirror attached")
        if self._device_perm is None or self._device_dirty:
            self._sync_device()
        return self._device_perm

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {
            "heap_id": self.heap_id,
            "pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages(),
            "free_pages": self.free_pages(),
            "sealed_pages": int((self.perm & PERM_SEALED != 0).sum()),
            "perm_epoch": self.perm_epoch,
        }
