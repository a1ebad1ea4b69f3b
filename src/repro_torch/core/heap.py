"""SharedHeap — the RPCool shared-memory heap (§4.1, §5.1).

A heap is a fixed array of fixed-size pages. It stands for a CXL region:
a channel's heap holds the descriptor ring, the argument scopes and the
reply graphs in its host bytes; the KV pool's heap is the page table of
the device pool (the paged KV cache), and its host bytes hold only the
seal descriptor ring.

Page metadata kept per page:

* ``state``      FREE / USED
* ``owner``      connection id of the allocator (0 == unowned/daemon)
* ``perm``       permission word: bit SEALED ⇒ read-only for the sealing
                 process (the paper's PTE write-protect), bit NOACCESS ⇒
                 unmapped for everyone but the daemon.
* ``key``        MPK protection-key analogue assigned by the sandbox
                 manager.

Permission changes bump ``perm_epoch`` — the analogue of a TLB shootdown;
the device mirror of ``perm`` is re-pushed only after a bump. Bytes are
read and written through checked loads and stores (``read``/``write``):
the RPC plane's rings, scopes and argument graphs live in ``buf``.

The allocator is a first-fit extent allocator over pages, identical to
the reference package's, so both hand out the same page ids.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import addr as gaddr
from .errors import AllocationError, InvalidPointer, SealedPageError

# page state
FREE = 0
USED = 1

# permission bits
PERM_SEALED = 1 << 0   # write-protected for the sealing (sender) process
PERM_NOACCESS = 1 << 1  # unmapped (daemon-only)

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
                 page_size: int = DEFAULT_PAGE_SIZE, name: str = "",
                 sanitize: Optional[bool] = None):
        if num_pages <= 0 or num_pages > gaddr.MAX_PAGES:
            raise ValueError(f"num_pages out of range: {num_pages}")
        self.heap_id = heap_id
        self.num_pages = num_pages
        self.page_size = page_size
        self.name = name or f"heap{heap_id}"

        # The byte space (zero pages are not committed until touched, so
        # a KV-sized page costs host memory only where descriptors live).
        self.buf = np.zeros(num_pages * page_size, dtype=np.uint8)
        # 'B'-format view of the byte space: slice-assigning bytes into it
        # is one memcpy
        self._bytes = self.buf.data

        self.state = np.full(num_pages, FREE, dtype=np.uint8)
        self.owner = np.zeros(num_pages, dtype=np.int32)
        self.perm = np.zeros(num_pages, dtype=np.uint8)
        # Which process a seal protects against (the sender); 0 = none.
        self.seal_holder = np.zeros(num_pages, dtype=np.int64)
        self.key = np.zeros(num_pages, dtype=np.int16)  # MPK key per page

        self.perm_epoch = 0

        self._free: List[Extent] = [Extent(0, num_pages)]
        self._lock = threading.RLock()

        # Device mirror of the permission word (int32, bit0 = SEALED),
        # consumed by the sandboxed paged-attention kernel; attached by
        # serving/kv_pool and re-pushed lazily after an epoch bump.
        self._device = None
        self._device_perm = None
        self._device_dirty = False
        self._device_epoch = -1   # perm_epoch of the installed mirror

        # ShmCheck sanitizer (analysis/): ``sanitize`` True forces tracing,
        # False opts out, None attaches only when a session is active or
        # REPRO_SANITIZE is set. When off, this one reference is the
        # entire cost of the instrumentation.
        self._tracer = None
        if sanitize is not False:
            from ..analysis.runtime import maybe_attach
            self._tracer = maybe_attach(self, sanitize)

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
                    if self._tracer is not None:
                        self._tracer.on_alloc(self, start, count, owner)
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
            # unmap drops the MPK key: a cached sandbox binding over these
            # pages is void from here, even if the range is reallocated
            self.key[start : start + count] = 0
            self._insert_free(Extent(start, count))
            if self._tracer is not None:
                self._tracer.on_free(self, start, count)

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

    def used_bytes(self) -> int:
        return self.used_pages() * self.page_size

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
            if self._tracer is not None:
                self._tracer.on_protect(self, start, count, holder)

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
            if self._tracer is not None:
                self._tracer.on_unprotect(self, ranges)

    def _bump_epoch(self) -> None:
        with self._lock:
            self.perm_epoch += 1
            self._device_dirty = True

    # ------------------------------------------------------------------
    # byte access (checked loads/stores — what MMU+MPK do in hardware)
    # ------------------------------------------------------------------
    def _check_addr(self, a: int, nbytes: int) -> Tuple[int, int]:
        if gaddr.is_null(a):
            raise InvalidPointer("NULL dereference")
        if gaddr.heap_of(a) != self.heap_id:
            raise InvalidPointer(
                f"addr heap {gaddr.heap_of(a)} != {self.heap_id} ({self.name})"
            )
        off = gaddr.linear(a, self.page_size)
        if off + nbytes > self.num_pages * self.page_size:
            raise InvalidPointer(f"addr+{nbytes} past end of {self.name}")
        return off, off + nbytes

    @staticmethod
    def _payload_nbytes(data) -> int:
        if isinstance(data, (np.ndarray, memoryview)):
            return data.nbytes
        return len(data)

    def _store(self, lo: int, hi: int, data) -> None:
        """Copy ``data`` into heap bytes with one memcpy."""
        if isinstance(data, np.ndarray):
            if data.dtype != np.uint8 or data.ndim != 1:
                data = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
            self.buf[lo:hi] = data
        elif isinstance(data, memoryview):
            if data.format != "B" or data.ndim != 1:
                try:
                    data = data.cast("B")
                except TypeError:  # non-contiguous: flattening copy
                    data = bytes(data)
            self._bytes[lo:hi] = data
        else:  # bytes | bytearray
            self._bytes[lo:hi] = data

    def write(self, a: int,
              data: bytes | bytearray | memoryview | np.ndarray,
              pid: int = 0) -> None:
        lo, hi = self._check_addr(a, self._payload_nbytes(data))
        p0, p1 = lo // self.page_size, (hi - 1) // self.page_size + 1
        if p1 - p0 == 1:  # single-page access: scalar checks
            if self.state[p0] == FREE:
                raise InvalidPointer(f"write to freed page in {self.name}")
            if pid and (self.perm[p0] & PERM_SEALED) and \
                    self.seal_holder[p0] == pid:
                raise SealedPageError(
                    f"pid {pid} writing sealed page in {self.name} "
                    f"(RPC in flight — §4.5)"
                )
        else:
            sl = slice(p0, p1)
            if np.any(self.state[sl] == FREE):
                raise InvalidPointer(f"write to freed page in {self.name}")
            if pid and np.any(
                (self.perm[sl] & PERM_SEALED != 0)
                & (self.seal_holder[sl] == pid)
            ):
                raise SealedPageError(
                    f"pid {pid} writing sealed page in {self.name} "
                    f"(RPC in flight — §4.5)"
                )
        self._store(lo, hi, data)
        if self._tracer is not None:
            self._tracer.on_write(self, lo, hi, pid)

    def read(self, a: int, nbytes: int) -> np.ndarray:
        lo, hi = self._check_addr(a, nbytes)
        p0, p1 = lo // self.page_size, (hi - 1) // self.page_size + 1
        if p1 - p0 == 1:
            if self.state[p0] == FREE:
                raise InvalidPointer(f"read of freed page in {self.name}")
        elif np.any(self.state[p0:p1] == FREE):
            raise InvalidPointer(f"read of freed page in {self.name}")
        if self._tracer is not None:
            self._tracer.on_read(self, lo, hi)
        return self.buf[lo:hi]

    def write_fast(self, a: int,
                   data: bytes | bytearray | memoryview | np.ndarray) -> None:
        """Bounds-only write for freshly allocated private scopes: never
        use on pages that may be sealed or foreign."""
        lo = gaddr.linear(a, self.page_size)
        hi = lo + self._payload_nbytes(data)
        if hi > self.num_pages * self.page_size:
            raise InvalidPointer(f"write past end of {self.name}")
        self._store(lo, hi, data)
        if self._tracer is not None:
            self._tracer.on_write(self, lo, hi, 0)

    def addr_of_page(self, page: int, offset: int = 0) -> int:
        return gaddr.pack(self.heap_id, page, offset)

    # ------------------------------------------------------------------
    # device mirror (perm bits consumed by the sandboxed kernel)
    # ------------------------------------------------------------------
    def attach_device_perm(self, device: torch.device) -> None:
        """Mirror the perm word, widened to int32, on ``device``."""
        with self._lock:
            self._device = torch.device(device)
            self._device_perm = None
            self._device_epoch = -1
        self._sync_device()

    def _sync_device(self) -> torch.Tensor:
        """Re-push the mirror from a snapshot of ``perm``; returns the
        installed mirror. The flag is cleared only if no epoch bump landed
        since the snapshot: a bump from another thread during the upload
        keeps the mirror dirty, so the next ``device_perm()`` pushes it.
        A snapshot older than the installed mirror is dropped, so a slow
        upload cannot overwrite a newer one that finished first."""
        with self._lock:
            perm = self.perm.astype(np.int32)
            epoch = self.perm_epoch
        mirror = self._upload(perm)
        with self._lock:
            if epoch > self._device_epoch:
                self._device_perm = mirror
                self._device_epoch = epoch
            if self.perm_epoch == self._device_epoch:
                self._device_dirty = False
            return self._device_perm

    def _upload(self, perm: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(perm).to(self._device)

    def device_perm(self) -> torch.Tensor:
        with self._lock:
            if self._device is None:
                raise InvalidPointer(
                    f"{self.name}: no device perm mirror attached")
            if self._device_perm is not None and not self._device_dirty:
                return self._device_perm
        return self._sync_device()

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

    def __repr__(self) -> str:
        s = self.stats()
        return (
            f"<SharedHeap {self.name} pages={s['used_pages']}/{s['pages']} "
            f"sealed={s['sealed_pages']} epoch={s['perm_epoch']}>"
        )
