"""Sandboxes — MPK-analogue pointer confinement (§4.4, §5.2).

When the receiver processes a sandboxed RPC it must be able to chase native
pointers through shared memory without a wild/invalid pointer reaching its
private memory. Intel MPK gives the paper ~tens-of-ns permission switches
via the PKRU register, with the expensive part being *key assignment* to
pages (mprotect-class cost). RPCool therefore keeps up to **14 cached
sandboxes** with pre-assigned keys (16 keys − 2 reserved for private memory
and unsandboxed shared regions) and recycles keys for uncached requests.

Here a "key" is a row in a per-heap page→key table, and the PKRU word is
a thread-local permission mask. Entering a *cached* sandbox only swaps the
thread mask (O(1), like a PKRU write). Entering an *uncached* sandbox
re-assigns keys to the page range, bumps the permission epoch, rebuilds the
page bitmap and re-initializes the sandbox temp heap.

The SIGSEGV path: host-side ``check`` raises ``SandboxViolation``; the
paged-attention kernel cannot trap, so it **masks** the offending access
and counts it in its ``oob`` output, which the engine turns into an error
count — the paper's signal-to-error-reply path (§4.4).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import numpy as np

from . import addr as gaddr
from .errors import SandboxViolation
from .heap import SharedHeap, USED

NUM_KEYS = 16
KEY_PRIVATE = 0        # process private memory
KEY_SHARED = 1         # unsandboxed shared regions
FIRST_SANDBOX_KEY = 2  # keys 2..15 → 14 cached sandboxes (paper §5.2)
MAX_CACHED = NUM_KEYS - FIRST_SANDBOX_KEY


class _TempHeap:
    """Bump allocator for in-sandbox ``malloc`` redirection (§5.2);
    contents are lost on exit."""

    def __init__(self, size: int):
        self.buf = np.empty(size, dtype=np.uint8)
        self.bump = 0

    def reset(self) -> None:
        # pages are recycled, not scrubbed: allocations never read first
        self.bump = 0

    def alloc(self, n: int) -> memoryview:
        off = (self.bump + 7) & ~7
        if off + n > len(self.buf):
            raise SandboxViolation("sandbox temp heap exhausted")
        self.bump = off + n
        return memoryview(self.buf[off : off + n])


class Sandbox:
    """An entered sandbox: the thread's view while processing one RPC."""

    def __init__(self, mgr: "SandboxManager", key: int, start_page: int,
                 num_pages: int, temp: _TempHeap, cached_hit: bool):
        self.mgr = mgr
        self.key = key
        self.start_page = start_page
        self.num_pages = num_pages
        self.temp = temp
        self.cached_hit = cached_hit
        self._vars: Dict[str, bytes] = {}
        self._active = False

    # -- SB_BEGIN / SB_END ------------------------------------------------
    def __enter__(self) -> "Sandbox":
        self.mgr._activate(self)
        self._active = True
        return self

    def __exit__(self, *exc) -> None:
        self._active = False
        self.temp.reset()  # temp-heap data is lost (§5.2)
        self.mgr._deactivate(self)

    # -- checked access (the MMU/MPK fault path) ---------------------------
    def check(self, a: int, nbytes: int = 1) -> None:
        """Validate a pointer dereference. Raises SandboxViolation (the
        SIGSEGV analogue) if it escapes the sandbox."""
        if not self._active:
            raise SandboxViolation("access through inactive sandbox")
        if gaddr.is_null(a) or gaddr.heap_of(a) != self.mgr.heap.heap_id:
            raise SandboxViolation(
                f"wild pointer {a:#x} escapes sandboxed heap"
            )
        lin = gaddr.linear(a, self.mgr.heap.page_size)
        lo = self.start_page * self.mgr.heap.page_size
        hi = (self.start_page + self.num_pages) * self.mgr.heap.page_size
        if not (lo <= lin and lin + nbytes <= hi):
            raise SandboxViolation(
                f"pointer {a:#x} (+{nbytes}) outside sandbox pages "
                f"[{self.start_page},{self.start_page + self.num_pages})"
            )

    def read(self, a: int, nbytes: int) -> np.ndarray:
        self.check(a, nbytes)
        return self.mgr.heap.read(a, nbytes)

    def malloc(self, n: int) -> memoryview:
        """libc malloc redirection — allocates from the temp heap."""
        if not self._active:
            raise SandboxViolation("malloc outside active sandbox")
        return self.temp.alloc(n)

    # -- copied-in private variables (SB_BEGIN(region, var0, var1...)) -----
    def var(self, name: str) -> bytes:
        try:
            return self._vars[name]
        except KeyError:
            raise SandboxViolation(
                f"access to private variable {name!r} not copied into sandbox"
            )

    @property
    def page_size(self) -> int:
        return self.mgr.heap.page_size

    def device_bitmap(self):
        """(num_pages,) uint8 mask for sandboxed kernels: 1 where a
        block-table dereference is permitted."""
        return self.mgr._bitmap_for(self)


class SandboxManager:
    """Per-heap sandbox bookkeeping: key assignment + the 14-slot cache."""

    def __init__(self, heap: SharedHeap, temp_heap_bytes: int = 1 << 16):
        self.heap = heap
        self.temp_heap_bytes = temp_heap_bytes
        # cache: (start_page, num_pages) -> key
        self._cache: Dict[Tuple[int, int], int] = {}
        self._lru: List[Tuple[int, int]] = []
        self._free_keys = list(range(FIRST_SANDBOX_KEY, NUM_KEYS))
        self._active_keys: Dict[int, int] = {}  # key -> active count
        # keys whose binding was invalidated while still ACTIVE: they
        # return to the free list on their final deactivation
        self._orphaned: set = set()
        self._temps: Dict[int, _TempHeap] = {}
        self._bitmaps: Dict[int, np.ndarray] = {}  # key -> page bitmap
        self._tls = threading.local()
        self._lock = threading.RLock()
        # counters
        self.cache_hits = 0
        self.cache_misses = 0

    # -- entry points -------------------------------------------------------
    def enter(self, start_page: int, num_pages: int,
              **copy_vars: bytes) -> Sandbox:
        """SB_BEGIN(start_addr, size, var0, var1, ...) — §5.2.

        Fast path: the region already has a pre-assigned key (cached
        sandbox). Slow path: recycle a key — evict an inactive sandbox,
        reassign its key to the new page range (an epoch bump), rebuild
        the bitmap and temp heap. ``copy_vars`` are copied into the temp
        heap and readable through ``Sandbox.var``.
        """
        rng = (start_page, num_pages)
        with self._lock:
            key = self._cache.get(rng)
            if key is not None and not self._still_valid(rng, key):
                # the pages were freed (and possibly recycled to another
                # owner) since the key was assigned — a stale cache hit
                # here would grant the sandbox access to whoever holds
                # those pages now. Invalidate and take the miss path.
                self._invalidate(rng, key)
                key = None
            if key is not None:
                self.cache_hits += 1
                cached = True
                self._touch(rng)
            else:
                self.cache_misses += 1
                cached = False
                key = self._assign_key(rng)
        sb = Sandbox(self, key, start_page, num_pages,
                     self._temps[key], cached_hit=cached)
        for name, v in copy_vars.items():
            buf = bytes(v)
            mv = sb.temp.alloc(len(buf))
            mv[:] = buf
            sb._vars[name] = buf
        return sb

    def _assign_key(self, rng: Tuple[int, int]) -> int:
        start, count = rng
        if self._free_keys:
            key = self._free_keys.pop()
        else:
            key = self._evict_one()
        # "assigning keys to pages has similar overheads as mprotect()" —
        # a key-table write + an epoch bump + bitmap + temp heap rebuild
        self.heap.key[start : start + count] = key
        self.heap._bump_epoch()
        bm = np.zeros(self.heap.num_pages, dtype=np.uint8)
        bm[start : start + count] = 1
        self._bitmaps[key] = bm
        self._temps[key] = _TempHeap(self.temp_heap_bytes)
        self._cache[rng] = key
        self._lru.append(rng)
        return key

    def _still_valid(self, rng: Tuple[int, int], key: int) -> bool:
        """A cached (range → key) binding is only honourable while every
        page is still allocated AND still carries the key — free/realloc
        or a key reassignment voids it."""
        start, count = rng
        sl = slice(start, start + count)
        return bool(np.all(self.heap.state[sl] == USED)
                    and np.all(self.heap.key[sl] == key))

    def _invalidate(self, rng: Tuple[int, int], key: int) -> None:
        start, count = rng
        self._cache.pop(rng, None)
        if rng in self._lru:
            self._lru.remove(rng)
        # scrub the key off any page in the range that still carries it
        sl = slice(start, start + count)
        keys = self.heap.key[sl]
        keys[keys == key] = KEY_SHARED
        if self._active_keys.get(key, 0) == 0:
            self._bitmaps.pop(key, None)
            self._temps.pop(key, None)
            if key not in self._free_keys:
                self._free_keys.append(key)
        else:
            # still active somewhere: reclaim on final deactivation —
            # dropping it here would lose the key forever (it is in
            # neither _cache nor _free_keys)
            self._orphaned.add(key)

    def _evict_one(self) -> int:
        for i, rng in enumerate(self._lru):
            key = self._cache[rng]
            if self._active_keys.get(key, 0) == 0:
                self._lru.pop(i)
                del self._cache[rng]
                start, count = rng
                # scrub only pages still carrying THIS key: a stale range
                # whose pages were recycled into another live sandbox
                # must not have that binding's key clobbered
                keys = self.heap.key[start : start + count]
                keys[keys == key] = KEY_SHARED
                return key
        raise SandboxViolation(
            "all 14 sandbox keys active; no key available to recycle"
        )

    def _touch(self, rng: Tuple[int, int]) -> None:
        self._lru.remove(rng)
        self._lru.append(rng)

    # -- PKRU analogue -------------------------------------------------------
    def _thread_mask(self) -> int:
        return getattr(self._tls, "mask", (1 << KEY_PRIVATE) | (1 << KEY_SHARED))

    def _activate(self, sb: Sandbox) -> None:
        # PKRU write: drop every key except the sandbox's (§5.2).
        with self._lock:
            rng = (sb.start_page, sb.num_pages)
            # a held Sandbox whose key was recycled to another region (or
            # whose pages were freed) must never re-enter: its key now
            # guards someone else's pages
            if self._cache.get(rng) != sb.key or \
                    not self._still_valid(rng, sb.key):
                if self.heap._tracer is not None:
                    self.heap._tracer.on_sandbox_stale(
                        self.heap, sb.key, sb.start_page, sb.num_pages)
                raise SandboxViolation(
                    f"stale sandbox: key {sb.key} no longer guards pages "
                    f"[{sb.start_page},{sb.start_page + sb.num_pages})"
                )
            self._active_keys[sb.key] = self._active_keys.get(sb.key, 0) + 1
        self._tls.mask = 1 << sb.key
        if self.heap._tracer is not None:
            self.heap._tracer.on_sandbox_enter(
                self.heap, sb.key, sb.start_page, sb.num_pages)

    def _deactivate(self, sb: Sandbox) -> None:
        with self._lock:
            self._active_keys[sb.key] -= 1
            if self._active_keys[sb.key] == 0 and \
                    sb.key in self._orphaned:
                self._orphaned.discard(sb.key)
                self._bitmaps.pop(sb.key, None)
                self._temps.pop(sb.key, None)
                if sb.key not in self._free_keys:
                    self._free_keys.append(sb.key)
        self._tls.mask = (1 << KEY_PRIVATE) | (1 << KEY_SHARED)
        if self.heap._tracer is not None:
            self.heap._tracer.on_sandbox_exit(self.heap, sb.key)

    def in_sandbox(self) -> bool:
        return self._thread_mask() & ~((1 << KEY_PRIVATE) | (1 << KEY_SHARED)) != 0

    def check_private_access(self) -> None:
        """Touching private memory while sandboxed → SIGSEGV analogue."""
        if self.in_sandbox():
            raise SandboxViolation("private-memory access inside sandbox")

    def _bitmap_for(self, sb: Sandbox) -> np.ndarray:
        return self._bitmaps[sb.key]

    def cached_regions(self) -> int:
        return len(self._cache)
