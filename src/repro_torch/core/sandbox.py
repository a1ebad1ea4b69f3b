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
re-assigns keys to the page range and bumps the permission epoch. The
sandbox temp heap and copied-in private variables are not ported.

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


class Sandbox:
    """An entered sandbox: the thread's view while processing one RPC."""

    def __init__(self, mgr: "SandboxManager", key: int, start_page: int,
                 num_pages: int, cached_hit: bool):
        self.mgr = mgr
        self.key = key
        self.start_page = start_page
        self.num_pages = num_pages
        self.cached_hit = cached_hit
        self._active = False

    # -- SB_BEGIN / SB_END ------------------------------------------------
    def __enter__(self) -> "Sandbox":
        self.mgr._activate(self)
        self._active = True
        return self

    def __exit__(self, *exc) -> None:
        self._active = False
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

class SandboxManager:
    """Per-heap sandbox bookkeeping: key assignment + the 14-slot cache."""

    def __init__(self, heap: SharedHeap):
        self.heap = heap
        # cache: (start_page, num_pages) -> key
        self._cache: Dict[Tuple[int, int], int] = {}
        self._lru: List[Tuple[int, int]] = []
        self._free_keys = list(range(FIRST_SANDBOX_KEY, NUM_KEYS))
        self._active_keys: Dict[int, int] = {}  # key -> active count
        # keys whose binding was invalidated while still ACTIVE: they
        # return to the free list on their final deactivation
        self._orphaned: set = set()
        self._tls = threading.local()
        self._lock = threading.RLock()
        # counters
        self.cache_hits = 0
        self.cache_misses = 0

    # -- entry points -------------------------------------------------------
    def enter(self, start_page: int, num_pages: int) -> Sandbox:
        """SB_BEGIN(start_addr, size) — §5.2.

        Fast path: the region already has a pre-assigned key (cached
        sandbox). Slow path: recycle a key — evict an inactive sandbox and
        reassign its key to the new page range (an epoch bump).
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
        return Sandbox(self, key, start_page, num_pages, cached_hit=cached)

    def _assign_key(self, rng: Tuple[int, int]) -> int:
        start, count = rng
        if self._free_keys:
            key = self._free_keys.pop()
        else:
            key = self._evict_one()
        # "assigning keys to pages has similar overheads as mprotect()" —
        # a key-table write + an epoch bump
        self.heap.key[start : start + count] = key
        self.heap._bump_epoch()
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
                raise SandboxViolation(
                    f"stale sandbox: key {sb.key} no longer guards pages "
                    f"[{sb.start_page},{sb.start_page + sb.num_pages})"
                )
            self._active_keys[sb.key] = self._active_keys.get(sb.key, 0) + 1
        self._tls.mask = 1 << sb.key

    def _deactivate(self, sb: Sandbox) -> None:
        with self._lock:
            self._active_keys[sb.key] -= 1
            if self._active_keys[sb.key] == 0 and \
                    sb.key in self._orphaned:
                self._orphaned.discard(sb.key)
                if sb.key not in self._free_keys:
                    self._free_keys.append(sb.key)
        self._tls.mask = (1 << KEY_PRIVATE) | (1 << KEY_SHARED)

    def in_sandbox(self) -> bool:
        return self._thread_mask() & ~((1 << KEY_PRIVATE) | (1 << KEY_SHARED)) != 0

    def check_private_access(self) -> None:
        """Touching private memory while sandboxed → SIGSEGV analogue."""
        if self.in_sandbox():
            raise SandboxViolation("private-memory access inside sandbox")
