"""The ShmCheck tracer: event recorder + race detector + invariant checkers.

The core modules call the ``on_*`` hooks below whenever a heap they own
carries a tracer (``heap._tracer is not None``); with sanitize off the
hooks never run. All state is guarded by one lock — the sanitizer
serializes bookkeeping, never the traced data plane itself.

Heaps are mapped to **spaces**: a logical address space for shadow
keying. The two replicas of a DSM link share one space (they are one
logical heap), so a page migrated across the wire keeps one identity.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from .findings import Finding, capture_stack
from .hb import RaceDetector

# heap.perm bit (mirrored from core.heap to avoid an import cycle)
_PERM_SEALED = 1 << 0


class _ScopeRec:
    __slots__ = ("uid", "space", "start", "count", "owner", "live",
                 "pooled", "gen", "created_at")

    def __init__(self, uid, space, start, count, owner, gen, created_at):
        self.uid = uid
        self.space = space
        self.start = start
        self.count = count
        self.owner = owner
        self.live = True
        self.pooled = False
        self.gen = gen
        self.created_at = created_at


class Tracer:
    """One sanitizer session: spaces, shadow state, findings."""

    def __init__(self, max_events: int = 65536):
        self._lock = threading.RLock()
        self.findings: List[Finding] = []
        self._dedup: set = set()
        self.events: deque = deque(maxlen=max_events)
        self.n_events = 0
        self._next_space = 0
        self._race = RaceDetector()
        # scope lifecycle: uid -> record (records also ride on the Scope)
        self._next_scope_uid = 0
        self._live_scopes: Dict[int, _ScopeRec] = {}
        # allocation generation per (space, page): bumped on every
        # alloc_pages covering the page — the recycled-page UAF check
        self._page_gen: Dict[Tuple[int, int], int] = {}
        # seal descriptor mirror: (space, idx) -> [state, start, count, holder]
        self._seals: Dict[Tuple[int, int], list] = {}
        self._actor_names: Dict[int, str] = {}
        # synchronization-fabric pages (stream anchors, chunk chains):
        # racy-by-design watch words, exempt from the race detector —
        # their ordering is modelled by explicit release/acquire edges
        self._sync_pages: Dict[int, set] = {}

    # ------------------------------------------------------------------
    # identity
    # ------------------------------------------------------------------
    def register_heap(self, heap) -> None:
        with self._lock:
            if getattr(heap, "_shm_space", None) is None:
                heap._shm_space = self._next_space
                self._next_space += 1

    def alias_space(self, heap, canonical) -> None:
        """Fold ``heap`` into ``canonical``'s space (DSM replicas are one
        logical heap)."""
        with self._lock:
            self.register_heap(canonical)
            heap._shm_space = canonical._shm_space

    @staticmethod
    def _space(heap) -> int:
        sp = getattr(heap, "_shm_space", None)
        return -1 if sp is None else sp

    def _actor(self) -> int:
        return threading.get_ident()

    def _actor_name(self, ident: int) -> str:
        name = self._actor_names.get(ident)
        if name is None:
            name = self._actor_names[ident] = f"T{len(self._actor_names)}"
        return name

    # ------------------------------------------------------------------
    # findings
    # ------------------------------------------------------------------
    def _report(self, rule: str, message: str, space: int = -1,
                page: int = -1,
                stack: Optional[Tuple[str, ...]] = None) -> None:
        f = Finding(rule, message, space, page,
                    capture_stack() if stack is None else stack)
        key = f.dedup_key()
        if key in self._dedup:
            return
        self._dedup.add(key)
        self.findings.append(f)

    def _event(self, *rec) -> None:
        self.n_events += 1
        self.events.append(rec)

    # ------------------------------------------------------------------
    # data plane (heap.read / heap.write / heap.write_fast)
    # ------------------------------------------------------------------
    def _data_pages(self, sp: int, lo: int, hi: int, ps: int):
        """Pages of [lo, hi) minus registered sync-fabric pages."""
        p0, p1 = lo // ps, (hi - 1) // ps + 1
        sync = self._sync_pages.get(sp)
        if sync is None:
            return range(p0, p1)
        return [p for p in range(p0, p1) if p not in sync]

    def on_write(self, heap, lo: int, hi: int, pid: int) -> None:
        sp = self._space(heap)
        with self._lock:
            actor = self._actor()
            self._event("w", sp, lo, hi, actor, pid)
            pages = self._data_pages(sp, lo, hi, heap.page_size)
            for kind, page, other in self._race.access(sp, pages, actor,
                                                       True):
                self._race_finding(heap, sp, kind, page, actor, other)

    def on_read(self, heap, lo: int, hi: int) -> None:
        sp = self._space(heap)
        with self._lock:
            actor = self._actor()
            self._event("r", sp, lo, hi, actor)
            pages = self._data_pages(sp, lo, hi, heap.page_size)
            for kind, page, other in self._race.access(sp, pages, actor,
                                                       False):
                self._race_finding(heap, sp, kind, page, actor, other)

    def sync_pages(self, heap, start: int, count: int) -> None:
        """Declare [start, start+count) synchronization fabric: stream
        anchor / chunk-chain pages whose watch words race by design.
        Cleared when the allocator recycles the pages (``on_alloc``)."""
        sp = self._space(heap)
        with self._lock:
            self._event("sync-pages", sp, start, count)
            self._sync_pages.setdefault(sp, set()).update(
                range(start, start + count))

    def _race_finding(self, heap, space, kind, page, actor, other) -> None:
        # §4.5 TOCTOU classification: a read/write race on an extent that
        # is owned (someone's scope) yet carries no seal — exactly the
        # "receiver dereferences what the sender can still mutate" hole
        # seals exist to close. Everything else is a generic race.
        unsealed = not (int(heap.perm[page]) & _PERM_SEALED)
        owned = int(heap.owner[page]) != 0
        if unsealed and owned and kind in ("read-after-write",
                                           "write-after-read"):
            rule = "SHM102"
            msg = (f"{kind} race on unsealed owned page {page}: "
                   f"{self._actor_name(actor)} vs "
                   f"{self._actor_name(other)} with no happens-before "
                   "edge — the sender can mutate what the receiver reads "
                   "(seal the scope, §4.5)")
        else:
            rule = "SHM101"
            msg = (f"{kind} race on page {page}: "
                   f"{self._actor_name(actor)} vs "
                   f"{self._actor_name(other)} with no happens-before edge")
        self._report(rule, msg, space, page)

    def checked_deref(self, heap, a: int, nbytes: int):
        """Receiver-side unsandboxed dereference: a wild pointer (NULL,
        wrong heap, freed or out-of-range extent) is a finding *and* the
        usual InvalidPointer."""
        from ..core.errors import InvalidPointer
        try:
            return heap.read(a, nbytes)
        except InvalidPointer as e:
            with self._lock:
                self._report(
                    "SHM107",
                    f"unsandboxed handler dereferenced wild pointer "
                    f"{a:#x} (+{nbytes}B): {e} — sandbox the request "
                    "(§4.4) or validate before dereferencing",
                    self._space(heap))
            raise

    def checked_deref_node(self, node, a: int, nbytes: int):
        """Fallback-transport variant: ownership fault-in happens first,
        then the checked read against the local replica."""
        from ..core.errors import InvalidPointer
        try:
            return node.read(a, nbytes)
        except (InvalidPointer, IndexError) as e:
            with self._lock:
                self._report(
                    "SHM107",
                    f"unsandboxed handler dereferenced wild pointer "
                    f"{a:#x} (+{nbytes}B) across the DSM link: {e}",
                    self._space(node.heap))
            raise

    # ------------------------------------------------------------------
    # synchronization edges
    # ------------------------------------------------------------------
    def sync_release(self, token: tuple) -> None:
        with self._lock:
            self._event("rel", token)
            self._race.release(self._actor(), token)

    def sync_acquire(self, token: tuple) -> None:
        with self._lock:
            self._event("acq", token)
            self._race.acquire(self._actor(), token)

    # ------------------------------------------------------------------
    # allocator lifecycle
    # ------------------------------------------------------------------
    def on_alloc(self, heap, start: int, count: int, owner: int) -> None:
        sp = self._space(heap)
        with self._lock:
            self._event("alloc", sp, start, count, owner)
            gen = self._page_gen
            for p in range(start, start + count):
                gen[(sp, p)] = gen.get((sp, p), 0) + 1
            # hand-off barrier: the allocator lock orders the previous
            # tenant's accesses before the new tenant's
            self._race.reset_pages(sp, range(start, start + count))
            sync = self._sync_pages.get(sp)
            if sync is not None:
                # recycled fabric pages become ordinary data again
                sync.difference_update(range(start, start + count))

    def on_free(self, heap, start: int, count: int) -> None:
        with self._lock:
            self._event("free", self._space(heap), start, count)

    def on_protect(self, heap, start: int, count: int, holder: int) -> None:
        with self._lock:
            self._event("protect", self._space(heap), start, count, holder)

    def on_unprotect(self, heap, ranges) -> None:
        with self._lock:
            self._event("unprotect", self._space(heap), tuple(ranges))

    def reset_pages(self, heap, pages: Iterable[int]) -> None:
        """DSM ownership transfer: the bulk copy orders every prior
        access on the old owner before every later access on the new."""
        with self._lock:
            pages = list(pages)
            self._event("dsm-xfer", self._space(heap), len(pages))
            self._race.reset_pages(self._space(heap), pages)

    # ------------------------------------------------------------------
    # scope lifecycle (create / destroy / pool recycle / use)
    # ------------------------------------------------------------------
    def on_scope_create(self, scope) -> None:
        sp = self._space(scope.heap)
        with self._lock:
            uid = self._next_scope_uid
            self._next_scope_uid += 1
            rec = _ScopeRec(uid, sp, scope.start_page, scope.num_pages,
                            scope.owner,
                            self._page_gen.get((sp, scope.start_page), 0),
                            capture_stack())
            self._live_scopes[uid] = rec
            scope._shm_rec = rec
            self._event("scope+", sp, scope.start_page, scope.num_pages)

    def on_scope_destroy(self, scope) -> None:
        rec = getattr(scope, "_shm_rec", None)
        if rec is None:
            return
        with self._lock:
            rec.live = False
            self._live_scopes.pop(rec.uid, None)
            self._event("scope-", rec.space, rec.start, rec.count)

    def on_pool_pop(self, scope) -> None:
        rec = getattr(scope, "_shm_rec", None)
        if rec is None:
            return
        with self._lock:
            rec.pooled = False
            self._event("pool-pop", rec.space, rec.start)
            # pool hand-off edge: the pusher's accesses happen-before
            # the popper's (the pool list is the synchronizer)
            self._race.acquire(self._actor(), ("scope", rec.uid))

    def on_pool_push(self, scope) -> None:
        rec = getattr(scope, "_shm_rec", None)
        if rec is None:
            return
        with self._lock:
            rec.pooled = True
            self._event("pool-push", rec.space, rec.start)
            self._race.release(self._actor(), ("scope", rec.uid))

    def on_scope_use(self, scope, what: str) -> None:
        """Called from Scope.alloc / Scope.view — the UAF checks."""
        rec = getattr(scope, "_shm_rec", None)
        if rec is None:
            return
        with self._lock:
            if not rec.live:
                self._report(
                    "SHM103",
                    f"{what} through a destroyed scope over pages "
                    f"[{rec.start},{rec.start + rec.count}) — its pages "
                    "may already belong to someone else",
                    rec.space, rec.start)
            elif self._page_gen.get((rec.space, rec.start), 0) != rec.gen:
                self._report(
                    "SHM103",
                    f"{what} through a stale scope: pages "
                    f"[{rec.start},{rec.start + rec.count}) were freed "
                    "and reallocated under it (recycled-page disclosure)",
                    rec.space, rec.start)
            elif rec.pooled:
                self._report(
                    "SHM103",
                    f"{what} through a scope already returned to its pool "
                    f"(pages [{rec.start},{rec.start + rec.count})): the "
                    "next pop hands these pages to another call",
                    rec.space, rec.start)

    # ------------------------------------------------------------------
    # seals
    # ------------------------------------------------------------------
    def on_seal(self, heap, idx: int, start: int, count: int,
                holder: int) -> None:
        sp = self._space(heap)
        with self._lock:
            self._seals[(sp, idx)] = ["sealed", start, count, holder]
            self._event("seal", sp, idx, start, count, holder)
            self._race.release(self._actor(), ("seal", sp, idx))

    def on_seal_check(self, heap, idx: int) -> None:
        with self._lock:
            self._race.acquire(self._actor(),
                               ("seal", self._space(heap), idx))

    def on_seal_complete(self, heap, idx: int) -> None:
        sp = self._space(heap)
        with self._lock:
            ent = self._seals.get((sp, idx))
            if ent is not None:
                ent[0] = "complete"
            self._event("seal-complete", sp, idx)
            self._race.release(self._actor(), ("sealdone", sp, idx))

    def on_seal_release(self, heap, idx: int, holder: int,
                        queued: bool) -> None:
        sp = self._space(heap)
        with self._lock:
            ent = self._seals.get((sp, idx))
            if ent is not None:
                ent[0] = "queued" if queued else "released"
            self._event("seal-release", sp, idx, queued)
            self._race.acquire(self._actor(), ("sealdone", sp, idx))

    def on_seal_flush(self, heap, idxs) -> None:
        sp = self._space(heap)
        with self._lock:
            for idx in idxs:
                ent = self._seals.get((sp, idx))
                if ent is not None:
                    ent[0] = "released"
            self._event("seal-flush", sp, len(idxs))

    def on_double_release(self, heap, idx: int, holder: int) -> None:
        with self._lock:
            self._report(
                "SHM105",
                f"double release of seal {idx} by pid {holder} — the "
                "first release already restored write permission; a "
                "second one races whoever re-sealed the pages",
                self._space(heap))

    # ------------------------------------------------------------------
    # sandboxes
    # ------------------------------------------------------------------
    def on_sandbox_enter(self, heap, key: int, start: int,
                         count: int) -> None:
        with self._lock:
            self._event("sb+", self._space(heap), key, start, count)

    def on_sandbox_exit(self, heap, key: int) -> None:
        with self._lock:
            self._event("sb-", self._space(heap), key)

    def on_sandbox_stale(self, heap, key: int, start: int,
                         count: int) -> None:
        with self._lock:
            self._report(
                "SHM108",
                f"re-entry of a stale sandbox: key {key} no longer "
                f"guards pages [{start},{start + count}) — they were "
                "freed or recycled since the sandbox was cached; honoring "
                "it would grant access to the new tenant's data",
                self._space(heap), start)

    # ------------------------------------------------------------------
    # connection close — leak checks
    # ------------------------------------------------------------------
    def on_conn_close(self, heap, client_pid: int, seals=None) -> None:
        sp = self._space(heap)
        with self._lock:
            self._event("close", sp, client_pid)
            for rec in list(self._live_scopes.values()):
                if rec.space == sp and rec.owner == client_pid and rec.live:
                    self._report(
                        "SHM104",
                        f"scope pages [{rec.start},{rec.start + rec.count})"
                        f" owned by pid {client_pid} still allocated at "
                        "connection close — destroy the scope or track it "
                        "on the connection",
                        sp, rec.start, stack=rec.created_at)
            for (s, idx), ent in self._seals.items():
                if s != sp or ent[3] != client_pid:
                    continue
                state = ent[0]
                if state in ("sealed", "complete"):
                    self._report(
                        "SHM106",
                        f"seal {idx} (pages [{ent[1]},{ent[1] + ent[2]}), "
                        f"holder {client_pid}) never released: its pages "
                        "stay write-protected after close",
                        sp, ent[1])
                elif state == "queued":
                    self._report(
                        "SHM106",
                        f"seal {idx} queued for batched release but never "
                        "flushed before close — the permission flip never "
                        "happened (call end_seal_window/flush)",
                        sp, ent[1])

    # ------------------------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            return {
                "findings": [f.to_dict() for f in self.findings],
                "n_findings": len(self.findings),
                "n_events": self.n_events,
                "n_spaces": self._next_space,
                "actors": len(self._actor_names),
            }

    def summary(self) -> str:
        with self._lock:
            if not self.findings:
                return (f"ShmCheck: clean — {self.n_events} events, "
                        f"{self._next_space} spaces, 0 findings")
            by_rule: Dict[str, int] = {}
            for f in self.findings:
                by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
            parts = ", ".join(f"{r}×{n}" for r, n in sorted(by_rule.items()))
            return (f"ShmCheck: {len(self.findings)} finding(s) "
                    f"({parts}) over {self.n_events} events")
