"""Vector-clock happens-before machinery for the ShmCheck race detector.

Actors are OS threads (``threading.get_ident``). Every traced heap
access ticks its actor's clock; synchronization edges are modelled as
release/acquire on named **tokens**:

* ``("req", ring, slot)``   — descriptor post (client) → load (server)
* ``("rep", ring, slot)``   — descriptor complete (server) → consume (client)
* ``("seal", space, idx)``  — seal() (sender) → is_sealed() (receiver)
* ``("sealdone", space, idx)`` — mark_complete() (receiver) → release() (sender)
* ``("chk", space, addr)``  — stream chunk publish (server) → consume (client)
* ``("cons", space, addr)`` — consumed-word store (client) → read (server)

``release`` snapshots the actor's clock into the token; ``acquire``
joins the snapshot into the acquiring actor. DSM ownership transfer is
a *barrier*: the transferred pages' shadow history is reset (the copy
itself establishes the ordering), see ``RaceDetector.reset_pages``.

Shadow state per (space, page) follows FastTrack's shape: last write
(actor, tick) plus a read map actor → tick. A new allocation of a page
resets its shadow — the heap allocator's lock is the synchronization
between tenants, and cross-tenant reuse bugs are caught by the
allocation-generation checker in the tracer, not the race detector.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple


class HBGraph:
    """Per-actor vector clocks + release/acquire token snapshots."""

    def __init__(self):
        self._vc: Dict[int, Dict[int, int]] = {}
        self._tokens: Dict[tuple, Dict[int, int]] = {}

    def clock(self, actor: int) -> Dict[int, int]:
        c = self._vc.get(actor)
        if c is None:
            c = self._vc[actor] = {actor: 0}
        return c

    def tick(self, actor: int) -> int:
        c = self.clock(actor)
        t = c.get(actor, 0) + 1
        c[actor] = t
        return t

    def release(self, actor: int, token: tuple) -> None:
        self.tick(actor)
        self._tokens[token] = dict(self.clock(actor))

    def acquire(self, actor: int, token: tuple) -> None:
        snap = self._tokens.get(token)
        c = self.clock(actor)
        if snap:
            for a, t in snap.items():
                if c.get(a, 0) < t:
                    c[a] = t
        self.tick(actor)


class RaceDetector:
    """FastTrack-style shadow memory over (space, page) cells."""

    def __init__(self):
        self.hb = HBGraph()
        # (space, page) -> [writer_actor | None, writer_tick, {reader: tick}]
        self._shadow: Dict[Tuple[int, int], list] = {}

    # -- sync edges -----------------------------------------------------
    def release(self, actor: int, token: tuple) -> None:
        self.hb.release(actor, token)

    def acquire(self, actor: int, token: tuple) -> None:
        self.hb.acquire(actor, token)

    # -- barriers -------------------------------------------------------
    def reset_pages(self, space: int, pages: Iterable[int]) -> None:
        """Forget a page's access history: allocation hand-off or DSM
        ownership transfer orders everything before against everything
        after."""
        shadow = self._shadow
        for p in pages:
            shadow.pop((space, p), None)

    # -- accesses -------------------------------------------------------
    def access(self, space: int, pages: Iterable[int], actor: int,
               is_write: bool) -> List[Tuple[str, int, int]]:
        """Record an access over ``pages``; returns the races found
        as (kind, page, other_actor) tuples."""
        clock = self.hb.clock(actor)
        tick = self.hb.tick(actor)
        races: List[Tuple[str, int, int]] = []
        shadow = self._shadow
        for p in pages:
            st = shadow.get((space, p))
            if st is None:
                st = shadow[(space, p)] = [None, 0, {}]
            w_actor, w_tick, reads = st[0], st[1], st[2]
            if is_write:
                if w_actor is not None and w_actor != actor \
                        and clock.get(w_actor, 0) < w_tick:
                    races.append(("write-write", p, w_actor))
                for r_actor, r_tick in reads.items():
                    if r_actor != actor and clock.get(r_actor, 0) < r_tick:
                        races.append(("write-after-read", p, r_actor))
                st[0], st[1] = actor, tick
                st[2] = {}
            else:
                if w_actor is not None and w_actor != actor \
                        and clock.get(w_actor, 0) < w_tick:
                    races.append(("read-after-write", p, w_actor))
                reads[actor] = tick
        return races
