"""Sanitizer session plumbing: how heaps find their tracer.

Sessions form a stack; a heap created while a session is active attaches
to the innermost one. Three ways in:

* ``with repro_torch.analysis.session() as shm: ...`` — scoped, explicit.
* ``SharedHeap(..., sanitize=True)`` — attaches that heap (creating an
  ambient session if none is active).
* ``REPRO_SANITIZE=1`` in the environment — every heap attaches to one
  ambient process-wide session of this package (report-only).

``SharedHeap(..., sanitize=False)`` always opts out, and with no session,
no flag and no env var, ``maybe_attach`` returns None — the zero-cost
default.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

from .tracer import Tracer

_lock = threading.Lock()
_stack: list = []          # innermost session last
_ambient: Optional[Tracer] = None


def sanitize_enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0", "false",
                                                        "False", "off")


def current() -> Optional[Tracer]:
    return _stack[-1] if _stack else None


def push(tracer: Tracer) -> None:
    with _lock:
        _stack.append(tracer)


def pop(tracer: Tracer) -> None:
    with _lock:
        if tracer in _stack:
            _stack.remove(tracer)


def _ensure_ambient() -> Tracer:
    global _ambient
    with _lock:
        if _ambient is None:
            _ambient = Tracer()
            _stack.insert(0, _ambient)  # below any scoped session
        return _ambient


def ambient() -> Optional[Tracer]:
    return _ambient


def maybe_attach(heap, sanitize: Optional[bool]) -> Optional[Tracer]:
    """Resolve the tracer a new heap should attach to (None = off)."""
    if sanitize is False:
        return None
    tr = current()
    if tr is None:
        if sanitize is not True and not sanitize_enabled():
            return None
        tr = _ensure_ambient()
    tr.register_heap(heap)
    return tr


@contextmanager
def session(max_events: int = 65536):
    """Scoped sanitizer session: heaps created inside attach to it."""
    tr = Tracer(max_events=max_events)
    push(tr)
    try:
        yield tr
    finally:
        pop(tr)
