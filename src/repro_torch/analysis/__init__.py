"""ShmCheck — correctness tooling for the port's shared-memory runtime.

Two prongs:

* a **dynamic sanitizer** (`tracer.Tracer`): an opt-in event recorder the
  core modules (heap/scope/seal/sandbox/channel/fallback/marshal) feed
  with data-plane accesses, lifecycle transitions and synchronization
  edges. On top of the event stream sit a vector-clock happens-before
  race detector and invariant checkers (use-after-free on recycled
  pages, leak-at-close, double seal release, wild-pointer dereference,
  §4.5 TOCTOU). Findings are deduplicated, structured and carry the
  offending stack.
* a **static pass** (`tools/lint_rules.py`, repo root): AST lint rules
  RPR001–RPR005 over the project's own idioms.

Enable the sanitizer with ``REPRO_SANITIZE=1`` (ambient, report-only),
``SharedHeap(sanitize=True)``, or a scoped ``session()``::

    from repro_torch.analysis import session
    with session() as shm:
        ...   # heaps created here are traced
    assert not shm.findings

The entire cost when disabled is one ``is not None`` check per heap
operation. Host code only (NumPy and the standard library): nothing runs
on the card. ``REPRO_SANITIZE`` is the switch of both packages; each keeps
its own ambient session.
"""

from .findings import Finding, RULES
from .runtime import maybe_attach, session, sanitize_enabled
from .tracer import Tracer

__all__ = [
    "Finding",
    "RULES",
    "Tracer",
    "maybe_attach",
    "sanitize_enabled",
    "session",
]
