"""Costing mode: the flag the reference's model code reads to unroll its
scans for an exact cost analysis.

The counterpart of ``src/repro/costing.py``, copied. XLA's
``cost_analysis()`` counts a while-loop body once, so under
``costing_mode()`` the reference unrolls its scan over blocks, its SSD
chunk recurrence and its streaming loops. The port's model code has
nothing to unroll: every layer, chunk and query block runs as its own
operators, and the dry-run's FLOP counter (``launch/dryrun.py``) sees
each of them. No module of the port reads ``is_costing()``; the flag is
kept so that the dry-run's ``--costing`` pass names the same mode.
"""

from __future__ import annotations

import contextlib
import contextvars

_costing = contextvars.ContextVar("costing_mode", default=False)


@contextlib.contextmanager
def costing_mode(enabled: bool = True):
    tok = _costing.set(enabled)
    try:
        yield
    finally:
        _costing.reset(tok)


def is_costing() -> bool:
    return _costing.get()
