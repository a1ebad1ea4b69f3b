"""Unified endpoint lifecycle: one handle over serve/quiesce/drain/close.

Serving a channel takes three surfaces — ``Channel.serve`` registers the
handlers, ``Channel.serve_all``/``ServerLoop`` runs the sweep thread, and
teardown is ``stop()``/``destroy()``. ``Endpoint`` folds them into one
handle with explicit states::

    SERVING ──quiesce()──▶ QUIESCED ──drain()──▶ DRAINED ──close()──▶ CLOSED
       ▲                      │
       └──────resume()────────┘

* ``quiesce()`` installs a :class:`QuiesceGate` on every channel: new
  requests shed with typed ``Overloaded`` (carrying a retry-after hint)
  while requests already admitted keep running. This is §5.4 admission
  turned into a drain valve.
* ``drain()`` waits for the serve loop to settle everything in flight —
  posted ring slots served, stream chunk-chains ended — within a bounded
  budget. The loop keeps running; ``drain`` only *watches* the rings, so
  there is never a second thread sweeping an SPSC ring.
* ``close()`` stops the loop and destroys the channels (idempotent).

``Channel.serve`` / ``serve_all`` / ``ServerLoop`` stay usable on their
own; they are what this handle drives underneath. Live migration
(``ClusterRouter.migrate``) uses exactly these states on the source
endpoint.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

from .channel import BusyWaitPolicy, Channel, R_REQ, ServerLoop
from .errors import ChannelError

# lifecycle states (string-valued for cheap debugging/reprs)
SERVING = "serving"
QUIESCED = "quiesced"
DRAINED = "drained"
CLOSED = "closed"


class QuiesceGate:
    """Admission gate that sheds *every* new request with typed
    ``Overloaded`` (+ retry-after hint) while leaving already-admitted
    work untouched. Wraps whatever gate was installed before so the
    service's own admission policy is restored on ``resume()``."""

    def __init__(self, prev=None, retry_after_s: float = 0.002):
        self.prev = prev
        self.retry_after_s = retry_after_s
        self.n_shed = 0

    def admit(self, client_pid: int, fn_id: int) -> Optional[int]:
        self.n_shed += 1
        return max(1, int(self.retry_after_s * 1e6))

    def release(self) -> None:
        # releases always belong to work admitted by the wrapped gate
        # (this gate never admits), so forward them
        if self.prev is not None:
            self.prev.release()


def _channel_busy(ch: Channel) -> bool:
    """True while the serve loop still owes work: a posted-but-unserved
    ring slot or a live stream chunk-chain."""
    if ch._streams:
        return True
    for conn in list(ch.connections):
        state = getattr(conn.ring, "state", None)
        if state is not None and bool((state == R_REQ).any()):
            return True
    return False


class Endpoint:
    """The unified serve/quiesce/drain/close handle over one or more
    channels publishing a single service instance."""

    def __init__(self, channels: Union[Channel, Sequence[Channel]],
                 instance=None, interceptors=(),
                 policy: Optional[BusyWaitPolicy] = None,
                 start: bool = True):
        chs: List[Channel] = [channels] if isinstance(channels, Channel) \
            else list(channels)
        if not chs:
            raise ChannelError("Endpoint needs at least one channel")
        self.channels = chs
        self.instance = instance
        self.interceptors = tuple(interceptors)
        self._policy = policy
        self._loop: Optional[ServerLoop] = None
        self._state = QUIESCED  # not serving until start()
        self._gates: List[QuiesceGate] = []
        self.n_shed = 0  # sheds across every quiesce window so far
        for ch in chs:
            if instance is not None and ch.served_instance is None:
                ch.serve(instance, interceptors)
            ch.lifecycle = self
        if start:
            self.start()

    @classmethod
    def serve(cls, channels: Union[Channel, Sequence[Channel]],
              instance=None, interceptors=(),
              policy: Optional[BusyWaitPolicy] = None) -> "Endpoint":
        """Register ``instance`` on the channel(s) and start serving from
        one background ``ServerLoop`` — the one-call replacement for
        ``Channel.serve`` + ``Channel.serve_all``."""
        return cls(channels, instance, interceptors, policy)

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def loop(self) -> Optional[ServerLoop]:
        return self._loop

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        names = ",".join(ch.name for ch in self.channels)
        return f"<Endpoint {names} {self._state}>"

    # -- transitions ---------------------------------------------------------
    def start(self, policy: Optional[BusyWaitPolicy] = None) -> "Endpoint":
        """(Re)start serving. Idempotent while SERVING."""
        if self._state == CLOSED:
            raise ChannelError("Endpoint is closed")
        if self._loop is None or not self._loop.running:
            self._loop = Channel.serve_all(
                self.channels, policy or self._policy)
        self._state = SERVING
        return self

    def quiesce(self, retry_after_s: Optional[float] = None) -> int:
        """Stop admitting: every channel gets a :class:`QuiesceGate`, so
        new requests shed with typed ``Overloaded`` while in-flight work
        keeps running. Returns the number of channels gated. Idempotent
        while QUIESCED/DRAINED."""
        if self._state == CLOSED:
            raise ChannelError("Endpoint is closed")
        if self._gates:
            return 0
        if retry_after_s is None:
            retry_after_s = self.channels[0].config.migrate_retry_after_s
        for ch in self.channels:
            gate = QuiesceGate(ch.admission, retry_after_s)
            ch.admission = gate
            self._gates.append(gate)
        self._state = QUIESCED
        return len(self._gates)

    def resume(self) -> "Endpoint":
        """Lift the quiesce gates and go back to SERVING."""
        if self._state == CLOSED:
            raise ChannelError("Endpoint is closed")
        for ch, gate in zip(self.channels, self._gates):
            if ch.admission is gate:  # don't clobber a newer gate
                ch.admission = gate.prev
            self.n_shed += gate.n_shed
        self._gates.clear()
        self._state = SERVING
        return self

    def drain(self, timeout_s: float = 2.0,
              poll_s: float = 200e-6) -> bool:
        """Quiesce (if not already) and wait for the serve loop to settle
        everything in flight: posted slots served, stream chains ended.
        Returns True if the endpoint went idle within ``timeout_s``.
        The serve loop keeps running — drain only watches."""
        if self._state == CLOSED:
            raise ChannelError("Endpoint is closed")
        self.quiesce()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not any(_channel_busy(ch) for ch in self.channels):
                self._state = DRAINED
                return True
            time.sleep(poll_s)
        return False

    def close(self, timeout_s: float = 2.0) -> None:
        """Stop the serve loop and destroy every channel. Draining first
        (bounded by ``timeout_s``) keeps in-flight callers from seeing a
        hard close; work still pending after the budget is aborted by
        ``Channel.destroy``. Idempotent."""
        if self._state == CLOSED:
            return
        if self._state != DRAINED:
            self.drain(timeout_s)
        for gate in self._gates:
            self.n_shed += gate.n_shed
        self._gates.clear()
        if self._loop is not None:
            self._loop.stop(join=True)
            self._loop = None
        for ch in self.channels:
            ch.lifecycle = None
            ch.destroy()
        self._state = CLOSED

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "Endpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
