"""Deterministic chaos injection for the traffic plane's fault drills.

The robustness story of the paper's traffic plane (§5.4 quotas, Fig. 5
lease-lapse failover, §5.8 busy-wait backpressure) is only credible if it
survives *mixed* faults under load. This module schedules and applies
them:

* ``Fault`` — one scheduled disturbance: a *kind*, the traffic-progress
  fraction ``at`` where it fires, how long it stays active (``duration``,
  also in progress fraction; ``0`` = one-shot), and an optional
  ``target`` (a pid, an endpoint name — whatever the kind's binding
  interprets).
* ``FaultPlan`` — an ordered, **seedable** set of faults.
  ``FaultPlan.default(seed)`` covers four fault families, each jittered
  inside its own progress band so distinct seeds reorder *timing* but
  never *coverage*.
* ``ChaosInjector`` — applies the plan. It is poll-driven and clockless:
  the load generator calls ``poke(progress)`` with its own notion of
  progress (requests completed / requests planned), and the injector
  fires every due fault and reverts every expired one. Determinism
  follows: same seed + same traffic schedule → same faults at the same
  requests.

Fault kinds (``KINDS``):

``slow_handler``    server-side latency spike (the caller binds it, e.g.
                    a handler that sleeps)
``ring_stall``      a serving loop stops draining its rings (the caller
                    binds it, e.g. detach/attach the channel) — exercises
                    the bounded admission queue and typed ``Overloaded``
                    shedding
``quota_exhaust``   the orchestrator's §5.4 request quota for a client
                    drops to zero (built-in binding) — every request
                    sheds with ``E_OVERLOAD`` until reverted
``lease_lapse``     a serving pid's leases lapse (built-in binding):
                    Fig. 5a server death → balancer drops the replica
``endpoint_death``  every replica of an endpoint lapses (built-in
                    binding) — the worst case; routed calls surface
                    ``ChannelError`` until a replica re-registers

Built-in bindings need an ``Orchestrator`` (and optionally the
``ClusterRouter``) at construction; ``bind()`` overrides or adds kinds.
Firing a fault whose kind has no binding raises — a chaos plan that
silently skipped faults would pass a drill that never ran.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from .errors import ChannelError

KINDS = ("slow_handler", "ring_stall", "quota_exhaust",
         "lease_lapse", "endpoint_death")

# FaultPlan.default(): one band per fault family. Jitter moves `at`
# inside the band; bands never overlap, so every seed keeps the same
# coverage AND the same fault order.
_DEFAULT_BANDS = (
    ("slow_handler",  0.10, 0.20, 0.05),
    ("ring_stall",    0.30, 0.40, 0.08),
    ("quota_exhaust", 0.50, 0.60, 0.10),
    ("lease_lapse",   0.70, 0.80, 0.00),   # one-shot: the pid stays dead
)


@dataclass(frozen=True)
class Fault:
    kind: str
    at: float                       # progress fraction in [0, 1)
    duration: float = 0.0           # progress the fault stays active
    target: Optional[object] = None  # pid / endpoint name / kind-specific

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ChannelError(
                f"unknown fault kind {self.kind!r} (want one of {KINDS})")
        if not (0.0 <= self.at <= 1.0) or self.duration < 0.0:
            raise ChannelError(
                f"fault {self.kind}: at={self.at} duration={self.duration} "
                "must satisfy 0 <= at <= 1, duration >= 0")

    @property
    def until(self) -> float:
        return self.at + self.duration


class FaultPlan:
    """An ordered, seed-reproducible schedule of faults."""

    def __init__(self, faults: Sequence[Fault], seed: int = 0):
        self.seed = seed
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.at)

    @classmethod
    def default(cls, seed: int = 0,
                targets: Optional[Dict[str, object]] = None) -> "FaultPlan":
        """The standard mix: every fault family in
        ``_DEFAULT_BANDS``, fire points jittered inside their bands by
        ``seed``. ``targets`` maps kind → target (e.g. the pid to lapse);
        a missing entry leaves the target to the binding's default."""
        rng = random.Random(seed)
        targets = targets or {}
        faults = [
            Fault(kind, at=lo + rng.random() * (hi - lo), duration=dur,
                  target=targets.get(kind))
            for kind, lo, hi, dur in _DEFAULT_BANDS
        ]
        return cls(faults, seed=seed)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:  # pragma: no cover
        inner = ", ".join(f"{f.kind}@{f.at:.2f}" for f in self.faults)
        return f"<FaultPlan seed={self.seed} [{inner}]>"


class ChaosInjector:
    """Applies a ``FaultPlan`` as traffic progresses.

    Poll-driven: the load generator calls ``poke(progress)`` from its
    main loop; the injector fires every pending fault whose ``at`` has
    been reached and reverts every active fault whose window lapsed.
    ``finish()`` reverts anything still active (call it at the end of
    traffic, so a fault window that spans it cannot leak state into what
    follows).
    """

    def __init__(self, plan: FaultPlan,
                 orch=None, router=None):
        self.plan = plan
        self.orch = orch
        self.router = router
        self._apply: Dict[str, Callable[[Fault], None]] = {}
        self._revert: Dict[str, Callable[[Fault], None]] = {}
        self._pending: List[Fault] = list(plan)
        self._active: List[Fault] = []
        self.fired: List[Fault] = []
        self.reverted: List[Fault] = []
        self._saved_quota: Dict[int, Optional[float]] = {}
        if orch is not None:
            self._apply["quota_exhaust"] = self._quota_apply
            self._revert["quota_exhaust"] = self._quota_revert
            self._apply["lease_lapse"] = self._lapse_apply
            self._apply["endpoint_death"] = self._death_apply

    # -- bindings ------------------------------------------------------------
    def bind(self, kind: str, apply: Callable[[Fault], None],
             revert: Optional[Callable[[Fault], None]] = None) -> None:
        if kind not in KINDS:
            raise ChannelError(f"unknown fault kind {kind!r}")
        self._apply[kind] = apply
        if revert is not None:
            self._revert[kind] = revert

    def _quota_apply(self, fault: Fault) -> None:
        pid = int(fault.target)
        self._saved_quota[pid] = self.orch.request_quota(pid)
        self.orch.set_request_quota(pid, 0.0)   # shed everything

    def _quota_revert(self, fault: Fault) -> None:
        pid = int(fault.target)
        self.orch.set_request_quota(pid, self._saved_quota.pop(pid, None))

    def _kill_pid(self, pid: int) -> None:
        # stop heartbeating FIRST so the router cannot renew the lease
        # back to life between the lapse and the expiry tick
        if self.router is not None:
            self.router.mark_crashed(pid)
        self.orch.expire_leases(pid)

    def _lapse_apply(self, fault: Fault) -> None:
        self._kill_pid(int(fault.target))
        self.orch.tick()   # fire the failure callbacks now — determinism

    def _death_apply(self, fault: Fault) -> None:
        ep = self.router.resolve(str(fault.target))
        for ch in ep.chain:
            self._kill_pid(ch.server_pid)
        self.orch.tick()

    # -- the drive loop ------------------------------------------------------
    def poke(self, progress: float) -> List[Fault]:
        """Fire/revert everything due at ``progress`` ∈ [0, 1]. Returns
        the faults newly fired by this poke."""
        now_fired: List[Fault] = []
        while self._pending and self._pending[0].at <= progress:
            fault = self._pending.pop(0)
            apply = self._apply.get(fault.kind)
            if apply is None:
                raise ChannelError(
                    f"fault {fault.kind!r} fired with no binding — "
                    "bind() it (or pass orch/router for the built-ins)")
            apply(fault)
            self.fired.append(fault)
            now_fired.append(fault)
            if fault.duration > 0.0 and fault.kind in self._revert:
                self._active.append(fault)
        still = []
        for fault in self._active:
            if fault.until <= progress:
                self._revert[fault.kind](fault)
                self.reverted.append(fault)
            else:
                still.append(fault)
        self._active = still
        return now_fired

    def finish(self) -> None:
        """Revert every still-active fault (end of traffic)."""
        for fault in self._active:
            self._revert[fault.kind](fault)
            self.reverted.append(fault)
        self._active = []

    @property
    def n_fired(self) -> int:
        return len(self.fired)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"<ChaosInjector fired={len(self.fired)} "
                f"active={len(self._active)} pending={len(self._pending)}>")
