"""Central runtime configuration of the RPC plane.

One plain object holding the tuning knobs the ``Channel``/``Connection``,
``FallbackConnection`` and ``ClusterRouter`` constructors read their
*defaults* from; explicit per-call kwargs always win.

Usage::

    from repro_torch.configs import global_config
    global_config.admission_wait_s = 0.2        # process-wide default

    cfg = global_config.clone(fallback_pool_size=4)
    router = ClusterRouter(orch, config=cfg)    # scoped override

The knobs, their defaults and their ``REPRO_*`` environment overrides
are the reference package's, for every knob that something in this
package reads. ``lease_ttl_s`` is not here: nothing in either package
reads it (the orchestrator's lease TTL is its ``lease_ttl`` argument,
``DEFAULT_LEASE_TTL`` by default), and a knob nothing reads would be
accepted and do nothing, so ``clone()`` refuses it. Stdlib only:
``repro_torch.core`` imports it at module load.
"""

from __future__ import annotations

import os


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if raw is None else float(raw)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw is None else int(raw)


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes", "on")


class ReproConfig:
    """The global configuration of the repro runtime.

    Every attribute is a *default*: constructors accept the same knob as
    a kwarg and an explicitly-passed value always overrides the config.
    Attributes read ``REPRO_*`` environment variables once, at
    construction time.
    """

    def __init__(self):
        ########## Admission (§5.4 bounded admission queue) ##########
        # budget a ring-full post may park before a typed Overloaded
        self.admission_wait_s = _env_float("REPRO_ADMISSION_WAIT_S", 0.05)
        # parked posters per connection before immediate shed
        self.admission_max_waiters = _env_int(
            "REPRO_ADMISSION_MAX_WAITERS", 8)

        ########## Streaming (reply chunk chains) ##########
        # chunks pumped per stream per sweep; None = drain greedily
        self.stream_pump_burst = None

        ########## Wait policy (§5.8 adaptive busy-wait) ##########
        # fixed poll sleep in µs (None = load-adaptive), and the duty-
        # cycle window the adaptive policy estimates load over
        self.wait_fixed_sleep_us = None
        self.wait_window = _env_int("REPRO_WAIT_WINDOW", 256)

        ########## Fallback DSM transport (§5.6) ##########
        self.fallback_pages = _env_int("REPRO_FALLBACK_PAGES", 4096)
        self.fallback_link_latency_us = _env_float(
            "REPRO_FALLBACK_LINK_LATENCY_US", 3.0)
        self.fallback_ring_capacity = _env_int(
            "REPRO_FALLBACK_RING_CAPACITY", 64)
        # pooled links per pod pair (0 = private link per connection)
        self.fallback_pool_size = _env_int("REPRO_FALLBACK_POOL_SIZE", 2)
        # "rr" round-robin or "pid" sticky (pid-hashed) striping across
        # pooled links
        self.fallback_stripe = os.environ.get("REPRO_FALLBACK_STRIPE", "rr")
        # cMPI-style one-sided put/get framing for staged flights
        self.fallback_one_sided = _env_bool("REPRO_FALLBACK_ONE_SIDED", True)

        ########## Orchestrator quotas (§5.4) ##########
        # default per-engine page quota (ServeEngine); None = unlimited
        self.quota_pages = None

        ########## Live migration (snapshot/restore handoff) ##########
        # budget for the source endpoint to settle in-flight work
        self.migrate_drain_timeout_s = _env_float(
            "REPRO_MIGRATE_DRAIN_TIMEOUT_S", 2.0)
        # retry-after hint carried by Overloaded sheds while quiesced
        self.migrate_retry_after_s = _env_float(
            "REPRO_MIGRATE_RETRY_AFTER_S", 0.002)

    def clone(self, **overrides) -> "ReproConfig":
        """A copy with ``overrides`` applied; unknown names are errors."""
        cfg = ReproConfig.__new__(ReproConfig)
        cfg.__dict__.update(self.__dict__)
        for key, val in overrides.items():
            if key not in cfg.__dict__:
                raise AttributeError(f"unknown config knob: {key!r}")
            setattr(cfg, key, val)
        return cfg

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        body = ", ".join(f"{k}={v!r}" for k, v in sorted(
            self.__dict__.items()))
        return f"ReproConfig({body})"


global_config = ReproConfig()
