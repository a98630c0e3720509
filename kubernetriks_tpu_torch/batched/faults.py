"""Fault domains: the scenario fleet's typed query outcomes, the streaming
feeder's producer death carried to the engine with its slab, and the
deterministic host-fault injector.

Own copy of the JAX package's `batched/faults.py`: the `QueryError`
family (:55-141: `QueryError`, `RejectedError`, `DeadlineExceededError`,
`LaneFaultError`, `FeederError`, `ShutdownError`; the fleet's typed
outcomes, batched/fleet.py), `FeederProducerError` (:144),
`InjectedFault` (:156), `InjectedFeederKill` (:166) and `HostChaos`
(:177-314).

`HostChaos` draws its decisions from the chaos engine's counter-based
threefry (chaos.object_uniforms) on the reference's three host streams,
disjoint from the device streams (1-3), so a seed replays the same fault
schedule on every run: the dispatch channel (the lane-asynchronous
fleet's pump: an InjectedFault in place of a dispatch, its victim the
least-faulted active lane), the feeder channel (the stream feeder's
producer) and the stall channel (a sleep before a pump dispatch). Each
channel keeps its own counter under the lock, and the derivation runs
outside it.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from kubernetriks_tpu_torch import chaos as _chaos

# The reference's host chaos streams, disjoint from the device's
# (STREAM_NODE=1, STREAM_GROUP=2, STREAM_POD=3 in chaos.py).
STREAM_HOST_DISPATCH = 11
STREAM_HOST_FEEDER = 12
STREAM_HOST_STALL = 13


class QueryError(Exception):
    """A query's terminal typed outcome, streamed through the fleet's
    poll() under the same stream-once contract as a FleetResult, whose
    readout protocol it shares: `.query`, `.lane` (-1: none), `.horizon`
    and `.scenario` where known, `.ok` False and a stable `.kind`."""

    kind = "query_error"
    ok = False

    def __init__(self, query: int, message: str, *, lane: int = -1, scenario=None, horizon=None) -> None:
        super().__init__(message)
        self.query = int(query)
        self.message = message
        self.lane = int(lane)
        self.scenario = scenario
        self.horizon = horizon


class RejectedError(QueryError):
    """Refused at admission: the bounded queue was full under the 'reject'
    policy. `retry_after_s`: a back-off hint from the observed service
    times (None before any query was served)."""

    kind = "rejected"

    def __init__(self, query, message, *, retry_after_s=None, **kw) -> None:
        super().__init__(query, message, **kw)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(QueryError):
    """The query's deadline passed while it was queued: it failed without
    occupying a lane."""

    kind = "deadline_exceeded"

    def __init__(self, query, message, *, deadline_s=None, late_s=None, **kw) -> None:
        super().__init__(query, message, **kw)
        self.deadline_s = deadline_s
        self.late_s = late_s


class LaneFaultError(QueryError):
    """The occupying lane's dispatch failed: the lane was reset from the
    pristine snapshot and only this query failed."""

    kind = "lane_fault"

    def __init__(self, query, message, *, cause=None, **kw) -> None:
        super().__init__(query, message, **kw)
        # The repr, not the exception: an outcome outlives the engine.
        self.cause = cause if isinstance(cause, str) else repr(cause)


class FeederError(QueryError):
    """The stream feeder's producer died under this query's lane; carries
    the slab context of the FeederProducerError."""

    kind = "feeder"

    def __init__(self, query, message, *, slab_lo=None, restarts=None, **kw) -> None:
        super().__init__(query, message, **kw)
        self.slab_lo = slab_lo
        self.restarts = restarts


class ShutdownError(QueryError):
    """Still queued at close(): the graceful drain fails what never reached
    a lane. Also raised by submit() after close (there is no query id to
    stream it under)."""

    kind = "shutdown"


class FeederProducerError(RuntimeError):
    """The stream feeder's producer died: the slab it was building
    (`slab_lo`, payload columns [slab_lo, slab_lo + width)) crosses the
    thread boundary with the error. `stream.StreamFeeder.get_stage` raises
    it; the engine's feeder supervisor restarts the feeder or lets it
    propagate."""

    def __init__(self, message, *, slab_lo=None, width=None) -> None:
        super().__init__(message)
        self.slab_lo = slab_lo
        self.width = width


class InjectedFault(RuntimeError):
    """Raised by HostChaos at a pump dispatch in place of the dispatch;
    `.lane` names the victim, so the fleet fails that lane alone."""

    def __init__(self, message, *, lane=None) -> None:
        super().__init__(message)
        self.lane = lane


class InjectedFeederKill(RuntimeError):
    """Raised inside the stream feeder's producer thread by HostChaos."""


_CHAOS_DEFAULTS = dict(seed=7, dispatch=0.04, feeder=0.05, stall=0.03, stall_ms=2.0)


class HostChaos:
    """Counter-seeded host-fault injector: each channel draws from its own
    (stream, counter) sequence, so the schedule is a function of the seed
    and the call sequence alone, whatever the threads' timing."""

    def __init__(
        self,
        seed: int = 7,
        *,
        dispatch_rate: float = 0.0,
        feeder_rate: float = 0.0,
        stall_rate: float = 0.0,
        stall_ms: float = 2.0,
    ) -> None:
        self.seed = int(seed)
        self.dispatch_rate = float(dispatch_rate)
        self.feeder_rate = float(feeder_rate)
        self.stall_rate = float(stall_rate)
        self.stall_ms = float(stall_ms)
        self._lock = threading.Lock()
        self._counters: Dict[int, int] = {}
        self._victim_counts: Dict[int, int] = {}
        self.events: Dict[str, int] = {"draws": 0, "dispatch_faults": 0, "feeder_kills": 0, "stalls": 0}

    @classmethod
    def from_flag(cls, spec: Optional[str]) -> Optional["HostChaos"]:
        """From a KTPU_HOST_CHAOS value: None or a false value is None
        (injection off); '1' / 'true' / 'on' the defaults; otherwise a
        'k=v,k=v' spec with keys seed, dispatch, feeder, stall, stall_ms."""
        if spec is None:
            return None
        text = str(spec).strip()
        if text.lower() in ("", "0", "false", "no", "off"):
            return None
        params = dict(_CHAOS_DEFAULTS)
        if text.lower() not in ("1", "true", "yes", "on"):
            for item in text.split(","):
                item = item.strip()
                if not item:
                    continue
                if "=" not in item:
                    raise ValueError(
                        f"KTPU_HOST_CHAOS: bad item {item!r} (expected 'key=value' with keys "
                        f"{sorted(_CHAOS_DEFAULTS)}, or '1' for defaults)"
                    )
                key, _, value = item.partition("=")
                key = key.strip()
                if key not in _CHAOS_DEFAULTS:
                    raise ValueError(f"KTPU_HOST_CHAOS: unknown key {key!r} (expected one of {sorted(_CHAOS_DEFAULTS)})")
                params[key] = float(value)
        return cls(
            seed=int(params["seed"]), dispatch_rate=params["dispatch"], feeder_rate=params["feeder"],
            stall_rate=params["stall"], stall_ms=params["stall_ms"],
        )

    def _draw(self, stream: int) -> float:
        with self._lock:
            counter = self._counters.get(stream, 0)
            self._counters[stream] = counter + 1
            self.events["draws"] += 1
        u, _ = _chaos.object_uniforms(self.seed, stream, 0, 0, counter)
        return float(u)

    def dispatch_fault(self, active_lanes: Sequence[int]) -> Optional[int]:
        """One draw a dispatch; on a hit the victim is the least-faulted
        active lane (ties to the lowest index), so a shrinking active set
        does not fault the same lanes again. Returns the victim or None."""
        lanes = sorted(int(v) for v in active_lanes)
        if not lanes or self.dispatch_rate <= 0.0:
            return None
        if self._draw(STREAM_HOST_DISPATCH) >= self.dispatch_rate:
            return None
        with self._lock:
            victim = min(lanes, key=lambda v: (self._victim_counts.get(v, 0), v))
            self._victim_counts[victim] = self._victim_counts.get(victim, 0) + 1
            self.events["dispatch_faults"] += 1
        return victim

    def feeder_kill(self) -> bool:
        """One draw a slab built (from the producer thread)."""
        if self.feeder_rate <= 0.0:
            return False
        hit = self._draw(STREAM_HOST_FEEDER) < self.feeder_rate
        if hit:
            with self._lock:
                self.events["feeder_kills"] += 1
        return hit

    def stall_s(self) -> float:
        """Seconds to sleep before this dispatch (a slow lane, no failure):
        0.0 but on a hit."""
        if self.stall_rate <= 0.0:
            return 0.0
        if self._draw(STREAM_HOST_STALL) >= self.stall_rate:
            return 0.0
        with self._lock:
            self.events["stalls"] += 1
        return self.stall_ms / 1e3

    def report(self) -> Dict:
        with self._lock:
            events = dict(self.events)
        return {
            "seed": self.seed,
            "rates": {"dispatch": self.dispatch_rate, "feeder": self.feeder_rate, "stall": self.stall_rate},
            "events": events,
        }
