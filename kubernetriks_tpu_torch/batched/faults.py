"""Fault domains: the scenario fleet's typed query outcomes, the streaming
feeder's producer death carried to the engine with its slab, and the
deterministic host-fault injector.

Own copy of the JAX package's `batched/faults.py`: the `QueryError`
family (:55-141: `QueryError`, `RejectedError`, `DeadlineExceededError`,
`ShutdownError`; the wave-aligned fleet's outcomes, batched/fleet.py),
`FeederProducerError` (:144), `InjectedFeederKill` (:166) and `HostChaos`
(:177-314). The lane-asynchronous fleet's `LaneFaultError` and
`FeederError` come with it (ROADMAP Queue 1 item 13b).

`HostChaos` draws its decisions from the chaos engine's counter-based
threefry (chaos.object_uniforms) on the reference's host feeder stream,
disjoint from the device streams (1-3), so a seed replays the same fault
schedule on every run. It keeps the reference's feeder channel alone,
which the stream feeder's producer calls; the dispatch and stall channels
serve the lane-asynchronous fleet's pump (item 13b). Its counters live
under its lock, and the derivation runs outside it.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from kubernetriks_tpu_torch import chaos as _chaos

# The reference's host chaos stream of the feeder, disjoint from the
# device's (STREAM_NODE=1, STREAM_GROUP=2, STREAM_POD=3 in chaos.py).
STREAM_HOST_FEEDER = 12


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


class InjectedFeederKill(RuntimeError):
    """Raised inside the stream feeder's producer thread by HostChaos."""


_CHAOS_DEFAULTS = dict(seed=7, feeder=0.05)
# The reference's dispatch and stall channels: their caller is the
# lane-asynchronous fleet's pump (ROADMAP Queue 1 item 13b), so a spec that
# sets them is refused.
_FLEET_KEYS = ("dispatch", "stall", "stall_ms")


class HostChaos:
    """Counter-seeded host-fault injector: the feeder channel, one draw a
    slab built, from its own (stream, counter) sequence, so the schedule
    is a function of the seed and the call sequence alone, whatever the
    threads' timing."""

    def __init__(self, seed: int = 7, *, feeder_rate: float = 0.0) -> None:
        self.seed = int(seed)
        self.feeder_rate = float(feeder_rate)
        self._lock = threading.Lock()
        self._counter = 0
        self.events: Dict[str, int] = {"draws": 0, "feeder_kills": 0}

    @classmethod
    def from_flag(cls, spec: Optional[str]) -> Optional["HostChaos"]:
        """From a KTPU_HOST_CHAOS value: None or a false value is None
        (injection off); '1' / 'true' / 'on' the defaults; otherwise a
        'k=v,k=v' spec with keys seed and feeder. The reference's dispatch
        and stall keys (dispatch, stall, stall_ms) raise: they serve the
        lane-asynchronous fleet (ROADMAP Queue 1 item 13b)."""
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
                if key in _FLEET_KEYS:
                    raise ValueError(
                        f"KTPU_HOST_CHAOS: {key!r} is the lane-asynchronous fleet's channel, which the port "
                        "does not have yet (ROADMAP Queue 1 item 13b); only seed and feeder are read"
                    )
                if key not in _CHAOS_DEFAULTS:
                    raise ValueError(f"KTPU_HOST_CHAOS: unknown key {key!r} (expected one of {sorted(_CHAOS_DEFAULTS)})")
                params[key] = float(value)
        return cls(seed=int(params["seed"]), feeder_rate=params["feeder"])

    def feeder_kill(self) -> bool:
        """One draw a slab built (from the producer thread)."""
        if self.feeder_rate <= 0.0:
            return False
        with self._lock:
            counter = self._counter
            self._counter += 1
            self.events["draws"] += 1
        u, _ = _chaos.object_uniforms(self.seed, STREAM_HOST_FEEDER, 0, 0, counter)
        hit = float(u) < self.feeder_rate
        if hit:
            with self._lock:
                self.events["feeder_kills"] += 1
        return hit

    def report(self) -> Dict:
        with self._lock:
            events = dict(self.events)
        return {"seed": self.seed, "rates": {"feeder": self.feeder_rate}, "events": events}
