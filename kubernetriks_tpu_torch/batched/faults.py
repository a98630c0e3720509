"""The streaming feeder's fault domain: the producer's death carried to the
engine with its slab, and the deterministic host-fault injector.

Own copy of the feeder's part of the JAX package's `batched/faults.py`
(`FeederProducerError` :144, `InjectedFeederKill` :166, `HostChaos`
:177-314). The serving fleet's query outcomes (the `QueryError` family)
wait for the fleet (ROADMAP Queue 1 item 13).

`HostChaos` draws its decisions from the chaos engine's counter-based
threefry (chaos.object_uniforms) on the reference's host feeder stream,
disjoint from the device streams (1-3), so a seed replays the same fault
schedule on every run. It keeps the reference's feeder channel alone,
which the stream feeder's producer calls; the dispatch and stall channels
serve the fleet and wait for it with the QueryError family. Its counters
live under its lock, and the derivation runs outside it.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from kubernetriks_tpu_torch import chaos as _chaos

# The reference's host chaos stream of the feeder, disjoint from the
# device's (STREAM_NODE=1, STREAM_GROUP=2, STREAM_POD=3 in chaos.py).
STREAM_HOST_FEEDER = 12


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
# The reference's fleet channels: no caller in the port until the fleet
# comes (ROADMAP Queue 1 item 13), so a spec that sets them is refused.
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
        'k=v,k=v' spec with keys seed and feeder. The reference's fleet
        keys (dispatch, stall, stall_ms) raise: the port has no fleet."""
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
                        f"KTPU_HOST_CHAOS: {key!r} is the serving fleet's channel, which the port does not "
                        "have yet (ROADMAP Queue 1 item 13); only seed and feeder are read"
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
