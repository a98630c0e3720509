"""Pluggable measurement backends for the autotuner (reference
`kubernetriks_tpu/tune/measure.py`, own copy).

The search (search.py) is backend-agnostic: it hands a fully pinned
statics table to `backend.measure(statics)` and gets a `Measurement`
back; `backend.device_type` ("cuda" or "cpu") says which values it can
build. Two backends exist:

- `BenchMeasurementBackend`: the real capture path. It builds an engine
  with the candidate statics on the caller's composed traces, runs the
  bench protocol (warm-up through the first slide of the pod window, every
  window piece captured, >= 5 valid timed spans, zero-decision spans
  dropped and disclosed), reads the observatory objective
  (telemetry/observatory.tuning_objective) over the timed spans, and
  enforces the statics-only contract PER CANDIDATE: a recompile sentinel
  sealed after the warm-up (no capture in the timed spans, no growth of
  the pod window), and every candidate's final state equal to the first
  candidate's (state.compare_states) with equal committed decisions: the
  whole-grid gate. The fingerprint digests every leaf the gate holds
  exact (all but the float32 `.metrics.` accumulators, which it holds to
  rtol 1e-6 and the two cycle routes fold in different orders).

- `FakeMeasurementBackend`: pinned measurements for tests and the
  --fake line of run.py: a deterministic additive cost model (base cost
  minus a per-knob, per-value bonus table), so tests can pin the winner,
  resume behaviour and budget accounting without building engines.

The objective covers the timed spans only. The reference scores the
per-window line over the whole run, its compiles included; here the
warm-up's share would be the graph captures (seconds on the card, one
build's cost), which would rank every graphs=True candidate by its
capture time. So the report fed to tuning_objective carries the
per-window line between the seal and the end: the window-chunk and slide
host spans, their reads included, over the windows recorded between the
two (the ring drained at both ends).
"""

from __future__ import annotations

import gc
import hashlib
import json
import time
from typing import Dict, List, NamedTuple, Optional

from kubernetriks_tpu_torch.tune.knobs import validate_statics


class Measurement(NamedTuple):
    objective: float  # the score the search minimizes (lower = better)
    ms_per_window: float  # the raw per-window host cost line
    decisions_per_s: float  # median composed rate (disclosure)
    spans: Dict[str, object]  # {n, min, max, dropped, spread_frac}
    verdicts_fired: Dict[str, int]  # observatory watchdog verdicts
    fingerprint: str  # semantic digest: the exact leaves + decisions
    recompiles_after_warmup: int  # captures past the seal (must be 0)
    wall_s: float  # capture cost (disclosure only, never an input to
    #               the search, so resumed runs stay deterministic)

    def as_record(self) -> Dict[str, object]:
        return {
            "objective": round(self.objective, 4),
            "ms_per_window": round(self.ms_per_window, 4),
            "decisions_per_s": round(self.decisions_per_s, 3),
            "spans": self.spans,
            "verdicts_fired": self.verdicts_fired,
            "fingerprint": self.fingerprint,
            "recompiles_after_warmup": self.recompiles_after_warmup,
            "wall_s": round(self.wall_s, 3),
        }


def canonical_key(statics: Dict[str, object]) -> str:
    """THE candidate identity: sorted-key JSON of the full statics table.
    Resume caches, dedup and profile candidate matching all key on this,
    so a reordered dict is the same candidate."""
    return json.dumps(statics, sort_keys=True, default=str)


class FakeMeasurementBackend:
    """Deterministic pinned measurements: objective = base minus the bonus
    table's entry for each (knob, value) in the candidate. Knobs absent
    from the table contribute 0: independent contributions, so coordinate
    descent provably reaches the global optimum and tests can pin the
    winner. `device_type`: the device whose defaults the sweep starts
    from and whose buildable values it measures."""

    def __init__(
        self,
        bonuses: Optional[Dict[str, Dict[object, float]]] = None,
        base: float = 100.0,
        device_type: str = "cpu",
    ):
        self.bonuses = bonuses or {}
        self.base = float(base)
        self.device_type = device_type
        self.measure_calls: List[Dict[str, object]] = []

    def measure(self, statics: Dict[str, object]) -> Measurement:
        validate_statics(statics, self.device_type)
        self.measure_calls.append(dict(statics))
        cost = self.base
        for name, value in statics.items():
            table = self.bonuses.get(name)
            if table:
                cost -= float(table.get(value, 0.0))
        if cost <= 0:
            raise ValueError(
                f"fake measurement backend: the bonus table drove the objective to {cost} <= 0 for "
                f"{statics!r}; raise base"
            )
        return Measurement(
            objective=cost,
            ms_per_window=cost,
            decisions_per_s=1e6 / cost,
            spans={"n": 5, "min": 1, "max": 1, "dropped": 0, "spread_frac": 1.0},
            verdicts_fired={},
            # One constant fingerprint: the fake grid is trivially
            # bit-identical, as the real backend's contract requires.
            fingerprint="fake:pinned",
            recompiles_after_warmup=0,
            wall_s=0.0,
        )


class TuneMeasurementError(AssertionError):
    """A candidate broke the measurement protocol or the statics-only
    contract (too few valid spans, a growth or capture after the seal, a
    state or decision count that differs from the first candidate's)."""


def _policy_float(key: str, leaf) -> bool:
    """A float32 metric accumulator: compare_states holds it to rtol 1e-6
    (the reference's parity policy), every other leaf exactly."""
    return ".metrics." in key and leaf.dtype.name == "float32"


def _max_rel(a, b) -> float:
    import numpy as np

    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a64), np.abs(b64))
    diff = np.abs(a64 - b64)
    return float(np.max(np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0), 0.0)))


def _per_window(rep: Dict) -> Dict[str, float]:
    line = rep.get("per_window") or {}
    return {
        "windows": int(line.get("windows", 0)),
        "ms": float(line.get("window_program_ms_total", 0.0)),
    }


class BenchMeasurementBackend:
    """Real capture: one engine build and a bench-protocol measurement a
    candidate on a fixed composed trace set.

    The traces, geometry, device and shared build arguments are pinned at
    construction; `measure()` varies ONLY the candidate statics. The first
    measured candidate is the reference of the whole-grid gate: every later
    one must end in its state (compare_states, the documented parity
    policy) with equal committed decisions, or measure() raises.
    fast_forward is pinned off so every candidate runs the windows it
    names. On the card each candidate also records its device memory
    (`memory`: allocated bytes before the build and after the engine is
    closed and dropped, and the peak in between). The fingerprint digests
    the leaves the gate holds exact; `metric_drift` discloses, a new
    measurement, the float32 metric leaves that moved (module note)."""

    def __init__(
        self,
        config,
        cluster_events,
        workload_events,
        *,
        n_clusters: int,
        warm_until: float,
        t_end: float,
        step: float,
        device=None,
        build_kwargs: Optional[Dict[str, object]] = None,
        min_valid_spans: int = 5,
    ):
        from kubernetriks_tpu_torch.batched.engine import resolve_device

        self.config = config
        self.cluster_events = cluster_events
        self.workload_events = workload_events
        self.n_clusters = int(n_clusters)
        self.warm_until = float(warm_until)
        self.t_end = float(t_end)
        self.step = float(step)
        self.device = resolve_device(device)
        self.device_type = self.device.type
        self.build_kwargs = dict(build_kwargs or {})
        self.min_valid_spans = int(min_valid_spans)
        self.n_nodes: Optional[int] = None  # known after the first build
        self._reference = None  # (statics, flat numpy state, decisions)
        self.measure_calls: List[Dict[str, object]] = []
        self.memory: List[Dict[str, int]] = []
        # A new measurement's float32 `.metrics.` leaves that are not bit for
        # bit the first candidate's: {leaf: max relative difference}.
        self.metric_drift: List[Dict[str, float]] = []

    def measure(self, statics: Dict[str, object]) -> Measurement:
        import torch

        from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces

        validate_statics(statics, self.device_type)
        self.measure_calls.append(dict(statics))
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
            mem_before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        wall_t0 = time.perf_counter()
        sim = build_batched_from_traces(
            self.config, self.cluster_events, self.workload_events,
            n_clusters=self.n_clusters, device=self.device,
            telemetry=True, fast_forward=False,
            tuned_profile=False,  # candidates pin every knob explicitly
            **statics, **self.build_kwargs,
        )
        try:
            m = self._measure_built(sim, statics, wall_t0)
        finally:
            sim.close()
            del sim
        if on_card:
            gc.collect()
            torch.cuda.synchronize(self.device)
            self.memory.append({
                "before": int(mem_before),
                "peak": int(torch.cuda.max_memory_allocated(self.device)),
                "after": int(torch.cuda.memory_allocated(self.device)),
            })
        return m

    def _measure_built(self, sim, statics: Dict[str, object], wall_t0: float) -> Measurement:
        import numpy as np

        from kubernetriks_tpu_torch.batched.state import compare_states
        from kubernetriks_tpu_torch.convert import state_to_numpy
        from kubernetriks_tpu_torch.recompile import RecompileSentinel, sentinel_mode
        from kubernetriks_tpu_torch.telemetry.observatory import tuning_objective

        # A raising sentinel a candidate: any capture after the seal (build,
        # warm-up and precompile_pieces) breaks it. KTPU_EXPLAIN_RECOMPILES=0
        # force-disarms it, as everywhere.
        sentinel = None
        if sentinel_mode() is not False:
            sentinel = RecompileSentinel("raise").install()
        try:
            self.n_nodes = sim.n_nodes
            sim.step_until_time(self.warm_until)
            # The pod window must slide inside the warm-up: its first slide
            # captures the slide graphs, which after the seal would raise.
            # The slide time is a function of the trace alone, so every
            # candidate extends by the same amount.
            warm_end = self.warm_until
            if sim.pod_window is not None:
                while sim._pod_base == 0 and warm_end < self.t_end:
                    warm_end += self.step
                    sim.step_until_time(warm_end)
                if sim._pod_base == 0:
                    raise TuneMeasurementError(
                        f"tune candidate {statics!r}: the pod window never slid by t_end={self.t_end}; a later "
                        "first slide would capture inside a timed span: enlarge the horizon or shrink pod_window"
                    )
            sim.precompile_pieces()
            sim.drain_telemetry()
            sealed = _per_window(sim.telemetry_report())
            grows = sim.dispatch_stats["grows"]
            if sentinel is not None:
                sentinel.seal(f"tune candidate warm-up {statics!r}")
            # The bench span protocol: >= min_valid timed spans, each
            # decisions read a real sync, zero-decision spans dropped and
            # disclosed, re-armed past t_end up to +5 steps before failing.
            rates, span_decisions = [], []
            end = warm_end + self.step
            max_end = self.t_end + 5 * self.step
            while end <= self.t_end or (
                sum(1 for d in span_decisions if d > 0) < self.min_valid_spans and end <= max_end
            ):
                before = sim.decisions_total()
                t0 = time.perf_counter()
                sim.step_until_time(end)
                decided = sim.decisions_total() - before
                span_decisions.append(decided)
                rates.append(decided / (time.perf_counter() - t0))
                end += self.step
            valid = [r for r, d in zip(rates, span_decisions) if d > 0]
            dropped = len(rates) - len(valid)
            if len(valid) < self.min_valid_spans:
                raise TuneMeasurementError(
                    f"tune candidate {statics!r}: only {len(valid)} valid timed spans ({dropped} dropped as "
                    "zero-decision): extend the capture horizon"
                )
            if sim.dispatch_stats["grows"] != grows:
                raise TuneMeasurementError(
                    f"tune candidate {statics!r}: the pod window grew inside the timed spans "
                    f"({grows} -> {sim.dispatch_stats['grows']}): lengthen the warm-up"
                )
            sim.drain_telemetry()
            rep = sim.telemetry_report()
            ended = _per_window(rep)
            windows = ended["windows"] - sealed["windows"]
            rep["per_window"] = {
                "windows": windows,
                "window_program_ms_total": ended["ms"] - sealed["ms"],
                "ms_per_window": (ended["ms"] - sealed["ms"]) / windows if windows > 0 else 0.0,
            }
            obj = tuning_objective(rep)
            if not obj["ms_per_window"] > 0:
                raise TuneMeasurementError(
                    f"tune candidate {statics!r}: the telemetry report carries no per-window cost line over the "
                    "timed spans (no windows recorded?)"
                )
            recompiles = 0
            if sentinel is not None:
                sentinel.check(f"tune candidate {statics!r}")
                recompiles = len(sentinel.post_seal_events())
        finally:
            if sentinel is not None:
                sentinel.uninstall()
        decisions_total = sim.decisions_total()
        final = state_to_numpy(sim.state)
        # The whole-grid statics-only gate: the first candidate's final
        # state and committed decisions.
        drift: Dict[str, float] = {}
        if self._reference is None:
            self._reference = (dict(statics), final, decisions_total)
        else:
            ref_statics, ref_state, ref_decisions = self._reference
            if decisions_total != ref_decisions:
                raise TuneMeasurementError(
                    f"tune candidate {statics!r} committed {decisions_total} decisions against {ref_decisions} "
                    f"for the reference {ref_statics!r}: a tuning knob changed SEMANTICS, not just statics"
                )
            bad = compare_states(ref_state, final)
            if bad:
                raise TuneMeasurementError(
                    f"tune candidate {statics!r} diverged from the reference {ref_statics!r} final state at "
                    f"{bad}: a tuning knob changed SEMANTICS, not just statics"
                )
            drift = {
                key: _max_rel(ref_state[key], leaf)
                for key, leaf in final.items()
                if _policy_float(key, leaf) and not np.array_equal(ref_state[key], leaf)
            }
        self.metric_drift.append(drift)
        # The fingerprint: the decisions and the bytes of every leaf the gate
        # holds exact, in the fixed field order of the state's flatten
        # (state_to_numpy). The float32 `.metrics.` accumulators are left
        # out: the gate holds them to rtol 1e-6 (the parity policy), because
        # their folds sum in another order on another route (the
        # megakernel's in-kernel estimator against the two-kernel route's
        # torch reductions); `metric_drift` discloses how far they moved.
        digest = hashlib.sha1()
        digest.update(str(decisions_total).encode())
        for key, leaf in final.items():
            if not _policy_float(key, leaf):
                digest.update(key.encode())
                digest.update(np.ascontiguousarray(leaf).tobytes())
        spread = round(max(valid) / min(valid), 3) if min(valid) else 0.0
        return Measurement(
            objective=float(obj["score"]),
            ms_per_window=float(obj["ms_per_window"]),
            decisions_per_s=float(np.median(valid)),
            spans={
                "n": len(valid),
                "min": round(min(valid)),
                "max": round(max(valid)),
                "dropped": dropped,
                "spread_frac": spread,
            },
            verdicts_fired=dict(obj["verdicts_fired"]),
            fingerprint=digest.hexdigest(),
            recompiles_after_warmup=recompiles,
            wall_s=time.perf_counter() - wall_t0,
        )
