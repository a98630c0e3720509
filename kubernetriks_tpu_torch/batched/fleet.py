"""Scenario fleet: what-if queries as per-lane config over one resident engine.

Port of the JAX package's `batched/fleet.py` (:130-1000 and :1371-1560),
its wave-aligned path. The scenario-bearing control-law parameters ride as
per-cluster (C,) tensors (the autoscaler statics, and the pod-fault seed
vector under a scenario build), so one set of captured window graphs
serves any scenario mix:

- `Scenario`: one what-if query's config delta, over the vectorizable
  set SCENARIO_KEYS: parameters that shape no tensor and enter only the
  autoscaler chains (HPA scan interval, tolerance and per-lane enable;
  CA scan interval, scale-down threshold and node quota; the
  as_to_ca_network_delay, which feeds only the autoscaler chains) and the
  pod-fault seed. A lane with overrides runs as a scalar-config run with
  those values would.
- `scenario_leaves`: the one owner of the scalar -> per-lane composition
  rules (the delay chains). The engine's statics build and its
  `update_scenario` both go through it.
- `ScenarioFleet`: a resident service. `submit()` queues queries
  (validated before admission, a bounded queue with reject or block
  backpressure, deadlines), `run()` packs them into waves of C lanes,
  writes each wave's per-lane vectors into the engine in place
  (`update_scenario`), resets the lanes against the build's pristine
  state in place (`fleet_reset`), steps the engine to the wave's
  horizons and reads each lane's results back where the host blocks at
  the end of a step; `poll()` streams every query's terminal outcome
  exactly once; `sweep()` and `close()`.

On the card the engine's window pieces are captured once, at the fleet's
build (`precompile_pieces`); a scenario update and a wave reset write into
the tensors those graphs read and never capture again. A pod-window
fleet that streams re-seeks its feeder at each wave boundary, which
captures the new ring's slide graphs (at most its depth a wave).

Wave-aligned only: the engine's window clock is fleet-global, so the
lanes of a wave start together and a lane whose horizon comes early
runs on idle until the wave ends. The lane-asynchronous fleet (per-lane
clocks, `pump`, `LaneTraceMux`, quarantine, `HostChaos`'s dispatch and
stall channels) is ROADMAP Queue 1 item 13b: `lane_async=True` and
`trace_rows=` raise, and so does `tuned_profile=` (item 14).

Query lifecycle: each query keeps host perf_counter_ns stamps (submitted,
admitted, drained; polled at retirement), a submit -> drain flow arrow and
queue-wait / service spans in the engine's tracer, and its latency in
bounded log-bucketed histograms (telemetry/histogram.py), all host work.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Mapping
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.faults import (
    DeadlineExceededError,
    QueryError,
    RejectedError,
    ShutdownError,
)
from kubernetriks_tpu_torch.config import KubeClusterAutoscalerConfig, KubeHorizontalPodAutoscalerConfig
from kubernetriks_tpu_torch.telemetry.histogram import LatencyHistogram
from kubernetriks_tpu_torch.telemetry.tracer import PH_QUERY_FAIL, PH_QUERY_QUEUE, PH_QUERY_SERVICE

# Lifecycle records retired at poll() kept for query_lifecycle().
_POLLED_LIFECYCLES_KEPT = 128

# Scenario keys accepted as per-lane overrides (the vectorizable set).
SCENARIO_KEYS = (
    "hpa_scan_interval",
    "hpa_tolerance",
    "hpa_enabled",
    "ca_scan_interval",
    "ca_threshold",
    "ca_max_node_count",
    "as_to_ca_network_delay",
    "fault_seed",
)


@dataclass(frozen=True)
class Scenario:
    """One what-if query's config delta: each field overrides the base
    config's value for one lane (None keeps the base). `ca_max_node_count:
    0` disables the lane's CA scale-up; `hpa_enabled: False` parks the
    lane's pod groups (pg_active_from = +inf), as a run with the HPA off,
    whose initial replicas still run."""

    hpa_scan_interval: Optional[float] = None
    hpa_tolerance: Optional[float] = None
    hpa_enabled: Optional[bool] = None
    ca_scan_interval: Optional[float] = None
    ca_threshold: Optional[float] = None
    ca_max_node_count: Optional[int] = None
    as_to_ca_network_delay: Optional[float] = None
    fault_seed: Optional[int] = None

    def overrides(self) -> Dict[str, object]:
        return {f.name: getattr(self, f.name) for f in fields(self) if getattr(self, f.name) is not None}


def _base_values(config) -> Dict[str, object]:
    """The base config's value of every scenario key: what a lane without
    an override carries."""
    hpa = config.horizontal_pod_autoscaler
    ca = config.cluster_autoscaler
    hpa_tol = (hpa.kube_horizontal_pod_autoscaler_config or KubeHorizontalPodAutoscalerConfig()).target_threshold_tolerance
    ca_thresh = (ca.kube_cluster_autoscaler or KubeClusterAutoscalerConfig()).scale_down_utilization_threshold
    fi = getattr(config, "fault_injection", None)
    return {
        "hpa_scan_interval": float(hpa.scan_interval),
        "hpa_tolerance": float(hpa_tol),
        "hpa_enabled": bool(hpa.enabled),
        "ca_scan_interval": float(ca.scan_interval),
        "ca_threshold": float(ca_thresh),
        "ca_max_node_count": int(ca.max_node_count if ca.enabled else 0),
        "as_to_ca_network_delay": float(config.as_to_ca_network_delay),
        "fault_seed": int(fi.seed if fi is not None and fi.seed is not None else config.seed),
    }


def scenario_vectors(
    config,
    n_lanes: int,
    scenarios: Optional[Sequence[Optional[Scenario]]] = None,
    base_vectors: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """The per-lane (C,) scenario vectors: the base config's value (or a
    copy of `base_vectors` where given: the fleet's waves start from its
    build vectors) with each lane's overrides on top. `scenarios`: at most
    n_lanes entries, None keeps the base."""
    base = _base_values(config)
    out: Dict[str, np.ndarray] = {}
    for key in SCENARIO_KEYS:
        if base_vectors is not None and key in base_vectors:
            out[key] = base_vectors[key].copy()
        elif key == "hpa_enabled":
            out[key] = np.full((n_lanes,), bool(base[key]), bool)
        elif key in ("ca_max_node_count", "fault_seed"):
            out[key] = np.full((n_lanes,), int(base[key]), np.int64)
        else:
            out[key] = np.full((n_lanes,), float(base[key]), np.float64)
    if scenarios is not None:
        if len(scenarios) > n_lanes:
            raise ValueError(f"{len(scenarios)} scenarios do not fit {n_lanes} lanes")
        for lane, scen in enumerate(scenarios):
            if scen is None:
                continue
            for key, val in scen.overrides().items():
                if key not in out:
                    raise KeyError(f"unknown scenario key {key!r}")
                out[key][lane] = val
    return out


def normalize_scenario(scenario: Optional[Dict[str, object]], n_lanes: int) -> Optional[Dict[str, np.ndarray]]:
    """Check a scenario-vector mapping: known keys only, each value a
    scalar or of shape (n_lanes,). Returns owned (C,) numpy arrays."""
    if scenario is None:
        return None
    out: Dict[str, np.ndarray] = {}
    for key, val in scenario.items():
        if key not in SCENARIO_KEYS:
            raise KeyError(f"unknown scenario key {key!r}; supported: {SCENARIO_KEYS}")
        arr = np.asarray(val)
        if arr.ndim == 0:
            arr = np.full((n_lanes,), arr[()])
        if arr.shape != (n_lanes,):
            raise ValueError(f"scenario[{key!r}] must be scalar or shape ({n_lanes},), got {arr.shape}")
        out[key] = arr.copy()
    return out


def scenario_leaves(config, n_lanes: int, scenario: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """The per-lane (C,) control-law leaves from the base config and
    optional per-lane overrides (reference fleet.py:261): float64 seconds
    (the caller makes device time pairs of them) but the tolerance and
    threshold, the bool enable and the int quota and seed. The CA's true
    period is its info round trip plus scan_interval (the round trip
    alone where that overruns the scan), per lane."""
    scenario = dict(scenario or {})
    base = _base_values(config)
    C = n_lanes

    def vec(key, dtype=np.float64):
        out = np.full((C,), base[key], dtype)
        val = scenario.get(key)
        if val is not None:
            out[:] = np.asarray(val)
        return out

    hpa_scan = vec("hpa_scan_interval")
    hpa_tol = vec("hpa_tolerance")
    hpa_en = vec("hpa_enabled", bool) & bool(config.horizontal_pod_autoscaler.enabled)
    ca_scan = vec("ca_scan_interval")
    ca_thresh = vec("ca_threshold")
    ca_max = vec("ca_max_node_count", np.int64)
    if not config.cluster_autoscaler.enabled:
        ca_max[:] = 0
    as_to_ca = vec("as_to_ca_network_delay")
    fault_seed = vec("fault_seed", np.int64)

    as_to_ps = float(config.as_to_ps_network_delay)
    ps_to_sched = float(config.ps_to_sched_network_delay)
    sched_to_as = float(config.sched_to_as_network_delay)
    as_to_node = float(config.as_to_node_network_delay)
    d_pod_enqueue = as_to_ps + ps_to_sched
    ca_roundtrip = 2.0 * (as_to_ca + as_to_ps)
    return {
        "hpa_interval_s": hpa_scan,
        "hpa_tolerance": hpa_tol,
        "hpa_enabled": hpa_en,
        "ca_threshold": ca_thresh,
        "ca_max_nodes": ca_max,
        "fault_seed": fault_seed,
        "d_hpa_up_s": as_to_ca + d_pod_enqueue,
        "d_hpa_down_s": as_to_ca + as_to_ps,
        "d_ca_up_s": 3.0 * as_to_ca + 5.0 * as_to_ps + ps_to_sched,
        "d_ca_down_s": 3.0 * as_to_ca + 4.0 * as_to_ps + as_to_node,
        "ca_period_s": ca_roundtrip + np.where(ca_roundtrip <= ca_scan, ca_scan, 0.0),
        "ca_snap_s": as_to_ca + as_to_ps,
        "ca_finish_vis_s": np.full((C,), as_to_node + as_to_ps),
        "ca_commit_vis_s": np.full((C,), sched_to_as + as_to_ps),
    }


# --- the fleet ------------------------------------------------------------------


@dataclass
class FleetResult:
    """One drained what-if query. Shares the `.ok` / `.kind` protocol with
    the QueryError family (batched/faults.py), so a poll loop filters
    outcomes with `outcome.ok`."""

    ok = True
    kind = "result"

    query: int
    wave: int
    lane: int
    horizon: float
    scenario: Scenario
    counters: Dict[str, int]
    hpa_replicas: Optional[Dict[str, int]]
    ca_nodes: Optional[List[int]]
    # The lane's autoscaler work bounds (check_autoscaler_bounds' counters,
    # per lane): nonzero means its trajectory left the scalar semantics.
    hpa_reserve_clamped: int = 0
    ca_reserve_starved: int = 0


# The per-lane counters a query reads back (MetricArrays fields).
_RESULT_COUNTERS = (
    "pods_succeeded",
    "pods_removed",
    "terminated_pods",
    "scheduling_decisions",
    "scaled_up_pods",
    "scaled_down_pods",
    "scaled_up_nodes",
    "scaled_down_nodes",
    "node_crashes",
    "node_recoveries",
    "pod_interruptions",
    "pod_restarts",
    "pods_failed",
)
_BOUND_COUNTERS = ("hpa_reserve_clamped", "ca_reserve_starved")


class ScenarioFleet:
    """A resident what-if service over one engine (module note): build
    once, then `submit()` queries and `run()` them in waves of `n_lanes`.

    `horizon`: a query's default horizon (simulated seconds);
    `strict_divergence`: a drained lane whose autoscaler bounds were
    crossed raises instead of returning its numbers; `build_scenarios`:
    per-lane build config, the defaults a wave's queries override (the one
    channel to the crash chains, which are compiled at build); `max_queue`
    (KTPU_FLEET_QUEUE) and `queue_policy` (KTPU_FLEET_QUEUE_POLICY,
    'reject' or 'block'): the bounded admission queue. Other keyword
    arguments go to the engine's build (build_batched_from_traces)."""

    # Scenario fields that must be finite and >= 0; the others are
    # bool / int control values.
    _NONNEG_KEYS = ("hpa_scan_interval", "hpa_tolerance", "ca_scan_interval", "ca_threshold", "as_to_ca_network_delay")

    def __init__(
        self,
        config,
        cluster_events,
        workload_events,
        n_lanes: int,
        horizon: float,
        strict_divergence: bool = True,
        build_scenarios: Optional[Sequence[Optional[Scenario]]] = None,
        lane_async: bool = False,
        max_queue: Optional[int] = None,
        queue_policy: Optional[str] = None,
        tuned_profile=None,
        **engine_kwargs,
    ) -> None:
        from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
        from kubernetriks_tpu_torch.flags import flag_int, flag_str

        if lane_async:
            raise ValueError(
                "lane_async=True: the lane-asynchronous fleet (per-lane window clocks, pump, LaneTraceMux, "
                "quarantine) is not ported yet (ROADMAP Queue 1 item 13b); the wave-aligned fleet runs run()"
            )
        if tuned_profile is not None:
            raise ValueError(
                "tuned_profile=: tuned statics profiles are not ported yet (ROADMAP Queue 1 item 14)"
            )
        if n_lanes < 1:
            raise ValueError("a fleet needs at least one lane")
        self.config = config
        self.n_lanes = int(n_lanes)
        self.default_horizon = float(horizon)
        self.strict_divergence = bool(strict_divergence)
        if max_queue is None:
            max_queue = flag_int("KTPU_FLEET_QUEUE")
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None for unbounded), got {self.max_queue}")
        policy = queue_policy or flag_str("KTPU_FLEET_QUEUE_POLICY") or "reject"
        if policy not in ("reject", "block"):
            raise ValueError(f"queue_policy must be 'reject' or 'block', got {policy!r}")
        self.queue_policy = policy
        # Built with the scenario vectors, so every scenario-bearing leaf
        # is a per-lane tensor from the start and later waves only write.
        self._vectors = scenario_vectors(config, self.n_lanes, build_scenarios)
        self.engine = build_batched_from_traces(
            config, cluster_events, workload_events, n_clusters=self.n_lanes, scenario=dict(self._vectors),
            **engine_kwargs,
        )
        # On the card every window piece the plans can reach is captured
        # now: the waves replay them and never capture (the counterpart of
        # the reference's compile-once warm-up).
        self.engine.precompile_pieces()
        self._queue: deque = deque()
        self._next_query = 0
        # Terminal outcome per query id: a FleetResult or a QueryError.
        self.results: Dict[int, Union[FleetResult, QueryError]] = {}
        self._completed: deque = deque()
        self.waves_run = 0
        self._dirty = False  # wave 0 runs on the build-fresh engine
        self._lifecycle: Dict[int, Dict[str, int]] = {}
        self._polled_lifecycles: deque = deque(maxlen=_POLLED_LIFECYCLES_KEPT)
        # Submit-to-drain and admit-to-drain (service) wall seconds; the
        # service times give a rejected query its retry hint.
        self.latency_hist = LatencyHistogram()
        self.service_hist = LatencyHistogram()
        self.failed_queries: Dict[str, int] = {}
        self._deadlines_ever = False
        self._closing = False
        self._closed = False

    # -- intake ---------------------------------------------------------------

    def _validate_scenario(self, scenario) -> Scenario:
        """Pre-admission checks (unknown keys, per-lane vectors, negative or
        non-finite values) that raise ValueError naming the field."""
        if scenario is None:
            return Scenario()
        if isinstance(scenario, Scenario):
            overrides = scenario.overrides()
        elif isinstance(scenario, Mapping):
            overrides = dict(scenario)
            unknown = [k for k in overrides if k not in SCENARIO_KEYS]
            if unknown:
                raise ValueError(f"submit(): unknown scenario key(s) {sorted(unknown)}; legal keys: {list(SCENARIO_KEYS)}")
        else:
            raise ValueError(f"submit(): scenario must be a Scenario or a mapping of scenario keys, got {type(scenario).__name__}")
        for key, val in overrides.items():
            arr = np.asarray(val)
            if arr.ndim != 0:
                raise ValueError(
                    f"submit(): scenario[{key!r}] must be a per-query SCALAR override (axis shape ()), got shape "
                    f"{arr.shape}; per-lane (C,) vectors belong to build_scenarios / engine.update_scenario"
                )
            if key in self._NONNEG_KEYS:
                v = float(arr)
                if not np.isfinite(v) or v < 0:
                    raise ValueError(f"submit(): scenario[{key!r}] must be a finite value >= 0, got {val!r}")
        return scenario if isinstance(scenario, Scenario) else Scenario(**overrides)

    @staticmethod
    def _validate_positive(name: str, value, unit: str) -> float:
        try:
            out = float(value)
        except (TypeError, ValueError):
            out = float("nan")
        if not np.isfinite(out) or out <= 0:
            raise ValueError(f"submit(): {name} must be a finite number > 0 ({unit}), got {value!r}")
        return out

    def _retry_after_hint(self) -> Optional[float]:
        """A rejected query's back-off hint: the median service time times
        the waves queued ahead; None before any query was served."""
        if self.service_hist.count == 0:
            return None
        waves_ahead = (len(self._queue) + 1) / max(1, self.n_lanes)
        return round(self.service_hist.percentile(50.0) * waves_ahead, 6)

    def submit(self, scenario=None, horizon: Optional[float] = None, trace_rows=None,
               deadline_s: Optional[float] = None) -> int:
        """Queue one what-if query; returns its id (the key into `results`,
        and what poll() streams). Validated before admission (ValueError
        naming the field); `deadline_s`: host seconds from now after which
        a query still queued fails with DeadlineExceededError, checked at
        wave boundaries, without occupying a lane. A full bounded queue
        applies the policy: 'reject' streams a RejectedError for the
        query, 'block' runs waves inline until a slot frees. After close()
        this raises ShutdownError. `trace_rows` (a per-lane trace range)
        needs the lane-asynchronous fleet (ROADMAP Queue 1 item 13b)."""
        if self._closing:
            raise ShutdownError(-1, "submit() after close(): the fleet is closed and admits no new queries")
        scen = self._validate_scenario(scenario)
        h = self.default_horizon if horizon is None else self._validate_positive("horizon", horizon, "simulated seconds")
        if deadline_s is not None:
            deadline_s = self._validate_positive("deadline_s", deadline_s, "host seconds from submit")
        if trace_rows is not None:
            raise ValueError(
                "submit(): trace_rows needs the lane-asynchronous fleet's per-lane trace multiplexer, not ported "
                "yet (ROADMAP Queue 1 item 13b)"
            )
        if self.max_queue is not None and len(self._queue) >= self.max_queue and self.queue_policy == "block":
            while len(self._queue) >= self.max_queue:
                self._run_one_wave()
        qid = self._next_query
        self._next_query += 1
        t_submit = time.perf_counter_ns()
        self._lifecycle[qid] = {
            "submitted_ns": t_submit,
            "flow_id": self.engine.tracer.flow_start(PH_QUERY_QUEUE),
            "lane": -1,
        }
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self._fail_query(qid, RejectedError(
                qid,
                f"query {qid} rejected at admission: queue full ({len(self._queue)}/{self.max_queue} queued; "
                "policy 'reject')",
                retry_after_s=self._retry_after_hint(), scenario=scen, horizon=h,
            ))
            return qid
        deadline_ns = None
        if deadline_s is not None:
            deadline_ns = t_submit + int(deadline_s * 1e9)
            self._deadlines_ever = True
        self._queue.append((qid, scen, h, deadline_ns))
        return qid

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- outcomes ---------------------------------------------------------------

    def _fail_query(self, qid: int, err: QueryError) -> None:
        """Deliver a typed failure through the completion stream, as a
        drained result goes (poll() streams it once)."""
        rec = self._lifecycle.get(qid)
        t_fail = time.perf_counter_ns()
        if rec is not None:
            rec["failed_ns"] = t_fail
            if err.lane >= 0:
                rec["lane"] = err.lane
            tracer = self.engine.tracer
            tracer.end(PH_QUERY_FAIL, rec["submitted_ns"], dur=t_fail - rec["submitted_ns"])
            if rec["flow_id"]:
                tracer.flow_end(PH_QUERY_QUEUE, rec["flow_id"])
        self.results[qid] = err
        self._completed.append(qid)
        self.failed_queries[err.kind] = self.failed_queries.get(err.kind, 0) + 1

    def _expire_deadlines(self) -> None:
        """Fail the queued queries past their deadline, without a lane (at
        wave boundaries, and only once a deadline was ever given)."""
        if not self._deadlines_ever or not self._queue:
            return
        now = time.perf_counter_ns()
        keep: deque = deque()
        while self._queue:
            entry = self._queue.popleft()
            qid, scen, horizon, deadline_ns = entry
            if deadline_ns is not None and now >= deadline_ns:
                late_s = (now - deadline_ns) / 1e9
                self._fail_query(qid, DeadlineExceededError(
                    qid,
                    f"query {qid} deadline exceeded while queued ({late_s:.3f}s late); failed without occupying a lane",
                    late_s=round(late_s, 6), scenario=scen, horizon=horizon,
                ))
            else:
                keep.append(entry)
        self._queue = keep

    # -- waves ------------------------------------------------------------------

    def _lane_rows(self, lanes: Sequence[int]) -> Dict[int, Dict[str, int]]:
        """Each lane's counter row, every counter leaf read in one host
        read where the step has just blocked."""
        m = self.engine.state.metrics
        names = _RESULT_COUNTERS + _BOUND_COUNTERS
        table = torch.stack([getattr(m, n).to(torch.int64) for n in names]).cpu().numpy()
        return {lane: {n: int(table[i, lane]) for i, n in enumerate(names)} for lane in lanes}

    def _drain_lane(self, qid: int, lane: int, horizon: float, scen: Scenario, rows: Dict, wave: int) -> None:
        row = dict(rows[lane])
        clamped = row.pop("hpa_reserve_clamped")
        starved = row.pop("ca_reserve_starved")
        if self.strict_divergence and (clamped > 0 or starved > 0):
            raise RuntimeError(
                f"fleet query {qid} (lane {lane}): autoscaler reserve bound crossed (hpa_reserve_clamped={clamped}, "
                f"ca_reserve_starved={starved}); the lane's trajectory diverged from the scalar semantics; widen "
                "the reserves or pass strict_divergence=False to read it anyway"
            )
        eng = self.engine
        hpa = ca = None
        if eng.state.auto is not None:
            hpa = eng.hpa_replicas(lane)
            ca = [int(v) for v in eng.ca_node_counts(lane)]
        self.results[qid] = FleetResult(
            query=qid, wave=wave, lane=lane, horizon=horizon, scenario=scen, counters=row,
            hpa_replicas=hpa, ca_nodes=ca, hpa_reserve_clamped=clamped, ca_reserve_starved=starved,
        )
        self._completed.append(qid)

    def _run_wave(self, wave) -> None:
        """One wave: its per-lane vectors written in place (idle lanes run
        the build's), the lanes reset (from the second wave on), a step to
        each distinct horizon, and the lanes ending there drained."""
        eng = self.engine
        eng.update_scenario(scenario_vectors(
            self.config, self.n_lanes, [scen for _, scen, _, _ in wave], base_vectors=self._vectors,
        ))
        if self._dirty:
            eng.fleet_reset()
        self._dirty = True
        # Every lane of a wave starts together: one admission stamp.
        t_admit = time.perf_counter_ns()
        for lane, (qid, _, _, _) in enumerate(wave):
            rec = self._lifecycle.get(qid)
            if rec is not None:
                rec["admitted_ns"] = t_admit
                rec["lane"] = lane
        by_horizon: Dict[float, list] = {}
        for lane, (qid, scen, horizon, _) in enumerate(wave):
            by_horizon.setdefault(horizon, []).append((qid, lane, scen))
        tracer = eng.tracer
        for horizon in sorted(by_horizon):
            eng.step_until_time(horizon)
            rows = self._lane_rows([lane for _, lane, _ in by_horizon[horizon]])
            t_drain = time.perf_counter_ns()
            for qid, lane, scen in by_horizon[horizon]:
                self._drain_lane(qid, lane, horizon, scen, rows, self.waves_run)
                rec = self._lifecycle.get(qid)
                if rec is None:
                    continue
                rec["drained_ns"] = t_drain
                if rec["flow_id"]:
                    tracer.flow_end(PH_QUERY_QUEUE, rec["flow_id"])
                tracer.end(PH_QUERY_QUEUE, rec["submitted_ns"], dur=t_admit - rec["submitted_ns"])
                tracer.end(PH_QUERY_SERVICE, t_admit, dur=t_drain - t_admit)
                self.latency_hist.record((t_drain - rec["submitted_ns"]) / 1e9)
                self.service_hist.record((t_drain - t_admit) / 1e9)
        self.waves_run += 1

    def _run_one_wave(self) -> None:
        self._expire_deadlines()
        if self._queue:
            self._run_wave([self._queue.popleft() for _ in range(min(self.n_lanes, len(self._queue)))])

    def run(self) -> Dict[int, Union[FleetResult, QueryError]]:
        """Drain the queue in waves of n_lanes queries; returns `results`
        (every outcome so far, by query id)."""
        self._expire_deadlines()
        while self._queue:
            self._run_one_wave()
        return self.results

    def sweep(self, scenarios: Sequence[Scenario], horizon: Optional[float] = None) -> List[FleetResult]:
        """Submit and run a list of scenarios; their outcomes in submission
        order (delivered here, so poll() does not stream them again)."""
        qids = [self.submit(s, horizon) for s in scenarios]
        self.run()
        mine = set(qids)
        self._completed = deque(q for q in self._completed if q not in mine)
        t_poll = time.perf_counter_ns()
        for q in qids:
            self._retire_lifecycle(q, t_poll)
        return [self.results[q] for q in qids]

    # -- readout -----------------------------------------------------------------

    def _retire_lifecycle(self, qid: int, t_poll_ns: int) -> None:
        rec = self._lifecycle.pop(qid, None)
        if rec is not None:
            rec["polled_ns"] = t_poll_ns
            self._polled_lifecycles.append((qid, rec))

    def _qid_inventory(self) -> str:
        if self._next_query == 0:
            return "no queries have been submitted to this fleet yet"
        return (
            f"{self._next_query} submitted (qids 0..{self._next_query - 1}), {len(self.results)} completed "
            f"({len(self._completed)} unpolled), {len(self._queue)} queued"
        )

    def poll(self, qid: Optional[int] = None) -> List[Union[FleetResult, QueryError]]:
        """Terminal outcomes delivered since the last poll, in completion
        order: FleetResults and QueryErrors under one contract, every
        submitted query id streams exactly one outcome. poll(qid): that
        query's outcome once it landed (a one-element list), [] while it
        is queued or once it was streamed; a KeyError naming what this
        fleet knows where the id was never submitted."""
        t_poll = time.perf_counter_ns()
        if qid is None:
            out = [self.results[q] for q in self._completed]
            for q in self._completed:
                self._retire_lifecycle(q, t_poll)
            self._completed.clear()
            return out
        qid = int(qid)
        if qid < 0 or qid >= self._next_query:
            raise KeyError(f"poll({qid}): query {qid} was never submitted to this fleet; {self._qid_inventory()}")
        if qid in self._completed:
            self._completed.remove(qid)
            self._retire_lifecycle(qid, t_poll)
            return [self.results[qid]]
        return []

    def query_lifecycle(self, qid: int) -> Dict[str, int]:
        """One query's host stamps (submitted_ns, admitted_ns, drained_ns,
        failed_ns, polled_ns where they happened), its lane and flow id;
        from the live records, or the last polled ones."""
        qid = int(qid)
        if 0 <= qid < self._next_query:
            rec = self._lifecycle.get(qid)
            if rec is None:
                for old_qid, old_rec in reversed(self._polled_lifecycles):
                    if old_qid == qid:
                        rec = old_rec
                        break
            if rec is not None:
                return dict(rec)
        raise KeyError(
            f"query_lifecycle({qid}): no lifecycle record (never submitted, or retired past the last "
            f"{_POLLED_LIFECYCLES_KEPT} polled queries); {self._qid_inventory()}"
        )

    def close(self) -> None:
        """Graceful shutdown: admit nothing more (submit() raises
        ShutdownError), fail every query still queued with a ShutdownError
        through the completion stream (a wave's queries have all drained
        when run() returns), and close the engine (its feeder). poll()
        keeps working: the outcomes are host state."""
        if self._closed:
            return
        self._closing = True
        while self._queue:
            qid, scen, horizon, _ = self._queue.popleft()
            self._fail_query(qid, ShutdownError(
                qid,
                f"query {qid} was still queued at close(); the graceful drain fails queued queries",
                scenario=scen, horizon=horizon,
            ))
        self._closed = True
        self.engine.close()

