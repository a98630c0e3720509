"""Scenario fleet: what-if queries as per-lane config over one resident engine.

Port of the JAX package's `batched/fleet.py`, its wave-aligned and its
lane-asynchronous paths. The scenario-bearing control-law parameters ride as
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
fleet that streams re-seeks its feeder at each wave boundary into the
ring it already has (engine.close(keep_ring=True)): the slots keep their
addresses, so their slide graphs stay valid and nothing is captured after
the first wave.

Two lane protocols (reference fleet.py:37-57):
- wave-aligned (the default, `run()`): the engine's window clock is
  fleet-global, so the lanes of a wave start together and a lane whose
  horizon comes early runs on idle until the wave ends;
- lane-asynchronous (`lane_async=True`; DESIGN §13 of the reference): the
  engine carries per-lane window clocks (engine.set_lane_plan), each lane
  runs its own virtual span inside the shared window pieces, and a
  finished lane is reset and re-seeded in place (engine.lane_reset) while
  its neighbours step on. `pump()` runs one round: it seeds idle lanes
  from the queue (their scenario rows, their trace row range through the
  engine's LaneTraceMux with `submit(trace_rows=)`), steps up to
  `span_windows` global windows in power-of-two chunks clamped to the
  nearest lane's plan end (engine.step_windows; chunks inside every
  lane's span run the pieces without the freeze) and drains the lanes
  whose plan ended, host arithmetic on the clock mirrors; `run_async()`
  pumps until all is drained. A query's result equals the wave-aligned
  path's for the same scenario and horizon. The occupancy ledger
  (`lane_occupancy`) counts the lane-windows that carried a query.

Fault domains (lane-asynchronous fleet; reference fleet.py:59-80): a
failing dispatch fails the occupying lane's query alone (LaneFaultError
through poll()), the lane is reset from the pristine snapshot, and a
lane that faults `quarantine_faults` times within `quarantine_window`
rounds leaves the admission rotation for `quarantine_backoff` rounds,
then takes one probe query (a faulting probe doubles the backoff, a
finished one re-admits the lane). `HostChaos` (KTPU_HOST_CHAOS, or
`host_chaos=` / `arm_host_chaos`) injects dispatch faults and stalls;
unset, the chaos branches are never taken. The observatory (telemetry
on) hears every query's latencies (note_query, SLO verdicts under
KTPU_SLO_MS) and the lanes' states. `tuned_profile=` (else
KTPU_TUNED_PROFILE) goes to the engine's build (tune/profile.py);
`fleet.tuned_profile` is the profile it applied, or None.

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
    HostChaos,
    InjectedFault,
    LaneFaultError,
    QueryError,
    RejectedError,
    ShutdownError,
)
from kubernetriks_tpu_torch.config import KubeClusterAutoscalerConfig, KubeHorizontalPodAutoscalerConfig
from kubernetriks_tpu_torch.recompile import RecompileError, maybe_sentinel
from kubernetriks_tpu_torch.telemetry.histogram import LatencyHistogram
from kubernetriks_tpu_torch.telemetry.tracer import (
    PH_LANE_QUARANTINE,
    PH_QUERY_FAIL,
    PH_QUERY_QUEUE,
    PH_QUERY_SERVICE,
)

# Lifecycle records retired at poll() kept for query_lifecycle().
_POLLED_LIFECYCLES_KEPT = 128
# The latest query latencies kept exactly beside the histogram.
_EXACT_LATENCY_WINDOW = 1024

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
    once, then `submit()` queries and `run()` them in waves of `n_lanes`,
    or, with `lane_async`, `pump()` / `run_async()` them lane by lane.

    `horizon`: a query's default horizon (simulated seconds);
    `strict_divergence`: a drained lane whose autoscaler bounds were
    crossed raises instead of returning its numbers; `build_scenarios`:
    per-lane build config, the defaults a query's overrides apply to (the
    one channel to the crash chains, which are compiled at build);
    `lane_async`: per-lane window clocks (module note); `span_windows`
    (KTPU_LANE_SPAN, 8): a pump round's windows; `max_queue`
    (KTPU_FLEET_QUEUE) and `queue_policy` (KTPU_FLEET_QUEUE_POLICY,
    'reject' or 'block'): the bounded admission queue;
    `quarantine_faults` / `quarantine_window` / `quarantine_backoff`: the
    lane quarantine's policy; `host_chaos` (else KTPU_HOST_CHAOS): the
    host-fault injector; `tuned_profile` (else KTPU_TUNED_PROFILE): the
    engine's tuned statics profile (tune/profile.py). Other keyword
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
        span_windows: Optional[int] = None,
        max_queue: Optional[int] = None,
        queue_policy: Optional[str] = None,
        quarantine_faults: int = 3,
        quarantine_window: int = 64,
        quarantine_backoff: int = 8,
        host_chaos: Optional[HostChaos] = None,
        tuned_profile=None,
        **engine_kwargs,
    ) -> None:
        from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
        from kubernetriks_tpu_torch.flags import flag_int, flag_str

        if n_lanes < 1:
            raise ValueError("a fleet needs at least one lane")
        self.config = config
        self.n_lanes = int(n_lanes)
        self.default_horizon = float(horizon)
        self.strict_divergence = bool(strict_divergence)
        self.lane_async = bool(lane_async)
        if self.lane_async:
            engine_kwargs["lane_async"] = True
        if span_windows is None:
            span_windows = flag_int("KTPU_LANE_SPAN")
        self.span_windows = max(1, int(span_windows)) if span_windows else 8
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
            tuned_profile=tuned_profile, **engine_kwargs,
        )
        self.tuned_profile = self.engine.tuned_profile
        # On the card every window piece the plans can reach is captured
        # now, both freeze variants under lane clocks: the waves and pump
        # rounds replay them and never capture (the counterpart of the
        # reference's compile-once warm-up and precompile_lane_spans).
        self.engine.precompile_pieces()
        # KTPU_EXPLAIN_RECOMPILES=1: a raising recompile sentinel, sealed
        # here, guards every wave and pump round (reference fleet.py:
        # 515-523, where wave 1 compiles; here the build captured every
        # piece already): a capture inside one raises, naming its key.
        self._sentinel = maybe_sentinel()
        if self._sentinel is not None:
            self._sentinel.seal("fleet build")
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
        # The lane-asynchronous fleet's (module note): the lanes' current
        # scenario rows (a seed rewrites only its lanes' rows, so in-flight
        # lanes keep theirs), lane -> (qid, scenario, horizon) in flight,
        # qid -> trace row range, the queue-wait histogram and the exact
        # latencies kept beside the histograms, the rounds pumped and the
        # occupancy ledger.
        self._live_vectors = {k: v.copy() for k, v in self._vectors.items()}
        self._active: Dict[int, tuple] = {}
        self._trace_rows: Dict[int, tuple] = {}
        self.queue_wait_hist = LatencyHistogram()
        self.latency_exact_window: deque = deque(maxlen=_EXACT_LATENCY_WINDOW)
        self.pump_rounds = 0
        self.lane_busy_windows = np.zeros((self.n_lanes,), np.int64)
        self.lane_total_windows = np.zeros((self.n_lanes,), np.int64)
        # The host-fault injector (None: off, and no chaos branch is
        # taken) and the quarantine's policy and state.
        if host_chaos is None:
            host_chaos = HostChaos.from_flag(flag_str("KTPU_HOST_CHAOS"))
        self._chaos = host_chaos
        self.quarantine_faults = max(1, int(quarantine_faults))
        self.quarantine_window = max(1, int(quarantine_window))
        self.quarantine_backoff = max(1, int(quarantine_backoff))
        self._lane_fault_rounds: Dict[int, deque] = {}
        self._quarantine: Dict[int, Dict] = {}
        self.quarantine_events = 0
        self.readmissions = 0

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
        this raises ShutdownError. `trace_rows`: a (lo, hi) row range of the
        lane's slab row the query replays alone (hi None: to the end;
        lane-asynchronous fleets only, engine.set_lane_trace installs it
        when the query is seeded)."""
        if self._closing:
            raise ShutdownError(-1, "submit() after close(): the fleet is closed and admits no new queries")
        scen = self._validate_scenario(scenario)
        h = self.default_horizon if horizon is None else self._validate_positive("horizon", horizon, "simulated seconds")
        if deadline_s is not None:
            deadline_s = self._validate_positive("deadline_s", deadline_s, "host seconds from submit")
        if trace_rows is not None:
            if not self.lane_async:
                raise ValueError("trace_rows needs lane_async=True (the per-lane trace multiplexer)")
            lo, hi = trace_rows
            lo = int(lo)
            hi = None if hi is None else int(hi)
            if lo < 0 or (hi is not None and hi <= lo):
                raise ValueError(
                    f"submit(): trace_rows must satisfy 0 <= lo < hi (hi=None = end of trace), got {trace_rows!r}"
                )
            trace_rows = (lo, hi)
        if self.max_queue is not None and len(self._queue) >= self.max_queue and self.queue_policy == "block":
            while len(self._queue) >= self.max_queue:
                if self.lane_async:
                    self.pump()
                else:
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
        if trace_rows is not None:
            self._trace_rows[qid] = trace_rows
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
        self._trace_rows.pop(qid, None)
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

    def _lane_rows(self, lanes: Sequence[int]) -> Dict[int, Dict[str, int]]:  # ktpu: sync-ok(the lanes' counters, read where a wave's step or a pump round ends)
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
        """One wave, under the recompile sentinel where one is armed."""
        if self._sentinel is None:
            self._run_wave_inner(wave)
            return
        with self._sentinel.expect_none(f"fleet wave {self.waves_run + 1}"):
            self._run_wave_inner(wave)

    def _run_wave_inner(self, wave) -> None:
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

    # -- the lane-asynchronous pump (reference fleet.py:976-1199) -------------------

    def pump(self, span_windows: Optional[int] = None) -> int:
        """One lane-asynchronous round (module note): seed idle lanes from
        the queue, step up to `span_windows` global windows, drain the
        lanes whose plan ended. Returns the queries completed."""
        if not self.lane_async:
            raise ValueError("pump() needs lane_async=True (wave-aligned fleets run())")
        span = int(span_windows) if span_windows else self.span_windows
        if self._sentinel is None:
            drained = self._pump_inner(span)
        else:
            with self._sentinel.expect_none(f"fleet pump round {self.pump_rounds + 1}"):
                drained = self._pump_inner(span)
        self.pump_rounds += 1
        return drained

    def _seed_idle_lanes(self) -> None:
        """Seed each idle lane (not quarantined, or a quarantined lane's
        probe once its backoff passed) with the next queued query: its
        scenario rows, a reset of its state rows, its trace range (always
        installed, the whole trace where the query names none) and its
        clock from the current global window. A closing fleet admits
        nothing."""
        eng = self.engine
        assigned = []
        for lane in range(self.n_lanes):
            if lane in self._active or not self._queue or self._closing:
                continue
            q = self._quarantine.get(lane)
            if q is not None:
                if q["probing"] or self.pump_rounds < q["until_round"]:
                    continue
                q["probing"] = True
                self._push_lane_states()
            # An admitted query runs to its horizon: its deadline bounded
            # its queue wait alone.
            assigned.append((lane, *self._queue.popleft()[:3]))
        if not assigned:
            return
        for lane, _, scen, _ in assigned:
            for key in SCENARIO_KEYS:
                self._live_vectors[key][lane] = self._vectors[key][lane]
            for key, val in scen.overrides().items():
                self._live_vectors[key][lane] = val
        eng.update_scenario({k: v.copy() for k, v in self._live_vectors.items()})
        lanes = [lane for lane, _, _, _ in assigned]
        eng.lane_reset(lanes)
        for lane, qid, _, _ in assigned:
            lo, hi = self._trace_rows.pop(qid, (0, None))
            eng.set_lane_trace(lane, lo, hi)
        eng.set_lane_plan(lanes, eng.next_window_idx, [eng.horizon_windows(h) for _, _, _, h in assigned])
        t_admit = time.perf_counter_ns()
        tracer = eng.tracer
        for lane, qid, scen, horizon in assigned:
            self._active[lane] = (qid, scen, horizon)
            rec = self._lifecycle.get(qid)
            if rec is not None:
                rec["admitted_ns"] = t_admit
                rec["lane"] = lane
                tracer.end(PH_QUERY_QUEUE, rec["submitted_ns"], dur=t_admit - rec["submitted_ns"])

    def _pump_inner(self, span: int) -> int:
        eng = self.engine
        self._expire_deadlines()
        self._seed_idle_lanes()
        if not self._active:
            return 0
        t_dispatch = time.perf_counter_ns()
        for qid, _, _ in self._active.values():
            rec = self._lifecycle.get(qid)
            if rec is not None and "first_dispatch_ns" not in rec:
                rec["first_dispatch_ns"] = t_dispatch
        # Dispatch. With every lane busy, power-of-two chunks clamped to
        # the nearest plan end: no lane overshoots its horizon, and every
        # chunk lies inside every lane's span (the pieces without the
        # freeze); the round stops where a plan ends. Otherwise (the queue
        # ran dry, lanes idle) the whole span in one dispatch.
        remaining0 = eng.lane_windows_remaining()
        queue_fed = bool(self._queue)
        stepped = 0
        try:
            if len(self._active) == self.n_lanes:
                left = span
                remaining = remaining0.copy()
                while left > 0:
                    sub = 1 << (int(min(left, remaining.min())).bit_length() - 1)
                    self._dispatch(sub)
                    stepped += sub
                    left -= sub
                    remaining = remaining - sub
                    if (remaining <= 0).any():
                        break
            else:
                self._dispatch(span)
                stepped = span
        except Exception as exc:
            # A failing dispatch fails its lane's query (or, where it names
            # no lane, every active query), never the fleet. A recompile
            # sentinel's error is no lane fault: a fleet-level contract
            # broke, and it stays loud (reference fleet.py:1112-1124).
            if isinstance(exc, RecompileError):
                raise
            self._on_dispatch_fault(exc)
            return 0
        # The occupancy ledger: a lane is busy for the windows left on its
        # plan; an idle lane counts only while queries waited.
        for lane in range(self.n_lanes):
            if lane in self._active:
                self.lane_busy_windows[lane] += min(stepped, int(remaining0[lane]))
                self.lane_total_windows[lane] += stepped
            elif queue_fed:
                self.lane_total_windows[lane] += stepped
        done = eng.lane_windows_done()
        finished = [lane for lane in sorted(self._active) if done[lane]]
        if not finished:
            return 0
        rows = self._lane_rows(finished)
        t_drain = time.perf_counter_ns()
        obs = eng.observatory
        tracer = eng.tracer
        for lane in finished:
            qid, scen, horizon = self._active.pop(lane)
            self._drain_lane(qid, lane, horizon, scen, rows, self.pump_rounds)
            q = self._quarantine.get(lane)
            if q is not None and q["probing"]:
                # The probe finished: the lane is re-admitted and its fault
                # history cleared.
                del self._quarantine[lane]
                self._lane_fault_rounds.pop(lane, None)
                self.readmissions += 1
                tracer.end(PH_LANE_QUARANTINE, q["since_ns"], dur=t_drain - q["since_ns"])
                if obs is not None:
                    obs.note_lane_readmitted(lane, probes=q["probes"] + 1)
                self._push_lane_states()
            rec = self._lifecycle.get(qid)
            lat = queue_wait = service = 0.0
            if rec is not None:
                rec["drained_ns"] = t_drain
                t_sub = rec["submitted_ns"]
                t_adm = rec.get("admitted_ns", t_sub)
                tracer.end(PH_QUERY_SERVICE, t_adm, dur=t_drain - t_adm)
                if rec["flow_id"]:
                    tracer.flow_end(PH_QUERY_QUEUE, rec["flow_id"])
                tracer.lane_event(lane, qid, t_adm, t_drain - t_adm)
                lat, queue_wait, service = (t_drain - t_sub) / 1e9, (t_adm - t_sub) / 1e9, (t_drain - t_adm) / 1e9
            self.latency_hist.record(lat)
            self.queue_wait_hist.record(queue_wait)
            self.service_hist.record(service)
            self.latency_exact_window.append(lat)
            if obs is not None:
                obs.note_query(lat, queue_wait, service)
        return len(finished)

    # -- fault isolation and quarantine (reference fleet.py:1201-1321) ---------------

    def _dispatch(self, n_windows: int) -> None:
        """One engine dispatch, with the host-chaos injection point: a
        stall sleeps before it, a dispatch fault raises InjectedFault in
        its place (the state untouched). Chaos off: the plain call."""
        chaos = self._chaos
        if chaos is not None:
            stall = chaos.stall_s()
            if stall > 0.0:
                time.sleep(stall)
            victim = chaos.dispatch_fault(self._active)
            if victim is not None:
                raise InjectedFault(f"host-chaos: injected dispatch fault on lane {victim} (seed {chaos.seed})",
                                    lane=victim)
        self.engine.step_windows(n_windows)

    def _on_dispatch_fault(self, exc: Exception) -> None:
        """Fail the victim lane's query (or every active one where the
        error names no lane) with a LaneFaultError, reset the lanes from
        the pristine snapshot and give them a zero-window plan, so the
        clock mirrors read them as done until they are seeded again."""
        eng = self.engine
        victim = getattr(exc, "lane", None)
        lanes = [int(victim)] if victim is not None and victim in self._active else sorted(self._active)
        for lane in lanes:
            qid, scen, horizon = self._active.pop(lane)
            self._fail_query(qid, LaneFaultError(
                qid,
                f"query {qid}: lane {lane} dispatch failed ({type(exc).__name__}: {exc}); lane crash-reset, "
                "neighbors unaffected",
                lane=lane, cause=exc, scenario=scen, horizon=horizon,
            ))
            self._note_lane_fault(lane)
        eng.lane_reset(lanes)
        eng.set_lane_plan(lanes, eng.next_window_idx, [0] * len(lanes))

    def _note_lane_fault(self, lane: int) -> None:
        """Quarantine bookkeeping of one lane fault: a faulting probe
        doubles the backoff; `quarantine_faults` faults within
        `quarantine_window` rounds quarantine the lane."""
        obs = self.engine.observatory
        q = self._quarantine.get(lane)
        if q is not None:
            q["backoff"] = min(q["backoff"] * 2, 1 << 16)
            q["until_round"] = self.pump_rounds + q["backoff"]
            q["probing"] = False
            q["probes"] += 1
            if obs is not None:
                obs.note_lane_quarantined(lane, backoff_rounds=q["backoff"], probed=True)
            self._push_lane_states()
            return
        rounds = self._lane_fault_rounds.setdefault(lane, deque(maxlen=self.quarantine_faults))
        rounds.append(self.pump_rounds)
        if len(rounds) >= self.quarantine_faults and self.pump_rounds - rounds[0] <= self.quarantine_window:
            self._quarantine[lane] = {
                "backoff": self.quarantine_backoff,
                "until_round": self.pump_rounds + self.quarantine_backoff,
                "probing": False,
                "probes": 0,
                "since_ns": time.perf_counter_ns(),
            }
            rounds.clear()
            self.quarantine_events += 1
            if obs is not None:
                obs.note_lane_quarantined(lane, backoff_rounds=self.quarantine_backoff, probed=False)
            self._push_lane_states()

    def lane_states(self) -> List[str]:
        """Each lane's admission state: 'active' (a query in flight),
        'idle', 'quarantined' (backoff pending) or 'probe' (backoff over:
        its next admission, or the one in flight, is a probe)."""
        out = []
        for lane in range(self.n_lanes):
            q = self._quarantine.get(lane)
            if q is not None:
                out.append("probe" if q["probing"] or self.pump_rounds >= q["until_round"] else "quarantined")
            elif lane in self._active:
                out.append("active")
            else:
                out.append("idle")
        return out

    def _push_lane_states(self) -> None:
        obs = self.engine.observatory
        if obs is not None:
            obs.note_lane_states(self.lane_states())

    def arm_host_chaos(self, chaos: Optional[HostChaos]) -> None:
        """Attach the host-fault injector (None detaches it)."""
        self._chaos = chaos

    def fault_report(self) -> Dict:
        """Availability and the fault domains' counters: completed and
        failed queries by kind, quarantines and re-admissions, the lanes'
        states, the injector's events."""
        completed_ok = sum(1 for r in self.results.values() if getattr(r, "ok", True))
        submitted = self._next_query
        return {
            "submitted": submitted,
            "completed": completed_ok,
            "failed": dict(self.failed_queries),
            "availability": completed_ok / submitted if submitted else 1.0,
            "quarantine_events": self.quarantine_events,
            "readmissions": self.readmissions,
            "lane_states": self.lane_states(),
            "chaos": self._chaos.report() if self._chaos is not None else None,
        }

    def run_async(self, span_windows: Optional[int] = None) -> Dict[int, Union[FleetResult, QueryError]]:
        """Pump until the queue and every lane in flight drain; returns
        `results` (run()'s map: the same numbers a query by query)."""
        if not self.lane_async:
            raise ValueError("run_async() needs lane_async=True (wave-aligned fleets run())")
        while self._queue or self._active:
            self.pump(span_windows)
        return self.results

    def lane_occupancy(self) -> Dict[str, float]:
        """The busy share of dispatched lane-windows from the pump's
        ledger, its mean and min over the lanes (1.0 before any round)."""
        total = np.maximum(self.lane_total_windows, 1)
        frac = self.lane_busy_windows / total
        if not self.lane_total_windows.any():
            frac = np.ones_like(frac)
        return {
            "mean": float(frac.mean()),
            "min": float(frac.min()),
            "lane_windows_busy": int(self.lane_busy_windows.sum()),
            "lane_windows_total": int(self.lane_total_windows.sum()),
        }

    def reset_query_stats(self) -> None:
        """Forget the latency histograms, the exact latencies and the
        occupancy ledger, with the observatory's query statistics at once
        (results stay)."""
        self.latency_hist.reset()
        self.queue_wait_hist.reset()
        self.service_hist.reset()
        self.latency_exact_window.clear()
        self.lane_busy_windows[:] = 0
        self.lane_total_windows[:] = 0
        if self.engine.observatory is not None:
            self.engine.observatory.reset_query_stats()

    def query_latency_percentiles(self) -> Dict[str, float]:
        """Submit-to-drain wall latency percentiles (ms) from the
        histogram; {"count": 0} before any."""
        h = self.latency_hist
        if h.count == 0:
            return {"count": 0}
        out: Dict[str, float] = {"count": h.count}
        out.update(h.percentiles_ms())
        return out

    def query_latency_breakdown(self) -> Dict[str, object]:
        """Queue wait (submit -> admission) against service (admission ->
        drain) percentiles, and the latency histogram's dump."""
        return {
            "queue_wait_ms": self.queue_wait_hist.percentiles_ms(),
            "service_ms": self.service_hist.percentiles_ms(),
            "histogram": self.latency_hist.to_dict(),
        }

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
        in_flight = sorted(q for q, _, _ in self._active.values())
        return (
            f"{self._next_query} submitted (qids 0..{self._next_query - 1}), {len(self.results)} completed "
            f"({len(self._completed)} unpolled), in-flight qids {in_flight}, {len(self._queue)} queued"
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

    def close(self, drain: bool = True) -> None:
        """Graceful shutdown: admit nothing more (submit() raises
        ShutdownError), finish the queries in flight (a lane-asynchronous
        fleet pumps until its lanes drain; drain=False fails them with a
        ShutdownError instead; a wave's queries have all drained when
        run() returns), fail every query still queued with a ShutdownError
        through the completion stream, and close the engine (its feeder).
        poll() keeps working: the outcomes are host state."""
        if self._closed:
            return
        self._closing = True
        if self.lane_async and self._active:
            if drain:
                while self._active:
                    self.pump()
            else:
                for lane in sorted(self._active):
                    qid, scen, horizon = self._active.pop(lane)
                    self._fail_query(qid, ShutdownError(
                        qid, f"query {qid} was in flight at close(drain=False)", lane=lane, scenario=scen,
                        horizon=horizon,
                    ))
        while self._queue:
            qid, scen, horizon, _ = self._queue.popleft()
            self._fail_query(qid, ShutdownError(
                qid,
                f"query {qid} was still queued at close(); the graceful drain fails queued queries",
                scenario=scen, horizon=horizon,
            ))
        self._closed = True
        if self._sentinel is not None:
            self._sentinel.uninstall()
            self._sentinel = None
        self.engine.close()

