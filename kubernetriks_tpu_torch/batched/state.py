"""Dense tensor state of the batched simulation.

Clusters step together as (C, N) node-slot and (C, P) pod-slot tensors;
payloads (capacities, requests, durations) are staged per slot from the
compiled trace, and events only flip phases and masks. Every leaf has the
dtype of the JAX reference's leaf of the same name (`kubernetriks_tpu/
batched/state.py`): int32 resources (ram in RAM_UNIT units), float32
offsets, bool masks, and time as the (win, off) pairs of timerep.py.

The state is a tree of NamedTuples of tensors. `flatten` names each leaf
by its attribute path (".pods.queue_ts.win"), the same strings the JAX
reference's `jax.tree_util.keystr` gives, so the two states compare leaf
for leaf as flat numpy dicts (`compare_states`, convert.py). Optional
subtrees (the autoscaler state `auto`, and its HPA collection latch, and
the flight recorder's ring `telemetry`) are None when absent and then have
no leaves, as in the reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Set

import numpy as np
import torch

from kubernetriks_tpu_torch.batched.timerep import TPair, from_f64_np, t_inf, t_zeros

# Pod phases.
PHASE_EMPTY = 0  # slot not yet created
PHASE_QUEUED = 1  # in the scheduler's active queue
PHASE_UNSCHEDULABLE = 2  # parked in the unschedulable queue
PHASE_RUNNING = 3  # bound to a node (incl. binding in flight)
PHASE_SUCCEEDED = 4
PHASE_REMOVED = 5
PHASE_FAILED = 6

# Event kinds in the compiled trace slab.
EV_NONE = 0
EV_CREATE_NODE = 1
EV_REMOVE_NODE = 2
EV_CREATE_POD = 3
EV_REMOVE_POD = 4
EV_NODE_CRASH = 5  # chaos: remove semantics, with crash accounting
EV_NODE_RECOVER = 6  # chaos: create semantics on a fresh slot

DEFAULT_RAM_UNIT = 1024 * 1024  # 1 MiB

INF = float("inf")


class NodeArrays(NamedTuple):
    """(C, N) per-node-slot tensors."""

    alive: torch.Tensor  # bool
    cap_cpu: torch.Tensor  # int32 millicores
    cap_ram: torch.Tensor  # int32 ram units
    alloc_cpu: torch.Tensor  # int32
    alloc_ram: torch.Tensor  # int32
    # Pending cluster-autoscaler effects (node comes up / goes down at
    # this time); +inf = none.
    create_time: TPair
    remove_time: TPair
    crash_downtime: torch.Tensor  # float32 seconds: a crashing slot's repair span (0 otherwise)


class PodArrays(NamedTuple):
    """(C, P) per-pod-slot tensors."""

    phase: torch.Tensor  # int32
    req_cpu: torch.Tensor  # int32 millicores
    req_ram: torch.Tensor  # int32 ram units
    # Running duration as a time pair; win < 0 marks a long-running service.
    duration: TPair
    queue_ts: TPair  # queue-priority / eligibility timestamp
    queue_seq: torch.Tensor  # int32 FIFO tie-break within equal timestamps
    initial_attempt_ts: TPair
    attempts: torch.Tensor  # int32
    node: torch.Tensor  # int32 node slot, -1 = none
    start_time: TPair
    finish_time: TPair  # +inf = no pending finish
    removal_time: TPair  # pending HPA scale-down effect; +inf = none
    hpa_idx: torch.Tensor  # int32 HPA replica index of the occupant; -1 = none
    restarts: torch.Tensor  # int32 CrashLoopBackOff restarts so far
    will_fail: torch.Tensor  # bool


class EstArrays(NamedTuple):
    """(C,) streaming estimator accumulators (count/sum/sum of squares/
    min/max -> min/max/mean/variance at readout)."""

    count: torch.Tensor  # int32
    total: torch.Tensor  # float32
    total_sq: torch.Tensor  # float32
    minimum: torch.Tensor  # float32
    maximum: torch.Tensor  # float32

    @staticmethod
    def zeros(shape, device) -> "EstArrays":
        return EstArrays(
            count=torch.zeros(shape, dtype=torch.int32, device=device),
            total=torch.zeros(shape, dtype=torch.float32, device=device),
            total_sq=torch.zeros(shape, dtype=torch.float32, device=device),
            minimum=torch.full(shape, INF, dtype=torch.float32, device=device),
            maximum=torch.full(shape, -INF, dtype=torch.float32, device=device),
        )


class MetricArrays(NamedTuple):
    """(C,) per-cluster counters, in the reference's field order."""

    pods_succeeded: torch.Tensor
    pods_removed: torch.Tensor
    terminated_pods: torch.Tensor
    processed_nodes: torch.Tensor
    scheduling_decisions: torch.Tensor  # successful assignments
    scaled_up_pods: torch.Tensor
    scaled_down_pods: torch.Tensor
    scaled_up_nodes: torch.Tensor
    scaled_down_nodes: torch.Tensor
    hpa_reserve_clamped: torch.Tensor
    ca_reserve_starved: torch.Tensor
    node_crashes: torch.Tensor
    node_recoveries: torch.Tensor
    node_downtime_s: torch.Tensor  # float32
    pod_interruptions: torch.Tensor
    pod_restarts: torch.Tensor
    pods_failed: torch.Tensor
    queue_time: EstArrays
    algo_latency: EstArrays
    pod_duration: EstArrays


class AutoscaleState(NamedTuple):
    """Dynamic autoscaler state (the reference's `AutoscaleState`). The
    ca_alloc / ca_total / ca_reclaimed leaves are CA slot reclaim's,
    present only when the engine runs it; without them ca_cursor is the
    monotone next-slot cursor, with them the live occupancy of each
    group's reserve. The col_* leaves are the HPA's 60 s metrics
    collection latch, present only when a pod group can be scaled."""

    hpa_head: torch.Tensor  # (C, Gp) int32 replicas ever removed
    hpa_tail: torch.Tensor  # (C, Gp) int32 replicas ever created
    ca_count: torch.Tensor  # (C, Gn) int32 current CA nodes per group
    ca_cursor: torch.Tensor  # (C, Gn) int32 next reserved slot offset
    hpa_next: TPair  # (C,) next HPA tick
    ca_next: TPair  # (C,) next CA cycle fire time
    # The occupant's allocation index (names are "{group}_{alloc + 1}");
    # -1 a free slot. Occupied slots are each group's reserve prefix
    # [ng_ca_start, ng_ca_start + ca_cursor), in allocation order.
    ca_alloc: Optional[torch.Tensor] = None  # (C, S) int32
    ca_total: Optional[torch.Tensor] = None  # (C, Gn) int32 allocations ever made
    ca_reclaimed: Optional[torch.Tensor] = None  # (C,) int32 slots returned to the reserve
    col_next: Optional[TPair] = None  # (C,) next metrics collection
    col_run: Optional[torch.Tensor] = None  # (C, Gp) int32 running pods then
    col_util_cpu: Optional[torch.Tensor] = None  # (C, Gp) float32
    col_util_ram: Optional[torch.Tensor] = None  # (C, Gp) float32


class ClusterBatchState(NamedTuple):
    """Complete batched simulation state, leading axis C everywhere."""

    time: torch.Tensor  # (C,) int32 last completed window index
    queue_seq_counter: torch.Tensor  # (C,) int32 next queue sequence number
    event_cursor: torch.Tensor  # (C,) int32 next unapplied trace event
    pod_base: torch.Tensor  # (C,) int32 (0: whole trace resident)
    last_flush_win: torch.Tensor  # (C,) int32 last unschedulable flush window
    requeue_signal: torch.Tensor  # (C,) bool node-add/pod-finish since last cycle
    nodes: NodeArrays
    pods: PodArrays
    metrics: MetricArrays
    auto: Optional[AutoscaleState] = None  # None: no autoscaler configured
    # The flight recorder's per-window ring (TelemetryRing); None: telemetry off.
    telemetry: Optional["TelemetryRing"] = None


# Columns of the telemetry ring (TelemetryRing.buf), as the reference's
# (`kubernetriks_tpu/batched/state.py:219-278`). All int32, one row per
# cluster and executed window.
TELEM_WINDOW = 0  # the window this row describes
TELEM_DECISIONS = 1  # scheduling decisions committed in the window
TELEM_QUEUED = 2  # active-queue depth after the window
TELEM_UNSCHED = 3  # unschedulable-queue depth after the window
TELEM_HPA_PODS = 4  # HPA pod actions in the window (scale-ups + scale-downs)
TELEM_CA_NODES = 5  # CA node actions in the window (scale-ups + scale-downs)
TELEM_FAULTS = 6  # chaos events in the window (crashes, recoveries, interruptions, restarts, failures)
TELEM_ALIVE_NODES = 7  # alive nodes after the window
TELEM_HPA_RESERVE = 8  # live HPA replicas over the groups (hpa_tail - hpa_head)
TELEM_CA_RESERVE = 9  # CA reserve slots in use (ca_cursor; under slot reclaim the live occupancy)
# Plain-trace slots the device pod window has not covered yet
# (trace_pod_bound - pod_base - plain width); at or above the observatory's
# UNBOUNDED_SENTINEL where the whole trace is resident.
TELEM_POD_HEADROOM = 10
TELEM_LANE_ACTIVE = 11  # 1: the lane was active in the window (always 1 without fleets)
TELEMETRY_COLS = 12

# The metric counters a ring row takes window deltas of, in the order of
# the record's snapshot of the incoming counters (m0, (len, C) int32).
TELEM_COUNTERS = (
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


class TelemetryRing(NamedTuple):
    """(C, R, TELEMETRY_COLS) per-window metrics ring, carried in the state
    like `auto` (None: telemetry off). Every executed window writes one row
    a cluster at cursor % R and bumps the cursor; the engine drains it
    only where the host already blocks. Unwritten rows hold window -1."""

    buf: torch.Tensor  # (C, R, TELEMETRY_COLS) int32
    cursor: torch.Tensor  # (C,) int32 windows recorded (slot = cursor % R)


def strip_telemetry(state: ClusterBatchState) -> ClusterBatchState:
    """The state without its telemetry ring: what a telemetry-on run must
    equal, leaf for leaf, against the same run with telemetry off."""
    return state._replace(telemetry=None)


def counter_snapshot(metrics: MetricArrays) -> torch.Tensor:
    """(len(TELEM_COUNTERS), C) int32: the counters the ring takes window
    deltas of, stacked (a new tensor)."""
    return torch.stack([getattr(metrics, name) for name in TELEM_COUNTERS])


class LaneClocks(NamedTuple):
    """The lane-asynchronous engine's per-lane window clocks (reference
    `StepConstants.lane_clock` / `lane_horizon`, its SCENARIO_TRACED_CONSTS,
    state.py:584-618): lane c runs its own virtual window w - clock[c] at
    global window w, and is active while that lies in [0, horizon[c]).
    Fixed (C,) int32 tensors the captured graphs read: a re-seed writes
    them in place (engine.set_lane_plan), never replaces them. The engine
    keeps int64 host mirrors of both (`_lane_clock_np`,
    `_lane_horizon_np`), which its host arithmetic reads instead."""

    lane_clock: torch.Tensor  # (C,) int32 global window of each lane's virtual window 0
    lane_horizon: torch.Tensor  # (C,) int32 windows each lane runs (0: idle)

    @staticmethod
    def fresh(C: int, device) -> "LaneClocks":
        """Every lane inactive (horizon 0)."""
        return LaneClocks(
            lane_clock=torch.zeros((C,), dtype=torch.int32, device=device),
            lane_horizon=torch.zeros((C,), dtype=torch.int32, device=device),
        )


class TraceSlab(NamedTuple):
    """(C, E, 4) int32 compiled trace events, time-sorted per cluster:
    [win, off-bits, kind, slot], padded with EV_NONE at win = INF_WIN."""

    packed: torch.Tensor

    @staticmethod
    def build(win, off, kind, slot, device) -> "TraceSlab":
        packed = np.stack(
            [
                np.asarray(win, np.int32),
                np.asarray(off, np.float32).view(np.int32),
                np.asarray(kind, np.int32),
                np.asarray(slot, np.int32),
            ],
            axis=-1,
        )
        return TraceSlab(packed=torch.from_numpy(np.ascontiguousarray(packed)).to(device))


class RefillStage(NamedTuple):
    """The sliding pod window's refill payload over plain pod columns [lo,
    lo + L), (C, L) each (reference `RefillStage`, state.py:284): requests,
    duration pairs, create windows and, with the autoscalers, pod-name
    ranks (None without them). Columns past the plain segment carry the
    fresh-slot padding (trace_compile.stage_segment), so a stage near the
    trace's end slides exactly as the whole-trace payload (lo = 0, L = T +
    W) does. The slide reads it at columns base - lo (step.slide_*)."""

    req_cpu: torch.Tensor  # (C, L) int32 millicores
    req_ram: torch.Tensor  # (C, L) int32 ram units
    dur_win: torch.Tensor  # (C, L) int32 duration pair (win < 0: a service)
    dur_off: torch.Tensor  # (C, L) float32
    create_win: torch.Tensor  # (C, L) int32 create window; INT32_MAX: none
    rank: Optional[torch.Tensor] = None  # (C, L) int32 pod-name ranks


def stage_arrays_np(seg: Dict[str, np.ndarray], interval: float) -> Dict[str, np.ndarray]:
    """A host segment of trace_compile.stage_segment (float64 durations)
    as RefillStage's fields (the duration pair), C-contiguous numpy."""
    out = dict(seg)
    out["dur_win"], out["dur_off"] = duration_pair_np(out.pop("duration"), interval)
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def stage_nbytes(stage: Optional[RefillStage]) -> int:
    return 0 if stage is None else sum(int(t.numel() * t.element_size()) for t in flatten(stage).values())


class StepConstants(NamedTuple):
    """Per-run scalars derived from SimulationConfig: the control-plane hop
    delays composed into effective offsets."""

    scheduling_interval: float
    time_per_node: float  # scheduler latency model: 1 us per alive node
    delta_pod_enqueue: float  # create -> pod in scheduler queue
    delta_bind_start: float  # assignment (incl. cycle duration) -> pod starts
    delta_reschedule: float  # node removal -> its pods re-enqueued
    flush_interval: float  # 30 s
    max_unschedulable_stay: float  # 300 s
    # Global pod slots below trace_pod_bound are plain trace pods mapped to
    # device slots by subtracting pod_base (identity on whole-trace runs).
    trace_pod_bound: int = 1 << 30
    resident_shift: int = 0


def make_step_constants(config) -> StepConstants:
    """Compose effective delays from the six config delays."""
    return StepConstants(
        scheduling_interval=config.scheduling_cycle_interval,
        time_per_node=1e-6,
        delta_pod_enqueue=config.as_to_ps_network_delay
        + config.ps_to_sched_network_delay,
        delta_bind_start=config.sched_to_as_network_delay
        + 2.0 * config.as_to_ps_network_delay
        + config.as_to_node_network_delay,
        delta_reschedule=config.as_to_node_network_delay
        + config.as_to_ps_network_delay
        + config.ps_to_sched_network_delay,
        flush_interval=30.0,
        max_unschedulable_stay=300.0,
    )


def duration_pair_np(pod_duration: np.ndarray, interval: float):
    """Host float64 durations -> (win, off) numpy pair; < 0 marks a
    long-running service (win = -1)."""
    dur = np.asarray(pod_duration, np.float64)
    service = dur < 0
    dwin, doff = from_f64_np(np.where(service, 0.0, dur), interval)
    return (
        np.where(service, -1, dwin).astype(np.int32),
        np.where(service, 0.0, doff).astype(np.float32),
    )


def fresh_pod_arrays(
    C: int, P: int, req_cpu: torch.Tensor, req_ram: torch.Tensor, duration: TPair
) -> PodArrays:
    """Pod slots in their pristine state (EMPTY, never created) around the
    given (C, P) payload tensors, which become leaves as they are: the one
    source of fresh-slot defaults, shared by init_state and the sliding pod
    window's refill and growth (reference `fresh_pod_arrays`, state.py:411)."""
    dev = req_cpu.device

    def zeros_i32():
        return torch.zeros((C, P), dtype=torch.int32, device=dev)

    return PodArrays(
        phase=zeros_i32(),
        req_cpu=req_cpu,
        req_ram=req_ram,
        duration=duration,
        queue_ts=t_zeros((C, P), dev),
        queue_seq=zeros_i32(),
        initial_attempt_ts=t_zeros((C, P), dev),
        attempts=zeros_i32(),
        node=torch.full((C, P), -1, dtype=torch.int32, device=dev),
        start_time=t_zeros((C, P), dev),
        finish_time=t_inf((C, P), dev),
        removal_time=t_inf((C, P), dev),
        hpa_idx=torch.full((C, P), -1, dtype=torch.int32, device=dev),
        restarts=zeros_i32(),
        will_fail=torch.zeros((C, P), dtype=torch.bool, device=dev),
    )


def fresh_pods_np(req_cpu: np.ndarray, req_ram: np.ndarray, duration: np.ndarray, interval: float, device) -> PodArrays:
    """fresh_pod_arrays around host payload columns (float64 durations, < 0
    a long-running service), copied to `device`."""
    dwin, doff = duration_pair_np(duration, interval)
    dev = torch.device(device)
    C, P = np.shape(req_cpu)

    def copy(x, dtype):  # a copy: no two leaves share memory (they are updated in place)
        return torch.tensor(np.asarray(x, dtype), device=dev)

    return fresh_pod_arrays(
        C, P, copy(req_cpu, np.int32), copy(req_ram, np.int32),
        TPair(win=copy(dwin, np.int32), off=copy(doff, np.float32)),
    )


def init_state(
    n_clusters: int,
    n_nodes: int,
    n_pods: int,
    node_cap_cpu: np.ndarray,
    node_cap_ram: np.ndarray,
    pod_req_cpu: np.ndarray,
    pod_req_ram: np.ndarray,
    pod_duration: np.ndarray,
    interval: float,
    device,
    node_crash_downtime: Optional[np.ndarray] = None,
) -> ClusterBatchState:
    """The initial state with pre-staged payloads (all slots start
    EMPTY/dead; trace events bring them to life). pod_duration: float64
    seconds, < 0 marks a long-running service. node_crash_downtime: (C, N)
    float32 repair span of each crashing slot (zeros without faults)."""
    C, N, P = n_clusters, n_nodes, n_pods
    dev = torch.device(device)

    def i32(x):  # a copy: no two leaves share memory (they are updated in place)
        return torch.tensor(np.asarray(x, np.int32), device=dev)

    def zeros_i32(shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    nodes = NodeArrays(
        alive=torch.zeros((C, N), dtype=torch.bool, device=dev),
        cap_cpu=i32(node_cap_cpu),
        cap_ram=i32(node_cap_ram),
        alloc_cpu=i32(node_cap_cpu),
        alloc_ram=i32(node_cap_ram),
        create_time=t_inf((C, N), dev),
        remove_time=t_inf((C, N), dev),
        crash_downtime=(
            torch.zeros((C, N), dtype=torch.float32, device=dev)
            if node_crash_downtime is None
            else torch.tensor(np.asarray(node_crash_downtime, np.float32), device=dev)
        ),
    )
    pods = fresh_pods_np(pod_req_cpu, pod_req_ram, pod_duration, interval, dev)
    counters = {name: zeros_i32((C,)) for name in MetricArrays._fields[:17]}
    counters["node_downtime_s"] = torch.zeros((C,), dtype=torch.float32, device=dev)
    metrics = MetricArrays(
        **counters,
        queue_time=EstArrays.zeros((C,), dev),
        algo_latency=EstArrays.zeros((C,), dev),
        pod_duration=EstArrays.zeros((C,), dev),
    )
    return ClusterBatchState(
        time=zeros_i32((C,)),
        queue_seq_counter=zeros_i32((C,)),
        event_cursor=zeros_i32((C,)),
        pod_base=zeros_i32((C,)),
        last_flush_win=zeros_i32((C,)),
        requeue_signal=torch.zeros((C,), dtype=torch.bool, device=dev),
        nodes=nodes,
        pods=pods,
        metrics=metrics,
    )


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Leaves of a NamedTuple tree keyed by attribute path (".a.b"); None
    subtrees have no leaves."""
    if tree is None:
        return {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out: Dict[str, torch.Tensor] = {}
        for name in tree._fields:
            out.update(flatten(getattr(tree, name), f"{prefix}.{name}"))
        return out
    return {prefix: tree}


def clone_state(tree):
    """A copy of a NamedTuple tree, every leaf cloned (None subtrees stay
    None): a snapshot that later in-place steps do not touch."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[clone_state(getattr(tree, f)) for f in tree._fields])
    return tree.clone()


def copy_state_into(dst, src, fixed: Optional[Set[int]] = None) -> int:
    """Copy every leaf of the tree `src` into the leaf of the same path of
    `dst`, in place, so `dst` keeps its tensors (and their addresses, which
    a captured CUDA graph reads). A leaf that already is dst's own tensor
    is skipped. Raises if the leaf sets, shapes or dtypes differ, or if a
    src leaf lies in the memory of another destination (`fixed`: the
    storage addresses of every buffer that must not be a source; by
    default dst's leaves'): copying into that one first would overwrite it.
    Returns the number of leaves copied."""
    d, s = flatten(dst), flatten(src)
    if set(d) != set(s):
        raise ValueError(f"copy_state_into: leaf sets differ: {sorted(set(d) ^ set(s))}")
    if fixed is None:
        fixed = storages(d.values())
    pending = []
    for path, t in s.items():
        tgt = d[path]
        if t is tgt:
            continue
        if t.shape != tgt.shape or t.dtype != tgt.dtype:
            raise ValueError(
                f"copy_state_into: leaf {path} is {t.dtype}{tuple(t.shape)}, "
                f"the buffer {tgt.dtype}{tuple(tgt.shape)}"
            )
        if t.numel() and t.untyped_storage().data_ptr() in fixed and (
            t.untyped_storage().data_ptr() != tgt.untyped_storage().data_ptr()
        ):
            raise ValueError(f"copy_state_into: the new {path} lies in another buffer's memory")
        pending.append((tgt, t))
    for tgt, t in pending:
        tgt.copy_(t)
    return len(pending)


def storages(tensors) -> Set[int]:
    """The storage addresses of the non-empty tensors."""
    return {t.untyped_storage().data_ptr() for t in tensors if t.numel()}


def unflatten(cls, leaves: Dict[str, object], prefix: str = ""):
    """Inverse of `flatten`: `cls` is the root NamedTuple type; the types
    of nested NamedTuple fields come from `_TREE_TYPES`. An optional field
    with no leaf under its path is None; a missing required leaf raises
    KeyError."""
    kwargs = {}
    for name in cls._fields:
        path = f"{prefix}.{name}"
        if (cls.__name__, name) in _OPTIONAL_FIELDS and not any(
            k == path or k.startswith(path + ".") for k in leaves
        ):
            kwargs[name] = None
            continue
        sub = _TREE_TYPES.get((cls.__name__, name))
        kwargs[name] = unflatten(sub, leaves, path) if sub is not None else leaves[path]
    return cls(**kwargs)


# (parent type, field) -> NamedTuple type of that field.
_TREE_TYPES = {
    ("ClusterBatchState", "nodes"): NodeArrays,
    ("ClusterBatchState", "pods"): PodArrays,
    ("ClusterBatchState", "metrics"): MetricArrays,
    ("NodeArrays", "create_time"): TPair,
    ("NodeArrays", "remove_time"): TPair,
    **{
        ("PodArrays", f): TPair
        for f in (
            "duration",
            "queue_ts",
            "initial_attempt_ts",
            "start_time",
            "finish_time",
            "removal_time",
        )
    },
    ("MetricArrays", "queue_time"): EstArrays,
    ("MetricArrays", "algo_latency"): EstArrays,
    ("MetricArrays", "pod_duration"): EstArrays,
    ("ClusterBatchState", "auto"): AutoscaleState,
    ("AutoscaleState", "hpa_next"): TPair,
    ("AutoscaleState", "ca_next"): TPair,
    ("AutoscaleState", "col_next"): TPair,
    ("ClusterBatchState", "telemetry"): TelemetryRing,
}

# Fields that may be None (absent subtrees).
_OPTIONAL_FIELDS = {
    ("ClusterBatchState", "auto"),
    ("ClusterBatchState", "telemetry"),
    ("AutoscaleState", "ca_alloc"),
    ("AutoscaleState", "ca_total"),
    ("AutoscaleState", "ca_reclaimed"),
    ("AutoscaleState", "col_next"),
    ("AutoscaleState", "col_run"),
    ("AutoscaleState", "col_util_cpu"),
    ("AutoscaleState", "col_util_ram"),
}


# Leaf manifests of the state NamedTuples, for the stateleaf lint pass
# (kubernetriks_tpu_torch/lint/stateleaf.py; reference batched/state.py:
# 550-600): each equals its class's fields. Adding a leaf without adding it
# here fails the pass, naming the leaf: the anchor of "how to add a state
# leaf" (its consumers: convert.state_to_numpy / state_from_numpy, the
# checkpoint's flatten_tree, the engine's _reset_rows, step.freeze_lanes_,
# strip_telemetry, compare_states and sanitize's address check).
CLUSTER_STATE_LEAVES = (
    "time",
    "queue_seq_counter",
    "event_cursor",
    "pod_base",
    "last_flush_win",
    "requeue_signal",
    "nodes",
    "pods",
    "metrics",
    "auto",
    "telemetry",
)
TELEMETRY_RING_LEAVES = ("buf", "cursor")
AUTOSCALE_STATE_LEAVES = (
    "hpa_head",
    "hpa_tail",
    "ca_count",
    "ca_cursor",
    "hpa_next",
    "ca_next",
    "ca_alloc",
    "ca_total",
    "ca_reclaimed",
    "col_next",
    "col_run",
    "col_util_cpu",
    "col_util_ram",
)
LANE_CLOCK_LEAVES = ("lane_clock", "lane_horizon")

# Per-lane traced scenario data outside the autoscaler statics (reference
# batched/state.py:586 SCENARIO_TRACED_CONSTS, trimmed to the port's
# leaves): the pod-fault seed vector (step.FaultStep.fault_seed, the
# engine's _fault_seeds) and the lane clocks (LaneClocks). The
# scenariotrace lint pass forbids them from flowing into Python control
# flow, host casts, shape expressions or a piece key; `is None` presence
# checks stay legal. The host mirrors live under other names
# (engine._lane_clock_np / _lane_horizon_np), so host arithmetic never
# reads the device leaves.
SCENARIO_TRACED_CONSTS = ("fault_seed", "lane_clock", "lane_horizon")

# Declared axis signatures of state leaves (the shapecontract lint pass;
# reference batched/state.py:614, without its lane-major half: the port
# keeps every node leaf (C, N)). "C" = per-cluster lane vector, "C,P" /
# "C,N" = per-object planes, "C,*" = leading C with an unspecified second
# axis (PodArrays (C, P) and RefillStage (C, L) share these names).
AXIS_SIGNATURES = {
    "time": "C",
    "lane_clock": "C",
    "lane_horizon": "C",
    "queue_seq_counter": "C",
    "event_cursor": "C",
    "pod_base": "C",
    "last_flush_win": "C",
    "requeue_signal": "C",
    # PodArrays
    "phase": "C,P",
    "req_cpu": "C,*",
    "req_ram": "C,*",
    "duration": "C,P",
    "queue_ts": "C,P",
    "queue_seq": "C,P",
    "initial_attempt_ts": "C,P",
    "attempts": "C,P",
    "hpa_idx": "C,P",
    "restarts": "C,P",
    "will_fail": "C,P",
    "start_time": "C,P",
    "finish_time": "C,P",
    "removal_time": "C,P",
    # NodeArrays
    "create_time": "C,N",
    "remove_time": "C,N",
    "alive": "C,N",
    "cap_cpu": "C,N",
    "cap_ram": "C,N",
    "alloc_cpu": "C,N",
    "alloc_ram": "C,N",
    "crash_downtime": "C,N",
    # MetricArrays per-cluster counters
    "pods_succeeded": "C",
    "pods_removed": "C",
    "terminated_pods": "C",
    "processed_nodes": "C",
    "scheduling_decisions": "C",
    "scaled_up_pods": "C",
    "scaled_down_pods": "C",
    "scaled_up_nodes": "C",
    "scaled_down_nodes": "C",
    "hpa_reserve_clamped": "C",
    "ca_reserve_starved": "C",
    "node_crashes": "C",
    "node_recoveries": "C",
    "node_downtime_s": "C",
    "pod_interruptions": "C",
    "pod_restarts": "C",
    "pods_failed": "C",
}


def compare_states(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> list:
    """Compare two flat numpy states (convert.state_to_numpy) under the
    reference's parity policy (`kubernetriks_tpu/batched/state.py:681`):
    every leaf exactly equal, except float32 `.metrics.` accumulators, held
    to rtol 1e-6 with atol 0 (their folds sum in a different order on
    different paths). Returns the paths that differ (empty = parity)."""
    if set(a) != set(b):
        return [f"<leaf sets differ: {sorted(set(a) ^ set(b))}>"]
    bad = []
    for key in sorted(a):
        xa, ya = np.asarray(a[key]), np.asarray(b[key])
        if xa.shape != ya.shape:
            ok = False
        elif ".metrics." in key and xa.dtype == np.float32:
            ok = bool(np.allclose(xa, ya, rtol=1e-6, atol=0.0))
        else:
            ok = bool((xa == ya).all())
        if not ok:
            bad.append(key)
    return bad
