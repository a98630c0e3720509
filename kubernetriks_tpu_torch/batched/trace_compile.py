"""Host-side trace compiler: trace events -> dense numpy slabs.

Own copy of the JAX package's `batched/trace_compile.py`
(`compile_cluster_trace`, `segment_pod_slots`, `pad_and_batch`): names are
interned to slots once on the host, payloads (capacities, requests,
durations) are staged into per-slot arrays, and the device sees only
(time, kind, slot) triples. Node re-creations of the same name get fresh
slots, and so do the chaos engine's recoveries (EV_NODE_RECOVER; its
crashes are EV_NODE_CRASH, with each crashing slot's repair span). A pod group (HPA) reserves a block of pod slots for its replicas
and compiles its load model into a table of (duration, load) units.
`compile_from_arrays` compiles the native feeder's dense arrays
(trace/feeder.py) to the same CompiledClusterTrace without event objects.
`stage_segment` cuts the sliding pod window's refill payload out of a
`PayloadSource`: the whole-trace arrays (`ArrayPayloadSource`) or a
segment reader over the native feeder (`FeederPayloadSource`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import yaml

from kubernetriks_tpu_torch.batched.state import (
    DEFAULT_RAM_UNIT,
    EV_CREATE_NODE,
    EV_CREATE_POD,
    EV_NODE_CRASH,
    EV_NODE_RECOVER,
    EV_REMOVE_NODE,
    EV_REMOVE_POD,
)
from kubernetriks_tpu_torch.core.events import (
    CreateNodeRequest,
    CreatePodGroupRequest,
    CreatePodRequest,
    RemoveNodeRequest,
    RemovePodRequest,
)
from kubernetriks_tpu_torch.trace.interface import TraceEvents


# Reserved pod slots of a group = initial + this x max_pod_count.
POD_GROUP_SLOT_MULTIPLIER = 2


@dataclass
class CompiledPodGroup:
    """Host-side pod-group table for the batched HPA: reserved slot range,
    targets, and the load curve compiled out of the nested YAML usage-model
    config."""

    name: str
    slot_start: int
    slot_count: int  # reserved slots = initial + multiplier x max_pod_count
    max_pods: int
    initial: int
    creation_time: float
    target_cpu: float  # <= 0 means unset
    target_ram: float
    cpu_units: List[Tuple[float, float]]  # (duration, load); [] = no model
    cpu_const: bool
    ram_units: List[Tuple[float, float]]
    ram_const: bool


def _compile_usage_model(model_config) -> Tuple[List[Tuple[float, float]], bool]:
    """ResourceUsageModelConfig -> (units, is_constant). A constant model's
    load IS the utilization; a pod_group model's load is divided by the
    running pod count."""
    if model_config is None:
        return [], False
    parsed = yaml.safe_load(model_config.config)
    if model_config.model_name == "constant":
        return [(1.0, float(parsed["usage"]))], True
    if model_config.model_name == "pod_group":
        return [(float(u["duration"]), float(u["total_load"])) for u in parsed], False
    raise ValueError(f"unknown usage model {model_config.model_name!r}")


@dataclass
class CompiledClusterTrace:
    """One cluster's compiled trace + payload tables (numpy, host-side)."""

    ev_time: np.ndarray  # (E,) float64
    ev_kind: np.ndarray  # (E,) int32
    ev_slot: np.ndarray  # (E,) int32
    node_cap_cpu: np.ndarray  # (N,) int32
    node_cap_ram: np.ndarray  # (N,) int32 (ram units)
    pod_req_cpu: np.ndarray  # (P,) int32
    pod_req_ram: np.ndarray  # (P,) int32 (ram units)
    pod_duration: np.ndarray  # (P,) float64 (-1 for long-running)
    node_names: List[str] = field(default_factory=list)
    pod_names: List[str] = field(default_factory=list)
    pod_groups: List[CompiledPodGroup] = field(default_factory=list)
    # (N,) repair span of each slot's crash event (0 where the slot never
    # crashes); None when no faults were injected.
    node_crash_downtime: Optional[np.ndarray] = None

    @property
    def n_events(self) -> int:
        return len(self.ev_time)

    @property
    def n_nodes(self) -> int:
        return len(self.node_cap_cpu)

    @property
    def n_pods(self) -> int:
        return len(self.pod_req_cpu)


def _event_time_shifts(config) -> Tuple[float, float, float]:
    """Per-kind event-time shifts composing the control-plane hop chains:
    (create_node, remove_node, remove_pod)."""
    if config is None:
        return 0.0, 0.0, 0.0
    return (
        3.0 * config.as_to_ps_network_delay + config.ps_to_sched_network_delay,
        2.0 * config.as_to_ps_network_delay + config.as_to_node_network_delay,
        config.as_to_ps_network_delay,
    )


def compile_cluster_trace(
    cluster_events: TraceEvents,
    workload_events: TraceEvents,
    config=None,
    ram_unit: int = DEFAULT_RAM_UNIT,
) -> CompiledClusterTrace:
    """Merge + time-sort both traces (stable: cluster events first at equal
    times) and intern names to slots. Event times are shifted to their
    effect times:
    - CreateNode at t becomes schedulable at t + 3*as_to_ps + ps_to_sched;
    - RemoveNode at t takes effect at t + 2*as_to_ps + as_to_node, never
      before its node's create effect;
    - RemovePod at t takes effect at t + as_to_ps;
    - CreatePod stays at t (its queue entry is shifted on the device).
    A CreatePodGroup at t reserves the group's replica slots (named
    "{group}_{i}") and creates its initial replicas at t.
    """
    shift_create_node, shift_remove_node, shift_remove_pod = _event_time_shifts(config)

    node_create_effect: Dict[str, float] = {}
    merged: List[Tuple[float, int, object]] = []
    for order, events in ((0, cluster_events), (1, workload_events)):
        for ts, event in events:
            shifted = float(ts)
            if isinstance(event, CreateNodeRequest):
                shifted += shift_create_node
                node_create_effect[event.node.metadata.name] = shifted
            elif isinstance(event, RemoveNodeRequest):
                shifted = max(
                    shifted + shift_remove_node,
                    node_create_effect.get(event.node_name, -np.inf),
                )
            elif isinstance(event, RemovePodRequest):
                shifted += shift_remove_pod
            merged.append((shifted, order, event))
    merged.sort(key=lambda item: (item[0], item[1]))

    ev_time: List[float] = []
    ev_kind: List[int] = []
    ev_slot: List[int] = []
    node_cap_cpu: List[int] = []
    node_cap_ram: List[int] = []
    node_names: List[str] = []
    live_node_slot: Dict[str, int] = {}
    pod_req_cpu: List[int] = []
    pod_req_ram: List[int] = []
    pod_duration: List[float] = []
    pod_names: List[str] = []
    pod_slot: Dict[str, int] = {}
    pod_groups: List[CompiledPodGroup] = []
    node_crash_downtime: Dict[int, float] = {}

    for ts, _, event in merged:
        if isinstance(event, CreateNodeRequest):
            node = event.node
            slot = len(node_cap_cpu)
            node_cap_cpu.append(int(node.status.capacity.cpu))
            node_cap_ram.append(int(node.status.capacity.ram) // ram_unit)
            node_names.append(node.metadata.name)
            live_node_slot[node.metadata.name] = slot
            ev_time.append(ts)
            ev_kind.append(EV_NODE_RECOVER if event.recovered else EV_CREATE_NODE)
            ev_slot.append(slot)
        elif isinstance(event, RemoveNodeRequest):
            slot = live_node_slot.pop(event.node_name)
            ev_time.append(ts)
            if event.crashed:
                ev_kind.append(EV_NODE_CRASH)
                node_crash_downtime[slot] = float(event.downtime_s)
            else:
                ev_kind.append(EV_REMOVE_NODE)
            ev_slot.append(slot)
        elif isinstance(event, CreatePodRequest):
            pod = event.pod
            slot = len(pod_req_cpu)
            requests = pod.spec.resources.requests
            pod_req_cpu.append(int(requests.cpu))
            pod_req_ram.append(-(-int(requests.ram) // ram_unit))  # ceil
            duration = pod.spec.running_duration
            pod_duration.append(-1.0 if duration is None else float(duration))
            pod_names.append(pod.metadata.name)
            pod_slot[pod.metadata.name] = slot
            ev_time.append(ts)
            ev_kind.append(EV_CREATE_POD)
            ev_slot.append(slot)
        elif isinstance(event, RemovePodRequest):
            ev_time.append(ts)
            ev_kind.append(EV_REMOVE_POD)
            ev_slot.append(pod_slot[event.pod_name])
        elif isinstance(event, CreatePodGroupRequest):
            group = event.pod_group
            template = group.pod_template
            if template.spec.running_duration is not None:
                raise ValueError(
                    f"pod group {group.name!r} has a running_duration: only "
                    "long-running service groups are supported"
                )
            umc = group.resources_usage_model_config
            cpu_units, cpu_const = _compile_usage_model(umc.cpu_config if umc else None)
            ram_units, ram_const = _compile_usage_model(umc.ram_config if umc else None)
            slot_start = len(pod_req_cpu)
            # The reserve seats the initial replicas beside a full scale-up,
            # and freed slots are reused by later scale-ups.
            slot_count = group.initial_pod_count + POD_GROUP_SLOT_MULTIPLIER * group.max_pod_count
            requests = template.spec.resources.requests
            for i in range(slot_count):
                pod_req_cpu.append(int(requests.cpu))
                pod_req_ram.append(-(-int(requests.ram) // ram_unit))
                pod_duration.append(-1.0)
                name = f"{group.name}_{i}"
                pod_slot[name] = len(pod_names)
                pod_names.append(name)
            for i in range(group.initial_pod_count):
                ev_time.append(ts)
                ev_kind.append(EV_CREATE_POD)
                ev_slot.append(slot_start + i)
            targets = group.target_resources_usage
            pod_groups.append(
                CompiledPodGroup(
                    name=group.name,
                    slot_start=slot_start,
                    slot_count=slot_count,
                    max_pods=group.max_pod_count,
                    initial=group.initial_pod_count,
                    creation_time=float(ts),
                    target_cpu=float(targets.cpu_utilization or 0.0),
                    target_ram=float(targets.ram_utilization or 0.0),
                    cpu_units=cpu_units,
                    cpu_const=cpu_const,
                    ram_units=ram_units,
                    ram_const=ram_const,
                )
            )
        else:
            raise ValueError(
                f"batched path does not support trace event {type(event).__name__}"
            )

    crash_downtime = None
    if node_crash_downtime:
        crash_downtime = np.zeros(len(node_cap_cpu), np.float32)
        for slot, ttr in node_crash_downtime.items():
            crash_downtime[slot] = ttr
    return CompiledClusterTrace(
        ev_time=np.asarray(ev_time, np.float64),
        ev_kind=np.asarray(ev_kind, np.int32),
        ev_slot=np.asarray(ev_slot, np.int32),
        node_cap_cpu=np.asarray(node_cap_cpu, np.int32).reshape(-1),
        node_cap_ram=np.asarray(node_cap_ram, np.int32).reshape(-1),
        pod_req_cpu=np.asarray(pod_req_cpu, np.int32).reshape(-1),
        pod_req_ram=np.asarray(pod_req_ram, np.int32).reshape(-1),
        pod_duration=np.asarray(pod_duration, np.float64).reshape(-1),
        node_names=node_names,
        pod_names=pod_names,
        pod_groups=pod_groups,
        node_crash_downtime=crash_downtime,
    )


def segment_pod_slots(
    compiled: Sequence[CompiledClusterTrace],
) -> Tuple[List[CompiledClusterTrace], int]:
    """Renumber pod slots into the segmented layout the reference uses
    whenever pod groups exist: plain (non-group) pods occupy slots [0, T)
    in their original event order, the groups' reserved slots [T, ...),
    where T is the batch-wide largest plain-pod count. Slot order feeds
    order-sensitive passes (CA scale-down re-placement, same-window
    reschedule ranking), so the port keeps the reference's layout. Event
    order is unchanged; only slot numbers move.

    Returns (renumbered traces, T); the traces are returned as they are
    when none has pod groups."""
    if not any(c.pod_groups for c in compiled):
        return list(compiled), max((c.n_pods for c in compiled), default=0)

    group_masks = []
    for c in compiled:
        is_group = np.zeros(c.n_pods, bool)
        for g in c.pod_groups:
            is_group[g.slot_start : g.slot_start + g.slot_count] = True
        group_masks.append(is_group)
    T = max(int((~m).sum()) for m in group_masks)

    out: List[CompiledClusterTrace] = []
    for c, is_group in zip(compiled, group_masks):
        if c.n_pods == 0:
            out.append(c)
            continue
        R = int(is_group.sum())
        L = T + R
        plain_ord = np.cumsum(~is_group) - 1
        group_ord = np.cumsum(is_group) - 1
        new_slot = np.where(is_group, T + group_ord, plain_ord).astype(np.int32)

        req_cpu = np.zeros(L, np.int32)
        req_ram = np.zeros(L, np.int32)
        duration = np.full(L, -1.0, np.float64)
        names = [""] * L
        req_cpu[new_slot] = c.pod_req_cpu
        req_ram[new_slot] = c.pod_req_ram
        duration[new_slot] = c.pod_duration
        for old, new in enumerate(new_slot):
            names[new] = c.pod_names[old]

        is_pod_ev = (c.ev_kind == EV_CREATE_POD) | (c.ev_kind == EV_REMOVE_POD)
        ev_slot = np.where(
            is_pod_ev, new_slot[np.clip(c.ev_slot, 0, c.n_pods - 1)], c.ev_slot
        ).astype(np.int32)
        groups = [
            dataclasses.replace(g, slot_start=T + int(group_ord[g.slot_start]))
            for g in c.pod_groups
        ]
        out.append(
            CompiledClusterTrace(
                ev_time=c.ev_time,
                ev_kind=c.ev_kind,
                ev_slot=ev_slot,
                node_cap_cpu=c.node_cap_cpu,
                node_cap_ram=c.node_cap_ram,
                pod_req_cpu=req_cpu,
                pod_req_ram=req_ram,
                pod_duration=duration,
                node_names=c.node_names,
                pod_names=names,
                pod_groups=groups,
                node_crash_downtime=c.node_crash_downtime,
            )
        )
    return out, T


def pad_and_batch(
    compiled: Sequence[CompiledClusterTrace],
    n_nodes: Optional[int] = None,
    n_pods: Optional[int] = None,
    n_events: Optional[int] = None,
) -> Tuple[np.ndarray, ...]:
    """Stack per-cluster compilations into (C, ...) arrays, padding slots and
    events (pad events: kind=EV_NONE, time=+inf; one sentinel always
    follows the last real event). Returns (ev_time, ev_kind, ev_slot,
    node_cap_cpu, node_cap_ram, pod_req_cpu, pod_req_ram, pod_duration,
    node_crash_downtime): the last zeros where no slot crashes."""
    C = len(compiled)
    N = n_nodes if n_nodes is not None else max((c.n_nodes for c in compiled), default=0)
    P = n_pods if n_pods is not None else max((c.n_pods for c in compiled), default=0)
    E = n_events if n_events is not None else max((c.n_events for c in compiled), default=0)
    N, P, E = max(N, 1), max(P, 1), max(E, 0) + 1

    ev_time = np.full((C, E), np.inf, np.float64)
    ev_kind = np.zeros((C, E), np.int32)
    ev_slot = np.zeros((C, E), np.int32)
    node_cap_cpu = np.zeros((C, N), np.int32)
    node_cap_ram = np.zeros((C, N), np.int32)
    pod_req_cpu = np.zeros((C, P), np.int32)
    pod_req_ram = np.zeros((C, P), np.int32)
    pod_duration = np.full((C, P), -1.0, np.float64)
    node_crash_downtime = np.zeros((C, N), np.float32)

    for i, c in enumerate(compiled):
        ev_time[i, : c.n_events] = c.ev_time
        ev_kind[i, : c.n_events] = c.ev_kind
        ev_slot[i, : c.n_events] = c.ev_slot
        node_cap_cpu[i, : c.n_nodes] = c.node_cap_cpu
        node_cap_ram[i, : c.n_nodes] = c.node_cap_ram
        pod_req_cpu[i, : c.n_pods] = c.pod_req_cpu
        pod_req_ram[i, : c.n_pods] = c.pod_req_ram
        pod_duration[i, : c.n_pods] = c.pod_duration
        if c.node_crash_downtime is not None:
            node_crash_downtime[i, : c.n_nodes] = c.node_crash_downtime

    return (
        ev_time,
        ev_kind,
        ev_slot,
        node_cap_cpu,
        node_cap_ram,
        pod_req_cpu,
        pod_req_ram,
        pod_duration,
        node_crash_downtime,
    )


# --- the sliding pod window's payload ------------------------------------------

NO_CREATE = np.iinfo(np.int32).max  # create window of a slot no event creates
BIG_RANK = 1 << 30  # name rank of a slot without a trace name


def _pad_cols(arr: np.ndarray, lo: int, width: int, fill, dtype) -> np.ndarray:
    """arr[:, lo:lo + width] as `dtype`, right-padded with `fill` past arr's
    columns."""
    out = np.full((arr.shape[0], width), fill, dtype)
    src = arr[:, lo : lo + width]
    out[:, : src.shape[1]] = src
    return out


def compile_from_arrays(
    cluster_arrays,
    workload_arrays,
    config=None,
    ram_unit: int = DEFAULT_RAM_UNIT,
) -> CompiledClusterTrace:
    """The native feeder's output (trace/feeder.py ClusterArrays or None,
    WorkloadArrays) compiled to a CompiledClusterTrace without per-event
    Python objects (reference `compile_from_arrays`, trace_compile.py:436):
    the same result as compile_cluster_trace over
    {cluster,workload}_events_from_arrays. Node events (few) run through a
    loop, pod events (the long axis of an Alibaba trace) through numpy."""
    shift_create_node, shift_remove_node, _ = _event_time_shifts(config)

    node_cap_cpu: List[int] = []
    node_cap_ram: List[int] = []
    node_names: List[str] = []
    live_node_slot: Dict[int, int] = {}
    c_time: List[float] = []
    c_kind: List[int] = []
    c_slot: List[int] = []
    node_create_effect: Dict[int, float] = {}
    if cluster_arrays is not None:
        for i in range(len(cluster_arrays.ts)):
            mid = int(cluster_arrays.machine_id[i])
            if int(cluster_arrays.kind[i]) == 0:
                slot = len(node_cap_cpu)
                node_cap_cpu.append(int(cluster_arrays.cpu_millicores[i]))
                node_cap_ram.append(int(cluster_arrays.ram_bytes[i]) // ram_unit)
                node_names.append(cluster_arrays.node_name(i))
                live_node_slot[mid] = slot
                shifted = float(cluster_arrays.ts[i]) + shift_create_node
                node_create_effect[mid] = shifted
                c_time.append(shifted)
                c_kind.append(EV_CREATE_NODE)
                c_slot.append(slot)
            else:
                # As compile_cluster_trace: a removal never takes effect
                # before its node's creation under asymmetric shifts.
                c_time.append(max(float(cluster_arrays.ts[i]) + shift_remove_node, node_create_effect.get(mid, -np.inf)))
                c_kind.append(EV_REMOVE_NODE)
                c_slot.append(live_node_slot.pop(mid))

    P = len(workload_arrays.start_ts)
    w_time = workload_arrays.start_ts.astype(np.float64)
    pod_req_cpu = workload_arrays.cpu_millicores.astype(np.int32)
    pod_req_ram = (-(-workload_arrays.ram_bytes // ram_unit)).astype(np.int32)
    pod_duration = workload_arrays.duration.astype(np.float64)
    pod_names = [workload_arrays.pod_name(i) for i in range(P)]

    # A stable merge on time, cluster events before workload events at ties.
    times = np.concatenate([np.asarray(c_time, np.float64), w_time])
    kinds = np.concatenate([np.asarray(c_kind, np.int32), np.full(P, EV_CREATE_POD, np.int32)])
    slots = np.concatenate([np.asarray(c_slot, np.int32), np.arange(P, dtype=np.int32)])
    source = np.concatenate([np.zeros(len(c_time), np.int8), np.ones(P, np.int8)])
    order = np.lexsort((source, times))
    return CompiledClusterTrace(
        ev_time=times[order],
        ev_kind=kinds[order],
        ev_slot=slots[order],
        node_cap_cpu=np.asarray(node_cap_cpu, np.int32).reshape(-1),
        node_cap_ram=np.asarray(node_cap_ram, np.int32).reshape(-1),
        pod_req_cpu=pod_req_cpu.reshape(-1),
        pod_req_ram=pod_req_ram.reshape(-1),
        pod_duration=pod_duration.reshape(-1),
        node_names=node_names,
        pod_names=pod_names,
        pod_groups=[],
    )


class PayloadSource:
    """The refill payload of the plain pod slots, global columns [lo, lo +
    width) (reference `PayloadSource`, trace_compile.py:537): `segment`
    returns {"req_cpu", "req_ram", "duration"} (C, width) numpy arrays with
    the fresh-slot padding past the trace's end: request 0, duration -1.0
    (the long-running-service sentinel), so a padding slot never finishes
    and is never created. `total_rows`: the plain pod columns it covers.
    The streaming feeder calls `segment` from its producer thread, so an
    implementation must allow one concurrent reader."""

    total_rows: int

    def segment(self, lo: int, width: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class ArrayPayloadSource(PayloadSource):
    """Whole-trace host arrays {"req_cpu", "req_ram", "duration"} of shape
    (C, T), the engine's default (reference trace_compile.py:569)."""

    def __init__(self, full_pods: Dict[str, np.ndarray]) -> None:
        self.full_pods = full_pods
        self.total_rows = int(full_pods["req_cpu"].shape[1])

    def segment(self, lo: int, width: int) -> Dict[str, np.ndarray]:
        full = self.full_pods
        return {
            "req_cpu": _pad_cols(full["req_cpu"], lo, width, 0, np.int32),
            "req_ram": _pad_cols(full["req_ram"], lo, width, 0, np.int32),
            "duration": _pad_cols(full["duration"], lo, width, -1.0, np.float64),
        }


class FeederPayloadSource(PayloadSource):
    """The payload read a segment at a time from a row-range workload
    reader (trace/feeder.py WorkloadSegmentReader, or WorkloadArraysReader)
    for a trace of plain pods alone (reference trace_compile.py:578): their
    slots follow the sorted workload rows, so payload column i is row i, and
    a segment materializes only its rows, converted as compile_from_arrays
    converts them (int32 millicores, RAM units rounded up, float64
    seconds). Every cluster gets the same rows."""

    def __init__(self, reader, n_clusters: int, ram_unit: int) -> None:
        self.reader = reader
        self.n_clusters = int(n_clusters)
        self.ram_unit = int(ram_unit)
        self.total_rows = len(reader)

    def segment(self, lo: int, width: int) -> Dict[str, np.ndarray]:
        C = self.n_clusters
        out = {
            "req_cpu": np.zeros((C, width), np.int32),
            "req_ram": np.zeros((C, width), np.int32),
            "duration": np.full((C, width), -1.0, np.float64),
        }
        n = max(0, min(width, self.total_rows - lo))
        if n:
            wa = self.reader.read(lo, n)
            out["req_cpu"][:, :n] = wa.cpu_millicores.astype(np.int32)[None, :]
            out["req_ram"][:, :n] = (-(-wa.ram_bytes // self.ram_unit)).astype(np.int32)[None, :]
            out["duration"][:, :n] = wa.duration.astype(np.float64)[None, :]
        return out


def stage_segment(
    payload: PayloadSource,
    create_win: np.ndarray,
    rank_full: Optional[np.ndarray],
    lo: int,
    width: int,
) -> Dict[str, np.ndarray]:
    """Payload columns [lo, lo + width) of the plain pod segment for the
    slide (reference `stage_segment`, trace_compile.py:615): the requests
    and float64 durations of `payload`, each slot's create window
    (`create_win`, (C, T); NO_CREATE past the trace) and, with
    `rank_full`, its pod-name rank (BIG_RANK past the trace). The one owner
    of the padding rules, so the engine's device payload and its refill
    and growth slots agree slot for slot."""
    out = payload.segment(lo, width)
    out["create_win"] = _pad_cols(create_win, lo, width, NO_CREATE, np.int32)
    if rank_full is not None:
        out["rank"] = _pad_cols(rank_full, lo, width, BIG_RANK, np.int32)
    return out
