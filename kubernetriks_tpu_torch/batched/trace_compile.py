"""Host-side trace compiler: trace events -> dense numpy slabs.

Own copy of the JAX package's `batched/trace_compile.py`
(`compile_cluster_trace`, `pad_and_batch`): names are interned to slots
once on the host, payloads (capacities, requests, durations) are staged
into per-slot arrays, and the device sees only (time, kind, slot) triples.
Node re-creations of the same name get fresh slots. Pod groups raise: they
arrive with the autoscalers (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetriks_tpu_torch.batched.state import (
    DEFAULT_RAM_UNIT,
    EV_CREATE_NODE,
    EV_CREATE_POD,
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

    for ts, _, event in merged:
        if isinstance(event, CreateNodeRequest):
            node = event.node
            slot = len(node_cap_cpu)
            node_cap_cpu.append(int(node.status.capacity.cpu))
            node_cap_ram.append(int(node.status.capacity.ram) // ram_unit)
            node_names.append(node.metadata.name)
            live_node_slot[node.metadata.name] = slot
            ev_time.append(ts)
            ev_kind.append(EV_CREATE_NODE)
            ev_slot.append(slot)
        elif isinstance(event, RemoveNodeRequest):
            slot = live_node_slot.pop(event.node_name)
            ev_time.append(ts)
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
            raise NotImplementedError(
                "pod groups are not run by kubernetriks_tpu_torch yet "
                "(ROADMAP Queue 1 item 7)"
            )
        else:
            raise ValueError(
                f"batched path does not support trace event {type(event).__name__}"
            )

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
    )


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
    node_crash_downtime) — the last all zeros, as no faults are injected."""
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
