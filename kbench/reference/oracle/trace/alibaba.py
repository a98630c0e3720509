"""Alibaba cluster trace v2017 pipeline: own copy of the JAX package's
`trace/alibaba.py` (the Rust original: src/trace/alibaba_cluster_trace_v2017/
{workload,cluster,common}.rs).

Workload: CSV batch_instance joined to batch_task on task_id, filtered for
validity, converted to CreatePodRequests. Cluster: CSV machine_events — `add`
creates a node, `softerror`/`harderror` removes it (with dedup of re-removals
and ghost nodes).
"""

from __future__ import annotations

import csv
import io
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

from kbench.reference.oracle.core.events import CreateNodeRequest, CreatePodRequest, RemoveNodeRequest
from kbench.reference.oracle.core.types import Node, Pod
from kbench.reference.oracle.trace.interface import Trace, TraceEvents

# Normalized memory 1.0 == 128 GiB; machine cpus are cores (x1000 -> millicores)
# (reference: src/trace/alibaba_cluster_trace_v2017/common.rs:1-6).
DENORMALIZATION_BASE = 128 * 1024**3
CPU_BASE = 1000


# ASCII integer-literal syntax (optional sign, digits, single underscores
# BETWEEN digits) — the header rule's integer test. ASCII-only on purpose:
# Python's int() also accepts Unicode digits, which a byte-level reader
# cannot see, so the rule pins the ASCII subset.
_ASCII_INT_RE = re.compile(r"[+-]?[0-9](?:_?[0-9])*")


def _data_rows(text: str):
    """CSV rows of a real-format Alibaba dump, tolerant of the quirks the
    circulating files actually carry: CRLF line endings and quoted fields
    (both handled by the csv module's RFC4180 state machine) plus an
    OPTIONAL header line. Header rule (the JAX package's, which its native
    feeder shares): the FIRST row is a header iff its first field
    (ASCII-whitespace-trimmed) is non-empty and not an ASCII integer
    literal — every data row's first column is either an integer timestamp
    or empty (batch_instance's optional start_ts), while header names never
    are. Only the first row is eligible, so a malformed later row still
    surfaces as a parse error."""
    first = True
    for row in csv.reader(io.StringIO(text)):
        if not row:
            continue
        if first:
            first = False
            head = row[0].strip(" \t\f\v")
            if head and not _ASCII_INT_RE.fullmatch(head):
                continue
        yield row


def _opt_int(value: str) -> Optional[int]:
    return int(value) if value not in ("", None) else None


def _opt_float(value: str) -> Optional[float]:
    return float(value) if value not in ("", None) else None


@dataclass
class BatchTask:
    """Row of batch_task.csv (reference: workload.rs:15-25)."""

    task_create_time: int
    task_end_time: int
    job_id: int
    task_id: int
    number_of_instances: int
    status: str
    cpus_requested_per_instance: Optional[int]  # in santicores (1 core = 100)
    normalized_memory_per_instance: Optional[float]

    @staticmethod
    def from_row(row: List[str]) -> "BatchTask":
        return BatchTask(
            task_create_time=int(row[0]),
            task_end_time=int(row[1]),
            job_id=int(row[2]),
            task_id=int(row[3]),
            number_of_instances=int(row[4]),
            status=row[5],
            cpus_requested_per_instance=_opt_int(row[6]) if len(row) > 6 else None,
            normalized_memory_per_instance=_opt_float(row[7]) if len(row) > 7 else None,
        )


@dataclass
class BatchInstance:
    """Row of batch_instance.csv (reference: workload.rs:27-41)."""

    start_timestamp: Optional[int]
    end_timestamp: Optional[int]
    job_id: Optional[int]
    task_id: Optional[int]
    machine_id: Optional[int]
    status: str
    sequence_number: int
    total_sequence_number: int

    @staticmethod
    def from_row(row: List[str]) -> "BatchInstance":
        return BatchInstance(
            start_timestamp=_opt_int(row[0]),
            end_timestamp=_opt_int(row[1]),
            job_id=_opt_int(row[2]),
            task_id=_opt_int(row[3]),
            machine_id=_opt_int(row[4]),
            status=row[5],
            sequence_number=int(row[6]),
            total_sequence_number=int(row[7]),
        )


def read_batch_tasks(text: str) -> Dict[int, BatchTask]:
    """task_id-keyed; duplicate task ids are an input error
    (reference: workload.rs:152-166)."""
    tasks: Dict[int, BatchTask] = {}
    for row in _data_rows(text):
        task = BatchTask.from_row(row)
        if task.task_id in tasks:
            raise ValueError(f"duplicated task id: {task.task_id}")
        tasks[task.task_id] = task
    return tasks


def read_batch_instances(text: str) -> List[BatchInstance]:
    return [BatchInstance.from_row(row) for row in _data_rows(text)]


class AlibabaWorkloadTraceV2017(Trace):
    def __init__(
        self, batch_instances: List[BatchInstance], batch_tasks: Dict[int, BatchTask]
    ) -> None:
        self.batch_instances_events = batch_instances
        self.batch_tasks = batch_tasks

    @staticmethod
    def from_files(
        batch_instance_trace_path: str, batch_task_trace_path: str
    ) -> "AlibabaWorkloadTraceV2017":
        with open(batch_instance_trace_path) as f:
            instances = read_batch_instances(f.read())
        with open(batch_task_trace_path) as f:
            tasks = read_batch_tasks(f.read())
        return AlibabaWorkloadTraceV2017(instances, tasks)

    def make_pods_from_instances(
        self, instances: List[BatchInstance]
    ) -> List[tuple]:
        """Filter invalid rows and join to tasks; pod = (job_task_seq name,
        santicores x10 -> millicores, normalized mem x128 GiB, duration =
        end - start) (reference: workload.rs:56-120)."""
        pods = []
        pod_no = 0
        for instance in instances:
            if (
                instance.start_timestamp is None
                or instance.end_timestamp is None
                or instance.task_id is None
            ):
                continue
            task = self.batch_tasks.get(instance.task_id)
            if task is None:
                continue
            if (
                task.cpus_requested_per_instance is None
                or task.normalized_memory_per_instance is None
            ):
                continue
            if (
                instance.start_timestamp <= 0
                or instance.end_timestamp <= 0
                or instance.start_timestamp >= instance.end_timestamp
            ):
                continue

            pod_name = f"{instance.job_id}_{instance.task_id}_{pod_no}"
            pod_no += 1
            converted_cpu = task.cpus_requested_per_instance * 10  # santicores -> millicores
            converted_ram = int(task.normalized_memory_per_instance * DENORMALIZATION_BASE)
            running_duration = float(instance.end_timestamp - instance.start_timestamp)
            pod = Pod.new(pod_name, converted_cpu, converted_ram, running_duration)
            pods.append((float(instance.start_timestamp), pod))
        return pods

    def convert_to_simulator_events(self) -> TraceEvents:
        events, self.batch_instances_events = self.batch_instances_events, []
        converted = [
            (ts, CreatePodRequest(pod=pod))
            for ts, pod in self.make_pods_from_instances(events)
        ]
        self.batch_tasks = {}
        converted.sort(key=lambda pair: pair[0])
        return converted

    def event_count(self) -> int:
        return len(self.batch_instances_events)


@dataclass
class MachineEvent:
    """Row of machine_events.csv (reference: cluster.rs:16-38)."""

    timestamp: int
    machine_id: int
    event_type: str  # "add" | "softerror" | "harderror"
    event_detail: Optional[str]
    number_of_cpus: Optional[int]  # in cores
    normalized_memory: Optional[float]

    @staticmethod
    def from_row(row: List[str]) -> "MachineEvent":
        return MachineEvent(
            timestamp=int(row[0]),
            machine_id=int(row[1]),
            event_type=row[2],
            event_detail=row[3] if len(row) > 3 and row[3] else None,
            number_of_cpus=_opt_int(row[4]) if len(row) > 4 else None,
            normalized_memory=_opt_float(row[5]) if len(row) > 5 else None,
        )


def read_machine_events(text: str) -> List[MachineEvent]:
    return [MachineEvent.from_row(row) for row in _data_rows(text)]


class AlibabaClusterTraceV2017(Trace):
    def __init__(self, machine_events: List[MachineEvent]) -> None:
        self.machine_events = machine_events

    @staticmethod
    def from_file(machine_events_trace_path: str) -> "AlibabaClusterTraceV2017":
        with open(machine_events_trace_path) as f:
            return AlibabaClusterTraceV2017(read_machine_events(f.read()))

    def convert_to_simulator_events(self) -> TraceEvents:
        """`add` -> CreateNodeRequest; `softerror`/`harderror` ->
        RemoveNodeRequest with dedup of re-removals and ghost nodes
        (reference: cluster.rs:55-105). The soft/hard distinction is collapsed:
        the simulator terminates the node either way so workload reschedules."""
        events, self.machine_events = self.machine_events, []
        converted: TraceEvents = []
        created_nodes = set()
        removed_nodes = set()
        for machine_event in events:
            node_name = f"alibaba_node_{machine_event.machine_id}"
            if machine_event.event_type == "add":
                if (
                    machine_event.number_of_cpus is None
                    or machine_event.normalized_memory is None
                ):
                    raise ValueError(
                        f"machine event 'add' for machine "
                        f"{machine_event.machine_id} at t={machine_event.timestamp} "
                        f"lacks cpu/memory values"
                    )
                created_nodes.add(node_name)
                converted_cpu = machine_event.number_of_cpus * CPU_BASE
                converted_ram = int(machine_event.normalized_memory * DENORMALIZATION_BASE)
                converted.append(
                    (
                        float(machine_event.timestamp),
                        CreateNodeRequest(
                            node=Node.new(node_name, converted_cpu, converted_ram)
                        ),
                    )
                )
            elif machine_event.event_type in ("softerror", "harderror"):
                if node_name in removed_nodes or node_name not in created_nodes:
                    continue
                removed_nodes.add(node_name)
                converted.append(
                    (
                        float(machine_event.timestamp),
                        RemoveNodeRequest(node_name=node_name),
                    )
                )
            else:
                raise ValueError(
                    f"Unsupported operation for a node in alibaba cluster "
                    f"trace: {machine_event.event_type}"
                )
        converted.sort(key=lambda pair: pair[0])
        return converted

    def event_count(self) -> int:
        return len(self.machine_events)
