"""Kubernetes object model — the subset the trace formats build.

Own copy of the JAX package's `core/types.py` object model (ObjectMeta,
RuntimeResources with cpu millicores / ram bytes, Node with capacity and
allocatable, Pod with requests/limits/duration), trimmed to what the trace
readers and the trace compiler use, plus the HPA's pod group and its
utilization targets (the JAX package keeps those in
`autoscalers/interface.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class RuntimeResources:
    """cpu in millicores, ram in bytes."""

    cpu: int = 0
    ram: int = 0

    def copy(self) -> "RuntimeResources":
        return RuntimeResources(self.cpu, self.ram)

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "RuntimeResources":
        if not d:
            return RuntimeResources()
        return RuntimeResources(cpu=int(d.get("cpu", 0)), ram=int(d.get("ram", 0)))


@dataclass
class ObjectMeta:
    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "ObjectMeta":
        if not d:
            return ObjectMeta()
        return ObjectMeta(
            name=d.get("name", ""),
            labels=dict(d.get("labels") or {}),
            creation_timestamp=float(d.get("creation_timestamp", 0.0)),
        )


@dataclass
class NodeStatus:
    allocatable: RuntimeResources = field(default_factory=RuntimeResources)
    capacity: RuntimeResources = field(default_factory=RuntimeResources)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: NodeStatus = field(default_factory=NodeStatus)

    @staticmethod
    def new(name: str, cpu: int, ram: int) -> "Node":
        return Node(
            metadata=ObjectMeta(name=name),
            status=NodeStatus(
                allocatable=RuntimeResources(cpu, ram),
                capacity=RuntimeResources(cpu, ram),
            ),
        )

    def copy(self) -> "Node":
        return Node(
            metadata=ObjectMeta(self.metadata.name, dict(self.metadata.labels), self.metadata.creation_timestamp),
            status=NodeStatus(allocatable=self.status.allocatable.copy(), capacity=self.status.capacity.copy()),
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Node":
        """Missing allocatable defaults to capacity (node templates in
        traces specify only capacity)."""
        status = d.get("status") or {}
        capacity = RuntimeResources.from_dict(status.get("capacity"))
        allocatable_raw = status.get("allocatable")
        allocatable = (
            RuntimeResources.from_dict(allocatable_raw)
            if allocatable_raw
            else capacity.copy()
        )
        return Node(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            status=NodeStatus(allocatable=allocatable, capacity=capacity),
        )


@dataclass
class ResourceUsageModelConfig:
    """Nested YAML-in-string usage model config."""

    model_name: str = ""
    config: str = ""

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["ResourceUsageModelConfig"]:
        if not d:
            return None
        return ResourceUsageModelConfig(
            model_name=d.get("model_name", ""), config=d.get("config", "")
        )


@dataclass
class RuntimeResourcesUsageModelConfig:
    cpu_config: Optional[ResourceUsageModelConfig] = None
    ram_config: Optional[ResourceUsageModelConfig] = None

    @staticmethod
    def from_dict(
        d: Optional[Dict[str, Any]],
    ) -> Optional["RuntimeResourcesUsageModelConfig"]:
        if not d:
            return None
        return RuntimeResourcesUsageModelConfig(
            cpu_config=ResourceUsageModelConfig.from_dict(d.get("cpu_config")),
            ram_config=ResourceUsageModelConfig.from_dict(d.get("ram_config")),
        )


@dataclass
class Resources:
    limits: RuntimeResources = field(default_factory=RuntimeResources)
    requests: RuntimeResources = field(default_factory=RuntimeResources)
    usage_model_config: Optional[RuntimeResourcesUsageModelConfig] = None


@dataclass
class PodSpec:
    """running_duration=None means an infinitely long-running service."""

    resources: Resources = field(default_factory=Resources)
    running_duration: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)

    @staticmethod
    def new(name: str, cpu: int, ram: int, running_duration: Optional[float]) -> "Pod":
        return Pod(
            metadata=ObjectMeta(name=name),
            spec=PodSpec(
                resources=Resources(
                    limits=RuntimeResources(cpu, ram),
                    requests=RuntimeResources(cpu, ram),
                ),
                running_duration=running_duration,
            ),
        )

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Pod":
        spec = d.get("spec") or {}
        resources = spec.get("resources") or {}
        return Pod(
            metadata=ObjectMeta.from_dict(d.get("metadata")),
            spec=PodSpec(
                resources=Resources(
                    limits=RuntimeResources.from_dict(resources.get("limits")),
                    requests=RuntimeResources.from_dict(resources.get("requests")),
                    usage_model_config=RuntimeResourcesUsageModelConfig.from_dict(
                        resources.get("usage_model_config")
                    ),
                ),
                running_duration=spec.get("running_duration"),
            ),
        )


@dataclass
class TargetResourcesUsage:
    """Target cpu/ram utilization ratios in [0, 1], relative to requests;
    None leaves the metric unset."""

    cpu_utilization: Optional[float] = None
    ram_utilization: Optional[float] = None

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> "TargetResourcesUsage":
        if not d:
            return TargetResourcesUsage()
        return TargetResourcesUsage(
            cpu_utilization=d.get("cpu_utilization"),
            ram_utilization=d.get("ram_utilization"),
        )


@dataclass
class PodGroup:
    """A set of long-running service pods the HPA scales together: the
    trace creates `initial_pod_count` replicas of `pod_template`, and the
    HPA keeps between them and `max_pod_count` running against the load
    model in `resources_usage_model_config`."""

    name: str
    initial_pod_count: int
    max_pod_count: int
    pod_template: Pod
    target_resources_usage: TargetResourcesUsage
    resources_usage_model_config: Optional[RuntimeResourcesUsageModelConfig]

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodGroup":
        return PodGroup(
            name=d.get("name", ""),
            initial_pod_count=int(d.get("initial_pod_count", 0)),
            max_pod_count=int(d.get("max_pod_count", 0)),
            pod_template=Pod.from_dict(d.get("pod_template") or {}),
            target_resources_usage=TargetResourcesUsage.from_dict(
                d.get("target_resources_usage")
            ),
            resources_usage_model_config=RuntimeResourcesUsageModelConfig.from_dict(
                d.get("resources_usage_model_config")
            ),
        )
