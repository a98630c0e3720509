"""Synthetic generators for benchmark traces: Poisson pod arrivals, their
time-merge and a uniform cluster created at t=0. Seeded with Python's `random`, so a seed
gives the same event stream as the JAX package's generators."""

from __future__ import annotations

import random
from typing import Optional, Tuple

from kubernetriks_tpu_torch.core.events import CreateNodeRequest, CreatePodRequest
from kubernetriks_tpu_torch.core.types import Node, Pod
from kubernetriks_tpu_torch.trace.interface import Trace, TraceEvents


class PoissonWorkloadTrace(Trace):
    """Poisson pod arrivals at a given rate, durations uniform in a range."""

    def __init__(
        self,
        rate_per_second: float,
        horizon: float,
        seed: int = 42,
        cpu: int = 1000,
        ram: int = 1024**3,
        duration_range: Tuple[float, float] = (10.0, 300.0),
        max_pods: Optional[int] = None,
        name_prefix: str = "poisson_pod",
    ) -> None:
        self.rate = rate_per_second
        self.horizon = horizon
        self.seed = seed
        self.cpu = cpu
        self.ram = ram
        self.duration_range = duration_range
        self.max_pods = max_pods
        self.name_prefix = name_prefix
        self._count: Optional[int] = None

    def convert_to_simulator_events(self) -> TraceEvents:
        rng = random.Random(self.seed)
        events: TraceEvents = []
        t = 0.0
        i = 0
        while True:
            t += rng.expovariate(self.rate)
            if t > self.horizon or (self.max_pods is not None and i >= self.max_pods):
                break
            duration = rng.uniform(*self.duration_range)
            events.append(
                (
                    t,
                    CreatePodRequest(
                        pod=Pod.new(f"{self.name_prefix}_{i}", self.cpu, self.ram, duration)
                    ),
                )
            )
            i += 1
        self._count = i
        return events

    def event_count(self) -> int:
        return self._count if self._count is not None else int(self.rate * self.horizon)


class MergedWorkloadTrace(Trace):
    """Time-merge of several workload traces into one event stream (a
    bimodal mix of a high-rate small-pod process and a low-rate large-pod
    process, the learning proof's scenario). Give the parts distinct
    name_prefix values so pod names stay unique."""

    def __init__(self, *parts: Trace) -> None:
        self.parts = parts

    def convert_to_simulator_events(self) -> TraceEvents:
        events: TraceEvents = []
        for part in self.parts:
            events.extend(part.convert_to_simulator_events())
        events.sort(key=lambda pair: pair[0])
        return events

    def event_count(self) -> int:
        return sum(part.event_count() for part in self.parts)


class UniformClusterTrace(Trace):
    """N identical nodes created at t=0."""

    def __init__(self, node_count: int, cpu: int = 64000, ram: int = 128 * 1024**3) -> None:
        self.node_count = node_count
        self.cpu = cpu
        self.ram = ram

    def convert_to_simulator_events(self) -> TraceEvents:
        return [
            (
                0.0,
                CreateNodeRequest(node=Node.new(f"gen_node_{i}", self.cpu, self.ram)),
            )
            for i in range(self.node_count)
        ]

    def event_count(self) -> int:
        return self.node_count
