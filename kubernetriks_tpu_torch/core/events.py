"""Trace-level request events: create/remove of nodes and pods.

Own copy of the request events of the JAX package's `core/events.py` that
a trace can carry, pod groups (HPA) included.
"""

from __future__ import annotations

from dataclasses import dataclass
from kubernetriks_tpu_torch.core.types import Node, Pod, PodGroup


@dataclass
class CreateNodeRequest:
    node: Node


@dataclass
class RemoveNodeRequest:
    node_name: str


@dataclass
class CreatePodRequest:
    pod: Pod


@dataclass
class RemovePodRequest:
    pod_name: str


@dataclass
class CreatePodGroupRequest:
    """A pod group (HPA-managed replica set)."""

    pod_group: PodGroup
