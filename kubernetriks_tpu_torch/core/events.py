"""Trace-level request events: create/remove of nodes and pods.

Own copy of the request events of the JAX package's `core/events.py` that
a trace can carry. Pod groups (HPA) are parsed into CreatePodGroupRequest
only so the trace compiler can refuse them by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from kubernetriks_tpu_torch.core.types import Node, Pod


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
    """A pod group (HPA-managed replica set). Not run by this port yet."""

    pod_group: Any
