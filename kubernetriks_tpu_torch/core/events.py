"""Trace-level request events: create/remove of nodes and pods.

Own copy of the request events of the JAX package's `core/events.py` that
a trace can carry, pod groups (HPA) included, with the chaos engine's
flags (reference core/events.py:29-89): a recovery is a CreateNodeRequest
with recovered=True, a crash a RemoveNodeRequest with crashed=True and
the sampled repair span.
"""

from __future__ import annotations

from dataclasses import dataclass
from kubernetriks_tpu_torch.core.types import Node, Pod, PodGroup


@dataclass
class CreateNodeRequest:
    node: Node
    recovered: bool = False  # a chaos-engine recovery (fault accounting only)


@dataclass
class RemoveNodeRequest:
    node_name: str
    crashed: bool = False  # a chaos-engine crash: rides the removal chain
    downtime_s: float = 0.0  # its pre-sampled repair span


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
