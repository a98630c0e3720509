"""Simulation configuration: one YAML document -> SimulationConfig.

Own copy of the JAX package's `config.py` surface for the blocks this
port runs: the simulation name and seed, the scheduling interval, the
scheduler profile, the conditional-move switch and the six control-plane
network delays. The autoscaler and fault-injection blocks are parsed only
far enough to refuse them: an enabled `horizontal_pod_autoscaler`,
`cluster_autoscaler` or `fault_injection` block raises NotImplementedError
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import yaml

# ROADMAP.md, Queue 1 items that bring the refused blocks.
_UNPORTED_BLOCKS = {
    "horizontal_pod_autoscaler": "ROADMAP Queue 1 item 7 (autoscalers: the composed path)",
    "cluster_autoscaler": "ROADMAP Queue 1 item 7 (autoscalers: the composed path)",
    "fault_injection": "ROADMAP Queue 1 item 9 (chaos on device)",
}


def _refuse_unported(d: Dict[str, Any]) -> None:
    for key, item in _UNPORTED_BLOCKS.items():
        block = d.get(key)
        if block and bool(block.get("enabled", False)):
            raise NotImplementedError(
                f"config block {key!r} is enabled, but kubernetriks_tpu_torch "
                f"does not run it yet: {item}"
            )


@dataclass
class SimulationConfig:
    sim_name: str = "kubernetriks-tpu"
    seed: int = 0
    scheduling_cycle_interval: float = 10.0
    # Scheduler profile spec; only the reference default (Fit +
    # LeastAllocatedResources) is ported (batched/pipeline.py raises on
    # anything else).
    scheduler_profile: Optional[Any] = None
    enable_unscheduled_pods_conditional_move: bool = False
    # Simulated control-plane network delays in seconds; as = api server,
    # ps = persistent storage.
    as_to_ps_network_delay: float = 0.0
    ps_to_sched_network_delay: float = 0.0
    sched_to_as_network_delay: float = 0.0
    as_to_node_network_delay: float = 0.0
    as_to_ca_network_delay: float = 0.0
    as_to_hpa_network_delay: float = 0.0

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SimulationConfig":
        _refuse_unported(d)
        return SimulationConfig(
            sim_name=d.get("sim_name", "kubernetriks-tpu"),
            seed=int(d.get("seed", 0)),
            scheduling_cycle_interval=float(d.get("scheduling_cycle_interval", 10.0)),
            scheduler_profile=d.get("scheduler_profile"),
            enable_unscheduled_pods_conditional_move=bool(
                d.get("enable_unscheduled_pods_conditional_move", False)
            ),
            as_to_ps_network_delay=float(d.get("as_to_ps_network_delay", 0.0)),
            ps_to_sched_network_delay=float(d.get("ps_to_sched_network_delay", 0.0)),
            sched_to_as_network_delay=float(d.get("sched_to_as_network_delay", 0.0)),
            as_to_node_network_delay=float(d.get("as_to_node_network_delay", 0.0)),
            as_to_ca_network_delay=float(d.get("as_to_ca_network_delay", 0.0)),
            as_to_hpa_network_delay=float(d.get("as_to_hpa_network_delay", 0.0)),
        )

    @staticmethod
    def from_yaml(text: str) -> "SimulationConfig":
        return SimulationConfig.from_dict(load_yaml_with_tags(text) or {})

    @staticmethod
    def from_file(path: str) -> "SimulationConfig":
        with open(path) as f:
            return SimulationConfig.from_yaml(f.read())


class _TaggedLoader(yaml.SafeLoader):
    """SafeLoader that flattens serde-style YAML tags: a tag on a mapping
    becomes {"__tag__": name, **mapping}; a tag on an empty scalar becomes
    the bare tag name string."""


def _multi_constructor(loader: _TaggedLoader, tag_suffix: str, node: yaml.Node) -> Any:
    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
        value["__tag__"] = tag_suffix
        return value
    if isinstance(node, yaml.SequenceNode):
        return {"__tag__": tag_suffix, "items": loader.construct_sequence(node, deep=True)}
    scalar = loader.construct_scalar(node)
    return tag_suffix if scalar in (None, "") else {"__tag__": tag_suffix, "value": scalar}


_TaggedLoader.add_multi_constructor("!", _multi_constructor)


def load_yaml_with_tags(text: str) -> Any:
    return yaml.load(text, Loader=_TaggedLoader)
