"""What every input generator shares: the simulation config as YAML text
(which the program and the reference each parse with their own parser),
the trace's horizon and the node order of the program's slots."""

from __future__ import annotations

import importlib
import re
from typing import Dict, List, Optional

import numpy as np
import yaml


class Inputs:
    """One deployment's generated inputs. Subclasses set `arrivals` (the
    pods' sorted arrival times, one lane's) and give `node_names()` (the
    cluster trace's nodes in creation order), `program_simulation()` and
    `reference_events()`."""

    trace_config: Optional[Dict] = None

    def __init__(self, config: Dict, days: float) -> None:
        self.config = config
        self.days = days
        self.horizon = 86400.0 * days

    def config_dict(self, scenario: Optional[Dict] = None) -> Dict:
        """The simulation block, the trace paths where the generator wrote
        files, a stand-in for the CA's scale-down threshold where the
        configuration gives one at its top level, and one lane's scenario
        (fleet.SCENARIO_KEYS' CA keys) on top: what the program and the
        reference run a lane with."""
        d = yaml.safe_load(yaml.safe_dump(self.config["simulation"]))
        if self.trace_config is not None:
            d["trace_config"] = self.trace_config
        ca = d.get("cluster_autoscaler", {})
        if "scale_down_utilization_threshold" in self.config:
            ca.setdefault("kube_cluster_autoscaler", {})["scale_down_utilization_threshold"] = float(
                self.config["scale_down_utilization_threshold"])
        if scenario:
            if "ca_scan_interval" in scenario:
                ca["scan_interval"] = float(scenario["ca_scan_interval"])
            if "ca_max_node_count" in scenario:
                ca["max_node_count"] = int(scenario["ca_max_node_count"])
            if "ca_threshold" in scenario:
                ca.setdefault("kube_cluster_autoscaler", {})["scale_down_utilization_threshold"] = float(
                    scenario["ca_threshold"])
        return d

    def config_yaml(self, scenario: Optional[Dict] = None) -> str:
        return yaml.safe_dump(self.config_dict(scenario), sort_keys=False)

    def node_names(self) -> List[str]:
        raise NotImplementedError

    def arrivals_between(self, t0: float, t1: float) -> int:
        """Pods one lane creates in [t0, t1)."""
        return int(np.searchsorted(self.arrivals, t1) - np.searchsorted(self.arrivals, t0))

    def node_order(self):
        """Sort key of a node name in the program's slot order: the cluster
        trace's nodes in creation order, then each CA group's nodes (groups
        in template-name order) by allocation number."""
        trace = {n: i for i, n in enumerate(self.node_names())}
        groups = sorted(g["node_template"]["metadata"]["name"]
                        for g in self.config["simulation"].get("cluster_autoscaler", {}).get("node_groups", []))
        rank = {g: i for i, g in enumerate(groups)}
        pattern = re.compile(r"^(.*)_(\d+)$")

        def key(name: str):
            if name in trace:
                return (0, trace[name], 0)
            m = pattern.match(name)
            if m is None or m.group(1) not in rank:
                raise KeyError(f"node {name!r} is neither in the trace nor a CA group's")
            return (1, rank[m.group(1)], int(m.group(2)))

        return key


def generator(name: str):
    """The generator module `tracegen/<name>.py`, found by name."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"bad generator name {name!r}")
    return importlib.import_module(f"kbench.tracegen.{name}")
