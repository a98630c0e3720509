"""One lane of a cell through the frozen oracle (`reference/oracle/`, a
copy of the port's scalar event-loop simulator with the benchmark's
scheduler semantics): the plain reference that decides `correct`.

It imports nothing of the program. Its inputs are the generator's raw
files or arrays, turned into events by the oracle's own parser."""

from __future__ import annotations

from typing import Dict, List, Optional

from kbench.reference.oracle.config import SimulationConfig
from kbench.reference.oracle.core.types import PodConditionType
from kbench.reference.oracle.sim.simulator import KubernetriksSimulation
from kbench.reference.oracle.trace.interface import Trace


class _Events(Trace):
    def __init__(self, events: list) -> None:
        self.events = events

    def convert_to_simulator_events(self):
        events, self.events = self.events, []
        return events

    def event_count(self) -> int:
        return len(self.events)


def lane(inputs, scenario: Optional[Dict], bounds: Dict[str, int], precision: str = "float32",
         until: Optional[float] = None):
    """The oracle of one lane, at time 0: the deployment's config with the
    lane's scenario, the generator's events (those up to `until` where it
    is given: the state up to then is the same), the engine's bounds
    (max_pods_per_cycle; max_ca_pods_per_cycle, max_pods_per_scale_down
    where the configuration states them), the score precision and the
    program's node slot order."""
    config = SimulationConfig.from_dict(inputs.config_dict(scenario))
    sim = KubernetriksSimulation(config)
    cluster, workload = inputs.reference_events(until)
    sim.initialize(_Events(cluster), _Events(workload))
    sim.scheduler.max_pods_per_cycle = int(bounds["max_pods_per_cycle"])
    sim.scheduler.score_precision = precision
    sim.scheduler.node_order = inputs.node_order()
    if sim.cluster_autoscaler is not None:
        algo = sim.cluster_autoscaler.autoscaling_algorithm
        algo.max_pods_per_scale_up = int(bounds.get("max_ca_pods_per_cycle", 0))
        algo.max_pods_per_scale_down = int(bounds.get("max_pods_per_scale_down", 0))
        sim.persistent_storage.scale_down_threshold = algo.config.scale_down_utilization_threshold
    return sim


def pods(sim, names: List[str]) -> Dict[str, Dict]:
    """{name: {state, node, start}} of the named pods: state "running"
    (bound, not finished), "succeeded", "waiting" (queued or parked),
    "absent" (not created yet); node and start of the last attempt."""
    storage = sim.persistent_storage
    out = {}
    for name in names:
        pod = storage.succeeded_pods.get(name)
        state = "succeeded"
        if pod is None:
            pod = storage.get_pod(name)
            state = "absent" if pod is None else ("running" if pod.status.assigned_node else "waiting")
        node = pod.status.assigned_node if pod is not None and state in ("running", "succeeded") else None
        start = None
        if node:
            cond = pod.get_condition(PodConditionType.POD_RUNNING)
            start = None if cond is None else cond.last_transition_time
        out[name] = {"state": state, "node": node or None, "start": start}
    return out


def counters(sim) -> Dict[str, int]:
    """The lane's counters that the program also keeps."""
    m = sim.metrics_collector.accumulated_metrics
    return {
        "scheduling_decisions": sim.scheduler.decisions,
        "pods_succeeded": m.pods_succeeded,
        "terminated_pods": m.internal.terminated_pods,
        "pods_removed": m.pods_removed,
        "nodes": sim.api_server.node_count(),
    }


def ca_counts(sim, before: float) -> Dict[str, int]:
    """The CA's counters as of the cycles whose storage snapshot (fire
    time + as_to_ca + as_to_ps) falls before `before`: nodes scaled up,
    scaled down, and each group's count ("ca_nodes.<group>"). The program
    counts a cycle in the window that holds its snapshot."""
    ca = sim.cluster_autoscaler
    if ca is None:
        return {}
    cfg = sim.config
    snap = cfg.as_to_ca_network_delay + cfg.as_to_ps_network_delay
    out = {"scaled_up_nodes": 0, "scaled_down_nodes": 0}
    groups = {name: 0 for name in ca.node_groups}
    for fired, up, down, after in ca.cycles:
        if fired + snap < before:
            out["scaled_up_nodes"] += up
            out["scaled_down_nodes"] += down
            groups = after
    out.update({f"ca_nodes.{name}": n for name, n in groups.items()})
    return out


def expected(ref: Dict) -> Dict[str, int]:
    """The counters a run is judged on, from a readout: decisions half a
    cycle past T (the cycle at T has committed), the CA's as of the
    program's last window, the rest at T."""
    return {"scheduling_decisions": ref["late"]["scheduling_decisions"],
            **{k: ref["at_t"][k] for k in ("pods_succeeded", "terminated_pods", "pods_removed", "nodes")},
            **ref["ca"]}


def readout(inputs, scenario: Optional[Dict], bounds: Dict[str, int], precision: str, until: float, half: float,
            names: List[str]) -> Dict:
    """One lane to `until`: its counters there, half a cycle later its
    counters and the named pods (what compare.py judges a run by), and
    the CA's counters as of the program's window past `until` (stepped
    until every cycle snapped in it has answered). A picklable entry for
    a worker process."""
    interval = 2.0 * half
    ca_end = until + interval
    sim = lane(inputs, scenario, bounds, precision, ca_end + interval)
    sim.step_until_time(until)
    at_t = counters(sim)
    sim.step_until_time(until + half)
    out = {"at_t": at_t, "late": counters(sim), "pods": pods(sim, names)}
    cfg = sim.config
    sim.step_until_time(ca_end + 2.0 * (cfg.as_to_ca_network_delay + cfg.as_to_ps_network_delay))
    out["ca"] = ca_counts(sim, ca_end)
    return out
