"""Poisson pod arrivals with the Alibaba v2017 task mix, on a fixed
cluster, drawn from a seed as arrays that both sides turn into their own
events: the program's through `kubernetriks_tpu_torch` (imported only
inside `program_simulation`), the reference's through its frozen oracle.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kbench.tracegen import common


class Inputs(common.Inputs):
    def __init__(self, config: Dict, seed: int, days: float, out_dir: str) -> None:
        super().__init__(config, days)
        w = config["workload"]
        rng = np.random.default_rng(seed)
        horizon = self.horizon
        n = int(rng.poisson(w["rate_per_s"] * horizon))
        self.arrival = np.sort(np.round(rng.uniform(1.0, horizon, size=n), 3))
        lo, hi = w["cpu_santicores"]
        heavy = rng.random(n) < w["heavy_fraction"]
        self.cpu = 10 * np.where(heavy, rng.integers(hi, w["max_cpu_cores"] * 100 + 1, size=n),
                                 rng.integers(lo, hi + 1, size=n))
        self.ram = rng.integers(w["memory_mib"][0], w["memory_mib"][1], size=n) << 20
        self.duration = rng.integers(w["duration_s"][0], w["duration_s"][1] + 1, size=n).astype(np.float64)
        self.arrivals = self.arrival

    def pod_names(self) -> List[str]:
        return [f"pod_{i:07d}" for i in range(self.arrival.size)]

    def node_names(self) -> List[str]:
        c = self.config["cluster"]
        return [f"{c['name']}_{i}" for i in range(c["nodes"])]

    def _events(self, node_cls, pod_cls, create_node, create_pod, until=None) -> Tuple[list, list]:
        c = self.config["cluster"]
        cluster = [(0.0, create_node(node=node_cls.new(n, c["cpu"], c["ram"]))) for n in self.node_names()]
        n = self.arrival.size if until is None else int(np.searchsorted(self.arrival, until, side="right"))
        workload = [
            (t, create_pod(pod=pod_cls.new(name, cpu, ram, d)))
            for t, name, cpu, ram, d in zip(self.arrival[:n].tolist(), self.pod_names()[:n], self.cpu[:n].tolist(),
                                            self.ram[:n].tolist(), self.duration[:n].tolist())
        ]
        return cluster, workload

    def program_simulation(self, n_lanes: int, device, engine_kwargs: Dict):
        from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
        from kubernetriks_tpu_torch.config import SimulationConfig
        from kubernetriks_tpu_torch.core.events import CreateNodeRequest, CreatePodRequest
        from kubernetriks_tpu_torch.core.types import Node, Pod

        cluster, workload = self._events(Node, Pod, CreateNodeRequest, CreatePodRequest)
        return build_batched_from_traces(
            SimulationConfig.from_yaml(self.config_yaml()), cluster, workload,
            n_clusters=n_lanes, device=device, **engine_kwargs,
        )

    def reference_events(self, until=None):
        """The oracle's events of the pods that arrive at or before `until`
        (all where None)."""
        from kbench.reference.oracle.core.events import CreateNodeRequest, CreatePodRequest
        from kbench.reference.oracle.core.types import Node, Pod

        return self._events(Node, Pod, CreateNodeRequest, CreatePodRequest, until)
