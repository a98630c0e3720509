"""The Alibaba cluster-trace-v2017 CSVs, synthesized from a seed.

The benchmark's own copy of the port's `trace/synthetic_alibaba.py`,
vectorized: the same columns, distributions and fit filter (every task
fits a 64-core machine), drawn in bulk so that a week of rows takes well
under a second. The real trace is not in the repository. Both the program
(its native CSV feeder) and the plain reference (its copy of the Python
parser) read the files this writes.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from kbench.tracegen import common

MEMORY_BASE_MIB = 128 * 1024  # the trace normalizes memory to 128 GiB


def machine_events(rng: np.random.Generator, n_machines: int, cores: int, memory: float,
                   error_fraction: float, error_window: Tuple[float, float]) -> str:
    """machine_events.csv: an `add` row per machine at t = 0, then a
    softerror or harderror (a removal) for `error_fraction` of them at a
    uniform time in `error_window` seconds."""
    rows = [(0, m, "add", "", cores, memory) for m in range(n_machines)]
    n_errors = int(n_machines * error_fraction)
    failing = rng.choice(n_machines, size=n_errors, replace=False)
    times = rng.uniform(error_window[0], error_window[1], size=n_errors).astype(np.int64)
    kinds = np.where(rng.random(n_errors) < 0.5, "softerror", "harderror")
    rows += [(int(t), int(m), str(k), "", "", "") for t, m, k in zip(times, failing, kinds)]
    rows.sort(key=lambda r: (r[0], r[1]))
    return "".join(",".join(str(x) for x in r) + "\n" for r in rows)


def batch_workload(rng: np.random.Generator, n_tasks: int, arrival_horizon: float, p: Dict) -> Tuple[str, str, np.ndarray]:
    """(batch_task.csv, batch_instance.csv, the instances' sorted start
    times): `n_tasks`
    tasks created uniformly over [1, arrival_horizon) s, each with 1 to
    `max_instances` instances starting within a minute of it; cpu in
    santicores, mostly sub-8-core with a `heavy_fraction` tail to
    `max_cpu_cores`; memory MiB-aligned against the 128 GiB base."""
    lo, hi = p["cpu_santicores"]
    n_inst = rng.integers(1, p["max_instances"] + 1, size=n_tasks)
    heavy = rng.random(n_tasks) < p["heavy_fraction"]
    cpus = np.where(heavy, rng.integers(hi, p["max_cpu_cores"] * 100 + 1, size=n_tasks),
                    rng.integers(lo, hi + 1, size=n_tasks))
    mem_mib = rng.integers(p["memory_mib"][0], p["memory_mib"][1], size=n_tasks)
    create = rng.uniform(1.0, arrival_horizon, size=n_tasks).astype(np.int64)
    duration = rng.uniform(p["duration_s"][0], p["duration_s"][1], size=n_tasks).astype(np.int64)
    job = 1_000_000 + np.arange(n_tasks) // 4
    task = 2_000_000 + np.arange(n_tasks)
    mem = [repr(m / MEMORY_BASE_MIB) for m in mem_mib.tolist()]
    tasks = "".join(
        f"{c},{c + d},{j},{t},{n},Terminated,{cpu},{m}\n"
        for c, d, j, t, n, cpu, m in zip(create.tolist(), duration.tolist(), job.tolist(), task.tolist(),
                                         n_inst.tolist(), cpus.tolist(), mem)
    )
    owner = np.repeat(np.arange(n_tasks), n_inst)
    seq = np.arange(owner.size) - np.repeat(np.cumsum(n_inst) - n_inst, n_inst)
    start = create[owner] + rng.uniform(0.0, 60.0, size=owner.size).astype(np.int64)
    machine = rng.integers(0, 1313, size=owner.size)
    order = np.argsort(start, kind="stable")
    instances = "".join(
        f"{s},{s + duration[o]},{job[o]},{task[o]},{mid},Terminated,{q},{n_inst[o]}\n"
        for s, o, mid, q in zip(start[order].tolist(), owner[order].tolist(), machine[order].tolist(),
                                seq[order].tolist())
    )
    return tasks, instances, start[order]


def write(out_dir: str, seed: int, deployment: Dict, days: float) -> Tuple[Tuple[str, str, str], np.ndarray]:
    """Write the three CSVs of `deployment` (a configuration's `cluster`
    and `workload` blocks) for `days` days of arrivals at the day's
    density into out_dir; returns the (machine_events, batch_task,
    batch_instance) paths and the pods' sorted arrival times."""
    rng = np.random.default_rng(seed)
    cluster, workload = deployment["cluster"], deployment["workload"]
    horizon = 86400.0 * days
    os.makedirs(out_dir, exist_ok=True)
    paths = tuple(os.path.join(out_dir, n) for n in ("machine_events.csv", "batch_task.csv", "batch_instance.csv"))
    window = [f * horizon for f in cluster["error_window_fraction"]]
    with open(paths[0], "w") as f:
        f.write(machine_events(rng, cluster["machines"], cluster["cores"], cluster["normalized_memory"],
                               cluster["error_fraction"], window))
    n_tasks = int(round(workload["tasks_per_day"] * days))
    tasks, instances, arrivals = batch_workload(rng, n_tasks, workload["arrival_fraction"] * horizon, workload)
    with open(paths[1], "w") as f:
        f.write(tasks)
    with open(paths[2], "w") as f:
        f.write(instances)
    return paths, arrivals.astype(np.float64)


class Inputs(common.Inputs):
    """The CSVs of one seed under out_dir; both sides parse them."""

    def __init__(self, config: Dict, seed: int, days: float, out_dir: str) -> None:
        super().__init__(config, days)
        self.paths, self.arrivals = write(out_dir, seed, config, days)
        self.trace_config = {"alibaba_cluster_trace_v2017": {
            "machine_events_trace_path": self.paths[0],
            "batch_task_trace_path": self.paths[1],
            "batch_instance_trace_path": self.paths[2],
        }}

    def node_names(self):
        return [f"alibaba_node_{m}" for m in range(self.config["cluster"]["machines"])]

    def program_simulation(self, n_lanes: int, device, engine_kwargs: Dict):
        from kubernetriks_tpu_torch.cli import build_batched_simulation
        from kubernetriks_tpu_torch.config import SimulationConfig

        return build_batched_simulation(SimulationConfig.from_yaml(self.config_yaml()), n_lanes, device=device,
                                        **engine_kwargs)

    def reference_events(self, until=None):
        """The oracle's events, parsed by its own copy of the CSV parser
        from the rows at or before `until` (all where None): the instance
        rows are sorted by start, so the pods keep their names."""
        from kbench.reference.oracle.trace.alibaba import (
            AlibabaClusterTraceV2017,
            AlibabaWorkloadTraceV2017,
            read_batch_instances,
            read_batch_tasks,
        )

        def rows(path):
            with open(path) as f:
                text = f.read()
            if until is None:
                return text
            return "".join(line for line in text.splitlines(keepends=True) if int(line.split(",", 1)[0]) <= until)

        cluster = AlibabaClusterTraceV2017.from_file(self.paths[0])
        workload = AlibabaWorkloadTraceV2017(read_batch_instances(rows(self.paths[2])), read_batch_tasks(rows(self.paths[1])))
        return cluster.convert_to_simulator_events(), workload.convert_to_simulator_events()
