"""Synthesize Alibaba-v2017-format CSV traces at configurable scale.

Own copy of the JAX package's `trace/synthetic_alibaba.py`: for the same
arguments it writes byte-identical files. The real trace is not
redistributable with this repo, so benchmarks and integration tests
synthesize statistically similar CSVs in the exact column format the
parsers consume (machine_events.csv per
reference src/trace/alibaba_cluster_trace_v2017/cluster.rs:16-38;
batch_task.csv / batch_instance.csv per workload.rs:15-41). Default shape
parameters follow the reference's "modified trace": 1,313 add-only machines
with 64 cores and normalized memory ~0.69, and a fit-filtered batch workload
of ~53k tasks (reference experiments/{modify_traces,alibaba_demo}.ipynb,
BASELINE.md).
"""

from __future__ import annotations

import os

import numpy as np

REFERENCE_MACHINES = 1313
REFERENCE_TASKS = 53472


def write_machine_events(
    path: str,
    n_machines: int = REFERENCE_MACHINES,
    cores: int = 64,
    normalized_memory: float = 0.6875,  # 88 GiB of the 128 GiB base: MiB-exact
    error_fraction: float = 0.0,
    horizon: float = 86400.0,
    seed: int = 0,
) -> int:
    """machine_events.csv: `add` rows at t=0 (the reference's modified trace
    keeps only adds); optionally a fraction of machines fail later
    (softerror -> node removal). Returns the number of rows written."""
    rng = np.random.default_rng(seed)
    rows = []
    for m in range(n_machines):
        rows.append((0, m, "add", "", cores, normalized_memory))
    n_errors = int(n_machines * error_fraction)
    for m in rng.choice(n_machines, size=n_errors, replace=False):
        ts = int(rng.uniform(0.2, 0.9) * horizon)
        kind = "softerror" if rng.random() < 0.5 else "harderror"
        rows.append((ts, int(m), kind, "", "", ""))
    rows.sort(key=lambda r: (r[0], r[1]))
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    return len(rows)


def write_batch_workload(
    task_path: str,
    instance_path: str,
    n_tasks: int = REFERENCE_TASKS,
    horizon: float = 86400.0,
    max_instances_per_task: int = 3,
    cpu_santicores_range=(50, 800),
    heavy_fraction: float = 0.02,
    max_cpu_cores: int = 64,
    duration_range=(60.0, 2400.0),
    seed: int = 1,
) -> int:
    """batch_task.csv + batch_instance.csv. Task sizing follows the real
    trace's character: mostly sub-8-core requests with a small heavy tail up
    to max_cpu_cores (the fit filter of modify_traces.ipynb cell 5 guarantees
    every task fits a 64-core machine; the reference demo's cluster runs at
    ~3-10% utilization, so defaults keep aggregate demand well under
    capacity). Returns the number of instance rows."""
    rng = np.random.default_rng(seed)
    task_rows = []
    instance_rows = []
    for t in range(n_tasks):
        job_id = 1_000_000 + t // 4
        task_id = 2_000_000 + t
        n_inst = int(rng.integers(1, max_instances_per_task + 1))
        # santicores: 1 core == 100.
        if rng.random() < heavy_fraction:
            cpus = int(rng.integers(cpu_santicores_range[1], max_cpu_cores * 100 + 1))
        else:
            cpus = int(rng.integers(cpu_santicores_range[0], cpu_santicores_range[1] + 1))
        # Normalized memory, MiB-aligned against the 128 GiB base so the
        # batched path's RAM quantization is exact.
        mem_mib = int(rng.integers(64, 4096))
        mem = mem_mib / (128 * 1024)
        create = int(rng.uniform(1.0, horizon * 0.8))
        duration = int(rng.uniform(duration_range[0], min(horizon * 0.2, duration_range[1])))
        task_rows.append(
            (create, create + duration, job_id, task_id, n_inst, "Terminated", cpus, mem)
        )
        for s in range(n_inst):
            start = create + int(rng.uniform(0.0, 60.0))
            end = start + duration
            instance_rows.append(
                (start, end, job_id, task_id, int(rng.integers(0, 1313)),
                 "Terminated", s, n_inst)
            )
    with open(task_path, "w") as f:
        for r in task_rows:
            f.write(",".join(str(x) for x in r) + "\n")
    instance_rows.sort(key=lambda r: r[0])
    with open(instance_path, "w") as f:
        for r in instance_rows:
            f.write(",".join(str(x) for x in r) + "\n")
    return len(instance_rows)


def write_synthetic_trace_dir(
    out_dir: str,
    n_machines: int = REFERENCE_MACHINES,
    n_tasks: int = REFERENCE_TASKS,
    horizon: float = 86400.0,
    error_fraction: float = 0.0,
    seed: int = 0,
):
    """Write all three CSVs into out_dir; returns their paths
    (machine_events, batch_task, batch_instance)."""
    os.makedirs(out_dir, exist_ok=True)
    machines = os.path.join(out_dir, "machine_events.csv")
    tasks = os.path.join(out_dir, "batch_task.csv")
    instances = os.path.join(out_dir, "batch_instance.csv")
    write_machine_events(
        machines, n_machines, error_fraction=error_fraction,
        horizon=horizon, seed=seed,
    )
    write_batch_workload(
        tasks, instances, n_tasks, horizon=horizon, seed=seed + 1
    )
    return machines, tasks, instances
