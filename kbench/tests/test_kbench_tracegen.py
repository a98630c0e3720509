"""The generators' copies give the configurations' row counts and size
ranges for a seed, and the same seed gives the same inputs."""

import json
from pathlib import Path

import numpy as np

from kbench.tracegen import common

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "kbench" / "configs" / f"{name}.json").read_text())


def test_alibaba_rows_and_ranges(tmp_path):
    cfg = config("alibaba-v2017")
    gen = common.generator(cfg["generator"])
    inputs = gen.Inputs(cfg, 2**31 + 77, 0.25, str(tmp_path / "a"))
    machines = [r.split(",") for r in Path(inputs.paths[0]).read_text().splitlines()]
    adds = [r for r in machines if r[2] == "add"]
    fails = [r for r in machines if r[2] in ("softerror", "harderror")]
    assert len(adds) == 1313 and len(fails) == 131
    assert all(r[4] == "64" and float(r[5]) == 0.6875 for r in adds)
    times = np.array([int(r[0]) for r in fails])
    assert times.min() >= 0.02 * inputs.horizon and times.max() < 0.8 * inputs.horizon
    tasks = [r.split(",") for r in Path(inputs.paths[1]).read_text().splitlines()]
    assert len(tasks) == round(53472 * 0.25)
    cpu = np.array([int(r[6]) for r in tasks])
    assert cpu.min() >= 50 and cpu.max() <= 6400 and 0.005 < (cpu > 800).mean() < 0.04
    mem_mib = np.array([float(r[7]) for r in tasks]) * 128 * 1024
    assert np.all(mem_mib == np.round(mem_mib)) and mem_mib.min() >= 64 and mem_mib.max() < 4096
    dur = np.array([int(r[1]) - int(r[0]) for r in tasks])
    assert dur.min() >= 60 and dur.max() < 2400
    create = np.array([int(r[0]) for r in tasks])
    assert create.max() < 0.8 * inputs.horizon
    instances = Path(inputs.paths[2]).read_text().splitlines()
    n_inst = np.array([int(r[4]) for r in tasks])
    assert len(instances) == n_inst.sum() == inputs.arrivals.size
    again = gen.Inputs(cfg, 2**31 + 77, 0.25, str(tmp_path / "b"))
    assert all(Path(a).read_bytes() == Path(b).read_bytes() for a, b in zip(inputs.paths, again.paths))


def test_poisson_mix_rows_and_ranges(tmp_path):
    cfg = config("kubernetriks-config-yaml")
    gen = common.generator(cfg["generator"])
    inputs = gen.Inputs(cfg, 2**33 + 5, 0.5, str(tmp_path))
    n = inputs.arrival.size
    assert abs(n - 43200) < 5 * 43200**0.5
    assert np.all(np.diff(inputs.arrival) >= 0) and inputs.arrival.max() < inputs.horizon
    assert inputs.cpu.min() >= 500 and inputs.cpu.max() <= 64000 and np.all(inputs.cpu % 10 == 0)
    assert inputs.ram.min() >= 64 << 20 and inputs.ram.max() < 4096 << 20 and np.all(inputs.ram % (1 << 20) == 0)
    assert inputs.duration.min() >= 60 and inputs.duration.max() <= 2400
    cluster, workload = inputs.reference_events()
    assert len(cluster) == 10 and len(workload) == n
    again = gen.Inputs(cfg, 2**33 + 5, 0.5, str(tmp_path))
    assert np.array_equal(again.arrival, inputs.arrival) and np.array_equal(again.cpu, inputs.cpu)


def test_node_order_is_the_programs_slot_order(tmp_path):
    cfg = config("kubernetriks-config-yaml")
    inputs = common.generator(cfg["generator"]).Inputs(cfg, 1, 0.01, str(tmp_path))
    names = ["autoscaler_64cpu_128gb_node_2", "default_128cpu_256gb_node_9", "autoscaler_128cpu_256gb_node_10",
             "default_128cpu_256gb_node_0", "autoscaler_128cpu_256gb_node_9"]
    assert sorted(names, key=inputs.node_order()) == [
        "default_128cpu_256gb_node_0", "default_128cpu_256gb_node_9", "autoscaler_128cpu_256gb_node_9",
        "autoscaler_128cpu_256gb_node_10", "autoscaler_64cpu_128gb_node_2"]
