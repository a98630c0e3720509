"""The port's scalar event-loop oracle against the JAX package's, on the CPU.

Both are plain Python in float64 over the same event order, tie-breaks,
name-sorted walks and `random.Random(seed)` stream, so they are compared
exactly (`==`): every pod and node the persistent storage holds (conditions
and their times, the assigned node), the succeeded and failed pods, the
unscheduled cache, the accumulated and gauge metrics, the node-count
series, the gauge CSV's bytes and the printer's JSON and table. The traces
are the JAX package's own scalar-equivalence traces: the batch-of-one
trace under both delay settings, the HPA-driven CA trace, the chaos
engine's fault configs, the default-cluster configs, the Alibaba replay at
the reference's test size, and the event kernel's FIFO and cancellation
cases. The CLI's `--backend scalar` is held against the JAX CLI's.
"""

import copy
import dataclasses
import enum
import importlib
import json
import math
import os

import numpy as np
import pytest

import test_torch_reference  # noqa: F401  (installs the JAX alias before the reference imports)
from test_batched_equivalence import CLUSTER_YAML, make_workload
from test_chaos import FAULT_YAML, GROUP_FAULT_YAML
from test_hpa_ca_combined import CLUSTER_TRACE as HPA_CA_CLUSTER
from test_hpa_ca_combined import CONFIG_SUFFIX as HPA_CA_SUFFIX
from test_hpa_ca_combined import WORKLOAD_TRACE as HPA_CA_WORKLOAD
from test_random_equivalence import END_TIME, generate_traces
from test_torch_replay import REFERENCE_SIZE, alibaba_yaml, restore_logging  # noqa: F401  (restore_logging: a fixture)

import kubernetriks_tpu.cli as jax_cli
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML

from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.trace import synthetic_alibaba as port_synth

from chip_smoke import SCALAR_ZERO_DELAYS

PACKAGES = {"jax": "kubernetriks_tpu", "port": "kubernetriks_tpu_torch"}
SIDES = tuple(PACKAGES)

DEFAULT_CLUSTERS = {
    "unnamed": """
default_cluster:
- node_count: 10
  node_template:
      metadata:
        labels: {storage_type: ssd, proc_type: intel}
      status: {capacity: {cpu: 18000, ram: 18589934592}}
- node_count: 20
  node_template:
      status: {capacity: {cpu: 24000, ram: 18589934592}}
""",
    "prefixed": """
default_cluster:
- node_count: 5
  node_template:
      metadata: {name: group_a}
      status: {capacity: {cpu: 18000, ram: 18589934592}}
""",
    "single_named": """
default_cluster:
- node_template:
      metadata: {name: super_node}
      status: {capacity: {cpu: 1024000, ram: 549755813888}}
- node_count: 1
  node_template:
      metadata: {name: another_single}
      status: {capacity: {cpu: 2000, ram: 4294967296}}
""",
    "mixed": """
default_cluster:
- node_count: 2
  node_template:
      metadata: {name: prefix_a}
      status: {capacity: {cpu: 4000, ram: 8589934592}}
- node_count: 2
  node_template:
      status: {capacity: {cpu: 8000, ram: 17179869184}}
""",
}

def mod(side: str, name: str):
    return importlib.import_module(f"{PACKAGES[side]}.{name}")


def plain(x):
    """A package-neutral value of `x`: dataclasses by field, enums by
    value, estimators by their accumulators, NaN as a string (NaN != NaN),
    sets sorted, so the two packages' objects compare with ==."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if type(x).__name__ == "Estimator":
        return ("Estimator", plain([x._count, x._min, x._max, x._mean, x._m2]))
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def snapshot(sim) -> dict:
    """What one scalar run leaves: its clock and event count, the storage's
    objects (every pod's conditions and assigned node), the terminal pod
    maps, the node count, and the collector's metrics."""
    storage = sim.persistent_storage
    out = {
        "time": sim.sim.time(),
        "events": sim.sim.event_count(),
        "nodes": plain(storage.storage_data.nodes),
        "pods": plain(storage.storage_data.pods),
        "succeeded": plain(storage.succeeded_pods),
        "failed": plain(storage.failed_pods),
        "unscheduled": plain(storage.unscheduled_pods_cache),
        "assignments": plain(storage.assignments),
        "node_count": sim.api_server.node_count(),
        "accumulated": plain(sim.metrics_collector.accumulated_metrics),
        "gauges": plain(sim.metrics_collector.gauge_metrics),
    }
    if sim.horizontal_pod_autoscaler is not None:
        out["pod_groups"] = plain({k: v.created_pods for k, v in sim.horizontal_pod_autoscaler.pod_groups.items()})
    return out


def build_scalar(side, config_yaml, cluster, workload, gauge_csv=None):
    """A scalar simulation of one package, initialized on the generic
    traces `cluster` / `workload` (YAML text or event-dict lists)."""
    generic = mod(side, "trace.generic")

    def trace(cls, src):
        return cls.from_yaml(src) if isinstance(src, str) else cls(events=copy.deepcopy(src))

    sim = mod(side, "sim.simulator").KubernetriksSimulation(
        mod(side, "config").SimulationConfig.from_yaml(config_yaml), gauge_csv_path=gauge_csv
    )
    sim.initialize(trace(generic.GenericClusterTrace, cluster), trace(generic.GenericWorkloadTrace, workload))
    return sim


def run_pair(tmp_path, config_yaml, cluster, workload, samples, until=None, sample=None):
    """Both packages' scalar runs stepped through `samples` (the node count,
    and `sample(sim)` where given, read at each), then to `until`. Returns
    {side: (snapshot, series, gauge CSV bytes, printer JSON, printer table)}."""
    out = {}
    for side in SIDES:
        csv_path = str(tmp_path / f"gauges_{side}.csv")
        sim = build_scalar(side, config_yaml, cluster, workload, gauge_csv=csv_path)
        series = []
        for t in samples:
            sim.step_until_time(float(t))
            series.append((sim.api_server.node_count(), sample(sim) if sample else None))
        if until is not None:
            sim.step_until_time(until)
        printer = mod(side, "metrics.printer")
        report = (json.dumps(printer.metrics_as_dict(sim.metrics_collector), indent=2),
                  printer.metrics_as_pretty_table(sim.metrics_collector))
        sim.metrics_collector.close()
        with open(csv_path, "rb") as f:
            out[side] = (snapshot(sim), series, f.read(), *report)
    return out


def assert_pair_equal(out):
    jx, port = out["jax"], out["port"]
    for key in jx[0]:
        assert port[0][key] == jx[0][key], key
    assert port[1] == jx[1], "node-count series"
    assert port[2] == jx[2], "gauge CSV bytes"
    assert port[3] == jx[3], "printer JSON"
    assert port[4] == jx[4], "printer table"


def random_events(seed):
    cluster, workload = generate_traces(seed)
    return cluster.events, workload.events


@pytest.mark.parametrize("delays", ["zero", "reference"])
def test_batch_of_one_trace_matches_reference(tmp_path, delays):
    workload, _ = make_workload()
    config = DEFAULT_TEST_CONFIG_YAML + (SCALAR_ZERO_DELAYS if delays == "zero" else "")
    out = run_pair(tmp_path, config, CLUSTER_YAML, workload, np.arange(5.0, 2000.0, 10.0))
    assert_pair_equal(out)
    assert out["port"][0]["accumulated"][1]["pods_succeeded"] == 7


def test_hpa_ca_trace_matches_reference(tmp_path):
    out = run_pair(
        tmp_path, DEFAULT_TEST_CONFIG_YAML + HPA_CA_SUFFIX, HPA_CA_CLUSTER, HPA_CA_WORKLOAD,
        np.arange(61.0, 1800.0, 60.0),
        sample=lambda sim: len(sim.horizontal_pod_autoscaler.pod_groups["grp"].created_pods),
    )
    assert_pair_equal(out)
    accumulated = out["port"][0]["accumulated"][1]
    assert accumulated["total_scaled_up_nodes"] == 4 and accumulated["total_scaled_up_pods"] == 15


@pytest.mark.parametrize("seed,fault_yaml", [(101, FAULT_YAML), (202, GROUP_FAULT_YAML)], ids=["node_pod", "groups"])
def test_chaos_trace_matches_reference(tmp_path, seed, fault_yaml):
    cluster, workload = random_events(seed)
    out = run_pair(tmp_path, DEFAULT_TEST_CONFIG_YAML + fault_yaml, cluster, workload,
                   np.arange(5.0, END_TIME, 250.0), until=END_TIME)
    assert_pair_equal(out)
    accumulated = out["port"][0]["accumulated"][1]
    assert accumulated["node_crashes"] > 0 and accumulated["pod_restarts"] > 0


@pytest.mark.parametrize("name", sorted(DEFAULT_CLUSTERS))
def test_default_cluster_matches_reference(tmp_path, name):
    workload, _ = make_workload()
    empty = "events: []"
    out = run_pair(tmp_path, DEFAULT_TEST_CONFIG_YAML + DEFAULT_CLUSTERS[name], empty, workload,
                   np.arange(5.0, 600.0, 10.0), until=2000.0)
    assert_pair_equal(out)
    assert out["port"][0]["node_count"] == {"unnamed": 30, "prefixed": 5, "single_named": 2, "mixed": 4}[name]


def test_alibaba_replay_matches_reference(tmp_path):
    """The replay at the reference's test size, to completion, through the
    run-until-all-pods-finished callbacks the CLI runs."""
    paths = port_synth.write_synthetic_trace_dir(str(tmp_path), **REFERENCE_SIZE)
    machines, tasks, instances = paths
    out = {}
    for side in SIDES:
        alibaba = mod(side, "trace.alibaba")
        sim = mod(side, "sim.simulator").KubernetriksSimulation(
            mod(side, "config").SimulationConfig.from_yaml(alibaba_yaml(paths))
        )
        sim.initialize(alibaba.AlibabaClusterTraceV2017.from_file(machines),
                       alibaba.AlibabaWorkloadTraceV2017.from_files(instances, tasks))
        sim.run_with_callbacks(mod(side, "sim.callbacks").RunUntilAllPodsAreFinishedCallbacks())
        out[side] = snapshot(sim)
    for key in out["jax"]:
        assert out["port"][key] == out["jax"][key], key
    assert out["port"]["accumulated"][1]["pods_succeeded"] > 500


def _kernel_run(side):
    """Same-time FIFO order, cancellation and the seeded draws of one
    package's event kernel."""
    kernel = mod(side, "sim.kernel")

    @dataclasses.dataclass
    class Ping:
        tag: str

    class Recorder(kernel.EventHandler):
        def __init__(self):
            self.seen = []

        def on_ping(self, data, time):
            self.seen.append((time, data.tag))

    sim = kernel.Simulation(seed=46)
    rec = Recorder()
    dst = sim.add_handler("rec", rec)
    ctx = sim.create_context("src")
    ids = [ctx.emit(Ping(tag), dst, ts) for tag, ts in
           (("late", 5.0), ("first_at_2", 2.0), ("second_at_2", 2.0), ("early", 1.0), ("third_at_2", 2.0),
            ("dropped", 2.0), ("at_0", 0.0))]
    ctx.cancel_event(ids[5])
    sim.step_until_time(1.5)
    mid = (sim.time(), list(rec.seen))
    ctx.emit(Ping("after_cancel"), dst, 0.5)
    sim.step_until_no_events()
    draws = [ctx.gen_range_float(0.0, 1.0) for _ in range(20)] + [ctx.gen_range_int(0, 1000) for _ in range(20)]
    return mid, rec.seen, sim.time(), sim.event_count(), ids, draws


def test_event_kernel_matches_reference():
    want, got = _kernel_run("jax"), _kernel_run("port")
    assert got == want
    seen = got[1]
    assert [tag for _, tag in seen if _ == 2.0] == ["first_at_2", "second_at_2", "third_at_2", "after_cancel"]
    assert "dropped" not in [tag for _, tag in seen]


def _generic_cli_config(tmp_path, extra=""):
    workload, _ = make_workload()
    (tmp_path / "cluster.yaml").write_text(CLUSTER_YAML)
    (tmp_path / "workload.yaml").write_text(workload)
    path = tmp_path / "config.yaml"
    path.write_text(DEFAULT_TEST_CONFIG_YAML + extra + f"""
trace_config:
  generic_trace:
    workload_trace_path: {tmp_path / "workload.yaml"}
    cluster_trace_path: {tmp_path / "cluster.yaml"}
""")
    return str(path)


@pytest.mark.parametrize("report", [["--report", "json"], ["--report", "table"], [], ["--profile", "best_fit"]],
                         ids=["json", "table", "config_printer", "profile"])
def test_cli_scalar_backend_matches_reference_cli(tmp_path, capsys, restore_logging, report):
    """`--backend scalar` of both CLIs on one config: the same stdout and
    the same gauge CSV bytes; without --report the config's
    metrics_printer block (PrettyTable to a file here) reports."""
    extra = "" if report else f"metrics_printer:\n  format: PrettyTable\n  output_file: {{out}}\n"
    outputs = {}
    for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        d = tmp_path / side
        d.mkdir()
        config = _generic_cli_config(d, extra.format(out=d / "report.txt"))
        assert main(["--config-file", config, "--backend", "scalar", "--gauge-csv", str(d / "g.csv"), *report]) == 0
        printed = (d / "report.txt").read_text() if not report else ""
        outputs[side] = (capsys.readouterr().out, (d / "g.csv").read_bytes(), printed)
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"][1].splitlines()) > 10
    if report == ["--report", "json"]:
        assert json.loads(outputs["port"][0])["counters"]["pods_succeeded"] == 7
    if not report:
        assert "| Pods succeeded" in outputs["port"][2]


def test_cli_logs_to_the_configured_file(tmp_path, capsys, restore_logging):
    log = tmp_path / "logs" / "sim.log"
    config = _generic_cli_config(tmp_path, f"logs_filepath: {log}\n")
    assert port_cli.main(["--config-file", config, "--backend", "scalar", "--report", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["counters"]["pods_succeeded"] == 7
    assert os.path.getsize(log) > 0 and "Processed" in log.read_text()
