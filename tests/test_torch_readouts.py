"""The port engine's scalar-equivalence readouts (`pod_view`,
`cluster_metrics`, `node_count_at`, `window_times`), on the CPU.

(1) They equal the JAX engine's readouts (its XLA path) on the same runs:
    the batch-of-one trace, a chaos run sampled right after a crash inside
    a window the step has not applied yet, a CA churn with slot reclaim,
    and a run through the sliding pod window.
(2) The port's batched engine at C = 1 equals the port's own scalar
    oracle, as the JAX package's equivalence tests hold its engine to its
    oracle: integer facts exactly, start times to 1e-2 s (5e-6 s on the
    random traces), timing stats to rel 1e-4. The batch-of-one, HPA-driven
    CA and fault cases are chip_smoke.py's phase 24a checks, run here on
    the CPU; chip_smoke's copies of the JAX tests' traces equal them.
"""

import copy

import numpy as np
import pytest

from test_torch_reference import jax_build, port_build  # installs the JAX alias first
from test_batched_equivalence import CLUSTER_YAML, GiB, make_workload, pod_yaml
from test_chaos import FAULT_YAML
from test_hpa_ca_combined import CLUSTER_TRACE as HPA_CA_CLUSTER
from test_hpa_ca_combined import CONFIG_SUFFIX as HPA_CA_SUFFIX
from test_hpa_ca_combined import WORKLOAD_TRACE as HPA_CA_WORKLOAD
from test_random_ca_equivalence import CA_CONFIG_SUFFIX
from test_random_ca_equivalence import CLUSTER_TRACE as CA_CLUSTER
from test_random_ca_equivalence import make_workload as ca_workload
from test_random_equivalence import END_TIME, generate_traces
from test_reclaim import CLUSTER_TRACE as RECLAIM_CLUSTER
from test_reclaim import RECLAIM_CA_SUFFIX, wave_workload
from test_torch_replay import alibaba_yaml

from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu.trace import generic as jax_generic

from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.sim.simulator import KubernetriksSimulation
from kubernetriks_tpu_torch.trace import generic as port_generic
from kubernetriks_tpu_torch.trace import synthetic_alibaba as port_synth
from kubernetriks_tpu_torch.trace.alibaba import AlibabaClusterTraceV2017, AlibabaWorkloadTraceV2017

import chip_smoke
from chip_smoke import metrics_against_oracle, pods_against_oracle, scalar_oracle


def events(side, cluster, workload):
    """Both traces as `side`'s event objects; each argument YAML text or a
    list of event dicts."""
    generic = jax_generic if side == "jax" else port_generic

    def trace(cls, src):
        return cls.from_yaml(src) if isinstance(src, str) else cls(events=copy.deepcopy(src))

    return (
        trace(generic.GenericClusterTrace, cluster).convert_to_simulator_events(),
        trace(generic.GenericWorkloadTrace, workload).convert_to_simulator_events(),
    )


def engines(config_yaml, cluster, workload, **kwargs):
    """(JAX engine on its XLA path, port engine on the CPU), C = 1."""
    jx = jax_build(JaxConfig.from_yaml(config_yaml), *events("jax", cluster, workload), n_clusters=1,
                   use_pallas=False, **kwargs)
    return jx, port_engine(config_yaml, cluster, workload, **kwargs)


def port_engine(config_yaml, cluster, workload, **kwargs):
    return port_build(PortConfig.from_yaml(config_yaml), *events("port", cluster, workload), n_clusters=1,
                      device="cpu", **kwargs)


def assert_readouts_equal(jx, port, t, cluster=0):
    """The four readouts of the two engines at sample time `t`."""
    assert port.pod_view(cluster) == jx.pod_view(cluster), t
    assert port.cluster_metrics(cluster) == jx.cluster_metrics(cluster), t
    assert port.node_count_at(t, cluster) == jx.node_count_at(t, cluster), t
    np.testing.assert_array_equal(port.window_times(t + 100.0), jx.window_times(t + 100.0))


# --- (1) the port's readouts against the JAX engine's ---------------------------


def test_readouts_match_reference_on_the_batch_of_one_trace():
    workload, _ = make_workload()
    jx, port = engines(DEFAULT_TEST_CONFIG_YAML, CLUSTER_YAML, workload)
    for t in (15.0, 95.0, 205.0, 255.0, 2000.0):
        jx.step_until_time(t)
        port.step_until_time(t)
        assert_readouts_equal(jx, port, t)
    assert port.cluster_metrics(0)["pods_succeeded"] == 7
    assert port.window_times(35.0).tolist() == []


def test_readouts_match_reference_right_after_a_crash_mid_window():
    """A crash earlier in the window the step has not applied shows only
    through the node-event table's replay; the count equals the JAX
    engine's and the scalar oracle's there."""
    cluster, workload = generate_traces(101)
    cluster, workload = cluster.events, workload.events
    config = DEFAULT_TEST_CONFIG_YAML + FAULT_YAML
    jx, port = engines(config, cluster, workload, fast_forward=False)
    oracle = scalar_oracle(config, cluster, workload)
    for t in chip_smoke.crash_samples(config, cluster, workload):
        jx.step_until_time(t)
        port.step_until_time(t)
        oracle.step_until_time(t)
        assert_readouts_equal(jx, port, t)
        assert port.node_count_at(t) == oracle.api_server.node_count(), t
    assert port.metrics_summary()["counters"]["node_crashes"] > 0


def test_readouts_match_reference_on_a_reclaim_churn():
    jx, port = engines(DEFAULT_TEST_CONFIG_YAML + RECLAIM_CA_SUFFIX, RECLAIM_CLUSTER, wave_workload(6),
                       reclaim=True, ca_slot_multiplier=1, fast_forward=False)
    for t in np.arange(15.0, 1250.0, 40.0):
        jx.step_until_time(float(t))
        port.step_until_time(float(t))
        assert port.node_count_at(float(t)) == jx.node_count_at(float(t)), t
    assert_readouts_equal(jx, port, 1245.0)
    assert int(port.ca_slots_reclaimed().sum()) > 0
    assert any(name.startswith("ca_node_") for name in port.node_names[0])


def test_readouts_match_reference_through_the_pod_window():
    workload, _ = make_workload()
    jx, port = engines(DEFAULT_TEST_CONFIG_YAML, CLUSTER_YAML, workload, pod_window=3)
    for t in (25.0, 95.0, 215.0, 2000.0):
        jx.step_until_time(t)
        port.step_until_time(t)
        assert_readouts_equal(jx, port, t)
    assert port.dispatch_stats["slides"] > 0
    assert len(port.pod_view(0)) < 7  # the resident slots alone


# --- (2) the port's batched engine against the port's scalar oracle --------------


@pytest.mark.parametrize("delays", ["zero", "reference"])
def test_batch_of_one_matches_scalar(delays):
    assert chip_smoke.check_batch_of_one("cpu", delays, "cpu")["pods"] == 7


def test_hpa_drives_ca_like_scalar():
    assert chip_smoke.check_hpa_ca("cpu", "cpu")["peak"] == (9, 3)


def test_fault_trace_matches_scalar():
    assert chip_smoke.check_faults("cpu", "cpu")["counters"]["node_crashes"] > 0


def test_node_removal_reschedules_like_scalar():
    cluster = CLUSTER_YAML + """
- timestamp: 60
  event_type:
    !RemoveNode
      node_name: node_00
"""
    workload = "events:" + pod_yaml("pod_00", 6000, 12 * GiB, 100.0, 10)
    oracle = scalar_oracle(DEFAULT_TEST_CONFIG_YAML, cluster, workload)
    batched = port_engine(DEFAULT_TEST_CONFIG_YAML, cluster, workload)
    for t in (55.0, 65.0, 195.0, 205.0, 3000.0):
        oracle.step_until_time(t)
        batched.step_until_time(t)
        assert batched.node_count_at(t) == oracle.api_server.node_count(), t
    pods_against_oracle("node removal", batched, oracle, 1e-2)
    assert batched.pod_view(0)["pod_00"]["node"] == "node_02"


@pytest.mark.parametrize("seed,conditional_move", [(101, False), (202, False), (404, True)])
def test_random_trace_matches_scalar(seed, conditional_move):
    config = DEFAULT_TEST_CONFIG_YAML + (
        "enable_unscheduled_pods_conditional_move: true" if conditional_move else ""
    )
    cluster, workload = generate_traces(seed)
    cluster, workload = cluster.events, workload.events
    oracle = scalar_oracle(config, cluster, workload)
    oracle.step_until_time(END_TIME)
    batched = port_engine(config, cluster, workload)
    batched.step_until_time(END_TIME)
    pods_against_oracle(f"seed {seed}", batched, oracle, 5e-6)
    assert metrics_against_oracle(f"seed {seed}", batched, oracle)["pods_succeeded"] > 50


@pytest.mark.parametrize("seed", [1, 3, 6])
def test_ca_node_series_matches_scalar(seed):
    """The node count sampled 5 s into every window equals the scalar
    oracle's, sample for sample."""
    config = DEFAULT_TEST_CONFIG_YAML + CA_CONFIG_SUFFIX
    workload = ca_workload(seed)
    oracle = scalar_oracle(config, CA_CLUSTER, workload)
    batched = port_engine(config, CA_CLUSTER, workload)
    want, got = [], []
    for t in np.arange(15.0, 800.0, 10.0):
        oracle.step_until_time(float(t))
        batched.step_until_time(float(t))
        want.append(oracle.api_server.node_count())
        got.append(batched.node_count_at(float(t)))
    assert max(want) > 1
    assert got == want


def test_node_event_table_on_every_compile_route(tmp_path):
    """The event objects, the native feeder's compile_from_arrays and the
    streamed pod window build the same node-event table, and their
    node_count_at follows the scalar oracle through machine failures."""
    machines, tasks, instances = paths = port_synth.write_synthetic_trace_dir(
        str(tmp_path), n_machines=30, n_tasks=80, horizon=1500.0, error_fraction=0.2, seed=9)
    config = PortConfig.from_yaml(alibaba_yaml(paths))
    routes = {
        "objects": port_build(
            config, AlibabaClusterTraceV2017.from_file(machines).convert_to_simulator_events(),
            AlibabaWorkloadTraceV2017.from_files(instances, tasks).convert_to_simulator_events(),
            n_clusters=1, device="cpu", max_pods_per_cycle=256),
        "native": port_cli.build_batched_simulation(config, 1, device="cpu"),
        "streamed": port_cli.build_batched_simulation(config, 1, device="cpu", pod_window=16, stream=True),
    }
    want = routes["objects"]._node_event_table[0]
    assert int((~want[1]).sum()) > 0  # machine failures
    for sim in routes.values():
        for a, b in zip(sim._node_event_table[0], want):
            np.testing.assert_array_equal(a, b)
    oracle = KubernetriksSimulation(config)
    oracle.initialize(*port_cli.build_traces(config))
    for t in np.arange(5.0, 1500.0, 50.0):
        oracle.step_until_time(float(t))
        for name, sim in routes.items():
            sim.step_until_time(float(t))
            assert sim.node_count_at(float(t)) == oracle.api_server.node_count(), (name, t)
    assert routes["streamed"].dispatch_stats["slides"] > 0
    routes["streamed"].close()


def test_batched_gauge_csv_has_the_scalar_collectors_columns(tmp_path):
    workload, _ = make_workload()
    oracle = KubernetriksSimulation(PortConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML),
                                    gauge_csv_path=str(tmp_path / "scalar.csv"))
    oracle.initialize(*chip_smoke.generic_events(CLUSTER_YAML, workload))
    oracle.step_until_time(300.0)
    oracle.metrics_collector.close()
    batched = port_engine(DEFAULT_TEST_CONFIG_YAML, CLUSTER_YAML, workload)
    batched.collect_gauges = True
    batched.step_until_time(300.0)
    batched.write_gauge_csv(str(tmp_path / "batched.csv"))
    scalar_rows = (tmp_path / "scalar.csv").read_text().splitlines()
    batched_rows = (tmp_path / "batched.csv").read_text().splitlines()
    assert batched_rows[0] == scalar_rows[0]
    assert {len(r.split(",")) for r in batched_rows + scalar_rows} == {8}


def test_chip_smoke_traces_equal_the_reference_tests():
    assert chip_smoke.SCALAR_TEST_CONFIG_YAML == DEFAULT_TEST_CONFIG_YAML
    assert chip_smoke.EQUIV_CLUSTER_YAML == CLUSTER_YAML
    assert events("port", CLUSTER_YAML, chip_smoke.equiv_workload_yaml()) == events(
        "port", CLUSTER_YAML, make_workload()[0])
    assert (chip_smoke.HPA_CA_SUFFIX, chip_smoke.HPA_CA_CLUSTER, chip_smoke.HPA_CA_WORKLOAD) == (
        HPA_CA_SUFFIX, HPA_CA_CLUSTER, HPA_CA_WORKLOAD)
    assert chip_smoke.SCALAR_FAULT_YAML == FAULT_YAML
    assert chip_smoke.RANDOM_END_TIME == END_TIME
    for seed in (101, 202):
        cluster, workload = generate_traces(seed)
        assert chip_smoke.random_trace_events(seed) == (cluster.events, workload.events)
