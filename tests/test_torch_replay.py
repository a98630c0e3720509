"""The port's trace-replay path (C < 128: the sorted cycle route) and its
CLI against the JAX reference, on the CPU.

- The port's Alibaba synthesizer writes the reference's bytes, and its
  parser plus trace compiler give the reference's arrays.
- The replay at the reference's own test size (tests/test_alibaba_batched_
  e2e.py: 100 machines, 700 tasks, 4 000 s, seed 7), built through the
  port's CLI functions at C=1 and K=256, equals the JAX XLA path under
  compare_states at several times and at completion, and its terminal
  counters and duration stats equal the scalar oracle's.
- A smaller cut equals the JAX path through `fused_schedule_cycle` in
  interpret mode.
- The contended cluster-autoscaler replay (the reference's
  `_contended_ca_setup`: 6 machines, 150 heavy tasks, 30 % machine
  failures, C=2, ca_slot_multiplier 4) equals the JAX XLA path at
  completion.
- At C=128 the three cycle routes give the same states, and the two-kernel
  route equals the reference's interpret-mode two-kernel path; the engine
  picks the route from the shape and KTPU_MEGAKERNEL.
- The CLI gives the reference CLI's counters and refuses what it does not
  run.

Tolerance: compare_states (every non-metric leaf exactly equal, float32
metric accumulators to rtol 1e-6); counters exactly equal; the scalar
oracle's duration stats to the reference test's rel 1e-5 / 1e-4 (float32
batched sums against float64 scalar sums).
"""

import inspect
import json
import logging

import numpy as np
import pytest
import torch

from test_torch_reference import (
    BENCH_CONFIG,
    POISSON,
    REPO,
    TraceSpec,
    build_port_engine,
    jax_kernels,
    jax_state_to_numpy,
)

import jax
import kubernetriks_tpu.cli as jax_cli
from kubernetriks_tpu.batched.engine import build_batched_from_traces as jax_build
from kubernetriks_tpu.batched.trace_compile import compile_cluster_trace as jax_compile
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.sim.callbacks import RunUntilAllPodsAreFinishedCallbacks
from kubernetriks_tpu.sim.simulator import KubernetriksSimulation
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu.trace import synthetic_alibaba as jax_synth
from kubernetriks_tpu.trace.alibaba import (
    AlibabaClusterTraceV2017 as JaxAlibabaCluster,
    AlibabaWorkloadTraceV2017 as JaxAlibabaWorkload,
)

from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.batched.engine import choose_cycle_route
from kubernetriks_tpu_torch.batched.state import compare_states, flatten
from kubernetriks_tpu_torch.batched.trace_compile import compile_cluster_trace as port_compile
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.trace import synthetic_alibaba as port_synth
from kubernetriks_tpu_torch.trace.alibaba import (
    AlibabaClusterTraceV2017 as PortAlibabaCluster,
    AlibabaWorkloadTraceV2017 as PortAlibabaWorkload,
)

CA_YAML = """
cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: {max_nodes}
  node_groups:
  - node_template:
      metadata:
        name: {node_name}
      status:
        capacity:
          cpu: 64000
          ram: 94489280512
"""


def alibaba_yaml(paths, extra: str = "") -> str:
    machines, tasks, instances = paths
    return DEFAULT_TEST_CONFIG_YAML + f"""
trace_config:
  alibaba_cluster_trace_v2017:
    machine_events_trace_path: {machines}
    batch_task_trace_path: {tasks}
    batch_instance_trace_path: {instances}
""" + extra


def write_trace(tmp_path, synth, **kwargs):
    return synth.write_synthetic_trace_dir(str(tmp_path), **kwargs)


def jax_events(paths):
    machines, tasks, instances = paths
    return (
        JaxAlibabaCluster.from_file(machines).convert_to_simulator_events(),
        JaxAlibabaWorkload.from_files(instances, tasks).convert_to_simulator_events(),
    )


def jax_replay(yaml, paths, n_clusters=1, **kwargs):
    """The reference engine on the replay's events, as its CLI builds it
    (K=256) on the object path; XLA unless kwargs say otherwise."""
    kwargs.setdefault("use_pallas", False)
    return jax_build(JaxConfig.from_yaml(yaml), *jax_events(paths), n_clusters=n_clusters,
                     max_pods_per_cycle=256, **kwargs)


REFERENCE_SIZE = dict(n_machines=100, n_tasks=700, horizon=4000.0, seed=7)


# --- the trace ------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [dict(REFERENCE_SIZE), dict(n_machines=40, n_tasks=90, horizon=2500.0, error_fraction=0.3, seed=11)],
)
def test_synthetic_csvs_are_byte_identical(tmp_path, kwargs):
    mine = write_trace(tmp_path / "port", port_synth, **kwargs)
    theirs = write_trace(tmp_path / "jax", jax_synth, **kwargs)
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
    # The contended generator's arguments too.
    for synth, d in ((port_synth, tmp_path / "port"), (jax_synth, tmp_path / "jax")):
        synth.write_batch_workload(
            str(d / "t.csv"), str(d / "i.csv"), n_tasks=40, horizon=3000.0,
            cpu_santicores_range=(1600, 6400), heavy_fraction=0.0, seed=12,
        )
    for name in ("t.csv", "i.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("error_fraction", [0.0, 0.1])
def test_alibaba_compile_matches_reference(tmp_path, error_fraction):
    paths = write_trace(tmp_path, port_synth, n_machines=60, n_tasks=300, horizon=3000.0,
                        error_fraction=error_fraction, seed=5)
    machines, tasks, instances = paths
    yaml = alibaba_yaml(paths)
    mine = port_compile(
        PortAlibabaCluster.from_file(machines).convert_to_simulator_events(),
        PortAlibabaWorkload.from_files(instances, tasks).convert_to_simulator_events(),
        PortConfig.from_yaml(yaml),
    )
    theirs = jax_compile(*jax_events(paths), JaxConfig.from_yaml(yaml))
    for name in ("ev_time", "ev_kind", "ev_slot", "node_cap_cpu", "node_cap_ram",
                 "pod_req_cpu", "pod_req_ram", "pod_duration"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.node_names == theirs.node_names and mine.pod_names == theirs.pod_names
    assert (mine.ev_kind == 2).any() == (error_fraction > 0)


# --- the replay at the reference's test size ------------------------------------


@pytest.fixture(scope="module")
def reference_replay(tmp_path_factory):
    """The reference test's trace, replayed by the port (CLI functions,
    C=1, CPU) to completion, and by the JAX XLA path with its states at
    t = 1000 and 2500 s and at completion."""
    paths = write_trace(tmp_path_factory.mktemp("replay"), port_synth, **REFERENCE_SIZE)
    yaml = alibaba_yaml(paths)
    port = port_cli.build_batched_simulation(PortConfig.from_yaml(yaml), 1, device="cpu")
    jx = jax_replay(yaml, paths)
    states = {}
    for t in (1000.0, 2500.0):
        port.step_until_time(t)
        jx.step_until_time(t)
        states[t] = (jax_state_to_numpy(jx.state), state_to_numpy(port.state))
    port.run_to_completion()
    jx.run_to_completion()
    states["end"] = (jax_state_to_numpy(jx.state), state_to_numpy(port.state))
    return {"paths": paths, "yaml": yaml, "port": port, "jax": jx, "states": states}


def test_replay_matches_xla_path(reference_replay):
    port, jx = reference_replay["port"], reference_replay["jax"]
    assert port.cycle_route == "sorted" and port.max_pods_per_cycle == 256
    for when, (want, got) in reference_replay["states"].items():
        assert compare_states(want, got) == [], when
    assert port.next_window_idx == jx.next_window_idx
    assert port.metrics_summary()["counters"] == jx.metrics_summary()["counters"]
    # The run ends on a completion poll: one read-back per chunk past the
    # last event.
    assert 1 <= port.host_syncs <= 3


def test_replay_matches_scalar_oracle(reference_replay):
    """Terminal counters and duration stats against the scalar oracle
    (the reference's test_alibaba_replay_batched_matches_scalar)."""
    machines, tasks, instances = reference_replay["paths"]
    scalar = KubernetriksSimulation(JaxConfig.from_yaml(reference_replay["yaml"]))
    scalar.initialize(
        JaxAlibabaCluster.from_file(machines), JaxAlibabaWorkload.from_files(instances, tasks)
    )
    scalar.run_with_callbacks(RunUntilAllPodsAreFinishedCallbacks())
    sm = scalar.metrics_collector.accumulated_metrics
    bm = reference_replay["port"].metrics_summary()
    assert sm.pods_succeeded > 500
    assert bm["counters"]["pods_succeeded"] == sm.pods_succeeded
    assert bm["counters"]["terminated_pods"] == sm.internal.terminated_pods
    assert bm["counters"]["processed_nodes"] == 100
    got = bm["timings"]["pod_duration"]
    assert got["min"] == pytest.approx(sm.pod_duration_stats.min(), rel=1e-5)
    assert got["max"] == pytest.approx(sm.pod_duration_stats.max(), rel=1e-5)
    assert got["mean"] == pytest.approx(sm.pod_duration_stats.mean(), rel=1e-4)


def test_replay_with_machine_failures_matches_xla_path(tmp_path):
    """10 % of the machines fail mid-run: their pods reschedule through
    the name-ranked queue order."""
    paths = write_trace(tmp_path, port_synth, n_machines=40, n_tasks=300, horizon=3000.0,
                        error_fraction=0.1, seed=9)
    yaml = alibaba_yaml(paths)
    port = port_cli.build_batched_simulation(PortConfig.from_yaml(yaml), 1, device="cpu")
    jx = jax_replay(yaml, paths)
    port.step_until_time(1500.0)
    jx.step_until_time(1500.0)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    port.run_to_completion()
    jx.run_to_completion()
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    # Some pod was placed twice: rescheduled off a failed machine.
    counters = port.metrics_summary()["counters"]
    assert counters["scheduling_decisions"] > counters["pods_succeeded"] == port.n_real_pods


def test_replay_matches_interpret_kernel_path(tmp_path, monkeypatch):
    """A smaller cut against the reference's sorted kernel route: the
    queue sort and `fused_schedule_cycle` in interpret mode (the reference
    takes that route below 128 clusters)."""
    paths = write_trace(tmp_path, port_synth, n_machines=20, n_tasks=80, horizon=1200.0,
                        error_fraction=0.1, seed=7)
    yaml = alibaba_yaml(paths)
    calls = [0]
    real = jax_kernels.fused_schedule_cycle

    def counting(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_kernels, "fused_schedule_cycle", counting)
    jax.clear_caches()  # a cached window program would skip the wrapper
    jx = jax_replay(yaml, paths, use_pallas=True, pallas_interpret=True)
    assert jx.use_pallas and not jx.use_pallas_select
    jx.step_until_time(1500.0)
    assert calls[0] >= 1
    port = port_cli.build_batched_simulation(PortConfig.from_yaml(yaml), 1, device="cpu")
    port.step_until_time(1500.0)
    got = state_to_numpy(port.state)
    assert compare_states(jax_state_to_numpy(jx.state), got) == []
    assert int(got[".metrics.scheduling_decisions"].sum()) > 0


def test_contended_ca_replay_matches_reference(tmp_path):
    """The reference's contended CA replay (6 machines, 150 tasks of 16-64
    cores, 30 % machine failures, CA up to 64 nodes): scale-ups,
    scale-downs and reschedules, to completion at C=2 with 4 reserved CA
    slots per node of the cap."""
    machines, tasks, instances = (str(tmp_path / n) for n in ("m.csv", "t.csv", "i.csv"))
    port_synth.write_machine_events(machines, n_machines=6, error_fraction=0.3, horizon=3000.0, seed=11)
    port_synth.write_batch_workload(tasks, instances, n_tasks=150, horizon=3000.0,
                                    cpu_santicores_range=(1600, 6400), heavy_fraction=0.0, seed=12)
    paths = (machines, tasks, instances)
    yaml = alibaba_yaml(paths, CA_YAML.format(max_nodes=64, node_name="alibaba_ca_node"))
    port = port_cli.build_batched_simulation(PortConfig.from_yaml(yaml), 2, device="cpu", ca_slot_multiplier=4)
    assert port.autoscale_statics.ca_slots.shape[1] == 4 * 64
    port.run_to_completion(max_time=1e6)
    jx = jax_replay(yaml, paths, n_clusters=2, ca_slot_multiplier=4)
    jx.run_to_completion(max_time=1e6)
    assert port.next_window_idx == jx.next_window_idx
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    counters = port.metrics_summary()["counters"]
    assert counters == jx.metrics_summary()["counters"]
    assert counters["total_scaled_up_nodes"] > 0 and counters["total_scaled_down_nodes"] > 0
    assert counters["pods_succeeded"] == 2 * port.n_real_pods


# --- the cycle routes ------------------------------------------------------------


DENSE = TraceSpec(n_nodes=4, poisson=dict(POISSON, rate_per_second=0.5, horizon=60.0))


def test_cycle_routes_agree_at_dense_batch(monkeypatch):
    """At C=128 the engine takes the megakernel; the two-kernel and sorted
    routes, forced after the build, end in the same state, which also
    equals the reference's interpret-mode two-kernel path."""
    states = {}
    for route in ("megakernel", "two_kernel", "sorted"):
        port = build_port_engine(BENCH_CONFIG, DENSE, 128, 8)
        if route == "megakernel":
            assert port.cycle_route == "megakernel"
        port.cycle_route = route
        port.step_until_time(100.0)
        # The card's kernels take contiguous operands only.
        assert all(leaf.is_contiguous() for leaf in flatten(port.state).values()), route
        states[route] = state_to_numpy(port.state)
    assert int(states["sorted"][".metrics.scheduling_decisions"].sum()) > 0
    assert compare_states(states["megakernel"], states["two_kernel"]) == []
    assert compare_states(states["megakernel"], states["sorted"]) == []

    calls = {"fused_select_schedule_cycle": 0, "fused_commit_scatter": 0}
    for name in calls:
        real = getattr(jax_kernels, name)

        def counting(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(jax_kernels, name, counting)
    jax.clear_caches()
    jx = jax_build(
        JaxConfig.from_yaml(BENCH_CONFIG), *DENSE.events("jax"), n_clusters=128,
        max_pods_per_cycle=8, use_pallas=True, pallas_interpret=True,
    )
    jx.use_pallas_select = True
    jx.use_megakernel = False
    jx.step_until_time(100.0)
    assert all(v >= 1 for v in calls.values()), calls
    assert compare_states(jax_state_to_numpy(jx.state), states["two_kernel"]) == []


def test_cycle_route_choice(monkeypatch):
    small = build_port_engine(BENCH_CONFIG, DENSE, 2, 8)
    assert small.cycle_route == "sorted"
    assert build_port_engine(BENCH_CONFIG, DENSE, 128, 8).cycle_route == "megakernel"
    monkeypatch.setenv("KTPU_MEGAKERNEL", "0")
    assert build_port_engine(BENCH_CONFIG, DENSE, 128, 8).cycle_route == "two_kernel"
    monkeypatch.delenv("KTPU_MEGAKERNEL")
    # The dense kernels' shared memory is fixed whatever the shape, so the
    # cluster count and the flag alone decide: a P past the old selection
    # kernel's limit (20 480 pod slots at N = 8) runs dense too.
    assert list(inspect.signature(choose_cycle_route).parameters) == ["n_clusters", "megakernel"]
    assert choose_cycle_route(128) == "megakernel"
    assert choose_cycle_route(128, megakernel=False) == "two_kernel"
    assert choose_cycle_route(127) == "sorted"
    assert choose_cycle_route(127, megakernel=False) == "sorted"


# --- the CLI ----------------------------------------------------------------------


@pytest.fixture
def restore_logging():
    """The CLIs configure the root logger (the JAX one with force=True,
    on the captured stderr); put it back for the tests that follow."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def _generic_config(tmp_path) -> str:
    path = tmp_path / "config.yaml"
    path.write_text(DEFAULT_TEST_CONFIG_YAML + f"""
trace_config:
  generic_trace:
    workload_trace_path: {REPO}/kubernetriks_tpu/data/generic_workload_trace_example.yaml
    cluster_trace_path: {REPO}/kubernetriks_tpu/data/generic_cluster_trace_example.yaml
""")
    return str(path)


@pytest.mark.parametrize("clusters", [1, 3])
def test_cli_matches_reference_cli(tmp_path, capsys, restore_logging, clusters):
    config = _generic_config(tmp_path)
    assert jax_cli.main(["--config-file", config, "--backend", "batched", "--clusters", str(clusters)]) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_cli.main(["--config-file", config, "--device", "cpu", "--clusters", str(clusters)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["counters"] == want["counters"]
    assert got["counters"]["pods_succeeded"] == 2 * clusters
    assert port_cli.main(["--config-file", config, "--device", "cpu", "--report", "table"]) == 0
    assert "| Pods succeeded" in capsys.readouterr().out


@pytest.mark.parametrize("profile", ["best_fit", "balanced_packing"])
def test_cli_profile_matches_reference_cli(tmp_path, capsys, restore_logging, profile):
    """--profile NAME supersedes the config's scheduler_profile block, as
    in the reference CLI, and the counters equal its batched run's."""
    config = _generic_config(tmp_path)
    assert jax_cli.main(["--config-file", config, "--backend", "batched", "--clusters", "2",
                         "--profile", profile]) == 0
    want = json.loads(capsys.readouterr().out)
    assert port_cli.main(["--config-file", config, "--device", "cpu", "--clusters", "2",
                          "--profile", profile]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["counters"] == want["counters"]
    assert got["counters"]["pods_succeeded"] == 4
    with pytest.raises(ValueError, match="unknown named scheduler profile"):
        port_cli.main(["--config-file", config, "--device", "cpu", "--profile", "best-fit"])


@pytest.mark.parametrize("option", [
    ["--device", "cpu"], ["--clusters", "2"], ["--pod-window", "8"], ["--max-pods-per-cycle", "4"],
    ["--metrics-export", "stem"],
])
def test_cli_refuses_unported_options(tmp_path, option):
    """The batched-only options given with --backend scalar raise, naming
    the option; none is silently ignored."""
    with pytest.raises(SystemExit, match=option[0]):
        port_cli.main(["--config-file", _generic_config(tmp_path), "--backend", "scalar", *option])


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch, restore_logging):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device|CUDA"):
        port_cli.main(["--config-file", _generic_config(tmp_path)])
