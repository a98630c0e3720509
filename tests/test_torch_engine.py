"""The port's main path as a whole against the JAX reference, on the CPU.

Parity policy: compare_states (every non-metric leaf exactly equal,
float32 `.metrics.` accumulators to rtol 1e-6, atol 0), against both the
reference's XLA path and its interpret-mode megakernel path:
  (a) C=4, N=8, K=8, a 100 s Poisson trace stepped to t=150 s;
  (b) a seeded generic-YAML trace with a mid-run RemoveNode (reschedules
      through the name-ranked queue order), also with conditional move;
  (c) a mid-run handoff: the reference's state at t=60 carried over with
      convert.state_from_numpy, both engines stepped to t=300;
  (d) metrics_summary: same keys, same counters;
  (e) the config blocks all parse, and the build refuses a profile the
      device path cannot run.
The card-against-CPU run is in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import DELAYS, churn_yaml
from test_torch_reference import (
    BENCH_CONFIG,
    POISSON,
    TraceSpec,
    build_jax_engine,
    build_port_engine,
    jax_state_to_numpy,
)

from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
from kubernetriks_tpu_torch.batched.pipeline import UnsupportedProfileError
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

MAIN = TraceSpec(n_nodes=8, poisson=POISSON)


def churn_trace(seed: int) -> TraceSpec:
    cluster_yaml, workload_yaml = churn_yaml(seed)
    return TraceSpec(cluster_yaml=cluster_yaml, workload_yaml=workload_yaml)


@pytest.fixture(scope="module")
def main_runs():
    """Reference XLA run of the main-path trace, sampled at t=60, 150 and
    300, and the port's own run to t=150."""
    jx = build_jax_engine(BENCH_CONFIG, MAIN, 4, 8, "xla")
    out = {}
    for t in (60.0, 150.0, 300.0):
        jx.step_until_time(t)
        out[t] = jax_state_to_numpy(jx.state)
        out[f"next{t}"] = jx.next_window_idx
        if t == 150.0:
            out["jax_summary"] = jx.metrics_summary()
    port = build_port_engine(BENCH_CONFIG, MAIN, 4, 8)
    port.step_until_time(150.0)
    out["port"] = port
    return out


def test_main_path_matches_xla_and_megakernel(main_runs, monkeypatch):
    port = main_runs["port"]
    got = state_to_numpy(port.state)
    assert compare_states(main_runs[150.0], got) == []
    mk = build_jax_engine(BENCH_CONFIG, MAIN, 4, 8, "megakernel", monkeypatch)
    mk.step_until_time(150.0)
    assert mk.megakernel_calls[0] >= 1
    assert compare_states(jax_state_to_numpy(mk.state), got) == []
    want = int(main_runs[150.0][".metrics.scheduling_decisions"].sum())
    assert want > 0
    assert port.metrics_summary()["counters"]["scheduling_decisions"] == want
    # The CPU run decides everything on the host tables: no device reads.
    assert port.host_syncs == 0


def test_forced_megakernel_route_matches_reference(main_runs):
    """Below 128 clusters the engine takes the sorted route; forced after
    the build, the megakernel route (its plain version on the CPU) ends in
    the same state as the reference's XLA path."""
    port = build_port_engine(BENCH_CONFIG, MAIN, 4, 8)
    assert port.cycle_route == "sorted"
    port.cycle_route = "megakernel"
    port.step_until_time(150.0)
    assert compare_states(main_runs[150.0], state_to_numpy(port.state)) == []


@pytest.mark.parametrize(
    "seed,conditional_move", [(3, False), (17, False), (5, True)]
)
def test_node_removal_trace_matches_reference(seed, conditional_move, monkeypatch):
    config = DELAYS + (
        "enable_unscheduled_pods_conditional_move: true\n" if conditional_move else ""
    )
    spec = churn_trace(seed)
    port = build_port_engine(config, spec, 4, 8)
    port.step_until_time(600.0)
    got = state_to_numpy(port.state)
    jx = build_jax_engine(config, spec, 4, 8, "xla")
    jx.step_until_time(600.0)
    assert compare_states(jax_state_to_numpy(jx.state), got) == []
    if not conditional_move:
        mk = build_jax_engine(config, spec, 4, 8, "megakernel", monkeypatch)
        mk.step_until_time(600.0)
        assert compare_states(jax_state_to_numpy(mk.state), got) == []
    counters = port.metrics_summary()["counters"]
    assert counters["scheduling_decisions"] > 0
    # The trace exercises the removal: some pod went back to the queue or
    # was parked at least once.
    assert (got[".pods.attempts"] > 1).any() or (got[".pods.phase"] == 2).any()


def test_small_event_chunks_match_reference():
    """Three events per chunk: every window with more due events runs
    several chunks (the t=0 burst of 8 node creations takes three), whose
    count the port's engine derives on the host from the slab."""
    jx = build_jax_engine(BENCH_CONFIG, MAIN, 4, 8, "xla", max_events_per_window=3)
    jx.step_until_time(120.0)
    port = build_port_engine(BENCH_CONFIG, MAIN, 4, 8, max_events_per_window=3)
    port.step_until_time(120.0)
    assert port.max_events_per_window == 3
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []


def test_mid_run_handoff_from_reference(main_runs):
    port = build_port_engine(BENCH_CONFIG, MAIN, 4, 8)
    port.install_state(state_from_numpy(main_runs[60.0], "cpu"), main_runs["next60.0"])
    port.step_until_time(300.0)
    assert port.next_window_idx == main_runs["next300.0"]
    assert compare_states(main_runs[300.0], state_to_numpy(port.state)) == []


def test_metrics_summary_matches_reference(main_runs):
    want = main_runs["jax_summary"]
    got = main_runs["port"].metrics_summary()
    assert want.keys() == got.keys()
    assert want["counters"] == got["counters"]
    assert want["timings"].keys() == got["timings"].keys()
    for name, est in want["timings"].items():
        mine = got["timings"][name]
        assert est.keys() == mine.keys()
        for stat in ("min", "max", "mean"):
            assert np.isclose(est[stat], mine[stat], rtol=1e-6, atol=0.0), (name, stat)
        # variance = E[x^2] - mean^2 cancels: each term carries the
        # accumulators' rtol 1e-6, so the difference is bounded by it.
        ex2 = est["variance"] + est["mean"] ** 2
        bound = 2e-6 * (ex2 + est["mean"] ** 2)
        assert abs(est["variance"] - mine["variance"]) <= bound, name


def _tiny_events():
    return (
        UniformClusterTrace(2).convert_to_simulator_events(),
        PoissonWorkloadTrace(1.0, 30.0, seed=1).convert_to_simulator_events(),
    )


def test_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster, workload = _tiny_events()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_batched_from_traces(SimulationConfig(), cluster, workload, n_clusters=1)


def test_state_from_numpy_without_device_needs_cuda(main_runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(main_runs[60.0])


def test_install_state_on_another_device_raises(main_runs):
    """A state on another device than the engine's is refused at install,
    not left to fail later in a kernel wrapper (the meta device stands in
    for the card here; test_torch_cuda.py installs a CPU state into a CUDA
    engine)."""
    port = build_port_engine(BENCH_CONFIG, MAIN, 4, 8)
    with pytest.raises(ValueError, match="install_state: leaf .* is on meta"):
        port.install_state(state_from_numpy(main_runs[60.0], "meta"), main_runs["next60.0"])


# A burst of ~600 pods in the first 15 s: the first cycle picks ~400 of
# them (more than 256, so the cycle's prefix sums recurse), and the cycles
# after it park the pods past the nodes' capacity (512 pods of 1 000 mCPU
# on 8 nodes of 64 000).
BURST = TraceSpec(
    n_nodes=8,
    poisson=dict(POISSON, rate_per_second=40.0, horizon=15.0, cpu=1000, ram=1024**3),
)


@pytest.fixture(scope="module")
def burst_reference():
    """The reference's XLA run of BURST at its default cycle size (every
    pod slot), to t=40 s."""
    jx = build_jax_engine(BENCH_CONFIG, BURST, 2, None, "xla")
    jx.step_until_time(40.0)
    return jax_state_to_numpy(jx.state)


@pytest.mark.parametrize("route", ["sorted", "megakernel", "two_kernel"])
def test_default_cycle_size_above_256_matches_reference(burst_reference, route):
    """Without max_pods_per_cycle the cycle takes every pod slot (P > 256
    here), as in the reference; each route, forced after the build, ends
    in the reference's state."""
    port = build_port_engine(BENCH_CONFIG, BURST, 2, None)
    assert port.max_pods_per_cycle == port.n_pods > 256
    port.cycle_route = route
    port.step_until_time(10.0)
    assert port.metrics_summary()["counters"]["scheduling_decisions"] > 256
    port.step_until_time(40.0)
    assert compare_states(burst_reference, state_to_numpy(port.state)) == []


@pytest.mark.parametrize(
    "block",
    [
        "horizontal_pod_autoscaler:\n  enabled: true\n",
        "cluster_autoscaler:\n  enabled: true\n  max_node_count: 4\n",
        "fault_injection:\n  enabled: true\n  node: {mttf: 900.0}\n",
    ],
)
def test_unported_config_blocks_raise(block):
    """No config block is refused any more: the two autoscaler blocks and
    the fault-injection block parse, and an enabled fault-injection block
    runs (its crash chains compiled into the trace at build)."""
    config = SimulationConfig.from_yaml(BENCH_CONFIG + block)
    name = block.split(":")[0]
    assert getattr(config, name).enabled
    if name == "fault_injection":
        assert config.fault_injection.node.mttf == 900.0
        config.fault_injection.horizon = 3000.0  # the tiny trace ends at 30 s
        cluster, workload = _tiny_events()
        sim = build_batched_from_traces(config, cluster, workload, n_clusters=2, device="cpu")
        assert sim.fault_params is not None and sim.fault_params.node_faults
        sim.step_until_time(3000.0)
        counters = sim.metrics_summary()["counters"]
        assert counters["node_crashes"] > 0 and counters["node_recoveries"] > 0


def test_unported_profile_and_pod_groups_raise():
    """A profile naming a plugin the device path cannot run raises at
    build; pod groups parse, and a group with a finite running duration
    (which the reference refuses too) raises at compile."""
    cluster, workload = _tiny_events()
    with pytest.raises(UnsupportedProfileError, match="NodeAffinity"):
        build_batched_from_traces(
            SimulationConfig(), cluster, workload, device="cpu",
            scheduler_profile={"filters": ["Fit"], "score": [{"name": "NodeAffinity"}]},
        )
    group = """events:
- timestamp: 1.0
  event_type:
    !CreatePodGroup
      pod_group:
        name: g
        initial_pod_count: 1
        max_pod_count: 2
        pod_template:
          spec: {running_duration: 30.0}
"""
    events = GenericWorkloadTrace.from_yaml(group).convert_to_simulator_events()
    assert events[0][1].pod_group.name == "g"
    with pytest.raises(ValueError, match="long-running"):
        build_batched_from_traces(SimulationConfig(), cluster, events, device="cpu")
