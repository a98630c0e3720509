"""Fast-forward in the port (the engine's `fast_forward=`, step's
next_window_span and catch_up_bookkeeping, the executor's skipping loop)
against the JAX package's `fast_forward=True` dispatch, on the CPU.

Every case of the reference's tests/test_fast_forward.py but the mesh and
gauge ones: a sparse trace, a sparse trace with the HPA and the CA, parked
pods and the flush cadence, the conditional move, the sliding pod window
and a dense trace. In each the port fast-forwarded ends in the state of
the JAX engine fast-forwarded on its XLA path (compare_states: every
non-metric leaf exactly equal, float32 `.metrics.` accumulators to rtol
1e-6, atol 0) at the same next window, and in the state of the port
stepping every window; and the port's default picks what the
reference's picks on the trace. With CA slot reclaim on (the wave churn
of tests/test_reclaim.py), a skipped window's compaction waits for the
next executed one, so the port equals the reference only where both run
the same windows: reclaim on both sides, both fast-forwarded, whole and
through the sliding pod window (whose spans both cut along the same
ladder). The executor's pieces on a stubbed capture (test_torch_executor)
replay what the uncaptured run does, with one host read an executed
window.
"""

import pytest

from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy

from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML  # noqa: E402
from kubernetriks_tpu.trace.generator import (  # noqa: E402
    PoissonWorkloadTrace as JaxPoisson,
    UniformClusterTrace as JaxUniform,
)
from kubernetriks_tpu.trace.generic import (  # noqa: E402
    GenericClusterTrace as JaxGenericCluster,
    GenericWorkloadTrace as JaxGenericWorkload,
)
from test_hpa_ca_combined import CLUSTER_TRACE as HPA_CA_CLUSTER  # noqa: E402
from test_hpa_ca_combined import CONFIG_SUFFIX as HPA_CA_SUFFIX  # noqa: E402
from test_hpa_ca_combined import WORKLOAD_TRACE as HPA_CA_WORKLOAD  # noqa: E402
from test_reclaim import CLUSTER_TRACE as RECLAIM_CLUSTER, RECLAIM_CA_SUFFIX, wave_workload  # noqa: E402
from test_torch_executor import assert_bitwise_equal, stub_graphs  # noqa: E402

from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
from kubernetriks_tpu_torch.trace.generic import GenericClusterTrace, GenericWorkloadTrace

INTERVAL_CONFIG = "sim_name: ff\nseed: 1\nscheduling_cycle_interval: 10.0\n"
PARKED_CLUSTER = """
events:
- timestamp: 2.0
  event_type:
    !CreateNode
      node:
        metadata: {name: tiny}
        status: {capacity: {cpu: 2000, ram: 4294967296}}
"""
PARKED_WORKLOAD = """
events:
- timestamp: 13.0
  event_type:
    !CreatePod
      pod:
        metadata: {name: too_big}
        spec:
          resources:
            requests: {cpu: 64000, ram: 4294967296}
            limits: {cpu: 64000, ram: 4294967296}
          running_duration: 50.0
- timestamp: 700.0
  event_type:
    !CreatePod
      pod:
        metadata: {name: fits}
        spec:
          resources:
            requests: {cpu: 1000, ram: 1073741824}
            limits: {cpu: 1000, ram: 1073741824}
          running_duration: 40.0
"""


class SparseSpec:
    """The reference test's traces, rendered for either package: 6
    uniform nodes (16 000 mCPU, 32 GiB) and Poisson pods (3 000 mCPU,
    6 GiB, 15-120 s), or the HPA/CA trace with Poisson pods beside its
    group, or a pair of generic YAML documents."""

    def __init__(self, rate=0.02, horizon=3000.0, seed=5, kind="uniform", cluster_yaml=None, workload_yaml=None):
        self.rate, self.horizon, self.seed, self.kind = rate, horizon, seed, kind
        self.cluster_yaml, self.workload_yaml = cluster_yaml, workload_yaml

    def events(self, side: str):
        jax = side == "jax"
        cluster_cls = JaxGenericCluster if jax else GenericClusterTrace
        workload_cls = JaxGenericWorkload if jax else GenericWorkloadTrace
        poisson = JaxPoisson if jax else PoissonWorkloadTrace
        if self.kind == "yaml":
            return (
                cluster_cls.from_yaml(self.cluster_yaml).convert_to_simulator_events(),
                workload_cls.from_yaml(self.workload_yaml).convert_to_simulator_events(),
            )
        if self.kind == "autoscaled":
            plain = poisson(
                rate_per_second=self.rate, horizon=self.horizon, seed=self.seed, cpu=1000, ram=2 * 1024**3,
                duration_range=(20.0, 60.0),
            ).convert_to_simulator_events()
            group = workload_cls.from_yaml(HPA_CA_WORKLOAD).convert_to_simulator_events()
            workload = sorted(plain + group, key=lambda e: e[0])
            return cluster_cls.from_yaml(HPA_CA_CLUSTER).convert_to_simulator_events(), workload
        uniform = JaxUniform if jax else UniformClusterTrace
        return (
            uniform(6, cpu=16000, ram=32 * 1024**3).convert_to_simulator_events(),
            poisson(
                rate_per_second=self.rate, horizon=self.horizon, seed=self.seed, cpu=3000, ram=6 * 1024**3,
                duration_range=(15.0, 120.0),
            ).convert_to_simulator_events(),
        )


def run_case(config_yaml, spec, until, n_clusters=3, k=8, expect_skips=True, **kwargs):
    """The JAX engine fast-forwarded (XLA path), the port fast-forwarded and
    the port stepping every window, each to `until`; both defaults built.
    Returns (jax, fast port, plain port)."""
    jx = build_jax_engine(config_yaml, spec, n_clusters, k, "xla", fast_forward=True, **kwargs)
    jx.step_until_time(until)
    fast = build_port_engine(config_yaml, spec, n_clusters, k, fast_forward=True, **kwargs)
    fast.step_until_time(until)
    plain = build_port_engine(config_yaml, spec, n_clusters, k, fast_forward=False, **kwargs)
    plain.step_until_time(until)
    assert fast.fast_forward and not plain.fast_forward
    assert fast.next_window_idx == plain.next_window_idx == jx.next_window_idx
    got = state_to_numpy(fast.state)
    assert compare_states(jax_state_to_numpy(jx.state), got) == []
    stats = fast.dispatch_stats
    assert stats["executed_windows"] + stats["skipped_windows"] == fast.windows_run == plain.windows_run
    assert fast.host_syncs == stats["executed_windows"] + stats["slides"] + stats["grows"]
    if expect_skips:
        assert stats["skipped_windows"] > 0
    # The default: the reference's density rule on the same trace.
    want = build_jax_engine(config_yaml, spec, n_clusters, k, "xla", **kwargs).fast_forward
    assert build_port_engine(config_yaml, spec, n_clusters, k, **kwargs).fast_forward == want
    return jx, fast, plain


def assert_fast_equals_plain(fast, plain):
    assert compare_states(state_to_numpy(plain.state), state_to_numpy(fast.state)) == []


def test_sparse_trace_matches_reference():
    jx, fast, plain = run_case(INTERVAL_CONFIG, SparseSpec(), 4000.0)
    assert_fast_equals_plain(fast, plain)
    assert fast.fast_forward is True and jx.fast_forward is True
    assert fast.metrics_summary()["counters"]["pods_succeeded"] > 0


def test_sparse_trace_with_autoscalers_matches_reference():
    """The HPA and the CA on a sparse mixed trace: the catch-up advances
    the HPA tick and the CA cycle as stepping does."""
    spec = SparseSpec(rate=0.03, horizon=1500.0, seed=11, kind="autoscaled")
    jx, fast, plain = run_case(DEFAULT_TEST_CONFIG_YAML + HPA_CA_SUFFIX, spec, 2000.0, reclaim=False)
    assert_fast_equals_plain(fast, plain)
    counters = fast.metrics_summary()["counters"]
    assert counters["total_scaled_up_pods"] > 0 and counters["total_scaled_up_nodes"] > 0


def test_parked_pods_and_flush_cadence_match_reference():
    """A pod that never fits parks for good: the flush and stale windows
    fire at the same indices in both modes."""
    spec = SparseSpec(kind="yaml", cluster_yaml=PARKED_CLUSTER, workload_yaml=PARKED_WORKLOAD)
    _, fast, plain = run_case(DEFAULT_TEST_CONFIG_YAML, spec, 1500.0)
    assert_fast_equals_plain(fast, plain)
    assert (state_to_numpy(fast.state)[".pods.phase"] == 2).any()


def test_conditional_move_matches_reference():
    config = DEFAULT_TEST_CONFIG_YAML + "enable_unscheduled_pods_conditional_move: true\n"
    _, fast, plain = run_case(config, SparseSpec(rate=0.05, horizon=1500.0, seed=23), 2500.0)
    assert_fast_equals_plain(fast, plain)


def test_sliding_pod_window_matches_reference():
    _, fast, plain = run_case(INTERVAL_CONFIG, SparseSpec(rate=0.05, horizon=4000.0, seed=31), 5000.0, pod_window=24)
    assert_fast_equals_plain(fast, plain)
    assert fast.dispatch_stats["slides"] > 0


def test_dense_trace_matches_reference():
    """Every window interesting: the skip degenerates to stepping."""
    _, fast, plain = run_case(
        INTERVAL_CONFIG, SparseSpec(rate=1.5, horizon=400.0, seed=41), 700.0, expect_skips=False
    )
    assert_fast_equals_plain(fast, plain)
    assert fast.dispatch_stats["executed_windows"] >= 40


@pytest.mark.parametrize("pod_window", [None, 8])
def test_reclaim_fast_forward_matches_reference(pod_window):
    """CA slot reclaim on both sides, both fast-forwarded, on the wave
    churn past its 2-slot reserve: equal states, the allocation, cursor
    and reclaimed leaves included; through pod_window=8 the spans are cut
    along the reference's ladder on both sides."""
    spec = SparseSpec(kind="yaml", cluster_yaml=RECLAIM_CLUSTER, workload_yaml=wave_workload(10))
    kwargs = {"reclaim": True, "ca_slot_multiplier": 1}
    if pod_window:
        kwargs["pod_window"] = pod_window
    jx, fast, _ = run_case(DEFAULT_TEST_CONFIG_YAML + RECLAIM_CA_SUFFIX, spec, 10.0 + 10 * 200.0, 1, None, **kwargs)
    assert fast.reclaim and jx.reclaim
    assert int(fast.ca_slots_reclaimed().sum()) > 0


def test_stubbed_graph_run_matches_uncaptured():
    """On the stubbed capture backend the next and catch-up pieces replay
    what the uncaptured run does, bit for bit: the same windows executed
    and skipped, one host read an executed window."""
    spec = SparseSpec(rate=0.03, horizon=1500.0, seed=11, kind="autoscaled")

    def build():
        return build_port_engine(DEFAULT_TEST_CONFIG_YAML + HPA_CA_SUFFIX, spec, 2, 8, fast_forward=True,
                                 reclaim=False)

    plain = build()
    plain.step_until_time(2000.0)
    sim = stub_graphs(build())
    captured = sim.precompile_pieces()
    assert ("next",) in sim._executor.graphs and ("catch_up",) in sim._executor.graphs
    sim.step_until_time(2000.0)
    stats = sim.dispatch_stats
    assert stats["captures"] == captured
    assert stats["graph_windows"] == stats["executed_windows"] == plain.dispatch_stats["executed_windows"]
    assert stats["skipped_windows"] == plain.dispatch_stats["skipped_windows"] > 0
    assert sim.host_syncs == plain.host_syncs == stats["executed_windows"]
    assert_bitwise_equal(sim.state, plain.state)
