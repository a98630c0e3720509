"""The port's autoscaler path (HPA + cluster autoscaler) against the JAX
reference, on the CPU.

Parity policy, as in test_torch_engine.py: compare_states — every leaf
exactly equal, float32 `.metrics.` accumulators to rtol 1e-6, atol 0 —
against the reference's XLA path and, for the whole slice, its
interpret-mode kernel path (megakernel and both CA kernels):
  (a) the CA kernels' plain versions against the reference's Pallas
      kernels in interpret mode, exactly, on seeded inputs;
  (b) the composed scenario at a toy shape (4 nodes, C=2, K=8, to
      t=360 s): 142 decisions, 28/28 HPA pods, 6/2 CA nodes; and one
      cluster of it at the reference's own width to t=1200 s;
  (c) random HPA pod groups, and a non-default HPA scan interval;
  (d) a mid-run handoff of a reference state with a CA removal pending;
  (e) a CA removal of a node that still runs pods, in a window without a
      trace removal, compared at every 10 s step;
  (f) the config, trace and compile surface of pod and node groups.
The card's runs of the CA kernels are in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from test_torch_reference import (  # installs the F1 alias first
    JaxGenericCluster,
    JaxGenericWorkload,
    JaxPoisson,
    JaxUniform,
    build_jax_engine,
    build_port_engine,
    jax_state_to_numpy,
)

import kubernetriks_tpu.ops.autoscale_kernel as jax_ca_kernels  # noqa: E402
from kubernetriks_tpu.batched import trace_compile as jax_tc  # noqa: E402
from kubernetriks_tpu.config import SimulationConfig as JaxConfig  # noqa: E402

from chip_smoke import composed_config_yaml, composed_workload_yaml  # noqa: E402
from ca_inputs import ca_down_inputs, ca_up_inputs  # noqa: E402
from test_torch_cuda import t as _t  # noqa: E402

from kubernetriks_tpu_torch.batched import trace_compile as port_tc
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.ops import autoscale_kernel as port_ca_kernels
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
from kubernetriks_tpu_torch.trace.generic import GenericClusterTrace, GenericWorkloadTrace

DEFAULT_TEST_CONFIG_YAML = """
sim_name: "test_kubernetriks"
seed: 123
scheduling_cycle_interval: 10.0
as_to_ps_network_delay: 0.050
ps_to_sched_network_delay: 0.010
sched_to_as_network_delay: 0.020
as_to_node_network_delay: 0.150
as_to_ca_network_delay: 0.30
as_to_hpa_network_delay: 0.40
"""


class ComposedSpec:
    """The composed scenario (`bench.py:198` `_composed_inputs`): uniform
    nodes, Poisson plain pods at 16 000 mCPU / 32 GiB, one HPA pod group
    with a three-phase load curve, rendered as each package's events."""

    def __init__(self, n_nodes=4, rate=0.2, horizon=300.0, max_group_pods=16, burst=(90.0, 90.0, 120.0)):
        self.n_nodes = n_nodes
        self.rate = rate
        self.horizon = horizon
        self.group_yaml = composed_workload_yaml(max_group_pods, burst)
        self.config_yaml = composed_config_yaml(n_nodes)

    def events(self, side: str):
        uniform = JaxUniform if side == "jax" else UniformClusterTrace
        poisson = JaxPoisson if side == "jax" else PoissonWorkloadTrace
        generic = JaxGenericWorkload if side == "jax" else GenericWorkloadTrace
        plain = poisson(
            rate_per_second=self.rate, horizon=self.horizon, seed=3, cpu=16000,
            ram=32 * 1024**3, duration_range=(30.0, 120.0), name_prefix="plain",
        ).convert_to_simulator_events()
        group = generic.from_yaml(self.group_yaml).convert_to_simulator_events()
        return (
            uniform(self.n_nodes, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
            sorted(plain + group, key=lambda e: e[0]),
        )


class YamlSpec:
    """A (cluster, workload) pair of generic YAML documents."""

    def __init__(self, cluster_yaml: str, workload_yaml: str):
        self.cluster_yaml = cluster_yaml
        self.workload_yaml = workload_yaml

    def events(self, side: str):
        cluster = JaxGenericCluster if side == "jax" else GenericClusterTrace
        workload = JaxGenericWorkload if side == "jax" else GenericWorkloadTrace
        return (
            cluster.from_yaml(self.cluster_yaml).convert_to_simulator_events(),
            workload.from_yaml(self.workload_yaml).convert_to_simulator_events(),
        )


TOY = ComposedSpec()


def _jax(config_yaml, spec, C, K, path="xla", monkeypatch=None):
    return build_jax_engine(config_yaml, spec, C, K, path, monkeypatch, reclaim=False)


# --- (a) the CA kernels -------------------------------------------------------


@pytest.mark.parametrize("seed, edge", [
    (0, None), (1, None), (2, None), (3, "crossing"), (4, "target"),
], ids=["0", "1", "2", "crossing-3", "target-4"])
def test_ca_scale_down_plain_matches_pallas(seed, edge):
    """Exact: removed flags in name-order positions. "crossing": lane 0's
    first removal deducts onto its second candidate, which the threshold
    then refuses though its starting utilization is under it; "target":
    lane 0's second candidate re-places its pod onto the first, already
    removed (the walk keeps removed candidates alive as targets)."""
    args, K = ca_down_inputs(seed, edge=edge)
    want = np.asarray(jax_ca_kernels.fused_ca_scale_down(*args, k_sd=K, interpret=True))
    got = port_ca_kernels.fused_ca_scale_down(*(_t(a) for a in args), k_sd=K).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    if edge == "crossing":
        assert want[0, 0] and not want[0, 1]
    elif edge == "target":
        assert want[0, 0] and want[0, 1] and not want[0, 2:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ca_scale_up_plain_matches_pallas(seed):
    """Exact: planned slots, per-group opens and reserve starvation (lane
    4's reserve is consumed, so it starves)."""
    args, S = ca_up_inputs(seed)
    planned, gpl, starved = jax_ca_kernels.fused_ca_scale_up(*args, n_slots=S, interpret=True)
    got = port_ca_kernels.fused_ca_scale_up(*(_t(a) for a in args), n_slots=S)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(planned))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(gpl))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(starved)[:, 0])
    assert np.asarray(planned).any() and np.asarray(starved)[4, 0] > 0


# --- (b) the composed scenario -------------------------------------------------


@pytest.fixture(scope="module")
def toy_runs():
    """The reference's XLA run of the toy composed scenario, sampled at
    t=280 (a CA removal pending) and t=360, and the port's run to t=360."""
    jx = _jax(TOY.config_yaml, TOY, 2, 8)
    out = {}
    for t in (280.0, 360.0):
        jx.step_until_time(t)
        out[t] = jax_state_to_numpy(jx.state)
        out[f"next{t}"] = jx.next_window_idx
    out["jax_summary"] = jx.metrics_summary()
    port = build_port_engine(TOY.config_yaml, TOY, 2, 8)
    port.step_until_time(360.0)
    out["port"] = port
    return out


def test_composed_path_matches_xla_and_kernel_paths(toy_runs, monkeypatch):
    port = toy_runs["port"]
    got = state_to_numpy(port.state)
    assert compare_states(toy_runs[360.0], got) == []
    counters = port.metrics_summary()["counters"]
    assert counters == toy_runs["jax_summary"]["counters"]
    assert counters["scheduling_decisions"] == 142
    assert (counters["total_scaled_up_pods"], counters["total_scaled_down_pods"]) == (28, 28)
    assert (counters["total_scaled_up_nodes"], counters["total_scaled_down_nodes"]) == (6, 2)
    assert port.host_syncs == 0
    # The engine's host clock still equals the device's due times.
    auto = port.state.auto
    for mine, dev in ((port.clock.hpa_next, auto.hpa_next), (port.clock.col_next, auto.col_next),
                      (port.clock.ca_next, auto.ca_next)):
        assert torch.equal(mine.win, dev.win) and torch.equal(mine.off, dev.off)

    # The reference's kernel path: megakernel and both CA kernels, traced
    # in interpret mode (counted as they are traced).
    traced = {"up": 0, "down": 0}
    for key, name in (("up", "fused_ca_scale_up"), ("down", "fused_ca_scale_down")):
        real = getattr(jax_ca_kernels, name)

        def counting(*args, _real=real, _key=key, **kwargs):
            traced[_key] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(jax_ca_kernels, name, counting)
    mk = _jax(TOY.config_yaml, TOY, 2, 8, "megakernel", monkeypatch)
    mk.step_until_time(360.0)
    assert mk.megakernel_calls[0] >= 1 and traced["up"] >= 1 and traced["down"] >= 1
    assert compare_states(jax_state_to_numpy(mk.state), got) == []


def test_full_width_composed_cluster_matches_reference():
    """One cluster of the reference's composed line at its own width
    (32 nodes + 64 CA slots, 1 664 pod slots, K = 64) to t = 1200 s: equal
    to the XLA path; 1 561 decisions, 44/44 HPA pods, 8/8 CA nodes."""
    spec = ComposedSpec(n_nodes=32, rate=1.5, horizon=1000.0, max_group_pods=64, burst=(300.0, 300.0, 400.0))
    jx = _jax(spec.config_yaml, spec, 1, 64)
    jx.step_until_time(1200.0)
    port = build_port_engine(spec.config_yaml, spec, 1, 64)
    port.step_until_time(1200.0)
    assert (port.n_nodes, port.n_pods, port.hpa_seg) == (96, 1664, (1503, 1639))
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    c = port.metrics_summary()["counters"]
    assert (c["scheduling_decisions"], c["total_scaled_up_pods"], c["total_scaled_down_pods"]) == (1561, 44, 44)
    assert (c["total_scaled_up_nodes"], c["total_scaled_down_nodes"]) == (8, 8)


def test_mid_run_handoff_with_pending_ca_removal(toy_runs):
    """The reference's state at t=280 carries a CA removal not yet in
    effect; the port takes it over and runs on to t=360."""
    flat = toy_runs[280.0]
    assert (flat[".nodes.remove_time.win"] < 1 << 29).any()
    port = build_port_engine(TOY.config_yaml, TOY, 2, 8)
    port.install_state(state_from_numpy(flat, "cpu"), toy_runs["next280.0"])
    port.step_until_time(360.0)
    assert compare_states(toy_runs[360.0], state_to_numpy(port.state)) == []


def test_install_state_refuses_a_state_without_autoscaler_leaves(toy_runs):
    flat = {k: v for k, v in toy_runs[280.0].items() if not k.startswith(".auto.")}
    port = build_port_engine(TOY.config_yaml, TOY, 2, 8)
    with pytest.raises(ValueError, match="autoscaler leaves"):
        port.install_state(state_from_numpy(flat, "cpu"), toy_runs["next280.0"])


# --- (c) random HPA pod groups -------------------------------------------------


HPA_CLUSTER_TRACE = """
events:
- timestamp: 5.0
  event_type:
    !CreateNode
      node:
        metadata: {name: node_00}
        status: {capacity: {cpu: 64000, ram: 68719476736}}
"""


def hpa_workload(seed: int) -> str:
    """Random pod group: initial/max counts, cpu target, and a 2-4 segment
    cyclic load curve (the generator of tests/test_random_hpa_equivalence.py)."""
    rng = np.random.default_rng(seed)
    initial = int(rng.integers(2, 9))
    max_pods = int(rng.integers(20, 60))
    target = round(float(rng.uniform(0.3, 0.9)), 2)
    segments = "".join(
        f"""
              - duration: {int(rng.integers(2, 9)) * 60}.0
                total_load: {round(float(rng.uniform(0.5, 12.0)), 2)}"""
        for _ in range(int(rng.integers(2, 5)))
    )
    return f"""
events:
- timestamp: 59.5
  event_type:
    !CreatePodGroup
      pod_group:
        name: pod_group_1
        initial_pod_count: {initial}
        max_pod_count: {max_pods}
        pod_template:
          metadata:
            name: pod_group_1
          spec:
            resources:
              requests:
                cpu: 100
                ram: 104857600
              limits:
                cpu: 100
                ram: 104857600
        target_resources_usage:
          cpu_utilization: {target}
        resources_usage_model_config:
          cpu_config:
            model_name: pod_group
            config: |{segments}
"""


@pytest.mark.parametrize("seed,scan", [(17, 60.0), (29, 60.0), (29, 90.0)])
def test_random_hpa_groups_match_reference(seed, scan):
    """Compared every 300 s to t=1500 s; the 90 s scan makes the cycle
    read the latched 60 s collection sample."""
    config = DEFAULT_TEST_CONFIG_YAML + f"horizontal_pod_autoscaler:\n  enabled: true\n  scan_interval: {scan}\n"
    spec = YamlSpec(HPA_CLUSTER_TRACE, hpa_workload(seed))
    jx = _jax(config, spec, 1, 16)
    port = build_port_engine(config, spec, 1, 16)
    replicas = set()
    for t in np.arange(300.0, 1501.0, 300.0):
        jx.step_until_time(float(t))
        port.step_until_time(float(t))
        got = state_to_numpy(port.state)
        assert compare_states(jax_state_to_numpy(jx.state), got) == [], t
        replicas.add(int((got[".auto.hpa_tail"] - got[".auto.hpa_head"]).sum()))
    assert len(replicas) > 1  # the group scaled
    assert port.host_syncs == 0


# --- (e) a CA removal of a busy node ---------------------------------------------


CA_CONFIG_SUFFIX = """
cluster_autoscaler:
  enabled: true
  autoscaler_type: kube_cluster_autoscaler
  scan_interval: 10.0
  max_node_count: 12
  node_groups:
  - node_template:
      metadata:
        name: autoscaler_node
      status:
        capacity:
          cpu: 16000
          ram: 34359738368
"""

CA_CLUSTER_TRACE = """
events:
- timestamp: 2.0
  event_type:
    !CreateNode
      node:
        metadata: {name: base_node}
        status: {capacity: {cpu: 8000, ram: 17179869184}}
"""


def ca_workload(seed: int) -> str:
    """Random pods, some fitting only the CA's 16 000 mCPU template (the
    generator of tests/test_random_ca_equivalence.py)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 14))
    events = []
    for i in range(n):
        cpu = int(rng.choice([2000, 4000, 6000, 12000]))
        ts = round(float(rng.uniform(3.0, 40.0)), 1)
        duration = round(float(rng.uniform(20.0, 80.0)), 1)
        events.append(
            f"""
- timestamp: {ts}
  event_type:
    !CreatePod
      pod:
        metadata:
          name: pod_{i:03d}
        spec:
          resources:
            requests:
              cpu: {cpu}
              ram: {cpu * 1048576}
            limits:
              cpu: {cpu}
              ram: {cpu * 1048576}
          running_duration: {duration}
"""
        )
    return "events:" + "".join(events)


def test_ca_removal_of_a_busy_node_reschedules_its_pods():
    """Seed 23 of the CA generator: the CA's scale-down removes a node
    that still runs a pod (its re-placement onto another node was what
    made the node removable). The trace itself removes no node, so the
    window where that removal takes effect has no slab removal; the old
    host plan (removal_due from slab removals only) skipped the per-pod
    removal gather there, left the pod running on a dead node and
    diverged from the reference at t=60 s. The pod must be rescheduled,
    and the port must equal the reference's XLA path at every 10 s."""
    config = DEFAULT_TEST_CONFIG_YAML + CA_CONFIG_SUFFIX
    spec = YamlSpec(CA_CLUSTER_TRACE, ca_workload(23))
    jx = _jax(config, spec, 1, 16)
    port = build_port_engine(config, spec, 1, 16)
    n_trace_nodes = 1
    rescheduled = 0
    for t in np.arange(10.0, 301.0, 10.0):
        before = state_to_numpy(port.state)
        on_ca_node = (before[".pods.phase"] == 3) & (before[".pods.node"] >= n_trace_nodes)
        jx.step_until_time(float(t))
        port.step_until_time(float(t))
        after = state_to_numpy(port.state)
        assert compare_states(jax_state_to_numpy(jx.state), after) == [], t
        rescheduled += int((on_ca_node & (after[".pods.node"] != before[".pods.node"])).sum())
    assert rescheduled > 0
    assert port.metrics_summary()["counters"]["total_scaled_down_nodes"] > 0


# --- (f) config, trace and compile surface ---------------------------------------


def test_autoscaler_config_blocks_parse_like_the_reference():
    text = TOY.config_yaml + (
        "  kube_cluster_autoscaler: {scale_down_utilization_threshold: 0.4}\n"
    )
    mine, ref = PortConfig.from_yaml(text), JaxConfig.from_yaml(text)
    for block in ("cluster_autoscaler", "horizontal_pod_autoscaler"):
        a, b = getattr(mine, block), getattr(ref, block)
        assert (a.enabled, a.scan_interval) == (b.enabled, b.scan_interval)
    ca, ref_ca = mine.cluster_autoscaler, ref.cluster_autoscaler
    assert ca.max_node_count == ref_ca.max_node_count == 4
    assert ca.kube_cluster_autoscaler.scale_down_utilization_threshold == 0.4
    g, ref_g = ca.node_groups[0], ref_ca.node_groups[0]
    assert g.node_template.metadata.name == ref_g.node_template.metadata.name == "ca_node"
    assert g.node_template.status.capacity.cpu == ref_g.node_template.status.capacity.cpu


def test_pod_group_compile_matches_reference():
    """compile_cluster_trace + segment_pod_slots + pad_and_batch with a pod
    group: every array and group table equal to the reference's."""
    config = DEFAULT_TEST_CONFIG_YAML
    mine = port_tc.compile_cluster_trace(*TOY.events("port"), PortConfig.from_yaml(config))
    ref = jax_tc.compile_cluster_trace(*TOY.events("jax"), JaxConfig.from_yaml(config))
    (mine,), T = port_tc.segment_pod_slots([mine])
    (ref,), T_ref = jax_tc.segment_pod_slots([ref])
    assert T == T_ref and mine.pod_names == ref.pod_names
    for field in ("name", "slot_start", "slot_count", "max_pods", "initial", "creation_time",
                  "target_cpu", "target_ram", "cpu_units", "cpu_const", "ram_units", "ram_const"):
        assert getattr(mine.pod_groups[0], field) == getattr(ref.pod_groups[0], field), field
    for a, b in zip(port_tc.pad_and_batch([mine] * 2, n_pods=256), jax_tc.pad_and_batch([ref] * 2, n_pods=256)):
        np.testing.assert_array_equal(a, b)
