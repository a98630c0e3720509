"""The chaos engine of the port (kubernetriks_tpu_torch/chaos.py and the
fault path of the window step) on the CPU, against the JAX package.

- (a) The counter PRNG: threefry2x32's bits and `pod_attempt_uniforms`,
  numpy and torch forms, equal `kubernetriks_tpu.chaos` (numpy) over
  random 32-bit counters, wrap-around included; the exact powers of two
  of the backoff against XLA:CPU's jnp.exp2 where that is exact.
- (b) The crash chains: `inject_node_faults` yields the reference's event
  list for the three configs of tests/test_chaos.py at their seeds, and
  for the batched chain compiler's edge cases.
- (c) The commit draw's plain version (the CUDA kernel's twin) against
  the reference's XLA expression on seeded operands.
- (d) Fault-enabled runs equal to the JAX engine's XLA path under
  compare_states (every leaf exact, float32 metric accumulators within
  rtol 1e-6): the three tests/test_chaos.py configs on their random
  traces; the composed line with bench.py's FAULTS_YAML through a sliding
  pod window that slides; faults together with best_fit on every cycle
  route. Each run shows faults (pod_interruptions + pods_failed > 0), so
  parity is not vacuous.
- (e) The window pieces under faults on the stubbed capture backend equal
  the eager run bit for bit.

The JAX side runs with fast_forward=False (the port steps every window).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_chaos import FAULT_YAML, GROUP_FAULT_YAML, SHORT_BACKOFF_YAML
from test_random_equivalence import generate_traces
from test_torch_autoscale import TOY
from test_torch_executor import assert_bitwise_equal, counting_wrappers, stub_graphs  # noqa: F401
from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy

from bench import FAULTS_YAML
import chip_smoke
from chip_smoke import composed_sim
from kubernetriks_tpu import chaos as jax_chaos
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.core.events import CreateNodeRequest as JaxCreateNode
from kubernetriks_tpu.core.events import RemoveNodeRequest as JaxRemoveNode
from kubernetriks_tpu.core.types import Node as JaxNode
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu.trace.generic import GenericClusterTrace as JaxGenericCluster
from kubernetriks_tpu_torch import chaos
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.batched.step import exp2_int
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.core.events import CreateNodeRequest, RemoveNodeRequest
from kubernetriks_tpu_torch.core.types import Node
from kubernetriks_tpu_torch.ops._launch import LAUNCHES, reset_launches
from kubernetriks_tpu_torch.ops.chaos_kernel import pod_attempt_draw
from kubernetriks_tpu_torch.trace.generic import GenericClusterTrace, GenericWorkloadTrace

GiB = 1024**3


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


# --- (a) the counter PRNG -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 0x7FFFFFFF, 0xFFFFFFFF])
def test_threefry_bits_and_uniforms_match_the_reference(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    c0, c1 = _u32(rng, 4096), _u32(rng, 4096)
    c0[:4] = [0, 0xFFFFFFFF, 0x80000000, 0xFFFFFFFE]  # the wrap-around edges
    c1[:4] = [0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF, 1]
    want = jax_chaos._threefry2x32(seed, 3, c0, c1, np)
    got_np = chaos._threefry2x32(seed, 3, c0, c1, chaos._NumpyU32())
    got_t = chaos._threefry2x32(
        seed, 3, torch.from_numpy(c0.astype(np.int64)), torch.from_numpy(c1.astype(np.int64)), chaos._TorchU32()
    )
    for w, n, t in zip(want, got_np, got_t):
        np.testing.assert_array_equal(n, w)
        np.testing.assert_array_equal(t.numpy().astype(np.uint32), w)
    cluster, slot, attempt = _u32(rng, 4096), _u32(rng, 4096), rng.integers(0, 8, 4096).astype(np.uint32)
    want = jax_chaos.pod_attempt_uniforms(seed, cluster, slot, attempt, xp=np)
    got_np = chaos.pod_attempt_uniforms(seed, cluster, slot, attempt)
    got_t = chaos.pod_attempt_uniforms(
        seed, *(torch.from_numpy(a.astype(np.int64)) for a in (cluster, slot, attempt)), xp=torch
    )
    for w, n, t in zip(want, got_np, got_t):
        assert n.dtype == np.float32 and t.dtype == torch.float32
        np.testing.assert_array_equal(n.view(np.int32), w.view(np.int32))
        np.testing.assert_array_equal(t.numpy().view(np.int32), w.view(np.int32))
    assert want[0].min() >= 0.0 and want[0].max() < 1.0


def test_backoff_powers_of_two_are_exact():
    """exp2_int is 2^k exactly (numpy's ldexp); XLA:CPU's jnp.exp2, the
    reference's, agrees where it is exact (k <= 12), which covers every
    backoff under the configs' restart limits."""
    k = torch.arange(0, 140, dtype=torch.int32)
    got = exp2_int(k).numpy()
    want = np.ldexp(np.float64(1.0), np.arange(128)).astype(np.float32)
    np.testing.assert_array_equal(got[:128], want)
    assert np.isinf(got[128:]).all()
    xla = np.asarray(jax.jit(jnp.exp2)(jnp.arange(0, 13).astype(jnp.float32)))
    np.testing.assert_array_equal(got[:13], xla)
    base = np.float32(10.0)
    np.testing.assert_array_equal(
        (torch.tensor(10.0) * exp2_int(k[:13])).numpy(),
        np.asarray(jax.jit(lambda r: jnp.float32(base) * jnp.exp2(r))(jnp.arange(13).astype(jnp.float32))),
    )


# --- (b) the crash chains -------------------------------------------------------------


def _event_list(events):
    out = []
    for ts, e in events:
        if isinstance(e, (CreateNodeRequest, JaxCreateNode)):
            cap = e.node.status.capacity
            out.append((ts, "create", e.node.metadata.name, cap.cpu, cap.ram, e.recovered))
        else:
            out.append((ts, "remove", e.node_name, e.crashed, e.downtime_s))
    return out


@pytest.mark.parametrize("yaml, seed", [(FAULT_YAML, 101), (GROUP_FAULT_YAML, 202), (SHORT_BACKOFF_YAML, 101)])
def test_inject_node_faults_matches_the_reference(yaml, seed):
    """tests/test_chaos.py's three configs on their random traces
    (generate_traces), for clusters 0..2 at the configs' seed 123 and at
    the trace seed."""
    jcfg = JaxConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML + yaml)
    pcfg = SimulationConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML + yaml)
    cluster_trace, _ = generate_traces(seed)
    jevents = JaxGenericCluster(events=copy.deepcopy(cluster_trace.events)).convert_to_simulator_events()
    pevents = GenericClusterTrace(events=copy.deepcopy(cluster_trace.events)).convert_to_simulator_events()
    for fseed in (123, seed):
        for cluster in range(3):
            want = jax_chaos.inject_node_faults(jevents, jcfg.fault_injection, fseed, cluster, 12000.0, 10.0)
            got = chaos.inject_node_faults(pevents, pcfg.fault_injection, fseed, cluster, 12000.0, 10.0)
            assert _event_list(got) == _event_list(want)
            assert len(want) > len(jevents)
    assert chaos.make_fault_params(pcfg) == tuple(jax_chaos.make_fault_params(jcfg))


def test_inject_node_faults_edge_cases_match_the_reference():
    """Overlapping node and group channels (dropped group pairs), fixed
    spans, a lifetime ended by a removal, and no node at all."""
    def events(node_cls, create_cls, remove_cls):
        evs = [(0.0, create_cls(node=node_cls.new(f"n_{i}", 8000 + i * 1000, 16 * GiB))) for i in range(3)]
        evs.append((900.0, remove_cls(node_name="n_2")))
        return evs

    yaml = GROUP_FAULT_YAML.replace("node_000, node_001, node_002, node_003", "n_0, n_1")
    for dist in ("exponential", "fixed"):
        y = yaml.replace("mttr: 150.0", f"mttr: 150.0\n    distribution: {dist}")
        jcfg = JaxConfig.from_yaml("sim_name: t\n" + y).fault_injection
        pcfg = SimulationConfig.from_yaml("sim_name: t\n" + y).fault_injection
        jcfg.node.mttf = pcfg.node.mttf = 500.0
        for seed in range(4):
            want = jax_chaos.inject_node_faults(events(JaxNode, JaxCreateNode, JaxRemoveNode), jcfg, seed, 0, 5000.0, 10.0)
            got = chaos.inject_node_faults(events(Node, CreateNodeRequest, RemoveNodeRequest), pcfg, seed, 0, 5000.0, 10.0)
            assert _event_list(got) == _event_list(want)
    assert chaos.inject_node_faults([], pcfg, 0, 0, 100.0, 10.0) == []
    assert chaos.fault_horizon(pcfg, [], []) == 0.0


# --- (c) the commit draw -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_draw_matches_the_reference_expression(seed):
    """The draw's plain version (the CUDA kernel's twin) against the
    reference's commit expression (step.py:1311-1360) written in jnp and
    run by XLA:CPU: the same will_fail and the same float32 fail time
    bits, at a sliding window's pod_base."""
    rng = np.random.default_rng(seed)
    C, P, W = 3, 40, 30
    start = np.where(rng.random((C, P)) < 0.6, rng.uniform(0.0, 1.0, (C, P)), np.inf).astype(np.float32)
    restarts = rng.integers(0, 4, (C, P)).astype(np.int32)
    dwin = np.where(rng.random((C, P)) < 0.1, -1, rng.integers(0, 40, (C, P))).astype(np.int32)
    doff = rng.uniform(0.0, 10.0, (C, P)).astype(np.float32)
    will_fail = rng.random((C, P)) < 0.3
    pod_base = rng.integers(0, 500, C).astype(np.int32)
    fseed, prob, interval = 77, 0.4, 10.0

    def reference(start, restarts, dwin, doff, will_fail, pod_base):
        idx = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None, :], (C, P))
        started = start < jnp.float32(np.inf)
        in_plain = idx < W
        gslot = idx + jnp.where(in_plain, pod_base[:, None], jnp.int32(0))
        cid = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[:, None], (C, P)).astype(jnp.uint32)
        u_fail, u_frac = jax_chaos.pod_attempt_uniforms(
            fseed, cid, gslot.astype(jnp.uint32), restarts.astype(jnp.uint32), xp=jnp
        )
        wf = started & in_plain & (dwin >= 0) & (u_fail < jnp.float32(prob))
        dur_s = dwin.astype(jnp.float32) * jnp.float32(interval) + doff
        return jnp.where(started, wf, will_fail), jnp.where(wf, start + u_frac * dur_s, 0.0)

    want = [np.asarray(x) for x in jax.jit(reference)(start, restarts, dwin, doff, will_fail, pod_base)]
    got = pod_attempt_draw(
        *(torch.from_numpy(a) for a in (start, restarts, dwin, doff, will_fail, pod_base)),
        seed=fseed, plain_width=W, fail_prob=prob, interval=interval,
    )
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy().view(np.int32), want[1].view(np.int32))
    assert want[0].any() and (want[1] != 0).any()


# --- (d) fault-enabled runs ----------------------------------------------------------------


class RandomTraceSpec:
    """tests/test_random_equivalence.py's generate_traces(seed), rendered
    as each package's events."""

    def __init__(self, seed):
        self.seed = seed

    def events(self, side: str):
        cluster, workload = generate_traces(self.seed)
        if side == "jax":
            return cluster.convert_to_simulator_events(), workload.convert_to_simulator_events()
        return (
            GenericClusterTrace(events=cluster.events).convert_to_simulator_events(),
            GenericWorkloadTrace(events=workload.events).convert_to_simulator_events(),
        )


def _assert_faults_shown(counters):
    assert counters["pod_interruptions"] + counters["pods_failed"] > 0, counters
    assert counters["node_crashes"] > 0 or counters["pod_restarts"] > 0


def _run_pair(config_yaml, spec, C, K, until, route=None, profile=None, fast_forward=False, **kwargs):
    jx = build_jax_engine(
        config_yaml, spec, C, K, "xla", fast_forward=fast_forward, scheduler_profile=profile, **kwargs
    )
    jx.step_until_time(until)
    port = build_port_engine(
        config_yaml, spec, C, K, fast_forward=fast_forward, scheduler_profile=profile, **kwargs
    )
    if route is not None:
        port.cycle_route = route
    port.step_until_time(until)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    counters = port.metrics_summary()["counters"]
    assert counters == jx.metrics_summary()["counters"]
    _assert_faults_shown(counters)
    return jx, port, counters


@pytest.mark.parametrize("yaml, seed", [(FAULT_YAML, 101), (GROUP_FAULT_YAML, 202), (SHORT_BACKOFF_YAML, 101)])
def test_fault_run_matches_reference(yaml, seed):
    """tests/test_chaos.py's configs on their random traces, two clusters
    (each with its own crash chains), to t = 4 000 s."""
    _, port, counters = _run_pair(DEFAULT_TEST_CONFIG_YAML + yaml, RandomTraceSpec(seed), 2, 64, 4000.0)
    assert port.fault_params.node_faults and port.fault_params.pod_faults
    assert counters["node_crashes"] > 0 and counters["pod_restarts"] > 0


@pytest.mark.parametrize("fast_forward", [False, True])
def test_composed_faults_through_a_sliding_window_match_reference(fast_forward):
    """The composed line with bench.py's FAULTS_YAML through pod_window=8
    (slides and growths), the HPA and the CA on, four clusters (each with
    its own crash chains) to t = 600 s; also with both sides
    fast-forwarded."""
    assert chip_smoke.FAULTS_YAML == FAULTS_YAML  # chip_smoke's copy of the bench's block
    jx, port, counters = _run_pair(
        TOY.config_yaml + FAULTS_YAML, TOY, 4, 8, 600.0, pod_window=8, reclaim=False, fast_forward=fast_forward
    )
    assert port.dispatch_stats["slides"] > 0
    assert (port.pod_window, port._pod_base) == (jx.pod_window, jx._pod_base)


def test_sparse_fault_run_fast_forward_matches_reference():
    """A sparse fault run (tests/test_chaos.py's FAULT_YAML on the
    reference's sparse trace: 6 nodes, 0.02 pods/s) with both sides
    fast-forwarded to t = 6 000 s: crashes and recoveries are trace
    events, so each is a window both execute."""
    from test_torch_fast_forward import SparseSpec

    spec = SparseSpec(rate=0.02, horizon=6000.0, seed=5)
    _, port, counters = _run_pair(DEFAULT_TEST_CONFIG_YAML + FAULT_YAML, spec, 2, 8, 6000.0, fast_forward=True)
    assert port.dispatch_stats["skipped_windows"] > 0 and counters["node_crashes"] > 0


@pytest.mark.parametrize("route", ["sorted", "megakernel", "two_kernel"])
def test_faults_with_best_fit_match_reference(route):
    """Faults and the best_fit profile together (the reference's
    test_superspan gate), on each cycle route."""
    _, port, _ = _run_pair(
        DEFAULT_TEST_CONFIG_YAML + FAULT_YAML, RandomTraceSpec(101), 2, 64, 3000.0, route=route, profile="best_fit"
    )
    assert port.profile.name == "best_fit"


def test_stubbed_graph_run_under_faults_matches_eager(counting_wrappers):  # noqa: F811
    """On the stubbed capture backend (test_torch_executor.py): the window
    pieces under faults and best_fit, across slides and growths of a pod
    window, replay what an eager run does, bit for bit and launch for
    launch; the crash variants of the end piece are captured up front
    (precompile_pieces), none later."""
    def build():
        return composed_sim("cpu", 4, faults=True, pod_window=8, scheduler_profile="best_fit")

    eager = build()
    reset_launches()
    eager.step_until_time(600.0)
    want = dict(LAUNCHES)
    sim = stub_graphs(build())
    captured = sim.precompile_pieces()
    assert any(key[-1] == "crash" for key in sim._executor.graphs)
    reset_launches()
    sim.step_until_time(600.0)
    stats = sim.dispatch_stats
    assert stats["graph_windows"] == sim.windows_run and stats["eager_windows"] == 0
    assert stats["captures"] == captured * (1 + stats["grows"])
    assert dict(LAUNCHES) == want and sum(want.values()) > 0
    assert sim.host_syncs == eager.host_syncs == stats["slides"] + stats["grows"]
    assert_bitwise_equal(sim.state, eager.state)
    counters = sim.metrics_summary()["counters"]
    _assert_faults_shown(counters)
    assert counters["node_crashes"] > 0
