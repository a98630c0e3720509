"""CA slot reclaim in the port (autoscale.ca_name_order, ca_reclaim_pass and
the engine's `reclaim=` build argument) against the JAX package's
`reclaim=True` path, on the CPU.

Parity policy, as in test_torch_engine.py: compare_states — every integer
and time leaf exactly equal, float32 `.metrics.` accumulators to rtol
1e-6, atol 0. The reference runs on its XLA path with fast_forward=False:
its fast-forward dispatch skips windows it finds idle, and the reclaim
compaction of a skipped window waits for the next one it runs, so its
allocation and cursor leaves then depend on how the run was stepped (the
trajectory does not). The port runs every window.
  (1) ca_name_order on seeded allocation tables (reused and double- and
      triple-digit allocations, two CA groups, three clusters), and the
      name-class tables the build makes;
  (2) ca_reclaim_pass on the reference's own states along the wave churn,
      and the identity where nothing retires, bit for bit;
  (3) the wave churn of tests/test_reclaim.py at C = 1 past its 2-slot
      reserve (12 waves, 16 allocations): the port and the reference
      finish in equal states, the CA counters equal the scalar oracle's,
      and the port without reclaim raises; and a churn whose coexisting
      pair is named ca_node_9 and ca_node_10, where the scale-down's
      name-ordered walk decides which of the two goes;
  (4) reclaim on against reclaim off within the reserve (slot multiplier
      3): the same trajectory, only the CA slots' positions differ;
  (5) the decision: interleaving names refuse an explicit reclaim=True,
      the default turns it off with the reason, and on each test trace the
      port decides as the reference does;
  (6) the churn through pod_window=8 against the reference's sliding
      engine;
  (7) the graph executor on a stubbed capture: the reclaim piece's
      replays equal the eager run, launches included.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference import TraceSpec, build_jax_engine, build_port_engine, jax_state_to_numpy

from kubernetriks_tpu.batched import autoscale as jax_autoscale  # noqa: E402
from kubernetriks_tpu.sim.simulator import KubernetriksSimulation  # noqa: E402
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML, default_test_simulation_config  # noqa: E402
from kubernetriks_tpu.trace.generic import GenericClusterTrace as JaxGenericCluster  # noqa: E402
from kubernetriks_tpu.trace.generic import GenericWorkloadTrace as JaxGenericWorkload  # noqa: E402
from test_reclaim import CLUSTER_TRACE, RECLAIM_CA_SUFFIX, wave_workload  # noqa: E402
from test_torch_executor import (  # noqa: E402,F401  (counting_wrappers: a fixture)
    _run_counted,
    assert_bitwise_equal,
    counting_wrappers,
    functional_run,
    stub_graphs,
)
from test_torch_replay import CA_YAML, REFERENCE_SIZE, alibaba_yaml, jax_replay, write_trace  # noqa: E402

from chip_smoke import composed_config_yaml, count_reordered_removals
from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.batched.autoscale import ca_name_order, ca_reclaim_pass
from kubernetriks_tpu_torch.batched.engine import decide_reclaim
from kubernetriks_tpu_torch.batched.state import compare_states, flatten
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.trace import synthetic_alibaba as port_synth

CONFIG = DEFAULT_TEST_CONFIG_YAML + RECLAIM_CA_SUFFIX
N_WAVES = 12
HORIZON = 10.0 + N_WAVES * 200.0
CHURN = TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=wave_workload(N_WAVES))
TWO_GROUPS = DEFAULT_TEST_CONFIG_YAML + """
cluster_autoscaler:
  enabled: true
  scan_interval: 10.0
  max_node_count: 3
  node_groups:
  - node_template:
      metadata: {name: ca_b}
      status: {capacity: {cpu: 16000, ram: 34359738368}}
  - node_template:
      metadata: {name: ca_a}
      status: {capacity: {cpu: 32000, ram: 34359738368}}
"""
RECLAIM_LEAVES = (".auto.ca_alloc", ".auto.ca_total", ".auto.ca_reclaimed")


def _jax(spec, config=CONFIG, n_clusters=1, **kwargs):
    kwargs.setdefault("ca_slot_multiplier", 1)
    kwargs.setdefault("fast_forward", False)
    return build_jax_engine(config, spec, n_clusters, None, "xla", **kwargs)


def _port(spec, config=CONFIG, n_clusters=1, **kwargs):
    kwargs.setdefault("ca_slot_multiplier", 1)
    kwargs.setdefault("fast_forward", False)
    return build_port_engine(config, spec, n_clusters, None, **kwargs)


@pytest.fixture(scope="module")
def churn_runs():
    """The reference's and the port's reclaim runs of the wave churn to
    its horizon; the reference's state before each window is kept (as
    numpy) with its window index."""
    jx = _jax(CHURN, reclaim=True)
    port = _port(CHURN, reclaim=True)
    before = []
    samples = {}
    for t in np.arange(10.0, HORIZON + 10.0, 10.0):
        before.append((jx.next_window_idx, jax_state_to_numpy(jx.state)))
        jx.step_until_time(float(t))
        if int(t) % 400 == 0:
            samples[float(t)] = (jx.next_window_idx, jax_state_to_numpy(jx.state))
    return {"jax": jx, "port": port, "before": before, "samples": samples}


# --- (1) ca_name_order -----------------------------------------------------------


def _seeded_allocs(rng, C, starts, counts):
    """(C, S) allocation tables: in each group a random prefix occupied by
    distinct allocation indices drawn from [0, 130), in allocation order
    as a run leaves them (a slot reused many times carries a late index;
    double- and triple-digit names mix)."""
    S = int(sum(counts))
    out = np.full((C, S), -1, np.int32)
    for c in range(C):
        for start, count in zip(starts, counts):
            k = int(rng.integers(1, count + 1))
            out[c, start : start + k] = np.sort(rng.choice(130, size=k, replace=False))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ca_name_order_matches_reference(seed):
    cluster = CLUSTER_TRACE.replace("base_node", "ca_a_base")
    spec = TraceSpec(cluster_yaml=cluster, workload_yaml=wave_workload(1))
    jx = _jax(spec, TWO_GROUPS, n_clusters=3, ca_slot_multiplier=2)
    port = _port(spec, TWO_GROUPS, n_clusters=3, ca_slot_multiplier=2)
    jst, pst = jx.autoscale_statics, port.autoscale_statics
    # The name-class tables the build makes, as compare_states holds them.
    tables = ("ca_slot_class", "ca_class_start", "node_class_key", "ca_sd_order", "node_name_rank")
    want = {f".{n}": np.asarray(getattr(jst, n)) for n in tables}
    got = {k: v for k, v in state_to_numpy(pst).items() if k in want}
    assert compare_states(want, got) == []
    starts = np.asarray(jst.ng_ca_start)[0]
    counts = np.asarray(jst.ng_slot_count)[0]
    assert list(counts) == [6, 6]
    alloc = _seeded_allocs(np.random.default_rng(seed), 3, starts, counts)
    assert (alloc >= 99).any() and ((alloc >= 9) & (alloc < 99)).any()
    sd_want, key_want = jax_autoscale.ca_name_order(jx.state.auto._replace(ca_alloc=jnp.asarray(alloc)), jst)
    port_auto = port.state.auto._replace(ca_alloc=torch.from_numpy(alloc))
    sd_got, key_got = ca_name_order(port_auto, pst, port._k)
    assert sd_got.dtype == torch.int64  # the port's slot-order dtype; compared as int32
    np.testing.assert_array_equal(sd_got.to(torch.int32).numpy(), np.asarray(sd_want))
    np.testing.assert_array_equal(key_got.numpy(), np.asarray(key_want))
    # A table with no reuse orders the slots as the static table does.
    fresh = np.where(alloc >= 0, np.arange(12)[None, :] - np.repeat(starts, counts)[None, :], -1).astype(np.int32)
    sd_fresh, _ = ca_name_order(port.state.auto._replace(ca_alloc=torch.from_numpy(fresh)), pst, port._k)
    assert torch.equal(sd_fresh, pst.ca_sd_order)


# --- (2) ca_reclaim_pass --------------------------------------------------------------


def test_ca_reclaim_pass_matches_reference(churn_runs):
    """On the reference's states before every window that retires a slot,
    and before the first ten windows with a CA node (live, or dead and
    still bound by a pod) where nothing retires."""
    jx, port = churn_runs["jax"], churn_runs["port"]
    jst, pst = jx.autoscale_statics, port.autoscale_statics
    retiring, identity = [], []
    for w, flat in churn_runs["before"]:
        before = state_from_numpy(flat, "cpu")
        got = ca_reclaim_pass(before, pst, torch.full((1,), w, dtype=torch.int32), port._k)
        if int(got.auto.ca_reclaimed.sum()) > int(before.auto.ca_reclaimed.sum()):
            retiring.append((w, flat, got))
        elif (flat[".auto.ca_alloc"] >= 0).any() and len(identity) < 10:
            # Nothing retired: the input comes back bit for bit.
            assert_bitwise_equal(got, before)
            identity.append((w, flat, got))
    assert len(retiring) >= 10 and len(identity) == 10

    @jax.jit
    def reference_pass(state, W):
        return jax_autoscale.ca_reclaim_pass(state, state.auto, jst, W, jx.consts)

    for w, flat, got in retiring + identity:
        j_state, j_auto = reference_pass(jax_tree(jx.state, flat), jnp.full((1,), w, jnp.int32))
        assert compare_states(jax_state_to_numpy(j_state._replace(auto=j_auto)), state_to_numpy(got)) == [], w


def jax_tree(template, flat):
    """The reference's state `template` with the leaves of `flat`."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[jax.tree_util.keystr(p)]) for p, _ in leaves]
    )


# --- (3) the wave churn past the reserve ------------------------------------------


def test_churn_past_the_reserve_matches_reference_and_scalar(churn_runs):
    jx, port = churn_runs["jax"], churn_runs["port"]
    assert jx.reclaim and port.reclaim and port.reclaim_unsupported is None
    for t, (_, want) in churn_runs["samples"].items():
        port.step_until_time(t)
        assert compare_states(want, state_to_numpy(port.state)) == [], t
    port.step_until_time(HORIZON)
    final = jax_state_to_numpy(jx.state)
    assert compare_states(final, state_to_numpy(port.state)) == []
    # The reference's state mid-churn, reclaim leaves and all, handed to a
    # fresh port engine, runs on to the same end.
    w, mid = churn_runs["samples"][1200.0]
    handoff = _port(CHURN, reclaim=True)
    handoff.install_state(state_from_numpy(mid, "cpu"), w)
    handoff.step_until_time(HORIZON)
    assert compare_states(final, state_to_numpy(handoff.state)) == []
    counters = port.metrics_summary()["counters"]  # the bounds hold: no raise
    total = int(port.state.auto.ca_total.sum())
    reserve = int(port.autoscale_statics.ng_slot_count.sum())
    assert reserve == 2 and total == 16 >= 3 * reserve
    assert counters["ca_slots_reclaimed"] == int(jx.ca_slots_reclaimed().sum()) >= total - reserve
    # The scalar oracle's CA counters over the same churn.
    scalar = KubernetriksSimulation(default_test_simulation_config(RECLAIM_CA_SUFFIX))
    scalar.initialize(JaxGenericCluster.from_yaml(CLUSTER_TRACE), JaxGenericWorkload.from_yaml(CHURN.workload_yaml))
    scalar.step_until_time(HORIZON)
    sm = scalar.metrics_collector.accumulated_metrics
    assert (counters["total_scaled_up_nodes"], counters["total_scaled_down_nodes"]) == (
        sm.total_scaled_up_nodes, sm.total_scaled_down_nodes) == (16, 16)
    assert counters["pods_succeeded"] == sm.pods_succeeded == 16


def _pod_yaml(name, t, cpu, duration):
    return f"""
- timestamp: {t}
  event_type:
    !CreatePod
      pod:
        metadata:
          name: {name}
        spec:
          resources:
            requests: {{cpu: {cpu}, ram: 1073741824}}
            limits: {{cpu: {cpu}, ram: 1073741824}}
          running_duration: {duration}
"""


def straddling_workload():
    """A churn whose scale-down outcome rests on the name order across a
    digit boundary. A filler fills the base node; four waves of two
    12 000 mCPU pods allocate CA nodes 1-8 through the 2-slot reserve;
    then two 10 000 mCPU pods open ca_node_9 (A, slot order first) and
    ca_node_10 (B), a 5 000 mCPU pod joins each, and the big pods finish.
    A and B are then both under the threshold, and whichever the walk
    reaches first moves its small pod onto the other, which is then too
    full to go: "ca_node_10" < "ca_node_9", so B goes and A stays, where
    the static slot order would remove A."""
    ev = [_pod_yaml("filler", 5.0, 8000, 100000.0)]
    for k in range(4):
        t = 10.0 + 200.0 * k
        ev += [_pod_yaml(f"big_{k}_0", t, 12000, 60.0), _pod_yaml(f"big_{k}_1", t + 7.0, 12000, 71.0)]
    ev += [
        _pod_yaml("big_4_0", 810.0, 10000, 60.0), _pod_yaml("big_4_1", 817.0, 10000, 60.0),
        _pod_yaml("small_0", 830.0, 5000, 300.0), _pod_yaml("small_1", 831.0, 5000, 300.0),
    ]
    return "events:" + "".join(ev)


@pytest.mark.parametrize("fast_forward", [False, True])
def test_churn_across_a_digit_boundary_matches_reference(fast_forward):
    """The straddling churn past the 2-slot reserve: the port removes
    ca_node_10 on a reordered walk and keeps ca_node_9 (allocation 8), and
    its states along the way and at the end equal the reference's; the CA
    counters equal the scalar oracle's. Also with both sides
    fast-forwarded (the same windows executed, so the same compactions)."""
    workload = straddling_workload()
    horizon = 1400.0
    spec = TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=workload)
    jx = _jax(spec, reclaim=True, fast_forward=fast_forward)
    port = _port(spec, reclaim=True, fast_forward=fast_forward)
    assert port.fast_forward == jx.fast_forward == fast_forward
    reordered, restore = count_reordered_removals(port)
    try:
        for t in (700.0, 880.0, 900.0, 920.0, 950.0, 1200.0, horizon):
            jx.step_until_time(t)
            port.step_until_time(t)
            assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == [], t
            if t == 950.0:
                assert port.state.auto.ca_alloc.tolist() == [[8, -1]]
    finally:
        restore()
    assert reordered[0] == 1
    counters = port.metrics_summary()["counters"]
    if fast_forward:
        # The last windows are skipped, and with them a compaction the
        # reference defers too: its count, one short of stepping's.
        assert port.dispatch_stats["skipped_windows"] > 0
        assert counters["ca_slots_reclaimed"] == int(jx.ca_slots_reclaimed().sum()) == 9
        assert int(port.state.auto.ca_total.sum()) == 10
    else:
        assert int(port.state.auto.ca_total.sum()) == 10 and counters["ca_slots_reclaimed"] == 10
    scalar = KubernetriksSimulation(default_test_simulation_config(RECLAIM_CA_SUFFIX))
    scalar.initialize(JaxGenericCluster.from_yaml(CLUSTER_TRACE), JaxGenericWorkload.from_yaml(workload))
    scalar.step_until_time(horizon)
    sm = scalar.metrics_collector.accumulated_metrics
    assert (counters["total_scaled_up_nodes"], counters["total_scaled_down_nodes"]) == (
        sm.total_scaled_up_nodes, sm.total_scaled_down_nodes) == (10, 10)
    assert counters["pods_succeeded"] == sm.pods_succeeded


def test_churn_without_reclaim_raises(churn_runs):
    port = _port(CHURN, reclaim=False)
    assert not port.reclaim and port.state.auto.ca_alloc is None
    # A state with reclaim's leaves does not fit this engine.
    w, flat = churn_runs["samples"][400.0]
    with pytest.raises(ValueError, match="autoscaler leaves do not match"):
        port.install_state(state_from_numpy(flat, "cpu"), w)
    port.step_until_time(6 * 200.0)
    with pytest.raises(RuntimeError, match="CA slot reserve exhausted.*reclaim=True"):
        port.metrics_summary()


# --- (4) on against off within the reserve ---------------------------------------------


def test_reclaim_on_equals_off_within_the_reserve():
    spec = TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=wave_workload(4))
    on = _port(spec, reclaim=True, ca_slot_multiplier=3)
    off = _port(spec, reclaim=False, ca_slot_multiplier=3)
    n_trace = on.n_nodes - on.autoscale_statics.ca_slots.shape[1]
    for t in np.arange(15.0, 4 * 200.0 + 10.0, 10.0):
        on.step_until_time(float(t))
        off.step_until_time(float(t))
        assert int(on.state.nodes.alive.sum()) == int(off.state.nodes.alive.sum()), t
    a, b = state_to_numpy(on.state), state_to_numpy(off.state)
    # Reclaim moves CA nodes to other slots: the CA segment of the node
    # leaves, the pods' pointers into it and the cursor (live occupancy
    # against allocations) differ; every other leaf both have is equal.
    moved = [k for k in b if k.startswith(".nodes.")] + [".pods.node", ".auto.ca_cursor"]
    assert compare_states({k: a[k] for k in b if k not in moved}, {k: b[k] for k in b if k not in moved}) == []
    for key in moved[:-2]:
        assert (a[key][:, :n_trace] == b[key][:, :n_trace]).all(), key
    on_trace = b[".pods.node"] < n_trace
    assert (a[".pods.node"] < n_trace).tolist() == on_trace.tolist()
    assert (a[".pods.node"][on_trace] == b[".pods.node"][on_trace]).all()
    assert a[".auto.ca_cursor"].sum() < b[".auto.ca_cursor"].sum() == 5
    assert on.dispatch_stats == off.dispatch_stats
    counters = on.metrics_summary()["counters"]
    assert counters.pop("ca_slots_reclaimed") > 0
    assert counters == off.metrics_summary()["counters"]


# --- (5) the decision ----------------------------------------------------------------


BAD_CLUSTER = CLUSTER_TRACE.replace("base_node", "ca_node_15")


def test_interleaving_names_refuse_reclaim():
    spec = TraceSpec(cluster_yaml=BAD_CLUSTER, workload_yaml=wave_workload(2))
    with pytest.raises(ValueError, match="ca_node_15.*name family"):
        _port(spec, reclaim=True)
    port = _port(spec)
    jx = _jax(spec)
    assert not port.reclaim and port.autoscale_statics.ca_slot_class is None
    assert port.reclaim_unsupported == jx._autoscale_aux["reclaim_unsupported"]
    assert "name family" in port.reclaim_unsupported
    # The card's default: off, with the reason.
    with pytest.warns(RuntimeWarning, match="ca_node_15"):
        assert decide_reclaim(None, True, True, port.reclaim_unsupported) is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert decide_reclaim(None, False, True, port.reclaim_unsupported) is False
        assert decide_reclaim(None, True, True, None) is True
        assert decide_reclaim(None, True, False, "the cluster autoscaler is disabled") is False


@pytest.mark.parametrize("trace, armed", [
    ("churn", True), ("two_groups", True), ("interleaving", "refused"), ("composed", True),
    ("replay", False), ("replay_ca", True),
])
def test_reclaim_decision_matches_reference(trace, armed, tmp_path):
    """Whether each build can arm reclaim, why not, and what an explicit
    reclaim=True does (`armed`: True, refused, or False where no
    autoscaler runs): the same on both sides."""
    if trace.startswith("replay"):
        paths = write_trace(tmp_path, port_synth, **REFERENCE_SIZE)
        extra = CA_YAML.format(max_nodes=64, node_name="alibaba_ca_node") if trace == "replay_ca" else ""
        yaml = alibaba_yaml(paths, extra)

        def build_jax(**kwargs):
            return jax_replay(yaml, paths, **kwargs)

        def build_port(**kwargs):
            return port_cli.build_batched_simulation(PortConfig.from_yaml(yaml), 1, device="cpu", **kwargs)
    else:
        config, spec = {
            "churn": (CONFIG, CHURN),
            "two_groups": (TWO_GROUPS, TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=wave_workload(1))),
            "interleaving": (CONFIG, TraceSpec(cluster_yaml=BAD_CLUSTER, workload_yaml=wave_workload(1))),
            "composed": (composed_config_yaml(4), TraceSpec(n_nodes=4, poisson=dict(
                rate_per_second=0.2, horizon=60.0, seed=3, cpu=16000, ram=32 * 1024**3,
                duration_range=(30.0, 120.0)))),
        }[trace]

        def build_jax(**kwargs):
            return _jax(spec, config, **kwargs)

        def build_port(**kwargs):
            return _port(spec, config, **kwargs)

    jx, port = build_jax(), build_port()
    if port.autoscale_statics is not None:
        assert port.reclaim_unsupported == jx._autoscale_aux["reclaim_unsupported"]
    assert not port.reclaim and not jx.reclaim  # the CPU's default
    outcomes = []
    for build in (build_jax, build_port):
        try:
            outcomes.append(build(reclaim=True).reclaim)
        except ValueError:
            outcomes.append("refused")
    assert outcomes == [armed, armed]


# --- (6) through the sliding pod window ------------------------------------------------


@pytest.mark.parametrize("fast_forward", [False, True])
def test_churn_through_a_sliding_pod_window_matches_reference(fast_forward):
    """Also fast-forwarded on both sides: the spans cut along the
    reference's chunk ladder execute the same windows."""
    spec = TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=wave_workload(N_WAVES))
    jx = _jax(spec, reclaim=True, pod_window=8, fast_forward=fast_forward)
    port = _port(spec, reclaim=True, pod_window=8, fast_forward=fast_forward)
    jx.step_until_time(HORIZON)
    port.step_until_time(HORIZON)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    assert port.dispatch_stats["slides"] > 0
    assert int(port.ca_slots_reclaimed().sum()) == int(jx.ca_slots_reclaimed().sum()) >= 14


# --- (7) the graph executor --------------------------------------------------------------


def test_reclaim_piece_on_a_stubbed_capture(counting_wrappers):  # noqa: F811
    def build():
        return _port(CHURN, reclaim=True)

    eager = build()
    want = _run_counted(eager, 1200.0)
    sim = stub_graphs(build())
    captured = sim.precompile_pieces()
    assert ("reclaim",) in sim._executor.graphs and captured == len(sim._executor.reachable_keys())
    got = _run_counted(sim, 1200.0)
    assert got == want and got["fused_ca_scale_down"] > 0 and got["fused_ca_scale_up"] > 0
    stats = sim.dispatch_stats
    assert stats["captures"] == captured and stats["graph_windows"] == sim.windows_run
    # One reclaim replay a window, the end piece's one, and the chunks'.
    assert stats["replays"] >= 2 * sim.windows_run
    # The compaction ran only in the windows with a dead slot, and the
    # windows without one skipped it.
    bodies = sim._executor.backend.bodies
    assert bodies[True] > 0 and bodies[False] > bodies[True]
    assert_bitwise_equal(sim.state, eager.state)
    assert int(sim.ca_slots_reclaimed().sum()) > 0
    # The eager window body (the conditional move's path) does the same.
    assert_bitwise_equal(functional_run(build(), 1200.0), eager.state)
    assert set(RECLAIM_LEAVES) <= set(flatten(sim.state))
