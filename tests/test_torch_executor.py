"""The window executor (kubernetriks_tpu_torch/batched/graphs.py) on the CPU.

- The piece schedule each WindowPlan yields.
- The uncaptured piece executor (the engine's path on the CPU) against the
  eager window body (step.window_body, applied functionally, as the
  conditional move's windows run) leaf for leaf, bit for bit, and against
  the JAX XLA path under compare_states: on all three cycle routes (forced
  after the build), the autoscaler toy (`chip_smoke.composed_sim("cpu",
  2)`) and a toy Alibaba replay.
- install_state copies into the engine's fixed buffers; the state cannot
  be rebound.
- Launch accounting and graph keying with a stubbed capture: a capture
  backend whose capture runs a piece once on a copy of the buffers (so its
  wrappers count, as in a CUDA capture, and nothing changes) and whose
  replay runs it with the counts held (a replay calls no wrapper), beside
  wrappers that count on the CPU.
- graphs=True on the CPU raises; graphs=None (the default) resolves to off
  there and graphs=False is accepted.

Tolerance: the piece executor and the eager body run the same ops in the
same order, so every leaf is equal exactly (torch.equal); against the JAX
XLA path, compare_states (float32 metric accumulators to rtol 1e-6).
"""

import pytest
import torch

from test_torch_autoscale import TOY
from test_torch_cuda import DELAYS, churn_yaml
from test_torch_reference import TraceSpec, build_jax_engine, build_port_engine, jax_state_to_numpy
from test_torch_replay import jax_replay

from chip_smoke import composed_sim, replay_config, replay_config_yaml
from kubernetriks_tpu_torch.batched import autoscale as autoscale_mod
from kubernetriks_tpu_torch.batched import step as step_mod
from kubernetriks_tpu_torch.batched.graphs import WindowExecutor, piece_schedule
from kubernetriks_tpu_torch.batched.state import clone_state, compare_states, copy_state_into, flatten
from kubernetriks_tpu_torch.batched.step import WindowPlan
from kubernetriks_tpu_torch.cli import build_batched_simulation
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.ops._launch import LAUNCHES, reset_launches
from kubernetriks_tpu_torch.trace import synthetic_alibaba

_CHURN_YAML = churn_yaml(3)
CHURN = TraceSpec(cluster_yaml=_CHURN_YAML[0], workload_yaml=_CHURN_YAML[1])
TOY_REPLAY = dict(n_machines=20, n_tasks=120, horizon=1500.0, seed=7, error_fraction=0.1)


# --- the piece schedule ----------------------------------------------------------


@pytest.mark.parametrize("plan, route, want", [
    (WindowPlan(0, False), "sorted", [("end", "sorted", False, None, False)]),
    (WindowPlan(3, True), "megakernel", [("chunk",)] * 3 + [("end", "megakernel", True, None, False)]),
    (WindowPlan(1, False, hpa_cycle=True), "two_kernel",
     [("chunk",), ("end", "two_kernel", False, True, False)]),
    (WindowPlan(2, True, hpa_collect=True, ca_due=True), "sorted",
     [("chunk",)] * 2 + [("end", "sorted", True, False, True)]),
    (WindowPlan(0, False, hpa_cycle=True, hpa_collect=True), "sorted", [("end", "sorted", False, True, False)]),
    (WindowPlan(0, True, ca_due=True, reclaim=True), "sorted", [("reclaim",), ("end", "sorted", True, None, True)]),
    (WindowPlan(2, False, reclaim=True), "megakernel",
     [("reclaim",)] + [("chunk",)] * 2 + [("end", "megakernel", False, None, False)]),
])
def test_piece_schedule(plan, route, want):
    assert piece_schedule(plan, route) == want


# --- pieces against the eager body and the reference --------------------------------


def functional_run(sim, until: float):
    """sim's windows to `until` as eager window bodies on a copy of its
    state, the host plan advanced as the engine advances it."""
    state = clone_state(sim.state)
    for w in sim.window_idxs(until):
        state = sim._window_body(state, int(w), sim._plan(int(w)))
        sim.next_window_idx = int(w) + 1
    return state


def assert_bitwise_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    bad = [p for p in fa if not torch.equal(fa[p], fb[p])]
    assert bad == []


@pytest.fixture(scope="module")
def churn_reference():
    """The reference's XLA run of the node-removal trace to t=300."""
    jx = build_jax_engine(DELAYS, CHURN, 4, 8, "xla")
    jx.step_until_time(300.0)
    return jax_state_to_numpy(jx.state)


@pytest.mark.parametrize("route", ["sorted", "megakernel", "two_kernel"])
def test_pieces_match_eager_body_and_reference_on_every_route(churn_reference, route):
    sims = []
    for _ in range(2):
        sim = build_port_engine(DELAYS, CHURN, 4, 8)
        sim.cycle_route = route
        sims.append(sim)
    pieces, eager = sims
    pieces.step_until_time(300.0)
    assert pieces.dispatch_stats["eager_windows"] == pieces.windows_run == 31
    assert pieces.host_syncs == 0
    assert_bitwise_equal(pieces.state, functional_run(eager, 300.0))
    assert compare_states(churn_reference, state_to_numpy(pieces.state)) == []


def test_autoscaler_pieces_match_eager_body_and_reference():
    pieces = composed_sim("cpu", 2)
    pieces.step_until_time(360.0)
    assert_bitwise_equal(pieces.state, functional_run(composed_sim("cpu", 2), 360.0))
    jx = build_jax_engine(TOY.config_yaml, TOY, 2, 8, "xla", reclaim=False)
    jx.step_until_time(360.0)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(pieces.state)) == []
    counters = pieces.metrics_summary()["counters"]
    assert counters["total_scaled_up_nodes"] > 0 and counters["total_scaled_up_pods"] > 0


def test_replay_pieces_match_eager_body_and_reference(tmp_path):
    paths = synthetic_alibaba.write_synthetic_trace_dir(str(tmp_path), **TOY_REPLAY)
    config = replay_config(paths, "test", ca=True)
    pieces = build_batched_simulation(config, 1, device="cpu")
    pieces.step_until_time(1200.0)
    eager = build_batched_simulation(config, 1, device="cpu")
    assert_bitwise_equal(pieces.state, functional_run(eager, 1200.0))
    jx = jax_replay(replay_config_yaml(paths, "test", ca=True), paths)
    jx.step_until_time(1200.0)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(pieces.state)) == []
    assert int(pieces.state.metrics.scheduling_decisions.sum()) > 0


def test_conditional_move_windows_run_eagerly():
    """The conditional move's windows, which ran eagerly until its scans
    moved to the device (step.conditional_wake), replay graphs like any
    other and end where the eager window body ends, with no host read."""
    config = DELAYS + "enable_unscheduled_pods_conditional_move: true\n"
    sim = stub_graphs(build_port_engine(config, CHURN, 4, 8))
    assert sim.precompile_pieces() > 0
    sim.step_until_time(200.0)
    assert sim.dispatch_stats["graph_windows"] == sim.windows_run == 21
    assert sim.dispatch_stats["eager_windows"] == 0 and sim.dispatch_stats["replays"] > 0
    assert sim.host_syncs == 0
    assert_bitwise_equal(sim.state, functional_run(build_port_engine(config, CHURN, 4, 8), 200.0))


# --- the fixed buffers ------------------------------------------------------------


def test_install_state_copies_into_the_fixed_buffers():
    ahead = composed_sim("cpu", 2)
    ahead.step_until_time(280.0)
    flat = state_to_numpy(ahead.state)
    sim = composed_sim("cpu", 2)
    addresses = {p: t.data_ptr() for p, t in flatten(sim.state).items()}
    sim.install_state(state_from_numpy(flat, "cpu"), ahead.next_window_idx)
    assert {p: t.data_ptr() for p, t in flatten(sim.state).items()} == addresses
    assert compare_states(flat, state_to_numpy(sim.state)) == []
    # Both continue alike from there.
    ahead.step_until_time(360.0)
    sim.step_until_time(360.0)
    assert_bitwise_equal(ahead.state, sim.state)
    with pytest.raises(AttributeError):
        sim.state = ahead.state
    wrong = state_from_numpy({**flat, ".pods.phase": flat[".pods.phase"][:, :-1]}, "cpu")
    with pytest.raises(ValueError, match="copy_state_into: leaf .pods.phase"):
        sim.install_state(wrong, 0)


def test_copy_state_into_refuses_a_source_in_another_buffer():
    sim = composed_sim("cpu", 2)
    dst = sim.state
    src = dst._replace(pods=dst.pods._replace(attempts=dst.pods.queue_seq))
    with pytest.raises(ValueError, match="the new .pods.attempts lies in another buffer"):
        copy_state_into(dst, src)
    snapshot = clone_state(dst)
    assert copy_state_into(dst, snapshot) == len(flatten(dst))
    assert copy_state_into(dst, dst) == 0


def test_graphs_on_the_cpu_raise():
    with pytest.raises(ValueError, match="graphs=True needs the card"):
        composed_sim("cpu", 2, graphs=True)
    with pytest.raises(ValueError, match="graphs=True needs the card"):
        build_port_engine(DELAYS, CHURN, 4, 8, graphs=True)
    assert not build_port_engine(DELAYS, CHURN, 4, 8).graphs
    assert not build_port_engine(DELAYS, CHURN, 4, 8, graphs=False).graphs


# --- launch accounting with a stubbed capture ------------------------------------------


class StubGraph:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        held = dict(LAUNCHES)
        self.fn()
        LAUNCHES.update(held)


class StubGraphs:
    """A capture backend for the CPU (module note)."""

    def __init__(self):
        self.executor = None
        # Conditional bodies run and skipped.
        self.bodies = {True: 0, False: 0}

    def warm(self, fn):
        fn()

    def when(self, pred, fn):
        # A conditional node's body runs where its flag is set.
        taken = bool(pred)
        self.bodies[taken] += 1
        if taken:
            fn()

    def capture(self, fn):
        bufs = self.executor.bufs
        saved = clone_state(bufs)
        fn()
        copy_state_into(bufs, saved)
        return StubGraph(fn)

    def pool_bytes(self):
        return 0


def stub_graphs(sim):
    """Put `sim` (built with graphs off) on the stub capture backend."""
    backend = StubGraphs()
    sim._executor = backend.executor = WindowExecutor(sim, backend)
    sim.graphs = True
    return sim


COUNTED = {
    step_mod: ("fused_event_scatter", "fused_free_resources", "fused_select_cycle_commit",
               "fused_schedule_cycle", "fused_select_schedule_cycle", "fused_commit_scatter"),
    autoscale_mod: ("fused_ca_scale_down", "fused_ca_scale_up"),
}


@pytest.fixture
def counting_wrappers(monkeypatch):
    """Kernel wrappers that count their calls on the CPU too, as they
    count launches on the card."""
    for mod, names in COUNTED.items():
        for name in names:
            real = getattr(mod, name)

            def counted(*args, _real=real, _name=name, **kwargs):
                LAUNCHES[_name] += 1
                return _real(*args, **kwargs)

            monkeypatch.setattr(mod, name, counted)
    reset_launches()
    yield
    reset_launches()


def _run_counted(sim, until):
    reset_launches()
    sim.step_until_time(until)
    return dict(LAUNCHES)


@pytest.mark.parametrize("build, until", [
    pytest.param(lambda: composed_sim("cpu", 2), 360.0, id="autoscaler"),
    pytest.param(lambda: build_port_engine(DELAYS, CHURN, 4, 8), 300.0, id="node_removal"),
])
def test_launch_accounting_with_a_stubbed_capture(counting_wrappers, build, until):
    eager = build()
    want = _run_counted(eager, until)
    sim = stub_graphs(build())
    reset_launches()
    captured = sim.precompile_pieces()
    assert captured == len(sim._executor.reachable_keys()) and dict(LAUNCHES) == dict.fromkeys(LAUNCHES, 0)
    got = _run_counted(sim, until)
    assert got == want and sum(got.values()) > 0
    stats = sim.dispatch_stats
    # precompile took every piece the run reached: none was captured later.
    assert stats["captures"] == captured
    assert stats["graph_windows"] == sim.windows_run and stats["eager_windows"] == 0
    assert stats["replays"] > sim.windows_run
    assert_bitwise_equal(sim.state, eager.state)


def test_a_route_forced_after_the_build_captures_its_own_cycle(counting_wrappers):
    sim = stub_graphs(build_port_engine(DELAYS, CHURN, 4, 8))
    eager = build_port_engine(DELAYS, CHURN, 4, 8)
    sim.step_until_time(150.0)
    eager.step_until_time(150.0)
    graphs = sim._executor.graphs
    stale = [graph for key, (graph, *_) in graphs.items() if key[:2] == ("end", "sorted")]
    assert ("end", "sorted", False, None, False) in graphs
    replays = []
    for graph in stale:
        graph.replay = lambda: replays.append(1)
    for s in (sim, eager):
        s.cycle_route = "megakernel"
    reset_launches()
    sim.step_until_time(300.0)
    got = dict(LAUNCHES)
    want = _run_counted(eager, 300.0)
    assert replays == [] and ("end", "megakernel", False, None, False) in graphs
    assert got == want and got["fused_select_cycle_commit"] == 15 and got["fused_schedule_cycle"] == 0
    assert_bitwise_equal(sim.state, eager.state)
