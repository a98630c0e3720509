"""The window-cost razor in the port (the engine's `window_razor=`,
step.window_work_due, the end piece's "gate" variant) on the CPU.

- Razor on equals razor off bit for bit (every leaf torch.equal) on a
  gappy trace stepped without fast-forward, on all three cycle routes
  (forced after the build), without and with the chaos engine (the
  reference's random trace with tests/test_chaos.py's fault block), most
  of the gated windows taking the skip branch: the pattern of the
  reference's tests/test_layout_razor.py
  `test_window_razor_empty_window_identity`.
- The port with the razor equals the JAX engine built with
  window_razor=True (XLA path, fast_forward=False) under compare_states
  (float32 `.metrics.` accumulators to rtol 1e-6, atol 0).
- The eager window body's razor (apply_window_events) equals the pieces.
- On the stubbed capture backend the gated end pieces are captured up
  front and skip their tail where the predicate is false.
- The glue kernels' wrappers run their plain versions on CPU tensors.
"""

import pytest
import torch

from test_chaos import FAULT_YAML  # noqa: E402
from test_torch_chaos import RandomTraceSpec  # noqa: E402
from test_torch_executor import assert_bitwise_equal, functional_run, stub_graphs  # noqa: E402
from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy  # noqa: E402

from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML  # noqa: E402
from kubernetriks_tpu.trace.generator import (  # noqa: E402
    PoissonWorkloadTrace as JaxPoisson,
    UniformClusterTrace as JaxUniform,
)

from kubernetriks_tpu_torch.batched import graphs as graphs_mod
from kubernetriks_tpu_torch.batched.graphs import piece_schedule
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.batched.step import WindowPlan
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.ops import window_kernel
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

GAPPY_CONFIG = "sim_name: razor\nseed: 1\nscheduling_cycle_interval: 10.0\n"


class GappySpec:
    """The reference test's gappy trace: 8 nodes (64 000 mCPU, 128 GiB) and
    two 60 s Poisson bursts at 0 and 600 s (1 pod/s, 20-40 s), quiet
    windows between."""

    def events(self, side: str):
        uniform = JaxUniform if side == "jax" else UniformClusterTrace
        poisson = JaxPoisson if side == "jax" else PoissonWorkloadTrace
        bursts = []
        for t0 in (0.0, 600.0):
            w = poisson(
                rate_per_second=1.0, horizon=60.0, seed=int(t0) + 5, cpu=4000, ram=8 * 1024**3,
                duration_range=(20.0, 40.0), name_prefix=f"b{int(t0)}",
            )
            bursts += [(t + t0, ev) for t, ev in w.convert_to_simulator_events()]
        return (
            uniform(8, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
            sorted(bursts, key=lambda e: e[0]),
        )


GAPPY = GappySpec()


@pytest.fixture
def predicate_counts(monkeypatch):
    """Count the gated tails' predicate values (the executor's calls of
    step.window_work_due)."""
    counts = {True: 0, False: 0}
    real = graphs_mod.window_work_due

    def counting(*args):
        out = real(*args)
        counts[bool(out)] += 1
        return out

    monkeypatch.setattr(graphs_mod, "window_work_due", counting)
    return counts


def _razor_pair(config, spec, C, K, until, route):
    runs = {}
    for razor in (True, False):
        sim = build_port_engine(config, spec, C, K, fast_forward=False, window_razor=razor)
        assert sim.window_razor is razor
        sim.cycle_route = route
        sim.step_until_time(until)
        runs[razor] = sim
    return runs[True], runs[False]


@pytest.mark.parametrize("route", ["sorted", "megakernel", "two_kernel"])
def test_razor_on_equals_off(route, predicate_counts):
    on, off = _razor_pair(GAPPY_CONFIG, GAPPY, 2, 16, 800.0, route)
    assert_bitwise_equal(on.state, off.state)
    assert predicate_counts[False] > 20 and predicate_counts[True] > 0
    assert on.metrics_summary()["counters"]["scheduling_decisions"] > 0


@pytest.mark.parametrize("route", ["sorted", "megakernel", "two_kernel"])
def test_razor_on_equals_off_with_faults(route, predicate_counts):
    on, off = _razor_pair(DEFAULT_TEST_CONFIG_YAML + FAULT_YAML, RandomTraceSpec(101), 2, 64, 2500.0, route)
    assert_bitwise_equal(on.state, off.state)
    assert predicate_counts[False] > 0 and predicate_counts[True] > 0
    counters = on.metrics_summary()["counters"]
    assert counters["node_crashes"] > 0 and counters["pod_restarts"] > 0


@pytest.mark.parametrize("route", ["sorted", "megakernel"])
def test_razor_matches_reference(route):
    jx = build_jax_engine(GAPPY_CONFIG, GAPPY, 2, 16, "xla", fast_forward=False, window_razor=True)
    assert jx.window_razor
    jx.step_until_time(800.0)
    port = build_port_engine(GAPPY_CONFIG, GAPPY, 2, 16, fast_forward=False, window_razor=True)
    port.cycle_route = route
    port.step_until_time(800.0)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []


def test_razor_defaults_off_on_the_cpu():
    sim = build_port_engine(GAPPY_CONFIG, GAPPY, 2, 16)
    assert sim.window_razor is False


def test_eager_body_razor_equals_pieces():
    """The eager window body under the razor (its skip branch read back on
    the host) ends where the pieces end."""
    sim = build_port_engine(GAPPY_CONFIG, GAPPY, 2, 16, fast_forward=False, window_razor=True)
    eager = functional_run(sim, 800.0)
    pieces = build_port_engine(GAPPY_CONFIG, GAPPY, 2, 16, fast_forward=False, window_razor=True)
    pieces.step_until_time(800.0)
    assert_bitwise_equal(eager, pieces.state)


def test_piece_schedule_gates_windows_without_chunks():
    assert piece_schedule(WindowPlan(0, False), "sorted", razor=True) == [("end", "sorted", False, None, False, "gate")]
    assert piece_schedule(WindowPlan(2, True, reclaim=True), "megakernel", razor=True) == (
        [("reclaim",)] + [("chunk",)] * 2 + [("end", "megakernel", True, None, False)]
    )


def test_stubbed_graph_razor_skips_tails():
    def build(razor):
        return build_port_engine(GAPPY_CONFIG, GAPPY, 2, 16, fast_forward=False, window_razor=razor)

    off = build(False)
    off.step_until_time(800.0)
    sim = stub_graphs(build(True))
    captured = sim.precompile_pieces()
    assert ("end", "sorted", False, None, False, "gate") in sim._executor.graphs
    backend = sim._executor.backend
    sim.step_until_time(800.0)
    assert sim.dispatch_stats["captures"] == captured
    assert backend.bodies[False] > 20 and backend.bodies[True] > 0
    assert_bitwise_equal(sim.state, off.state)


def run_glue_wrappers():
    """Each glue kernel's wrapper on small CPU tensors (its plain version;
    no count), checking its result's kind."""
    C, N, P, E, G = 2, 3, 4, 5, 1
    i32 = torch.int32

    def zi(*shape):
        return torch.zeros(shape, dtype=i32)

    packed = zi(C, E, 4)
    W = torch.full((C,), 3, dtype=i32)
    due = window_kernel.window_work_due(zi(C), packed, zi(C, N), zi(C, N), zi(C, P), zi(C, P), zi(C, P),
                                        torch.zeros((C, P)), W)
    assert due.dtype == torch.bool and due.shape == ()
    span = window_kernel.next_window_span(
        zi(C), packed, zi(C, P), zi(C, P), zi(C, N), zi(C, N), zi(C, P), zi(C, P), zi(C), W,
        torch.full((1,), 9, dtype=i32), zi(C), torch.zeros(C), zi(C), torch.zeros(C), zi(C), zi(C), zi(C, G),
        flush_windows=3, interval=10.0,
    )
    assert span.tolist() == [4, 4]
    out = window_kernel.catch_up(
        torch.tensor([4, 7], dtype=i32), zi(C), zi(C), *([zi(C), torch.zeros(C)] * 5),
        interval=10.0, flush_interval=30.0,
    )
    assert out[1].tolist() == [6, 6]
    moved = window_kernel.conditional_wake_scan(
        torch.ones((C, P), dtype=torch.bool), zi(C, P), zi(C, P), torch.zeros((C, N + P), dtype=torch.bool),
        torch.zeros((C, N + P), dtype=torch.bool), zi(C, N + P), zi(C, N + P),
    )
    assert not bool(moved.any())
