"""The sliding pod window of the port (kubernetriks_tpu_torch) on the CPU,
against the JAX package's sliding engine.

- (a) The slide primitives (batched/step.py `slide_shift_core`,
  `quantize_shift`, `slide_apply`) against the reference's
  `_slide_shift_core`, `_quantize_shift_device` and `_slide_apply_traced`
  on numpy-seeded pods and payloads, for every shift 0..W at W in {1, 2,
  3, 8, 64, 512}: exactly equal.
- (b)-(e) Sliding runs of the port against the reference's sliding engine
  (its default executor on the CPU: the slide payload on the device, one
  slide dispatch pair a span), built through the adapter in
  test_torch_reference.py: a Poisson trace that slides many times without
  growing (on the XLA path and on the interpret-mode megakernel path, the
  port on the megakernel route there), the growth trace of
  tests/test_pod_window_growth.py (64 -> 128 -> 200), the composed toy
  (HPA ring and CA) at a window that slides and grows, and a node removal
  under a window without autoscalers (no name ranks there, as in the
  reference). Each also equals the port's own whole-resident run on the
  metrics_summary() counters.
- (f) A mid-run hand-off of the reference's sliding state into a sliding
  port engine (install_state, which grows the window to the state's width
  and restores the pod_base mirror and the windowed ranks).
- The engine and executor: one host read a span (host_syncs == slides +
  grows), the slide writes the rank tensor in place, a growth rebuilds the
  executor's buffers and keeps K, graphs=True on the CPU raises, a
  payload over the budget runs from bounded stages (at the build and from
  a growth on) and equals the in-budget run, step_window refuses to run
  past the window, and the CLI's
  --pod-window gives the build argument's counters; on the stubbed capture
  backend of test_torch_executor.py, a run across slides and a growth
  equals the eager run bit for bit with equal launch counts.

Tolerance: compare_states (kubernetriks_tpu/batched/state.py:681): every
state leaf exact, the float32 metric accumulators within rtol 1e-6; the
primitives and the stubbed graph run exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_autoscale import TOY
from test_torch_cuda import DELAYS, churn_yaml
from test_torch_executor import assert_bitwise_equal, counting_wrappers, stub_graphs  # noqa: F401
from test_torch_reference import (
    BENCH_CONFIG,
    POISSON,
    TraceSpec,
    build_jax_engine,
    build_port_engine,
    jax_state_to_numpy,
)

from chip_smoke import composed_sim
from kubernetriks_tpu.batched.engine import _slide_shift_device
from kubernetriks_tpu.batched.state import PodArrays as JaxPodArrays
from kubernetriks_tpu.batched.state import fresh_pod_arrays as jax_fresh_pod_arrays
from kubernetriks_tpu.batched.step import _quantize_shift_device, _slide_apply_traced
from kubernetriks_tpu.batched.timerep import TPair as JaxTPair
from kubernetriks_tpu_torch import cli
from kubernetriks_tpu_torch.batched import engine as engine_mod
from kubernetriks_tpu_torch.batched.state import PodArrays, compare_states, flatten, unflatten
from kubernetriks_tpu_torch.batched.step import quantize_shift, slide_apply, slide_shift_core
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.metrics.render import render_metrics
from kubernetriks_tpu_torch.ops._launch import LAUNCHES, reset_launches

INT32_MAX = np.iinfo(np.int32).max

# --- (a) the slide primitives ----------------------------------------------------


def _random_pods(rng, C, P):
    """{path: numpy} of a PodArrays with every leaf seeded."""
    out = {}
    for path in _POD_PATHS:
        if path in (".phase",):
            out[path] = rng.integers(0, 7, (C, P)).astype(np.int32)
        elif path.endswith(".off"):
            out[path] = np.where(rng.random((C, P)) < 0.1, np.inf, rng.uniform(0, 10, (C, P))).astype(np.float32)
        elif path == ".will_fail":
            out[path] = rng.random((C, P)) < 0.5
        else:
            out[path] = rng.integers(-2, 1000, (C, P)).astype(np.int32)
    return out


_POD_PATHS = [
    ".phase", ".req_cpu", ".req_ram", ".duration.win", ".duration.off", ".queue_ts.win", ".queue_ts.off",
    ".queue_seq", ".initial_attempt_ts.win", ".initial_attempt_ts.off", ".attempts", ".node",
    ".start_time.win", ".start_time.off", ".finish_time.win", ".finish_time.off", ".removal_time.win",
    ".removal_time.off", ".hpa_idx", ".restarts", ".will_fail",
]


def _jax_pods(flat):
    template = jax_fresh_pod_arrays(
        1, 1, np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
        JaxTPair(win=jnp.zeros((1, 1), jnp.int32), off=jnp.zeros((1, 1), jnp.float32)),
    )
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    assert isinstance(template, JaxPodArrays)
    assert sorted(jax.tree_util.keystr(p) for p, _ in paths) == sorted(_POD_PATHS)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[jax.tree_util.keystr(p)]) for p, _ in paths])


def _shift_case(rng, C, W, T, s0):
    """(phase (C, W), create_win (C, T + W), base) whose leading run of
    terminal or padding slots, least over the rows, is exactly s0."""
    base = int(rng.integers(0, T + 1))
    create_win = rng.integers(0, 500, (C, T + W)).astype(np.int32)
    create_win[rng.random((C, T + W)) < 0.2] = INT32_MAX
    phase = rng.integers(0, 7, (C, W)).astype(np.int32)
    row = int(rng.integers(0, C))
    for c in range(C):
        run = s0 if c == row else int(rng.integers(s0, W + 1))
        for j in range(run):  # terminal, or EMPTY with no create event
            if rng.random() < 0.5:
                phase[c, j] = rng.integers(4, 7)
            else:
                phase[c, j] = 0
                create_win[c, base + j] = INT32_MAX
        if run < W:  # live, or EMPTY with its create event pending
            if rng.random() < 0.5:
                phase[c, run] = rng.integers(1, 4)
            else:
                phase[c, run] = 0
                create_win[c, base + run] = int(rng.integers(0, 500))
    return phase, create_win, base


@pytest.mark.parametrize("W", [1, 2, 3, 8, 64, 512])
def test_slide_primitives_match_the_reference(W):
    rng = np.random.default_rng(W)
    C, ring, T = 3, 5, 2 * W + 7
    P = W + ring
    shifts = np.arange(W + 1, dtype=np.int32)
    got = quantize_shift(torch.from_numpy(shifts), W).numpy()
    assert np.array_equal(got, np.asarray(_quantize_shift_device(jnp.asarray(shifts), W)))

    apply_ref = jax.jit(_slide_apply_traced, static_argnames=("W",))
    for s0 in range(W + 1):
        phase, create_win, base = _shift_case(rng, C, W, T, s0)
        want = int(_slide_shift_device(jnp.asarray(phase), jnp.asarray(create_win), jnp.int32(base)))
        got = slide_shift_core(torch.from_numpy(phase), torch.from_numpy(create_win), torch.tensor(base, dtype=torch.int32))
        assert got.dtype == torch.int32 and int(got) == want == s0

        flat = _random_pods(rng, C, P)
        pay = {
            "req_cpu": rng.integers(0, 9000, (C, T + W)).astype(np.int32),
            "req_ram": rng.integers(0, 9000, (C, T + W)).astype(np.int32),
            "dur_win": rng.integers(-1, 50, (C, T + W)).astype(np.int32),
            "dur_off": rng.uniform(0, 10, (C, T + W)).astype(np.float32),
            "create_win": create_win,
            "rank": rng.integers(0, 1 << 30, (C, T + W)).astype(np.int32),
        }
        rank = rng.integers(0, 1 << 30, (C, P)).astype(np.int32)
        jpods, jrank = apply_ref(
            _jax_pods(flat), jnp.asarray(rank), {k: jnp.asarray(v) for k, v in pay.items()},
            jnp.int32(base), jnp.int32(s0), W=W,
        )
        ppods, prank = slide_apply(
            unflatten(PodArrays, {k: torch.from_numpy(v) for k, v in flat.items()}),
            torch.from_numpy(rank), {k: torch.from_numpy(v) for k, v in pay.items()},
            torch.tensor(base, dtype=torch.int32), torch.tensor(s0, dtype=torch.int32), W,
        )
        jflat = {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(jpods)[0]}
        pflat = {k: v.numpy() for k, v in flatten(ppods).items()}
        assert [k for k in _POD_PATHS if not np.array_equal(jflat[k], pflat[k])] == [], s0
        assert np.array_equal(np.asarray(jrank), prank.numpy())


# --- (b)-(f) sliding runs against the reference's sliding engine ------------------


def growth_yaml(n_pods=200, duration=600.0):
    """(cluster, workload) YAML of tests/test_pod_window_growth.py: four
    16 000 mCPU / 32 GiB nodes, one pod a second, each running long
    enough that ~n_pods are live at once before the first one finishes."""
    cluster = "events:" + "".join(
        f"""
- timestamp: 0.0
  event_type:
    !CreateNode
      node:
        metadata: {{name: gen_node_{i}}}
        status: {{capacity: {{cpu: 16000, ram: 34359738368}}}}"""
        for i in range(4)
    )
    workload = "events:" + "".join(
        f"""
- timestamp: {1 + i}
  event_type:
    !CreatePod
      pod:
        metadata: {{name: pod_{i:04d}}}
        spec:
          resources:
            requests: {{cpu: 10, ram: 10485760}}
            limits: {{cpu: 10, ram: 10485760}}
          running_duration: {duration}"""
        for i in range(n_pods)
    )
    return cluster, workload


_CHURN = churn_yaml(3)
_GROWTH = growth_yaml()
# name: (config, trace, clusters, K, pod_window, until, what the window does)
CASES = {
    "poisson": (BENCH_CONFIG, TraceSpec(n_nodes=16, poisson=dict(POISSON, rate_per_second=1.0, horizon=1000.0)),
                2, 32, 160, 1100.0, "slides"),
    "growth": (DELAYS, TraceSpec(cluster_yaml=_GROWTH[0], workload_yaml=_GROWTH[1]), 3, 16, 64, 1200.0, "grows"),
    "composed": (TOY.config_yaml, TOY, 2, 8, 8, 400.0, "both"),
    "node_removal": (DELAYS, TraceSpec(cluster_yaml=_CHURN[0], workload_yaml=_CHURN[1]), 4, 8, 8, 400.0, "both"),
}


def _jax_sliding(name, path="xla", monkeypatch=None):
    config, spec, C, K, W, _, _ = CASES[name]
    kwargs = {"reclaim": False} if spec is TOY else {}
    return build_jax_engine(config, spec, C, K, path, monkeypatch, pod_window=W, **kwargs)


def _port(name, **kwargs):
    config, spec, C, K, W, _, _ = CASES[name]
    return build_port_engine(config, spec, C, K, pod_window=W, **kwargs)


def _check_sliding_run(name, jx, port):
    """The port's sliding run equals the reference's state and its own
    whole-resident run's counters, and its window did what the case is
    for."""
    config, spec, C, K, W, until, does = CASES[name]
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []
    assert (port.pod_window, port._pod_base) == (jx.pod_window, jx._pod_base)
    stats = port.dispatch_stats
    assert {"slides": stats["slides"] > 0, "grows": stats["grows"] > 0} == {
        "slides": {"slides": True, "grows": False, "both": True}[does],
        "grows": {"slides": False, "grows": True, "both": True}[does],
    }
    whole = build_port_engine(config, spec, C, K)
    whole.step_until_time(until)
    counters = port.metrics_summary()["counters"]
    assert counters == whole.metrics_summary()["counters"] and counters["scheduling_decisions"] > 0
    return counters


@pytest.mark.parametrize("name, path", [
    ("poisson", "xla"), ("poisson", "megakernel"), ("growth", "xla"), ("composed", "xla"), ("node_removal", "xla"),
])
def test_sliding_run_matches_the_reference(monkeypatch, name, path):
    until = CASES[name][5]
    jx = _jax_sliding(name, path, monkeypatch)
    jx.step_until_time(until)
    port = _port(name)
    if path == "megakernel":
        port.cycle_route = "megakernel"
        assert jx.megakernel_calls[0] >= 1
    port.step_until_time(until)
    counters = _check_sliding_run(name, jx, port)
    if name == "growth":  # 64 -> 128 -> 200, the whole plain segment
        assert port.pod_window == 200 and port.dispatch_stats["grows"] == 2
        assert counters["pods_succeeded"] == 600
    if name == "composed":  # the HPA ring moved right with each growth
        assert port.hpa_seg[0] == port.pod_window and counters["total_scaled_up_pods"] > 0
        assert counters["total_scaled_up_nodes"] > 0
    if name == "node_removal":  # the reference keeps no name ranks here
        assert port.name_ranks is None and port.autoscale_statics is None


def test_install_state_mid_run_on_a_sliding_engine():
    """The reference's sliding state at t = 200 s (after a growth) carried
    into a fresh sliding port engine, then both run to 400 s."""
    jx = _jax_sliding("composed")
    jx.step_until_time(200.0)
    flat = jax_state_to_numpy(jx.state)
    port = _port("composed")
    assert port.pod_window < flat[".pods.phase"].shape[1]
    port.install_state(state_from_numpy(flat, "cpu"), jx.next_window_idx)
    assert (port.pod_window, port._pod_base) == (jx.pod_window, jx._pod_base) and port._pod_base > 0
    ranks = np.asarray(jx.autoscale_statics.pod_name_rank)
    assert np.array_equal(port.autoscale_statics.pod_name_rank.numpy(), ranks)
    jx.step_until_time(400.0)
    port.step_until_time(400.0)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(port.state)) == []


# --- the engine and the executor ----------------------------------------------------


def test_one_host_read_a_span_and_ranks_in_place():
    """Every span boundary reads the device once (a slide or a growth), the
    run reads nothing else; a slide writes the statics' rank tensor, which
    the executor's buffers and the end graphs share, in place."""
    sim = composed_sim("cpu", 2, pod_window=16)
    ranks = sim.autoscale_statics.pod_name_rank
    ptr = ranks.data_ptr()
    assert sim.name_ranks[1] is ranks and sim._executor.bufs.rank is ranks
    sim.step_until_time(110.0)
    stats = sim.dispatch_stats
    assert stats["slides"] > 0 and stats["grows"] == 0
    assert sim.host_syncs == stats["slides"] + stats["grows"]
    assert sim.autoscale_statics.pod_name_rank.data_ptr() == ptr
    T = sim.consts.trace_pod_bound
    window = sim._pod_name_rank_full[:, sim._pod_base : sim._pod_base + sim.pod_window]
    assert window.shape[1] == sim.pod_window
    assert np.array_equal(ranks.numpy(), np.concatenate([window, sim._pod_name_rank_full[:, T:]], axis=1))
    sim.step_until_time(400.0)
    assert stats["grows"] > 0 and sim.host_syncs == stats["slides"] + stats["grows"]
    sim.decisions_total()
    assert sim.host_syncs == stats["slides"] + stats["grows"] + 1


def test_a_growth_rebuilds_the_buffers_and_keeps_k():
    sim = _port("growth")
    K, bufs = sim.max_pods_per_cycle, sim._executor.bufs
    assert (K, sim.n_pods, bufs.state.pods.phase.shape[1]) == (16, 64, 64)
    sim.step_until_time(100.0)
    new = sim._executor.bufs
    assert sim.dispatch_stats["grows"] == 1 and sim.pod_window == 128
    assert new is not bufs and new.state is sim.state and new.acc.pod_create.shape == (3, 128)
    assert sim.max_pods_per_cycle == K and sim.consts.resident_shift == 200 - 128
    assert sim._slide_payload["req_cpu"].shape == (3, 200 + 128)


def test_the_payload_budget_and_graphs_on_the_cpu_raise(monkeypatch):
    """graphs=True on the CPU raises; a whole-trace payload over the
    device budget no longer does: the slide then refills from bounded
    stages built on the engine's thread (the stream feeder without its
    thread), at the build and from a growth on, and the run equals the
    in-budget run."""
    with pytest.raises(ValueError, match="graphs=True needs the card"):
        _port("growth", graphs=True)
    until = CASES["growth"][5]
    whole = _port("growth")
    whole.step_until_time(until)
    want = state_to_numpy(whole.state)
    assert whole._slide_payload is not None and whole.dispatch_stats["stage_refills"] == 0
    C, T = 3, 200
    # Over the budget at W = 64 already, and only from the growth to 128.
    for budget, bounded_from in ((C * (T + 64) * 4 * 5 - 1, 64), (C * (T + 64) * 4 * 5, 128)):
        monkeypatch.setattr(engine_mod, "SLIDE_PAYLOAD_BUDGET_BYTES", budget)
        sim = _port("growth")
        assert (sim._slide_payload is None) == (bounded_from == 64)
        sim.step_until_time(until)
        assert sim._slide_payload is None and sim.pod_window == 200
        assert compare_states(want, state_to_numpy(sim.state)) == []
        stats = sim.dispatch_stats
        assert stats["stage_refills"] > 0 and stats["feeder_slabs_produced"] >= stats["stage_refills"]
        assert sim.telemetry_report()["feeder"]["threaded"] is False
        assert (stats["slides"], stats["grows"], sim.host_syncs) == (
            whole.dispatch_stats["slides"], whole.dispatch_stats["grows"], whole.host_syncs)


def test_step_window_refuses_to_run_past_the_window():
    sim = _port("growth")
    while sim.next_window_idx <= sim._pod_capacity_window():
        sim.step_window()
    with pytest.raises(RuntimeError, match="beyond the sliding pod window"):
        sim.step_window()
    sim.step_until_time(sim.next_window + 10.0)
    assert sim.dispatch_stats["grows"] == 1


def test_cli_pod_window_matches_the_build_argument(tmp_path, capsys):
    cluster, workload = growth_yaml(120, 30.0)
    (tmp_path / "cluster.yaml").write_text(cluster)
    (tmp_path / "workload.yaml").write_text(workload)
    config_yaml = DELAYS + (
        "trace_config:\n  generic_trace:\n"
        f"    cluster_trace_path: {tmp_path / 'cluster.yaml'}\n"
        f"    workload_trace_path: {tmp_path / 'workload.yaml'}\n"
    )
    (tmp_path / "config.yaml").write_text(config_yaml)
    assert cli.main([
        "--config-file", str(tmp_path / "config.yaml"), "--device", "cpu", "--clusters", "2", "--pod-window", "32",
    ]) == 0
    got = json.loads(capsys.readouterr().out)
    sim = cli.build_batched_simulation(SimulationConfig.from_yaml(config_yaml), 2, device="cpu", pod_window=32)
    sim.run_to_completion()
    assert sim.dispatch_stats["slides"] > 0
    assert got == json.loads(render_metrics(sim.metrics_summary(), "json"))
    assert got["counters"]["pods_succeeded"] == 240


@pytest.mark.parametrize("build, until", [
    pytest.param(lambda g: composed_sim("cpu", 2, pod_window=8, graphs=g), 400.0, id="composed"),
    pytest.param(lambda g: _port("growth", graphs=g), 1200.0, id="growth"),
])
def test_stubbed_graph_run_across_slides_and_growths(counting_wrappers, build, until):  # noqa: F811
    """On the stubbed capture backend: the slide piece and the pieces
    captured again after each growth replay what an eager run does."""
    eager = build(False)
    reset_launches()
    eager.step_until_time(until)
    want = dict(LAUNCHES)
    sim = stub_graphs(build(False))
    captured = sim.precompile_pieces()
    assert sim._executor.slide_key() == ("slide", sim.pod_window, sim.pod_window + sim.consts.trace_pod_bound, -1)
    assert sim._executor.slide_key() in sim._executor.graphs
    reset_launches()
    sim.step_until_time(until)
    stats = sim.dispatch_stats
    assert stats["grows"] > 0 and stats["graph_windows"] == sim.windows_run
    assert stats["captures"] == captured * (1 + stats["grows"])
    assert sim._executor.slide_key() in sim._executor.graphs
    assert dict(LAUNCHES) == want and sum(want.values()) > 0
    assert sim.host_syncs == eager.host_syncs == stats["slides"] + stats["grows"]
    assert_bitwise_equal(sim.state, eager.state)
