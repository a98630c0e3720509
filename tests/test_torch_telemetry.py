"""The port's flight recorder (kubernetriks_tpu_torch/telemetry/, the
ring's record in step.py and graphs.py, the engine's readout) on the CPU,
against the JAX package's (the port of tests/test_telemetry.py where the
port has the mechanism).

- Telemetry on against off: every leaf but the ring equal
  (strip_telemetry, compare_states), host_syncs, dispatch_stats and
  next_window_idx equal.
- The ring's series lossless at telemetry_ring=16 (fewer windows than the
  run: the drains at step_until_time's exits and at the slides' reads
  keep it so), its decision deltas summing to the decisions counter.
- `telemetry_window_series()` equal to the JAX engine's bit for bit on
  four traces: the cheap pair; the composed line with the HPA and the CA
  through a sliding pod window, slot reclaim on both sides; a sparse
  trace fast-forwarded on both sides (the ring then holds the executed
  windows only); a fault config of tests/test_torch_chaos.py.
- The report's shape, the Chrome trace schema, no phantom export record
  from readout, uneven spans, the series cap, owned drained rows.
- On the stubbed capture backend (test_torch_executor) the record runs
  in the end piece, gated windows of the window-cost razor included, and
  the ring equals the uncaptured run's.
"""

import json

import numpy as np
import pytest

from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy

from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML  # noqa: E402
from test_chaos import FAULT_YAML  # noqa: E402
from test_telemetry import validate_chrome_trace  # noqa: E402
from test_torch_autoscale import TOY  # noqa: E402
from test_torch_chaos import RandomTraceSpec  # noqa: E402
from test_torch_executor import assert_bitwise_equal, stub_graphs  # noqa: E402
from test_torch_fast_forward import SparseSpec  # noqa: E402

from kubernetriks_tpu_torch.batched.state import compare_states, strip_telemetry
from kubernetriks_tpu_torch.convert import state_from_numpy, state_to_numpy
from kubernetriks_tpu_torch.metrics.render import render_telemetry
from kubernetriks_tpu_torch.telemetry.ring import RING_COLUMNS

ENDS = (150.0, 300.0, 450.0)


class CheapSpec:
    """The reference test's cheapest trace (tests/test_telemetry.py
    `_build_plain`): 8 nodes of 64 000 mCPU / 128 GiB, Poisson pods at 1/s
    for 400 s (seed 5, 4 000 mCPU, 4 GiB, 20-40 s), as each package's
    events."""

    def events(self, side: str):
        from kubernetriks_tpu.trace.generator import PoissonWorkloadTrace as JaxPoisson
        from kubernetriks_tpu.trace.generator import UniformClusterTrace as JaxUniform
        from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace

        uniform = JaxUniform if side == "jax" else UniformClusterTrace
        poisson = JaxPoisson if side == "jax" else PoissonWorkloadTrace
        return (
            uniform(8, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
            poisson(rate_per_second=1.0, horizon=400.0, seed=5, cpu=4000, ram=4 * 1024**3,
                    duration_range=(20.0, 40.0)).convert_to_simulator_events(),
        )


def _cheap(side="port", **kwargs):
    """The cheap trace on 2 clusters, K = 16, every window stepped."""
    kwargs.setdefault("fast_forward", False)
    if side == "jax":
        return build_jax_engine(DEFAULT_TEST_CONFIG_YAML, CheapSpec(), 2, 16, "xla", **kwargs)
    return build_port_engine(DEFAULT_TEST_CONFIG_YAML, CheapSpec(), 2, 16, **kwargs)


@pytest.fixture(scope="module")
def cheap_pair():
    """Telemetry on (ring 16, fewer windows than the run) and off, the
    port's engines stepped to ENDS."""
    on = _cheap(telemetry=True, telemetry_ring=16)
    off = _cheap()
    for end in ENDS:
        on.step_until_time(end)
        off.step_until_time(end)
    return on, off


def assert_on_equals_off(on, off):
    assert compare_states(state_to_numpy(strip_telemetry(on.state)), state_to_numpy(off.state)) == []
    assert on.host_syncs == off.host_syncs
    assert on.dispatch_stats == off.dispatch_stats
    assert on.next_window_idx == off.next_window_idx
    assert on.metrics_summary() == off.metrics_summary()


def assert_lossless(sim, executed):
    """One ring record an executed window, the decision deltas summing to
    the decisions counter."""
    wins, data = sim.telemetry_window_series()
    np.testing.assert_array_equal(wins, np.asarray(executed, dtype=np.int32))
    assert sim._ring_windows_recorded == len(executed)
    total = sim.metrics_summary()["counters"]["scheduling_decisions"]
    assert total > 0
    assert int(data[:, :, RING_COLUMNS.index("decisions")].sum()) == total
    return wins, data


def test_telemetry_on_is_bit_identical(cheap_pair):
    on, off = cheap_pair
    assert_on_equals_off(on, off)
    assert on.state.telemetry is not None and off.state.telemetry is None


def test_ring_series_is_lossless_and_matches_metrics(cheap_pair):
    on, _ = cheap_pair
    executed = on.next_window_idx
    assert executed > on._telemetry_ring_size  # the ring wrapped
    _, data = assert_lossless(on, range(executed))
    assert int(data[:, :, RING_COLUMNS.index("alive_nodes")].max()) > 0


# --- the ring against the JAX engine's, four traces ----------------------------


def _pair(config_yaml, spec, C, K, ends, **kwargs):
    """The JAX engine (XLA path) and the port, telemetry on, and the port
    with telemetry off, stepped to each of `ends`; returns (jax, on, off)."""
    jx = build_jax_engine(config_yaml, spec, C, K, "xla", telemetry=True, **kwargs)
    on = build_port_engine(config_yaml, spec, C, K, telemetry=True, **kwargs)
    off = build_port_engine(config_yaml, spec, C, K, **kwargs)
    for end in ends:
        for sim in (jx, on, off):
            sim.step_until_time(end)
    return jx, on, off


def assert_series_match(jx, on):
    wj, dj = jx.telemetry_window_series()
    wp, dp = on.telemetry_window_series()
    assert len(wp) > 0
    np.testing.assert_array_equal(wp, wj)
    assert dp.dtype == dj.dtype == np.int32
    np.testing.assert_array_equal(dp, dj)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(on.state)) == []


def test_cheap_series_matches_reference(cheap_pair):
    jx = _cheap("jax", telemetry=True, telemetry_ring=16)
    for end in ENDS:
        jx.step_until_time(end)
    assert_series_match(jx, cheap_pair[0])


def test_composed_series_through_a_sliding_window_with_reclaim_matches_reference():
    """HPA and CA through pod_window=8 (slides and growths), slot reclaim
    on both sides: the reserve columns move both ways."""
    jx, on, off = _pair(TOY.config_yaml, TOY, 2, 8, (200.0, 400.0, 600.0), pod_window=8, reclaim=True,
                        fast_forward=False)
    assert on.reclaim and jx.reclaim and on.dispatch_stats["slides"] > 0 and on.dispatch_stats["grows"] > 0
    assert_on_equals_off(on, off)
    assert_series_match(jx, on)
    wins, data = assert_lossless(on, range(on.next_window_idx))
    for col in ("hpa_pod_actions", "ca_node_actions", "hpa_reserve_used", "ca_reserve_used"):
        assert data[:, :, RING_COLUMNS.index(col)].max() > 0, col
    headroom = data[:, :, RING_COLUMNS.index("pod_headroom")]
    assert headroom.min() >= 0 and headroom.max() < 1 << 20  # bounded: the window slides


def test_sparse_fast_forward_series_matches_reference():
    """Both sides fast-forwarded: the ring holds the executed windows
    only, the catch-up records nothing."""
    jx, on, off = _pair(DEFAULT_TEST_CONFIG_YAML, SparseSpec(), 3, 8, (2000.0, 4000.0), fast_forward=True)
    stats = on.dispatch_stats
    assert on.fast_forward and stats["skipped_windows"] > 0
    assert_on_equals_off(on, off)
    assert_series_match(jx, on)
    wins, _ = on.telemetry_window_series()
    assert len(wins) == stats["executed_windows"] < on.next_window_idx


def test_fault_series_matches_reference():
    """tests/test_chaos.py's FAULT_YAML on its random trace, two clusters
    with their own crash chains: the fault column moves."""
    jx, on, off = _pair(DEFAULT_TEST_CONFIG_YAML + FAULT_YAML, RandomTraceSpec(101), 2, 64, (1500.0, 3000.0),
                        fast_forward=False)
    assert_on_equals_off(on, off)
    assert_series_match(jx, on)
    _, data = on.telemetry_window_series()
    assert data[:, :, RING_COLUMNS.index("fault_events")].sum() > 0


# --- readout ------------------------------------------------------------------


def test_telemetry_report_shape(cheap_pair):
    on, _ = cheap_pair
    rep = on.telemetry_report()
    assert rep["enabled"]
    assert rep["spans"]["window_chunk"]["count"] == len(ENDS)
    # Whole-resident and every window stepped: no read in the loop.
    assert rep["sync_budget"]["observed_slide_syncs"] == rep["sync_budget"]["steady_state_expected"] == 0
    assert rep["ring"]["windows_kept"] == rep["ring"]["windows_recorded"] == on.next_window_idx
    assert rep["ring"]["columns"] == list(RING_COLUMNS)
    assert rep["ring"]["totals"]["decisions"] == on.metrics_summary()["counters"]["scheduling_decisions"]
    assert rep["per_window"]["windows"] == on.next_window_idx and rep["per_window"]["ms_per_window"] > 0
    # The drains the stepping made (the port's own section): R = 16 is
    # smaller than the run, so they read every window but those the
    # readout drained, each once.
    drains = rep["ring_drains"]
    assert drains["drains"] > 0 and 0 < drains["windows"] <= on.next_window_idx
    assert drains["read_ms"] > 0 and drains["host_ms"] > 0
    assert on.telemetry_report()["ring_drains"]["windows"] == on.next_window_idx
    res = rep["resources"]
    assert res["watchdog"]["enabled"] and res["memory"]["rss_bytes"] > 0
    assert res["memory"]["slabs"]["telemetry_ring_bytes"] == 2 * 16 * 12 * 4 + 2 * 4
    table = render_telemetry(rep, "table")
    assert "window_chunk" in table and "Ring windows kept" in table and "Ring drains" in table
    json.loads(render_telemetry(rep, "json"))


def test_report_keys_match_reference(cheap_pair):
    """The report's sections are the reference's (less its feeder's), and
    the port's count of the ring's drains."""
    jx = _cheap("jax", telemetry=True, telemetry_ring=16)
    jx.step_until_time(150.0)
    ref, mine = jx.telemetry_report(), cheap_pair[0].telemetry_report()
    assert set(mine) == set(ref) - {"feeder", "stage_prefetch_hit_rate"} | {"ring_drains"}
    assert set(mine["ring"]) == set(ref["ring"])
    assert set(mine["resources"]) == set(ref["resources"])
    assert set(mine["resources"]["watchdog"]) == set(ref["resources"]["watchdog"])


def test_chrome_trace_schema(cheap_pair, tmp_path):
    on, _ = cheap_pair
    path = on.write_chrome_trace(str(tmp_path / "trace.json"))
    validate_chrome_trace(path, expect_flows=False)


def test_annotated_spans_show_in_the_profiler():
    """With `annotate` set (profile_main_path.py's traced windows), the
    engine's spans open record_function scopes named after their phase,
    which torch.profiler lists; without it they open none, and the tracer
    records the spans either way."""
    from torch.profiler import ProfilerActivity, profile

    sim = _cheap(telemetry=True, telemetry_ring=16)
    for annotate in (False, True):
        sim.tracer.annotate = annotate
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sim.step_until_time(sim.next_window + 20.0)
        keys = {e.key for e in prof.key_averages()}
        assert ("window_chunk" in keys) == annotate, sorted(keys)[:20]
    assert sim.tracer.report()["spans"]["window_chunk"]["count"] == 2


def test_readout_does_not_emit_phantom_export_records():
    sim = _cheap(telemetry=True, telemetry_ring=16)
    records = []

    class _Recorder:
        def emit(self, record):
            records.append(record)

    sim.attach_metrics_exporter(_Recorder())
    sim.step_until_time(150.0)
    sim.telemetry_window_series()
    n = len(records)
    assert n > 0 and all(r["fresh_windows"] > 0 for r in records)
    for _ in range(3):
        sim.telemetry_report()
    assert len(records) == n


def test_ring_drain_handles_uneven_spans():
    """A short call below the exit drain's threshold, then a call long
    enough to wrap past its rows: the entry guard drains first."""
    sim = _cheap(telemetry=True, telemetry_ring=16)
    sim.step_until_time(60.0)  # 7 windows
    sim.step_until_time(180.0)  # 12 more
    assert_lossless(sim, range(sim.next_window_idx))


def test_series_cap_bounds_host_memory_and_discloses():
    sim = _cheap(telemetry=True, telemetry_ring=16)
    sim.telemetry_series_windows = 10
    for end in ENDS:
        sim.step_until_time(end)
    wins, _ = sim.telemetry_window_series()
    assert len(wins) <= 10 and wins[-1] == sim.next_window_idx - 1
    rep = sim.telemetry_report()
    assert rep["ring"]["series_dropped_windows"] > 0 and rep["ring"]["windows_kept"] <= 10


def test_drained_rows_survive_later_windows():
    """drain_telemetry's rows are owned copies: later windows write the
    ring in place and leave them as they were."""
    sim = build_port_engine(TOY.config_yaml, TOY, 2, 8, telemetry=True, telemetry_ring=16, pod_window=8)
    sim.step_until_time(120.0)
    rec = sim.drain_telemetry()
    assert rec and rec["window"] == sim.next_window_idx - 1
    assert "occupancy" in rec and "resources" in rec
    wins0, data0 = sim.telemetry_window_series()
    snap = data0.copy()
    sim.step_until_time(400.0)
    wins1, data1 = sim.telemetry_window_series()
    np.testing.assert_array_equal(wins1[: len(wins0)], wins0)
    np.testing.assert_array_equal(data1[: len(wins0)], snap)
    off = _cheap()
    assert off.drain_telemetry() == {}
    assert off.telemetry_report()["enabled"] is False


def test_arming_rules(monkeypatch):
    """telemetry= and watchdog= as the reference decides them: the
    watchdog rides the recorder, KTPU_TRACE / KTPU_WATCHDOG where the
    arguments are None, and an armed watchdog without the recorder
    raises."""
    with pytest.raises(ValueError, match="watchdog=True requires the flight recorder"):
        _cheap(watchdog=True)
    sim = _cheap(telemetry=True)
    assert sim._watchdog and sim.observatory.watchdog
    assert not _cheap(telemetry=True, watchdog=False)._watchdog
    monkeypatch.setenv("KTPU_TRACE", "1")
    sim = _cheap()
    assert sim.state.telemetry is not None and sim._watchdog
    monkeypatch.setenv("KTPU_WATCHDOG", "0")
    assert not _cheap()._watchdog
    monkeypatch.setenv("KTPU_TRACE", "0")
    monkeypatch.setenv("KTPU_WATCHDOG", "1")
    with pytest.raises(ValueError, match="watchdog=True requires"):
        _cheap()
    monkeypatch.delenv("KTPU_WATCHDOG")
    assert _cheap().state.telemetry is None
    with pytest.raises(ValueError, match="telemetry is off"):
        _cheap().attach_metrics_exporter(object())


def test_install_state_carries_the_ring():
    """A telemetry-on state installs into a telemetry-on engine, whose
    series then continues from the installed ring; a mismatch raises."""
    ahead = _cheap(telemetry=True)
    ahead.step_until_time(200.0)
    flat = state_to_numpy(ahead.state)
    sim = _cheap(telemetry=True)
    sim.install_state(state_from_numpy(flat, "cpu"), ahead.next_window_idx)
    for s in (ahead, sim):
        s.step_until_time(400.0)
    assert_bitwise_equal(ahead.state, sim.state)
    wa, da = ahead.telemetry_window_series()
    wb, db = sim.telemetry_window_series()
    np.testing.assert_array_equal(wb, wa)
    np.testing.assert_array_equal(db, da)
    with pytest.raises(ValueError, match="telemetry ring mismatch"):
        _cheap().install_state(state_from_numpy(flat, "cpu"), ahead.next_window_idx)


@pytest.mark.parametrize("razor", [False, True])
def test_stubbed_graph_run_records_every_window(razor):
    """On the stubbed capture backend the record runs in the end graph,
    outside the razor's conditional node: a gated window records too, and
    the ring and every other leaf equal the uncaptured run's (razor off),
    with the same reads and no replay added."""
    spec = SparseSpec(rate=0.05, horizon=1500.0, seed=23)

    def build(**kwargs):
        return build_port_engine(DEFAULT_TEST_CONFIG_YAML, spec, 2, 8, fast_forward=False, telemetry=True, **kwargs)

    plain = build()
    plain.step_until_time(1500.0)
    sim = stub_graphs(build(window_razor=razor))
    off = stub_graphs(build_port_engine(DEFAULT_TEST_CONFIG_YAML, spec, 2, 8, fast_forward=False,
                                        window_razor=razor))
    for s in (sim, off):
        s.precompile_pieces()
        s.step_until_time(1500.0)
    gated = [k for k in sim._executor.graphs if "gate" in k]
    assert bool(gated) == razor
    if razor:
        assert sim._executor.backend.bodies[False] > 0  # gated tails skipped
    assert_bitwise_equal(sim.state, plain.state)
    assert sim.dispatch_stats == off.dispatch_stats and sim.host_syncs == off.host_syncs
    assert_lossless(sim, range(sim.next_window_idx))
