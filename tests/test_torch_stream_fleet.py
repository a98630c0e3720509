"""A streaming pod-window scenario fleet re-seeks its feeder at every wave
boundary into the ring it already has: the slots keep their addresses, so
their slide graphs stay valid and nothing is captured after the first
wave. On the stubbed capture backend (test_torch_executor.py) under
KTPU_EXPLAIN_RECOMPILES=1, four waves raise nothing, and the results equal
the same fleet unstreamed and uncaptured (exact: FleetResult fields).

A producer that outlives a re-seek's join (stalled mid-build past a short
timeout) may still upload into the ring it was given: the ring goes with
it, the next wave builds and captures a new one, and the results still
equal the unstreamed fleet's."""

import threading

import pytest

from test_torch_executor import stub_graphs
from test_torch_fleet import _same

from chip_smoke import composed_config_yaml, composed_workload_yaml

from kubernetriks_tpu_torch.batched.fleet import Scenario, ScenarioFleet
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

# chip_smoke.composed_sim's line at C = 3 lanes through a 32-slot pod
# window, which no wave grows (52 plain slots, 6 slides a wave); slabs of
# 56 columns make a ring of 3 slots. Query 0 runs alone in the first wave,
# then the other seven in three waves, repeating the scenarios in other
# lanes.
STREAM_KW = dict(n_lanes=3, horizon=400.0, max_pods_per_cycle=8, fast_forward=False, pod_window=32)
SCENS = [dict(hpa_scan_interval=30.0), dict(ca_threshold=0.7), dict(hpa_tolerance=0.25), dict()]
QUERIES = [Scenario(**s) for s in SCENS] * 2


def composed_events():
    cluster = UniformClusterTrace(4, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events()
    plain = PoissonWorkloadTrace(
        rate_per_second=0.2, horizon=300.0, seed=3, cpu=16000, ram=32 * 1024**3, duration_range=(30.0, 120.0),
        name_prefix="plain",
    ).convert_to_simulator_events()
    group = GenericWorkloadTrace.from_yaml(composed_workload_yaml(16, (90.0, 90.0, 120.0))).convert_to_simulator_events()
    return cluster, sorted(plain + group, key=lambda e: e[0])


@pytest.fixture
def stubbed_builds(monkeypatch):
    from kubernetriks_tpu_torch.batched import engine as engine_mod

    real = engine_mod.BatchedSimulation.precompile_pieces

    def stubbed(sim):
        if sim._executor.backend is None:
            stub_graphs(sim)
        return real(sim)

    monkeypatch.setattr(engine_mod.BatchedSimulation, "precompile_pieces", stubbed)
    return real


def test_streaming_pod_window_fleet_captures_nothing_after_wave_one(monkeypatch, stubbed_builds):
    monkeypatch.setenv("KTPU_EXPLAIN_RECOMPILES", "1")
    config = SimulationConfig.from_yaml(composed_config_yaml(4))
    f = ScenarioFleet(config, *composed_events(), device="cpu", stream=True, stream_segment=56, **STREAM_KW)
    try:
        eng = f.engine
        assert eng._stream_on() and eng.graphs and f._sentinel is not None
        assert eng._feeder_uploads.depth == 3
        f.submit(QUERIES[0])
        f.run()
        after_one = eng.dispatch_stats["captures"]
        ring = eng._feeder_uploads
        slots = [s.req_cpu.data_ptr() for s in ring.slots]
        slides = sorted(k for k in eng._executor.graphs if k[0] == "slide")
        assert slides, "the first wave captured no slide graph"
        for q in QUERIES[1:]:
            f.submit(q)
        res = f.run()
        assert f.waves_run == 1 + -(-(len(QUERIES) - 1) // 3)
        assert eng.dispatch_stats["slides"] > 0 and eng.dispatch_stats["stage_refills"] > 1
        assert eng.dispatch_stats["grows"] == 0
        # Every wave after the first replayed: no capture, same ring, same
        # slide graphs on the same slots.
        assert eng.dispatch_stats["captures"] == after_one
        assert f._sentinel.post_seal_events() == []
        assert eng._feeder_uploads is ring and [s.req_cpu.data_ptr() for s in ring.slots] == slots
        assert sorted(k for k in eng._executor.graphs if k[0] == "slide") == slides
    finally:
        f.close()
    monkeypatch.delenv("KTPU_EXPLAIN_RECOMPILES")
    monkeypatch.setattr(
        __import__("kubernetriks_tpu_torch.batched.engine", fromlist=["x"]).BatchedSimulation,
        "precompile_pieces", stubbed_builds,
    )
    want = _plain_results(config)
    assert sorted(res) == sorted(want) == list(range(len(QUERIES)))
    assert all(_same(res[q], want[q]) for q in res)


def _plain_results(config):
    plain = ScenarioFleet(config, *composed_events(), device="cpu", stream=False, **STREAM_KW)
    try:
        for q in QUERIES:
            plain.submit(q)
        return plain.run()
    finally:
        plain.close()


def test_a_producer_that_outlives_the_reseek_join_takes_the_ring_with_it(monkeypatch, stubbed_builds):
    config = SimulationConfig.from_yaml(composed_config_yaml(4))
    f = ScenarioFleet(config, *composed_events(), device="cpu", stream=True, stream_segment=56, **STREAM_KW)
    try:
        eng = f.engine
        f.submit(QUERIES[0])
        f.run()
        ring = eng._feeder_uploads
        entered, release = threading.Event(), threading.Event()
        real_stage, real_close = eng._stage_arrays, type(eng).close

        def stalled(lo, width):
            if not entered.is_set():
                entered.set()
                release.wait(60.0)
            return real_stage(lo, width)

        # A wave boundary's re-seek (the ring kept), whose producer is
        # then held in its first build.
        monkeypatch.setattr(eng, "_stage_arrays", stalled)
        eng._rewind_host()
        assert eng._feeder_uploads is ring and entered.wait(30.0)
        held, uploads = eng._feeder._thread, ring._next
        # The next wave's re-seek joins it with a short timeout.
        monkeypatch.setattr(eng, "close", lambda timeout=30.0, keep_ring=False: real_close(eng, 0.05, keep_ring))
        for q in QUERIES[1:]:
            f.submit(q)
        try:
            res = f.run()
        finally:
            release.set()
        held.join(30.0)
        assert not held.is_alive()
        # The ring went with the producer that outlived the join: the held
        # build's upload landed in it alone, and the waves ran on a new one.
        assert ring._next == uploads + 1
        assert eng._feeder_uploads is not None and eng._feeder_uploads is not ring
    finally:
        f.close()
    want = _plain_results(config)
    assert sorted(res) == sorted(want) == list(range(len(QUERIES)))
    assert all(_same(res[q], want[q]) for q in res)
