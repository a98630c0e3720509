"""The lane-asynchronous scenario fleet of the port (kubernetriks_tpu_torch/
batched/fleet.py pump / run_async and the engine's lane clocks) on the
CPU, against the JAX package's `ScenarioFleet(lane_async=True)` on its XLA
path (use_pallas=False), on the composed line with faults and the
reference's five-query, three-lane stream (tests/test_fleet_async.py:
54-61), the pattern of tests/test_fleet_async.py and the lane-asynchronous
cases of tests/test_fleet_faults.py.

1. Every FleetResult (counters, hpa_replicas, ca_nodes, lane, round),
   the occupancy ledger (lane_busy_windows, lane_total_windows) and
   pump_rounds equal the JAX fleet's.
2. A lane-asynchronous result equals the port's wave-aligned result for
   the same query; the permuted stream gives bit-identical results; on
   the stubbed capture backend nothing is captured after the build, and
   the results equal the eager fleet's.
3. After fixed numbers of pump rounds (lanes mid-flight; lanes parked
   once the queue ran dry) the port's state equals the JAX engine's
   under compare_states, the telemetry ring with its lane column
   included, and so do the lane clocks.
4. The LaneTraceMux masks the rows JAX's masks and refuses a re-offer to
   a lane in flight; a query with trace_rows= gives JAX's result.
5. HostChaos's dispatch and stall schedules equal JAX's over 200 draws;
   under a scripted injector the quarantine, probe and re-admission
   sequence, lane_states() each round and fault_report() equal JAX's, and
   every query id streams one outcome.
6. The build guards raise (no scenario, a pod window, the stream feeder),
   and so do the lane calls on an engine without lane clocks.
7. A checkpoint carries the lane clocks and their host mirrors.

Both fleets pump spans of 2 windows with telemetry on (the JAX fleet
compiles its window program in 2 x 2 variants; its jit cache serves the
later JAX fleets of this module). Tolerance: compare_states (every leaf exact but float32
metric accumulators, rtol 1e-6); results exactly.
"""

import numpy as np
import pytest

from test_fleet_faults import ScriptedInjector
from test_torch_executor import stub_graphs
from test_torch_fleet import CHAOS_YAML, composed_events
from test_torch_reference import jax_state_to_numpy

from kubernetriks_tpu.batched import fleet as jax_fleet
from kubernetriks_tpu.batched import stream as jax_stream
from kubernetriks_tpu.batched.faults import HostChaos as JaxHostChaos
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
from kubernetriks_tpu_torch.batched.faults import DeadlineExceededError, HostChaos, LaneFaultError
from kubernetriks_tpu_torch.batched.fleet import Scenario, ScenarioFleet, scenario_vectors
from kubernetriks_tpu_torch.batched.state import TELEM_LANE_ACTIVE, compare_states, flatten
from kubernetriks_tpu_torch.batched.stream import LaneTraceMux
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_to_numpy

# tests/test_fleet_async.py:54-61: scenario 0 == scenario 3; five queries
# over three lanes force a re-seed mid-flight; the 150 s query finishes
# its lane ~3x earlier than its neighbours.
SCENS = [
    (dict(fault_seed=11, hpa_scan_interval=30.0), 450.0),
    (dict(fault_seed=22, ca_threshold=0.7), 250.0),
    (dict(fault_seed=33, hpa_tolerance=0.25), 350.0),
    (dict(fault_seed=11, hpa_scan_interval=30.0), 450.0),
    (dict(fault_seed=44), 150.0),
]
SPAN = 2
FLEET_KW = dict(n_lanes=3, horizon=450.0, max_pods_per_cycle=16, ca_slot_multiplier=4, span_windows=SPAN)
# Rounds after which the states are compared: lanes mid-flight (and one
# re-seeded), then the queue dry with lanes parked.
CHECK_ROUNDS = (5, 30)


def port_fleet(lane_async=True, **kw):
    return ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu",
                         lane_async=lane_async, **{**FLEET_KW, **kw})


def jax_async_fleet(**kw):
    return jax_fleet.ScenarioFleet(JaxConfig.from_yaml(CHAOS_YAML), *composed_events("jax"), use_pallas=False,
                                   lane_async=True, **{**FLEET_KW, **kw})


def submit_all(fleet, scen_cls, order=range(len(SCENS))):
    return [fleet.submit(scen_cls(**SCENS[i][0]), SCENS[i][1]) for i in order]


def _same(a, b) -> bool:
    return (a.counters, a.hpa_replicas, a.ca_nodes) == (b.counters, b.hpa_replicas, b.ca_nodes)


@pytest.fixture(scope="module")
def runs():
    """The JAX and the port lane-asynchronous fleets (telemetry on) pumped
    round by round over SCENS, their states compared at CHECK_ROUNDS."""
    jf = jax_async_fleet(telemetry=True)
    pf = port_fleet(telemetry=True)
    jq, pq = submit_all(jf, jax_fleet.Scenario), submit_all(pf, Scenario)
    states = {}
    while jf.pending or jf._active:
        jf.pump()
        pf.pump()
        if pf.pump_rounds in CHECK_ROUNDS:
            states[pf.pump_rounds] = (
                jax_state_to_numpy(jf.engine.state), state_to_numpy(pf.engine.state),
                (jf.engine._lane_clock_np.copy(), jf.engine._lane_horizon_np.copy(), jf.engine.next_window_idx),
                (pf.engine._lane_clock_np.copy(), pf.engine._lane_horizon_np.copy(), pf.engine.next_window_idx),
                (pf.lane_states(), sorted(pf._active)),
            )
    assert not (pf.pending or pf._active), "the port's fleet outlived the JAX fleet's rounds"
    yield jf, jq, pf, pq, states
    jf.close()
    pf.close()


# --- 1. results and ledgers against the JAX fleet ------------------------------------


def test_results_and_ledgers_equal_the_reference_fleet(runs):
    jf, jq, pf, pq, _ = runs
    faults = 0
    for i, (a, b) in enumerate(zip(pq, jq)):
        mine, ref = pf.results[a], jf.results[b]
        assert mine.ok and _same(mine, ref), f"query {i}: {mine.counters} vs {ref.counters}"
        assert (mine.lane, mine.wave, mine.horizon) == (ref.lane, ref.wave, ref.horizon)
        faults += mine.counters["pod_restarts"] + mine.counters["node_crashes"]
    assert faults > 0, "the chaos stream showed no fault"
    assert pf.pump_rounds == jf.pump_rounds
    np.testing.assert_array_equal(pf.lane_busy_windows, jf.lane_busy_windows)
    np.testing.assert_array_equal(pf.lane_total_windows, jf.lane_total_windows)
    assert pf.lane_occupancy() == jf.lane_occupancy()
    # A lane was re-seeded mid-flight and the duplicate (0 == 3) repeats.
    assert len({pf.results[q].lane for q in pq}) == 3 and _same(pf.results[pq[0]], pf.results[pq[3]])


def test_poll_latency_and_lifecycle(runs):
    """poll() streams each query once; each completed query has a latency
    sample; its lifecycle stages are in order; the observatory heard every
    query."""
    _, _, pf, pq, _ = runs
    assert sorted(r.query for r in pf.poll()) == sorted(pq) and pf.poll() == []
    lat = pf.query_latency_percentiles()
    assert lat["count"] == len(pq) and 0.0 < lat["p50_ms"] <= lat["p99_ms"]
    assert pf.query_latency_breakdown()["histogram"]["count"] == len(pq)
    for q in pq:
        rec = pf.query_lifecycle(q)
        assert rec["submitted_ns"] <= rec["admitted_ns"] <= rec["first_dispatch_ns"] <= rec["drained_ns"]
        assert rec["drained_ns"] <= rec["polled_ns"] and rec["lane"] >= 0
    assert pf.engine.observatory._lat_hist.count == len(pq)
    with pytest.raises(KeyError, match=r"poll\(9999\).*never submitted.*in-flight qids"):
        pf.poll(9999)


# --- 2. against the wave-aligned path, permuted, captured ------------------------------


def test_async_equals_wave_and_the_permuted_stream(runs):
    _, _, pf, pq, _ = runs
    wave = port_fleet(lane_async=False)
    wq = submit_all(wave, Scenario)
    wave.run()
    for i, (a, b) in enumerate(zip(pq, wq)):
        assert _same(pf.results[a], wave.results[b]), f"query {i}: async != wave"
    wave.close()
    perm = [4, 2, 3, 0, 1]
    permuted = port_fleet()
    qp = submit_all(permuted, Scenario, perm)
    permuted.run_async()
    for j, i in enumerate(perm):
        assert _same(permuted.results[qp[j]], pf.results[pq[i]]), f"scenario {i} differs when permuted"
    assert [permuted.results[q].lane for q in qp] != [pf.results[pq[i]].lane for i in perm]
    permuted.close()


def test_no_capture_after_the_build_on_the_stub_backend(runs, monkeypatch):
    """The fleet captures both freeze variants of its pieces at build; the
    pump rounds, lane resets, plans and trace installs replay them, and
    the results equal the eager fleet's."""
    from kubernetriks_tpu_torch.batched import engine as engine_mod

    _, _, pf, pq, _ = runs
    real = engine_mod.BatchedSimulation.precompile_pieces

    def stubbed(sim):
        if sim._executor.backend is None:
            stub_graphs(sim)
        return real(sim)

    monkeypatch.setattr(engine_mod.BatchedSimulation, "precompile_pieces", stubbed)
    f = port_fleet()
    captured = f.engine.dispatch_stats["captures"]
    keys = set(f.engine._executor.graphs)
    assert ("lanes",) in keys and ("lanes", "freeze") in keys and any(k[-1] == "freeze" for k in keys if k[0] == "end")
    qids = submit_all(f, Scenario)
    f.run_async()
    stats = f.engine.dispatch_stats
    assert stats["captures"] == captured and stats["eager_windows"] == 0 and stats["graph_windows"] > 0
    for a, b in zip(qids, pq):
        assert _same(f.results[a], pf.results[b])
    f.close()


# --- 3. mid-flight states ------------------------------------------------------------------


@pytest.mark.parametrize("at", CHECK_ROUNDS)
def test_mid_flight_state_equals_the_reference(runs, at):
    _, _, _, _, states = runs
    ref, mine, ref_clocks, my_clocks, (lanes, active) = states[at]
    assert compare_states(ref, mine) == []
    np.testing.assert_array_equal(ref_clocks[0], my_clocks[0])
    np.testing.assert_array_equal(ref_clocks[1], my_clocks[1])
    assert ref_clocks[2] == my_clocks[2]
    col = mine[".telemetry.buf"][..., TELEM_LANE_ACTIVE]
    if at == CHECK_ROUNDS[0]:
        assert lanes == ["active"] * 3
    else:
        # The queue ran dry: parked lanes record zero in the lane column.
        assert len(active) < 3 and (col == 0).any()
    assert (col == 1).any()


# --- 4. the trace multiplexer -----------------------------------------------------------------


def test_lane_trace_mux_masks_the_reference_rows(runs):
    _, _, pf, _, _ = runs
    packed = pf.engine._lane_mux._base
    mine, ref = LaneTraceMux(packed), jax_stream.LaneTraceMux(packed)
    E = mine.n_rows
    for lane, (lo, hi) in enumerate([(0, E // 2), (E // 3, None), (5, 6)]):
        a, b = mine.offer(lane, lo, hi), ref.offer(lane, lo, hi)
        np.testing.assert_array_equal(a, b)
        assert (a[:, 2] == 0).any()  # EV_NONE rows: the mask bites
        with pytest.raises(RuntimeError, match="flying"):
            mine.offer(lane, lo, hi)
    mine.retire([0])
    ref.retire([0])
    assert mine.offer(0, 0, E // 2) is None and ref.offer(0, 0, E // 2) is None  # installed already
    assert mine.report() == ref.report()


def test_trace_rows_query_equals_the_reference(runs):
    jf, _, pf, pq, _ = runs
    E = pf.engine._lane_mux.n_rows
    scen = SCENS[0][0]
    mq = pf.submit(Scenario(**scen), 300.0, trace_rows=(0, E // 2))
    jq = jf.submit(jax_fleet.Scenario(**scen), 300.0, trace_rows=(0, E // 2))
    full = pf.submit(Scenario(**scen), 300.0)
    pf.run_async()
    jf.run_async()
    assert _same(pf.results[mq], jf.results[jq])
    assert pf.results[mq].counters != pf.results[full].counters, "the row range did not bite"
    with pytest.raises(ValueError, match="lo < hi"):
        pf.submit(Scenario(), 100.0, trace_rows=(4, 2))
    # A lane in flight refuses a new range.
    pf.submit(Scenario(**scen), 300.0)
    pf.pump()
    lane = next(iter(pf._active))
    with pytest.raises(RuntimeError, match="flying"):
        pf.engine.set_lane_trace(lane, 0, E // 2)
    pf.run_async()
    pf.poll()
    jf.poll()


# --- 5. host chaos and quarantine ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 12])
def test_host_chaos_schedules_equal_the_reference(seed):
    kw = dict(dispatch_rate=0.3, stall_rate=0.2, stall_ms=1.5)
    mine, ref = HostChaos(seed, **kw), JaxHostChaos(seed, **kw)
    active = [0, 1, 2, 3]
    got = [(mine.dispatch_fault(active), mine.stall_s()) for _ in range(200)]
    want = [(ref.dispatch_fault(active), ref.stall_s()) for _ in range(200)]
    assert got == want and any(v is not None for v, _ in got) and any(s > 0 for _, s in got)
    assert mine.report() == ref.report()
    assert {v for v, _ in got if v is not None} == set(active)  # least-faulted victims cover every lane


def _scripted_run(fleet, scen_cls):
    """SCENS twice under a scripted injector faulting lane 0 then lane 1
    (quarantine on the first fault, a 2-round backoff), then an expired
    deadline: the lane states each round, the outcomes and the report."""
    fleet.arm_host_chaos(ScriptedInjector([0, 1]))
    qids = submit_all(fleet, scen_cls) + submit_all(fleet, scen_cls)
    seen = []
    while fleet.pending or fleet._active:
        fleet.pump()
        seen.append(tuple(fleet.lane_states()))
    fleet.arm_host_chaos(None)
    dead = fleet.submit(scen_cls(), 150.0, deadline_s=1e-9)
    fleet.run_async()
    counts = {}
    for o in fleet.poll():
        counts[o.query] = counts.get(o.query, 0) + 1
    report = fleet.fault_report()
    report.pop("chaos")
    return qids, dead, seen, counts, report


def test_scripted_faults_quarantine_and_readmit_as_the_reference():
    kw = dict(quarantine_faults=1, quarantine_window=64, quarantine_backoff=2, telemetry=True)
    jf, pf = jax_async_fleet(**kw), port_fleet(**kw)
    jq, jdead, jseen, jcounts, jrep = _scripted_run(jf, jax_fleet.Scenario)
    pq, pdead, pseen, pcounts, prep = _scripted_run(pf, Scenario)
    assert pseen == jseen and {"quarantined", "probe", "active"} <= set(sum(pseen, ()))
    assert prep == jrep and prep["quarantine_events"] == 2 and prep["readmissions"] == 2
    assert prep["failed"] == {"lane_fault": 2, "deadline_exceeded": 1}
    for a, b in zip(pq, jq):
        mine, ref = pf.results[a], jf.results[b]
        assert (mine.ok, mine.kind, mine.lane) == (ref.ok, ref.kind, ref.lane)
        if mine.ok:
            assert _same(mine, ref)
        else:
            assert isinstance(mine, LaneFaultError) and "InjectedFault" in mine.cause and "crash-reset" in mine.message
    assert isinstance(pf.results[pdead], DeadlineExceededError) and pf.results[pdead].lane == -1
    assert set(pcounts) == set(pq) | {pdead} and set(pcounts.values()) == {1}
    assert pcounts == {q: 1 for q in pq + [pdead]}
    obs = pf.engine.observatory
    assert (obs._quarantine_total, obs._readmit_total) == (2, 2) and len(obs.report()["lane_states"]) == 3
    jf.close()
    pf.close()


# --- 6. guards ------------------------------------------------------------------------------------


def test_build_guards_and_lane_calls_raise():
    config = SimulationConfig.from_yaml(CHAOS_YAML)
    cluster, workload = composed_events("port")
    scen = dict(scenario_vectors(config, 2))

    def build(**kw):
        return build_batched_from_traces(config, cluster, workload, n_clusters=2, device="cpu",
                                         max_pods_per_cycle=16, **kw)

    with pytest.raises(ValueError, match="requires a scenario build"):
        build(lane_async=True)
    with pytest.raises(ValueError, match="full-resident pod path"):
        build(lane_async=True, scenario=scen, pod_window=8)
    with pytest.raises(ValueError, match="streaming feeder"):
        build(lane_async=True, scenario=scen, stream=True)
    sim = build(lane_async=True, scenario=scen, fast_forward=True)
    assert not sim.fast_forward and sim.lane_async and not sim._lane_horizon_np.any()
    plain = build(scenario=scen)
    for call in (lambda: plain.set_lane_plan([0], 0, [3]), lambda: plain.lane_reset([0]),
                 lambda: plain.set_lane_trace(0), ):
        with pytest.raises(ValueError, match="lane_async=True"):
            call()
    # A lane plan writes the clock tensors in place.
    ptrs = {k: v.data_ptr() for k, v in flatten(sim._lane_clocks).items()}
    sim.set_lane_plan([1], 4, [7])
    assert {k: v.data_ptr() for k, v in flatten(sim._lane_clocks).items()} == ptrs
    assert sim._lane_clocks.lane_clock.tolist() == [0, 4] and sim._lane_clocks.lane_horizon.tolist() == [0, 7]
    assert sim.lane_windows_remaining().tolist() == [0, 11] and sim.lane_windows_done().tolist() == [True, False]
    wave = port_fleet(lane_async=False)
    for call in (wave.pump, wave.run_async):
        with pytest.raises(ValueError, match="lane_async=True"):
            call()
    wave.close()


def test_checkpoint_carries_the_lane_clocks(tmp_path):
    """A lane-asynchronous engine saved mid-flight (lanes active, one
    parked) restores its lane clocks and their host mirrors with its
    state, and the two engines, given the same scenario vectors (the
    fleet's, which a checkpoint does not carry), step on equal."""
    f = port_fleet(telemetry=True)
    submit_all(f, Scenario, [4, 1])
    for _ in range(10):
        f.pump()
    eng = f.engine
    assert eng._lane_horizon_np.any() and not eng.lane_windows_done().all()
    path = str(tmp_path / "lanes")
    eng.save_checkpoint(path)
    restored = port_fleet(telemetry=True).engine
    restored.update_scenario({k: v.copy() for k, v in f._live_vectors.items()})  # the lanes' queries
    restored.load_checkpoint(path)
    np.testing.assert_array_equal(restored._lane_clock_np, eng._lane_clock_np)
    np.testing.assert_array_equal(restored._lane_horizon_np, eng._lane_horizon_np)
    assert restored._lane_clocks.lane_clock.tolist() == eng._lane_clocks.lane_clock.tolist()
    assert restored._lane_clocks.lane_horizon.tolist() == eng._lane_clocks.lane_horizon.tolist()
    for sim in (eng, restored):
        sim.step_windows(6)
    assert compare_states(state_to_numpy(eng.state), state_to_numpy(restored.state)) == []
    f.close()
