"""The scenario fleet of the port (kubernetriks_tpu_torch/batched/fleet.py and
the engine's scenario build, update_scenario and fleet_reset) on the CPU,
against the JAX package.

- (a) The scenario vectors and leaves equal the reference's; homogeneous
  vectors (every lane the base config) run as the scalar-config build does.
- (b) Heterogeneous HPA fleets (per-lane tolerance and enable; per-lane
  scan interval) and a heterogeneous CA fleet (threshold, scan interval,
  as_to_ca delay) equal the JAX engine built with the same scenario, lane
  for lane (hpa_replicas, ca_node_counts over time, the final state under
  compare_states), and each lane equals an independent scalar-config port
  build.
- (c) The composed line with faults as a ScenarioFleet of 3 lanes running
  4 queries in 2 waves: each FleetResult (counters, hpa_replicas,
  ca_nodes, lane, wave) equals the JAX ScenarioFleet's; the same queries
  lane-permuted give bit-identical counters and idle-lane state rows; a
  query's per-lane fault seed gives the run of a standalone one-lane
  fleet, in the port and in JAX; a later wave of the same queries repeats
  them.
- (d) update_scenario and fleet_reset write in place: the statics, the
  seed vector and the executor's buffers keep their data_ptr, and on the
  stubbed capture backend no piece is captured after the fleet's build.
- (e) The host boundaries (mirroring tests/test_fleet.py:142-615 and the
  wave path's cases of tests/test_fleet_faults.py:361-449): validation
  naming the field, the bounded queue (reject and block), deadlines,
  close() and ShutdownError, poll() streaming each query once, and the
  refusals: trace_rows on a wave fleet, tuned profiles, the lane clocks'
  build guards.
"""

import numpy as np
import pytest

from test_fleet import FAULT_SUFFIX
from test_random_ca_equivalence import CA_CONFIG_SUFFIX, CLUSTER_TRACE as CA_CLUSTER_TRACE
from test_random_ca_equivalence import make_workload as make_ca_workload
from test_random_hpa_equivalence import CLUSTER_TRACE as HPA_CLUSTER_TRACE
from test_random_hpa_equivalence import make_workload as make_hpa_workload
from test_torch_autoscale import TOY, YamlSpec
from test_torch_executor import stub_graphs
from test_torch_reference import jax_state_to_numpy
from test_window_donation_dispatch import COMPOSED_CONFIG_SUFFIX, GROUP_TRACE

from chip_smoke import scenario_config

from kubernetriks_tpu.batched import fleet as jax_fleet
from kubernetriks_tpu.batched.engine import build_batched_from_traces as jax_build
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu.trace.generator import PoissonWorkloadTrace as JaxPoisson, UniformClusterTrace as JaxUniform
from kubernetriks_tpu.trace.generic import GenericWorkloadTrace as JaxGenericWorkload
from kubernetriks_tpu_torch.batched import fleet
from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
from kubernetriks_tpu_torch.batched.faults import DeadlineExceededError, QueryError, RejectedError, ShutdownError
from kubernetriks_tpu_torch.batched.fleet import FleetResult, Scenario, ScenarioFleet, scenario_vectors
from kubernetriks_tpu_torch.batched.state import compare_states, flatten
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
from kubernetriks_tpu_torch.trace.generic import GenericWorkloadTrace

HPA_YAML = DEFAULT_TEST_CONFIG_YAML + "horizontal_pod_autoscaler:\n  enabled: true\n"
CA_YAML = DEFAULT_TEST_CONFIG_YAML + CA_CONFIG_SUFFIX
CHAOS_YAML = DEFAULT_TEST_CONFIG_YAML + COMPOSED_CONFIG_SUFFIX + FAULT_SUFFIX
# The reference's chaos fleet (tests/test_fleet.py:431): scenario 0 twice
# (different lanes of wave 1), scenario 3 in wave 2.
CHAOS_SCENS = [
    dict(fault_seed=11, hpa_scan_interval=30.0),
    dict(fault_seed=22, ca_threshold=0.7),
    dict(fault_seed=11, hpa_scan_interval=30.0),
    dict(fault_seed=33, hpa_tolerance=0.25),
]
FLEET_KW = dict(n_lanes=3, horizon=450.0, max_pods_per_cycle=16, ca_slot_multiplier=4, fast_forward=False)


def composed_events(side: str):
    """tests/test_fleet.py's composed traces (`_composed_traces`) as each
    package's events."""
    uniform = JaxUniform if side == "jax" else UniformClusterTrace
    poisson = JaxPoisson if side == "jax" else PoissonWorkloadTrace
    generic = JaxGenericWorkload if side == "jax" else GenericWorkloadTrace
    plain = poisson(
        rate_per_second=0.3, horizon=400.0, seed=7, cpu=2000, ram=2 * 1024**3,
        duration_range=(30.0, 90.0), name_prefix="plain",
    ).convert_to_simulator_events()
    workload = sorted(plain + generic.from_yaml(GROUP_TRACE).convert_to_simulator_events(), key=lambda e: e[0])
    return uniform(4, cpu=16000, ram=32 * 1024**3).convert_to_simulator_events(), workload


def lane_rows(state_np: dict, lane: int) -> dict:
    return {k: v[lane : lane + 1] for k, v in state_np.items()}


# --- (a) vectors and the homogeneous build -------------------------------------------


def test_scenario_vectors_and_leaves_match_the_reference():
    rng = np.random.default_rng(5)
    for yaml in (CHAOS_YAML, CA_YAML, HPA_YAML):
        scens = [
            dict(hpa_scan_interval=float(rng.choice([30.0, 60.0])), hpa_tolerance=float(rng.uniform(0, 0.5)),
                 ca_scan_interval=float(rng.choice([10.0, 25.0])), ca_threshold=float(rng.uniform(0.3, 0.9)),
                 as_to_ca_network_delay=float(rng.uniform(0, 0.5)), fault_seed=int(rng.integers(0, 2**31)),
                 hpa_enabled=bool(rng.integers(0, 2)), ca_max_node_count=int(rng.integers(0, 5))),
            {}, dict(ca_threshold=0.8),
        ]
        port = scenario_vectors(SimulationConfig.from_yaml(yaml), 4, [Scenario(**s) for s in scens])
        want = jax_fleet.scenario_vectors(JaxConfig.from_yaml(yaml), 4, [jax_fleet.Scenario(**s) for s in scens])
        assert port.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(port[k], want[k], err_msg=k)
            assert port[k].dtype == want[k].dtype
        got = fleet.scenario_leaves(SimulationConfig.from_yaml(yaml), 4, port)
        ref = jax_fleet.scenario_leaves(JaxConfig.from_yaml(yaml), 4, want)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_homogeneous_vectors_equal_the_scalar_build():
    """A scenario build whose vectors all carry the base values runs bit
    for bit as the scenario-less build, with equal dispatch_stats; both
    hold per-lane statics."""
    config = SimulationConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML + COMPOSED_CONFIG_SUFFIX)
    cluster, workload = composed_events("port")

    def build(scenario):
        return build_batched_from_traces(config, cluster, workload, n_clusters=2, device="cpu",
                                         max_pods_per_cycle=16, scenario=scenario)

    plain, neutral = build(None), build(dict(scenario_vectors(config, 2)))
    for end in (150.0, 300.0, 450.0):
        plain.step_until_time(end)
        neutral.step_until_time(end)
    assert compare_states(state_to_numpy(plain.state), state_to_numpy(neutral.state)) == []
    assert plain.dispatch_stats == neutral.dispatch_stats
    assert plain.autoscale_statics.hpa_interval.win.shape == (2,) and plain.autoscale_statics.ca_threshold.shape == (2,)
    assert neutral._pristine is not None and plain._pristine is None


# --- (b) heterogeneous fleets against the reference and independent builds -------------


def _hetero(config_yaml, spec, scens, times, readout):
    """The port's and the JAX engine's scenario builds of `scens`, stepped
    to each of `times`, read out per lane with `readout(sim, lane)`; each
    lane's trajectory and final state also against an independent
    scalar-config port build
    (a lane with the HPA off has none: its scalar config builds no
    autoscaler). Returns the port's trajectories."""
    cluster, workload = spec.events("port")
    config = SimulationConfig.from_yaml(config_yaml)
    port = build_batched_from_traces(
        config, cluster, workload, n_clusters=len(scens), device="cpu", fast_forward=False,
        scenario=dict(scenario_vectors(config, len(scens), scens)),
    )
    jcluster, jworkload = spec.events("jax")
    jconfig = JaxConfig.from_yaml(config_yaml)
    jx = jax_build(
        jconfig, jcluster, jworkload, n_clusters=len(scens), use_pallas=False, fast_forward=False,
        scenario=dict(jax_fleet.scenario_vectors(jconfig, len(scens), [jax_fleet.Scenario(**s.overrides()) for s in scens])),
    )
    solos = [
        None if s.hpa_enabled is False else build_batched_from_traces(
            scenario_config(config_yaml, s), cluster, workload,
            n_clusters=1, device="cpu", fast_forward=False)
        for s in scens
    ]
    got = [[] for _ in scens]
    for t in times:
        port.step_until_time(t)
        jx.step_until_time(t)
        for lane, solo in enumerate(solos):
            mine = readout(port, lane)
            assert mine == readout(jx, lane), f"lane {lane} at t={t}: {mine} vs the reference's {readout(jx, lane)}"
            if solo is not None:
                solo.step_until_time(t)
                assert mine == readout(solo, 0), f"lane {lane} at t={t}: the fleet differs from its own build"
            got[lane].append(mine)
    final = state_to_numpy(port.state)
    assert compare_states(jax_state_to_numpy(jx.state), final) == []
    for lane, solo in enumerate(solos):
        if solo is not None:
            assert compare_states(lane_rows(final, lane), state_to_numpy(solo.state)) == [], f"lane {lane}"
    return got


def test_heterogeneous_hpa_fleet_matches_reference_and_own_builds():
    """Per-lane (tolerance, enable), as tests/test_fleet.py:173 samples it
    (every 60 s boundary); the disabled lane stays at its initial
    replicas."""
    scens = [Scenario(), Scenario(hpa_tolerance=0.02), Scenario(hpa_tolerance=0.4), Scenario(hpa_enabled=False)]
    spec = YamlSpec(HPA_CLUSTER_TRACE, make_hpa_workload(29))
    got = _hetero(HPA_YAML, spec, scens, [float(t) for t in np.arange(61.0, 960.0, 60.0)],
                  lambda sim, lane: sim.hpa_replicas(lane)["pod_group_1"])
    assert len({tuple(t) for t in got}) > 1
    assert len(set(got[3])) == 1


def test_heterogeneous_hpa_scan_fleet_matches_reference_and_own_builds():
    scens = [Scenario(hpa_scan_interval=s) for s in (30.0, 90.0, 120.0)]
    spec = YamlSpec(HPA_CLUSTER_TRACE, make_hpa_workload(17))
    got = _hetero(HPA_YAML, spec, scens, [float(t) for t in np.arange(61.0, 660.0, 30.0)],
                  lambda sim, lane: sim.hpa_replicas(lane)["pod_group_1"])
    assert len({tuple(t) for t in got}) > 1 and all(len(set(t)) > 1 for t in got)


def test_heterogeneous_ca_fleet_matches_reference_and_own_builds():
    scens = [Scenario(), Scenario(ca_threshold=0.8), Scenario(ca_scan_interval=25.0),
             Scenario(as_to_ca_network_delay=0.35)]
    spec = YamlSpec(CA_CLUSTER_TRACE, make_ca_workload(8))
    got = _hetero(CA_YAML, spec, scens, [float(t) for t in np.arange(15.0, 600.0, 40.0)],
                  lambda sim, lane: [int(v) for v in sim.ca_node_counts(lane)])
    assert max(max(v) for v in got[0]) > 0, "the scenario must exercise the CA"
    assert len({str(t) for t in got}) > 1


# --- (c) the composed fleet with faults ------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_fleets():
    """Port fleets A (queries in order) and B (lane-permuted) and the JAX
    fleet A, each sweeping CHAOS_SCENS over 3 lanes (2 waves)."""
    def port(order):
        f = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu", **FLEET_KW)
        return f, f.sweep([Scenario(**CHAOS_SCENS[i]) for i in order])

    jf = jax_fleet.ScenarioFleet(JaxConfig.from_yaml(CHAOS_YAML), *composed_events("jax"), use_pallas=False, **FLEET_KW)
    jres = jf.sweep([jax_fleet.Scenario(**s) for s in CHAOS_SCENS])
    fa, ra = port([0, 1, 2, 3])
    fb, rb = port([3, 2, 1, 0])
    yield jres, fa, ra, fb, rb
    for f in (jf, fa, fb):
        f.close()


def _same(a, b) -> bool:
    return (a.counters, a.hpa_replicas, a.ca_nodes) == (b.counters, b.hpa_replicas, b.ca_nodes)


def test_fleet_results_equal_the_reference_fleet(chaos_fleets):
    jres, fa, ra, _, _ = chaos_fleets
    for mine, ref in zip(ra, jres):
        assert isinstance(mine, FleetResult) and mine.ok
        assert (mine.lane, mine.wave, mine.horizon) == (ref.lane, ref.wave, ref.horizon)
        assert mine.counters == ref.counters and mine.hpa_replicas == ref.hpa_replicas
        assert mine.ca_nodes == ref.ca_nodes
        assert (mine.hpa_reserve_clamped, mine.ca_reserve_starved) == (0, 0)
    assert fa.waves_run == 2 and {r.wave for r in ra} == {0, 1}
    assert sum(r.counters["pod_restarts"] + r.counters["node_crashes"] for r in ra) > 0


def test_lane_permutation_is_bit_identical(chaos_fleets):
    _, fa, ra, fb, rb = chaos_fleets
    assert ra[0].lane != ra[2].lane and _same(ra[0], ra[2])
    order_b = [3, 2, 1, 0]
    for i in range(len(CHAOS_SCENS)):
        assert _same(ra[i], rb[order_b.index(i)]), f"scenario {i}"
    # The last waves' idle lanes (1 and 2) ran the build scenario for the
    # same span in both fleets: their whole state rows match.
    a, b = state_to_numpy(fa.engine.state), state_to_numpy(fb.engine.state)
    assert compare_states(lane_rows(a, 1), lane_rows(a, 2)) == []
    assert compare_states(lane_rows(a, 1), lane_rows(b, 1)) == []


def test_per_lane_fault_seed_equals_a_standalone_fleet(chaos_fleets):
    """A lane's fault stream is a function of its scenario: seed 22 in the
    3-lane fleet equals a one-lane fleet running it, in the port and in
    JAX."""
    _, _, ra, _, _ = chaos_fleets
    solo = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu",
                         **{**FLEET_KW, "n_lanes": 1})
    jsolo = jax_fleet.ScenarioFleet(JaxConfig.from_yaml(CHAOS_YAML), *composed_events("jax"), use_pallas=False,
                                    **{**FLEET_KW, "n_lanes": 1})
    try:
        mine = solo.sweep([Scenario(**CHAOS_SCENS[1])])[0]
        ref = jsolo.sweep([jax_fleet.Scenario(**CHAOS_SCENS[1])])[0]
        assert _same(mine, ra[1]) and mine.counters == ref.counters and mine.hpa_replicas == ref.hpa_replicas
        assert mine.counters["pod_restarts"] > 0
    finally:
        solo.close()
        jsolo.close()


def test_a_later_wave_repeats_the_queries(chaos_fleets):
    _, fa, ra, _, _ = chaos_fleets
    again = fa.sweep([Scenario(**CHAOS_SCENS[0]), Scenario(**CHAOS_SCENS[3])])
    assert _same(again[0], ra[0]) and _same(again[1], ra[3])
    assert {r.wave for r in again} == {2}


# --- (d) in place ----------------------------------------------------------------------------------


def _ptrs(tree) -> dict:
    return {k: v.data_ptr() for k, v in flatten(tree).items() if v.numel()}


def test_updates_and_resets_write_in_place():
    f = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu",
                      **{**FLEET_KW, "horizon": 120.0})
    eng = f.engine
    statics, bufs, seeds = _ptrs(eng.autoscale_statics), _ptrs(eng._executor.bufs), eng._fault_seeds.data_ptr()
    f.sweep([Scenario(**s) for s in CHAOS_SCENS])
    eng.update_scenario({"hpa_scan_interval": np.array([15.0, 45.0, 75.0]), "fault_seed": 99})
    eng.fleet_reset(lanes=[1])
    eng.fleet_reset()
    assert _ptrs(eng.autoscale_statics) == statics and _ptrs(eng._executor.bufs) == bufs
    assert eng._fault_seeds.data_ptr() == seeds
    assert eng._fault_seeds.tolist() == [99, 99, 99]
    np.testing.assert_array_equal(eng.clock.hpa_interval.win.numpy(), [1, 4, 7])
    # A reset at the wave boundary rewinds to the build state.
    assert eng.next_window_idx == 0 and not eng._cursor.any()
    assert compare_states(state_to_numpy(eng.state), state_to_numpy(eng._pristine)) == []
    f.close()


def test_no_capture_after_the_fleet_build_on_the_stub_backend(monkeypatch):
    """On the stubbed capture backend (test_torch_executor.py) the fleet
    captures its pieces at build; the waves, their scenario updates and
    resets replay them and capture nothing more, and the results equal an
    eager fleet's."""
    from kubernetriks_tpu_torch.batched import engine as engine_mod

    real = engine_mod.BatchedSimulation.precompile_pieces

    def stubbed(sim):
        if sim._executor.backend is None:
            stub_graphs(sim)
        return real(sim)

    monkeypatch.setattr(engine_mod.BatchedSimulation, "precompile_pieces", stubbed)
    f = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu", **FLEET_KW)
    captured = f.engine.dispatch_stats["captures"]
    assert captured > 0 and f.engine.graphs
    res = f.sweep([Scenario(**s) for s in CHAOS_SCENS])
    stats = f.engine.dispatch_stats
    assert stats["captures"] == captured and stats["eager_windows"] == 0 and stats["graph_windows"] > 0
    monkeypatch.setattr(engine_mod.BatchedSimulation, "precompile_pieces", real)
    eager = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu", **FLEET_KW)
    for a, b in zip(res, eager.sweep([Scenario(**s) for s in CHAOS_SCENS])):
        assert _same(a, b)
    f.close()
    eager.close()


def test_scenario_calls_need_a_scenario_build():
    config = SimulationConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML + COMPOSED_CONFIG_SUFFIX)
    sim = build_batched_from_traces(config, *composed_events("port"), n_clusters=1, device="cpu", max_pods_per_cycle=16)
    with pytest.raises(ValueError, match="scenario"):
        sim.update_scenario({"hpa_scan_interval": 30.0})
    with pytest.raises(ValueError, match="fleet"):
        sim.fleet_reset()
    with pytest.raises(KeyError, match="unknown scenario key"):
        fleet.normalize_scenario({"bogus": 1.0}, 2)
    with pytest.raises(ValueError, match="shape"):
        fleet.normalize_scenario({"hpa_scan_interval": np.zeros(3)}, 2)
    np.testing.assert_array_equal(fleet.normalize_scenario({"hpa_scan_interval": 30.0}, 2)["hpa_scan_interval"], [30.0, 30.0])


# --- (e) host boundaries --------------------------------------------------------------------------


def _small_fleet(**kwargs):
    return ScenarioFleet(SimulationConfig.from_yaml(TOY.config_yaml), *TOY.events("port"), device="cpu",
                         n_lanes=2, horizon=60.0, max_pods_per_cycle=8, **kwargs)


@pytest.fixture(scope="module")
def host_fleet():
    f = _small_fleet()
    yield f
    f.close()


def test_query_outcome_protocol():
    assert FleetResult.ok is True and FleetResult.kind == "result"
    for cls, kind in {RejectedError: "rejected", DeadlineExceededError: "deadline_exceeded",
                      ShutdownError: "shutdown"}.items():
        err = cls(7, "boom", lane=2)
        assert isinstance(err, QueryError) and isinstance(err, Exception)
        assert err.ok is False and err.kind == kind and (err.query, err.lane, err.message) == (7, 2, "boom")
    assert RejectedError(1, "full", retry_after_s=0.25).retry_after_s == 0.25


def test_submit_validation_names_the_field(host_fleet):
    f = host_fleet
    with pytest.raises(ValueError, match=r"unknown scenario key.*'warp'"):
        f.submit({"warp": 9.0}, 100.0)
    with pytest.raises(ValueError, match=r"scenario\['ca_threshold'\].*SCALAR"):
        f.submit({"ca_threshold": [0.5, 0.6]}, 100.0)
    with pytest.raises(ValueError, match=r"scenario\['hpa_tolerance'\].*>= 0"):
        f.submit({"hpa_tolerance": -0.25}, 100.0)
    with pytest.raises(ValueError, match="Scenario or a mapping"):
        f.submit(42, 100.0)
    for bad in (0, -5.0, float("nan"), "soon"):
        with pytest.raises(ValueError, match="horizon must be a finite"):
            f.submit(Scenario(), bad)
    with pytest.raises(ValueError, match="deadline_s must be a finite"):
        f.submit(Scenario(), 100.0, deadline_s=0.0)
    with pytest.raises(ValueError, match="trace_rows needs lane_async=True"):
        f.submit(Scenario(), 100.0, trace_rows=(0, 4))
    assert f.pending == 0


def test_lane_async_options_raise():
    """The refusals: a tuned profile whose path is missing (the strict
    load's FileNotFoundError), an unknown queue policy, and a
    lane-asynchronous fleet over a sliding pod window or the streaming
    feeder (the reference's build guards)."""
    config = SimulationConfig.from_yaml(TOY.config_yaml)
    with pytest.raises(ValueError, match="full-resident pod path"):
        ScenarioFleet(config, *TOY.events("port"), n_lanes=2, horizon=60.0, device="cpu", lane_async=True,
                      pod_window=8)
    with pytest.raises(ValueError, match="streaming feeder"):
        ScenarioFleet(config, *TOY.events("port"), n_lanes=2, horizon=60.0, device="cpu", lane_async=True,
                      stream=True)
    with pytest.raises(FileNotFoundError):
        ScenarioFleet(config, *TOY.events("port"), n_lanes=2, horizon=60.0, device="cpu", tuned_profile="x")
    with pytest.raises(ValueError, match="queue_policy"):
        ScenarioFleet(config, *TOY.events("port"), n_lanes=2, horizon=60.0, device="cpu", queue_policy="drop")


def test_queue_reject_block_deadline_close_and_stream_once(monkeypatch):
    """The bounded queue (reject streams a RejectedError with a retry hint
    once a query was served; block runs waves inline), a queued query past
    its deadline fails without a lane, close() fails what is queued and
    refuses new queries, and across it all every query id streams exactly
    one outcome through poll()."""
    f = _small_fleet(max_queue=2, queue_policy="reject")
    q0, q1 = f.submit(Scenario(), 40.0), f.submit(Scenario(hpa_tolerance=0.2))
    rejected = f.submit(Scenario())
    out = f.poll()
    assert [o.query for o in out] == [rejected] and isinstance(out[0], RejectedError)
    assert "queue full" in out[0].message and "'reject'" in out[0].message and out[0].retry_after_s is None
    f.run()
    got = {o.query: o for o in f.poll()}
    assert set(got) == {q0, q1} and got[q0].ok and got[q0].horizon == 40.0 and got[q1].horizon == 60.0
    assert f.poll(q0) == [] and f.query_lifecycle(q0)["drained_ns"] >= f.query_lifecycle(q0)["admitted_ns"]
    f.submit(Scenario())
    f.submit(Scenario())
    late = f.submit(Scenario())
    assert f.poll(late)[0].retry_after_s > 0.0  # service times exist now
    f.run()
    f.poll()
    # Block: submit() runs a wave inline, the queue never passes its bound.
    f.queue_policy = "block"
    blocked = [f.submit(Scenario()) for _ in range(5)]
    assert f.pending <= 2
    f.run()
    assert all(f.results[q].ok for q in blocked)
    # A deadline that passed while queued fails the query without a lane.
    d = f.submit(Scenario(), deadline_s=1e-9)
    f.run()
    (dead,) = f.poll(d)
    assert isinstance(dead, DeadlineExceededError) and dead.lane == -1 and dead.late_s >= 0.0
    # close(): the queued queries fail with ShutdownError; submit raises.
    f.queue_policy = "reject"
    f.max_queue = None
    queued = [f.submit(Scenario()) for _ in range(3)]
    f.close()
    with pytest.raises(ShutdownError, match="after close"):
        f.submit(Scenario())
    counts = {}
    for o in f.poll():
        counts[o.query] = counts.get(o.query, 0) + 1
        if o.query in queued:
            assert isinstance(o, ShutdownError) and "queued at close()" in o.message
    assert f.poll() == []
    with pytest.raises(KeyError, match="never submitted"):
        f.poll(10_000)
    completed = sum(1 for r in f.results.values() if r.ok)
    assert len(f.results) == f._next_query and completed + sum(f.failed_queries.values()) == f._next_query
    assert f.failed_queries == {"rejected": 2, "deadline_exceeded": 1, "shutdown": 3}
    assert f.latency_hist.count == f.service_hist.count == completed
