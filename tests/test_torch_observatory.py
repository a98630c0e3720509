"""The port's capacity observatory, export and histogram
(kubernetriks_tpu_torch/telemetry/{observatory,export,histogram}.py) on
the CPU, against the JAX package's (the port of tests/test_soak.py:
266-437 and of the watchdog gate of tests/test_reclaim.py:315).

- The same drained ring buffers go through the JAX package's
  Observatory and the port's: the same records (but their wall-clock
  stamp), the same SaturationWarnings, the same report, in each of the
  reference's scenarios: a rising reserve fires with its time to
  exhaustion; reclaim's fall clears the verdict and a later rise
  re-fires it; a flat tie names the most saturated cluster; low flat
  occupancy stays quiet; the idle-lane verdict fires once on a synthetic
  ring and is vacuous without lane-async; the pipeline checks flag a
  feeder and a sync budget; a falling pod-window headroom warns once.
- The fit / time-to-exhaustion math, the Prometheus lines, the bounded
  JSONL exporter and the latency histogram equal the reference's.
- The watchdog end to end: a faulted CA churn through slot reclaim with
  the watchdog armed (tests/test_reclaim.py:315 without the superspan,
  which the port's window executor replaces, and the checkpoint, ROADMAP
  item 12; the streaming feeder's runs are in test_torch_stream.py) shows
  no reserve verdict, and its ring equals the JAX engine's.
"""

import json
import math
import os
import warnings

import numpy as np
import pytest

import kubernetriks_tpu.telemetry.export as ref_export
import kubernetriks_tpu.telemetry.histogram as ref_hist
import kubernetriks_tpu.telemetry.observatory as ref_obs
from test_reclaim import CLUSTER_TRACE, RECLAIM_CA_SUFFIX, wave_workload
from test_torch_reference import TraceSpec, build_jax_engine, build_port_engine, jax_state_to_numpy

from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML  # noqa: E402

import kubernetriks_tpu_torch.telemetry.export as port_export
import kubernetriks_tpu_torch.telemetry.histogram as port_hist
import kubernetriks_tpu_torch.telemetry.observatory as port_obs
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.telemetry.ring import RING_COLUMNS

COL = {name: idx for idx, name in enumerate(RING_COLUMNS)}
SENT = port_obs.UNBOUNDED_SENTINEL


def ring_buf(rows):
    """A drained ring of one cluster: rows = [(window, hpa, ca, head)]."""
    buf = np.full((1, len(rows), len(RING_COLUMNS)), -1, np.int32)
    for slot, (w, hpa, ca, head) in enumerate(rows):
        buf[0, slot, COL["window"]] = w
        buf[0, slot, COL["hpa_reserve_used"]] = hpa
        buf[0, slot, COL["ca_reserve_used"]] = ca
        buf[0, slot, COL["pod_headroom"]] = head
    return buf


def lane_buf(w0, R, lane1_active):
    buf = np.full((2, R, len(RING_COLUMNS)), -1, np.int32)
    for slot in range(R):
        buf[:, slot, COL["window"]] = w0 + slot
        buf[:, slot, COL["hpa_reserve_used"]] = 0
        buf[:, slot, COL["ca_reserve_used"]] = 0
        buf[:, slot, COL["pod_headroom"]] = SENT
        buf[0, slot, COL["lane_active"]] = 1
        buf[1, slot, COL["lane_active"]] = lane1_active(slot)
    return buf


def tie_buf():
    R = 6
    buf = np.full((2, R, len(RING_COLUMNS)), -1, np.int32)
    for slot in range(R):
        buf[:, slot, COL["window"]] = slot
        buf[0, slot, COL["ca_reserve_used"]] = 17  # flat, 85 %
        buf[1, slot, COL["ca_reserve_used"]] = 19  # flat, 95 %
        buf[:, slot, COL["hpa_reserve_used"]] = 0
        buf[:, slot, COL["pod_headroom"]] = SENT
    return buf


PIPELINE = dict(
    dispatch_stats={"feeder_slabs_produced": 40, "stage_refills": 3, "superspans": 10, "fused_slides": 0,
                    "slide_syncs": 13},
    sync_budget={"steady_state_expected": 10, "observed_slide_syncs": 13},
    feeder={"ring_capacity": 3, "stalls": {"feeder_not_ready": {"count": 2, "ms": 5.0},
                                           "upload_wait": {"count": 0, "ms": 0.0}}},
)
CAPS = {"hpa_reserve": [100], "ca_reserve": [20]}

# name -> (Observatory kwargs, steps: ("ingest", buf) or ("observe", kwargs)).
SCENARIOS = {
    "rising_reserve": (
        dict(capacities=CAPS, horizon_s=1e6),
        [("ingest", ring_buf([(w, 0, 8 + w, SENT) for w in range(6)])), ("observe", {})],
    ),
    "recover_and_rewarn": (
        dict(capacities=CAPS, horizon_s=1e6),
        [
            ("ingest", ring_buf([(w, 0, 17, SENT) for w in range(6)])), ("observe", {}),
            ("ingest", ring_buf([(6 + w, 0, 3, SENT) for w in range(6)])), ("observe", {}),
            ("ingest", ring_buf([(12 + w, 0, 18, SENT) for w in range(6)])), ("observe", {}),
        ],
    ),
    "flat_tie": (dict(capacities={"ca_reserve": [20, 20]}, horizon_s=1e6), [("ingest", tie_buf()), ("observe", {})]),
    "quiet_low": (
        dict(capacities={"hpa_reserve": [100], "ca_reserve": [100]}),
        [("ingest", ring_buf([(w, 5, 10, SENT) for w in range(6)])), ("observe", {})],
    ),
    "idle_lane": (
        dict(capacities={}),
        [
            ("ingest", lane_buf(0, 8, lambda slot: 1 if slot < 2 else 0)), ("observe", {}),
            ("ingest", lane_buf(8, 6, lambda slot: 0)), ("observe", {}),
        ],
    ),
    "lane_vacuous": (dict(capacities={}), [("ingest", ring_buf([(w, 0, 0, SENT) for w in range(8)])),
                                          ("observe", {})]),
    "pipeline": (dict(capacities={}), [("ingest", ring_buf([(0, 0, 0, SENT)])), ("observe", PIPELINE)]),
    "falling_headroom": (
        dict(capacities=CAPS, horizon_s=1e6),
        [("ingest", ring_buf([(w, 0, 0, 400 - 40 * w) for w in range(6)])), ("observe", {}),
         ("ingest", ring_buf([(6 + w, 0, 0, 160 - 20 * w) for w in range(6)])), ("observe", {})],
    ),
}


def run_scenario(mod, kwargs, steps):
    """Each observe's record (less its wall-clock stamp) and warnings, and
    the final report, for one package's Observatory."""
    obs = mod.Observatory(interval=10.0, **kwargs)
    out = []
    for kind, arg in steps:
        if kind == "ingest":
            out.append(("ingest", obs.ingest(arg.copy())))
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rec = obs.observe(**arg)
        rec.pop("t_wall_s")
        out.append(("observe", rec, [
            (w.category.__name__, str(w.message)) for w in caught if issubclass(w.category, mod.SaturationWarning)
        ]))
    return obs, out, obs.report()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_observatory_verdicts_match_reference(name):
    kwargs, steps = SCENARIOS[name]
    ref, ref_out, ref_rep = run_scenario(ref_obs, kwargs, steps)
    mine, my_out, my_rep = run_scenario(port_obs, kwargs, steps)
    assert my_out == ref_out
    assert my_rep == ref_rep
    observed = [o for o in my_out if o[0] == "observe"]
    fired = [[e["kind"] for e in o[1]["watchdog"]] for o in observed]
    warned = [len(o[2]) for o in observed]
    if name == "rising_reserve":
        ev = observed[0][1]["watchdog"][0]
        assert ev["kind"] == "ca_reserve_used" and ev["eta_s"] == pytest.approx(70.0, abs=1.0)
        assert my_rep["watchdog"]["fired"]["ca_reserve_used"] == 5
    elif name == "recover_and_rewarn":
        assert fired == [["ca_reserve_used"], ["ca_reserve_used_recovered"], ["ca_reserve_used"]]
        assert warned == [1, 0, 1] and "ca_reserve_used" in mine.fired
        assert observed[1][1]["watchdog"][0]["frac"] == pytest.approx(3 / 20)
    elif name == "flat_tie":
        ev = observed[0][1]["watchdog"][0]
        assert ev["cluster"] == 1 and ev["used"] == 19 and "cluster 1" in observed[0][2][0][1]
    elif name in ("quiet_low", "lane_vacuous"):
        assert fired == [[]] and warned == [0]
    elif name == "idle_lane":
        assert fired == [["lane_idle"], []] and warned == [1, 0]
        ev = observed[0][1]["watchdog"][0]
        assert ev["lane"] == 1 and ev["active_frac"] == pytest.approx(0.25)
    elif name == "pipeline":
        assert {"sync_budget", "feeder_waste", "feeder_starved"} <= {e["kind"] for e in mine.events}
    elif name == "falling_headroom":
        assert fired == [["pod_headroom"], []]  # one verdict a run


def test_fit_and_eta_math_match_reference():
    xs = [0.0, 10.0, 20.0, 30.0]
    ys = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    slopes = port_obs.fit_slope(xs, ys)
    np.testing.assert_array_equal(slopes, ref_obs.fit_slope(xs, ys))
    assert abs(slopes[0] - 0.1) < 1e-12 and slopes[1] == 0.0
    rng = np.random.default_rng(3)
    for _ in range(20):
        x = np.sort(rng.uniform(0, 1000, 8)).tolist()
        y = rng.integers(0, 50, (8, 3))
        np.testing.assert_array_equal(port_obs.fit_slope(x, y), ref_obs.fit_slope(x, y))
    for args in [(3.0, 0.1, 10.0), (3.0, 0.0, 10.0), (12.0, 0.1, 10.0), (50.0, -5.0, None, True),
                 (50.0, 5.0, None, True)]:
        assert port_obs.time_to_exhaustion(*args) == ref_obs.time_to_exhaustion(*args)
    assert port_obs.time_to_exhaustion(3.0, 0.1, 10.0) == pytest.approx(70.0)
    assert port_obs.time_to_exhaustion(3.0, 0.0, 10.0) == math.inf
    mem = port_obs.sample_host_memory()
    assert mem["rss_bytes"] > 0 and mem["peak_rss_bytes"] >= mem["rss_bytes"] // 2


def test_prometheus_lines_and_tuning_objective_match_reference(tmp_path):
    report = {
        "dispatch_stats": {"slides": 7, "executed_windows": 3},
        "sync_budget": {"steady_state_expected": 10, "observed_slide_syncs": 10},
        "ring": {"windows_recorded": 12, "windows_kept": 12, "totals": {"decisions": 99}},
        "per_window": {"ms_per_window": 2.5},
        "resources": {
            "occupancy": {"ca_reserve_used": {"used_max": 3, "capacity_min": 8, "frac_max": 0.375,
                                              "high_water": 3}},
            "memory": {"rss_bytes": 123456, "slabs": {"telemetry_ring_bytes": 4096},
                       "high_water": {"rss_bytes": 234567}},
            "queries": {"count": 2, "p50_ms": 1.5, "histogram": {"buckets": [[0.5, 1], ["+Inf", 2]],
                                                                 "sum_s": 0.7, "count": 2}},
            "watchdog": {"enabled": True, "fired": {"ca_reserve_used": 9}},
            "samples": 4,
        },
    }
    lines = port_export.prometheus_lines(report)
    assert lines == ref_export.prometheus_lines(report)
    assert 'ktpu_ring_total{column="decisions"} 99' in lines
    path = port_export.write_prometheus_textfile(str(tmp_path / "m.prom"), report)
    assert open(path).read() == "\n".join(lines) + "\n" and not os.path.exists(path + ".tmp")
    assert port_obs.tuning_objective(report) == ref_obs.tuning_objective(report)


def test_jsonl_exporter_is_bounded(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    exp = port_export.JsonlExporter(path, max_bytes=2048)
    record = {"occupancy": {"ca_reserve_used": {"used_max": 3}}, "pad": "x" * 64}
    for i in range(200):
        exp.emit({**record, "window": i})
    assert exp.lines_written == 200
    assert os.path.getsize(path) <= 2048 + 256 and os.path.getsize(path + ".1") <= 2048 + 256
    assert json.loads(open(path).read().splitlines()[-1])["window"] == 199


def test_histogram_and_query_stats_match_reference():
    rng = np.random.default_rng(7)
    samples = rng.lognormal(-3.0, 1.5, 500)
    mine, ref = port_hist.LatencyHistogram(), ref_hist.LatencyHistogram()
    for v in samples:
        mine.record(float(v))
        ref.record(float(v))
    assert mine.to_dict() == ref.to_dict()
    assert mine.percentiles_ms() == ref.percentiles_ms()
    obs = [mod.Observatory(interval=10.0, capacities={}, slo_ms=50.0) for mod in (port_obs, ref_obs)]
    for o in obs:
        for i, v in enumerate(samples[:64]):
            o.note_query(float(v), queue_wait_s=float(v) / 4, service_s=float(v) * 3 / 4)
    assert obs[0].query_stats() == obs[1].query_stats()


# --- the watchdog end to end -------------------------------------------------------

FAULTS = """
fault_injection:
  enabled: true
  seed: 3
  node:
    mttf: 2400.0
    mttr: 120.0
"""


def test_endurance_churn_watchdog_stays_quiet_under_reclaim():
    """tests/test_reclaim.py:315's gate on the port: 48 churn waves (~13
    simulated hours) through a 4-slot CA reserve (multiplier 2) with node
    crashes, slot reclaim, pod_window=32 and the watchdog armed, sampled
    every 10 s off the window lattice: no reserve verdict, crashes seen,
    allocations at least 3x the reserve and the retired slots reclaimed,
    the bounds clean; the drained ring equals the JAX engine's."""
    n_waves = 48
    spec = TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=wave_workload(n_waves))
    config = DEFAULT_TEST_CONFIG_YAML + RECLAIM_CA_SUFFIX + FAULTS
    kwargs = dict(reclaim=True, ca_slot_multiplier=2, pod_window=32, telemetry=True, watchdog=True,
                  telemetry_ring=64, fast_forward=False)
    sim = build_port_engine(config, spec, 1, None, **kwargs)
    horizon = 10.0 + n_waves * 200.0
    caught = []
    slabs = {}
    for t in np.arange(15.003, horizon, 10.0):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sim.step_until_time(float(t))
        caught.extend(x for x in w if issubclass(x.category, port_obs.SaturationWarning))
        if (int(t) - 15) % 500 == 0:
            slabs.setdefault(sim.pod_window, []).append(sim._sample_resources()["slabs"])
    # The last windows since the previous drain are judged too.
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sim.drain_telemetry()
    caught.extend(x for x in w if issubclass(x.category, port_obs.SaturationWarning))
    assert sim.reclaim and sim._watchdog
    assert [str(x.message) for x in caught if "reserve" in str(x.message)] == []
    assert sim.observatory.samples > 0
    assert [k for k in sim.observatory.fired if "reserve" in k] == []
    assert int(sim.state.metrics.node_crashes.sum()) > 0
    total = int(sim.state.auto.ca_total.sum())
    reserve = sim._reserve_capacities["ca_reserve"][0]
    assert reserve == 4 and total >= 3 * reserve
    assert int(sim.ca_slots_reclaimed().sum()) >= total - reserve
    for rows in slabs.values():  # flat buffer accounting at each window width
        assert all(r == rows[0] for r in rows[1:])
    sim.check_autoscaler_bounds()
    wins, data = sim.telemetry_window_series()
    np.testing.assert_array_equal(wins, np.arange(sim.next_window_idx, dtype=np.int32))
    occupancy = data[:, :, COL["ca_reserve_used"]]
    assert occupancy.max() <= reserve and occupancy.min() == 0
    jx = build_jax_engine(config, spec, 1, None, "xla", **kwargs)
    for t in np.arange(500.0, horizon + 500.0, 500.0):
        jx.step_until_time(min(float(t), float(np.arange(15.003, horizon, 10.0)[-1])))
    assert jx.next_window_idx == sim.next_window_idx
    wj, dj = jx.telemetry_window_series()
    np.testing.assert_array_equal(wins, wj)
    np.testing.assert_array_equal(data, dj)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(sim.state)) == []
