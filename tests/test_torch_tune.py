"""The port's statics autotuner (kubernetriks_tpu_torch/tune/) on the CPU,
case for case after the reference's tests/test_tune.py.

- Search parity: with the JAX registry's entries installed into the port's
  `knobs` module (monkeypatch; nothing in the JAX package changes), the
  port's staged coordinate descent on FakeMeasurementBackend(BONUSES)
  gives the JAX search's candidate records, chosen config, objective and
  measured / reused / complete exactly: unbudgeted, with a seed config,
  with budget 3 and then a resume, and with budget 0 (both raise). On the
  port's own registry the fake winner is the bonus optimum, the sweep is
  deterministic, and a CPU sweep never measures graphs=True.
- Profiles: the round trip keeps the document; an unknown knob (the
  reference's TPU knobs among them), an illegal value, a value the
  profile's device cannot build, and an explicit device type or geometry
  mismatch raise, naming the field; an auto profile's mismatch warns and
  keeps its statics; resolve_build_profile rejects junk.
- The build seam: a profile-sourced build IS the hand-argument build (the
  same tuning_statics(); stepped, compare_states equal with equal
  dispatch_stats), and equals the JAX engine's XLA path with the same
  razor setting; no profile and no flag gives default_statics("cpu");
  KTPU_TUNED_PROFILE: a path is strict, auto resolves by key, a knob's own
  flag outranks the profile; every closed-domain knob is an engine
  argument and a tuning_statics() key; a CPU build refuses graphs=True
  through a profile.
- The real backend: BenchMeasurementBackend's whole sweep on the composed
  line's CPU cut (>= 5 valid spans a candidate, no capture or growth after
  the seal, one fingerprint, chosen <= baseline, the profile loads back
  build-identical).
- The fleet applies `tuned_profile=`; the command line's --fake line prints its
  record from a fresh interpreter.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_reference import REPO, jax_state_to_numpy  # noqa: E402  (installs the enable_x64 alias first)

from kubernetriks_tpu.batched.engine import build_batched_from_traces as jax_build  # noqa: E402
from kubernetriks_tpu.config import SimulationConfig as JaxConfig  # noqa: E402
from kubernetriks_tpu.trace.generator import (  # noqa: E402
    PoissonWorkloadTrace as JaxPoisson,
    UniformClusterTrace as JaxUniform,
)
from kubernetriks_tpu.tune import knobs as jax_knobs  # noqa: E402
from kubernetriks_tpu.tune.measure import FakeMeasurementBackend as JaxFake  # noqa: E402
from kubernetriks_tpu.tune.search import staged_coordinate_descent as jax_descent  # noqa: E402

from kubernetriks_tpu_torch.batched.engine import BatchedSimulation, build_batched_from_traces
from kubernetriks_tpu_torch.batched.fleet import ScenarioFleet
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
from kubernetriks_tpu_torch.tune import (
    KNOBS,
    FakeMeasurementBackend,
    GeometryMismatch,
    knob_by_name,
    load_profile,
    profile_path,
    resolve_build_profile,
    save_profile,
    staged_coordinate_descent,
    validate_statics,
)
from kubernetriks_tpu_torch.tune import knobs as port_knobs
from kubernetriks_tpu_torch.tune.knobs import default_statics
from kubernetriks_tpu_torch.tune.run import FAKE_BONUSES, run_tune
from kubernetriks_tpu_torch.tune.search import profile_doc

# The reference test's bonus table, over the reference's knobs.
JAX_BONUSES = {"lane_major": {True: 5.0}, "window_razor": {True: 3.0}}


def _sweep(**kwargs):
    return staged_coordinate_descent(FakeMeasurementBackend(FAKE_BONUSES, device_type="cpu"), **kwargs)


# ---------------------------------------------------------------- search


@pytest.fixture
def jax_registry(monkeypatch):
    """The JAX registry's entries installed into the port's knobs module
    (as port Knobs, with no per-device values)."""
    entries = tuple(port_knobs.Knob(**k._asdict()) for k in jax_knobs.KNOBS)
    monkeypatch.setattr(port_knobs, "KNOBS", entries)
    monkeypatch.setattr(port_knobs, "_BY_NAME", {k.name: k for k in entries})
    monkeypatch.setattr(port_knobs, "STAGES", jax_knobs.STAGES)


def _both(bonuses, **kwargs):
    """The same sweep through the JAX search and the port's."""
    return (
        jax_descent(JaxFake(bonuses), **kwargs),
        staged_coordinate_descent(FakeMeasurementBackend(bonuses, device_type="cpu"), **kwargs),
    )


def _assert_same(jax_res, port_res):
    assert port_res.candidates == jax_res.candidates
    assert port_res.chosen == jax_res.chosen
    assert port_res.objective == jax_res.objective
    assert port_res.baseline == jax_res.baseline
    assert (port_res.measured, port_res.reused, port_res.complete) == (
        jax_res.measured, jax_res.reused, jax_res.complete
    )
    assert port_res.fingerprint == jax_res.fingerprint


@pytest.mark.parametrize("way", ["unbudgeted", "seeded", "budget_then_resume", "zero_budget"])
def test_search_equals_the_jax_search_on_its_registry(jax_registry, way):
    if way == "zero_budget":
        for run in (
            lambda: jax_descent(JaxFake(JAX_BONUSES), budget=0),
            lambda: staged_coordinate_descent(FakeMeasurementBackend(JAX_BONUSES), budget=0),
        ):
            with pytest.raises(ValueError, match="did not cover even the baseline"):
                run()
        return
    if way == "unbudgeted":
        jax_res, port_res = _both(JAX_BONUSES)
        assert port_res.chosen["lane_major"] is True and port_res.objective == pytest.approx(92.0)
        _assert_same(jax_res, port_res)
    elif way == "seeded":
        bonuses = {"superspan_k": {32: 50.0}, "lane_major": {True: 5.0}}
        seed = dict(jax_knobs.default_statics(), superspan=True, superspan_k=32)
        jax_res, port_res = _both(bonuses, seed_configs=[seed])
        assert port_res.chosen == seed
        _assert_same(jax_res, port_res)
    else:
        jax_part, port_part = _both(JAX_BONUSES, budget=3)
        assert port_part.complete is False and port_part.measured == 3
        _assert_same(jax_part, port_part)
        jax_res, port_res = _both(JAX_BONUSES, resume_candidates=port_part.candidates)
        assert port_res.reused == 3 and port_res.complete is True
        _assert_same(jax_res, port_res)


def test_fake_sweep_pins_the_bonus_optimum():
    res = _sweep()
    assert res.chosen == dict(default_statics("cpu"), megakernel=False, window_razor=True)
    assert res.objective == pytest.approx(92.0)
    assert res.baseline == {"statics": default_statics("cpu"), "objective": 100.0}
    assert res.complete is True and res.measured == len(res.candidates) and res.reused == 0


def test_fake_sweep_is_deterministic():
    a, b = _sweep(), _sweep()
    assert a.chosen == b.chosen
    assert a.candidates == b.candidates  # full records, visit order


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_sweep_measures_only_values_the_device_builds(device):
    """The CPU sweep never measures graphs=True (and does not fail); the
    card's measures both executors, starting from its own defaults."""
    be = FakeMeasurementBackend({"graphs": {False: 1.0}}, device_type=device)
    res = staged_coordinate_descent(be)
    graphs = {c["graphs"] for c in be.measure_calls}
    assert graphs == ({False} if device == "cpu" else {False, True})
    assert res.baseline["statics"] == default_statics(device)
    assert res.chosen["graphs"] is False
    with pytest.raises(ValueError, match="'graphs'.*does not build on 'cpu'"):
        FakeMeasurementBackend(device_type="cpu").measure(dict(default_statics("cpu"), graphs=True))


# --------------------------------------------------------------- profile


def _doc(statics=None, backend="cpu", n_clusters=2, n_nodes=4):
    doc = profile_doc(_sweep(), backend=backend, n_clusters=n_clusters, n_nodes=n_nodes)
    if statics is not None:
        doc["statics"] = statics
    return doc


def test_profile_roundtrips_and_names_are_the_key(tmp_path):
    doc = _doc()
    path = profile_path("cpu", 2, 4, root=str(tmp_path))
    assert path == os.path.join(str(tmp_path), "cpu_2x4.json")
    save_profile(doc, path)
    prof = load_profile(path)
    assert prof.backend == "cpu"
    assert (prof.n_clusters, prof.n_nodes) == (2, 4)
    assert prof.statics == doc["statics"]
    assert prof.doc["candidates"] == doc["candidates"]
    assert prof.doc["knob_registry"]["graphs"]["device_values"] == {"cpu": [False]}
    assert prof.explicit is True


@pytest.mark.parametrize("field", ["bogus_knob", "lane_major", "donate", "superspan", "ca_descatter"])
def test_unknown_knob_raises_at_load_naming_the_field(tmp_path, field):
    """Unknown names and the reference's TPU knobs raise at save and at
    load."""
    doc = _doc(statics={field: 1})
    path = str(tmp_path / "p.json")
    with pytest.raises(ValueError, match=field):
        save_profile(doc, path)
    with open(path, "w") as fh:  # written raw to test the LOAD side
        json.dump(doc, fh)
    with pytest.raises(ValueError, match=field):
        load_profile(path)


def test_illegal_value_raises_naming_the_knob(tmp_path):
    path = str(tmp_path / "p.json")
    for statics, field in (
        (dict(default_statics("cpu"), stream_depth=7), "stream_depth"),
        (dict(default_statics("cpu"), graphs=True), "graphs"),  # legal, not on the CPU
        (dict(default_statics("cpu"), stream_segment=True), "stream_segment"),
    ):
        with open(path, "w") as fh:
            json.dump(_doc(statics=statics), fh)
        with pytest.raises(ValueError, match=field):
            load_profile(path)
    # The card's profile may carry graphs=True.
    save_profile(_doc(statics=dict(default_statics("cuda")), backend="cuda"), path)
    assert load_profile(path).statics["graphs"] is True
    with pytest.raises(ValueError, match="stream_depth"):
        validate_statics({"stream_depth": 7})
    with pytest.raises(ValueError, match="no_such_knob"):
        knob_by_name("no_such_knob")


def test_explicit_geometry_mismatch_raises_naming_the_field(tmp_path):
    path = str(tmp_path / "p.json")
    save_profile(_doc(), path)
    prof = load_profile(path)  # explicit
    with pytest.raises(GeometryMismatch, match="geometry.n_clusters"):
        prof.check_geometry(n_clusters=3)
    with pytest.raises(GeometryMismatch, match="backend"):
        prof.check_geometry(backend="cuda")
    with pytest.raises(GeometryMismatch, match="geometry.n_nodes"):
        prof.check_geometry(n_nodes=5)
    prof.check_geometry(backend="cpu", n_clusters=2, n_nodes=4)  # matching: silent


def test_auto_geometry_mismatch_warns_and_keeps_statics(tmp_path):
    path = str(tmp_path / "p.json")
    save_profile(_doc(), path)
    prof = load_profile(path, explicit=False)
    with pytest.warns(RuntimeWarning, match="geometry.n_nodes"):
        prof.check_geometry(n_nodes=5)
    assert prof.statics  # still usable after the warning


def test_resolve_build_profile_rejects_junk():
    with pytest.raises(TypeError, match="tuned_profile"):
        resolve_build_profile(42, backend="cpu", n_clusters=2)
    assert resolve_build_profile(False, backend="cpu", n_clusters=2) is None


# ------------------------------------------------------------ build seam


TINY_YAML = "sim_name: tune\nseed: 1\nscheduling_cycle_interval: 10.0"


def tiny_events(side: str):
    """The reference test's tiny traces: 4 nodes, Poisson pods at 0.2/s to
    200 s (16 000 mCPU / 32 GiB, 30-90 s), as each package's events."""
    uniform = JaxUniform if side == "jax" else UniformClusterTrace
    poisson = JaxPoisson if side == "jax" else PoissonWorkloadTrace
    wl = poisson(
        rate_per_second=0.2, horizon=200.0, seed=3, cpu=16000, ram=32 * 1024**3,
        duration_range=(30.0, 90.0), name_prefix="p",
    )
    return (
        uniform(4, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
        wl.convert_to_simulator_events(),
    )


def _build(**kwargs):
    return build_batched_from_traces(
        SimulationConfig.from_yaml(TINY_YAML), *tiny_events("port"), n_clusters=2, device="cpu",
        fast_forward=False, **kwargs,
    )


@pytest.fixture(scope="module")
def tiny_profile_doc():
    """A profile whose geometry matches the tiny build (cpu, C=2, N=4) and
    whose chosen statics turn the razor on and the megakernel off."""
    sim = _build(tuned_profile=False)
    n_nodes = sim.n_nodes
    sim.close()
    return profile_doc(_sweep(), backend="cpu", n_clusters=2, n_nodes=n_nodes)


def test_profile_build_matches_hand_passed_statics(tiny_profile_doc, tmp_path):
    """A profile-sourced build IS the hand-argument build: the statics
    resolve equal, and stepped, the final state is bit-identical
    (compare_states) with equal dispatch_stats; both equal the JAX
    engine's XLA path with the razor on."""
    path = str(tmp_path / "tiny.json")
    save_profile(tiny_profile_doc, path)
    sim_prof = _build(tuned_profile=path)
    sim_hand = _build(tuned_profile=False, **tiny_profile_doc["statics"])
    assert sim_prof.tuning_statics() == sim_hand.tuning_statics() == tiny_profile_doc["statics"]
    assert sim_prof.window_razor is True and sim_prof.megakernel is False
    assert sim_prof.tuned_profile is not None and sim_prof.tuned_profile.source == path
    assert sim_hand.tuned_profile is None
    sim_prof.step_until_time(150.0)
    sim_hand.step_until_time(150.0)
    got = state_to_numpy(sim_prof.state)
    assert compare_states(state_to_numpy(sim_hand.state), got) == []
    assert sim_prof.dispatch_stats == sim_hand.dispatch_stats
    jx = jax_build(
        JaxConfig.from_yaml(TINY_YAML), *tiny_events("jax"), n_clusters=2, use_pallas=False,
        fast_forward=False, window_razor=True, tuned_profile=False,
    )
    jx.step_until_time(150.0)
    assert compare_states(jax_state_to_numpy(jx.state), got) == []


def test_build_without_profile_is_untouched():
    """No argument, no flag: no profile consulted, the untuned build's
    statics (the CPU's defaults)."""
    sim = _build()
    assert sim.tuned_profile is None
    assert sim.tuning_statics() == default_statics("cpu")
    sim.close()


def test_env_flag_seam(tiny_profile_doc, tmp_path, monkeypatch):
    path = str(tmp_path / "tiny.json")
    save_profile(tiny_profile_doc, path)
    # KTPU_TUNED_PROFILE=<path>: strict, and applies the profile...
    monkeypatch.setenv("KTPU_TUNED_PROFILE", path)
    sim = _build()
    assert sim.tuned_profile is not None and sim.megakernel is False and sim.window_razor is True
    sim.close()
    # ...and a knob's own flag OUTRANKS the profile entry.
    monkeypatch.setenv("KTPU_MEGAKERNEL", "1")
    sim = _build()
    assert sim.megakernel is True and sim.window_razor is True
    sim.close()
    monkeypatch.delenv("KTPU_MEGAKERNEL")
    deep = str(tmp_path / "deep.json")
    save_profile(dict(tiny_profile_doc, statics=dict(tiny_profile_doc["statics"], stream=True, stream_depth=2)), deep)
    monkeypatch.setenv("KTPU_TUNED_PROFILE", deep)
    assert _build().tuning_statics()["stream_depth"] == 2
    monkeypatch.setenv("KTPU_STREAM_DEPTH", "4")
    monkeypatch.setenv("KTPU_STREAM", "0")
    got = _build().tuning_statics()
    assert (got["stream"], got["stream_depth"]) == (False, 4)
    monkeypatch.delenv("KTPU_STREAM_DEPTH")
    monkeypatch.delenv("KTPU_STREAM")
    # A flag naming a MISSING path raises (never silently untuned).
    monkeypatch.setenv("KTPU_TUNED_PROFILE", str(tmp_path / "gone.json"))
    with pytest.raises(FileNotFoundError):
        _build()
    # An explicit build argument outranks the (broken) flag entirely.
    sim = _build(tuned_profile=False)
    assert sim.tuned_profile is None
    sim.close()


def test_env_flag_auto_resolution(tiny_profile_doc, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("KTPU_TUNED_PROFILE", "auto")
    # No artifacts/tuned/ anywhere: auto quietly resolves to no profile.
    sim = _build()
    assert sim.tuned_profile is None
    sim.close()
    # A profile under artifacts/tuned/ keyed by device type and cluster
    # count is picked up; its provenance is auto (explicit False).
    path = profile_path("cpu", 2, tiny_profile_doc["geometry"]["n_nodes"])
    save_profile(tiny_profile_doc, path)
    sim = _build()
    assert sim.tuned_profile is not None and sim.tuned_profile.explicit is False
    assert sim.window_razor is True
    sim.close()
    # An auto profile whose recorded N drifts from the build only WARNS
    # (post-build check) and the statics stay applied.
    os.remove(path)
    save_profile(dict(tiny_profile_doc, geometry={"n_clusters": 2, "n_nodes": 999}), profile_path("cpu", 2, 999))
    with pytest.warns(RuntimeWarning, match="geometry.n_nodes"):
        sim = _build()
    assert sim.window_razor is True
    sim.close()


def test_registry_covers_every_engine_static():
    """Every closed-domain knob is an engine build argument AND a
    tuning_statics() key: a renamed argument breaks here, not silently in
    a stale profile."""
    import inspect

    names = {k.name for k in KNOBS if k.values is not None}
    assert names == set(default_statics("cpu")) == set(default_statics("cuda"))
    params = set(inspect.signature(BatchedSimulation.__init__).parameters)
    assert {k.name for k in KNOBS} <= params, {k.name for k in KNOBS} - params
    sim = _build()
    assert set(sim.tuning_statics()) == names
    sim.close()


def test_cpu_build_refuses_graphs_through_a_profile(tiny_profile_doc):
    """graphs=True builds on the card only: a CPU profile asking for it
    raises at load, a card profile on a CPU build raises on the device
    type, and the engine's own refusal stands behind both."""
    statics = dict(tiny_profile_doc["statics"], graphs=True)
    with pytest.raises(ValueError, match="'graphs'.*does not build on 'cpu'"):
        _build(tuned_profile=dict(tiny_profile_doc, statics=statics))
    with pytest.raises(GeometryMismatch, match="backend"):
        _build(tuned_profile=dict(tiny_profile_doc, backend="cuda", statics=statics))
    with pytest.raises(ValueError, match="graphs=True needs the card"):
        _build(graphs=True)


# ------------------------------------------------------------ real backend


def test_real_sweep_on_the_cpu(tmp_path):
    """The REAL measurement sweep (run.run_tune) on the composed line's CPU
    cut: complete, chosen <= baseline, and in the written profile every
    candidate with >= 5 valid spans, no capture after its seal (the
    sentinel raises inside measure(), which also held the grid to the
    first candidate's state and decisions) and one fingerprint."""
    rec = run_tune("cpu", json_path=str(tmp_path / "real.json"), log=lambda msg: None)
    tune = rec["tune"]
    assert tune["measurement"] == "bench" and tune["backend"] == "cpu"
    assert tune["complete"] is True and tune["roundtrip_build_identical"] is True
    assert tune["objective"] <= tune["baseline_objective"]
    assert tune["baseline"] == default_statics("cpu")
    doc = json.loads((tmp_path / "real.json").read_text())
    assert doc["statics"] == tune["chosen"]
    assert len({c["fingerprint"] for c in doc["candidates"]}) == 1
    assert tune["metric_drift"] == [{}] * tune["measured"]  # the CPU's routes agree on every bit
    assert {c["statics"]["graphs"] for c in doc["candidates"]} == {False}
    assert len(doc["candidates"]) >= 4  # baseline, megakernel, razor, stream
    for cand in doc["candidates"]:
        assert cand["recompiles_after_warmup"] == 0
        assert cand["spans"]["n"] >= 5 and cand["spans"]["min"] > 0
    assert load_profile(str(tmp_path / "real.json")).statics == tune["chosen"]


# ------------------------------------------------------------------ fleet


def test_fleet_applies_the_profile(tiny_profile_doc, tmp_path):
    path = str(tmp_path / "tiny.json")
    save_profile(tiny_profile_doc, path)
    fleet = ScenarioFleet(
        SimulationConfig.from_yaml(TINY_YAML), *tiny_events("port"), n_lanes=2, horizon=150.0, device="cpu",
        fast_forward=False, tuned_profile=path,
    )
    assert fleet.tuned_profile is not None and fleet.tuned_profile.source == path
    assert fleet.engine.tuning_statics() == tiny_profile_doc["statics"]
    fleet.close()
    plain = ScenarioFleet(
        SimulationConfig.from_yaml(TINY_YAML), *tiny_events("port"), n_lanes=2, horizon=150.0, device="cpu",
        fast_forward=False,
    )
    assert plain.tuned_profile is None and plain.engine.tuning_statics() == default_statics("cpu")
    plain.close()


# ----------------------------------------------------------- command line


def test_command_line_fake_line_prints_its_record(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["TMPDIR"] = str(tmp_path)
    out = str(tmp_path / "fake.json")
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetriks_tpu_torch.tune", "--fake", "--device", "cpu", "--json", out],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["unit"] == "ms/window" and rec["value"] == pytest.approx(92.0)
    tune = rec["tune"]
    assert tune["measurement"] == "fake" and tune["backend"] == "cpu" and tune["profile"] == out
    assert tune["chosen"] == dict(default_statics("cpu"), megakernel=False, window_razor=True)
    assert tune["roundtrip_build_identical"] is True and tune["complete"] is True
    assert load_profile(out).statics == tune["chosen"]
