"""ktpu-lint over the port (kubernetriks_tpu_torch/lint/): the port's
default scope is golden-clean under all nine passes with no stale waiver,
every seeded fixture under tests/lint_fixtures/torch/ is caught by its
pass, the CLI's exit codes and JSON, the waiver and stale-waiver rules,
the state-leaf gate against the real tree, the manifests against the live
NamedTuples, and, for the passes that read the same inputs (envflags,
feederlock, the numpy/stdlib half of prng), the same findings as the JAX
package's lint on its own fixtures."""

import json
import os

import pytest

from kubernetriks_tpu_torch.lint import PASS_IDS, collect_files, is_hot, run_lint, run_lint_report
from kubernetriks_tpu_torch.lint.__main__ import default_paths, main as lint_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "lint_fixtures", "torch")


def _fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def test_port_scope_is_golden_clean():
    """The port's whole default scope (the package, the card scripts, the
    port's tests) lints clean under all nine passes, every legitimate
    read, draw, mix and rebinding carrying a waiver with its reason, and
    carries no stale waiver."""
    scope = default_paths(ROOT)
    assert "kubernetriks_tpu_torch" in scope and "chip_smoke.py" in scope
    assert any(p.startswith(os.path.join("tests", "test_torch_")) for p in scope)
    report = run_lint_report(scope, ROOT)
    assert report.violations == [], "\n".join(v.render() for v in report.violations)
    assert report.stale_waivers == [], "\n".join(w.render() for w in report.stale_waivers)
    assert lint_main(["--root", ROOT, "--strict-waivers"]) == 0


def test_cli_exit_codes(tmp_path):
    """0 on clean input, 1 on a seeded violation, 2 on a usage error (an
    unknown pass, nothing to lint)."""
    assert lint_main(["--root", ROOT, "kubernetriks_tpu_torch/flags.py"]) == 0
    assert lint_main(["--root", ROOT, _fixture("envflags_direct_read.py")]) == 1
    with pytest.raises(SystemExit) as exc:
        lint_main(["--root", ROOT, "--pass", "donation"])
    assert exc.value.code == 2
    assert lint_main(["--root", str(tmp_path)]) == 2


# (fixture file, pass id, expected minimum violations, message fragment)
FIXTURE_CASES = [
    ("envflags_direct_read.py", "envflags", 3, "not declared"),
    ("prng_torch_draws.py", "prng", 4, "without generator="),
    ("hostsync_torch_syncs.py", "hostsync", 9, ".item()"),
    ("feederlock_torch_synchronize.py", "feederlock", 4, "HOLDING the ring lock"),
    ("stateleaf_missing_leaf.py", "stateleaf", 2, "scratch_probe"),
    ("scenariotrace_piece_key.py", "scenariotrace", 5, "piece key"),
    ("shapecontract_lane_mix.py", "shapecontract", 3, "[:, None]"),
    ("capture_rebind.py", "capture", 3, "self._state"),
    ("graphstatic_coupled.py", "graphstatic", 3, "travel together"),
]


def test_every_pass_has_a_fixture():
    assert sorted({c[1] for c in FIXTURE_CASES}) == sorted(PASS_IDS)


@pytest.mark.parametrize(
    "fixture,pass_id,min_violations,fragment", FIXTURE_CASES, ids=[c[0] for c in FIXTURE_CASES]
)
def test_fixture_caught(fixture, pass_id, min_violations, fragment):
    """Each seeded fixture is caught by its pass, alone and among all nine
    (passes don't mask each other), and the CLI gates on it."""
    violations = run_lint([_fixture(fixture)], ROOT, passes=[pass_id])
    rendered = "\n".join(v.render() for v in violations)
    assert len(violations) >= min_violations, rendered or "no violations"
    assert any(fragment in v.message for v in violations), rendered
    assert all(v.pass_id == pass_id for v in violations)
    assert any(v.pass_id == pass_id for v in run_lint([_fixture(fixture)], ROOT))
    assert lint_main(["--root", ROOT, "--strict-waivers", _fixture(fixture)]) == 1


def test_fixture_clean_lines_stay_quiet():
    """The lines each fixture marks fine (a named generator, a presence
    check, an explicit expansion, a rebuild after the rebinding, all three
    coupled keywords or none) are not flagged."""
    for fixture, pass_id, _, _ in FIXTURE_CASES:
        src = open(os.path.join(ROOT, _fixture(fixture)), encoding="utf-8").read().splitlines()
        fine = {i for i, line in enumerate(src, 1) if "# fine" in line}
        flagged = {v.line for v in run_lint([_fixture(fixture)], ROOT, passes=[pass_id])}
        assert not fine & flagged, (fixture, sorted(fine & flagged))


def test_waiver_counts_only_with_a_reason(tmp_path):
    """A sync-ok waiver suppresses exactly its line; an empty reason
    suppresses nothing."""
    (tmp_path / "waived.py").write_text(
        "# ktpu: hot-path\n"
        "def readout(state):\n"
        "    a = state.time.item()  # ktpu: sync-ok(the span's one read)\n"
        "    b = state.time.item()  # ktpu: sync-ok()\n"
        "    c = state.time.item()\n"
        "    return a + b + c\n",
        encoding="utf-8",
    )
    lines = {v.line for v in run_lint(["waived.py"], str(tmp_path), passes=["hostsync"])}
    assert lines == {4, 5}


def test_stale_waiver_detection(tmp_path):
    """A waiver whose line no longer triggers its pass is reported stale;
    a load-bearing one is not; an unknown tag always is (a JAX-only tag
    among them). The CLI exits 0 by default and 1 under --strict-waivers;
    under a --pass filter other passes' waivers stay unjudged."""
    (tmp_path / "stale.py").write_text(
        "# ktpu: hot-path\n"
        "def readout(state):\n"
        "    n = state.total.item()  # ktpu: sync-ok(readout at a span boundary)\n"
        "    m = 1 + 1  # ktpu: sync-ok(nothing here syncs any more)\n"
        "    k = 2  # ktpu: donation-ok(no donation on the card)\n"
        "    return n + m + k\n",
        encoding="utf-8",
    )
    report = run_lint_report(["stale.py"], str(tmp_path))
    assert report.violations == []
    lines = {w.line for w in report.stale_waivers}
    assert 4 in lines and 3 not in lines
    assert any(w.line == 5 and "unknown waiver tag" in w.message for w in report.stale_waivers)
    assert lint_main(["--root", str(tmp_path), "stale.py"]) == 0
    assert lint_main(["--root", str(tmp_path), "--strict-waivers", "stale.py"]) == 1
    (tmp_path / "filtered.py").write_text(
        "# ktpu: hot-path\n"
        "def f(state):\n"
        "    return state.total.item()  # ktpu: sync-ok(span boundary)\n",
        encoding="utf-8",
    )
    assert lint_main(["--root", str(tmp_path), "--strict-waivers", "--pass", "envflags", "filtered.py"]) == 0


def test_json_and_github_output(tmp_path, capsys):
    out_path = tmp_path / "lint.json"
    rc = lint_main(["--root", ROOT, "--json", str(out_path), _fixture("scenariotrace_piece_key.py")])
    assert rc == 1
    payload = json.loads(out_path.read_text())
    assert payload["counts"]["violations"] >= 5 and payload["passes"] == list(PASS_IDS)
    rec = payload["violations"][0]
    assert set(rec) >= {"file", "line", "pass", "message"} and rec["pass"] == "scenariotrace"
    assert rec["file"].endswith("scenariotrace_piece_key.py")
    capsys.readouterr()
    lint_main(["--root", ROOT, "--github", _fixture("capture_rebind.py")])
    out = capsys.readouterr().out
    assert "::error file=" in out and "ktpu-lint[capture]" in out
    lint_main(["--root", ROOT, "--list-waivers", "kubernetriks_tpu_torch/sim/kernel.py"])
    assert "prng-ok(" in capsys.readouterr().out


def test_stateleaf_scratch_leaf_fails_against_real_tree(tmp_path):
    """A scratch leaf added to the REAL ClusterBatchState without touching
    any registry fails, naming the leaf, the manifest and the by-name
    consumer that misses it (init_state); the untouched copy is clean."""
    src = open(os.path.join(ROOT, "kubernetriks_tpu_torch", "batched", "state.py"), encoding="utf-8").read()
    dest_dir = tmp_path / "kubernetriks_tpu_torch" / "batched"
    dest_dir.mkdir(parents=True)
    dest = dest_dir / "state.py"
    rel = "kubernetriks_tpu_torch/batched/state.py"
    dest.write_text(src, encoding="utf-8")
    assert run_lint([rel], str(tmp_path), passes=["stateleaf"]) == []
    marker = "    nodes: NodeArrays\n"
    assert marker in src, "ClusterBatchState layout changed; update the test"
    dest.write_text(src.replace(marker, "    scratch_probe: torch.Tensor\n" + marker, 1), encoding="utf-8")
    violations = run_lint([rel], str(tmp_path), passes=["stateleaf"])
    rendered = "\n".join(v.render() for v in violations)
    assert any("scratch_probe" in v.message and "CLUSTER_STATE_LEAVES" in v.message for v in violations), rendered
    assert any("scratch_probe" in v.message and "init-state" in v.message for v in violations), rendered
    assert lint_main(["--root", str(tmp_path), rel]) == 1


def test_manifests_equal_the_live_namedtuples():
    """The AST-read manifests equal the live fields, the scenario and axis
    registries name real leaves, and the scenariotrace pass's fallback
    copy equals the module manifests."""
    from kubernetriks_tpu_torch.batched import autoscale, state
    from kubernetriks_tpu_torch.batched.step import FaultStep
    from kubernetriks_tpu_torch.lint.scenariotrace import DEFAULT_TRACED

    assert state.CLUSTER_STATE_LEAVES == state.ClusterBatchState._fields
    assert state.TELEMETRY_RING_LEAVES == state.TelemetryRing._fields
    assert state.AUTOSCALE_STATE_LEAVES == state.AutoscaleState._fields
    assert state.LANE_CLOCK_LEAVES == state.LaneClocks._fields
    assert set(autoscale.SCENARIO_TRACED_LEAVES) <= set(autoscale.AutoscaleStatics._fields)
    assert set(state.SCENARIO_TRACED_CONSTS) <= set(state.LaneClocks._fields) | set(FaultStep._fields)
    assert DEFAULT_TRACED == set(autoscale.SCENARIO_TRACED_LEAVES) | set(state.SCENARIO_TRACED_CONSTS)
    known = (
        set(autoscale.AutoscaleStatics._fields)
        | set(state.AutoscaleState._fields)
        | set(state.ClusterBatchState._fields)
        | set(state.NodeArrays._fields)
        | set(state.PodArrays._fields)
        | set(state.MetricArrays._fields)
        | set(state.LaneClocks._fields)
    )
    for reg in (state.AXIS_SIGNATURES, autoscale.AXIS_SIGNATURES):
        assert not set(reg) - known, set(reg) - known


def test_hot_modules_and_their_sync_budget():
    """The hot modules are the ones the stepping loop runs, and every
    sync-ok waiver in them is a def or a line the hostsync pass needs."""
    hot = [sf.path for sf in collect_files(["kubernetriks_tpu_torch"], ROOT) if is_hot(sf)]
    for name in ("step.py", "engine.py", "autoscale.py", "graphs.py", "fleet.py"):
        assert f"kubernetriks_tpu_torch/batched/{name}" in hot
    assert any(p.startswith("kubernetriks_tpu_torch/ops/") for p in hot)
    report = run_lint_report(hot, ROOT, passes=["hostsync"])
    assert report.violations == [] and report.stale_waivers == []


@pytest.mark.parametrize("pattern", ["envflags_", "feederlock_", "prng_np_random"])
def test_same_findings_as_the_jax_lint_on_its_fixtures(pattern):
    """On the JAX package's own fixtures, the port's envflags, feederlock
    and numpy/stdlib prng passes find the same (line, pass) set as the JAX
    package's lint."""
    from kubernetriks_tpu import lint as jax_lint

    names = sorted(n for n in os.listdir(os.path.join(ROOT, "tests", "lint_fixtures")) if n.startswith(pattern))
    assert names
    for name in names:
        path = os.path.join("tests", "lint_fixtures", name)
        pass_id = name.split("_")[0]
        mine = {(v.line, v.pass_id) for v in run_lint([path], ROOT, passes=[pass_id])}
        theirs = {(v.line, v.pass_id) for v in jax_lint.run_lint([path], ROOT, passes=[pass_id])}
        assert mine == theirs and mine, (name, mine, theirs)
