"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "kbench/run.py"]
    assert manifest["paths"] == ["kbench"]
    assert all(line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_check_budget_fits_24_cells(manifest):
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for group in ("configs", "workloads"):
        got = [x["name"] for x in manifest[group]]
        assert len(got) == len(set(got))
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in manifest["workloads"]} == set(names)
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(manifest["workloads"]) // 4)


def reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(manifest):
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in manifest["end_to_end"])
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in manifest["end_to_end"] if reported(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reported(m, w["name"]) for m in manifest["per_layer"])


def test_moves_target_is_reported_wherever_the_layer_metric_is(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in cells:
            if reported(m, cell):
                assert reported(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_named_file_exists_and_is_found_by_name(manifest):
    from kbench import run

    for c in manifest["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("kbench/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / "kbench" / "tracegen" / f"{cfg['generator']}.py").is_file()
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for w in manifest["workloads"]:
        spec = run.find(manifest, w["name"], ROOT)
        assert (ROOT / "kbench" / "drivers" / f"{spec['traffic']['driver']}.py").is_file()
        run.module("drivers", spec["traffic"]["driver"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(run.module("metrics", m["name"]).read)
    from kbench.roofline import event_scatter, schedule_cycle, select_cycle_commit

    for mod in (event_scatter, schedule_cycle, select_cycle_commit):
        assert mod.NAMES and callable(mod.need)
