"""A later change adds a configuration, a cell and a per-layer metric by
adding files and manifest entries alone: a fixture cell and metric in a
copy of the benchmark, found by name, with no file of it edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

FIXTURE_METRIC = '''"""A fixture per-layer metric: windows the traced stretch ran."""


def read(run):
    return 1.0
'''


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    before = {p: p.read_bytes() for p in (ROOT / "kbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "kbench", root / "kbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((root / "kbench" / "configs" / "alibaba-v2017.json").read_text())
    config["name"] = "fixture-config"
    (root / "kbench" / "configs" / "fixture-config.json").write_text(json.dumps(config))
    traffic = json.loads((root / "kbench" / "traffic" / "alibaba-v2017.single.json").read_text())
    (root / "kbench" / "traffic" / "fixture-config.fixture.json").write_text(json.dumps(traffic))
    (root / "kbench" / "metrics" / "fixture_metric.py").write_text(FIXTURE_METRIC)
    manifest["configs"].append({"name": "fixture-config", "source": config["source"],
                                "file": "kbench/configs/fixture-config.json", "reduced": [], "why": "a fixture"})
    manifest["workloads"].append({"name": "fixture-config.fixture", "config": "fixture-config",
                                  "traffic": "fixture", "chips": 1, "why": "a fixture"})
    manifest["per_layer"].append({"name": "fixture_metric", "unit": "count", "better": "lower",
                                  "source": "program_counter", "layer": "engine", "moves": "decisions_per_s",
                                  "workloads": ["fixture-config.fixture"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    probe = (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
        "from kbench import run; root = Path(sys.argv[1]); m = run.load_manifest(root);"
        "spec = run.find(m, 'fixture-config.fixture', root);"
        "assert spec['config']['name'] == 'fixture-config';"
        "assert [x['name'] for x in spec['per_layer']][-1] == 'fixture_metric';"
        "assert run.module('metrics', 'fixture_metric').read(None) == 1.0;"
        "assert run.module('drivers', spec['traffic']['driver']).Run;"
        "assert run.__file__.startswith(sys.argv[1]); print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", probe, str(root)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    after = {p: p.read_bytes() for p in (ROOT / "kbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert after == before
