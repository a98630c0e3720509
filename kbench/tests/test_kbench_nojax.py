"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's),
and the plain reference loads nothing of the program."""

import ast
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SETUP_PROBE = r"""
import argparse, copy, json, sys
sys.path.insert(0, sys.argv[1])
from kbench import run as harness
spec = copy.deepcopy(harness.find(harness.load_manifest(), "alibaba-v2017.sweep1024"))
spec["config"]["cluster"]["machines"] = 32
spec["config"]["workload"]["tasks_per_day"] = 2000
spec["traffic"].update(lanes=2, warm_until=300.0, check_lanes=1, trace_days=0.5)
spec["traffic"]["engine"] = {"pod_window": 128}
args = argparse.Namespace(workload="alibaba-v2017.sweep1024", seed=3, seconds=0.5, trace=0)
result = harness.execute(spec, args, "cpu")
assert result["correct"], result
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SETUP_PROBE, str(ROOT)], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "kbench" / ".cache")})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "kubernetriks_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "kubernetriks_tpu"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from kbench import run as harness

    for name in list(sys.modules):
        if name.split(".", 1)[0] in harness.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "kubernetriks_tpu_torch_like", types.ModuleType("kubernetriks_tpu_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "kubernetriks_tpu.batched", types.ModuleType("kubernetriks_tpu.batched"))
    assert harness.forbidden_modules() == ["jax", "kubernetriks_tpu"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_the_reference_imports_nothing_of_the_program():
    ref = ROOT / "kbench" / "reference"
    for path in ref.rglob("*.py"):
        roots = set(imported_roots(path))
        assert not roots & {"kubernetriks_tpu_torch", "kubernetriks_tpu", "jax", "jaxlib", "flax", "torch"}, path
    probe = ("import sys; sys.path.insert(0, sys.argv[1]); import kbench.reference.replay, "
             "kbench.reference.compare; print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "kubernetriks_tpu_torch" not in out.stdout and "'torch'" not in out.stdout
