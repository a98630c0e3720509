#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 kbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration and its traffic
are found by name: BENCHMARK.json's `workloads` entry, the configuration
file it names, `kbench/traffic/<cell>.json` and the driver that file
names (`kbench/drivers/<driver>.py`). Each metric the cell reports is read
by `kbench/metrics/<metric>.py` (or its base name's). With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics. Both check the
timed path's output against the plain reference (`kbench/reference/`).
The last line of standard output is one JSON object; everything else goes
to standard error.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kubernetriks_tpu")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def fail(msg: str, code: int = 1) -> None:
    print(f"kbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        fail(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def find(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metric lists, by name."""
    if not NAME.fullmatch(workload):
        fail(f"bad workload name {workload!r}")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_entry = configs[cell["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(root / "kbench" / "traffic" / f"{workload}.json") as f:
        traffic = json.load(f)

    def reported(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in manifest["end_to_end"] if reported(m)],
        "per_layer": [m for m in manifest["per_layer"] if reported(m)],
    }


def module(kind: str, name: str):
    """kbench/<kind>/<name>.py, found by name (a name's dots become
    underscores in the file name). A name `<base>.<part>` with no file of
    its own is `<base>`'s: one reader serves a metric split by the cells
    that report it (`decisions_per_s.replay`)."""
    if not NAME.fullmatch(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = f"kbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError as e:
        if e.name != path or "." not in name:
            raise
        return module(kind, name.rsplit(".", 1)[0])


def device_block(torch, chips: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
    }


def execute(spec: dict, args, device: str, chips: int = 1) -> dict:
    """Set-up, window, metrics and check of one run on `device`; returns
    the result's object (tests drive it on the CPU)."""
    import torch

    driver = module("drivers", spec["traffic"]["driver"])
    run = driver.Run(spec, args, PROCESS_START, device)
    try:
        try:
            run.setup()
            run.window(traced=bool(args.trace))
            device_info = device_block(torch, chips) if device == "cuda" else {"platform": "cpu"}
            names = spec["per_layer"] if args.trace else spec["end_to_end"]
            metrics = {}
            for m in names:
                value = module("metrics", m["name"]).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if args.trace:
                device_info["busy_s"] = run.trace["busy_s"]
                device_info["window_s"] = run.trace["window_s"]
            outcome = run.outputs()
        finally:
            run.close()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        checks = run.check(outcome)
    finally:
        run.cleanup()
    found = forbidden_modules()
    if found:
        fail(f"the run loaded {found}: the benchmark and the program may not import JAX or the JAX package")
    for c in checks:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info,
    }
    if args.trace:
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The program's kernel builds go to fixed directories inside the
    # checkout (kubernetriks_tpu_torch/ops/build, trace/build); these are
    # for any other compiler cache a library opens.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "kbench" / ".cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "kbench" / ".cache" / "triton")
    os.environ["USE_FLAX"] = "0"

    manifest = load_manifest()
    spec = find(manifest, args.workload)
    chips = int(spec["cell"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(f"the cell needs {chips} CUDA device(s); found {found}", code=3)
    torch.cuda.init()
    for i in range(chips):
        torch.cuda.reset_peak_memory_stats(i)

    result = execute(spec, args, "cuda", chips)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
