#!/usr/bin/env python3
"""The control: the plain reference put in the program's place, its
scores computed in bfloat16, the nearest precision below the float32
that the configurations state. It has to come out as not correct.

    python3 kbench/reference/control.py --workload <cell> --seed <n> --until <t>

Draws the cell's inputs, scenarios and checked lanes from the seed as a
run does, steps the bfloat16 reference of each checked lane to `until`
(a time a window of the cell reaches) and judges it as a run's output is
judged. Prints one JSON line: the readings and whether it would pass.
Needs no card; keep it beside the runs that set the limits.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from kbench import run as harness  # noqa: E402
from kbench.drivers import stepping  # noqa: E402
from kbench.reference import compare, replay  # noqa: E402

# The oracle's pod states as the program's phases.
PHASES = {"running": compare.RUNNING, "succeeded": compare.SUCCEEDED, "waiting": compare.QUEUED,
          "absent": compare.EMPTY}


def as_program_view(ref_pods):
    return {n: {"phase": PHASES[p["state"]], "node": p["node"], "start_time": p["start"]} for n, p in ref_pods.items()}


def readings(spec: dict, seed: int, until: float, precision: str = "bfloat16") -> dict:
    """The check's numbers for `precision`'s reference in the program's
    place, at the cell's own size (its lanes, scenarios and inputs, drawn
    from the seed as a run draws them)."""
    args = argparse.Namespace(workload=spec["cell"]["name"], seed=seed, seconds=0.0, trace=0)
    run = stepping.Run(spec, args, 0.0, device="cpu")
    try:
        run.inputs, run.scenario, run.check_lanes = stepping.draw(spec, seed, str(Path(run.tmp) / "inputs"))
        bounds = {**spec["config"].get("engine", {}), **spec["traffic"].get("engine", {})}
        half = 0.5 * float(spec["config"]["simulation"]["scheduling_cycle_interval"])
        names = _pod_names(run.inputs, until)
        out = {"t": until, "lanes": {}}
        for lane in run.check_lanes:
            ref = replay.readout(run.inputs, stepping.lane_scenario(run.scenario, lane), bounds, precision, until,
                                 half, names)
            out["lanes"][lane] = {"pods": as_program_view(ref["pods"]), "counters": replay.expected(ref)}
        checks = run.check(out)
        return {c["name"]: c["value"] for c in checks} | {"pods_compared": run.check_detail["pods_compared"]}
    finally:
        run.cleanup()


def _pod_names(inputs, until: float):
    """The pods the reference has created by `until` (the names its
    storage holds), of the last few hours: what a run's resident window
    shows."""
    _, workload = inputs.reference_events()
    return [e.pod.metadata.name for t, e in workload if until - 4 * 3600.0 <= t <= until]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--until", type=float, required=True)
    ap.add_argument("--precision", default="bfloat16")
    args = ap.parse_args(argv)
    spec = harness.find(harness.load_manifest(), args.workload)
    got = readings(spec, args.seed, args.until, args.precision)
    limits = spec["traffic"]["limits"]
    got["correct"] = all(got[k] <= limits[k] for k in limits)
    got.update(workload=args.workload, seed=args.seed, until=args.until, precision=args.precision)
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
