"""The comparison that decides `correct`: the program's pods and counters
of one lane against the reference's.

The program's window ends at a window boundary T with the scheduling
cycle at T already committed (its bindings land a fraction of a second
after T). The reference is stepped to T + half a cycle, where that
cycle's bindings have landed and the next cycle has not run. A pod the
program has not created yet is not compared; every other resident pod is:

- running on the program: bound in the reference to the same node, with
  the same start (it may have finished there in the half cycle);
- succeeded: succeeded in the reference, same node, same start;
- queued or parked: not bound in the reference.

Starts agree to START_TOL_S: the program keeps times as float32
offsets in 10 s windows (a few microseconds at most), the reference in
float64. Counters must be equal.
"""

from __future__ import annotations

from typing import Dict

START_TOL_S = 1e-3
# Differing pods printed for a run's record.
EXAMPLES = 5
# The program's pod phases (kubernetriks_tpu_torch/batched/state.py).
EMPTY, QUEUED, UNSCHEDULABLE, RUNNING, SUCCEEDED, REMOVED, FAILED = range(7)


def pods(view: Dict[str, Dict], ref: Dict[str, Dict]) -> Dict[str, int]:
    """Mismatch counts of the program's pod_view against the reference's
    pods of the same names ({"compared": n, "node": .., "state": ..,
    "start": ..})."""
    out = {"compared": 0, "state": 0, "node": 0, "start": 0, "examples": []}
    for name, b in view.items():
        phase = b["phase"]
        if phase == EMPTY:
            continue
        r = ref[name]
        out["compared"] += 1
        wrong = None
        if phase in (RUNNING, SUCCEEDED):
            if not (r["state"] == "succeeded" or (phase == RUNNING and r["state"] == "running")):
                wrong = "state"
            elif r["node"] != b["node"]:
                wrong = "node"
            elif r["start"] is None or abs(r["start"] - b["start_time"]) > START_TOL_S:
                wrong = "start"
        elif phase in (QUEUED, UNSCHEDULABLE):
            if r["state"] != "waiting":
                wrong = "state"
        elif r["state"] in ("running", "waiting"):
            wrong = "state"
        if wrong:
            out[wrong] += 1
            if len(out["examples"]) < EXAMPLES:
                out["examples"].append({"pod": name, "program": b, "reference": r})
    return out


def counters(program: Dict[str, int], ref: Dict[str, int]) -> int:
    """How many of the reference's counters the program's differ from (one
    the program lacks differs)."""
    return sum(int(program.get(k) != v) for k, v in ref.items())
