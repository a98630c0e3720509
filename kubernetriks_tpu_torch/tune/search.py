"""Deterministic, resumable staged coordinate descent over the knob
registry (reference `kubernetriks_tpu/tune/search.py`, own copy; the
algorithm is the reference's, step for step).

The search walks the registry's stages in declaration order (executor ->
layout -> memory); within a stage it fixes one knob at a time: measure
every value of the knob that the backend's device can build, with all
other knobs held at the current config, keep the best, move on.
Dependent knobs (`requires`) are skipped while inactive: turning
`stream` on in the memory stage activates `stream_depth` right after it,
in the same pass. No randomness, no wall-clock input: the visit order is
the registry order, ties break toward the earlier candidate, and resumed
runs replay cached measurements: same measurements in, same chosen
config out.

Resume and budget: every measurement is keyed by the canonical statics
JSON (measure.canonical_key). A prior profile's `candidates` list is the
resume cache: already measured candidates are reused (disclosed with
`"reused": true`), and `budget` caps NEW measurements a run
(KTPU_TUNE_BUDGET): an exhausted budget stops the sweep, the partial
profile records `complete: false`, and the next run continues where this
one stopped.

The chosen config is the argmin over EVERYTHING measured: the descent
path, seed configs and resumed candidates alike.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

from kubernetriks_tpu_torch.tune import knobs
from kubernetriks_tpu_torch.tune.measure import canonical_key


class TuneResult(NamedTuple):
    chosen: Dict[str, object]  # the winning statics table
    objective: float  # its measured objective score
    baseline: Dict[str, object]  # hand-picked defaults + their score
    candidates: List[Dict[str, object]]  # every candidate, visit order
    measured: int  # NEW measurements this run
    reused: int  # resume-cache hits this run
    complete: bool  # False = budget stopped the sweep early
    fingerprint: str  # the grid's (shared) semantic fingerprint


class BudgetExhausted(Exception):
    """Internal control flow: the measurement budget ran out."""


def staged_coordinate_descent(
    backend,
    *,
    budget: Optional[int] = None,
    resume_candidates: Optional[Sequence[Dict[str, object]]] = None,
    seed_configs: Sequence[Dict[str, object]] = (),
    log: Optional[Callable[[str], None]] = None,
) -> TuneResult:
    """Run the sweep. `backend` is any object with `device_type` and
    `measure(statics) -> Measurement`; `seed_configs` are partial statics
    tables (merged over the defaults) that are always measured before the
    descent: reference configurations the chosen config must match or
    beat."""
    device = backend.device_type
    resume_cache: Dict[str, Dict[str, object]] = {}
    for entry in resume_candidates or ():
        if isinstance(entry, dict) and "statics" in entry and "objective" in entry:
            resume_cache[canonical_key(entry["statics"])] = entry

    cache: Dict[str, Dict[str, object]] = {}
    candidates: List[Dict[str, object]] = []
    counts = {"measured": 0, "reused": 0}

    def note(msg: str) -> None:
        if log is not None:
            log(msg)

    def evaluate(config: Dict[str, object]) -> Dict[str, object]:
        key = canonical_key(config)
        if key in cache:
            return cache[key]
        if key in resume_cache:
            entry = dict(resume_cache[key])
            entry["reused"] = True
            counts["reused"] += 1
            note(f"tune: reused {key}")
        else:
            if budget is not None and counts["measured"] >= budget:
                raise BudgetExhausted(key)
            m = backend.measure(config)
            entry = {"statics": dict(config), "reused": False}
            entry.update(m.as_record())
            counts["measured"] += 1
            note(f"tune: measured {key} -> objective {entry['objective']}")
        cache[key] = entry
        candidates.append(entry)
        return entry

    config = knobs.default_statics(device)
    complete = True
    try:
        evaluate(config)  # the hand-picked baseline is always candidate 0
        for seed in seed_configs:
            merged = dict(config)
            merged.update(seed)
            evaluate(merged)
        for stage in knobs.STAGES:
            for knob in knobs.KNOBS:
                if knob.stage != stage or knob.values is None:
                    continue
                if not knobs.is_active(knob, config, device):
                    continue
                best_val = config[knob.name]
                best_obj = evaluate(config)["objective"]
                for value in knobs.legal_values(knob, device):
                    cand = dict(config)
                    cand[knob.name] = value
                    obj = evaluate(cand)["objective"]
                    if obj < best_obj:
                        best_obj, best_val = obj, value
                config[knob.name] = best_val
    except BudgetExhausted as exc:
        complete = False
        note(
            f"tune: budget of {budget} new measurements exhausted at {exc}: partial profile; rerun with it as "
            "resume input"
        )

    if not candidates:
        raise ValueError(
            "tune: the measurement budget did not cover even the baseline configuration: raise KTPU_TUNE_BUDGET"
        )
    # Argmin over everything measured; ties break toward the earliest
    # candidate (the visit order is deterministic).
    chosen = min(enumerate(candidates), key=lambda t: (t[1]["objective"], t[0]))[1]
    baseline = candidates[0]
    return TuneResult(
        chosen=dict(chosen["statics"]),
        objective=float(chosen["objective"]),
        baseline={"statics": dict(baseline["statics"]), "objective": float(baseline["objective"])},
        candidates=candidates,
        measured=counts["measured"],
        reused=counts["reused"],
        complete=complete,
        fingerprint=str(chosen.get("fingerprint", "")),
    )


def profile_doc(
    result: TuneResult,
    *,
    backend: str,
    n_clusters: int,
    n_nodes: int,
    budget: Optional[int] = None,
    protocol: str = "",
) -> Dict[str, object]:
    """Compose the persistable profile document (profile.save_profile
    validates and writes it): the chosen statics, the objective
    definition, the baseline, budget accounting and EVERY measured
    candidate. `backend` is the device type the sweep ran on."""
    return {
        "kind": "ktpu-tuned-profile",
        "schema": 1,
        "backend": backend,
        "geometry": {"n_clusters": int(n_clusters), "n_nodes": int(n_nodes)},
        "statics": dict(result.chosen),
        "objective": {
            "score": result.objective,
            "definition": (
                "host ms a window of the window-chunk and slide spans over the timed spans (ms_per_window), "
                "scaled by 1 + 0.25 per fired observatory stall/occupancy verdict "
                "(telemetry/observatory.tuning_objective); lower is better"
            ),
        },
        "baseline": result.baseline,
        "complete": result.complete,
        "budget": {"limit": budget, "measured": result.measured, "reused": result.reused},
        "protocol": protocol,
        "fingerprint": result.fingerprint,
        "candidates": result.candidates,
        "knob_registry": {
            k.name: {
                "kind": k.kind,
                "values": list(k.values) if k.values is not None else None,
                "default": k.default,
                "device_values": (
                    {d: list(v) for d, v in k.device_values.items()} if k.device_values is not None else None
                ),
                "stage": k.stage,
                "recompile": k.recompile,
                "requires": [list(r) for r in k.requires],
            }
            for k in knobs.KNOBS
        },
    }
