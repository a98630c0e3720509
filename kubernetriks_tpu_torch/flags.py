"""The port's environment flags: one registry, one parser each.

Every KTPU_* variable the port reads (and the scalar CLI's
KUBERNETRIKS_LOG) is declared here (name, type,
default, documentation) and read through the typed helpers below; a read
of an unregistered name raises. Names, types, defaults and meanings are
the JAX package's own (its `flags.py` registry), so one environment drives
either package the same way. Own copy: the port imports nothing of the
JAX package.

Truthiness (flag_bool / flag_tristate): unset gives the default (None for
a tristate); "0", "", "false", "no" and "off" (any case, trimmed) are
false; anything else is true.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional


class Flag(NamedTuple):
    name: str
    type: str  # "bool" | "tristate" | "str" | "int"
    default: object
    doc: str


_FLAGS = [
    Flag(
        "KTPU_MEGAKERNEL",
        "bool",
        True,
        "The dense cycle route from 128 clusters: 1 (default) runs "
        "selection, cycle and commit in one kernel (select_cycle_commit.cu); "
        "0 the two-kernel route (select_schedule_cycle.cu, then "
        "commit_scatter.cu). Read at engine build.",
    ),
    Flag(
        "KTPU_TRACE",
        "bool",
        False,
        "Flight recorder: the host span tracer over the engine's phases and "
        "the device ring of per-window records carried in the state "
        "(ClusterBatchState.telemetry). The engine's telemetry= argument "
        "supersedes it. Read out with telemetry_report(), "
        "telemetry_window_series(), write_chrome_trace(); the CLI prints the "
        "report and writes the Chrome trace. Off by default.",
    ),
    Flag(
        "KTPU_TRACE_PATH",
        "str",
        None,
        "Path stem of the Chrome trace-event JSON the CLI writes when the "
        "flight recorder is on. Unset: ktpu_trace in the working directory.",
    ),
    Flag(
        "KTPU_WATCHDOG",
        "tristate",
        None,
        "Saturation watchdog (telemetry/observatory.py): at every ring drain "
        "it fits the reserve-occupancy trajectories (CA node-slot reserve, "
        "HPA pod reserve, pod-window headroom) and warns "
        "(SaturationWarning) with an estimated time to exhaustion before "
        "the reserve bound raises. The engine's watchdog= argument "
        "supersedes it. Unset: armed exactly when the flight recorder is; "
        "1 with the recorder off raises at engine build.",
    ),
    Flag(
        "KTPU_STREAM",
        "tristate",
        None,
        "Streaming feeder (batched/stream.py) under the sliding pod window: a "
        "feeder thread assembles the slide's refill payload a segment at a "
        "time into a bounded ring of K staging slabs on the device, running "
        "ahead of the engine, so the whole-trace payload is never put on the "
        "device. The engine's stream= argument supersedes it. Unset: on for "
        "the card, off on the CPU.",
    ),
    Flag(
        "KTPU_STREAM_DEPTH",
        "int",
        3,
        "Ring depth K of the streaming feeder: the ring holds K slabs on the "
        "device, or as many as the trace still needs from the feeder's base "
        "where that is fewer, and the slide reads them in place (the memory "
        "bound: no other staging buffer). At the default width a ring that "
        "would hold the whole payload's columns is one slab of it. K = 1 "
        "stages one slab at a time, off the engine's thread, and stays exact.",
    ),
    Flag(
        "KTPU_STREAM_SEGMENT",
        "int",
        None,
        "Width (payload columns) of the streaming feeder's slabs. Unset: 4x "
        "the pod window, clamped to [W + W/2, the whole payload] (and the "
        "whole payload where K slabs of 4W would hold as much).",
    ),
    Flag(
        "KTPU_WINDOW_RAZOR",
        "tristate",
        None,
        "Window-cost razor: a window with no event chunk runs its event "
        "tail behind a cheap due-ness predicate (step.window_work_due; a "
        "conditional node on graphs), so empty windows skip the masked "
        "elementwise passes. Bit-exact: the tail is skipped only where it is "
        "the identity. The engine's window_razor= argument supersedes it; a "
        "tuned profile's entry ranks below it. Unset: on for the card, off "
        "on the CPU.",
    ),
    Flag(
        "KTPU_RECLAIM",
        "tristate",
        None,
        "CA slot reclaim (batched/autoscale.py ca_reclaim_pass): a "
        "compaction at the head of the window returns fully retired CA "
        "reserve slots to their group, so ca_cursor tracks live occupancy "
        "and sustained churn never runs the reserve dry. Trajectories stay "
        "scalar-exact. The engine's reclaim= argument supersedes it. Unset: "
        "on for the card, off on the CPU. Forced off (warning) where the "
        "trace's node-name classes interleave; an explicit 1 raises there.",
    ),
    Flag(
        "KTPU_RECLAIM_PERIOD",
        "int",
        1,
        "Reclaim compaction cadence in windows: 1 (default) compacts in any "
        "window with a retired slot (a scale-up can then never starve while "
        "reclaimable slots exist); N > 1 compacts only in windows with (W + "
        "1) % N == 0, trading a transiently tighter reserve for less work. "
        "The engine's reclaim_period= argument supersedes it; a tuned "
        "profile's entry ranks below a set flag.",
    ),
    Flag(
        "KTPU_DEBUG_FINITE",
        "bool",
        False,
        "Guard mode: a host sweep of every float state leaf at each dispatch "
        "boundary (a span of windows, not each window), raising "
        "FloatingPointError that names the leaf holding a NaN, or an inf "
        "outside the documented sentinel leaves. Off by default: the "
        "stepping loop then adds no read.",
    ),
    Flag(
        "KTPU_SANITIZE",
        "bool",
        False,
        "Runtime sanitizer (sanitize.py): the engine's stepping loop "
        "(step_until_time, step_windows, run_to_completion) runs under "
        "torch.cuda.set_sync_debug_mode('error') on the card and the "
        "sanitizer's own thread-local guard on both devices, so any "
        "device-to-host read outside an allow_transfer scope raises; the "
        "KTPU_DEBUG_FINITE sweep and the captured-address check (a state leaf "
        "rebound behind the window executor's back raises, naming it) run "
        "at every dispatch boundary. The engine's sanitize_mode= argument "
        "supersedes it.",
    ),
    Flag(
        "KTPU_EXPLAIN_RECOMPILES",
        "tristate",
        None,
        "Recompile sentinel (recompile.py): the window executor publishes "
        "every CUDA graph capture with its piece key, and a sealed sentinel "
        "raises RecompileError naming the key of any capture after the "
        "warm-up, the runtime cross-check of the fleet's capture-once "
        "guarantee (the scenariotrace lint pass is the static half). Unset: "
        "armed only where code opts in; 1: ScenarioFleet seals a raising "
        "sentinel right after its build and guards every wave and pump "
        "round; 0: forced off everywhere.",
    ),
    Flag(
        "KTPU_PROFILE",
        "str",
        None,
        "Named scheduler profile for batched engines that were not handed "
        "an explicit profile (bench/CLI selection): 'default', 'best_fit' or "
        "'balanced_packing'. Compiled at engine build (batched/pipeline.py); "
        "an unknown name raises at construction instead of silently running "
        "the default. Unset: the config's scheduler_profile, else the "
        "default.",
    ),
    Flag(
        "KTPU_LANE_SPAN",
        "int",
        None,
        "Pump span (windows a round) of the lane-asynchronous fleet "
        "(batched/fleet.py pump()): each round steps every lane up to this "
        "many global windows, in power-of-two chunks clamped to the nearest "
        "lane's plan end, then re-seeds the lanes whose per-lane clock "
        "finished. Smaller spans cut completion latency and idle-lane waste "
        "at more dispatch overhead. The fleet's span_windows= argument "
        "supersedes it. Unset: 8.",
    ),
    Flag(
        "KTPU_HOST_CHAOS",
        "str",
        None,
        "Deterministic host-fault injection (batched/faults.py HostChaos): "
        "counter-seeded threefry draws fail the lane-asynchronous fleet's "
        "dispatches (the victim the least-faulted active lane), kill the "
        "stream feeder's producer and stall pump dispatches, so the fault "
        "domains (typed query errors, lane resets, quarantine, the feeder "
        "supervisor) can be proven. '1' selects the defaults "
        "(seed=7,dispatch=0.04,feeder=0.05,stall=0.03,stall_ms=2.0); a "
        "'k=v,...' spec overrides them. Unset: injection off.",
    ),
    Flag(
        "KTPU_FLEET_QUEUE",
        "int",
        None,
        "Bounded admission queue depth for ScenarioFleet.submit(): at most "
        "this many queries may be queued. A full queue applies the "
        "KTPU_FLEET_QUEUE_POLICY backpressure. The fleet's max_queue= "
        "argument supersedes it. Unset: unbounded.",
    ),
    Flag(
        "KTPU_FLEET_QUEUE_POLICY",
        "str",
        "reject",
        "Backpressure policy when the bounded admission queue is full: "
        "'reject' streams a RejectedError (with a retry_after_s hint from "
        "the observed service times) through poll() for the refused query; "
        "'block' makes submit() run waves inline until a queue slot frees. "
        "The fleet's queue_policy= argument supersedes it. Ignored while "
        "KTPU_FLEET_QUEUE is unset.",
    ),
    Flag(
        "KTPU_SLO_MS",
        "int",
        None,
        "Latency-SLO target in milliseconds (submit-to-drain wall) for "
        "lane-asynchronous fleet queries: arms the capacity observatory's "
        "SLO burn-rate verdicts (telemetry/observatory.py), fast and slow "
        "error-budget burn with hysteresis, windowed by "
        "KTPU_SLO_BURN_WINDOW. Unset: SLO verdicts disarmed.",
    ),
    Flag(
        "KTPU_SLO_BURN_WINDOW",
        "int",
        60,
        "Fast burn-rate window (wall seconds) of the SLO verdict; the slow "
        "window is 12x this. Default: 60.",
    ),
    Flag(
        "KTPU_TUNED_PROFILE",
        "str",
        None,
        "Tuned-statics profile for engine builds (tune/profile.py): a path "
        "to a profile JSON (strict: a missing file, an unknown knob or a "
        "device type or geometry mismatch raises, naming the field), or "
        "1/auto/true/on to resolve artifacts/tuned/ under the working "
        "directory, then the bundled kubernetriks_tpu_torch/tune/profiles/, "
        "by the build's device type (cuda or cpu) and cluster count (no "
        "match: the hand-picked statics, quietly). Per knob the profile "
        "ranks below an explicit build argument and the knob's own flag, "
        "above the device default. The engine's and the fleet's "
        "tuned_profile= argument supersedes it. Unset: no profile is "
        "consulted.",
    ),
    Flag(
        "KTPU_TUNE_BUDGET",
        "int",
        None,
        "Cap on new measurements a run of the statics autotuner "
        "(python -m kubernetriks_tpu_torch.tune) makes; candidates found "
        "in the profile it resumes from are free. An exhausted budget stops "
        "the sweep and writes a partial profile (complete: false), which a "
        "rerun resumes. Its --budget option supersedes it. Unset: the "
        "whole staged coordinate descent.",
    ),
    Flag(
        "KUBERNETRIKS_LOG",
        "str",
        "INFO",
        "CLI logging level (DEBUG/INFO/WARNING/ERROR).",
    ),
]

REGISTRY: Dict[str, Flag] = {f.name: f for f in _FLAGS}

_FALSY = frozenset({"0", "", "false", "no", "off"})


def _lookup(name: str, expected: str) -> Flag:
    flag = REGISTRY.get(name)
    if flag is None:
        raise KeyError(f"environment flag {name!r} is not registered in kubernetriks_tpu_torch.flags")
    if flag.type != expected:
        raise TypeError(f"environment flag {name!r} is registered as {flag.type!r}, read as {expected!r}")
    return flag


def parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in _FALSY


def flag_bool(name: str) -> bool:
    """Boolean flag: unset gives its default, else parse_bool."""
    flag = _lookup(name, "bool")
    raw = os.environ.get(name)
    return bool(flag.default) if raw is None else parse_bool(raw)


def flag_tristate(name: str) -> Optional[bool]:
    """Tristate flag: None when unset, else parse_bool."""
    _lookup(name, "tristate")
    raw = os.environ.get(name)
    return None if raw is None else parse_bool(raw)


def flag_str(name: str) -> Optional[str]:
    """String flag: unset gives its default (may be None)."""
    flag = _lookup(name, "str")
    raw = os.environ.get(name)
    return flag.default if raw is None else raw  # type: ignore[return-value]


def flag_set(name: str) -> bool:
    """Whether the flag is in the environment at all: for flags with a
    concrete default that a tuned profile may override (the profile ranks
    below a set flag and above the default, which flag_bool and flag_int
    cannot tell apart)."""
    if name not in REGISTRY:
        raise KeyError(f"environment flag {name!r} is not registered in kubernetriks_tpu_torch.flags")
    return name in os.environ


def flag_int(name: str) -> Optional[int]:
    """Integer flag: unset or empty gives its default (may be None); any
    other value must parse as a base-10 integer, or this raises."""
    flag = _lookup(name, "int")
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return flag.default  # type: ignore[return-value]
    try:
        return int(raw.strip(), 10)
    except ValueError as exc:
        raise ValueError(f"environment flag {name!r} must be an integer, got {raw!r}") from exc
