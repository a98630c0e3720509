"""The port's environment flags: one registry, one parser each.

Every KTPU_* variable the port reads is declared here (name, type,
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

