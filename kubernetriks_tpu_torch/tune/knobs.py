"""The declarative knob registry: every tunable performance static of the
port (reference `kubernetriks_tpu/tune/knobs.py`, own copy).

A Knob names ONE engine build argument (a static that the repo's own
gates hold bit for bit against its other settings), its legal candidate
values, the stage the coordinate-descent sweep visits it in, whether
changing it changes what the window executor captures (disclosure of a
candidate's capture cost), and the activation predicates (`requires`)
that keep the sweep off configurations where the knob is inert.

The port's knobs are its own statics: the graph executor (`graphs`), the
dense cycle route (`megakernel`, KTPU_MEGAKERNEL), the window razor
(`window_razor`), the streaming feeder (`stream`, `stream_depth`,
`stream_segment`) and reclaim's cadence (`reclaim_period`, open-domain as
in the reference's registry). The reference's TPU knobs (`superspan*`,
`fuse_slide`, `lane_major`, `donate`, `ca_descatter`) have no counterpart
here: a profile naming one raises at load, naming the field.

Two things differ from the reference's single table:

- The hand-picked defaults depend on the device. `default` is either one
  value or a mapping from device type ("cuda", "cpu") to the value the
  untuned build takes there; `knob_default(knob, device)` reads it, and
  `default_statics(device)` is the untuned build's table on that device.
- Some values build on one device only: `graphs=True` needs the card
  (the engine raises on the CPU). `device_values` maps a device type to
  the values it can build where that is fewer than `values`;
  `legal_values(knob, device)` is what the sweep measures there, and
  `validate_value(knob, value, device)` raises, naming the knob and the
  device, for a value the device cannot build. No silent fallback.

Closed-domain knobs (`values` is a tuple) are swept; open-domain knobs
(`values is None`) are registered, applied and validated, but the sweep
skips them (a slab width scales with the pod window, not with one list).

Deliberately NOT knobs:
- `reclaim`: an explicit reclaim=True raises on traces whose node-name
  classes interleave, and a candidate must never be a build error.
- `fast_forward`: pinned off while measuring, so every candidate steps the
  windows it names.
- the cluster count and the pod window: GEOMETRY, the profile's key.

Adding a knob: add the engine argument with a None default and the
explicit argument > the knob's own flag > tuned profile > device default
resolution, report it in `BatchedSimulation.tuning_statics()`, and
register it here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple


class Knob(NamedTuple):
    name: str  # == the BatchedSimulation build argument it feeds
    kind: str  # "bool" | "int": the value type in profiles
    values: Optional[Tuple]  # legal sweep candidates; None = open domain
    default: object  # the hand-picked value, or {device type: value}
    stage: str  # coordinate-descent stage (visited in registry order)
    recompile: bool  # changing it changes what the executor captures
    requires: Tuple  # ((knob, value), ...): active only when all hold
    doc: str
    device_values: Optional[Dict[str, Tuple]] = None  # {device: buildable values}


KNOBS: Tuple[Knob, ...] = (
    # -- executor stage: how the window's pieces are dispatched ----------
    Knob(
        "graphs",
        "bool",
        (False, True),
        {"cuda": True, "cpu": False},
        "executor",
        True,
        (),
        "CUDA graphs of the window's pieces (batched/graphs.py), replayed in "
        "plan order, against the same pieces launched eagerly from Python. "
        "True builds on the card only.",
        {"cpu": (False,)},
    ),
    Knob(
        "megakernel",
        "bool",
        (False, True),
        True,
        "executor",
        True,
        (),
        "The dense cycle route from 128 clusters: selection, cycle and "
        "commit in one kernel (select_cycle_commit.cu), or the two-kernel "
        "route (select_schedule_cycle.cu, then commit_scatter.cu). Inert "
        "below 128 clusters, where the route is 'sorted'.",
    ),
    # -- layout stage: which pieces a window runs ------------------------
    Knob(
        "window_razor",
        "bool",
        (False, True),
        {"cuda": True, "cpu": False},
        "layout",
        True,
        (),
        "A window with no event chunk runs its tail behind the "
        "window_work_due predicate (a conditional node on graphs).",
    ),
    # -- memory stage: staging of the slide's refill payload -------------
    Knob(
        "stream",
        "bool",
        (False, True),
        {"cuda": True, "cpu": False},
        "memory",
        True,
        (),
        "The streaming feeder (batched/stream.py): a thread stages the "
        "slide's refill payload a slab at a time into a bounded ring on "
        "the device. Acts only under a sliding pod window.",
    ),
    Knob(
        "stream_depth",
        "int",
        (2, 3, 4),
        3,
        "memory",
        True,
        (("stream", True),),
        "The feeder ring's depth K (KTPU_STREAM_DEPTH): at most K slabs on "
        "the device at once, a slide graph for each slot.",
    ),
    # -- open-domain knobs: registered, applied, validated, NOT swept ----
    Knob(
        "stream_segment",
        "int",
        None,
        None,
        "memory",
        True,
        (("stream", True),),
        "Width (payload columns) of the feeder's slabs "
        "(KTPU_STREAM_SEGMENT). Geometry-specific: profiles may pin it, the "
        "sweep leaves the engine's 4W rule in charge.",
    ),
    Knob(
        "reclaim_period",
        "int",
        None,
        1,
        "memory",
        True,
        (),
        "Reclaim compaction cadence in windows (KTPU_RECLAIM_PERIOD), for "
        "engines whose reclaim tristate is already on (the knob never turns "
        "reclaim on; see the module docstring).",
    ),
)

_BY_NAME: Dict[str, Knob] = {k.name: k for k in KNOBS}

STAGES: Tuple[str, ...] = tuple(dict.fromkeys(k.stage for k in KNOBS))


def knob_by_name(name: str) -> Knob:
    """The registered knob, or a ValueError NAMING the unknown field: the
    error profile validation surfaces for a stale or mistyped entry."""
    knob = _BY_NAME.get(name)
    if knob is None:
        raise ValueError(
            f"unknown tuning knob {name!r}: not in the tune.knobs registry "
            f"(known: {', '.join(sorted(_BY_NAME))})"
        )
    return knob


def knob_default(knob: Knob, device: str) -> object:
    """The value an untuned build on `device` ("cuda" or "cpu") takes."""
    if isinstance(knob.default, dict):
        return knob.default[device]
    return knob.default


def legal_values(knob: Knob, device: str) -> Tuple:
    """The knob's candidates that a build on `device` can take."""
    narrowed = (knob.device_values or {}).get(device)
    return knob.values if narrowed is None else narrowed


def default_statics(device: str) -> Dict[str, object]:
    """The untuned build's table on `device`, the sweep's starting point:
    each swept knob at its device default (open-domain knobs stay unset,
    the engine's own rules keep deciding them)."""
    return {k.name: knob_default(k, device) for k in KNOBS if k.values is not None}


def validate_value(knob: Knob, value: object, device: Optional[str] = None) -> None:
    """Legality check for one (knob, value) pair, naming the field; with
    `device`, also that a build there can take the value."""
    if knob.values is not None:
        if value not in knob.values:
            raise ValueError(
                f"tuning knob {knob.name!r}: value {value!r} is not in the "
                f"registered legal set {knob.values!r}"
            )
        if device is not None and value not in legal_values(knob, device):
            raise ValueError(
                f"tuning knob {knob.name!r}: value {value!r} does not build on "
                f"{device!r} (buildable there: {legal_values(knob, device)!r})"
            )
        return
    # Open domain: type-check only. None is always legal (= engine rule).
    if value is None:
        return
    if knob.kind == "int" and not isinstance(value, bool) and isinstance(value, int):
        return
    if knob.kind == "bool" and isinstance(value, bool):
        return
    raise ValueError(
        f"tuning knob {knob.name!r}: value {value!r} is not a valid "
        f"{knob.kind} (open-domain knobs type-check against the registry kind)"
    )


def validate_statics(statics: Dict[str, object], device: Optional[str] = None) -> Dict[str, object]:
    """Validate a whole statics table (a profile's `statics` or a
    candidate): every key a registered knob, every value legal (and, with
    `device`, buildable there). Returns the table so call sites can chain."""
    for name, value in statics.items():
        validate_value(knob_by_name(name), value, device)
    return statics


def is_active(knob: Knob, config: Dict[str, object], device: str) -> bool:
    """Whether the knob is live under `config` (its `requires` hold; a
    missing key falls back to the required knob's default on `device`)."""
    for dep, want in knob.requires:
        have = config.get(dep, knob_default(_BY_NAME[dep], device))
        if have != want:
            return False
    return True


def active_knobs(config: Dict[str, object], device: str) -> Tuple[Knob, ...]:
    """The swept knobs live under `config`, in registry (stage) order."""
    return tuple(k for k in KNOBS if k.values is not None and is_active(k, config, device))
