"""Per-device tuned-statics profiles: persistence and the build seam
(reference `kubernetriks_tpu/tune/profile.py`, own copy).

A profile is a JSON table keyed by device type and geometry (the file
name IS the key: `artifacts/tuned/<backend>_<C>x<N>.json`, where
`backend` is the build's `device.type`, "cuda" or "cpu"): the chosen
statics, the objective they scored, the hand-picked baseline they were
searched from, and EVERY measured candidate (so a profile is auditable
and the search can RESUME from it: measured candidates are cache hits).

Load seam (BatchedSimulation / ScenarioFleet build):

    profile source:  explicit `tuned_profile` argument
                   > KTPU_TUNED_PROFILE (a path, or 1/auto = resolve
                     artifacts/tuned/ under the working directory, then
                     the bundled kubernetriks_tpu_torch/tune/profiles/,
                     by the build's device type and cluster count)
                   > nothing (the hand-picked statics, exactly the
                     untuned build)
    per-knob value:  explicit build argument
                   > the knob's own flag (KTPU_MEGAKERNEL, KTPU_STREAM,
                     KTPU_STREAM_DEPTH, KTPU_STREAM_SEGMENT)
                   > the loaded profile's statics entry
                   > the device default (tune/knobs.py)

Mismatch policy: an EXPLICITLY loaded profile (argument, or a flag naming
a path) raises on a device type or geometry mismatch, naming the field.
Auto-resolved profiles match by construction on the device type and C
(the file name is the key); the engine re-checks N after the build, where
it is known, and an auto profile whose N drifted warns and keeps its
statics. A profile's statics are validated at load against the registry
and against the values its device can build: a CPU profile naming
graphs=True raises there.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, NamedTuple, Optional, Sequence

from kubernetriks_tpu_torch.tune.knobs import validate_statics

SCHEMA_VERSION = 1
PROFILE_KIND = "ktpu-tuned-profile"

# Where `python -m kubernetriks_tpu_torch.tune` lands profiles,
# relative to the working directory, and where auto-resolution looks first.
ARTIFACT_DIR = os.path.join("artifacts", "tuned")

# Profiles bundled with the package: the last source auto-resolution reads.
BUNDLED_DIR = os.path.join(os.path.dirname(__file__), "profiles")

# KTPU_TUNED_PROFILE values that mean "resolve by key" rather than a path.
_AUTO_VALUES = frozenset({"1", "auto", "true", "on"})

# Device types whose buildable values the registry knows.
_DEVICES = ("cuda", "cpu")


class GeometryMismatch(ValueError):
    """An explicitly loaded profile does not match the build, naming the
    mismatched field."""


class TunedProfile(NamedTuple):
    backend: str  # the device type it was tuned on
    n_clusters: int
    n_nodes: int
    statics: Dict[str, object]
    doc: Dict[str, object]  # the full JSON document (candidates etc.)
    source: str  # path it was loaded from, or "<dict>"
    explicit: bool  # explicitly requested (argument / flag path): strict

    def describe(self) -> str:
        return f"{self.backend}_{self.n_clusters}x{self.n_nodes} ({self.source})"

    def check_geometry(
        self,
        *,
        backend: Optional[str] = None,
        n_clusters: Optional[int] = None,
        n_nodes: Optional[int] = None,
    ) -> None:
        """Compare the profile key with the build, field by field.
        Explicit profiles RAISE GeometryMismatch naming the field;
        auto-resolved ones warn and keep going (the statics are still
        bit-identity-safe; only their tuning provenance is for another
        shape)."""
        checks = (
            ("backend", self.backend, backend),
            ("geometry.n_clusters", self.n_clusters, n_clusters),
            ("geometry.n_nodes", self.n_nodes, n_nodes),
        )
        for field, have, want in checks:
            if want is None or have == want:
                continue
            msg = (
                f"tuned profile {self.describe()}: {field} is {have!r} but this build is {want!r}: the profile "
                "was tuned for another device or geometry"
            )
            if self.explicit:
                raise GeometryMismatch(msg)
            warnings.warn(
                msg + "; applying its statics anyway (bit-identity holds, the tuning provenance does not)",
                RuntimeWarning,
                stacklevel=3,
            )


def profile_path(backend: str, n_clusters: int, n_nodes: int, root: str = ARTIFACT_DIR) -> str:
    """The canonical on-disk key: <root>/<backend>_<C>x<N>.json."""
    return os.path.join(root, f"{backend}_{n_clusters}x{n_nodes}.json")


def save_profile(doc: Dict[str, object], path: str) -> str:
    """Validate and write a profile document (creating directories);
    returns the path. The document must already carry the full record:
    this is persistence, not authoring (search.profile_doc authors)."""
    _validate_doc(doc, path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    return path


def _validate_doc(doc: Dict[str, object], source: str) -> None:
    if doc.get("kind") != PROFILE_KIND:
        raise ValueError(f"tuned profile {source}: 'kind' is {doc.get('kind')!r}, expected {PROFILE_KIND!r}")
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"tuned profile {source}: 'schema' is {doc.get('schema')!r}, this build reads version {SCHEMA_VERSION}"
        )
    geo = doc.get("geometry")
    if not isinstance(geo, dict) or not {"n_clusters", "n_nodes"} <= set(geo):
        raise ValueError(f"tuned profile {source}: 'geometry' must carry n_clusters and n_nodes, got {geo!r}")
    backend = doc.get("backend")
    if not isinstance(backend, str):
        raise ValueError(f"tuned profile {source}: 'backend' must be a string, got {backend!r}")
    statics = doc.get("statics")
    if not isinstance(statics, dict):
        raise ValueError(f"tuned profile {source}: 'statics' must be a table, got {statics!r}")
    # Unknown knobs and illegal values raise here, naming the field: a
    # stale profile (a renamed knob, the reference's TPU knobs) fails at
    # load, never by silently dropping the entry. A known device type also
    # holds the values to what it can build.
    try:
        validate_statics(statics, backend if backend in _DEVICES else None)
    except ValueError as exc:
        raise ValueError(f"tuned profile {source}: {exc}") from None


def _from_doc(doc: Dict[str, object], source: str, explicit: bool) -> TunedProfile:
    _validate_doc(doc, source)
    geo = doc["geometry"]
    return TunedProfile(
        backend=str(doc["backend"]),
        n_clusters=int(geo["n_clusters"]),
        n_nodes=int(geo["n_nodes"]),
        statics=dict(doc["statics"]),
        doc=doc,
        source=source,
        explicit=explicit,
    )


def load_profile(path: str, explicit: bool = True) -> TunedProfile:
    """Load and validate one profile file. Raises (naming the path and the
    offending field) on unknown knobs, illegal values or a malformed
    document: never a silent partial load."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return _from_doc(doc, path, explicit)


def _auto_candidates(backend: str, n_clusters: int) -> Sequence[str]:
    """Auto-resolution's search list: every <backend>_<C>x*.json under
    artifacts/tuned/, then the bundled directory (N is unknown until the
    build; the first match loads and the post-build N check warns on
    drift)."""
    out = []
    prefix = f"{backend}_{n_clusters}x"
    for root in (ARTIFACT_DIR, BUNDLED_DIR):
        if not os.path.isdir(root):
            continue
        for name in sorted(os.listdir(root)):
            if name.startswith(prefix) and name.endswith(".json"):
                out.append(os.path.join(root, name))
    return out


def resolve_build_profile(tuned_profile, *, backend: str, n_clusters: int) -> Optional[TunedProfile]:
    """The engine-build seam (called from BatchedSimulation.__init__).

    `tuned_profile`, the explicit build argument: a TunedProfile, a
    profile dict, a path, False (= profile loading OFF even under the
    flag), or None (= consult KTPU_TUNED_PROFILE). Explicit sources are
    strict: load failures and device type or C mismatches raise, naming
    the field. Flag-auto sources are best-effort: no match resolves to
    None (the hand-picked statics), quietly, because unset-flag builds
    must stay exactly the untuned build and auto is the documented "use
    one if you have one" mode."""
    from kubernetriks_tpu_torch.flags import flag_str

    if tuned_profile is False:
        return None
    explicit = tuned_profile is not None
    path: Optional[str] = None
    if isinstance(tuned_profile, TunedProfile):
        prof = tuned_profile
    elif isinstance(tuned_profile, dict):
        prof = _from_doc(tuned_profile, "<dict>", explicit=True)
    elif isinstance(tuned_profile, str):
        path = tuned_profile
        prof = None
    elif tuned_profile is None:
        raw = flag_str("KTPU_TUNED_PROFILE")
        if raw is None:
            return None
        if raw.strip().lower() in _AUTO_VALUES:
            candidates = _auto_candidates(backend, n_clusters)
            if not candidates:
                return None
            prof, path = None, candidates[0]
        else:
            # A flag naming a concrete path is as explicit as an argument:
            # a missing or stale file raises instead of silently running
            # the untuned statics the user thought they replaced.
            prof, path, explicit = None, raw, True
    else:
        raise TypeError(
            "tuned_profile must be a TunedProfile, a profile dict, a path, False or None: got "
            f"{type(tuned_profile).__name__}"
        )
    if prof is None:
        prof = load_profile(path, explicit=explicit)
    prof = prof._replace(explicit=explicit)
    prof.check_geometry(backend=backend, n_clusters=n_clusters)
    return prof
