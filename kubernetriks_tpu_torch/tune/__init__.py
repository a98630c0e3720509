"""Self-tuning statics: the measurement-driven autotuner over the port's
performance statics (reference `kubernetriks_tpu/tune/`, own copy).

Each static the port grew (the graph executor, the dense cycle route, the
window razor, the streaming feeder and its ring) is held bit for bit
against its other setting by an existing gate and set by a hand-picked
default for the device. This package makes them SEARCHABLE instead:

- `knobs.py`   the declarative knob registry: name, legal values (and the
               values each device can build), the device defaults, which
               engine argument each knob feeds, and the activation
               predicates (`stream_depth` rides `stream`).
- `measure.py` the pluggable measurement backend: the bench protocol
               (>= 5 valid timed spans, zero-decision spans dropped, a
               recompile sentinel sealed after the warm-up, whole-grid
               bit-identity) and a pinned-measurements fake.
- `search.py`  deterministic, resumable staged coordinate descent over the
               registry, budgeted by KTPU_TUNE_BUDGET.
- `profile.py` the per-device tuned-statics profile: a JSON table keyed by
               device type and geometry (artifacts/tuned/<cuda|cpu>_<C>x<N>.json)
               recording the chosen config AND every measured candidate,
               loaded at engine and fleet build (`tuned_profile=`,
               KTPU_TUNED_PROFILE).
- `run.py`     the command line: `python -m kubernetriks_tpu_torch.tune` runs the
               real sweep on the composed line (or the fake grid with
               --fake) and writes the profile.

Tuning changes statics only, never semantics: every candidate the search
measures must end in the first candidate's state bit for bit
(state.compare_states) with equal committed decisions. The objective is
the observatory's readout (telemetry/observatory.tuning_objective): the
host ms a window of the window spans, scaled by a penalty for fired
stall/occupancy verdicts.

Cold-path host code: no device work of its own (the measurement backend
drives engines that do).
"""

from kubernetriks_tpu_torch.tune.knobs import (  # noqa: F401
    KNOBS,
    Knob,
    active_knobs,
    default_statics,
    knob_by_name,
    validate_statics,
)
from kubernetriks_tpu_torch.tune.measure import (  # noqa: F401
    BenchMeasurementBackend,
    FakeMeasurementBackend,
    Measurement,
)
from kubernetriks_tpu_torch.tune.profile import (  # noqa: F401
    GeometryMismatch,
    TunedProfile,
    load_profile,
    profile_path,
    resolve_build_profile,
    save_profile,
)
from kubernetriks_tpu_torch.tune.search import (  # noqa: F401
    TuneResult,
    staged_coordinate_descent,
)
