"""State-leaf coverage pass: every state leaf is provably handled in
every registered consumer.

Port of the JAX package's pass. ClusterBatchState / AutoscaleState /
TelemetryRing / LaneClocks leaves ride the state's conversions
(convert.py), the checkpoint, the fleet's lane reset, the lane freeze,
telemetry stripping, the parity comparator and the sanitizer's address
check; nothing else forces a NEW leaf to reach them. A leaf that misses
one silently survives a lane reset, restores into the wrong structure,
escapes the comparator, or is rebound behind the captured graphs' backs
unchecked.

Mechanism. The state classes are parsed from their NamedTuple AST
definitions (fields = annotated assignments; a `= None` default marks a
structural leaf). Each registered consumer then proves coverage one of
two ways:

- pytree-GENERIC traversal: the function body calls `flatten` /
  `unflatten` / `flatten_tree` / `clone_state` / `copy_state_into` /
  `state_addresses`, rebuilds through `._replace` (which passes unnamed
  leaves through unchanged), walks a parameter's `._fields`, or iterates every key of a
  flat {path: leaf} parameter: every leaf, present and future, is
  handled by construction;
- by NAME: every required field name appears in the function body.

Each class also carries a leaf MANIFEST next to its definition
(`CLUSTER_STATE_LEAVES` / `AUTOSCALE_STATE_LEAVES` /
`TELEMETRY_RING_LEAVES` / `LANE_CLOCK_LEAVES` in batched/state.py) that
must equal the field list exactly: adding a leaf without touching the
manifest is a lint error, and a stale manifest entry is equally loud.

A `# ktpu: state-module` file pragma marks a self-contained fixture:
classes, manifests and consumer functions are all resolved within that
file (tests/lint_fixtures/torch/stateleaf_*.py).

Waive a deliberate gap with `# ktpu: leaf-ok(<reason>)` on the consumer
def line or the class line.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from kubernetriks_tpu_torch.lint import PACKAGE, LintContext, SourceFile, Violation, dotted_name

PASS_ID = "stateleaf"

STATE_PY = f"{PACKAGE}/batched/state.py"
STEP_PY = f"{PACKAGE}/batched/step.py"
ENGINE_PY = f"{PACKAGE}/batched/engine.py"
AUTOSCALE_PY = f"{PACKAGE}/batched/autoscale.py"
CONVERT_PY = f"{PACKAGE}/convert.py"
CHECKPOINT_PY = f"{PACKAGE}/checkpoint.py"
SANITIZE_PY = f"{PACKAGE}/sanitize.py"

# class name -> defining module (path match is exact on the repo layout;
# a state-module pragma file overrides with its own definitions).
STATE_CLASSES: Dict[str, str] = {
    "ClusterBatchState": STATE_PY,
    "TelemetryRing": STATE_PY,
    "AutoscaleState": STATE_PY,
    # The lane clocks are per-lane device data the captured graphs read,
    # re-seeded in place (engine.set_lane_plan).
    "LaneClocks": STATE_PY,
}

# class -> (manifest constant, module holding it)
MANIFESTS: Dict[str, Tuple[str, str]] = {
    "ClusterBatchState": ("CLUSTER_STATE_LEAVES", STATE_PY),
    "TelemetryRing": ("TELEMETRY_RING_LEAVES", STATE_PY),
    "AutoscaleState": ("AUTOSCALE_STATE_LEAVES", STATE_PY),
    "LaneClocks": ("LANE_CLOCK_LEAVES", STATE_PY),
}

CHECKLIST_HINT = "handle it in every consumer stateleaf.CONSUMERS names"

_STATE = ("ClusterBatchState", "AutoscaleState", "TelemetryRing")


@dataclass(frozen=True)
class Registry:
    """One registered consumer: `fields` selects which leaves it must
    handle — 'all', 'required' (no default: constructors must name them)
    or 'structural' (`= None` default: presence is program identity, so
    checkpoint meta must record it)."""

    name: str
    path: str
    func: str
    classes: Tuple[str, ...]
    fields: str = "all"  # "all" | "required" | "structural"
    manifest: Optional[str] = None  # module constant instead of the body


CONSUMERS: Tuple[Registry, ...] = (
    Registry("convert-to-numpy", CONVERT_PY, "state_to_numpy", _STATE),
    Registry("convert-from-numpy", CONVERT_PY, "state_from_numpy", _STATE),
    Registry("checkpoint", CHECKPOINT_PY, "flatten_tree", _STATE + ("LaneClocks",)),
    Registry("lane-reset", ENGINE_PY, "_reset_rows", _STATE),
    Registry("freeze-lanes", STEP_PY, "freeze_lanes_", ("ClusterBatchState", "AutoscaleState")),
    Registry("strip-telemetry", STATE_PY, "strip_telemetry", ("ClusterBatchState",)),
    Registry("compare-states", STATE_PY, "compare_states", _STATE),
    Registry("sanitize-addresses", SANITIZE_PY, "state_addresses", _STATE),
    Registry("lane-clocks-fresh", STATE_PY, "fresh", ("LaneClocks",)),
    # The constructors name every leaf they build.
    Registry("init-state", STATE_PY, "init_state", ("ClusterBatchState",), "required"),
    Registry("init-autoscale-state", AUTOSCALE_PY, "init_autoscale_state", ("AutoscaleState",)),
)

_GENERIC_MARKERS = (
    "flatten",
    "unflatten",
    "flatten_tree",
    "clone_state",
    "copy_state_into",
    "state_addresses",
)


@dataclass
class StateClass:
    name: str
    sf: SourceFile
    line: int
    fields: Tuple[str, ...]
    structural: Tuple[str, ...]  # fields defaulted to None

    def select(self, which: str) -> Tuple[str, ...]:
        if which == "structural":
            return self.structural
        if which == "required":
            return tuple(
                f for f in self.fields if f not in set(self._defaulted)
            )
        return self.fields

    _defaulted: Tuple[str, ...] = ()


def _class_fields(node: ast.ClassDef) -> Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]:
    """(all fields, structural fields (= None default), any-default fields)
    of a NamedTuple class body."""
    fields: List[str] = []
    structural: List[str] = []
    defaulted: List[str] = []
    for st in node.body:
        if isinstance(st, ast.AnnAssign) and isinstance(st.target, ast.Name):
            fields.append(st.target.id)
            if st.value is not None:
                defaulted.append(st.target.id)
                if isinstance(st.value, ast.Constant) and st.value.value is None:
                    structural.append(st.target.id)
    return tuple(fields), tuple(structural), tuple(defaulted)


def _is_namedtuple(node: ast.ClassDef) -> bool:
    for base in node.bases:
        name = dotted_name(base) or ""
        if name.rsplit(".", 1)[-1] == "NamedTuple":
            return True
    return False


def _find_classes(files, fixture: Optional[SourceFile]) -> Dict[str, StateClass]:
    out: Dict[str, StateClass] = {}
    scope = [fixture] if fixture is not None else files
    for sf in scope:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef) or not _is_namedtuple(node):
                continue
            if node.name not in STATE_CLASSES:
                continue
            if fixture is None and sf.path != STATE_CLASSES[node.name]:
                continue
            fields, structural, defaulted = _class_fields(node)
            sc = StateClass(node.name, sf, node.lineno, fields, structural)
            sc._defaulted = defaulted
            out[node.name] = sc
    return out


def _find_func(sf: SourceFile, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == name:
                return node
    return None


def _has_generic_traversal(fn: ast.AST) -> bool:
    params = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        params = {a.arg for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname is not None and fname.rsplit(".", 1)[-1] in _GENERIC_MARKERS:
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr == "_replace":
                # NamedTuple._replace passes every unnamed leaf through
                # unchanged: structure-preserving by construction.
                return True
        if (
            isinstance(node, ast.Attribute)
            and node.attr == "_fields"
            and isinstance(node.value, ast.Name)
            and node.value.id in params
        ):
            return True  # walks its argument's NamedTuple fields, whatever they are
        if isinstance(node, (ast.For, ast.comprehension)) and _iterates_param(node.iter, params):
            # every key of a flat {path: leaf} parameter (compare_states)
            return True
    return False


def _iterates_param(it: ast.AST, params) -> bool:
    """`for k in p` / `sorted(p)` / `p.items()` / `p.keys()` over a
    parameter `p`."""
    if isinstance(it, ast.Call):
        if isinstance(it.func, ast.Name) and it.func.id == "sorted" and it.args:
            it = it.args[0]
        elif isinstance(it.func, ast.Attribute) and it.func.attr in ("items", "keys") and not it.args:
            it = it.func.value
    return isinstance(it, ast.Name) and it.id in params


def _body_tokens(fn: ast.AST) -> Set[str]:
    """Every identifier-ish token in a function body: attribute names,
    bare names, keyword-argument names, string constants."""
    tokens: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            tokens.add(node.attr)
        elif isinstance(node, ast.Name):
            tokens.add(node.id)
        elif isinstance(node, ast.keyword) and node.arg:
            tokens.add(node.arg)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            tokens.add(node.value)
    return tokens


def _module_const_names(
    sf: SourceFile, const: str
) -> Tuple[Optional[Set[str]], Optional[int]]:
    """Names listed by a module-level manifest constant: a tuple/list of
    strings, or a dict with string keys (values = coverage reasons)."""
    if not isinstance(sf.tree, ast.Module):
        return None, None
    for node in sf.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == const
        ):
            val = node.value
            names: Set[str] = set()
            if isinstance(val, (ast.Tuple, ast.List)):
                for elt in val.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ):
                        names.add(elt.value)
                    else:
                        return None, node.lineno
                return names, node.lineno
            if isinstance(val, ast.Dict):
                for key in val.keys:
                    if isinstance(key, ast.Constant) and isinstance(
                        key.value, str
                    ):
                        names.add(key.value)
                    else:
                        return None, node.lineno
                return names, node.lineno
            return None, node.lineno
    return None, None


def _check_consumer(
    reg: Registry,
    sf: SourceFile,
    classes: Dict[str, StateClass],
    out: List[Violation],
) -> None:
    # Manifest-backed registry: the constant's keys are the coverage.
    if reg.manifest is not None:
        names, line = _module_const_names(sf, reg.manifest)
        anchor = line or 1
        if names is None:
            out.append(
                Violation(
                    sf.path,
                    anchor,
                    PASS_ID,
                    f"registry '{reg.name}': manifest constant "
                    f"{reg.manifest} missing or not a literal tuple/dict "
                    f"of leaf names in {sf.path}",
                )
            )
            return
        wanted: Set[str] = set()
        resolved_all = all(cls in classes for cls in reg.classes)
        for cls in reg.classes:
            sc = classes.get(cls)
            if sc is None:
                continue
            for leaf in sc.select(reg.fields):
                wanted.add(leaf)
                if leaf not in names and not sf.waived(anchor, PASS_ID):
                    out.append(
                        Violation(
                            sf.path,
                            anchor,
                            PASS_ID,
                            f"state leaf {cls}.{leaf} is not covered by "
                            f"registry '{reg.name}' ({reg.manifest}) — "
                            f"record how checkpoint save/restore handles "
                            f"it, or {CHECKLIST_HINT}",
                        )
                    )
        # Staleness is only judgeable when EVERY registered class resolved
        # in scope — a partial lint (one changed file) must not demand the
        # deletion of entries covering the out-of-scope classes.
        if resolved_all:
            for name in sorted(names - wanted):
                if not sf.waived(anchor, PASS_ID):
                    out.append(
                        Violation(
                            sf.path,
                            anchor,
                            PASS_ID,
                            f"registry '{reg.name}': {reg.manifest} lists "
                            f"{name!r}, which is not a "
                            f"{'/'.join(reg.classes)} {reg.fields} leaf — "
                            "remove the stale entry",
                        )
                    )
        return
    fn = _find_func(sf, reg.func)
    if fn is None:
        out.append(
            Violation(
                sf.path,
                1,
                PASS_ID,
                f"registered state-leaf consumer {reg.func} (registry "
                f"'{reg.name}') not found in {sf.path} — update the "
                "stateleaf registry if it moved or was renamed",
            )
        )
        return
    if _has_generic_traversal(fn):
        return  # every leaf handled by construction
    tokens = _body_tokens(fn)
    for cls in reg.classes:
        sc = classes.get(cls)
        if sc is None:
            continue
        for leaf in sc.select(reg.fields):
            if leaf not in tokens and not sf.waived(fn.lineno, PASS_ID):
                out.append(
                    Violation(
                        sf.path,
                        fn.lineno,
                        PASS_ID,
                        f"state leaf {cls}.{leaf} is not handled in "
                        f"registry '{reg.name}' ({reg.func}): no "
                        "pytree-generic traversal and the leaf is never "
                        f"named — handle it or {CHECKLIST_HINT}",
                    )
                )


def _check_manifest(
    cls: StateClass, sf: SourceFile, const: str, out: List[Violation]
) -> None:
    names, line = _module_const_names(sf, const)
    if names is None:
        out.append(
            Violation(
                sf.path,
                line or cls.line,
                PASS_ID,
                f"leaf manifest {const} for {cls.name} missing or not a "
                f"literal tuple of strings in {sf.path} — the manifest is "
                f"the 'how to add a state leaf' checklist anchor",
            )
        )
        return
    for leaf in cls.fields:
        if leaf not in names and not sf.waived(cls.line, PASS_ID):
            out.append(
                Violation(
                    sf.path,
                    cls.line,
                    PASS_ID,
                    f"new state leaf {cls.name}.{leaf} is missing from "
                    f"{const} — {CHECKLIST_HINT} (convert, checkpoint, "
                    "lane reset, freeze, strip_telemetry, compare_states, "
                    "sanitize's address check), then add it to the manifest",
                )
            )
    for name in sorted(names - set(cls.fields)):
        out.append(
            Violation(
                sf.path,
                line,
                PASS_ID,
                f"{const} lists {name!r}, which is not a field of "
                f"{cls.name} — remove the stale manifest entry",
            )
        )


def check(ctx: LintContext) -> List[Violation]:
    out: List[Violation] = []
    by_path = {sf.path: sf for sf in ctx.files}

    # Self-contained fixture modules: classes + consumers in one file.
    fixtures = [sf for sf in ctx.files if "state-module" in sf.pragmas]
    for sf in fixtures:
        classes = _find_classes(ctx.files, fixture=sf)
        if not classes:
            continue
        for cls, (const, _) in MANIFESTS.items():
            if cls in classes:
                _check_manifest(classes[cls], sf, const, out)
        for reg in CONSUMERS:
            if reg.manifest is not None:
                if _module_const_names(sf, reg.manifest)[1] is not None:
                    _check_consumer(reg, sf, classes, out)
                continue
            if _find_func(sf, reg.func) is not None:
                _check_consumer(reg, sf, classes, out)

    # The real tree: classes at their canonical paths, consumers at theirs.
    classes = _find_classes(
        [sf for sf in ctx.files if "state-module" not in sf.pragmas], None
    )
    if classes:
        for cls, sc in classes.items():
            const, path = MANIFESTS[cls]
            holder = by_path.get(path)
            if holder is not None:
                _check_manifest(sc, holder, const, out)
        for reg in CONSUMERS:
            sf = by_path.get(reg.path)
            if sf is None:
                continue  # consumer module out of scope (partial lint)
            if not any(c in classes for c in reg.classes):
                continue
            _check_consumer(reg, sf, classes, out)
    return out
