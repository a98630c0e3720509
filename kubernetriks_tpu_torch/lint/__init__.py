"""ktpu-lint over the port: framework-invariant static analysis.

Port of the JAX package's `lint/` (`python -m kubernetriks_tpu_torch.lint`;
own copy: the port imports nothing of the JAX package). The framework's
correctness rests on invariants no general-purpose tool checks; these AST
passes turn them into machine checks:

1. envflags      — every `os.environ` / `os.getenv` read of a KTPU_* /
   KUBERNETRIKS_* name resolves against the port's registry
   (`kubernetriks_tpu_torch/flags.py`) and happens inside it.
2. prng          — simulation-path modules draw no ad-hoc randomness
   (`np.random.*`, stdlib `random`, `torch.rand*` and friends without
   `generator=`, `torch.manual_seed`): every draw routes through the
   counter-based threefry keying in `chaos.py`, or card/CPU/JAX
   bit-identity breaks.
3. hostsync      — hot-path modules grow no implicit host sync:
   `.item()`, `.cpu()`, `.numpy()`, `.tolist()` / `int()` / `float()` /
   `bool()` of a tensor, `.to("cpu")`, `torch.cuda.synchronize`, an
   Event's or Stream's `.synchronize()`, `to_host`, and Python branches
   on a tensor. Every legitimate read carries a `# ktpu: sync-ok(<reason>)`
   waiver, which makes the hot paths' sync budget greppable; the same
   reads run inside sanitize.allow_transfer scopes at run time.
4. feederlock    — in threaded modules (`batched/stream.py`, or a
   `# ktpu: threaded` pragma) attributes mutated off-thread are touched
   only under the ring's lock, and no blocking call (a synchronize, a
   sleep, a join, a foreign wait) runs while it is held.
5. stateleaf     — every leaf of the state NamedTuples (ClusterBatchState,
   AutoscaleState, TelemetryRing, LaneClocks) is provably handled by each
   registered consumer, and each class's leaf manifest equals its fields.
6. scenariotrace — per-lane scenario leaves never flow into Python control
   flow, host casts, shape expressions, a piece key or a capture's
   arguments: the fleet's capture-once guarantee, statically.
7. shapecontract — per-cluster (C,) leaves carry declared axis signatures;
   mixing one with a (C, G) / (C, P) / (C, N) expression without an
   explicit `[:, None]` / transpose / broadcast is flagged.
8. capture       — the counterpart of the reference's donation pass: a
   captured CUDA graph reads fixed addresses, so rebinding a tensor tree
   a captured graph reads (`self._state`, `self.autoscale_statics`,
   `self.consts`, ...) in the engine, the executor or the fleet is a
   violation unless the same function then rebuilds the executor.
9. graphstatic   — the counterpart of the reference's jitstatic rules 1
   and 3: a call of a `batched/step.py` function that takes the coupled
   keywords `profile`, `faults` and `profile_terms` passes all three or
   none, and every keyword a call names exists in the callee's signature.

Waiver syntax (same line as the violation, or on the `def` line to waive a
whole function for hostsync): `# ktpu: <tag>-ok(<reason>)` with a
non-empty reason. Tags: sync, prng, flag, leaf, scenario, shape, lock,
capture, graphstatic. A waiver that no longer suppresses anything is
reported stale (`--strict-waivers` promotes that to an error).
File pragmas: `# ktpu: hot-path` opts a module into hostsync,
`# ktpu: sim-path` into prng / scenariotrace / shapecontract,
`# ktpu: threaded` into feederlock, `# ktpu: state-module` marks a
self-contained state-leaf fixture, `# ktpu: step-module` a file whose
top-level functions graphstatic treats as step functions, and
`# ktpu: capture-module` a file the capture pass patrols. The built-in
module lists cover the real package; pragmas serve the fixtures.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

PASS_IDS = (
    "envflags",
    "prng",
    "hostsync",
    "feederlock",
    "stateleaf",
    "scenariotrace",
    "shapecontract",
    "capture",
    "graphstatic",
)

# pass id -> waiver tag (`# ktpu: <tag>-ok(reason)`); the reverse map
# drives stale-waiver detection.
WAIVER_TAGS: Dict[str, str] = {
    "envflags": "flag",
    "prng": "prng",
    "hostsync": "sync",
    "feederlock": "lock",
    "stateleaf": "leaf",
    "scenariotrace": "scenario",
    "shapecontract": "shape",
    "capture": "capture",
    "graphstatic": "graphstatic",
}
TAG_TO_PASS: Dict[str, str] = {tag: pid for pid, tag in WAIVER_TAGS.items()}

PACKAGE = "kubernetriks_tpu_torch"

# Modules whose stepping regions are hot: a stray host read here adds a
# wait on the card to every window. Relative to the repo root.
HOT_MODULES = (
    f"{PACKAGE}/batched/step.py",
    f"{PACKAGE}/batched/engine.py",
    f"{PACKAGE}/batched/autoscale.py",
    f"{PACKAGE}/batched/graphs.py",
    f"{PACKAGE}/batched/fleet.py",
    f"{PACKAGE}/ops/",
)

# Modules on the simulation path, where every random draw must route
# through chaos.py's counter-based threefry keying. chaos.py itself (the
# key constructor) lives at the package root, outside the set.
SIM_MODULES = (
    f"{PACKAGE}/batched/",
    f"{PACKAGE}/ops/",
    f"{PACKAGE}/sim/",
    f"{PACKAGE}/core/",
    f"{PACKAGE}/autoscalers/",
)

# Modules owning threads that share mutable attributes with the engine
# thread: the feederlock pass patrols them.
THREADED_MODULES = (f"{PACKAGE}/batched/stream.py",)

# Modules that hold, or rebind, the tensor trees a captured graph reads:
# the capture pass patrols them.
CAPTURE_MODULES = (
    f"{PACKAGE}/batched/engine.py",
    f"{PACKAGE}/batched/graphs.py",
    f"{PACKAGE}/batched/fleet.py",
)

# The module whose functions take the coupled window-program keywords.
STEP_MODULE = f"{PACKAGE}/batched/step.py"

# Self-test fixtures hold seeded violations on purpose; the default scope
# must stay golden-clean without them.
DEFAULT_EXCLUDE = ("tests/lint_fixtures/",)

# Reason is greedy to the LAST ')' on the line, so reasons containing
# parentheses survive intact; convention is one waiver per line.
_WAIVER_RE = re.compile(r"#\s*ktpu:\s*([a-z]+)-ok\((.*)\)")
_PRAGMA_RE = re.compile(
    r"#\s*ktpu:\s*(hot-path|sim-path|threaded|state-module|step-module|capture-module)\b"
)


@dataclass(frozen=True)
class Violation:
    path: str
    line: int
    pass_id: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"

    def as_json(self) -> Dict[str, object]:
        return {
            "file": self.path,
            "line": self.line,
            "pass": self.pass_id,
            "message": self.message,
        }


@dataclass(frozen=True)
class StaleWaiver:
    """A `# ktpu: <tag>-ok(reason)` whose line/def no longer triggers its
    pass: dead weight that silently re-licenses a future violation."""

    path: str
    line: int
    tag: str
    reason: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [stale-waiver] {self.message}"

    def as_json(self) -> Dict[str, object]:
        return {
            "file": self.path,
            "line": self.line,
            "pass": "stale-waiver",
            "waiver": f"{self.tag}-ok({self.reason})",
            "message": self.message,
        }


@dataclass
class SourceFile:
    path: str  # repo-relative, forward slashes
    abspath: str
    text: str
    lines: List[str]
    tree: ast.AST
    waivers: Dict[int, List[Tuple[str, str]]]  # line -> [(pass tag, reason)]
    pragmas: frozenset
    # (line, tag) pairs that actually suppressed a violation this run:
    # the live half of the waiver inventory; declared-minus-used is the
    # stale set (find_stale_waivers).
    used_waivers: set = field(default_factory=set)

    def has_waiver(self, line: int, pass_id: str) -> bool:
        """Non-recording query: is there a waiver for pass_id on `line`?"""
        tag = WAIVER_TAGS.get(pass_id, pass_id)
        return any(t == tag and r.strip() for t, r in self.waivers.get(line, []))

    def waived(self, line: int, pass_id: str) -> bool:
        """Recording query: like has_waiver, but a True result marks the
        waiver USED (it suppressed a real violation). Passes call this
        exactly when they are about to flag."""
        tag = WAIVER_TAGS.get(pass_id, pass_id)
        if self.has_waiver(line, pass_id):
            self.used_waivers.add((line, tag))
            return True
        return False


@dataclass
class StepFunction:
    """One function whose calls graphstatic checks: a top-level function
    of batched/step.py (or of a `# ktpu: step-module` fixture)."""

    name: str
    path: str
    params: Tuple[str, ...]
    has_varkw: bool


@dataclass
class LintContext:
    """Package-wide tables built in phase 1, shared by every pass."""

    files: List[SourceFile] = field(default_factory=list)
    # bare name -> the step function (real tree: batched/step.py's)
    step_functions: Dict[str, StepFunction] = field(default_factory=dict)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _comment_tokens(text: str) -> List[Tuple[int, str]]:
    """(line, comment text) for every REAL comment token: waiver/pragma
    syntax quoted inside docstrings or message strings must not count as
    a declaration."""
    import io
    import tokenize

    out: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # Unterminated constructs: ast.parse will report the real error.
        pass
    return out


def _scan_waivers(text: str) -> Dict[int, List[Tuple[str, str]]]:
    out: Dict[int, List[Tuple[str, str]]] = {}
    for line_no, comment in _comment_tokens(text):
        for m in _WAIVER_RE.finditer(comment):
            out.setdefault(line_no, []).append((m.group(1), m.group(2)))
    return out


def _scan_pragmas(text: str) -> frozenset:
    found = set()
    for _, comment in _comment_tokens(text):
        for m in _PRAGMA_RE.finditer(comment):
            found.add(m.group(1))
    return frozenset(found)


def load_file(abspath: str, root: str) -> SourceFile:
    with open(abspath, encoding="utf-8") as fh:
        text = fh.read()
    rel = os.path.relpath(abspath, root).replace(os.sep, "/")
    return SourceFile(
        path=rel,
        abspath=abspath,
        text=text,
        lines=text.splitlines(),
        tree=ast.parse(text, filename=rel),
        waivers=_scan_waivers(text),
        pragmas=_scan_pragmas(text),
    )


def collect_files(
    paths: Sequence[str], root: str, exclude: Sequence[str] = DEFAULT_EXCLUDE
) -> List[SourceFile]:
    out: List[Tuple[str, bool]] = []  # (abspath, from directory walk)
    seen = set()
    for p in paths:
        ap = os.path.abspath(os.path.join(root, p) if not os.path.isabs(p) else p)
        if os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "build"))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append((os.path.join(dirpath, fn), True))
        elif ap.endswith(".py"):
            # explicitly-named files always lint (that's how the self-test
            # fixtures are invoked); excludes only prune directory walks
            out.append((ap, False))
    files: List[SourceFile] = []
    for ap, walked in out:
        rel = os.path.relpath(ap, root).replace(os.sep, "/")
        if ap in seen or (walked and any(rel.startswith(e) for e in exclude)):
            continue
        seen.add(ap)
        files.append(load_file(ap, root))
    return files


def _in(sf: SourceFile, modules: Sequence[str]) -> bool:
    return any(sf.path.startswith(m) if m.endswith("/") else sf.path == m for m in modules)


def is_hot(sf: SourceFile) -> bool:
    return "hot-path" in sf.pragmas or _in(sf, HOT_MODULES)


def is_sim_path(sf: SourceFile) -> bool:
    return "sim-path" in sf.pragmas or _in(sf, SIM_MODULES)


def is_threaded(sf: SourceFile) -> bool:
    return "threaded" in sf.pragmas or _in(sf, THREADED_MODULES)


def is_capture_module(sf: SourceFile) -> bool:
    return "capture-module" in sf.pragmas or _in(sf, CAPTURE_MODULES)


def func_params(fn: ast.FunctionDef) -> Tuple[Tuple[str, ...], bool]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return tuple(names), a.kwarg is not None


# --- phase 1: the step-function table ------------------------------------------


def build_context(files: List[SourceFile]) -> LintContext:
    ctx = LintContext(files=files)
    for sf in files:
        if sf.path != STEP_MODULE or not isinstance(sf.tree, ast.Module):
            continue
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params, varkw = func_params(node)
                ctx.step_functions[node.name] = StepFunction(node.name, sf.path, params, varkw)
    return ctx


# --- driver ------------------------------------------------------------------


@dataclass
class LintReport:
    """run_lint_report's full result: violations plus the stale-waiver
    inventory (only meaningful when every pass ran: a waiver for an
    unselected pass is never stale)."""

    violations: List[Violation]
    stale_waivers: List[StaleWaiver]
    root: str = ""


def _run_passes(
    paths: Sequence[str],
    root: str,
    passes: Optional[Sequence[str]],
    exclude: Sequence[str],
) -> Tuple[List[Violation], LintContext, Tuple[str, ...]]:
    from kubernetriks_tpu_torch.lint import (
        capture,
        envflags,
        feederlock,
        graphstatic,
        hostsync,
        prng,
        scenariotrace,
        shapecontract,
        stateleaf,
    )

    selected = tuple(passes) if passes else PASS_IDS
    unknown = set(selected) - set(PASS_IDS)
    if unknown:
        raise ValueError(f"unknown lint pass(es): {sorted(unknown)}")
    files = collect_files(paths, root, exclude=exclude)
    ctx = build_context(files)
    checkers = {
        "envflags": envflags.check,
        "prng": prng.check,
        "hostsync": hostsync.check,
        "feederlock": feederlock.check,
        "stateleaf": stateleaf.check,
        "scenariotrace": scenariotrace.check,
        "shapecontract": shapecontract.check,
        "capture": capture.check,
        "graphstatic": graphstatic.check,
    }
    violations: List[Violation] = []
    seen = set()
    for pass_id in selected:
        for v in checkers[pass_id](ctx):
            if v not in seen:
                seen.add(v)
                violations.append(v)
    violations.sort(key=lambda v: (v.path, v.line, v.pass_id))
    return violations, ctx, selected


def run_lint(
    paths: Sequence[str],
    root: str,
    passes: Optional[Sequence[str]] = None,
    exclude: Sequence[str] = DEFAULT_EXCLUDE,
) -> List[Violation]:
    return _run_passes(paths, root, passes, exclude)[0]


def find_stale_waivers(ctx: LintContext, selected: Sequence[str]) -> List[StaleWaiver]:
    """Declared waivers that suppressed nothing in this run. Only waivers
    whose tag maps to a SELECTED pass are judged; unknown tags are always
    reported (a typo'd tag suppresses nothing anywhere)."""
    selected_tags = {WAIVER_TAGS[p] for p in selected}
    out: List[StaleWaiver] = []
    for sf in ctx.files:
        for line, entries in sorted(sf.waivers.items()):
            for tag, reason in entries:
                if tag not in TAG_TO_PASS:
                    out.append(
                        StaleWaiver(
                            sf.path,
                            line,
                            tag,
                            reason,
                            f"unknown waiver tag {tag!r} — known tags: {', '.join(sorted(TAG_TO_PASS))}",
                        )
                    )
                    continue
                if tag not in selected_tags:
                    continue
                if (line, tag) not in sf.used_waivers:
                    out.append(
                        StaleWaiver(
                            sf.path,
                            line,
                            tag,
                            reason,
                            f"stale waiver: {tag}-ok({reason}) suppresses nothing — the line/def no longer "
                            f"triggers the {TAG_TO_PASS[tag]} pass; remove the waiver",
                        )
                    )
    return out


def run_lint_report(
    paths: Sequence[str],
    root: str,
    passes: Optional[Sequence[str]] = None,
    exclude: Sequence[str] = DEFAULT_EXCLUDE,
) -> LintReport:
    """run_lint plus the stale-waiver inventory (the --json/CI entry)."""
    violations, ctx, selected = _run_passes(paths, root, passes, exclude)
    return LintReport(violations=violations, stale_waivers=find_stale_waivers(ctx, selected), root=root)


def list_waivers(paths: Sequence[str], root: str) -> List[str]:
    """Greppable sync budget: every waiver in scope with its reason."""
    out = []
    for sf in collect_files(paths, root):
        for line, entries in sorted(sf.waivers.items()):
            for tag, reason in entries:
                out.append(f"{sf.path}:{line}: {tag}-ok({reason})")
    return out
