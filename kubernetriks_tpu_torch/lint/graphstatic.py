"""Step-call discipline pass: coupled window-program keywords travel together.

The port's counterpart of the JAX package's jitstatic rules 1 and 3. The
window program's configuration objects (`profile`, the compiled scheduler
profile; `faults`, the chaos engine's FaultStep; `profile_terms`, the
cycle kernels' term table on the card) each default silently in the step
functions that take them (batched/step.py): a call that forwards one but
forgets another runs the default scheduler or the fault-free window no
matter what the engine configured, and captures that into its graph.
Rules, for every call in scope of a step function (one defined at the
top level of batched/step.py, or of a `# ktpu: step-module` fixture;
called by its bare name where step.py defines or imports it, or as an
attribute of a module alias of step.py):

1. every keyword the call names exists in the callee's signature (or the
   callee takes **kwargs) — a renamed parameter otherwise fails only at
   run time, on the path that reaches it;
2. a callee whose signature takes all of COUPLED_KEYWORDS is called with
   all of them or none of them (positionally passed ones count).

Waive with `# ktpu: graphstatic-ok(<reason>)` on the call's line.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from kubernetriks_tpu_torch.lint import (
    STEP_MODULE,
    LintContext,
    SourceFile,
    StepFunction,
    Violation,
    dotted_name,
    func_params,
)

PASS_ID = "graphstatic"

COUPLED_KEYWORDS: Tuple[str, ...] = ("profile", "faults", "profile_terms")

_STEP_DOTTED = STEP_MODULE[: -len(".py")].replace("/", ".")  # kubernetriks_tpu_torch.batched.step


def _local_step_functions(sf: SourceFile) -> Dict[str, StepFunction]:
    out: Dict[str, StepFunction] = {}
    for node in sf.tree.body if isinstance(sf.tree, ast.Module) else []:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params, varkw = func_params(node)
            out[node.name] = StepFunction(node.name, sf.path, params, varkw)
    return out


def _bindings(sf: SourceFile, table: Dict[str, StepFunction]) -> Tuple[Dict[str, str], Set[str]]:
    """(local name -> step function name, module aliases of step.py) in
    one file."""
    names: Dict[str, str] = {}
    modules: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == _STEP_DOTTED:
                for a in node.names:
                    if a.name in table:
                        names[a.asname or a.name] = a.name
            elif mod == _STEP_DOTTED.rsplit(".", 1)[0]:
                for a in node.names:
                    if a.name == "step":
                        modules.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _STEP_DOTTED:
                    modules.add(a.asname or a.name)
    return names, modules


def _resolve(call: ast.Call, names: Dict[str, str], modules: Set[str], table) -> Optional[StepFunction]:
    func = call.func
    if isinstance(func, ast.Name) and func.id in names:
        return table[names[func.id]]
    if isinstance(func, ast.Attribute):
        recv = dotted_name(func.value)
        if recv in modules and func.attr in table:
            return table[func.attr]
    return None


def _passed(call: ast.Call, fn: StepFunction) -> Set[str]:
    """Parameter names the call binds, positionally or by keyword."""
    out = {kw.arg for kw in call.keywords if kw.arg}
    n_pos = 0
    for a in call.args:
        if isinstance(a, ast.Starred):
            return out | set(fn.params)  # *args: cannot tell; treat as all
        n_pos += 1
    out |= set(fn.params[:n_pos])
    return out


def check(ctx: LintContext) -> List[Violation]:
    violations: List[Violation] = []
    for sf in ctx.files:
        if "step-module" in sf.pragmas:
            table = _local_step_functions(sf)
            names = {n: n for n in table}
            modules: Set[str] = set()
        else:
            table = ctx.step_functions
            if not table:
                continue
            if sf.path == STEP_MODULE:
                names, modules = {n: n for n in table}, set()
            else:
                names, modules = _bindings(sf, table)
            if not names and not modules:
                continue
        for call in ast.walk(sf.tree):
            if not isinstance(call, ast.Call):
                continue
            fn = _resolve(call, names, modules, table)
            if fn is None or any(kw.arg is None for kw in call.keywords):
                continue  # **kwargs forwarding: the keywords are not known here
            problems = []
            if not fn.has_varkw:
                unknown = sorted(kw.arg for kw in call.keywords if kw.arg not in fn.params)
                if unknown:
                    problems.append(
                        f"keyword(s) {unknown} name no parameter of {fn.name} ({fn.path}; params: "
                        f"{', '.join(fn.params)})"
                    )
            if all(k in fn.params for k in COUPLED_KEYWORDS):
                passed = _passed(call, fn)
                present = [k for k in COUPLED_KEYWORDS if k in passed]
                if present and len(present) != len(COUPLED_KEYWORDS):
                    missing = [k for k in COUPLED_KEYWORDS if k not in passed]
                    problems.append(
                        f"call of {fn.name} passes {present} but not {missing}: the coupled window-program "
                        f"keywords {list(COUPLED_KEYWORDS)} must travel together, or the callee silently "
                        "runs the default for the missing one"
                    )
            if problems and not sf.waived(call.lineno, PASS_ID):
                for msg in problems:
                    violations.append(Violation(sf.path, call.lineno, PASS_ID, msg))
    return violations
