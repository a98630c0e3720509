"""Scenario-trace discipline pass: the fleet's capture-once guarantee,
statically.

Port of the JAX package's pass. `ScenarioFleet` serves heterogeneous
what-if configs through ONE set of captured window graphs because every
scenario-bearing parameter is per-cluster (C,) device data written in
place (`fleet.scenario_leaves` composes it; `engine.update_scenario`
copies it into the tensors the graphs read). That guarantee dies silently
the moment a scenario leaf flows into anything that shapes a graph:
Python control flow, an `int()` / `.item()` / `.tolist()` host cast, a
shape expression, a piece key, or an argument of a capture; the next
wave then captures again (or replays a graph that baked the previous
wave's value in). The recompile sentinel catches the capture at run
time, naming its piece key; this pass catches the flow at commit time,
naming the leaf.

Sources: attribute reads of the registered per-lane leaves: the
`SCENARIO_TRACED_LEAVES` manifest next to `AutoscaleStatics`
(batched/autoscale.py) and `SCENARIO_TRACED_CONSTS` (batched/state.py:
the pod-fault seed vector and the lane clocks). The pass unions every
in-scope manifest with the built-in defaults, so fixtures and future
registries extend it without touching the pass.

Sinks (function-local taint):
- `if` / `while` / `assert` tests and `for` iterables;
- `int()` / `float()` / `bool()` casts and `.item()` / `.tolist()` reads;
- shape positions: `torch.zeros / ones / empty / full / arange(shape..)`,
  `broadcast_to(x, shape)`'s shape, `.reshape(...)` / `.view(...)` /
  `.expand(...)` args;
- a piece key: a tuple literal whose first element is a string (the
  executor's keys, `("end", route, ...)`), and any argument of a call
  of `capture(...)`.

`x is None` / `is not None` presence checks never flag (a leaf's
presence is a legitimate structural choice of the build). Waive a
deliberate host read, such as a build-time host mirror, with
`# ktpu: scenario-ok(<reason>)`.

Scope: simulation-path modules (lint.SIM_MODULES or `# ktpu: sim-path`).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from kubernetriks_tpu_torch.lint import (
    LintContext,
    SourceFile,
    Violation,
    dotted_name,
    is_sim_path,
)

PASS_ID = "scenariotrace"

# Built-in defaults so PARTIAL-scope lints (one changed file, without
# autoscale.py/state.py in scope) keep their taint sources; unioned with
# every in-scope SCENARIO_TRACED_LEAVES / SCENARIO_TRACED_CONSTS manifest
# (kept in the modules that own the leaves). This copy is pinned EQUAL to
# those manifests by tests/test_torch_lint.py.
DEFAULT_TRACED = frozenset(
    {
        # AutoscaleStatics per-lane control-law leaves (fleet-composed)
        "hpa_interval",
        "hpa_tolerance",
        "ca_threshold",
        "ca_max_nodes",
        "pg_active_from",
        "d_hpa_up",
        "d_hpa_down",
        "d_ca_up",
        "d_ca_down",
        "ca_period",
        "ca_snap",
        "ca_finish_vis",
        "ca_commit_vis",
        # the pod-fault seed vector (step.FaultStep.fault_seed)
        "fault_seed",
        # the lane clocks (state.LaneClocks; engine.set_lane_plan re-seeds
        # a finished lane in place: capture-once)
        "lane_clock",
        "lane_horizon",
    }
)
MANIFEST_NAMES = ("SCENARIO_TRACED_LEAVES", "SCENARIO_TRACED_CONSTS")

_NEUTRAL_ATTRS = {"shape", "dtype", "ndim", "device"}
_CAST_FUNCS = {"int", "float", "bool"}
_NEUTRAL_FUNCS = {"hasattr", "isinstance", "len", "getattr", "type", "id"}
# callee bare name -> indices of its SHAPE-position arguments
_SHAPE_ARGS: Dict[str, Tuple[int, ...]] = {
    "zeros": (0,),
    "ones": (0,),
    "empty": (0,),
    "full": (0,),
    "arange": (0, 1, 2),
    "broadcast_to": (1,),
}
_SHAPE_METHODS = {"reshape", "view", "expand"}
_HOST_READ_METHODS = {"item", "tolist"}


def _collect_traced(ctx: LintContext) -> frozenset:
    names: Set[str] = set(DEFAULT_TRACED)
    for sf in ctx.files:
        if not isinstance(sf.tree, ast.Module):
            continue
        for node in sf.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in MANIFEST_NAMES
                and isinstance(node.value, (ast.Tuple, ast.List))
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str
                    ):
                        names.add(elt.value)
    return frozenset(names)


class _Checker:
    def __init__(
        self,
        sf: SourceFile,
        fn: ast.FunctionDef,
        traced: frozenset,
        violations: List[Violation],
    ):
        self.sf = sf
        self.fn = fn
        self.traced = traced
        self.violations = violations
        self.tainted: Set[str] = set()

    # -- taint ---------------------------------------------------------------

    def _leaf_of(self, node: ast.AST) -> str:
        """Best-effort leaf name for the message."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr in self.traced:
                return sub.attr
        return "scenario leaf"

    def _is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            if node.attr in _NEUTRAL_ATTRS:
                return False
            if node.attr in self.traced:
                return True
            return self._is_tainted(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname is not None:
                bare = fname.rsplit(".", 1)[-1]
                if bare in _CAST_FUNCS or bare in _NEUTRAL_FUNCS:
                    return False  # casts are flagged as sinks, not sources
            # traced data stays traced through array ops / helpers —
            # including method calls on tainted receivers (.sum(), .any())
            if isinstance(node.func, ast.Attribute) and node.func.attr not in _HOST_READ_METHODS:
                if self._is_tainted(node.func.value):
                    return True
            return any(
                self._is_tainted(a) for a in node.args
            ) or any(self._is_tainted(kw.value) for kw in node.keywords)
        if isinstance(node, ast.Subscript):
            return self._is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tainted(node.left) or self._is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False  # presence checks are structural statics
            return self._is_tainted(node.left) or any(
                self._is_tainted(c) for c in node.comparators
            )
        if isinstance(node, ast.IfExp):
            return self._is_tainted(node.body) or self._is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self._is_tainted(node.value)
        return False

    # -- violations ----------------------------------------------------------

    def _flag(self, node: ast.AST, leaf: str, what: str) -> None:
        if self.sf.waived(node.lineno, PASS_ID):
            return
        self.violations.append(
            Violation(
                self.sf.path,
                node.lineno,
                PASS_ID,
                f"per-lane scenario leaf '{leaf}' flows into {what} — a "
                "what-if config would shape a captured graph and the "
                "fleet's capture-once guarantee breaks (a capture per "
                "wave); keep scenario leaves on the device, or waive a "
                "deliberate host read with # ktpu: scenario-ok(reason)",
            )
        )

    def _check_expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Tuple)
                and sub.elts
                and isinstance(sub.elts[0], ast.Constant)
                and isinstance(sub.elts[0].value, str)
            ):
                for e in sub.elts[1:]:
                    if self._is_tainted(e):
                        self._flag(sub, self._leaf_of(e), f"a piece key {sub.elts[0].value!r}")
                        break
                continue
            if not isinstance(sub, ast.Call):
                continue
            fname = dotted_name(sub.func)
            bare = fname.rsplit(".", 1)[-1] if fname else None
            if (
                bare in _CAST_FUNCS
                and len(sub.args) == 1
                and self._is_tainted(sub.args[0])
            ):
                self._flag(
                    sub,
                    self._leaf_of(sub.args[0]),
                    f"a host {bare}() cast",
                )
                continue
            if (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _HOST_READ_METHODS
                and not sub.args
                and self._is_tainted(sub.func.value)
            ):
                self._flag(sub, self._leaf_of(sub.func.value), f"a .{sub.func.attr}() read")
                continue
            if bare == "capture":
                for a in list(sub.args) + [kw.value for kw in sub.keywords]:
                    if self._is_tainted(a):
                        self._flag(sub, self._leaf_of(a), "an argument of a capture")
                        break
                continue
            # shape-position arguments
            shape_idx: Tuple[int, ...] = ()
            if bare in _SHAPE_ARGS:
                shape_idx = _SHAPE_ARGS[bare]
            elif isinstance(sub.func, ast.Attribute) and sub.func.attr in _SHAPE_METHODS:
                shape_idx = tuple(range(len(sub.args)))
            for i in shape_idx:
                if i < len(sub.args) and self._is_tainted(sub.args[i]):
                    self._flag(
                        sub,
                        self._leaf_of(sub.args[i]),
                        f"a shape expression ({bare or 'reshape'} arg {i})",
                    )

    # -- walk ----------------------------------------------------------------

    def run(self) -> None:
        self.visit_stmts(self.fn.body)

    def visit_stmts(self, stmts) -> None:
        for st in stmts:
            self.visit_stmt(st)

    def visit_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(st, (ast.If, ast.While)):
            self._check_expr(st.test)
            if self._is_tainted(st.test):
                self._flag(
                    st, self._leaf_of(st.test), "Python control flow"
                )
            for body in (st.body, st.orelse):
                self.visit_stmts(body)
            return
        if isinstance(st, ast.Assert):
            self._check_expr(st.test)
            if self._is_tainted(st.test):
                self._flag(st, self._leaf_of(st.test), "a Python assert")
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._check_expr(st.iter)
            if self._is_tainted(st.iter):
                self._flag(st, self._leaf_of(st.iter), "Python iteration")
            self.visit_stmts(st.body)
            self.visit_stmts(st.orelse)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._check_expr(item.context_expr)
            self.visit_stmts(st.body)
            return
        if isinstance(st, ast.Try):
            self.visit_stmts(st.body)
            for handler in st.handlers:
                self.visit_stmts(handler.body)
            self.visit_stmts(st.orelse)
            self.visit_stmts(st.finalbody)
            return
        for _, value in ast.iter_fields(st):
            if isinstance(value, ast.expr):
                self._check_expr(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self._check_expr(v)
        if isinstance(st, ast.Assign):
            tainted = self._is_tainted(st.value)
            for tgt in st.targets:
                elts = (
                    tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
                )
                for e in elts:
                    path = dotted_name(e)
                    if path is None:
                        continue
                    if tainted:
                        self.tainted.add(path)
                    else:
                        self.tainted.discard(path)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            path = dotted_name(st.target)
            if path is not None:
                if self._is_tainted(st.value):
                    self.tainted.add(path)
                else:
                    self.tainted.discard(path)
        elif isinstance(st, ast.AugAssign):
            if self._is_tainted(st.value):
                path = dotted_name(st.target)
                if path is not None:
                    self.tainted.add(path)


def check(ctx: LintContext) -> List[Violation]:
    traced = _collect_traced(ctx)
    violations: List[Violation] = []
    for sf in ctx.files:
        if not is_sim_path(sf):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _Checker(sf, node, traced, violations).run()
    return violations
