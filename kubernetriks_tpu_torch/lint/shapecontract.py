"""Shape-contract pass: per-cluster lanes broadcast on declared axes only.

Port of the JAX package's pass, without its lane-major half (the port
keeps every node leaf (C, N)). Per-lane `(C,)` control-law leaves
(`hpa_tolerance`, `ca_threshold`, ...) meet `(C, G)` / `(C, P)`
per-object expressions in the autoscaler math. Broadcasting aligns from
the RIGHT, so a bare `util > st.hpa_tolerance` either fails on the shape
or, where the axis sizes happen to agree, silently broadcasts the lane
vector across the WRONG axis. The fixes are mechanical (`[:, None]`,
`.T`, `broadcast_to`); forgetting one is invisible until a heterogeneous
fleet diverges. This pass proves the mixes explicit.

Leaves carry declared axis signatures in `AXIS_SIGNATURES` registries
next to their NamedTuples (batched/state.py for state leaves,
batched/autoscale.py for autoscaler leaves; every in-scope registry is
merged). Signature grammar: comma-separated axis tokens, e.g. "C",
"C,G", "C,P", "C,*" (second axis intentionally unspecified: rank-only
checking).

A function-local abstract interpreter propagates signatures through
assignments, arithmetic, `torch.where` / `minimum` / `maximum`, `TPair`
leaves (`.win` / `.off`), `[:, None]` / `[..., None]` expansions (append
a broadcast-safe "1" axis) and `.T` (reverse). Anything else (slicing,
reductions, kernels) degrades to UNKNOWN: the pass only flags when BOTH
sides of an operator carry known, incompatible signatures, so it is quiet
by construction and loud exactly on the seeded bug class.

Waive a deliberate mix with `# ktpu: shape-ok(<reason>)`.
Scope: simulation-path modules (lint.SIM_MODULES or `# ktpu: sim-path`).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from kubernetriks_tpu_torch.lint import (
    LintContext,
    SourceFile,
    Violation,
    dotted_name,
    is_sim_path,
)

PASS_ID = "shapecontract"

REGISTRY_NAME = "AXIS_SIGNATURES"

# A signature: (tokens, origin leaf name).
Sig = Tuple[Tuple[str, ...], str]

_NEUTRAL_ATTRS = {"shape", "dtype", "ndim", "device"}
_PAIR_ATTRS = {"win", "off"}
# 2-arg elementwise combiners whose operands must already broadcast.
_COMBINE_CALLS = {
    "where",
    "minimum",
    "maximum",
    "add",
    "subtract",
    "multiply",
    "logical_and",
    "logical_or",
    "sub",
    "mul",
    "t_le",
    "t_lt",
    "t_ge",
    "t_gt",
    "t_eq",
    "t_add",
    "t_sub",
    "t_where",
    "t_min",
    "t_max",
}
# receiver-preserving methods: sig(x.m(...)) == sig(x)
_PRESERVE_METHODS = {"astype", "copy", "clip", "clamp", "clone", "to", "float", "double", "int", "long", "bool"}
_PRESERVE_CALLS = {"asarray", "abs", "negative", "logical_not", "copy", "clone"}


def collect_signatures(ctx: LintContext) -> Dict[str, Tuple[str, ...]]:
    """Merge every in-scope AXIS_SIGNATURES dict literal (str -> str)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for sf in ctx.files:
        if not isinstance(sf.tree, ast.Module):
            continue
        for node in sf.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == REGISTRY_NAME
                and isinstance(node.value, ast.Dict)
            ):
                for key, val in zip(node.value.keys, node.value.values):
                    if (
                        isinstance(key, ast.Constant)
                        and isinstance(key.value, str)
                        and isinstance(val, ast.Constant)
                        and isinstance(val.value, str)
                    ):
                        out[key.value] = tuple(
                            t.strip() for t in val.value.split(",")
                        )
    return out


def _compatible(a: Tuple[str, ...], b: Tuple[str, ...]) -> bool:
    """Right-aligned axis compatibility over declared tokens: tokens
    agree when equal, or either is "1" (explicit expansion) or "*"
    (declared-unknown). A SHORTER operand is fine when its tokens match
    the longer one's trailing axes — that is the broadcast the authors
    meant; a leading-axis match against a trailing mismatch is the bug."""
    for ta, tb in zip(reversed(a), reversed(b)):
        if ta == tb or ta in ("1", "*") or tb in ("1", "*"):
            continue
        return False
    return True


class _Checker:
    def __init__(
        self,
        sf: SourceFile,
        fn: ast.FunctionDef,
        registry: Dict[str, Tuple[str, ...]],
        violations: List[Violation],
    ):
        self.sf = sf
        self.fn = fn
        self.registry = registry
        self.violations = violations
        self.env: Dict[str, Sig] = {}

    # -- signature inference -------------------------------------------------

    def sig(self, node: ast.AST) -> Optional[Sig]:
        if isinstance(node, ast.Attribute):
            if node.attr in self.registry:
                return (self.registry[node.attr], node.attr)
            if node.attr in _PAIR_ATTRS:
                return self.sig(node.value)  # TPair leaves share its shape
            if node.attr == "T":
                base = self.sig(node.value)
                if base is not None:
                    return (tuple(reversed(base[0])), base[1])
                return base
            return None
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, bool, complex)):
                return ((), "scalar")
            return None
        if isinstance(node, ast.UnaryOp):
            return self.sig(node.operand)
        if isinstance(node, ast.BinOp):
            return self._combine(node, self.sig(node.left), self.sig(node.right))
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return None  # a presence check: a Python bool, no shape
            s = self.sig(node.left)
            for comp in node.comparators:
                s = self._combine(node, s, self.sig(comp))
            return s
        if isinstance(node, ast.BoolOp):
            s: Optional[Sig] = None
            for v in node.values:
                s = self._combine(node, s, self.sig(v))
            return s
        if isinstance(node, ast.IfExp):
            return self._combine(node, self.sig(node.body), self.sig(node.orelse))
        if isinstance(node, ast.Subscript):
            return self._subscript_sig(node)
        if isinstance(node, ast.Call):
            return self._call_sig(node)
        return None

    def _subscript_sig(self, node: ast.Subscript) -> Optional[Sig]:
        base = self.sig(node.value)
        if base is None:
            return None
        sl = node.slice
        elts = list(sl.elts) if isinstance(sl, ast.Tuple) else [sl]
        # x[:, None] / x[..., None] style: full slices / Ellipsis keep
        # axes, None inserts a broadcast-safe "1". Anything else (index,
        # bounded slice, mask) -> unknown.
        tokens = list(base[0])
        out: List[str] = []
        pos = 0
        for e in elts:
            if isinstance(e, ast.Constant) and e.value is None:
                out.append("1")
            elif isinstance(e, ast.Slice) and (
                e.lower is None and e.upper is None and e.step is None
            ):
                if pos >= len(tokens):
                    return None
                out.append(tokens[pos])
                pos += 1
            elif isinstance(e, ast.Constant) and e.value is Ellipsis:
                take = len(tokens) - pos - sum(
                    1
                    for r in elts[elts.index(e) + 1 :]
                    if not (isinstance(r, ast.Constant) and r.value is None)
                )
                out.extend(tokens[pos : pos + max(take, 0)])
                pos += max(take, 0)
            else:
                return None
        out.extend(tokens[pos:])
        return (tuple(out), base[1])

    def _call_sig(self, node: ast.Call) -> Optional[Sig]:
        fname = dotted_name(node.func)
        bare = fname.rsplit(".", 1)[-1] if fname else None
        if bare in _COMBINE_CALLS:
            s: Optional[Sig] = None
            for a in node.args:
                s = self._combine(node, s, self.sig(a))
            return s
        if bare in _PRESERVE_CALLS and len(node.args) >= 1:
            return self.sig(node.args[0])
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _PRESERVE_METHODS
        ):
            return self.sig(node.func.value)
        if bare == "TPair":
            s = None
            for kw in node.keywords:
                s = self._combine(node, s, self.sig(kw.value))
            for a in node.args:
                s = self._combine(node, s, self.sig(a))
            return s
        return None

    def _combine(
        self, node: ast.AST, a: Optional[Sig], b: Optional[Sig]
    ) -> Optional[Sig]:
        """Combine two operand signatures, flagging incompatible known
        pairs. Returns the broader signature (or None when unknown)."""
        if a is None:
            return b
        if b is None:
            return a
        ta, tb = a[0], b[0]
        if ta == ():
            return b
        if tb == ():
            return a
        if not _compatible(ta, tb):
            sa = "(" + ",".join(ta) + ("," if len(ta) == 1 else "") + ")"
            sb = "(" + ",".join(tb) + ("," if len(tb) == 1 else "") + ")"
            self._flag(
                node,
                f"{sa} expression from '{a[1]}' meets {sb} expression "
                f"from '{b[1]}' without an explicit [:, None] / "
                "transpose / broadcast_to — the per-cluster lane axis "
                "would broadcast on the wrong axis (the tolerance "
                "broadcast bug class)",
            )
            return None
        # the broader (higher-rank) signature wins
        return a if len(ta) >= len(tb) else b

    # -- violations ----------------------------------------------------------

    def _flag(self, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", self.fn.lineno)
        if self.sf.waived(line, PASS_ID):
            return
        v = Violation(
            self.sf.path,
            line,
            PASS_ID,
            f"{message}; waive a deliberate mix with "
            "# ktpu: shape-ok(reason)",
        )
        if v not in self.violations:
            self.violations.append(v)

    # -- walk ----------------------------------------------------------------

    def run(self) -> None:
        self.visit_stmts(self.fn.body)

    def visit_stmts(self, stmts) -> None:
        for st in stmts:
            self.visit_stmt(st)

    def visit_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        for _, value in ast.iter_fields(st):
            if isinstance(value, ast.expr):
                self.sig(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self.sig(v)
                    elif isinstance(v, ast.stmt):
                        self.visit_stmt(v)
                    elif isinstance(v, ast.excepthandler):
                        self.visit_stmts(v.body)
        if isinstance(st, ast.Assign):
            s = self.sig(st.value)
            for tgt in st.targets:
                if isinstance(tgt, ast.Name):
                    if s is not None:
                        self.env[tgt.id] = s
                    else:
                        self.env.pop(tgt.id, None)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            if isinstance(st.target, ast.Name):
                s = self.sig(st.value)
                if s is not None:
                    self.env[st.target.id] = s
                else:
                    self.env.pop(st.target.id, None)
        elif isinstance(st, ast.AugAssign):
            self._combine(st, self.sig(st.target), self.sig(st.value))


def check(ctx: LintContext) -> List[Violation]:
    registry = collect_signatures(ctx)
    if not registry:
        return []
    violations: List[Violation] = []
    for sf in ctx.files:
        if not is_sim_path(sf):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _Checker(sf, node, registry, violations).run()
    return violations
