"""Host-sync discipline pass: hot paths must not grow implicit host syncs.

Port of the JAX package's pass, its sources and sinks those of PyTorch.
Within hot-path modules (lint.HOT_MODULES, or any file carrying a
`# ktpu: hot-path` pragma), flags:

- `.item()`, `.cpu()` and `.numpy()` calls, and `.tolist()` of a tensor
  (a numpy array's `.tolist()` is host work and stays quiet);
- `.to("cpu")` / `.to(device="cpu")`: a device-to-host copy;
- `torch.cuda.synchronize()` and `.synchronize()` of an Event or Stream;
- `to_host` / `sanitize.to_host`, the port's device-to-host read;
- `int()` / `float()` / `bool()` applied to a tensor-valued expression
  (a blocking read through `__int__` / `__bool__`);
- Python `if` / `while` branching on a tensor (an implicit `bool()`).

"Tensor-valued" is a function-local taint analysis: `torch.*` tensor ops
and the state's leaves (a `state` / `bufs` name, or any `.state` /
`._state` / `.bufs` attribute chain) are sources; taint propagates through names assigned from tainted
expressions, through `self.X` attributes assigned from `torch.*` calls
anywhere in the same class, and through arithmetic, subscripts, method
calls and attribute access, but NOT through the syncs themselves
(`int(...)`, `to_host(...)`, `.tolist()` yield host values: the sync is
flagged at the conversion, and downstream host logic stays clean).
`is` / `is not` comparisons, `hasattr`, `isinstance`, `len` and `.shape`
/ `.dtype` / `.ndim` / `.device` reads never sync and never taint.

Every legitimate sync carries `# ktpu: sync-ok(<reason>)` on its line, or
on the enclosing `def` line to waive a whole cold-path function, which
makes the hot paths' sync budget greppable:
    grep -rn "ktpu: sync-ok" kubernetriks_tpu_torch/
The same reads run inside sanitize.allow_transfer scopes under
KTPU_SANITIZE, whose guard raises on any other.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from kubernetriks_tpu_torch.lint import LintContext, SourceFile, Violation, dotted_name, is_hot

PASS_ID = "hostsync"

_SYNC_FUNCS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize",
    "to_host": "to_host (device-to-host read)",
    "sanitize.to_host": "to_host (device-to-host read)",
}
# Methods that always read the device back (numpy arrays have .item()
# too: the reference flags it unconditionally, and so does this pass).
_SYNC_METHODS = {"item", "cpu", "numpy", "synchronize"}
# Methods that read back only from a tensor receiver.
_TENSOR_SYNC_METHODS = {"tolist"}
_CAST_FUNCS = {"int", "float", "bool"}
# Never sync and never propagate taint.
_NEUTRAL_FUNCS = {"hasattr", "isinstance", "len", "getattr", "type", "id", "range"}
_NEUTRAL_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}
_TAINT_ROOT = "torch."
# torch.* calls that return no tensor (devices, dtypes, streams, events).
_NON_TENSOR_TORCH = ("torch.device", "torch.cuda.", "torch.dtype", "torch.Size", "torch.get_", "torch.is_")
# Names and attribute names whose chains are the engine's tensor trees.
_STATE_ATTRS = {"state", "_state", "bufs"}


def _is_cpu_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


class _ClassTaint:
    """self.X attributes assigned from torch.* calls anywhere in a class
    body taint `self.X` reads in every method of that class."""

    def __init__(self):
        self.attrs: Set[str] = set()


class _FunctionChecker:
    def __init__(
        self,
        sf: SourceFile,
        fn: ast.FunctionDef,
        class_taint: Optional[_ClassTaint],
        violations: List[Violation],
    ):
        self.sf = sf
        self.fn = fn
        self.class_taint = class_taint
        self.violations = violations
        self.tainted: Set[str] = set()
        # Non-recording probe: the def-scoped waiver only counts as USED
        # (stale-waiver accounting) when it actually suppresses a flag.
        self.fn_waived = sf.has_waiver(fn.lineno, PASS_ID)

    # -- taint ----------------------------------------------------------------

    def _is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname is not None:
                bare = fname.rsplit(".", 1)[-1]
                if fname in _SYNC_FUNCS or bare in _CAST_FUNCS or bare in _NEUTRAL_FUNCS:
                    return False  # conversion yields a host value
                if fname.startswith(_TAINT_ROOT):
                    return not fname.startswith(_NON_TENSOR_TORCH)
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _SYNC_METHODS or node.func.attr in _TENSOR_SYNC_METHODS:
                    return False
                # method calls on tainted receivers stay tainted (.sum(), .any())
                return self._is_tainted(node.func.value)
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _NEUTRAL_ATTRS:
                return False
            if node.attr in _STATE_ATTRS:
                return True
            path = dotted_name(node)
            if path is not None:
                if path in self.tainted:
                    return True
                if (
                    self.class_taint is not None
                    and path.startswith("self.")
                    and path.split(".")[1] in self.class_taint.attrs
                ):
                    return True
                if path.startswith(_TAINT_ROOT):
                    return False  # module constant like torch.int32
            return self._is_tainted(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.tainted or node.id in _STATE_ATTRS
        if isinstance(node, ast.Subscript):
            return self._is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self._is_tainted(node.left) or self._is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not y` never reads the tensor's value.
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return self._is_tainted(node.left) or any(self._is_tainted(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self._is_tainted(node.body) or self._is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self._is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self._is_tainted(node.value)
        return False

    def _assign_taint(self, targets, value) -> None:
        tainted = self._is_tainted(value)

        def mark(tgt, is_tainted):
            if isinstance(tgt, (ast.Tuple, ast.List)):
                # tuple unpack of a tainted rhs taints every element
                for e in tgt.elts:
                    mark(e, is_tainted)
                return
            path = dotted_name(tgt)
            if path is None:
                return
            if is_tainted:
                self.tainted.add(path)
            else:
                self.tainted.discard(path)

        for tgt in targets:
            mark(tgt, tainted)

    # -- violations -----------------------------------------------------------

    def _flag(self, node: ast.AST, message: str) -> None:
        line = node.lineno
        if self.sf.waived(line, PASS_ID):
            return
        if self.fn_waived:
            self.sf.waived(self.fn.lineno, PASS_ID)  # record def-waiver use
            return
        self.violations.append(
            Violation(
                self.sf.path,
                line,
                PASS_ID,
                f"{message} in hot-path module; waive a legitimate sync with # ktpu: sync-ok(reason)",
            )
        )

    def _check_expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fname = dotted_name(sub.func)
            if fname in _SYNC_FUNCS:
                self._flag(sub, f"host sync: {_SYNC_FUNCS[fname]}")
                continue
            if isinstance(sub.func, ast.Attribute):
                attr = sub.func.attr
                if attr in _SYNC_METHODS and not sub.args:
                    self._flag(sub, f"host sync: .{attr}()")
                    continue
                if attr in _TENSOR_SYNC_METHODS and not sub.args and self._is_tainted(sub.func.value):
                    self._flag(sub, f"host sync: .{attr}() of a tensor")
                    continue
                if attr == "to" and (
                    any(_is_cpu_literal(a) for a in sub.args)
                    or any(kw.arg == "device" and _is_cpu_literal(kw.value) for kw in sub.keywords)
                ):
                    self._flag(sub, 'host sync: .to("cpu")')
                    continue
            if fname in _CAST_FUNCS and len(sub.args) == 1 and self._is_tainted(sub.args[0]):
                self._flag(
                    sub,
                    f"host sync: {fname}() on a tensor-valued expression (blocking device-to-host read)",
                )

    # -- walk -----------------------------------------------------------------

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
                self._flag(st, "Python branch on a tensor value (implicit bool() sync)")
            for body in (st.body, st.orelse):
                self.visit_stmts(body)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._check_expr(st.iter)
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
        # simple statement: check expressions, then propagate assignment taint
        for _, value in ast.iter_fields(st):
            if isinstance(value, ast.expr):
                self._check_expr(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self._check_expr(v)
        if isinstance(st, ast.Assign):
            self._assign_taint(st.targets, st.value)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            self._assign_taint([st.target], st.value)
        elif isinstance(st, ast.AugAssign):
            if self._is_tainted(st.value):
                path = dotted_name(st.target)
                if path is not None:
                    self.tainted.add(path)


def _collect_class_taint(cls: ast.ClassDef) -> _ClassTaint:
    """Seed-level taint for class attrs: `self.X = torch.*(...)` anywhere
    in the class (one level, no fixpoint across methods)."""
    taint = _ClassTaint()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
            continue
        fname = dotted_name(node.value.func) or ""
        if not (fname.startswith(_TAINT_ROOT) and not fname.startswith(_NON_TENSOR_TORCH)):
            continue
        for tgt in node.targets:
            path = dotted_name(tgt)
            if path is not None and path.startswith("self.") and path.count(".") == 1:
                taint.attrs.add(path.split(".")[1])
    return taint


def check(ctx: LintContext) -> List[Violation]:
    violations: List[Violation] = []
    for sf in ctx.files:
        if not is_hot(sf):
            continue
        for node in sf.tree.body if isinstance(sf.tree, ast.Module) else []:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _FunctionChecker(sf, node, None, violations).run()
            elif isinstance(node, ast.ClassDef):
                taint = _collect_class_taint(node)
                for method in node.body:
                    if isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        _FunctionChecker(sf, method, taint, violations).run()
    return violations
