"""Feeder-lock discipline pass: threaded modules share state under the
lock, and never block while holding it.

Port of the JAX package's pass. `batched/stream.py` runs a producer
THREAD against the engine thread, sharing a slab ring plus its counters
through one condition variable (`StreamFeeder._cond`). The invariants
that keep it correct:

1. every instance attribute MUTATED outside `__init__` (the shared
   mutable set — attributes only written in `__init__` are thread-safe
   configuration and exempt) is read and written ONLY inside a
   `with self.<lock>:` block, unless it is declared in an explicit
   class-level `_LOCK_FREE` handoff tuple (with the reason in a
   comment) or line-waived;
2. no blocking call while HOLDING the lock: `torch.cuda.synchronize()`,
   an Event's or Stream's `.synchronize()`, `time.sleep`, `.join()` and
   `.wait()` on anything that is not the lock itself (a condvar
   `self._cond.wait()` releases the lock while waiting — that one is the
   point) would stall both threads.

3. (the port's addition) helper methods a class declares in a
   class-level `_UNDER_LOCK` tuple are only ever called while holding
   the lock: their bodies count as locked, and a call of one outside a
   `with self.<lock>:` block (or another such helper) is a violation.

Lock attributes are discovered, not configured: any `self.X =
threading.Condition/Lock/RLock(...)` in `__init__`. Classes without one
are skipped (nothing to hold). `__init__` is exempt end to end — it runs
before the thread starts (starting the thread is its last act by
convention; a violation of THAT convention shows up as an unlocked
write from the producer body instead).

Waive with `# ktpu: lock-ok(<reason>)`.
Scope: `batched/stream.py` and any module carrying `# ktpu: threaded`.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from kubernetriks_tpu_torch.lint import (
    LintContext,
    SourceFile,
    Violation,
    dotted_name,
    is_threaded,
)

PASS_ID = "feederlock"

_LOCK_CTORS = {"Condition", "Lock", "RLock"}
_BLOCKING_BARE = {"sleep", "join", "synchronize"}
# In-place container mutation counts as a write (`self._ring.append(..)`)
_MUTATOR_METHODS = {
    "append",
    "appendleft",
    "pop",
    "popleft",
    "extend",
    "clear",
    "add",
    "remove",
    "discard",
    "update",
    "insert",
}
HANDOFF_CONST = "_LOCK_FREE"
UNDER_LOCK_CONST = "_UNDER_LOCK"


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' for a one-level self.X attribute access, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    locks: Set[str] = set()
    for method in cls.body:
        if not isinstance(method, ast.FunctionDef) or method.name != "__init__":
            continue
        for node in ast.walk(method):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                fname = dotted_name(node.value.func) or ""
                if fname.rsplit(".", 1)[-1] in _LOCK_CTORS:
                    for tgt in node.targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            locks.add(attr)
    return locks


def _handoff(cls: ast.ClassDef, const: str = HANDOFF_CONST) -> Set[str]:
    for node in cls.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == const
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            return {
                e.value
                for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
    return set()


class _Touch:
    __slots__ = ("attr", "line", "locked", "write", "method")

    def __init__(self, attr, line, locked, write, method):
        self.attr = attr
        self.line = line
        self.locked = locked
        self.write = write
        self.method = method


class _MethodWalker:
    """Collects self-attribute touches with lock context, and flags
    blocking calls made while the lock is held."""

    def __init__(
        self,
        sf: SourceFile,
        method: ast.FunctionDef,
        locks: Set[str],
        touches: List[_Touch],
        violations: List[Violation],
        under_lock: Set[str] = frozenset(),
    ):
        self.sf = sf
        self.method = method
        self.locks = locks
        self.touches = touches
        self.violations = violations
        self.under_lock = under_lock

    def run(self) -> None:
        self._visit_stmts(self.method.body, locked=self.method.name in self.under_lock)

    def _is_lock_expr(self, node: ast.AST) -> bool:
        attr = _self_attr(node)
        return attr is not None and attr in self.locks

    def _visit_stmts(self, stmts, locked: bool) -> None:
        for st in stmts:
            self._visit_stmt(st, locked)

    def _visit_stmt(self, st: ast.stmt, locked: bool) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs run later, outside this lock scope
        if isinstance(st, (ast.With, ast.AsyncWith)):
            inner = locked
            for item in st.items:
                self._scan_expr(item.context_expr, locked, writes=False)
                if self._is_lock_expr(item.context_expr):
                    inner = True
            self._visit_stmts(st.body, inner)
            return
        # compound statements: scan their own expressions, then bodies
        for field, value in ast.iter_fields(st):
            if isinstance(value, ast.expr):
                self._scan_expr(
                    value,
                    locked,
                    writes=field in ("target", "targets"),
                )
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        writes = (
                            isinstance(st, (ast.Assign, ast.Delete))
                            and field == "targets"
                        )
                        self._scan_expr(v, locked, writes=writes)
                    elif isinstance(v, ast.stmt):
                        self._visit_stmt(v, locked)
                    elif isinstance(v, ast.excepthandler):
                        self._visit_stmts(v.body, locked)

    def _scan_expr(self, node: ast.AST, locked: bool, writes: bool) -> None:
        for sub in ast.walk(node):
            # `self.X[i] = v` / `del self.X[i]` / `del self.X`: the inner
            # Attribute carries Load ctx, but the containing Store/Del
            # Subscript (or the Delete target itself) mutates the attr.
            if writes and isinstance(sub, ast.Subscript) and isinstance(
                sub.ctx, (ast.Store, ast.Del)
            ):
                recv = _self_attr(sub.value)
                if recv is not None and recv not in self.locks:
                    self.touches.append(
                        _Touch(recv, sub.lineno, locked, True, self.method.name)
                    )
            attr = _self_attr(sub)
            if attr is not None and attr not in self.locks:
                is_write = writes and isinstance(
                    getattr(sub, "ctx", None), (ast.Store, ast.Del)
                )
                self.touches.append(
                    _Touch(
                        attr,
                        sub.lineno,
                        locked,
                        is_write,
                        self.method.name,
                    )
                )
            # self.X.append(...) style in-place mutation is a write too
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _MUTATOR_METHODS
            ):
                recv = _self_attr(sub.func.value)
                if recv is not None and recv not in self.locks:
                    self.touches.append(
                        _Touch(recv, sub.lineno, locked, True, self.method.name)
                    )
            if locked and isinstance(sub, ast.Call):
                self._check_blocking(sub)
            if (
                not locked
                and isinstance(sub, ast.Call)
                and _self_attr(sub.func) in self.under_lock
                and not self.sf.waived(sub.lineno, PASS_ID)
            ):
                self.violations.append(
                    Violation(
                        self.sf.path,
                        sub.lineno,
                        PASS_ID,
                        f"call of self.{sub.func.attr}() outside the lock in {self.method.name}: it is "
                        f"declared in {UNDER_LOCK_CONST} (its body runs as if locked); call it inside "
                        f"`with self.{sorted(self.locks)[0]}:`, or waive with # ktpu: lock-ok(reason)",
                    )
                )

    def _check_blocking(self, call: ast.Call) -> None:
        fname = dotted_name(call.func)
        bare = fname.rsplit(".", 1)[-1] if fname else None
        blocking = bare in _BLOCKING_BARE
        if (
            not blocking
            and isinstance(call.func, ast.Attribute)
            and call.func.attr in ("wait", "acquire")
            and not self._is_lock_expr(call.func.value)
        ):
            blocking = True
        if blocking and not self.sf.waived(call.lineno, PASS_ID):
            self.violations.append(
                Violation(
                    self.sf.path,
                    call.lineno,
                    PASS_ID,
                    f"blocking call ({fname or call.func.attr}) while "
                    "HOLDING the ring lock — both threads stall (the "
                    "condvar's own .wait() releases it and is the one "
                    "legal wait); move the wait outside the with block, "
                    "or waive with # ktpu: lock-ok(reason)",
                )
            )


def _check_class(
    sf: SourceFile, cls: ast.ClassDef, violations: List[Violation]
) -> None:
    locks = _lock_attrs(cls)
    if not locks:
        return
    handoff = _handoff(cls)
    under_lock = _handoff(cls, UNDER_LOCK_CONST)
    touches: List[_Touch] = []
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        _MethodWalker(sf, method, locks, touches, violations, under_lock).run()
    # Shared-mutable set: attributes WRITTEN outside __init__.
    shared = {
        t.attr
        for t in touches
        if t.write and t.method != "__init__"
    }
    shared -= handoff
    for t in touches:
        if (
            t.attr in shared
            and t.method != "__init__"
            and not t.locked
            and not sf.waived(t.line, PASS_ID)
        ):
            kind = "write to" if t.write else "read of"
            violations.append(
                Violation(
                    sf.path,
                    t.line,
                    PASS_ID,
                    f"unlocked {kind} shared attribute self.{t.attr} in "
                    f"{cls.name}.{t.method} (mutated off-thread) — touch "
                    f"it under `with self.{sorted(locks)[0]}:`, declare "
                    f"it in {cls.name}.{HANDOFF_CONST} with the handoff "
                    "story, or waive with # ktpu: lock-ok(reason)",
                )
            )


def check(ctx: LintContext) -> List[Violation]:
    violations: List[Violation] = []
    for sf in ctx.files:
        if not is_threaded(sf):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                _check_class(sf, node, violations)
    return violations
