"""Captured-buffer pass: no rebinding of a tensor tree a captured graph reads.

The port's counterpart of the JAX package's donation pass. There a donated
input is dead after the call; here a captured CUDA graph reads and writes
the addresses it was captured on, so the engine's state, its autoscaler
statics, its step constants, the trace slab, the lane clocks and the
fault seeds must be written in place (`copy_`, `copy_state_into`), never
rebound: a rebinding leaves every graph on the old buffers (on the CPU,
without graphs, nothing shows; on the card the run silently diverges).
The sanitizer's address check (KTPU_SANITIZE) catches it at run time,
naming the leaf; this pass catches it at commit time.

Within the capture modules (lint.CAPTURE_MODULES: batched/engine.py,
graphs.py, fleet.py; or a `# ktpu: capture-module` pragma), flags any
assignment `X.<tree> = ...` (X any receiver: self, sim, eng, ...) to one
of CAPTURED_TREES, unless the same function then rebuilds the executor:
a later call of `WindowExecutor(...)`, `.rebuild()` or
`._bind_buffers()`, which binds new buffers and drops every graph
captured on the old ones.

Waive a deliberate rebinding (one that provably precedes every capture)
with `# ktpu: capture-ok(<reason>)` on its line.
"""

from __future__ import annotations

import ast
from typing import List

from kubernetriks_tpu_torch.lint import LintContext, Violation, dotted_name, is_capture_module

PASS_ID = "capture"

# The engine attributes holding tensors (or trees of them) the window
# pieces' captured graphs read.
CAPTURED_TREES = (
    "_state",
    "autoscale_statics",
    "consts",
    "slab",
    "_lane_clocks",
    "_fault_seeds",
    "profile_terms",
)
_REBUILDS = ("WindowExecutor", "rebuild", "_bind_buffers")


def _rebinds(st: ast.stmt):
    """(line, attribute) of every captured tree a statement rebinds."""
    targets = []
    if isinstance(st, ast.Assign):
        targets = list(st.targets)
    elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
        targets = [st.target]
    out = []
    while targets:
        tgt = targets.pop()
        if isinstance(tgt, (ast.Tuple, ast.List)):
            targets.extend(tgt.elts)
        elif isinstance(tgt, ast.Attribute) and tgt.attr in CAPTURED_TREES:
            out.append((tgt.lineno, dotted_name(tgt) or tgt.attr))
    return out


def _rebuild_lines(fn: ast.AST) -> List[int]:
    lines = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None and name.rsplit(".", 1)[-1] in _REBUILDS:
                lines.append(node.lineno)
    return lines


def check(ctx: LintContext) -> List[Violation]:
    violations: List[Violation] = []
    for sf in ctx.files:
        if not is_capture_module(sf):
            continue
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            rebuilds = _rebuild_lines(fn)
            for st in ast.walk(fn):
                if not isinstance(st, ast.stmt):
                    continue
                for line, what in _rebinds(st):
                    if any(r > line for r in rebuilds) or sf.waived(line, PASS_ID):
                        continue
                    violations.append(
                        Violation(
                            sf.path,
                            line,
                            PASS_ID,
                            f"rebinding of {what} in {fn.name}: a captured graph reads the old buffers; "
                            "write into them in place (copy_ / copy_state_into), or rebuild the executor "
                            "after the rebinding in the same function (WindowExecutor(...), .rebuild(), "
                            "._bind_buffers()); waive a rebinding that precedes every capture with "
                            "# ktpu: capture-ok(reason)",
                        )
                    )
    return violations
