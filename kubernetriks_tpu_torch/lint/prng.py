"""PRNG-hygiene pass: simulation-path randomness routes through chaos.py.

Port of the JAX package's pass. Card/CPU/JAX bit-identity (the port's
exactness promise, pinned by the parity suites) holds because every random
draw on the simulation path flows through the counter-based threefry
keying in `chaos.py`: keys are pure functions of (seed, stream, cluster,
object, counter), so the scalar oracle, the CPU engine and the card draw
identical numbers in any order. An ad-hoc draw on the simulation path
breaks that silently.

Within simulation-path modules (lint.SIM_MODULES, or a `# ktpu: sim-path`
pragma), flags:

- any `np.random.*` / `numpy.random.*` use, and `from numpy.random import`;
- stdlib `random` usage (`import random`, `random.*`, `from random
  import ...`);
- a torch draw without an explicit `generator=`: `torch.rand`,
  `rand_like`, `randn`, `randn_like`, `randint`, `randint_like`,
  `randperm`, `bernoulli`, `multinomial`, `normal`, `poisson`, and the
  in-place `.normal_()`, `.uniform_()`, `.bernoulli_()`, `.random_()`,
  `.exponential_()`, `.geometric_()`, `.log_normal_()`, `.cauchy_()`
  (the global generator's state is whatever ran before);
- `torch.manual_seed` / `torch.cuda.manual_seed(_all)` / `torch.seed`
  (reseeding the global generator).

chaos.py itself (the key constructor) lives at the package root, outside
the simulation-path module set. Waive deliberate uses with
`# ktpu: prng-ok(<reason>)`, e.g. the scalar oracle's seeded
reference-port RNG.
"""

from __future__ import annotations

import ast
from typing import List

from kubernetriks_tpu_torch.lint import LintContext, SourceFile, Violation, dotted_name, is_sim_path

PASS_ID = "prng"

_FORBIDDEN_PREFIXES = ("np.random.", "numpy.random.", "random.")
_FORBIDDEN_IMPORT_MODULES = ("numpy.random", "random")
_TORCH_DRAWS = {
    "rand",
    "rand_like",
    "randn",
    "randn_like",
    "randint",
    "randint_like",
    "randperm",
    "bernoulli",
    "multinomial",
    "normal",
    "poisson",
}
_INPLACE_DRAWS = {
    "normal_",
    "uniform_",
    "bernoulli_",
    "random_",
    "exponential_",
    "geometric_",
    "log_normal_",
    "cauchy_",
}
_RESEEDS = {"torch.manual_seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all", "torch.seed"}


def _flag(sf: SourceFile, node: ast.AST, what: str, out: List[Violation]):
    if sf.waived(node.lineno, PASS_ID):
        return
    out.append(
        Violation(
            sf.path,
            node.lineno,
            PASS_ID,
            f"{what} in a simulation-path module: route all draws through "
            "the counter-based key constructors in chaos.py "
            "(object_uniforms / pod_attempt_uniforms) or card/CPU/JAX "
            "bit-identity breaks; waive with # ktpu: prng-ok(reason)",
        )
    )


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def check(ctx: LintContext) -> List[Violation]:
    violations: List[Violation] = []
    for sf in ctx.files:
        if not is_sim_path(sf):
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name in _FORBIDDEN_IMPORT_MODULES:
                        _flag(sf, node, f"import of {alias.name!r}", violations)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod in _FORBIDDEN_IMPORT_MODULES:
                    _flag(
                        sf,
                        node,
                        f"import from {mod!r} ({', '.join(a.name for a in node.names)})",
                        violations,
                    )
                elif mod == "numpy" and any(a.name == "random" for a in node.names):
                    _flag(sf, node, "import of numpy.random", violations)
            elif isinstance(node, ast.Attribute):
                path = dotted_name(node)
                if path is not None and any(
                    path.startswith(p) or path == p.rstrip(".") for p in _FORBIDDEN_PREFIXES
                ):
                    _flag(sf, node, f"use of {path}", violations)
            elif isinstance(node, ast.Call):
                fname = dotted_name(node.func)
                if fname in _RESEEDS:
                    _flag(sf, node, f"{fname}() (reseeds the global generator)", violations)
                elif (
                    fname is not None
                    and fname.startswith("torch.")
                    and fname.rsplit(".", 1)[-1] in _TORCH_DRAWS
                    and not _has_generator(node)
                ):
                    _flag(sf, node, f"{fname}() without generator=", violations)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _INPLACE_DRAWS
                    and not _has_generator(node)
                ):
                    _flag(sf, node, f".{node.func.attr}() without generator=", violations)
    return violations
