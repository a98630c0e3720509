"""Scheduler profile: the filter mask and score of the decision core.

Own port of the JAX package's `batched/pipeline.py` for the reference
default profile — Fit + LeastAllocatedResources, weight 1.0 — written op
for op as its `_filter_fit` / `_score_least_allocated` / `profile_score`
(pipeline.py:97-117,261-285). The CUDA megakernel
(ops/csrc/select_cycle_commit.cu) inlines the same expressions in the same
order. Any other profile raises UnsupportedProfileError at engine build,
the one place a profile is checked; the step and kernel layers compute
this profile only. The other scorers arrive with ROADMAP Queue 1 item 6.

Semantics: the filter ANDs onto the alive mask; scores are float32;
zero-allocatable and non-fitting nodes score -inf, so they never win the
last-max-wins argmax (ties go to the highest node slot).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

FIT = "Fit"
LEAST_ALLOCATED = "LeastAllocatedResources"


class UnsupportedProfileError(ValueError):
    """A profile this port cannot run yet. Raised at engine build, never
    silently replaced by the default."""


class CompiledProfile(NamedTuple):
    name: str
    filters: Tuple[str, ...]
    scores: Tuple[Tuple[str, float], ...]


DEFAULT_PROFILE = CompiledProfile(
    name="default",
    filters=(FIT,),
    scores=((LEAST_ALLOCATED, 1.0),),
)


def compile_profile(spec=None) -> CompiledProfile:
    """None, "default" or DEFAULT_PROFILE -> DEFAULT_PROFILE; anything
    else raises UnsupportedProfileError."""
    if spec is None or spec == "default" or spec == DEFAULT_PROFILE:
        return DEFAULT_PROFILE
    raise UnsupportedProfileError(
        f"scheduler profile {spec!r}: kubernetriks_tpu_torch runs only the "
        f"default profile (Fit + LeastAllocatedResources) so far; the other "
        f"profiles are ROADMAP Queue 1 item 6"
    )


def _score_least_allocated(cpu, ram, rc, rr):
    neg_inf = float("-inf")
    cpu_f = cpu.to(torch.float32)
    ram_f = ram.to(torch.float32)
    cpu_score = torch.where(
        cpu > 0, (cpu_f - rc.to(torch.float32)) * 100.0 / cpu_f, neg_inf
    )
    ram_score = torch.where(
        ram > 0, (ram_f - rr.to(torch.float32)) * 100.0 / ram_f, neg_inf
    )
    return (cpu_score + ram_score) * 0.5


def profile_fit_score(alive, cpu, ram, rc, rr):
    """The default profile's (fit mask, masked float32 score) over
    broadcast-compatible node allocatables `cpu`/`ram` and candidate
    requests `rc`/`rr`."""
    fit = alive & (rc <= cpu) & (rr <= ram)
    score = torch.where(fit, _score_least_allocated(cpu, ram, rc, rr), float("-inf"))
    return fit, score
