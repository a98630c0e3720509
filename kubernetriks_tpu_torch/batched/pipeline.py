"""Compiled scheduler profiles: the filter mask and score of the decision core.

Own port of the JAX package's `batched/pipeline.py`. A profile is None, a
named string (default, best_fit, balanced_packing), an explicit
`{filters, score}` mapping, a KubeSchedulerConfig or a CompiledProfile;
every spec goes through the scalar scheduler's one parser
(`core/scheduler/kube_scheduler.py` `kube_scheduler_config_from_spec`,
`NAMED_PROFILE_SPECS`), so a profile means the same on both backends, and
`to_kube_scheduler_config` gives the scalar KubeScheduler a compiled one.

`compile_profile` checks every plugin against the device registry below,
once, at engine build, and raises UnsupportedProfileError on what the
batched path cannot run; it never falls back to the default. The profile
then reaches every cycle: the plain versions call `profile_fit_score`, and
the three CUDA cycle kernels (ops/csrc/cycle_common.cuh) take it as a
build-time profile: the default keeps its own instantiation, any other
profile runs the general term list (`kernel_terms`).

Semantics, op for op as the reference's (pipeline.py:97-285):
- filters AND into the alive mask;
- scores are float32, summed over the scorers in the profile's order
  after weighting; a weight of exactly 1.0 skips the multiply, so the
  default profile's expression tree is the one the port always ran;
- zero-allocatable and non-fitting nodes score -inf, so they never win the
  last-max-wins argmax (ties go to the highest node slot); a scoreless
  profile scores 0.0 on the fit set.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from kubernetriks_tpu_torch.batched.timerep import fma_f32
from kubernetriks_tpu_torch.core.scheduler.kube_scheduler import (
    DEFAULT_SCHEDULER_NAME,
    KubeSchedulerConfig,
    kube_scheduler_config_from_spec,
)
from kubernetriks_tpu_torch.core.scheduler.plugins import BALANCED, FIT, LEAST_ALLOCATED, MOST_ALLOCATED


class UnsupportedProfileError(ValueError):
    """A profile naming a plugin the device path cannot run, or a weight it
    cannot honour. Raised at engine build, never silently replaced by the
    default."""


class CompiledProfile(NamedTuple):
    name: str  # "default", a named profile, or "custom"
    filters: Tuple[str, ...]
    scores: Tuple[Tuple[str, float], ...]


def profile_plugins(spec) -> Tuple[Tuple[str, ...], Tuple[Tuple[str, float], ...]]:
    """(filter names, (scorer, weight) pairs) of one profile spec, through
    the scalar scheduler's parser (`kube_scheduler_config_from_spec`):
    ValueError on an unknown name or key, TypeError on another type."""
    kprof = kube_scheduler_config_from_spec(spec).profiles[DEFAULT_SCHEDULER_NAME]
    filters = tuple(p.name for p in kprof.plugins.filter)
    scores = tuple((p.name, float(1.0 if p.weight is None else p.weight)) for p in kprof.plugins.score)
    return filters, scores


# --- device plugin registry ---------------------------------------------------
# Filters: fn(cpu, ram, rc, rr) -> bool mask; scorers: fn(cpu, ram, rc, rr)
# -> float32 score. cpu/ram the nodes' allocatable, rc/rr the candidate's
# requests, broadcast-compatible. Every constant is a float32 tensor of the
# operands' device, so each op is float32 by float32, as in the reference.


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _filter_fit(cpu, ram, rc, rr):
    return (rc <= cpu) & (rr <= ram)


def _score_least_allocated(cpu, ram, rc, rr):
    neg_inf = _f32(float("-inf"), cpu)
    hundred = _f32(100.0, cpu)
    cpu_f = cpu.to(torch.float32)
    ram_f = ram.to(torch.float32)
    cpu_score = torch.where(cpu > 0, (cpu_f - rc.to(torch.float32)) * hundred / cpu_f, neg_inf)
    ram_score = torch.where(ram > 0, (ram_f - rr.to(torch.float32)) * hundred / ram_f, neg_inf)
    return (cpu_score + ram_score) * _f32(0.5, cpu)


def _score_most_allocated(cpu, ram, rc, rr):
    neg_inf = _f32(float("-inf"), cpu)
    hundred = _f32(100.0, cpu)
    cpu_f = cpu.to(torch.float32)
    ram_f = ram.to(torch.float32)
    cpu_score = torch.where(cpu > 0, (rc.to(torch.float32) - cpu_f) * hundred / cpu_f, neg_inf)
    ram_score = torch.where(ram > 0, (rr.to(torch.float32) - ram_f) * hundred / ram_f, neg_inf)
    return (cpu_score + ram_score) * _f32(0.5, cpu)


def _score_balanced(cpu, ram, rc, rr):
    neg_inf = _f32(float("-inf"), cpu)
    hundred = _f32(100.0, cpu)
    one = _f32(1.0, cpu)
    cpu_f = cpu.to(torch.float32)
    ram_f = ram.to(torch.float32)
    ok = (cpu > 0) & (ram > 0)
    # The divisors are guarded: where() evaluates both branches.
    cpu_frac = rc.to(torch.float32) / torch.where(ok, cpu_f, one)
    ram_frac = rr.to(torch.float32) / torch.where(ok, ram_f, one)
    # `hundred - abs(d) * hundred`, which XLA:CPU contracts into one fused
    # multiply-add (the reference's bits on the CPU); the CUDA kernels use
    # __fmaf_rn for it.
    d = torch.abs(cpu_frac - ram_frac)
    return torch.where(ok, fma_f32(-d, hundred.expand_as(d), hundred.expand_as(d)), neg_inf)


DEVICE_FILTER_PLUGINS: Dict[str, Callable] = {
    FIT: _filter_fit,
}

DEVICE_SCORE_PLUGINS: Dict[str, Callable] = {
    LEAST_ALLOCATED: _score_least_allocated,
    MOST_ALLOCATED: _score_most_allocated,
    BALANCED: _score_balanced,
}

# The scorers' ids in the CUDA kernels' term list (cycle_common.cuh
# kScoreLeast / kScoreMost / kScoreBalanced).
KERNEL_SCORER_IDS: Dict[str, int] = {LEAST_ALLOCATED: 0, MOST_ALLOCATED: 1, BALANCED: 2}


DEFAULT_PROFILE = CompiledProfile(
    name="default",
    filters=(FIT,),
    scores=((LEAST_ALLOCATED, 1.0),),
)


def compile_profile(spec=None) -> CompiledProfile:
    """One profile spec (see profile_plugins) or a CompiledProfile (checked
    again: a hand-built one may name unknown plugins) -> CompiledProfile.
    Raises UnsupportedProfileError on a filter or scorer outside the device
    registry and on a weight that is not finite and > 0."""
    if isinstance(spec, CompiledProfile):
        prof = spec
    else:
        name = spec if isinstance(spec, str) else None
        filters, scores = profile_plugins(spec)
        prof = CompiledProfile(name=name or ("default" if spec is None else "custom"), filters=filters,
                               scores=scores)
    supported = (
        f"the batched path supports filters {sorted(DEVICE_FILTER_PLUGINS)} and scorers "
        f"{sorted(DEVICE_SCORE_PLUGINS)} (kubernetriks_tpu_torch/batched/pipeline.py)"
    )
    for fname in prof.filters:
        if fname not in DEVICE_FILTER_PLUGINS:
            raise UnsupportedProfileError(
                f"scheduler profile {prof.name!r}: filter plugin {fname!r} has no device lowering; {supported}"
            )
    for sname, weight in prof.scores:
        if sname not in DEVICE_SCORE_PLUGINS:
            raise UnsupportedProfileError(
                f"scheduler profile {prof.name!r}: score plugin {sname!r} has no device lowering; {supported}"
            )
        if not (weight > 0.0) or not math.isfinite(weight):
            # A zero, negative or non-finite weight would turn the -inf of
            # zero-allocatable nodes into a winning score.
            raise UnsupportedProfileError(
                f"scheduler profile {prof.name!r}: score plugin {sname!r} has weight "
                f"{weight!r}; the device lowering requires a finite weight > 0"
            )
    return prof


def to_kube_scheduler_config(profile: CompiledProfile) -> KubeSchedulerConfig:
    """The KubeSchedulerConfig that makes the scalar KubeScheduler run the
    same profile as `profile` (reference pipeline.py:235)."""
    return kube_scheduler_config_from_spec(
        {"filters": list(profile.filters), "score": [{"name": n, "weight": w} for n, w in profile.scores]}
    )


def is_default_kernel_profile(profile: CompiledProfile) -> bool:
    """Whether the CUDA cycle kernels run `profile` through the default
    profile's own instantiation (its filters and scores are the default's;
    the name does not matter)."""
    return profile.filters == DEFAULT_PROFILE.filters and profile.scores == DEFAULT_PROFILE.scores


def kernel_terms(profile: CompiledProfile):
    """(use_fit, terms) of the general instantiation of the cycle kernels:
    whether the Fit filter applies (every filter of a compiled profile is
    Fit), and per scorer in the profile's order (kernel scorer id, float32
    weight bits, whether to multiply: weight != 1.0)."""
    import numpy as np

    terms = []
    for sname, weight in profile.scores:
        bits = int(np.array(weight, dtype=np.float32).view(np.int32))
        terms.append((KERNEL_SCORER_IDS[sname], bits, int(weight != 1.0)))
    return FIT in profile.filters, terms


# --- compiled expressions -----------------------------------------------------


def profile_fit_mask(profile: CompiledProfile, alive, cpu, ram, rc, rr):
    """The profile's filter chain ANDed onto the alive mask."""
    fit = alive
    for fname in profile.filters:
        fit = fit & DEVICE_FILTER_PLUGINS[fname](cpu, ram, rc, rr)
    return fit


def profile_score(profile: CompiledProfile, fit, cpu, ram, rc, rr):
    """The profile's weighted score sum, -inf off the fit set."""
    neg_inf = _f32(float("-inf"), cpu)
    total = None
    for sname, weight in profile.scores:
        s = DEVICE_SCORE_PLUGINS[sname](cpu, ram, rc, rr)
        if weight != 1.0:
            s = s * _f32(weight, cpu)
        total = s if total is None else total + s
    if total is None:
        return torch.where(fit, _f32(0.0, cpu), neg_inf)
    return torch.where(fit, total, neg_inf)


def profile_fit_score(profile: CompiledProfile, alive, cpu, ram, rc, rr):
    """(fit mask, masked float32 score) of `profile` over broadcast-
    compatible node allocatables `cpu`/`ram` and candidate requests
    `rc`/`rr`."""
    fit = profile_fit_mask(profile, alive, cpu, ram, rc, rr)
    return fit, profile_score(profile, fit, cpu, ram, rc, rr)


def bestfit_logits_from_obs(obs: torch.Tensor) -> torch.Tensor:
    """The MostAllocatedResources scorer on the RL observation channels
    (rl/env.featurize: alloc and request fractions of node capacity;
    reference pipeline.py:288). The scorer is scale-invariant per
    resource, so the fractions rank nodes as the raw allocatables do: the
    learning proof's best-fit baseline (rl/evaluate.bestfit_policy_apply)
    and the "best_fit" profile share this one scorer."""
    return DEVICE_SCORE_PLUGINS[MOST_ALLOCATED](obs[..., 2], obs[..., 3], obs[..., 4], obs[..., 5])
