"""Scheduler profiles in the port (kubernetriks_tpu_torch/batched/
pipeline.py and the cycle kernels' plain versions) on the CPU, against the
JAX package.

- (a) The scorers and the profiles' (fit, score): each scorer, each named
  profile and two custom ones, bit for bit against
  `kubernetriks_tpu.batched.pipeline` run by XLA:CPU, on seeded operands
  with zero allocatables, exact score ties, requests that fit nowhere and
  requests above capacity; fma_f32 (the balanced scorer's contracted
  multiply-add, which XLA:CPU emits) against exact rational arithmetic on
  operands at double-rounding ties.
- (b) compile_profile accepts and refuses exactly what the reference's
  does (the same forms, the same compiled plugins and weights, the same
  error kinds), and never falls back to the default.
- (c) The three profiled cycle kernels' plain versions against the Pallas
  kernels run in interpret mode with the same profile: the megakernel
  (fused_select_cycle_commit), the candidate cycle (fused_schedule_cycle)
  and the selecting cycle (fused_select_schedule_cycle).
- (d) Profiled runs: default, best_fit, balanced_packing and the custom
  {filters: [Fit], score: [{name: BalancedResourceAllocation, weight:
  2.0}]} profile, each on the sorted, megakernel and two-kernel routes,
  equal to the JAX engine's XLA path (its lax.scan cycle) under
  compare_states (every leaf exact; float32 metric accumulators within
  rtol 1e-6), on tests/test_random_equivalence.py's random trace (node
  and pod removals); a non-default profile's run differs from the
  default's.
- (e) KTPU_PROFILE is read after the argument and the config's block, as
  the reference reads it: under the flag the port equals the JAX engine
  built under the same environment.
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from test_torch_cuda import cycle_inputs, megakernel_inputs, t as _t
from test_torch_chaos import RandomTraceSpec
from test_torch_kernels import _assert_outputs, _per_cluster
from test_torch_reference import build_jax_engine, build_port_engine, jax_kernels, jax_state_to_numpy

from kubernetriks_tpu.batched import pipeline as jax_pipeline
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu_torch.batched import pipeline
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.batched.timerep import fma_f32
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.ops import scheduler_kernel as port_kernels

CUSTOM = {"filters": ["Fit"], "score": [{"name": "BalancedResourceAllocation", "weight": 2.0}]}
PROFILES = {"default": "default", "best_fit": "best_fit", "balanced_packing": "balanced_packing", "custom": CUSTOM}
# Custom profiles whose weighted sums XLA:CPU leaves uncontracted (see
# ROADMAP Queue 3: a sum of two products whose weights are not powers of
# two can contract into a fused multiply-add there).
EXTRA = {
    "no_filter": {"filters": [], "score": ["LeastAllocatedResources", {"name": "MostAllocatedResources"}]},
    "scoreless": {"filters": ["Fit"], "score": []},
    "most_then_balanced_0.3": {
        "filters": ["Fit"],
        "score": [{"name": "MostAllocatedResources"}, {"name": "BalancedResourceAllocation", "weight": 0.3}],
    },
}


def _operands(seed, n=60000):
    rng = np.random.default_rng(seed)
    cpu = rng.choice([0, 1000, 4000, 8000, 16000, 64000], n).astype(np.int32)
    ram = rng.choice([0, 1024, 4096, 8192, 16384, 131072], n).astype(np.int32)
    rnd = rng.random(n) < 0.5
    cpu[rnd] = rng.integers(0, 70000, rnd.sum())
    ram[rnd] = rng.integers(0, 140000, rnd.sum())
    rc = rng.choice([0, 500, 1000, 4000, 12000, 70000], n).astype(np.int32)
    rr = rng.choice([0, 256, 1024, 8192, 12288, 150000], n).astype(np.int32)
    alive = rng.random(n) < 0.9
    return alive, cpu, ram, rc, rr


@pytest.mark.parametrize("seed", [0, 1])
def test_scorers_match_the_reference_bit_for_bit(seed):
    alive, cpu, ram, rc, rr = _operands(seed)
    for name, fn in jax_pipeline.DEVICE_SCORE_PLUGINS.items():
        want = np.asarray(jax.jit(fn)(cpu, ram, rc, rr))
        got = pipeline.DEVICE_SCORE_PLUGINS[name](*(torch.from_numpy(a) for a in (cpu, ram, rc, rr))).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    for name, spec in {**PROFILES, **EXTRA}.items():
        jp, pp = jax_pipeline.compile_profile(spec), pipeline.compile_profile(spec)
        want = [np.asarray(x) for x in jax.jit(lambda *a: jax_pipeline.profile_fit_score(jp, *a))(alive, cpu, ram, rc, rr)]
        got = [x.numpy() for x in pipeline.profile_fit_score(pp, *(torch.from_numpy(a) for a in (alive, cpu, ram, rc, rr)))]
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32), err_msg=name)
        # Ties: some rows share a finite score with another row.
        finite = want[1][np.isfinite(want[1])]
        assert len(np.unique(finite)) < len(finite), name


def test_fma_f32_rounds_once():
    """fma_f32 equals a * b + c computed exactly and rounded once to
    float32 (round to nearest even), on random operands and on operands
    whose float64 sum lands on a float32 halfway point."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    # c + a * b at a float32 halfway point: exactly (ties to even), and
    # 2^-60 below it, where rounding to float64 first would make the tie.
    a[:2] = [2.0**-12, 2.0**-12 * (1 + 2.0**-18)]
    b[:2] = [2.0**-12, 2.0**-12 * (1 - 2.0**-18)]
    c[:2] = [1.0, 1 + 2.0**-23]
    got = fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()

    def exact(x, y, z):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(v))  # nearest double, then the float32 neighbours around it
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - v), int(np.array(f).view(np.int32)) & 1))
        return best

    want = np.array([exact(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == np.float32(1.0) and got[1] == np.float32(1 + 2.0**-23)


SPECS = [
    None, "default", "best_fit", "balanced_packing", "best-fit", 3, ["Fit"],
    {"filters": ["Fit"]}, {"filters": None, "score": ["MostAllocatedResources"]},
    {"filters": [], "score": []}, {"scores": []}, {"filters": ["Fit"], "score": [{"name": "Fit", "wieght": 1}]},
    {"filters": ["NodeAffinity"]}, {"score": ["NodeAffinity"]},
    {"score": [{"name": "LeastAllocatedResources", "weight": 0.0}]},
    {"score": [{"name": "LeastAllocatedResources", "weight": -1.0}]},
    {"score": [{"name": "LeastAllocatedResources", "weight": float("inf")}]},
    {"score": [{"name": "LeastAllocatedResources", "weight": float("nan")}]},
    CUSTOM,
]


def _outcome(fn, spec):
    try:
        prof = fn(spec)
    except Exception as e:  # noqa: BLE001 - the kind is what is compared
        kind = "unsupported" if type(e).__name__ == "UnsupportedProfileError" else type(e).__name__
        return ("raises", kind)
    return ("ok", prof.name, tuple(prof.filters), tuple((n, w) for n, w in prof.scores))


@pytest.mark.parametrize("spec", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_compile_profile_accepts_and_refuses_as_the_reference(spec):
    want = _outcome(jax_pipeline.compile_profile, spec)
    got = _outcome(pipeline.compile_profile, spec)
    assert got == want
    if got[0] == "ok":
        again = pipeline.compile_profile(pipeline.compile_profile(spec))
        assert again == pipeline.compile_profile(spec)


def test_compiled_profile_is_checked_again():
    bad = pipeline.CompiledProfile(name="hand", filters=("Fit",), scores=(("Spread", 1.0),))
    with pytest.raises(pipeline.UnsupportedProfileError, match="Spread"):
        pipeline.compile_profile(bad)


@pytest.mark.parametrize("name", [*PROFILES, *EXTRA])
def test_profile_terms_encode_the_profile(name):
    """The cycle kernels' launch arguments (profile_terms) decode to the
    reference's compiled profile: the default's own instantiation, else
    the Fit filter's kind and, per scorer in order, its id, float32 weight
    and whether to multiply."""
    spec = PROFILES.get(name) or EXTRA[name]
    want = jax_pipeline.compile_profile(spec)
    table, kind, n_terms = port_kernels.profile_terms(pipeline.compile_profile(spec), torch.device("cpu"))
    if name == "default":
        assert (table, kind, n_terms) == (None, 0, 0)
        return
    assert kind == (1 if "Fit" in want.filters else 2)
    assert n_terms == len(want.scores)
    ids = {v: k for k, v in pipeline.KERNEL_SCORER_IDS.items()}
    rows = table.numpy()[: 3 * n_terms].reshape(n_terms, 3)
    got = [(ids[int(i)], float(np.int32(bits).view(np.float32)), bool(mul)) for i, bits, mul in rows]
    assert got == [(s, float(np.float32(w)), w != 1.0) for s, w in want.scores]


def _both(spec):
    return jax_pipeline.compile_profile(spec), pipeline.compile_profile(spec)


@pytest.mark.parametrize("name", ["best_fit", "balanced_packing", "custom"])
@pytest.mark.parametrize("seed", [0, 1])
def test_profiled_megakernel_matches_pallas(name, seed):
    jp, pp = _both(PROFILES[name])
    for edges in (False, True):
        args, K = megakernel_inputs(seed, C=8, edges=edges)
        if edges:
            args = tuple(a[1:] for a in args)  # lane 0's whole-key ties: see test_torch_kernels.py
        want = jax_kernels.fused_select_cycle_commit(*args, k_pods=K, interpret=True, profile=jp)
        got = port_kernels.fused_select_cycle_commit(*(_t(a) for a in args), k_pods=K, profile=pp)
        _assert_outputs(got, want, stats_idx=6)


@pytest.mark.parametrize("name", ["best_fit", "balanced_packing", "custom"])
@pytest.mark.parametrize("seed", [0, 1])
def test_profiled_schedule_cycle_matches_pallas(name, seed):
    jp, pp = _both(PROFILES[name])
    for edges in (False, True):
        args = cycle_inputs(seed, edges=edges)
        got = port_kernels.fused_schedule_cycle(*(_t(a) for a in args), profile=pp)
        _assert_outputs(got, _per_cluster(jax_kernels.fused_schedule_cycle, args, interpret=True, profile=jp))


@pytest.mark.parametrize("name", ["best_fit", "balanced_packing", "custom"])
@pytest.mark.parametrize("seed", [0, 1])
def test_profiled_select_schedule_cycle_matches_pallas(name, seed):
    jp, pp = _both(PROFILES[name])
    margs, K = megakernel_inputs(seed)
    args = margs[:9]
    got = port_kernels.fused_select_schedule_cycle(*(_t(a) for a in args), k_pods=K, profile=pp)
    want = _per_cluster(jax_kernels.fused_select_schedule_cycle, args, k_pods=K, interpret=True, profile=jp)
    _assert_outputs(got, want)


def test_profiles_decide_differently():
    """On the kernels' inputs, best_fit and the default place some
    candidate on different nodes (so the profiled tests are not the
    default's in disguise)."""
    args = cycle_inputs(0)
    best = [
        port_kernels.fused_schedule_cycle(*(_t(a) for a in args), profile=pipeline.compile_profile(p))[2]
        for p in ("default", "best_fit", "balanced_packing")
    ]
    assert not torch.equal(best[0], best[1]) and not torch.equal(best[0], best[2])


SPEC = RandomTraceSpec(101)  # heterogeneous nodes, node and pod removals


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's XLA runs of tests/test_random_equivalence.py's
    random trace (seed 101: 25 nodes of mixed sizes, node and pod
    removals) under each profile, C = 2, K = 16, to t = 2 000 s."""
    out = {}
    for name, spec in PROFILES.items():
        jx = build_jax_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16, "xla", fast_forward=False, scheduler_profile=spec)
        jx.step_until_time(2000.0)
        out[name] = jax_state_to_numpy(jx.state)
    return out


@pytest.mark.parametrize("route", ["sorted", "megakernel", "two_kernel"])
@pytest.mark.parametrize("name", list(PROFILES))
def test_profiled_run_matches_reference(reference_runs, name, route):
    port = build_port_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16, fast_forward=False, scheduler_profile=PROFILES[name])
    port.cycle_route = route
    port.step_until_time(2000.0)
    got = state_to_numpy(port.state)
    assert compare_states(reference_runs[name], got) == []
    assert port.metrics_summary()["counters"]["scheduling_decisions"] > 0
    if name != "default":
        assert compare_states(reference_runs["default"], got) != []


def test_ktpu_profile_flag_is_read_after_the_argument_and_the_config(reference_runs, monkeypatch, tmp_path):
    """KTPU_PROFILE (reference engine.py:759-770, flags.py:191): with no
    argument and no config block the engine runs the flag's profile, equal
    to the JAX engine built under the same environment (and to the
    explicit best_fit run); an explicit scheduler_profile= and the
    config's block still win; an unknown name raises; a checkpoint records
    the profile the flag chose."""
    monkeypatch.setenv("KTPU_PROFILE", "best_fit")
    jx = build_jax_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16, "xla", fast_forward=False)
    jx.step_until_time(2000.0)
    port = build_port_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16, fast_forward=False)
    assert port.profile == pipeline.compile_profile("best_fit")
    port.step_until_time(2000.0)
    got = state_to_numpy(port.state)
    assert compare_states(jax_state_to_numpy(jx.state), got) == []
    assert compare_states(reference_runs["best_fit"], got) == []
    port.save_checkpoint(str(tmp_path / "ckpt"))
    meta = (tmp_path / "ckpt.meta.json").read_text()
    assert '"name": "best_fit"' in meta
    explicit = build_port_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16, scheduler_profile="balanced_packing")
    assert explicit.profile.name == "balanced_packing"
    block = build_port_engine(DEFAULT_TEST_CONFIG_YAML + "scheduler_profile: default\n", SPEC, 2, 16)
    assert block.profile == pipeline.DEFAULT_PROFILE
    monkeypatch.setenv("KTPU_PROFILE", "no_such_profile")
    with pytest.raises(ValueError, match="unknown named scheduler profile 'no_such_profile'"):
        build_port_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16)
    monkeypatch.delenv("KTPU_PROFILE")
    assert build_port_engine(DEFAULT_TEST_CONFIG_YAML, SPEC, 2, 16).profile == pipeline.DEFAULT_PROFILE
