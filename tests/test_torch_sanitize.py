"""The port's runtime sanitizer (kubernetriks_tpu_torch/sanitize.py,
KTPU_SANITIZE) and the finite sweep (KTPU_DEBUG_FINITE) on the CPU,
against the JAX package where it has a counterpart
(tests/test_sanitize.py).

- A sanitized composed run (the HPA, the CA, pod faults) equals the
  unsanitized run bit for bit, with the same host reads, and equals the
  JAX engine's XLA path under compare_states (tests/test_sanitize.py:31).
- An unwaived read inside the guard raises through the thread-local
  depth, in the engine's stepping loop too; the same read in an
  allow_transfer scope passes (:69).
- The finite sweep names a planted NaN (:114), under KTPU_SANITIZE and
  under KTPU_DEBUG_FINITE alone.
- The captured-address check names a state leaf rebound behind the
  window executor's back (the counterpart of consume_donated, :92), and a
  rebinding the executor followed (a rebuild) passes.
"""

import numpy as np
import pytest
import torch

from test_torch_autoscale import TOY
from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy

from bench import FAULTS_YAML
from kubernetriks_tpu_torch import sanitize
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.convert import state_to_numpy

CONFIG = TOY.config_yaml + FAULTS_YAML
KW = dict(reclaim=False, fast_forward=False)
ENDS = (150.0, 300.0, 450.0)


def _port(sanitize_mode, **kwargs):
    return build_port_engine(CONFIG, TOY, 2, 8, sanitize_mode=sanitize_mode, **{**KW, **kwargs})


def _run(sim):
    for end in ENDS:
        sim.step_until_time(end)
    return sim


def test_sanitized_composed_run_is_bit_identical_and_matches_reference():
    sane = _run(_port(True))
    plain = _run(_port(False))
    assert sane._sanitize and not plain._sanitize
    assert sane.autoscale_statics is not None and sane.fault_params is not None
    assert compare_states(state_to_numpy(sane.state), state_to_numpy(plain.state)) == []
    for a, b in zip(state_to_numpy(sane.state).values(), state_to_numpy(plain.state).values()):
        assert a.tobytes() == b.tobytes()
    assert sane.host_syncs == plain.host_syncs
    assert sane.dispatch_stats == plain.dispatch_stats
    counters = sane.metrics_summary()["counters"]
    assert counters["pod_restarts"] + counters["pods_failed"] + counters["pod_interruptions"] > 0
    assert counters["total_scaled_up_pods"] > 0 and counters["total_scaled_up_nodes"] > 0
    jx = build_jax_engine(CONFIG, TOY, 2, 8, "xla", **KW)
    for end in ENDS:
        jx.step_until_time(end)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(sane.state)) == []


def test_sanitized_sliding_run_counts_its_reads_in_allow_scopes():
    """Through a sliding pod window with fast-forward, every read the
    loop makes (slides, next windows, run_to_completion's) sits in an
    allow scope: the run completes, equal to the unsanitized one."""
    runs = []
    for mode in (True, False):
        sim = _port(mode, pod_window=8, fast_forward=True)
        sim.run_to_completion(max_time=5000.0)
        runs.append(sim)
    sane, plain = runs
    assert sane.dispatch_stats["slides"] > 0 and sane.dispatch_stats["skipped_windows"] > 0
    assert sane.host_syncs == plain.host_syncs
    assert compare_states(state_to_numpy(sane.state), state_to_numpy(plain.state)) == []


def test_guard_raises_on_an_unwaived_read():
    x = torch.arange(8)
    with pytest.raises(RuntimeError, match="unwaived device-to-host"):
        with sanitize.guard(True, "cpu"):
            sanitize.to_host(x + 1)
    with sanitize.guard(True, "cpu"):
        with sanitize.allow_transfer(True, "test readback"):
            got = sanitize.to_host(x + 1)
        with sanitize.guard(True, "cpu"):  # nesting keeps the depth
            with pytest.raises(RuntimeError, match="unwaived"):
                sanitize.to_host(x)
    np.testing.assert_array_equal(got, np.arange(1, 9))
    with sanitize.guard(False):
        sanitize.to_host(x + 2)
    sanitize.to_host(x)  # the depth unwound after the raises
    with pytest.raises(ValueError, match="reason"):
        sanitize.allow_transfer(True, "")


def test_an_unwaived_read_in_the_stepping_loop_raises():
    """A read added to the loop without an allow scope (here through the
    engine's window plan) raises under the sanitizer, not without it."""
    for mode in (True, False):
        sim = _port(mode)
        plan = sim._plan

        def reading_plan(w, freeze=True, _plan=plan, _sim=sim):
            sanitize.to_host(_sim.state.time)
            return _plan(w, freeze)

        sim._plan = reading_plan
        if mode:
            with pytest.raises(RuntimeError, match="unwaived device-to-host"):
                sim.step_until_time(50.0)
        else:
            sim.step_until_time(50.0)


def _plant_nan(sim) -> str:
    from kubernetriks_tpu_torch.batched.state import flatten

    for path, leaf in flatten(sim.state).items():
        if leaf.is_floating_point() and leaf.numel() and bool(torch.isfinite(leaf).all()):
            leaf.view(-1)[0] = float("nan")
            return path
    raise AssertionError("no finite float leaf to poison")


def test_finite_sweep_names_a_planted_nan(monkeypatch):
    sim = _port(True)
    assert not sim._debug_finite  # the sweep is on through the sanitizer alone
    sim.step_until_time(50.0)
    path = _plant_nan(sim)
    with pytest.raises(FloatingPointError, match=f"NaN in state field {path}"):
        sim._check_finite()
    monkeypatch.setenv("KTPU_DEBUG_FINITE", "1")
    flagged = _port(False)
    assert flagged._debug_finite and not flagged._sanitize
    flagged.step_until_time(50.0)
    path = _plant_nan(flagged)
    with pytest.raises(FloatingPointError, match=path):
        flagged.step_until_time(100.0)
    monkeypatch.setenv("KTPU_DEBUG_FINITE", "0")
    off = _port(False)
    off.step_until_time(50.0)
    _plant_nan(off)
    off._check_finite()  # off: no sweep


def test_address_check_names_a_rebound_leaf():
    sim = _port(True)
    sim.step_until_time(50.0)
    sim._state = sim._state._replace(time=sim._state.time.clone())
    with pytest.raises(RuntimeError, match=r"state leaf \.time is not the buffer"):
        sim.step_until_time(100.0)
    # A rebinding the executor followed (its buffers bound anew) passes.
    fresh = _port(True)
    fresh.step_until_time(50.0)
    fresh._state = fresh._state._replace(time=fresh._state.time.clone())
    fresh._executor._bind_buffers()
    fresh.step_until_time(100.0)
    assert sanitize.check_addresses(fresh.state, fresh._executor.addresses) > 0
    assert sanitize.check_addresses(fresh.state, None) == 0


def test_flag_default(monkeypatch):
    monkeypatch.setenv("KTPU_SANITIZE", "1")
    assert sanitize.sanitize_default() and _port(None)._sanitize
    monkeypatch.setenv("KTPU_SANITIZE", "0")
    assert not sanitize.sanitize_default() and not _port(None)._sanitize
    assert _port(True)._sanitize
