"""The engine's `reclaim_period` and the engine flags KTPU_RECLAIM,
KTPU_RECLAIM_PERIOD and KTPU_WINDOW_RAZOR, against the JAX package on the
CPU.

Parity policy, as in test_torch_reclaim.py: compare_states (every integer
and time leaf exactly equal, float32 `.metrics.` accumulators to rtol
1e-6, atol 0); the reference on its XLA path with fast_forward=False.

- The wave churn of tests/test_reclaim.py with waves 80 s apart, so a
  scale-up comes within a few windows of the last slot's retirement: at
  reclaim_period 4 the compaction waits for a window with (W + 1) % 4 ==
  0, the reserve runs dry and the CA starves, so the JAX trajectory
  differs from period 1's; the port equals the JAX engine at both.
- Period 1 (the argument, the flag's default) equals the build without the
  argument, leaf for leaf, eager and on the stubbed capture backend.
- A checkpoint records the period; a restore into an engine of another
  period raises, as a reclaim mismatch does, and one of the same period
  runs on to the straight run's end.
- Each flag is read after its argument, and under KTPU_RECLAIM=1,
  KTPU_RECLAIM_PERIOD=4 and KTPU_WINDOW_RAZOR=1 the two packages build
  engines that end in equal states.
"""

import numpy as np
import pytest

from test_reclaim import CLUSTER_TRACE, RECLAIM_CA_SUFFIX, wave_workload
from test_torch_executor import assert_bitwise_equal, stub_graphs
from test_torch_reference import TraceSpec, build_jax_engine, build_port_engine, jax_state_to_numpy

from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.convert import state_to_numpy

CONFIG = DEFAULT_TEST_CONFIG_YAML + RECLAIM_CA_SUFFIX
N_WAVES = 12
SPACING = 80.0
HORIZON = 10.0 + N_WAVES * SPACING + 400.0
TIGHT = TraceSpec(cluster_yaml=CLUSTER_TRACE, workload_yaml=wave_workload(N_WAVES, spacing=SPACING, duration=30.0))
ENV_FLAGS = ("KTPU_RECLAIM", "KTPU_RECLAIM_PERIOD", "KTPU_WINDOW_RAZOR")


@pytest.fixture(autouse=True)
def _no_engine_flags(monkeypatch):
    for name in ENV_FLAGS:
        monkeypatch.delenv(name, raising=False)


def _jax(**kwargs):
    kwargs.setdefault("ca_slot_multiplier", 1)
    kwargs.setdefault("fast_forward", False)
    return build_jax_engine(CONFIG, TIGHT, 1, None, "xla", **kwargs)


def _port(**kwargs):
    kwargs.setdefault("ca_slot_multiplier", 1)
    kwargs.setdefault("fast_forward", False)
    return build_port_engine(CONFIG, TIGHT, 1, None, **kwargs)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for period in (1, 4):
        jx = _jax(reclaim=True, reclaim_period=period)
        jx.step_until_time(HORIZON)
        out[period] = jax_state_to_numpy(jx.state)
    return out


@pytest.mark.parametrize("period", [1, 4])
def test_reclaim_period_matches_reference(jax_runs, period):
    port = _port(reclaim=True, reclaim_period=period)
    assert port.reclaim and port.reclaim_period == period
    port.step_until_time(HORIZON)
    got = state_to_numpy(port.state)
    assert compare_states(jax_runs[period], got) == []
    starved = int(got[".metrics.ca_reserve_starved"].sum())
    # Period 4 holds retired slots back past the next wave's scale-up.
    assert starved == (0 if period == 1 else 3)


def test_period_four_changes_the_reference_trajectory(jax_runs):
    differ = compare_states(jax_runs[1], jax_runs[4])
    assert ".metrics.ca_reserve_starved" in differ and ".metrics.queue_time.total" in differ


def test_period_one_is_the_default_build():
    default = _port(reclaim=True)
    explicit = _port(reclaim=True, reclaim_period=1)
    assert default.reclaim_period == explicit.reclaim_period == 1
    default.step_until_time(HORIZON)
    explicit.step_until_time(HORIZON)
    assert_bitwise_equal(default.state, explicit.state)
    # The reclaim piece's conditional node tests the period too: on the
    # stubbed capture backend the period-4 graphs equal the eager run.
    eager = _port(reclaim=True, reclaim_period=4)
    eager.step_until_time(HORIZON)
    sim = stub_graphs(_port(reclaim=True, reclaim_period=4))
    sim.precompile_pieces()
    sim.step_until_time(HORIZON)
    assert_bitwise_equal(sim.state, eager.state)
    assert sim.dispatch_stats["eager_windows"] == 0
    assert 0 < int(sim.ca_slots_reclaimed().sum()) == int(eager.ca_slots_reclaimed().sum())
    # Clamped to at least 1, as the reference's max(1, period).
    assert _port(reclaim=True, reclaim_period=0).reclaim_period == 1


def test_checkpoint_round_trip_carries_the_period(jax_runs, tmp_path):
    path = str(tmp_path / "ckpt")
    first = _port(reclaim=True, reclaim_period=4)
    first.step_until_time(500.0)
    first.save_checkpoint(path)
    meta = (tmp_path / "ckpt.meta.json").read_text()
    assert '"reclaim": true' in meta and '"reclaim_period": 4' in meta
    with pytest.raises(ValueError, match="reclaim_period mismatch: saved with reclaim_period=4"):
        _port(reclaim=True, reclaim_period=1).load_checkpoint(path)
    resumed = _port(reclaim=True, reclaim_period=4)
    resumed.load_checkpoint(path)
    resumed.step_until_time(HORIZON)
    assert compare_states(jax_runs[4], state_to_numpy(resumed.state)) == []
    # A period-1 save writes no period, and restores into a period-1 build.
    one = _port(reclaim=True)
    one.step_until_time(500.0)
    one.save_checkpoint(path)
    assert "reclaim_period" not in (tmp_path / "ckpt.meta.json").read_text()
    _port(reclaim=True).load_checkpoint(path)


def test_each_engine_flag_is_read_after_its_argument(monkeypatch):
    monkeypatch.setenv("KTPU_RECLAIM", "1")
    monkeypatch.setenv("KTPU_RECLAIM_PERIOD", "4")
    monkeypatch.setenv("KTPU_WINDOW_RAZOR", "1")
    flagged = _port()
    assert (flagged.reclaim, flagged.reclaim_period, flagged.window_razor) == (True, 4, True)
    argued = _port(reclaim=False, reclaim_period=2, window_razor=False)
    assert (argued.reclaim, argued.reclaim_period, argued.window_razor) == (False, 2, False)
    monkeypatch.setenv("KTPU_RECLAIM", "0")
    monkeypatch.setenv("KTPU_WINDOW_RAZOR", "0")
    assert (_port().reclaim, _port().window_razor) == (False, False)
    # The period ranks above a tuned profile's entry where the flag is set,
    # below it where the flag is unset.
    profile = {"statics": {"reclaim_period": 3}}
    assert _port(reclaim=True, tuned_profile=_profile(profile)).reclaim_period == 4
    monkeypatch.delenv("KTPU_RECLAIM_PERIOD")
    assert _port(reclaim=True, tuned_profile=_profile(profile)).reclaim_period == 3
    # An explicit KTPU_RECLAIM=1 raises where names interleave, as
    # reclaim=True does.
    from test_torch_reclaim import BAD_CLUSTER

    monkeypatch.setenv("KTPU_RECLAIM", "1")
    bad = TraceSpec(cluster_yaml=BAD_CLUSTER, workload_yaml=wave_workload(2))
    with pytest.raises(ValueError, match="reclaim=True is unsupported for this build.*name family"):
        build_port_engine(CONFIG, bad, 1, None, ca_slot_multiplier=1, fast_forward=False)


def _profile(doc):
    from kubernetriks_tpu_torch.tune.profile import TunedProfile

    return TunedProfile(
        backend="cpu", n_clusters=1, n_nodes=3, statics=doc["statics"], source="test", explicit=False, doc=doc,
    )


def test_same_environment_builds_equal_engines_in_both_packages(jax_runs, monkeypatch):
    monkeypatch.setenv("KTPU_RECLAIM", "1")
    monkeypatch.setenv("KTPU_RECLAIM_PERIOD", "4")
    monkeypatch.setenv("KTPU_WINDOW_RAZOR", "1")
    jx = _jax()
    port = _port()
    assert (jx.reclaim, jx.reclaim_period, jx.window_razor) == (port.reclaim, port.reclaim_period, True)
    jx.step_until_time(HORIZON)
    port.step_until_time(HORIZON)
    got = state_to_numpy(port.state)
    assert compare_states(jax_state_to_numpy(jx.state), got) == []
    assert compare_states(jax_runs[4], got) == []
    assert np.asarray(got[".auto.ca_reclaimed"]).sum() > 0
