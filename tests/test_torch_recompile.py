"""The port's recompile sentinel (kubernetriks_tpu_torch/recompile.py,
KTPU_EXPLAIN_RECOMPILES) on the CPU, mirroring tests/test_recompile.py:
its events are the window executor's captures, fed through the
executor's hook on the stubbed capture backend (test_torch_executor.py).

- Seal, check, raise: a capture after the seal raises RecompileError
  naming the piece key; replays between seal and capture stay quiet.
- Warn mode and expect_none windows.
- Nesting: every installed sentinel sees every capture; one uninstalled
  sees no more.
- The tristate flag: unset arms nothing, 0 forces off, 1 arms a raising
  sentinel, which a ScenarioFleet seals after its build and arms around
  every wave: a capture forced inside a wave raises, naming the key.
"""

import re

import pytest

from test_torch_executor import DELAYS, CHURN, stub_graphs
from test_torch_fleet import CHAOS_SCENS, CHAOS_YAML, FLEET_KW, composed_events
from test_torch_reference import build_port_engine

from kubernetriks_tpu_torch import recompile
from kubernetriks_tpu_torch.batched.fleet import Scenario, ScenarioFleet
from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.recompile import (
    RecompileError,
    RecompileSentinel,
    RecompileWarning,
    maybe_sentinel,
    sentinel_mode,
)


def _stubbed():
    return stub_graphs(build_port_engine(DELAYS, CHURN, 4, 8))


def _drop_end_graphs(sim):
    """Forget every captured end piece, so the next window captures its
    own again."""
    keys = [k for k in sim._executor.graphs if k[0] == "end"]
    for key in keys:
        del sim._executor.graphs[key]
    return keys


def test_capture_after_the_seal_raises_naming_the_piece_key():
    sim = _stubbed()
    sent = RecompileSentinel("raise").install()
    try:
        captured = sim.precompile_pieces()
        assert captured > 0 and len(sent.events) == captured
        assert set(sent.events) == set(sim._executor.graphs)
        sent.seal("build")
        sim.step_until_time(150.0)  # replays only
        sent.check("steady state")
        assert sent.post_seal_events() == []
        keys = _drop_end_graphs(sim)
        sim.step_until_time(600.0)
        again = sent.post_seal_events()
        assert again and set(again) <= set(keys)
        with pytest.raises(RecompileError, match=re.escape(repr(again[0]))):
            sent.check("forced recapture")
        sent.check("after the report")  # re-sealed: reported once
    finally:
        sent.uninstall()


def test_warn_mode_and_expect_none_windows():
    sim = _stubbed()
    sim.precompile_pieces()
    sent = RecompileSentinel("warn").install()
    try:
        with sent.expect_none("replay window"):
            sim.step_until_time(150.0)
        keys = _drop_end_graphs(sim)
        with pytest.warns(RecompileWarning, match="'end'"):
            with sent.expect_none("drift window"):
                sim.step_until_time(600.0)
        assert set(sent.events) & set(keys)
    finally:
        sent.uninstall()
    with pytest.raises(ValueError):
        RecompileSentinel("shout")


def test_nesting_and_uninstall():
    outer = RecompileSentinel().install()
    inner = RecompileSentinel().install()
    recompile.publish_capture(("chunk",))
    inner.uninstall()
    inner.uninstall()  # idempotent
    recompile.publish_capture(("next",))
    outer.uninstall()
    recompile.publish_capture(("catch_up",))
    assert outer.events == [("chunk",), ("next",)]
    assert inner.events == [("chunk",)]
    with RecompileSentinel() as scoped:
        recompile.publish_capture(("slide", 8, 24, 0))
    assert scoped.events == [("slide", 8, 24, 0)] and not recompile._SENTINELS


def test_flag_wiring(monkeypatch):
    monkeypatch.delenv("KTPU_EXPLAIN_RECOMPILES", raising=False)
    assert sentinel_mode() is None and maybe_sentinel() is None
    monkeypatch.setenv("KTPU_EXPLAIN_RECOMPILES", "0")
    assert sentinel_mode() is False and maybe_sentinel() is None
    monkeypatch.setenv("KTPU_EXPLAIN_RECOMPILES", "1")
    assert sentinel_mode() is True
    sent = maybe_sentinel()
    assert sent is not None and sent.mode == "raise"
    sent.uninstall()


def test_fleet_under_the_flag_raises_on_a_forced_recapture(monkeypatch):
    """A fleet built under KTPU_EXPLAIN_RECOMPILES=1 is sealed after its
    build: waves that replay pass; a piece captured inside a wave raises,
    naming its key, out of run()."""
    from kubernetriks_tpu_torch.batched import engine as engine_mod

    real = engine_mod.BatchedSimulation.precompile_pieces

    def stubbed(sim):
        if sim._executor.backend is None:
            stub_graphs(sim)
        return real(sim)

    monkeypatch.setattr(engine_mod.BatchedSimulation, "precompile_pieces", stubbed)
    monkeypatch.setenv("KTPU_EXPLAIN_RECOMPILES", "1")
    f = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu",
                      **{**FLEET_KW, "horizon": 120.0})
    try:
        assert f._sentinel is not None and f._sentinel.post_seal_events() == []
        f.sweep([Scenario(**s) for s in CHAOS_SCENS])
        assert f.waves_run == 2 and f._sentinel.post_seal_events() == []
        keys = _drop_end_graphs(f.engine)
        f.submit(Scenario(**CHAOS_SCENS[0]))
        with pytest.raises(RecompileError, match="fleet wave 3.*'end'"):
            f.run()
        again = f._sentinel.post_seal_events()
        assert again and set(again) <= set(keys)
    finally:
        f.close()
    assert f._sentinel is None and not recompile._SENTINELS


def test_lane_async_pump_rounds_under_the_flag(monkeypatch):
    """The lane-asynchronous fleet's pump rounds under the sealed
    sentinel: rounds that replay pass; a piece captured inside a round
    raises naming its key; a RecompileError out of a dispatch leaves the
    fault domain (no lane is failed or quarantined for it)."""
    from kubernetriks_tpu_torch.batched import engine as engine_mod

    real = engine_mod.BatchedSimulation.precompile_pieces

    def stubbed(sim):
        if sim._executor.backend is None:
            stub_graphs(sim)
        return real(sim)

    monkeypatch.setattr(engine_mod.BatchedSimulation, "precompile_pieces", stubbed)
    monkeypatch.setenv("KTPU_EXPLAIN_RECOMPILES", "1")
    f = ScenarioFleet(SimulationConfig.from_yaml(CHAOS_YAML), *composed_events("port"), device="cpu",
                      lane_async=True, **{**FLEET_KW, "horizon": 120.0})
    try:
        for s in CHAOS_SCENS:
            f.submit(Scenario(**s))
        f.run_async(span_windows=4)
        assert f.pump_rounds > 0 and f._sentinel.post_seal_events() == []
        keys = _drop_end_graphs(f.engine)
        f.submit(Scenario(**CHAOS_SCENS[0]))
        with pytest.raises(RecompileError, match="fleet pump round.*'end'"):
            f.pump(4)
        assert set(f._sentinel.post_seal_events()) <= set(keys)

        def broken(n_windows):
            raise RecompileError("a capture inside the dispatch")

        monkeypatch.setattr(f, "_dispatch", broken)
        with pytest.raises(RecompileError, match="inside the dispatch"):
            f.pump(4)
        assert not f.failed_queries and f.quarantine_events == 0
    finally:
        monkeypatch.undo()
        f.close(drain=False)
