"""Checkpoint and resume of the port (kubernetriks_tpu_torch/checkpoint.py and
BatchedSimulation.save_checkpoint / load_checkpoint) on the CPU, against
the JAX package.

- (a) A mid-run save, a restore into a fresh engine and the continuation
  equal the uninterrupted port run and the JAX engine's uninterrupted run
  under compare_states (every leaf exact, float32 estimators within rtol
  1e-6): the composed line with bench.py's FAULTS_YAML through pod_window=32
  (slides and a growth), explicit reclaim=True, telemetry and best_fit; the
  same line streamed (stream=True), saved while the feeder holds a live
  slab (reference tests/test_streaming.py:181); a save after growths of the
  pod window (reference tests/test_pod_window_growth.py:146).
- (b) The telemetry ring re-drained after a restore: the tail the restored
  ring holds, bit for bit (reference tests/test_telemetry.py:187-219).
- (c) The file format: overwrite, structure mismatch naming the leaves,
  missing path, the .old aside after a crashed swap, a plain dict round
  trip, torch.load(weights_only=True) (mirrors
  tests/test_checkpoint_roundtrip.py).
- (d) The guards: scheduler profile, telemetry ring (both ways), reclaim
  (explicit raises, the default follows with a RuntimeWarning; reference
  tests/test_reclaim.py:230-283).
- (e) The gauge sidecar.

The JAX side runs with fast_forward=False, as the port does here.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_autoscale import TOY
from test_torch_reference import build_jax_engine, build_port_engine, jax_state_to_numpy

from bench import FAULTS_YAML
from chip_smoke import composed_sim
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.checkpoint import ckpt_restore, ckpt_save, flatten_tree
from kubernetriks_tpu_torch.convert import state_to_numpy

END = 600.0
MID = 300.0
# pod_window=32: the reference recompiles its window programs at each
# growth, and 32 keeps it to one (the file's time on the CPU).
COMPOSED = dict(pod_window=32, reclaim=True, telemetry=True, telemetry_ring=16, watchdog=False,
                scheduler_profile="best_fit", fast_forward=False)


def _composed(**overrides):
    return build_port_engine(TOY.config_yaml + FAULTS_YAML, TOY, 4, 8, **{**COMPOSED, **overrides})


@pytest.fixture(scope="module")
def composed_runs(tmp_path_factory):
    """The composed line straight to END (JAX and port) and resumed from a
    save at MID; the save's path."""
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt")
    jx = build_jax_engine(TOY.config_yaml + FAULTS_YAML, TOY, 4, 8, "xla", **COMPOSED)
    jx.step_until_time(END)
    straight = _composed()
    straight.step_until_time(END)
    first = _composed()
    first.step_until_time(MID)
    first.save_checkpoint(path)
    resumed = _composed()
    resumed.load_checkpoint(path)
    resumed.step_until_time(END)
    return jx, straight, first, resumed, path


def test_composed_midrun_restore_equals_straight_and_reference(composed_runs):
    jx, straight, first, resumed, path = composed_runs
    assert compare_states(state_to_numpy(straight.state), state_to_numpy(resumed.state)) == []
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(resumed.state)) == []
    counters = resumed.metrics_summary()["counters"]
    assert counters == straight.metrics_summary()["counters"]
    # The port adds the slots reclaimed to the counters when reclaim runs.
    assert {k: v for k, v in counters.items() if k != "ca_slots_reclaimed"} == jx.metrics_summary()["counters"]
    assert counters["node_crashes"] > 0 and counters["pod_restarts"] > 0 and counters["total_scaled_up_pods"] > 0
    assert resumed.reclaim and resumed.profile.name == "best_fit"
    assert straight.dispatch_stats["slides"] > 0 and straight.dispatch_stats["grows"] > 0
    assert resumed.pod_window == straight.pod_window == jx.pod_window
    # Atomic: no temporary or aside file stays behind; the meta records the build facts.
    names = set(os.listdir(os.path.dirname(path)))
    assert names == {"ckpt", "ckpt.structure.json", "ckpt.meta.json"}
    import json

    with open(path + ".meta.json") as fh:
        meta = json.load(fh)
    assert meta["pod_window"] == first.pod_window and meta["telemetry_ring"] == 16 and meta["reclaim"] is True
    assert meta["scheduler_profile"]["name"] == "best_fit"
    assert resumed.tracer.report()["spans"]["ckpt_restore"]["count"] == 1
    assert first.tracer.report()["spans"]["ckpt_save"]["count"] == 1


def test_restored_ring_re_drains_its_tail(composed_runs):
    """The ring is state: the restored engine re-drains what the restored
    ring holds (capacity 16), the tail of the saved run's series, and
    later windows join it losslessly."""
    _, _, first, _, path = composed_runs
    fresh = _composed()
    fresh.load_checkpoint(path)
    wins_a, data_a = first.telemetry_window_series()
    wins_b, data_b = fresh.telemetry_window_series()
    assert len(wins_b) == 16 and list(wins_b) == list(wins_a[-16:])
    np.testing.assert_array_equal(data_b, data_a[-16:])
    for t in np.arange(MID + 80.0, MID + 240.0, 80.0):  # calls shorter than the ring: its drains keep up
        fresh.step_until_time(float(t))
    wins_c, _ = fresh.telemetry_window_series()
    assert list(wins_c) == list(range(int(wins_b[0]), fresh.next_window_idx))


def test_streamed_run_restored_mid_stream(composed_runs, tmp_path):
    """The composed line streamed (stream=True) saved at 210 s, after a
    slide installed a slab and before the growth and the next slide:
    the restore re-seeks the feeder at the restored base, and the
    continuation equals the uninterrupted run and the reference's
    (reference tests/test_streaming.py:181)."""
    jx, straight, _, _, _ = composed_runs

    def build():
        return _composed(stream=True, stream_segment=48)

    first = build()
    first.step_until_time(210.0)
    stats = first.dispatch_stats
    assert first._feeder is not None and stats["stage_refills"] > 0 and stats["slides"] > 0 and not stats["grows"]
    path = str(tmp_path / "ckpt")
    first.save_checkpoint(path)
    first.close()
    resumed = build()
    resumed.load_checkpoint(path)
    assert resumed._pod_base == first._pod_base > 0 and resumed._feeder is not None
    resumed.step_until_time(400.0)
    resumed.step_until_time(END)
    stats = resumed.dispatch_stats
    assert stats["stage_refills"] > 0 and stats["slides"] > 0 and stats["grows"] > 0
    assert compare_states(state_to_numpy(straight.state), state_to_numpy(resumed.state)) == []
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(resumed.state)) == []
    assert resumed.metrics_summary() == straight.metrics_summary()
    resumed.close()


def test_save_after_growth_restores_into_a_narrow_engine(tmp_path):
    """A checkpoint taken after growths restores into an engine built at
    the narrow width, which grows to match first (reference
    tests/test_pod_window_growth.py:146)."""
    def build():
        return composed_sim("cpu", 2, pod_window=4, fast_forward=False)

    straight = build()
    straight.step_until_time(500.0)
    first = build()
    first.step_until_time(250.0)
    assert first.pod_window > 4
    path = str(tmp_path / "ckpt")
    first.save_checkpoint(path)
    fresh = build()
    fresh.load_checkpoint(path)
    assert fresh.pod_window == first.pod_window
    fresh.step_until_time(500.0)
    assert compare_states(state_to_numpy(straight.state), state_to_numpy(fresh.state)) == []


# --- (c) the file format ----------------------------------------------------------------


def test_save_overwrites_the_previous_checkpoint(tmp_path):
    path = str(tmp_path / "ckpt")
    sim = composed_sim("cpu", 2)
    sim.step_until_time(100.0)
    sim.save_checkpoint(path)
    sim.step_until_time(200.0)
    sim.save_checkpoint(path)
    assert set(os.listdir(tmp_path)) == {"ckpt", "ckpt.structure.json"}
    fresh = composed_sim("cpu", 2)
    fresh.load_checkpoint(path)
    assert fresh.next_window_idx == sim.next_window_idx
    assert compare_states(state_to_numpy(sim.state), state_to_numpy(fresh.state)) == []


def test_structure_mismatch_names_the_leaves(tmp_path):
    path = str(tmp_path / "ckpt")
    sim = composed_sim("cpu", 2)
    sim.step_until_time(100.0)
    sim.save_checkpoint(path)
    payload = sim._ckpt_payload()
    wide = payload["state"]._replace(pods=payload["state"].pods._replace(
        phase=torch.zeros((sim.n_clusters, sim.n_pods + 8), dtype=torch.int32)))
    with pytest.raises(ValueError, match=r"mismatch at \['state'\]\.pods\.phase"):
        ckpt_restore(path, {"state": wide, "next_window_idx": payload["next_window_idx"]})
    with pytest.raises(ValueError, match="structure") as err:
        ckpt_restore(path, {"something": torch.zeros((3,), dtype=torch.int32)})
    assert "missing in checkpoint: ['something']" in str(err.value)
    assert "unexpected leaf in checkpoint: ['state'].pods.phase" in str(err.value)
    # Without its manifest the file itself is checked.
    os.remove(path + ".structure.json")
    with pytest.raises(ValueError, match=r"dtype=float32"):
        ckpt_restore(path, {**payload, "next_window_idx": torch.tensor(0.0)})


def test_missing_path_raises(tmp_path):
    with pytest.raises(ValueError, match="no checkpoint"):
        ckpt_restore(str(tmp_path / "nope"), {"a": torch.zeros(2)})


def test_restore_recovers_the_aside_after_a_crashed_swap(tmp_path):
    payload = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    path = str(tmp_path / "ckpt")
    ckpt_save(path, payload)
    os.rename(path, path + ".old")  # the crash point: aside moved, the swap pending
    out = ckpt_restore(path, payload)
    assert torch.equal(out["a"], payload["a"])


def test_plain_tree_round_trip_loads_with_weights_only(tmp_path):
    """Any tree of dicts, NamedTuples, tensors and numpy arrays; the file
    is a flat {keystr: tensor} dict that torch.load reads with
    weights_only=True."""
    from kubernetriks_tpu_torch.batched.timerep import TPair

    payload = {
        "a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "b": {"c": torch.ones((4,), dtype=torch.float32), "t": TPair(win=torch.tensor([1, 2]), off=torch.tensor([0.5, 0.25]))},
        "n": np.arange(3, dtype=np.int64),
        "u": torch.tensor([7, 2**32 - 1], dtype=torch.uint32),
        "m": torch.tensor([True, False]),
    }
    path = str(tmp_path / "ckpt")
    ckpt_save(path, payload)
    out = ckpt_restore(path, payload)
    flat_in, flat_out = flatten_tree(payload), flatten_tree(out)
    assert flat_in.keys() == flat_out.keys() == {"['a']", "['b']['c']", "['b']['t'].win", "['b']['t'].off", "['n']", "['u']", "['m']"}
    for k in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[k]), np.asarray(flat_in[k]))
    assert isinstance(out["n"], np.ndarray) and isinstance(out["b"]["t"], TPair)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == set(flat_in) and all(isinstance(v, torch.Tensor) for v in raw.values())


# --- (d) the guards -------------------------------------------------------------------------


def test_profile_guard_both_ways(tmp_path):
    profiled, plain = str(tmp_path / "p"), str(tmp_path / "d")
    a = composed_sim("cpu", 2, scheduler_profile="best_fit")
    a.step_until_time(100.0)
    a.save_checkpoint(profiled)
    with pytest.raises(ValueError, match="scheduler-profile mismatch"):
        composed_sim("cpu", 2).load_checkpoint(profiled)
    b = composed_sim("cpu", 2)
    b.step_until_time(100.0)
    b.save_checkpoint(plain)
    assert not os.path.exists(plain + ".meta.json")
    with pytest.raises(ValueError, match="scheduler-profile mismatch"):
        composed_sim("cpu", 2, scheduler_profile="best_fit").load_checkpoint(plain)
    ok = composed_sim("cpu", 2, scheduler_profile="best_fit")
    ok.load_checkpoint(profiled)
    assert ok.profile.name == "best_fit"


def test_ring_guard_both_ways(tmp_path):
    armed, plain = str(tmp_path / "on"), str(tmp_path / "off")
    a = composed_sim("cpu", 2, telemetry=True, telemetry_ring=16)
    a.step_until_time(100.0)
    a.save_checkpoint(armed)
    with pytest.raises(ValueError, match="telemetry ring mismatch"):
        composed_sim("cpu", 2).load_checkpoint(armed)
    with pytest.raises(ValueError, match="telemetry ring mismatch"):
        composed_sim("cpu", 2, telemetry=True, telemetry_ring=32).load_checkpoint(armed)
    b = composed_sim("cpu", 2)
    b.step_until_time(100.0)
    b.save_checkpoint(plain)
    with pytest.raises(ValueError, match="telemetry ring mismatch"):
        composed_sim("cpu", 2, telemetry=True, telemetry_ring=16).load_checkpoint(plain)


def test_reclaim_guard_and_tristate_follow(composed_runs, tmp_path):
    """An explicit reclaim= that differs from the save raises; an engine
    left to the default follows the checkpoint with a RuntimeWarning and
    continues as an engine built with the saved mode does, both ways."""
    _, straight, _, _, path = composed_runs
    with pytest.raises(ValueError, match="reclaim mismatch"):
        _composed(reclaim=False).load_checkpoint(path)
    follower = _composed(reclaim=None)
    assert follower._reclaim_requested is None and not follower.reclaim  # the CPU's default: off
    with pytest.warns(RuntimeWarning, match="following the checkpoint"):
        follower.load_checkpoint(path)
    assert follower.reclaim and follower.state.auto.ca_alloc is not None
    follower.step_until_time(END)
    assert compare_states(state_to_numpy(straight.state), state_to_numpy(follower.state)) == []

    off_path = str(tmp_path / "off")
    c = _composed(reclaim=False)
    c.step_until_time(MID)
    c.save_checkpoint(off_path)
    c.step_until_time(END)
    d = _composed(reclaim=True)
    d._reclaim_requested = None  # as if reclaim came from the card's default
    with pytest.warns(RuntimeWarning, match="following the checkpoint"):
        d.load_checkpoint(off_path)
    assert not d.reclaim and d.state.auto.ca_alloc is None
    d.step_until_time(END)
    assert compare_states(state_to_numpy(c.state), state_to_numpy(d.state)) == []


# --- (e) the gauge sidecar ---------------------------------------------------------------------


def test_gauge_sidecar_round_trip_and_stale_removal(tmp_path):
    path = str(tmp_path / "ckpt")
    sim = composed_sim("cpu", 2)
    sim.collect_gauges = True
    sim.step_until_time(150.0)
    sim.save_checkpoint(path)
    assert os.path.exists(path + ".gauges.npz")
    with np.load(path + ".gauges.npz", allow_pickle=False) as data:
        assert set(data.files) == {"windows", "samples"}
    fresh = composed_sim("cpu", 2)
    fresh.load_checkpoint(path)
    for got, want in zip(fresh.gauge_series(), sim.gauge_series()):
        np.testing.assert_array_equal(got, want)
    quiet = composed_sim("cpu", 2)
    quiet.step_until_time(50.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet.save_checkpoint(path)
    assert not os.path.exists(path + ".gauges.npz")
