"""The sliding pod window's bounded staging in the port
(kubernetriks_tpu_torch/batched/engine.py: the streaming feeder, the
engine thread's bounded slabs over the device budget, and
attach_payload_source) on the CPU, against the JAX package's engine.

The trace: a contended Alibaba replay written by the synthetic generator
(6 machines, 30 % of them failing, 120 tasks of 16-64 cores over 2 400 s;
~266 plain pods a cluster) with the cluster autoscaler on (up to 16 nodes,
2 slots a node of the cap), so the pod-name ranks ride the stage, at two
clusters through a 32-slot pod window that slides and grows twice (to
128), built through each package's CLI function (the native feeder and
compile_from_arrays on both sides), run to completion:

- the port with the streaming feeder (stream=True; 64-column slabs: ahead
  of the engine at W = 32, on demand from W = 64), at least three slabs
  installed, against the JAX engine's default on the CPU (the whole-trace
  payload on the device, its device slide);
- the port over the device budget without the feeder
  (SLIDE_PAYLOAD_BUDGET_BYTES patched to 0: bounded slabs built on the
  engine thread by the stream feeder without its thread, at least three
  installed) against the JAX engine's host
  slide path (its _DEVICE_SLIDE_BUDGET_BYTES patched to 0), with the
  streamed run's host reads;
- the streamed run with attach_payload_source(FeederPayloadSource over
  the native WorkloadSegmentReader) mid-run, against the streamed run:
  equal, and the whole-trace host payload released; a source that
  disagrees with the compiled payload, a non-source and an engine without
  the feeder are refused.

Tolerance: compare_states (kubernetriks_tpu/batched/state.py:681): every
state leaf exact, the float32 metric accumulators within rtol 1e-6.
"""

import numpy as np
import pytest

from test_torch_reference import jax_state_to_numpy
from test_torch_replay import CA_YAML, alibaba_yaml, port_synth

import kubernetriks_tpu.batched.engine as jax_engine_mod
import kubernetriks_tpu.cli as jax_cli
from kubernetriks_tpu.config import SimulationConfig as JaxConfig

from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.batched import engine as engine_mod
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.batched.trace_compile import ArrayPayloadSource, FeederPayloadSource
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.trace import feeder

C, W, SEGMENT = 2, 32, 64
KW = dict(ca_slot_multiplier=2, pod_window=W)


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    if not feeder.native_available():
        pytest.skip(f"the port's native feeder did not build: {feeder.native_build_error()}")
    d = tmp_path_factory.mktemp("staging")
    paths = tuple(str(d / n) for n in ("m.csv", "t.csv", "i.csv"))
    machines, tasks, instances = paths
    port_synth.write_machine_events(machines, n_machines=6, error_fraction=0.3, horizon=2400.0, seed=11)
    port_synth.write_batch_workload(tasks, instances, n_tasks=120, horizon=2400.0,
                                    cpu_santicores_range=(1600, 6400), heavy_fraction=0.0, seed=12)
    return paths, alibaba_yaml(paths, CA_YAML.format(max_nodes=16, node_name="alibaba_ca_node"))


def _jax(yaml):
    sim = jax_cli.build_batched_simulation(JaxConfig.from_yaml(yaml), C, max_pods_per_cycle=256, **KW)
    sim.run_to_completion(max_time=1e6)
    return sim


def _port(yaml, **kwargs):
    return port_cli.build_batched_simulation(PortConfig.from_yaml(yaml), C, device="cpu", **KW, **kwargs)


@pytest.fixture(scope="module")
def streamed(trace):
    sim = _port(trace[1], stream=True, stream_segment=SEGMENT)
    assert sim._stream_on() and sim._slide_payload is None and sim._stage_width() == SEGMENT
    sim.run_to_completion(max_time=1e6)
    sim.close()
    return sim


def _check_windowed(sim, min_installs=3):
    stats = sim.dispatch_stats
    assert stats["stage_refills"] >= min_installs and stats["grows"] >= 1 and stats["slides"] >= 3
    assert sim.pod_window > W
    counters = sim.metrics_summary()["counters"]
    assert counters["pods_succeeded"] == C * sim.n_real_pods
    assert counters["total_scaled_up_nodes"] > 0 and counters["total_scaled_down_nodes"] > 0
    return counters


def test_streamed_run_matches_the_reference(trace, streamed):
    jx = _jax(trace[1])
    assert jx._device_slide is not None and not jx._stream_on()
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(streamed.state)) == []
    assert (streamed.pod_window, streamed._pod_base, streamed.next_window_idx) == (
        jx.pod_window, jx._pod_base, jx.next_window_idx)
    counters = _check_windowed(streamed)
    assert counters == jx.metrics_summary()["counters"]
    stats = streamed.dispatch_stats
    assert stats["feeder_slabs_produced"] >= stats["stage_refills"] and stats["feeder_restarts"] == 0


def test_over_budget_run_matches_the_reference_host_slide(trace, streamed, monkeypatch):
    monkeypatch.setattr(jax_engine_mod, "_DEVICE_SLIDE_BUDGET_BYTES", 0)
    monkeypatch.setattr(engine_mod, "SLIDE_PAYLOAD_BUDGET_BYTES", 0)
    jx = _jax(trace[1])
    assert jx._device_slide is None and not jx._stream_on()  # the host slide path
    sim = _port(trace[1], stream=False)
    assert not sim._stream_on() and sim._slide_payload is None
    sim.run_to_completion(max_time=1e6)
    assert compare_states(jax_state_to_numpy(jx.state), state_to_numpy(sim.state)) == []
    assert _check_windowed(sim) == jx.metrics_summary()["counters"]
    stats = sim.dispatch_stats
    assert stats["feeder_slabs_produced"] >= stats["stage_refills"] and not sim._feeder.report()["threaded"]
    # The engine thread's bounded slabs read the device as often as the
    # feeder's: once a span (and run_to_completion's own).
    assert sim.host_syncs == streamed.host_syncs


def test_attached_payload_source_equals_the_resident_payload(trace, streamed):
    paths, yaml = trace
    machines, tasks, instances = paths
    sim = _port(yaml, stream=True, stream_segment=SEGMENT)
    sim.step_until_time(1200.0)
    before = sim._slab_accounting()["host_payload_bytes"]
    assert isinstance(sim._payload_source, ArrayPayloadSource)
    with pytest.raises(TypeError, match="PayloadSource"):
        sim.attach_payload_source(object())
    reader = feeder.WorkloadSegmentReader(instances, tasks)
    with pytest.raises(ValueError, match="disagrees with the compiled payload"):
        sim.attach_payload_source(FeederPayloadSource(reader, C, engine_mod.DEFAULT_RAM_UNIT // 2))
    source = FeederPayloadSource(reader, C, engine_mod.DEFAULT_RAM_UNIT)
    old = sim._feeder
    sim.attach_payload_source(source)
    assert sim._payload_source is source and sim._feeder is not None and sim._feeder is not old  # re-seeked
    assert sim._stage_lo is None  # the old ring's slab is no longer installed
    released = before - sim._slab_accounting()["host_payload_bytes"]
    T = sim.consts.trace_pod_bound
    assert released == C * T * (4 + 4 + 8)  # req_cpu, req_ram, float64 durations
    # To the streamed run's last window (run_to_completion would end on
    # another chunk boundary from 1 200 s).
    sim.step_until_time((streamed.next_window_idx - 1) * 10.0)
    assert sim.next_window_idx == streamed.next_window_idx
    sim.close()
    assert compare_states(state_to_numpy(streamed.state), state_to_numpy(sim.state)) == []
    for key in ("slides", "grows"):
        assert sim.dispatch_stats[key] == streamed.dispatch_stats[key]
    unstreamed = _port(yaml, stream=False)
    with pytest.raises(ValueError, match="streaming feeder"):
        unstreamed.attach_payload_source(source)
    assert np.array_equal(
        source.segment(0, 8)["req_cpu"], ArrayPayloadSource(unstreamed._payload_source.full_pods).segment(0, 8)["req_cpu"]
    )
    reader.close()
