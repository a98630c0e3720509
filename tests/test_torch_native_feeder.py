"""The port's native trace feeder (kubernetriks_tpu_torch/trace/feeder.py over
its own copy of the C++ source) and `compile_from_arrays`, on the CPU,
against the JAX package's.

- The arrays the port's feeder parses equal the reference feeder's, column
  for column, on the CSV texts of tests/test_native_feeder.py and on a
  seeded random trace with every failure mode mixed in; the errors it
  raises are the reference's.
- `WorkloadSegmentReader` segments, concatenated, equal the whole fill.
- The port's `compile_from_arrays` equals the reference's field for field
  and the port's own `compile_cluster_trace` over the event objects, also
  on the synthetic Alibaba day at a small scale and where a node is
  created and removed in one tick under asymmetric delay shifts.
- The CLI's native path (the arrays, compile_from_arrays, then
  BatchedSimulation over the clusters) ends in the state of its event
  path (the Python parser, which it falls back to where the library does
  not build) on the synthetic CSVs, through a sliding pod window.

The port builds its library into kubernetriks_tpu_torch/trace/build/
(never native/build/). Tolerance: exact everywhere.
"""

import numpy as np
import pytest

from test_native_feeder import MACHINE_EVENTS, WORKLOAD_INSTANCES, WORKLOAD_TASKS

from kubernetriks_tpu.batched.trace_compile import compile_from_arrays as jax_compile_from_arrays
from kubernetriks_tpu.config import SimulationConfig as JaxConfig
from kubernetriks_tpu.test_util import DEFAULT_TEST_CONFIG_YAML
from kubernetriks_tpu.trace import feeder as jax_feeder

from kubernetriks_tpu_torch import cli as port_cli
from kubernetriks_tpu_torch.batched.trace_compile import compile_cluster_trace, compile_from_arrays
from kubernetriks_tpu_torch.batched.state import compare_states
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig
from kubernetriks_tpu_torch.convert import state_to_numpy
from kubernetriks_tpu_torch.trace import feeder
from kubernetriks_tpu_torch.trace.synthetic_alibaba import write_synthetic_trace_dir

WORKLOAD_FIELDS = ("start_ts", "cpu_millicores", "ram_bytes", "duration", "job_id", "task_id", "pod_no")
CLUSTER_FIELDS = ("ts", "kind", "cpu_millicores", "ram_bytes", "machine_id")
COMPILED_ARRAYS = (
    "ev_time", "ev_kind", "ev_slot", "node_cap_cpu", "node_cap_ram", "pod_req_cpu", "pod_req_ram", "pod_duration",
)


@pytest.fixture
def native():
    if not feeder.native_available():
        pytest.skip(f"the port's native feeder did not build: {feeder.native_build_error()}")
    if not jax_feeder.native_available():
        pytest.skip(f"the reference's native feeder did not build: {jax_feeder.native_build_error()}")
    return feeder


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _random_csvs(tmp_path, seed=7, n_tasks=200, n_inst=4000):
    """tests/test_native_feeder.py's fuzz: random rows with every failure
    mode mixed in."""
    rng = np.random.default_rng(seed)
    task_lines = []
    for tid in range(n_tasks):
        cpu, mem = ("", "") if rng.random() < 0.1 else (str(rng.integers(10, 640)), f"{rng.random():.6f}")
        task_lines.append(f"1,2,{rng.integers(1, 50)},{tid},1,Terminated,{cpu},{mem}")
    inst_lines = []
    for _ in range(n_inst):
        start = rng.integers(-10, 5000)
        end = start + rng.integers(-5, 500)
        tid = rng.integers(0, int(n_tasks * 1.1))
        s = "" if rng.random() < 0.05 else str(start)
        e = "" if rng.random() < 0.05 else str(end)
        t = "" if rng.random() < 0.05 else str(tid)
        j = "" if rng.random() < 0.05 else str(rng.integers(1, 50))
        inst_lines.append(f"{s},{e},{j},{t},1,Terminated,1,1")
    machine_lines = []
    for mid in range(60):
        machine_lines.append(f"{rng.integers(0, 100)},{mid},add,,{rng.integers(8, 97)},{rng.random():.4f}")
        if rng.random() < 0.3:
            machine_lines.append(f"{rng.integers(100, 4000)},{mid},{rng.choice(['softerror', 'harderror'])},,,")
    machine_lines.append(f"500,{10_000},softerror,,,")  # a ghost node: deduplicated
    machine_lines.sort(key=lambda line: int(line.split(",")[0]))
    return (
        _write(tmp_path, "bi.csv", "\n".join(inst_lines) + "\n"),
        _write(tmp_path, "bt.csv", "\n".join(task_lines) + "\n"),
        _write(tmp_path, "me.csv", "\n".join(machine_lines) + "\n"),
    )


def _assert_arrays_equal(port, ref, fields):
    for name in fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _assert_compiled_equal(a, b):
    for name in COMPILED_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert list(a.node_names) == list(b.node_names) and list(a.pod_names) == list(b.pod_names)
    assert a.pod_groups == [] and b.pod_groups == []


@pytest.mark.parametrize("source", ["fixed", "random"])
def test_arrays_and_compile_match_the_reference(native, tmp_path, source):
    if source == "fixed":
        inst = _write(tmp_path, "bi.csv", WORKLOAD_INSTANCES)
        task = _write(tmp_path, "bt.csv", WORKLOAD_TASKS)
        machines = _write(tmp_path, "me.csv", MACHINE_EVENTS)
    else:
        inst, task, machines = _random_csvs(tmp_path)
    w_port, w_ref = feeder.load_workload_arrays(inst, task), jax_feeder.load_workload_arrays(inst, task)
    c_port, c_ref = feeder.load_cluster_arrays(machines), jax_feeder.load_cluster_arrays(machines)
    assert len(w_port.start_ts) > (3 if source == "fixed" else 1000)
    _assert_arrays_equal(w_port, w_ref, WORKLOAD_FIELDS)
    _assert_arrays_equal(c_port, c_ref, CLUSTER_FIELDS)
    assert [w_port.pod_name(i) for i in range(len(w_port.start_ts))] == [
        w_ref.pod_name(i) for i in range(len(w_ref.start_ts))
    ]
    port_cfg, ref_cfg = PortConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML), JaxConfig.from_yaml(DEFAULT_TEST_CONFIG_YAML)
    fast = compile_from_arrays(c_port, w_port, port_cfg)
    _assert_compiled_equal(fast, jax_compile_from_arrays(c_ref, w_ref, ref_cfg))
    slow = compile_cluster_trace(
        feeder.cluster_events_from_arrays(c_port), feeder.workload_events_from_arrays(w_port), port_cfg
    )
    _assert_compiled_equal(fast, slow)


@pytest.mark.parametrize("text, match", [
    ("1,2,3,64,1,T,50,0.5\n1,2,3,64,1,T,50,0.5\n", "duplicate"),
])
def test_errors_match_the_reference(native, tmp_path, text, match):
    inst = _write(tmp_path, "i.csv", WORKLOAD_INSTANCES)
    task = _write(tmp_path, "t.csv", text)
    errors = []
    for mod in (feeder, jax_feeder):
        with pytest.raises(ValueError, match=match) as info:
            mod.load_workload_arrays(inst, task)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    bad = _write(tmp_path, "m.csv", "10,1,explode,,,\n")
    messages = []
    for mod in (feeder, jax_feeder):
        with pytest.raises(ValueError) as info:
            mod.load_cluster_arrays(bad)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_segment_reader_matches_the_whole_fill(native, tmp_path):
    inst, task, _ = _random_csvs(tmp_path, seed=3)
    whole = feeder.load_workload_arrays(inst, task)
    with feeder.WorkloadSegmentReader(inst, task) as reader:
        assert len(reader) == len(whole.start_ts)
        for rows in (1, 97, 1000, len(reader) + 5):
            segs = list(reader.iter_segments(rows))
            assert [lo for lo, _ in segs] == list(range(0, len(reader), rows))
            for name in WORKLOAD_FIELDS:
                got = np.concatenate([getattr(seg, name) for _, seg in segs])
                assert np.array_equal(got, getattr(whole, name)), (rows, name)
        tail = reader.read(len(reader) - 3, 10)
        assert len(tail.start_ts) == 3
    python = feeder.WorkloadArraysReader(whole)
    for lo, n in ((0, 5), (17, 300), (len(whole.start_ts) - 1, 4)):
        _assert_arrays_equal(python.read(lo, n), feeder._rows(whole, lo, lo + n), WORKLOAD_FIELDS)
    with pytest.raises(ValueError, match="closed"):
        reader.read(0, 1)


def test_same_tick_create_remove_with_asymmetric_shifts(native, tmp_path):
    machines = _write(tmp_path, "me.csv", "100,1,add,,64,0.5\n100,1,softerror,,,\n")
    inst = _write(tmp_path, "bi.csv", "100,150,1,10,1,Terminated,1,1\n")
    task = _write(tmp_path, "bt.csv", "1,2,1,10,1,Terminated,50,0.015625\n")
    yaml = DEFAULT_TEST_CONFIG_YAML + "ps_to_sched_network_delay: 1.0\nas_to_node_network_delay: 0.0\n"
    port_cfg, ref_cfg = PortConfig.from_yaml(yaml), JaxConfig.from_yaml(yaml)
    c_arrays, w_arrays = feeder.load_cluster_arrays(machines), feeder.load_workload_arrays(inst, task)
    fast = compile_from_arrays(c_arrays, w_arrays, port_cfg)
    _assert_compiled_equal(fast, compile_cluster_trace(
        feeder.cluster_events_from_arrays(c_arrays), feeder.workload_events_from_arrays(w_arrays), port_cfg))
    _assert_compiled_equal(fast, jax_compile_from_arrays(
        jax_feeder.load_cluster_arrays(machines), jax_feeder.load_workload_arrays(inst, task), ref_cfg))


def test_cli_native_path_matches_the_event_path(native, tmp_path, monkeypatch):
    """The synthetic day cut to 30 machines and 120 tasks over 3 000 s,
    CA on: the CLI's native path equals its event path through a 32-slot
    sliding pod window at two clusters, to completion."""
    machines, tasks, instances = write_synthetic_trace_dir(
        str(tmp_path), n_machines=30, n_tasks=120, horizon=3000.0, error_fraction=0.1, seed=5)
    yaml = DEFAULT_TEST_CONFIG_YAML + (
        "trace_config:\n  alibaba_cluster_trace_v2017:\n"
        f"    machine_events_trace_path: {machines}\n"
        f"    batch_task_trace_path: {tasks}\n"
        f"    batch_instance_trace_path: {instances}\n"
        "cluster_autoscaler:\n  enabled: true\n  scan_interval: 10.0\n  max_node_count: 8\n"
        "  node_groups:\n  - node_template:\n      metadata:\n        name: ca_node\n"
        "      status:\n        capacity:\n          cpu: 64000\n          ram: 94489280512\n"
    )
    config = PortConfig.from_yaml(yaml)
    c_arrays, w_arrays = feeder.load_cluster_arrays(machines), feeder.load_workload_arrays(instances, tasks)
    _assert_compiled_equal(compile_from_arrays(c_arrays, w_arrays, config), compile_cluster_trace(
        feeder.cluster_events_from_arrays(c_arrays), feeder.workload_events_from_arrays(w_arrays), config))
    runs = []
    for native_on in (True, False):
        monkeypatch.setattr(feeder, "native_available", lambda on=native_on: on)
        sim = port_cli.build_batched_simulation(config, 2, device="cpu", pod_window=32)
        sim.run_to_completion(max_time=1e6)
        runs.append(sim)
    native_run, event_run = runs
    assert native_run.pod_names[0] == event_run.pod_names[0] and native_run.n_real_pods > 100
    assert native_run.dispatch_stats["slides"] > 0
    assert native_run.next_window_idx == event_run.next_window_idx
    assert compare_states(state_to_numpy(native_run.state), state_to_numpy(event_run.state)) == []
    counters = native_run.metrics_summary()["counters"]
    assert counters == event_run.metrics_summary()["counters"]
    assert counters["pods_succeeded"] == 2 * native_run.n_real_pods
    # Node faults are injected at compile: the native path refuses them.
    faulty = PortConfig.from_yaml(yaml + "fault_injection:\n  enabled: true\n  node:\n    mttf: 1000.0\n    mttr: 60.0\n")
    monkeypatch.setattr(feeder, "native_available", lambda: True)
    with pytest.raises(ValueError, match="native-feeder path"):
        port_cli.build_batched_simulation(faulty, 1, device="cpu")
