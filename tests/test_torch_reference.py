"""Reference adapter for the PyTorch port's parity tests, and the test that
the port's runtime loads neither jax nor the JAX package.

The JAX package (kubernetriks_tpu) is the reference: these helpers build
its batched engine on the CPU along two paths — the XLA path
(use_pallas=False) and the dense Pallas kernel path in interpret mode with
the megakernel forced on — and flatten its state to the framework-neutral
{keystr path: numpy array} form that kubernetriks_tpu_torch.convert and
compare_states use. Only tests import both packages.

JAX 0.9 dropped `jax.experimental.enable_x64`, which the reference's kernel
modules import; the alias below is installed before any reference module
is imported (the reference package itself is left as it is).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402

import kubernetriks_tpu.ops.scheduler_kernel as jax_kernels  # noqa: E402
from kubernetriks_tpu.batched.engine import build_batched_from_traces as jax_build  # noqa: E402
from kubernetriks_tpu.config import SimulationConfig as JaxConfig  # noqa: E402
from kubernetriks_tpu.trace.generator import (  # noqa: E402
    PoissonWorkloadTrace as JaxPoisson,
    UniformClusterTrace as JaxUniform,
)
from kubernetriks_tpu.trace.generic import (  # noqa: E402
    GenericClusterTrace as JaxGenericCluster,
    GenericWorkloadTrace as JaxGenericWorkload,
)

from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces as port_build  # noqa: E402
from kubernetriks_tpu_torch.batched.state import compare_states  # noqa: E402
from kubernetriks_tpu_torch.config import SimulationConfig as PortConfig  # noqa: E402
from kubernetriks_tpu_torch.convert import state_to_numpy  # noqa: E402
from kubernetriks_tpu_torch.trace.generator import (  # noqa: E402
    PoissonWorkloadTrace as PortPoisson,
    UniformClusterTrace as PortUniform,
)
from kubernetriks_tpu_torch.trace.generic import (  # noqa: E402
    GenericClusterTrace as PortGenericCluster,
    GenericWorkloadTrace as PortGenericWorkload,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCH_CONFIG = "sim_name: bench\nseed: 1\nscheduling_cycle_interval: 10.0\n"
POISSON = dict(
    rate_per_second=2.0, horizon=100.0, seed=3, cpu=4000, ram=8 * 1024**3,
    duration_range=(30.0, 120.0),
)


def jax_state_to_numpy(state) -> dict:
    """The JAX engine's ClusterBatchState as {keystr path: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


class TraceSpec:
    """One trace, given once, rendered as each package's event objects:
    either the Poisson/uniform generators with shared parameters or a pair
    of generic YAML documents."""

    def __init__(self, n_nodes=8, poisson=None, cluster_yaml=None, workload_yaml=None):
        self.n_nodes = n_nodes
        self.poisson = poisson
        self.cluster_yaml = cluster_yaml
        self.workload_yaml = workload_yaml

    def events(self, side: str):
        if self.cluster_yaml is not None:
            cluster_cls = JaxGenericCluster if side == "jax" else PortGenericCluster
            workload_cls = JaxGenericWorkload if side == "jax" else PortGenericWorkload
            return (
                cluster_cls.from_yaml(self.cluster_yaml).convert_to_simulator_events(),
                workload_cls.from_yaml(self.workload_yaml).convert_to_simulator_events(),
            )
        uniform = JaxUniform if side == "jax" else PortUniform
        poisson = JaxPoisson if side == "jax" else PortPoisson
        return (
            uniform(self.n_nodes).convert_to_simulator_events(),
            poisson(**self.poisson).convert_to_simulator_events(),
        )


def build_jax_engine(config_yaml, spec: TraceSpec, n_clusters, k, path, monkeypatch=None, **kwargs):
    """The reference engine on one of its two paths: "xla" (use_pallas=
    False) or "megakernel" (interpret-mode Pallas, with use_pallas_select
    AND use_megakernel forced on after the build: the engine fixes
    use_megakernel at build time from use_pallas_select, which its C >= 128
    gate leaves off at test sizes). For the megakernel path pass
    `monkeypatch`: a counting wrapper then proves the kernel was traced.
    Other keyword arguments go to the engine build."""
    cluster, workload = spec.events("jax")
    mega = path == "megakernel"
    sim = jax_build(
        JaxConfig.from_yaml(config_yaml), cluster, workload,
        n_clusters=n_clusters, max_pods_per_cycle=k,
        use_pallas=mega, pallas_interpret=mega, **kwargs,
    )
    sim.megakernel_calls = [0]
    if mega:
        sim.use_pallas_select = True
        sim.use_megakernel = True
        real = jax_kernels.fused_select_cycle_commit

        def counting(*args, **kwargs):
            sim.megakernel_calls[0] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(jax_kernels, "fused_select_cycle_commit", counting)
        jax.clear_caches()  # a cached window program would skip the wrapper
    return sim


def build_port_engine(config_yaml, spec: TraceSpec, n_clusters, k, device="cpu", **kwargs):
    cluster, workload = spec.events("port")
    return port_build(
        PortConfig.from_yaml(config_yaml), cluster, workload,
        n_clusters=n_clusters, device=device, max_pods_per_cycle=k, **kwargs,
    )


def test_reference_adapter_forces_the_megakernel(monkeypatch):
    spec = TraceSpec(n_nodes=4, poisson=dict(POISSON, horizon=40.0))
    sim = build_jax_engine(BENCH_CONFIG, spec, 2, 4, "megakernel", monkeypatch)
    sim.step_until_time(50.0)
    assert sim.megakernel_calls[0] >= 1
    assert sim.use_megakernel and sim.use_pallas_select
    port = build_port_engine(BENCH_CONFIG, spec, 2, 4)
    port.step_until_time(50.0)
    assert compare_states(jax_state_to_numpy(sim.state), state_to_numpy(port.state)) == []


def test_port_main_path_loads_no_jax(tmp_path):
    """The port's main path, its autoscaler path (whole-resident and through
    the sliding pod window, and with faults and a profile), the flight
    recorder (the ring, the watchdog, gauges, the report), a run streamed
    by the feeder thread, the endurance churn with slot reclaim, the trace
    replay through the native feeder and the CLI, a checkpoint's save and
    restore, two waves of a scenario fleet with faults, and a 2-window
    greedy rollout of the RL loop, run in a fresh interpreter, leave no
    module named jax* or kubernetriks_tpu.* in sys.modules."""
    code = textwrap.dedent(
        """
        import sys
        import tempfile
        from kubernetriks_tpu_torch.batched.engine import build_batched_from_traces
        from kubernetriks_tpu_torch.config import SimulationConfig
        from kubernetriks_tpu_torch.convert import state_to_numpy
        from kubernetriks_tpu_torch.trace.generator import PoissonWorkloadTrace, UniformClusterTrace
        import kubernetriks_tpu_torch.ops._build, kubernetriks_tpu_torch.ops.scheduler_kernel
        import kubernetriks_tpu_torch.ops.autoscale_kernel
        from test_torch_cuda import composed_sim
        cfg = SimulationConfig.from_yaml("sim_name: t\\nscheduling_cycle_interval: 10.0")
        sim = build_batched_from_traces(
            cfg, UniformClusterTrace(4).convert_to_simulator_events(),
            PoissonWorkloadTrace(1.0, 60.0, seed=3, cpu=4000).convert_to_simulator_events(),
            n_clusters=2, device="cpu", max_pods_per_cycle=8)
        sim.step_until_time(90.0)
        state_to_numpy(sim.state)
        assert sim.metrics_summary()["counters"]["scheduling_decisions"] > 0
        auto = composed_sim("cpu", 2)
        auto.step_until_time(160.0)
        state_to_numpy(auto.state)
        counters = auto.metrics_summary()["counters"]
        assert counters["total_scaled_up_pods"] > 0 and counters["total_scaled_up_nodes"] > 0
        sliding = composed_sim("cpu", 2, pod_window=8)
        sliding.step_until_time(400.0)
        assert sliding.dispatch_stats["slides"] > 0 and sliding.dispatch_stats["grows"] > 0
        state_to_numpy(sliding.state)
        sliding.metrics_summary()
        chaos_run = composed_sim("cpu", 4, faults=True, scheduler_profile="balanced_packing")
        chaos_run.step_until_time(600.0)
        assert chaos_run.metrics_summary()["counters"]["node_crashes"] > 0
        import kubernetriks_tpu_torch.flags, kubernetriks_tpu_torch.ops.telemetry_kernel
        import kubernetriks_tpu_torch.telemetry.export, kubernetriks_tpu_torch.telemetry.observatory
        import kubernetriks_tpu_torch.telemetry.ring, kubernetriks_tpu_torch.metrics.render
        armed = composed_sim("cpu", 2, pod_window=8, telemetry=True, watchdog=True)
        armed.collect_gauges = True
        armed.step_until_time(160.0)
        assert len(armed.telemetry_window_series()[0]) == armed.next_window_idx == len(armed.gauge_series()[0])
        kubernetriks_tpu_torch.metrics.render.render_telemetry(armed.telemetry_report(), "table")
        import kubernetriks_tpu_torch.batched.stream, kubernetriks_tpu_torch.batched.faults
        streamed = composed_sim("cpu", 2, pod_window=8, stream=True, stream_segment=24)
        streamed.step_until_time(400.0)
        assert streamed.dispatch_stats["stage_refills"] > 0 and streamed.telemetry_report()["feeder"]
        streamed.close()
        from chip_smoke import endurance_sim
        churn = endurance_sim("cpu", 1, 4, reclaim=True)
        churn.step_until_time(30.0 + 4 * 160.0)
        assert churn.metrics_summary()["counters"]["ca_slots_reclaimed"] > 0
        from kubernetriks_tpu_torch import cli
        from kubernetriks_tpu_torch.trace.synthetic_alibaba import write_synthetic_trace_dir
        machines, tasks, instances = write_synthetic_trace_dir(
            tempfile.mkdtemp(), n_machines=10, n_tasks=30, horizon=600.0, error_fraction=0.1, seed=3)
        config_path = tempfile.mktemp(suffix=".yaml")
        with open(config_path, "w") as f:
            f.write("sim_name: t\\ntrace_config:\\n  alibaba_cluster_trace_v2017:\\n"
                    f"    machine_events_trace_path: {machines}\\n"
                    f"    batch_task_trace_path: {tasks}\\n"
                    f"    batch_instance_trace_path: {instances}\\n")
        from kubernetriks_tpu_torch.trace import feeder
        assert feeder.native_available(), feeder.native_build_error()
        replay = cli.build_batched_simulation(SimulationConfig.from_file(config_path), 1, device="cpu")
        replay.run_to_completion()
        assert replay.cycle_route == "sorted"
        assert replay.metrics_summary()["counters"]["pods_succeeded"] == replay.n_real_pods
        assert cli.main(["--config-file", config_path, "--device", "cpu", "--report", "table"]) == 0
        import kubernetriks_tpu_torch.checkpoint
        from kubernetriks_tpu_torch.batched.fleet import Scenario, ScenarioFleet
        from chip_smoke import FAULTS_YAML, composed_config_yaml
        ckpt = tempfile.mktemp()
        chaos_run.save_checkpoint(ckpt)
        resumed = composed_sim("cpu", 4, faults=True, scheduler_profile="balanced_packing")
        resumed.load_checkpoint(ckpt)
        resumed.step_until_time(700.0)
        fleet = ScenarioFleet(
            SimulationConfig.from_yaml(composed_config_yaml(4) + FAULTS_YAML),
            UniformClusterTrace(4, cpu=64000, ram=128 * 1024**3).convert_to_simulator_events(),
            PoissonWorkloadTrace(0.2, 200.0, seed=3, cpu=16000).convert_to_simulator_events(),
            n_lanes=2, horizon=200.0, device="cpu", max_pods_per_cycle=8)
        out = fleet.sweep([Scenario(fault_seed=5, ca_threshold=0.6), Scenario(fault_seed=6), Scenario()])
        assert fleet.waves_run == 2 and all(r.ok for r in out)
        fleet.close()
        import kubernetriks_tpu_torch.parallel.ring, kubernetriks_tpu_torch.rl.attention_policy
        import kubernetriks_tpu_torch.rl.evaluate
        from kubernetriks_tpu_torch.rl.ppo import PPOTrainer
        from chip_smoke import rl_bench_sim
        _, flat = PPOTrainer(rl_bench_sim("cpu", 2), windows_per_rollout=2).collect(greedy=True)
        assert flat.valid.shape == (16, 2) and bool(flat.valid.any())
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
                     or m == "kubernetriks_tpu" or m.startswith("kubernetriks_tpu."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
