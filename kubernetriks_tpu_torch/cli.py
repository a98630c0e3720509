"""Command line: run a simulation from a config file.

    python -m kubernetriks_tpu_torch.cli --config-file <yaml>
        [--backend batched|scalar] [--clusters N] [--max-pods-per-cycle K]
        [--pod-window W] [--profile NAME] [--report json|table]
        [--device cuda|cpu] [--gauge-csv PATH] [--metrics-export STEM]

The JAX package's `cli.py`. `--backend batched` (the default): load the
config, build the traces its `trace_config` names (an Alibaba v2017 trace
XOR a generic YAML trace), replicate them over N clusters in one
BatchedSimulation, run until every pod has terminated, and print the
metrics report. An Alibaba trace goes through the native C++ feeder
(trace/feeder.py) and `compile_from_arrays`, without event objects, where
the feeder builds; otherwise (and for a generic trace) through the event
objects (`build_traces`), with the Python parser's same results. The run
is on the CUDA card unless `--device cpu` is given.

`--pod-window W` runs the sliding pod window of W plain pod slots (0, the
default, keeps the whole trace resident). `--profile NAME` runs a named
scheduler profile (default, best_fit, balanced_packing), superseding the
config's `scheduler_profile` block as the JAX package's CLI does
(cli.py:269-308). A `fault_injection:` block in the config runs the
chaos engine. `--gauge-csv PATH` collects a gauge sample after every
window and writes cluster 0's series in the scalar collector's CSV
schema. With the flight recorder armed (KTPU_TRACE=1) the telemetry
report follows the metrics report and the Chrome trace is written to
KTPU_TRACE_PATH (default ktpu_trace) + ".json"; `--metrics-export STEM`
(which needs the recorder) appends every ring drain's record to
STEM.jsonl and writes the final report as the Prometheus textfile
STEM.prom (the JAX package's CLI, cli.py:187-236).

`--backend scalar` runs the scalar event-loop oracle on the host
(sim/simulator.py KubernetriksSimulation) until every pod has finished,
as the JAX package's CLI does (cli.py:317-335): `--report` renders the
collector's metrics, without it the config's `metrics_printer` block (or
JSON) reports, and `--gauge-csv` writes the collector's gauge CSV. It
never runs in place of the card: `--backend batched` without one raises.
The batched-only options (`--clusters` above 1, `--max-pods-per-cycle`,
`--pod-window`, `--device`, `--metrics-export`) are refused with it.
`logs_filepath` in the config sends the log to a rotating file.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

from kubernetriks_tpu_torch.config import SimulationConfig
from kubernetriks_tpu_torch.trace.interface import EmptyTrace


def setup_logging(config: SimulationConfig) -> None:
    """Level from KUBERNETRIKS_LOG; with the config's `logs_filepath` the
    log goes to that rotating file alone (50 files of 100 MiB, the
    reference's main.rs:33-50), else to the console."""
    from logging.handlers import RotatingFileHandler

    from kubernetriks_tpu_torch.flags import flag_str

    level = (flag_str("KUBERNETRIKS_LOG") or "INFO").upper()
    if config.logs_filepath:
        os.makedirs(os.path.dirname(config.logs_filepath) or ".", exist_ok=True)
        handlers = [RotatingFileHandler(config.logs_filepath, maxBytes=100 * 1024 * 1024, backupCount=50)]
    else:
        handlers = [logging.StreamHandler()]
    logging.basicConfig(
        level=getattr(logging, level, logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def build_traces(config: SimulationConfig):
    """(cluster trace, workload trace) of the config's trace source: an
    Alibaba trace through the native feeder where it builds, else (logged)
    through the Python parser."""
    trace_config = config.trace_config
    if trace_config is None:
        return EmptyTrace(), EmptyTrace()
    alibaba = trace_config.alibaba_cluster_trace_v2017
    generic = trace_config.generic_trace
    if (alibaba is None) == (generic is None):
        raise ValueError("exactly one of alibaba_cluster_trace_v2017 or generic_trace must be set")
    if generic is not None:
        from kubernetriks_tpu_torch.trace.generic import GenericClusterTrace, GenericWorkloadTrace

        return (
            GenericClusterTrace.from_file(generic.cluster_trace_path),
            GenericWorkloadTrace.from_file(generic.workload_trace_path),
        )
    from kubernetriks_tpu_torch.trace import feeder

    if feeder.native_available():
        cluster_cls, workload_cls = feeder.NativeAlibabaClusterTrace, feeder.NativeAlibabaWorkloadTrace
    else:
        logging.getLogger(__name__).info(
            "native trace feeder unavailable (%s); using the Python parser", feeder.native_build_error()
        )
        from kubernetriks_tpu_torch.trace.alibaba import AlibabaClusterTraceV2017, AlibabaWorkloadTraceV2017

        cluster_cls, workload_cls = AlibabaClusterTraceV2017, AlibabaWorkloadTraceV2017
    cluster = (
        cluster_cls.from_file(alibaba.machine_events_trace_path)
        if alibaba.machine_events_trace_path
        else EmptyTrace()
    )
    workload = workload_cls.from_files(alibaba.batch_instance_trace_path, alibaba.batch_task_trace_path)
    return cluster, workload


def build_batched_simulation(
    config: SimulationConfig,
    n_clusters: int,
    max_pods_per_cycle: int = 0,
    device=None,
    **engine_kwargs,
):
    """A BatchedSimulation of the config's traces over n_clusters clusters.
    max_pods_per_cycle 0 bounds each cycle at 256 pods, as the JAX
    package's CLI does (the engine takes every slot when there are fewer).
    `device`: see engine.resolve_device. engine_kwargs go to the engine
    (e.g. ca_slot_multiplier, pod_window, stream).

    An Alibaba trace with the native feeder: the CSVs parse into dense
    arrays and compile through compile_from_arrays, once for every cluster
    (reference cli.py:127-166); node-level faults, which the event path
    injects at compile, raise there. Otherwise the event objects."""
    from kubernetriks_tpu_torch.batched.engine import BatchedSimulation, build_batched_from_traces
    from kubernetriks_tpu_torch.trace import feeder

    trace_config = config.trace_config
    alibaba = trace_config.alibaba_cluster_trace_v2017 if trace_config else None
    if alibaba is not None and feeder.native_available():
        from kubernetriks_tpu_torch.batched.trace_compile import compile_from_arrays
        from kubernetriks_tpu_torch.chaos import has_node_faults

        if has_node_faults(config.fault_injection):
            raise ValueError(
                "node-level fault injection is not supported on the alibaba native-feeder path; use the "
                "generic trace path or set fault_injection.node.mttf to 0 (pod-level faults are unaffected)"
            )
        workload_arrays = feeder.load_workload_arrays(alibaba.batch_instance_trace_path, alibaba.batch_task_trace_path)
        cluster_arrays = (
            feeder.load_cluster_arrays(alibaba.machine_events_trace_path) if alibaba.machine_events_trace_path else None
        )
        ram_unit = engine_kwargs.get("ram_unit")
        compiled = compile_from_arrays(cluster_arrays, workload_arrays, config, **({"ram_unit": ram_unit} if ram_unit else {}))
        return BatchedSimulation(
            config, [compiled] * n_clusters, device=device, max_pods_per_cycle=max_pods_per_cycle or 256,
            **engine_kwargs,
        )
    cluster_trace, workload_trace = build_traces(config)
    return build_batched_from_traces(
        config,
        cluster_trace.convert_to_simulator_events(),
        workload_trace.convert_to_simulator_events(),
        n_clusters=n_clusters,
        device=device,
        max_pods_per_cycle=max_pods_per_cycle or 256,
        **engine_kwargs,
    )


def run_batched(config: SimulationConfig, args) -> int:
    from kubernetriks_tpu_torch.metrics.render import render_metrics

    log = logging.getLogger(__name__)
    kwargs = {"pod_window": args.pod_window} if args.pod_window else {}
    sim = build_batched_simulation(
        config, args.clusters, args.max_pods_per_cycle, device=args.device or "cuda", **kwargs
    )
    log.info(
        "batched run on %s: %d clusters x %d node slots x %d pod slots, cycle route %s",
        sim.device, sim.n_clusters, sim.n_nodes, sim.n_pods, sim.cycle_route,
    )
    if args.metrics_export:
        # Every ring drain appends a record (occupancy, memory watermarks,
        # watchdog verdicts); raises unless the recorder is armed.
        from kubernetriks_tpu_torch.telemetry.export import JsonlExporter

        sim.attach_metrics_exporter(JsonlExporter(args.metrics_export + ".jsonl"))
    sim.collect_gauges = bool(args.gauge_csv)
    t0 = time.perf_counter()
    sim.run_to_completion()
    elapsed = time.perf_counter() - t0
    if args.gauge_csv:
        sim.write_gauge_csv(args.gauge_csv)
    summary = sim.metrics_summary()
    decisions = summary["counters"]["scheduling_decisions"]
    log.info(
        "Processed %d scheduling decisions in %.2fs (%.0f decisions/s)",
        decisions, elapsed, decisions / max(elapsed, 1e-9),
    )
    print(render_metrics(summary, args.report or "json"))
    if sim._telemetry:
        # One report serves the render and the Prometheus textfile.
        from kubernetriks_tpu_torch.flags import flag_str
        from kubernetriks_tpu_torch.metrics.render import render_telemetry

        report = sim.telemetry_report()
        print(render_telemetry(report, args.report or "json"))
        trace_path = (flag_str("KTPU_TRACE_PATH") or "ktpu_trace") + ".json"
        sim.write_chrome_trace(trace_path)
        log.info("wrote Chrome trace (Perfetto-loadable) to %s", trace_path)
        if args.metrics_export:
            from kubernetriks_tpu_torch.telemetry.export import write_prometheus_textfile

            prom = write_prometheus_textfile(args.metrics_export + ".prom", report)
            log.info("wrote observatory metrics to %s.jsonl and %s", args.metrics_export, prom)
    return 0


def run_scalar(config: SimulationConfig, args) -> int:
    """The scalar event-loop oracle until every pod has finished, then the
    report: `--report`'s format through the shared renderer, else the
    config's metrics_printer block, else JSON on stdout."""
    from kubernetriks_tpu_torch.metrics.printer import metrics_as_dict, print_metrics
    from kubernetriks_tpu_torch.metrics.render import render_metrics
    from kubernetriks_tpu_torch.sim.callbacks import RunUntilAllPodsAreFinishedCallbacks
    from kubernetriks_tpu_torch.sim.simulator import KubernetriksSimulation

    cluster_trace, workload_trace = build_traces(config)
    sim = KubernetriksSimulation(config, gauge_csv_path=args.gauge_csv)
    sim.initialize(cluster_trace, workload_trace)
    sim.run_with_callbacks(RunUntilAllPodsAreFinishedCallbacks())
    if args.report is not None:
        print(render_metrics(metrics_as_dict(sim.metrics_collector), args.report))
    elif config.metrics_printer is None:
        print_metrics(sim.metrics_collector, None)
    sim.metrics_collector.close()
    return 0


def _refuse_batched_options(args) -> None:
    """The batched-only options, refused with --backend scalar by name."""
    given = {
        "--clusters": args.clusters != 1,
        "--max-pods-per-cycle": bool(args.max_pods_per_cycle),
        "--pod-window": bool(args.pod_window),
        "--device": args.device is not None,
        "--metrics-export": args.metrics_export is not None,
    }
    for flag, set_ in given.items():
        if set_:
            raise SystemExit(f"kubernetriks_tpu_torch.cli: {flag} is a batched-backend option; "
                             "--backend scalar does not take it")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="kubernetriks-tpu simulator, PyTorch port")
    parser.add_argument("--config-file", required=True, help="Path to YAML config")
    parser.add_argument("--backend", choices=("scalar", "batched"), default="batched",
                        help="the batched engine on the card (default) or the scalar event-loop oracle on the host")
    parser.add_argument("--clusters", type=int, default=1,
                        help="number of identical clusters stepped in lockstep")
    parser.add_argument("--max-pods-per-cycle", type=int, default=0,
                        help="per-cycle scheduling work bound (0 = 256)")
    parser.add_argument("--report", choices=("json", "table"), default=None,
                        help="end-of-run report format (default json; the scalar backend then follows the "
                             "config's metrics_printer block)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default cuda; 'cpu' runs the plain PyTorch path)")
    parser.add_argument("--pod-window", type=int, default=0,
                        help="sliding pod window of this many plain pod slots (0 = whole trace resident)")
    parser.add_argument("--profile", default=None,
                        help="scheduler profile: a named profile (default, best_fit, balanced_packing) "
                             "overriding the config's scheduler_profile block")
    parser.add_argument("--gauge-csv", default=None,
                        help="collect per-window gauges and write cluster 0's series as CSV to this path")
    parser.add_argument("--metrics-export", default=None,
                        help="observatory time-series export: STEM.jsonl (one record a ring drain) and "
                             "STEM.prom (Prometheus textfile); needs KTPU_TRACE=1")
    args = parser.parse_args(argv)
    if args.backend == "scalar":
        _refuse_batched_options(args)
    config = SimulationConfig.from_file(args.config_file)
    setup_logging(config)
    if args.profile is not None:
        config = dataclasses.replace(config, scheduler_profile=args.profile)
    if args.backend == "batched":
        return run_batched(config, args)
    if args.report is not None:
        # --report supersedes the config's metrics_printer block: one report.
        config = dataclasses.replace(config, metrics_printer=None)
    return run_scalar(config, args)


if __name__ == "__main__":
    sys.exit(main())
