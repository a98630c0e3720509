"""End-of-run metric dump as JSON or aligned text table
(reference: src/metrics/printer.rs:20-164)."""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, Optional, TextIO

from kubernetriks_tpu_torch.config import MetricsPrinterConfig
from kubernetriks_tpu_torch.metrics.collector import MetricsCollector


def metrics_as_dict(collector: MetricsCollector) -> Dict[str, Any]:
    """The JSON schema mirrors the reference's MetricsJSON
    (reference: src/metrics/printer.rs:83-109)."""
    metrics = collector.accumulated_metrics
    return {
        "counters": {
            "total_nodes_in_trace": metrics.total_nodes_in_trace,
            "total_pods_in_trace": metrics.total_pods_in_trace,
            "pods_succeeded": metrics.pods_succeeded,
            "pods_unschedulable": metrics.pods_unschedulable,
            "pods_failed": metrics.pods_failed,
            "pods_removed": metrics.pods_removed,
            "total_scaled_up_nodes": metrics.total_scaled_up_nodes,
            "total_scaled_down_nodes": metrics.total_scaled_down_nodes,
            "total_scaled_up_pods": metrics.total_scaled_up_pods,
            "total_scaled_down_pods": metrics.total_scaled_down_pods,
            # Chaos-engine fault counters (zero when fault injection is off).
            "node_crashes": metrics.node_crashes,
            "node_recoveries": metrics.node_recoveries,
            "node_downtime_s": metrics.node_downtime_s,
            "pod_interruptions": metrics.pod_interruptions,
            "pod_restarts": metrics.pod_restarts,
        },
        "timings": {
            "pod_duration": metrics.pod_duration_stats.as_dict(),
            "pod_schedule_time": metrics.pod_scheduling_algorithm_latency_stats.as_dict(),
            "pod_queue_time": metrics.pod_queue_time_stats.as_dict(),
        },
    }


def metrics_as_pretty_table(collector: MetricsCollector) -> str:
    """Aligned-table rendering, through the SAME generic path the batched
    engine's metrics_summary and the telemetry report use
    (metrics/render.py) — scalar and batched runs emit the same report
    schema in the same two formats."""
    from kubernetriks_tpu_torch.metrics.render import render_metrics

    return render_metrics(metrics_as_dict(collector), "table")


def print_metrics(
    collector: MetricsCollector,
    config: Optional[MetricsPrinterConfig],
    stream: Optional[TextIO] = None,
) -> None:
    """Write metrics per config; without a config (or output_file), write JSON
    to ``stream`` (stdout by default)."""
    fmt = config.format if config else "JSON"
    if fmt == "PrettyTable":
        text = metrics_as_pretty_table(collector)
    else:
        text = json.dumps(metrics_as_dict(collector), indent=2)

    if config and config.output_file:
        with open(config.output_file, "w") as f:
            f.write(text)
    else:
        print(text, file=stream or sys.stdout)
