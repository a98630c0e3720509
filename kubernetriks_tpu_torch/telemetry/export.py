"""Time-series export for the capacity observatory: a bounded JSONL
appender and a Prometheus textfile writer (reference `kubernetriks_tpu/
telemetry/export.py`, copied whole).

Both consume the pure-python drain records and reports the observatory
builds from drained host copies, never a device value.

- `JsonlExporter` appends one JSON object per drain record, bounded: when
  the file would exceed `max_bytes` it rotates to `<path>.1` (replacing
  the previous rotation), so a long run's metrics file stays under ~2x
  max_bytes. Tail-friendly: `tail -f metrics.jsonl | jq .occupancy`.
- `write_prometheus_textfile` renders the latest telemetry report in the
  Prometheus text exposition format through tmp + rename (atomic: the
  node_exporter textfile collector's contract).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional


class JsonlExporter:
    """Bounded JSONL appender for observatory drain records."""

    def __init__(self, path: str, max_bytes: int = 8 << 20) -> None:
        self.path = path
        self.max_bytes = int(max_bytes)
        self.lines_written = 0
        directory = os.path.dirname(os.path.abspath(path))
        if directory:
            os.makedirs(directory, exist_ok=True)

    def emit(self, record: Dict) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        if size and size + len(line) > self.max_bytes:
            # Rotate: the previous window of history survives as .1, the
            # live file restarts — total footprint <= ~2x max_bytes.
            os.replace(self.path, self.path + ".1")
        with open(self.path, "a") as fh:
            fh.write(line)
        self.lines_written += 1


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


def _num(value) -> Optional[float]:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return None


def prometheus_lines(report: Dict, prefix: str = "ktpu_") -> List[str]:
    """Render a telemetry report (engine.telemetry_report()) as Prometheus
    text exposition lines: dispatch counters, the sync budget, the ring
    totals, and the capacity observatory's occupancy/memory gauges."""
    lines: List[str] = []

    def gauge(name: str, value, labels: Optional[Dict[str, str]] = None):
        num = _num(value)
        if num is None:
            return
        label_txt = ""
        if labels:
            inner = ",".join(
                f'{k}="{_prom_escape(str(v))}"' for k, v in sorted(labels.items())
            )
            label_txt = "{" + inner + "}"
        # Precision-preserving rendering: %g would round integers past 6
        # significant digits (an endurance run's window counters / byte
        # watermarks must stay exact; repr round-trips floats).
        txt = (
            str(int(num))
            if math.isfinite(num) and num == int(num)
            else repr(num)
        )
        lines.append(f"{prefix}{name}{label_txt} {txt}")

    for key, value in (report.get("dispatch_stats") or {}).items():
        gauge("dispatch_total", value, {"kind": key})
    budget = report.get("sync_budget") or {}
    gauge("sync_budget_expected", budget.get("steady_state_expected"))
    gauge("sync_budget_observed", budget.get("observed_slide_syncs"))
    ring = report.get("ring") or {}
    gauge("ring_windows_recorded", ring.get("windows_recorded"))
    gauge("ring_windows_kept", ring.get("windows_kept"))
    for key, value in (ring.get("totals") or {}).items():
        gauge("ring_total", value, {"column": key})
    resources = report.get("resources") or {}
    for name, entry in (resources.get("occupancy") or {}).items():
        if not isinstance(entry, dict):
            continue
        for field, value in entry.items():
            gauge("occupancy", value, {"gauge": name, "field": field})
    memory = resources.get("memory") or {}
    for key, value in memory.items():
        if key == "high_water":
            for hw_key, hw_val in value.items():
                gauge("memory_high_water_bytes", hw_val, {"kind": hw_key})
        elif isinstance(value, dict):
            for sub_key, sub_val in value.items():
                gauge("memory_bytes", sub_val, {"kind": f"{key}.{sub_key}"})
        else:
            gauge("memory_bytes", value, {"kind": key})
    queries = resources.get("queries") or {}
    for key, value in queries.items():
        # Lane-async per-query latency stats (observatory query_stats):
        # count + p50/p95/p99 in ms, with the queue_wait/service split
        # flattened into the stat label.
        if key == "histogram":
            continue
        if isinstance(value, dict):
            for sub_key, sub_val in value.items():
                gauge("query_latency", sub_val, {"stat": f"{key}_{sub_key}"})
        else:
            gauge("query_latency", value, {"stat": key})
    hist = queries.get("histogram") or {}
    if hist:
        # Native Prometheus histogram series from the bounded log-bucket
        # histogram: cumulative _bucket{le=...} samples (sparse — only
        # boundaries with nonzero increments, "+Inf" last), exact _sum
        # and _count, values under the same precision-preserving rule as
        # every other sample.
        for le, cum in hist.get("buckets") or []:
            le_num = _num(le)
            le_txt = (
                le
                if le_num is None
                else (
                    str(int(le_num))
                    if le_num == int(le_num)
                    else repr(le_num)
                )
            )
            gauge(
                "query_latency_seconds_bucket", cum, {"le": str(le_txt)}
            )
        gauge("query_latency_seconds_sum", hist.get("sum_s"))
        gauge("query_latency_seconds_count", hist.get("count"))
    watchdog = (resources.get("watchdog") or {})
    gauge("watchdog_enabled", watchdog.get("enabled"))
    for kind, window in (watchdog.get("fired") or {}).items():
        gauge("watchdog_fired_window", window, {"kind": kind})
    gauge("observatory_samples", resources.get("samples"))
    return lines


def write_prometheus_textfile(
    path: str, report: Dict, prefix: str = "ktpu_"
) -> str:
    """Atomically write the report as a Prometheus textfile (tmp+rename —
    a scraping node_exporter never sees a torn file)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write("\n".join(prometheus_lines(report, prefix)) + "\n")
    os.replace(tmp, path)
    return path
