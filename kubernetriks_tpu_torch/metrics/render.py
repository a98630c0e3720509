"""One rendering path for the end-of-run report: own copy of the JAX
package's `metrics/render.py` (`format_table`, `humanize`,
`render_metrics`). A report is a dict shaped `{"counters": {...},
"timings": {name: {min, max, mean, variance}}}` (the schema
`BatchedSimulation.metrics_summary` emits), rendered as "json" or "table"."""

from __future__ import annotations

import json
from typing import Any, Dict, List


def format_table(rows: List[list], header: List[str]) -> str:
    """Aligned ASCII table (the scalar printer's format, reference:
    src/metrics/printer.rs:20-164) — the one table formatter."""
    widths = [
        max(len(str(row[i])) for row in [header] + rows)
        for i in range(len(header))
    ]

    def fmt_row(row):
        return (
            "| "
            + " | ".join(str(v).ljust(w) for v, w in zip(row, widths))
            + " |"
        )

    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep, fmt_row(header), sep]
    lines += [fmt_row(row) for row in rows]
    lines.append(sep)
    return "\n".join(lines)


# Keys whose generic snake_case -> label transform would drop meaning
# (units); pinned to the labels the scalar table always printed.
_LABELS = {
    "node_downtime_s": "Node downtime (s)",
}


def humanize(key: str) -> str:
    """snake_case metric key -> row label ("pod_queue_time" ->
    "Pod queue time"), matching the labels the scalar table always
    printed."""
    return _LABELS.get(key, key.replace("_", " ").capitalize())


def render_metrics(d: Dict[str, Any], fmt: str) -> str:
    """Render a {"counters", "timings"} report dict as "json" or "table".
    Scalar and batched runs share this path, so both backends emit the
    same schema in the same two shapes."""
    if fmt == "json":
        return json.dumps(d, indent=2, default=float)
    if fmt != "table":
        raise ValueError(f"unknown report format {fmt!r} (json|table)")
    parts = []
    counters = d.get("counters")
    if counters:
        parts.append(
            format_table(
                [[humanize(k), v] for k, v in counters.items()],
                ["Metric", "Count"],
            )
        )
    timings = d.get("timings")
    if timings:
        parts.append(
            format_table(
                [
                    [
                        humanize(name),
                        *(stats[k] for k in ("min", "max", "mean", "variance")),
                    ]
                    for name, stats in timings.items()
                ],
                ["Metric", "Min", "Max", "Mean", "Variance"],
            )
        )
    return "\n".join(parts)
