"""The flight recorder of the port (reference `kubernetriks_tpu/
telemetry/`): what a run did, window by window, read out without slowing
the run down.

- Host span tracer (tracer.py): a preallocated ring of perf_counter_ns
  spans over the engine's phases (window spans, slides, growths, graph
  captures, fast-forward's reads), exported as Chrome trace-event JSON
  and a per-phase report.
- Device ring (ring.py): per-window scheduling, autoscaler, fault and
  occupancy counts written on the card by one glue kernel at the end of
  every executed window (step.telemetry_record), carried in the state
  (ClusterBatchState.telemetry) and drained only where the host already
  blocks.
- Gauges (gauges.py): the per-window gauge series (`collect_gauges`) and
  its CSV, the scalar collector's schema.
- Capacity observatory (observatory.py): reserve occupancy from the
  ring's columns, memory watermarks and the saturation watchdog.
- Export (export.py): bounded JSONL drain records and a Prometheus
  textfile; histogram.py the latency histogram they read.

The contract, as the reference's: with telemetry on, every simulation
leaf is bit for bit what it is with telemetry off; telemetry adds no host
read and no graph replay inside the stepping loop (host_syncs and
dispatch_stats are equal on and off).

Arm it with `BatchedSimulation(telemetry=True)` or KTPU_TRACE=1 (the
watchdog with watchdog= or KTPU_WATCHDOG); read it out with
`telemetry_report()`, `telemetry_window_series()`, `drain_telemetry()` and
`write_chrome_trace()`.
"""

from kubernetriks_tpu_torch.telemetry.gauges import GaugeSeries
from kubernetriks_tpu_torch.telemetry.histogram import LatencyHistogram
from kubernetriks_tpu_torch.telemetry.tracer import (
    NULL_TRACER,
    NullTracer,
    PHASE_NAMES,
    SpanTracer,
    log_chunk_throughput,
)

__all__ = [
    "GaugeSeries",
    "LatencyHistogram",
    "NULL_TRACER",
    "NullTracer",
    "PHASE_NAMES",
    "SpanTracer",
    "log_chunk_throughput",
]
