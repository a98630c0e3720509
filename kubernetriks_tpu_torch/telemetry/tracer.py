"""Host span tracer: the flight recorder's wall-clock half (reference
`kubernetriks_tpu/telemetry/tracer.py`; the same phase ids and names).

`begin()` is one `time.perf_counter_ns()` read; `end(phase, t0)` writes
one row of a preallocated int64 ring and four aggregate updates, well
under a microsecond a span. Phases are small ints. The port records the
phases it has: window spans (PH_WINDOW_CHUNK, one a span of windows the
executor runs), the sliding pod window's slides (PH_SLIDE) with their
shift read (PH_SHIFT_WAIT), growths (PH_WINDOW_GROW), graph captures
(PH_PRECOMPILE) and fast-forward's read of the next window after an
executed window (PH_PROGRESS_WAIT), and the sliding pod window's
staging: the engine thread's slab assembly, upload and prefetch
(PH_STAGE_ASSEMBLE, PH_STAGE_PUT, PH_STAGE_PREFETCH) and the stream
feeder's stalls at an install (PH_STAGE_WAIT_FEEDER, PH_STAGE_WAIT_UPLOAD),
checkpoint saves and restores (PH_CKPT_SAVE, PH_CKPT_RESTORE), the
scenario fleet's queries (PH_QUERY_QUEUE, PH_QUERY_SERVICE, PH_QUERY_FAIL:
queue wait, service and failure, each a span) and the lane-asynchronous
fleet's lane quarantines (PH_LANE_QUARANTINE: from the quarantine to the
lane's re-admission). Flow arrows (`flow_start` / `flow_end`, the Chrome
"s" / "f" events) link a fleet query's submit to its drain
(PH_QUERY_QUEUE), and `lane_event` records which query held which fleet
lane when (the Chrome trace's lane swimlanes, one a lane, on pid 2). The
superspan phases and the reference's async-readback flows stay empty.

Two consumers:
- `chrome_trace()`: Chrome trace-event JSON (Perfetto loads it): host
  spans as complete ("X") events, flow arrows, and optional device-ring
  counter tracks on a sim-time process (telemetry/ring.py builds those);
- `report()`: per-phase count / total / mean / max, exact even after the
  event ring wraps (the aggregates update on every `end()`).

`annotate`: a span from `span()` also opens an NVTX range
(`torch.cuda.nvtx.range_push/pop`) and a `torch.profiler.record_function`
scope named after its phase, so host phases show in a torch.profiler or
Nsight trace beside the kernels they launched (the reference opens a
jax.profiler.TraceAnnotation there, under its profile_dir; the port's
profiler run is profile_main_path.py's traced windows). The tracer never
touches a device value.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np

# Span phase ids, the reference's. Names index PHASE_NAMES; keep both in
# lockstep. The port records the phases marked "recorded"; the others stay
# empty until it has them.
PH_WINDOW_CHUNK = 0  # recorded: a span of windows through the window executor
PH_FUSED_CHUNK_SLIDE = 1  # the reference's fused chunk + slide dispatch
PH_SUPERSPAN = 2  # the reference's superspan dispatch
PH_PROGRESS_WAIT = 3  # recorded: fast-forward's read of the next window
PH_SHIFT_WAIT = 4  # recorded: the slide's read of its shift
PH_STAGE_ASSEMBLE = 5  # recorded: host assembly of a slab on the engine thread
PH_STAGE_PUT = 6  # recorded: upload of a slab on the engine thread
PH_STAGE_PREFETCH = 7  # recorded: the successor slab's prefetch
PH_REFILL_PREFETCH = 8  # the host slide path's refill prefetch
PH_SLIDE = 9  # recorded: the pod window's slide (piece and read)
PH_WINDOW_GROW = 10  # recorded: the pod window's growth (and recapture)
PH_CKPT_SAVE = 11  # recorded: checkpoint save (save_checkpoint)
PH_CKPT_RESTORE = 12  # recorded: checkpoint restore (load_checkpoint)
PH_PRECOMPILE = 13  # recorded: capture of window pieces ahead of use
PH_CHUNK_FENCED = 14  # an instrumented dispatch with a device fence
# Recorded: the streaming feeder's stalls, waiting for an unpublished
# slab, and for a published slab's upload to settle.
PH_STAGE_WAIT_FEEDER = 15
PH_STAGE_WAIT_UPLOAD = 16
# Recorded: the fleet query lifecycle, queue wait (submit -> admission),
# service (admission -> drain), a query's failure, and a lane's quarantine
# (quarantine -> re-admission; the lane-asynchronous fleet's).
PH_QUERY_QUEUE = 17
PH_QUERY_SERVICE = 18
PH_QUERY_FAIL = 19
PH_LANE_QUARANTINE = 20

# Flow event kinds (SpanTracer.flow_start / flow_end).
_FLOW_START = 0
_FLOW_END = 1

PHASE_NAMES = (
    "window_chunk",
    "fused_chunk_slide",
    "superspan",
    "progress_wait",
    "shift_wait",
    "stage_assemble",
    "stage_put",
    "stage_prefetch",
    "refill_prefetch",
    "slide",
    "window_grow",
    "ckpt_save",
    "ckpt_restore",
    "precompile",
    "chunk_fenced",
    "stage_wait_feeder",
    "stage_wait_upload",
    "query_queue",
    "query_service",
    "query_fail",
    "lane_quarantine",
)

_N_PHASES = len(PHASE_NAMES)

# Chrome-trace process ids: pid 0 = host spans, pid 1 = device-ring
# sim-time counter tracks (telemetry/ring.py), pid 2 = the fleet's lane
# swimlanes (one tid a lane, spans named by the occupying query id).
LANE_PID = 2


class _AnnotatedSpan:
    """Reusable context manager: one recorded span, and where the tracer
    annotates, an NVTX range and a torch.profiler record_function scope of
    the phase's name around it."""

    __slots__ = ("_tracer", "_phase", "_t0", "_ann", "_nvtx")

    def __init__(self, tracer: "SpanTracer", phase: int):
        self._tracer = tracer
        self._phase = phase
        self._ann = None
        self._nvtx = False

    def __enter__(self):
        if self._tracer.annotate:
            import torch

            name = PHASE_NAMES[self._phase]
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(name)
                self._nvtx = True
            self._ann = torch.profiler.record_function(name)
            self._ann.__enter__()
        self._t0 = self._tracer.begin()
        return self

    def __exit__(self, *exc):
        self._tracer.end(self._phase, self._t0)
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        return False


class SpanTracer:
    def __init__(self, capacity: int = 1 << 16, flow_capacity: int = 1 << 14, lane_capacity: int = 1 << 14):
        # Span event ring: [t0_ns, dur_ns, phase]; kept events wrap, the
        # per-phase aggregates below stay exact regardless.
        self._spans = np.zeros((capacity, 3), np.int64)
        self._n_spans = 0
        # Exact per-phase aggregates (ns).
        self._agg_count = np.zeros(_N_PHASES, np.int64)
        self._agg_total = np.zeros(_N_PHASES, np.int64)
        self._agg_max = np.zeros(_N_PHASES, np.int64)
        # Flow event ring: [t_ns, phase, flow_id, kind] (kind 0 the arrow's
        # start, 1 its end); the fleet's submit -> drain arrow a query.
        self._flows = np.zeros((flow_capacity, 4), np.int64)
        self._n_flows = 0
        self._next_flow = 1
        # Lane occupancy ring: [t0_ns, dur_ns, lane, qid], one a query that
        # held a fleet lane (the Chrome trace's lane swimlanes).
        self._lane_spans = np.zeros((lane_capacity, 4), np.int64)
        self._n_lane_spans = 0
        # Freeform counters (stage prefetch hits/misses, dispatch
        # histogram buckets, ...). Host ints only.
        self.counters: Dict[str, int] = {}
        self.enabled = True
        # When True, span() context managers also open an NVTX range and
        # a torch.profiler record_function scope (_AnnotatedSpan).
        self.annotate = False
        self._epoch = time.perf_counter_ns()

    # -- hot path ----------------------------------------------------------

    def begin(self) -> int:
        return time.perf_counter_ns()

    def end(self, phase: int, t0: int, dur: Optional[int] = None) -> None:
        dur = (time.perf_counter_ns() - t0) if dur is None else dur
        i = self._n_spans % self._spans.shape[0]
        buf = self._spans
        buf[i, 0] = t0
        buf[i, 1] = dur
        buf[i, 2] = phase
        self._n_spans += 1
        self._agg_count[phase] += 1
        self._agg_total[phase] += dur
        if dur > self._agg_max[phase]:
            self._agg_max[phase] = dur

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def flow_start(self, phase: int) -> int:
        """Open a flow arrow (a Chrome "s" event) now; returns its id (>= 1)."""
        fid = self._next_flow
        self._next_flow += 1
        self._flow_event(phase, fid, _FLOW_START)
        return fid

    def flow_end(self, phase: int, fid: int) -> None:
        """Close flow arrow `fid` (a Chrome "f" event) now."""
        self._flow_event(phase, fid, _FLOW_END)

    def _flow_event(self, phase: int, fid: int, kind: int) -> None:
        buf = self._flows
        i = self._n_flows % buf.shape[0]
        buf[i, 0] = time.perf_counter_ns()
        buf[i, 1] = phase
        buf[i, 2] = fid
        buf[i, 3] = kind
        self._n_flows += 1

    def lane_event(self, lane: int, qid: int, t0: int, dur: int) -> None:
        """Query `qid` held fleet lane `lane` for `dur` ns from `t0` (host
        clock): one ring row."""
        buf = self._lane_spans
        i = self._n_lane_spans % buf.shape[0]
        buf[i, 0] = t0
        buf[i, 1] = dur
        buf[i, 2] = lane
        buf[i, 3] = qid
        self._n_lane_spans += 1

    def span(self, phase: int) -> _AnnotatedSpan:
        """Context-manager span (the engine's window spans, slides,
        growths and captures); begin/end directly stay allocation-free."""
        return _AnnotatedSpan(self, phase)

    # -- export ------------------------------------------------------------

    def _kept(self, buf: np.ndarray, n: int) -> np.ndarray:
        cap = buf.shape[0]
        if n <= cap:
            return buf[:n]
        cut = n % cap
        return np.concatenate([buf[cut:], buf[:cut]], axis=0)

    def chrome_trace(self, extra_events: Optional[list] = None) -> dict:
        """Chrome trace-event JSON dict (load the written file straight
        into Perfetto / chrome://tracing). ts is microseconds relative to
        tracer construction; host spans live on pid 0, the device ring's
        sim-time counter tracks (extra_events, built by telemetry/ring.py)
        on pid 1."""
        ev = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": 0,
                "tid": 0,
                "args": {"name": "ktpu-host"},
            },
            {
                "ph": "M",
                "name": "thread_name",
                "pid": 0,
                "tid": 0,
                "args": {"name": "engine dispatch loop"},
            },
        ]
        epoch = self._epoch
        for t0, dur, phase in self._kept(self._spans, self._n_spans).tolist():
            ev.append(
                {
                    "ph": "X",
                    "name": PHASE_NAMES[int(phase)],
                    "cat": "host",
                    "ts": (t0 - epoch) / 1e3,
                    "dur": dur / 1e3,
                    "pid": 0,
                    "tid": 0,
                }
            )
        for t, phase, fid, kind in self._kept(self._flows, self._n_flows).tolist():
            ev.append(
                {
                    "ph": "s" if kind == _FLOW_START else "f",
                    "bp": "e",
                    "name": PHASE_NAMES[int(phase)],
                    "cat": "flow",
                    "id": int(fid),
                    "ts": (t - epoch) / 1e3,
                    "pid": 0,
                    "tid": 0,
                }
            )
        lane_rows = self._kept(self._lane_spans, self._n_lane_spans).tolist()
        if lane_rows:
            ev.append({"ph": "M", "name": "process_name", "pid": LANE_PID, "tid": 0, "args": {"name": "ktpu-lanes"}})
            for lane in sorted({int(r[2]) for r in lane_rows}):
                ev.append({"ph": "M", "name": "thread_name", "pid": LANE_PID, "tid": lane,
                           "args": {"name": f"lane {lane}"}})
            for t0, dur, lane, qid in lane_rows:
                ev.append({"ph": "X", "name": f"q{int(qid)}", "cat": "lane", "ts": (t0 - epoch) / 1e3,
                           "dur": dur / 1e3, "pid": LANE_PID, "tid": int(lane)})
        if extra_events:
            ev.extend(extra_events)
        return {
            "traceEvents": ev,
            "displayTimeUnit": "ms",
            "otherData": {
                "spans_recorded": int(self._n_spans),
                "spans_kept": int(min(self._n_spans, self._spans.shape[0])),
            },
        }

    def write_chrome_trace(
        self, path: str, extra_events: Optional[list] = None
    ) -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(extra_events), fh)
        return path

    def report(self) -> dict:
        """Aggregated per-phase wall time (ms totals, µs mean/max) plus
        the freeform counters — exact even when the span ring wrapped."""
        spans = {}
        for pid in range(_N_PHASES):
            n = int(self._agg_count[pid])
            if n == 0:
                continue
            total = int(self._agg_total[pid])
            spans[PHASE_NAMES[pid]] = {
                "count": n,
                "total_ms": total / 1e6,
                "mean_us": total / n / 1e3,
                "max_us": int(self._agg_max[pid]) / 1e3,
            }
        return {
            "spans": spans,
            "counters": dict(self.counters),
            "span_events": {
                "recorded": int(self._n_spans),
                "kept": int(min(self._n_spans, self._spans.shape[0])),
            },
            "lane_spans": {
                "recorded": int(self._n_lane_spans),
                "kept": int(min(self._n_lane_spans, self._lane_spans.shape[0])),
            },
        }


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """API-compatible no-op stand-in so the engine's instrumentation sites
    stay branch-free; `begin()` skips the clock read entirely."""

    annotate = False
    enabled = False
    counters: Dict[str, int] = {}

    def begin(self) -> int:
        return 0

    def end(self, phase: int, t0: int, dur: Optional[int] = None) -> None:
        pass

    def count(self, name: str, n: int = 1) -> None:
        pass

    def flow_start(self, phase: int) -> int:
        return 0

    def flow_end(self, phase: int, fid: int) -> None:
        pass

    def lane_event(self, lane: int, qid: int, t0: int, dur: int) -> None:
        pass

    def span(self, phase: int) -> _NullSpan:
        return _NULL_SPAN

    def report(self) -> dict:
        return {
            "spans": {},
            "counters": {},
            "span_events": {"recorded": 0, "kept": 0},
            "lane_spans": {"recorded": 0, "kept": 0},
        }


NULL_TRACER = NullTracer()


def log_chunk_throughput(logger, n_windows, n_clusters, decisions, elapsed):
    """The per-span decisions/s and cluster-windows/s log line (the scalar
    simulator's events/s log, reference: src/simulator.rs:363-368), the
    one owner of its format."""
    logger.info(
        "chunk of %d windows in %.3fs: %.0f decisions/s, "
        "%.0f cluster-windows/s",
        n_windows,
        elapsed,
        decisions / max(elapsed, 1e-9),
        n_windows * n_clusters / max(elapsed, 1e-9),
    )
