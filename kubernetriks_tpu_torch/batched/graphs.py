"""The window executor: each window's work as a few pieces, replayed on the
card from CUDA graphs in the order the window's plan gives.

Port of the JAX package's chunked window dispatch: `step.run_windows`
(kubernetriks_tpu/batched/step.py:2504, jitted at :2586) scans a chunk of
windows in one compiled program, `engine._dispatch_windows`
(engine.py:1965) cuts a span into such chunks, and `precompile_chunks`
(engine.py:2064) compiles every program shape up front against a scratch
copy of the state, so no compile lands in a timed region. On the card the
counterpart of one compiled program is a CUDA graph: launched op by op from
Python, a window costs the host several times the device's time.

A window's work varies with its plan (step.WindowPlan, a host fact), so one
graph per window would not do. It is cut into pieces, each captured once
per key:

- ("lanes",) and ("lanes", "freeze"): under lane clocks (a
  lane-asynchronous engine), first in every window: step.lane_window
  writes each lane's virtual window into W and the active lanes into
  WindowBuffers.active from the global window the host fills
  (WindowBuffers.Wg); the freezing variant also copies every state leaf
  but the ring into WindowBuffers.snap, before the reclaim piece, and
  the window's end piece then carries a further key element "freeze"
  and reverts the inactive lanes to it (step.freeze_lanes_) after its
  copy-back, before the record (reference `_window_body`, step.py:
  1915-1934, and `_freeze_lanes`, :1741-1781). Where the host mirrors
  prove every lane active for a whole chunk the windows run the
  variants without the freeze (the reference's all-active fast path);
  both are captured at build.
- ("reclaim",): CA slot reclaim, first in every window under reclaim,
  before the event chunks: the dead-slot predicate
  (autoscale.ca_dead_slots, with the engine's reclaim_period the window
  test of autoscale.reclaim_due), then ca_reclaim_pass's compaction in a
  conditional node that runs only where some slot is dead in a window of
  the period, as the reference's lax.cond does, so a quiet window pays
  only the predicate.
  The reference runs it at the head of its window body, after the
  previous span's slide, so a SUCCEEDED pod still in flight blocks
  retirement only while the window holds it. A piece of its own rather
  than a head variant of the chunk piece, since a window with no event
  chunk runs it too, and folding it into the previous window's end graph
  would run it before a slide instead of after.
- ("chunk",): one event chunk (step.event_chunk). A window replays it
  `n_chunks` times: a chunk reads only the device cursor, so one graph
  serves every chunk.
- ("end", route, removal_due, hpa, ca): the rest of the window, which
  always runs back to back: the events' tail (step.events_tail), the
  cycle of `route`, the HPA pass (`hpa`: None for none, False for the
  metrics collection alone, True for the cycle) and, with `ca`, the CA
  pass; a further element "crash" where a chaos-engine crash applies
  (its accounting and the crash-caused reschedules run), and "gate"
  where the window-cost razor is on and the window has no event chunk:
  the tail then sits in a conditional node on the razor's predicate
  (step.window_work_due, the reference's lax.cond in
  `_apply_window_events`, step.py:203), after time = max(time, W), which
  the tail sets too; with event chunks the reference's predicate holds
  (an event is due) and the tail runs as it is. One end graph a window,
  so the state is copied back once a window (twice where the gated tail
  runs); at most 12 end graphs a route, 18 with node faults, 24 with the
  razor.

With a telemetry ring in the state (the flight recorder) the end piece
ends with the window's record (step.telemetry_record, one kernel), after
its copy-back and outside the razor's conditional node, so a gated window
records too (under lane clocks, with the global window and the active
lanes in its columns 0 and 11): the ring's row at cursor % R, the cursor,
and the counter snapshot WindowBuffers.m0, which the record refreshes to
the counters the next window starts from (nothing between two windows
changes them: the catch-up, the slide and a growth leave the metrics
alone; install_state sets it). No piece is added, so replays and reads
are those of a run
without telemetry. With gauge collection on (the engine's
collect_gauges) a ("gauge",) piece follows each window's end: the
window's step.gauge_snapshot into WindowBuffers.gauges at a slot the
device indexes, which the engine reads back once a span.

Under the conditional move the chunks also fill the nodes' creation
times of the window (WindowBuffers.node_create_rel), and the tail's
WakeEvents reach the cycle, whose queue preamble runs the scans on the
device (step.conditional_wake): no host read. A gated tail leaves its
WakeEvents in WindowBuffers.wake, emptied before the conditional node.

Fast-forward (the reference's `_run_windows_skip_impl`, step.py:2391)
adds two pieces, replayed after each executed window:

- ("next",): step.next_window_rows, then window_kernel.
  next_window_combine (under a mesh over every shard's rows, gathered
  between the two), writes [W + 1, next] into
  WindowBuffers.span, next clamped to WindowBuffers.limit (the span's
  last window + 1, filled by the host once a span); the host reads
  next back (`run_windows_skipping`: the executed window's one read);
- ("catch_up",): step.catch_up_bookkeeping over [span[0], span[1]),
  replayed where next > W + 1.

Under the sliding pod window one more piece runs between spans:

- ("slide", W, L, slot): the slide of the W-slot window
  (step.slide_shift_core, quantize_shift, slide_apply), refilled from a
  stage of L columns over plain columns [stage_lo, stage_lo + L)
  (stage_lo a device word, WindowBuffers.stage_lo), its shift left in a
  device word that
  `slide` copies to a pinned host word and waits for: the span's one host
  read. It moves the autoscaler statics' pod-name ranks in place (they
  are WindowBuffers.rank), since the end graphs read that tensor.

The stage is the engine's whole-trace payload (slot -1, stage_lo 0, L =
T + W) or a slot of the feeder's ring (stream.SlabRing), read in place:
one slide graph a slot, each on its slot's fixed addresses. Installing a
slab (`install_stage`, outside any capture) makes the compute stream wait
on the slab's upload event and writes stage_lo; the next slides replay
its slot's graph. One graph a slot rather than a copy into fixed stage
buffers: those buffers were one slab more on the device beside the ring,
and a ring has at most `stream_depth` slots, so a slide costs at most
that many captures. A re-seek at the ring's widths (a fleet's wave
boundary) keeps the ring, whose slots keep their addresses, so their
slide graphs stay; one at other widths builds a new ring and drops the
slide graphs of the old one (`drop_slide`).

A growth of the window changes the pod axis, so `rebuild` binds new
buffers at the new widths and captures again every piece it held.

`piece_schedule` names a window's pieces from its plan and the route.
The route is read from the engine at every window, so a route forced
after the build captures its own end graphs: a graph of another route
never runs. Everything else a graph reads from the engine (its sizes, K,
E, the slab and the tables) is fixed at build, or until a growth of the
pod window rebuilds the executor.

Fixed buffers. A graph reads and writes the addresses it was captured on,
so everything that lives from one piece to the next lies in buffers that
never move (`WindowBuffers`): the engine's state, the event accumulators
the chunks fill and the end piece reads (and resets), and the window index
W (one (C,) int32 buffer, filled before each window's replays). Each piece
computes its outputs as the eager step does and ends by copying them into
the very buffers it read (state.copy_state_into). Its intermediates are
dead once that copy is done, so all graphs share one memory pool.

Capture. Warm-up executes, capture does not: a piece first runs once on a
scratch copy of the buffers, on the capture stream (that builds and loads
the kernels, sets their shared-memory attributes and allocates the free
kernel's per-stream scratch outside the graph), then is captured on the
real buffers. A failed capture or replay raises; nothing falls back to
eager launches. A capture runs in CUDA's thread-local capture mode, so the
streaming feeder's thread (its event waits and copies on the copy stream)
cannot invalidate it, and with Python's garbage collector off, so no
unreachable engine's graphs or events are destroyed inside it.

Launch counts. A replay bypasses the wrappers that count kernel launches
(ops/_launch.LAUNCHES), so each graph keeps the counts its capture added,
the warm-up's and the capture's own are taken back out, and every replay
adds them: a run counts what an eager run of the same windows counts. A
conditional node's body (CudaGraphs.when) launches only where its flag is
set: its launches stay out of the graph's counts, and the body adds one
to a counter on the card each time it runs, which ops/_launch.
launch_counts and reset_launches fold into LAUNCHES (a host read, outside
any window). An eager run on the card runs such bodies whatever the flag
holds, so it launches more by WindowExecutor.skipped_body_launches().

Without a capture backend (on the CPU, or with graphs off) the executor
runs the same pieces uncaptured, in the same order on the same buffers;
a conditional node's body then runs where its flag is set on the CPU
(read there at no cost) and always on the card, where it must be the
identity when the flag is false.

Capture events. Every capture, a piece's (`_capture_all`, whether the
build's precompile or a replay that found its piece uncaptured) and a
conditional node's body's (`CudaGraphs.when`, keyed by its piece's key
and "body"), reaches one hook, recompile.publish_capture, which the
installed recompile sentinels read (KTPU_EXPLAIN_RECOMPILES). The
executor records its state leaves' addresses at every binding of its
buffers (`addresses`), which the sanitizer's address check compares the
engine's state against (sanitize.check_addresses).

Under a mesh (the engine's `mesh=`) three pieces reduce over the whole
batch: the gated end piece all-reduces the razor's predicate before its
conditional node, the next piece gathers every shard's per-cluster words
before its combine, and the slide all-reduces its shift's minimum. On
NCCL the collectives are captured with the piece
(`collective_captures` records which captures issued one); every rank
runs the same pieces in the same order, since the host plans are the
whole batch's.

A device WHILE node over a whole span is not used: the host plans each
window's pieces (step.WindowPlan), so a loop on the device would need one
graph for every sequence of plans.
"""

from __future__ import annotations

import gc
import threading
from functools import partial
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch

from kubernetriks_tpu_torch.batched.autoscale import (
    ca_dead_slots,
    ca_pass,
    ca_reclaim_pass,
    hpa_pass,
    reclaim_due,
    reclaim_name_orders,
)
from kubernetriks_tpu_torch.batched.state import (
    ClusterBatchState,
    LaneClocks,
    clone_state,
    copy_state_into,
    counter_snapshot,
    flatten,
    storages,
    strip_telemetry,
)
from kubernetriks_tpu_torch.batched.step import (
    INF,
    EventAccumulators,
    WakeEvents,
    WindowPlan,
    catch_up_bookkeeping,
    empty_wake,
    event_chunk,
    events_tail,
    freeze_lanes_,
    gauge_snapshot,
    lane_window,
    next_window_rows,
    quantize_shift,
    run_scheduling_cycle,
    slide_apply,
    slide_shift_core,
    telemetry_record,
    window_work_due,
)
from kubernetriks_tpu_torch.ops._launch import LAUNCHES, register_deferred
from kubernetriks_tpu_torch.ops import window_kernel
from kubernetriks_tpu_torch.parallel.multihost import CALLS as COLLECTIVE_CALLS, all_gather_rows, all_reduce_
from kubernetriks_tpu_torch.recompile import publish_capture
from kubernetriks_tpu_torch.sanitize import allow_transfer, state_addresses, to_host
from kubernetriks_tpu_torch.telemetry.tracer import PH_PRECOMPILE, PH_PROGRESS_WAIT, PH_SHIFT_WAIT

Key = Tuple
# Conditional bodies with counted launches a capture backend can hold.
BODY_COUNTERS = 4096
# Windows of gauge samples the gauge buffer holds: the engine reads it back
# at least this often (once a span, spans cut to this many windows).
GAUGE_SPAN = 256
# The key of the piece being captured on this thread (None: no capture),
# which a conditional body's capture publishes under.
_CAPTURING = threading.local()


class WindowBuffers(NamedTuple):
    """Everything that lives from one piece to the next, at fixed
    addresses."""

    state: ClusterBatchState
    acc: EventAccumulators
    W: torch.Tensor  # (C,) int32 the window being run
    shift: torch.Tensor  # (1,) int32 the last slide's shift
    span: torch.Tensor  # (2,) int32 fast-forward's [W + 1, next window)
    limit: torch.Tensor  # (1,) int32 the span's last window + 1
    # The autoscaler statics' windowed pod-name ranks (the tensor itself),
    # which a slide moves; None without autoscalers or without the window.
    rank: Optional[torch.Tensor] = None
    # The (1,) int32 plain column the installed stage's first column
    # holds (the stage itself is a slot the slide piece reads in place);
    # None without the window.
    stage_lo: Optional[torch.Tensor] = None
    # The conditional move's: the nodes' creation times this window, (C,
    # N) float32 seconds from the window base (+inf: none), and a gated
    # tail's WakeEvents; None without it.
    node_create_rel: Optional[torch.Tensor] = None
    wake: Optional[WakeEvents] = None
    # The flight recorder's: the counters as they were when the window
    # began ((len(TELEM_COUNTERS), C) int32; between windows equal to the
    # state's counters), which the record takes deltas of and refreshes;
    # None without a telemetry ring.
    m0: Optional[torch.Tensor] = None
    # Gauge collection's: (GAUGE_SPAN, C, 7) float32 samples of the span so
    # far and the (1,) int32 slot of the next; None until gauges are on.
    gauges: Optional[torch.Tensor] = None
    gauge_slot: Optional[torch.Tensor] = None
    # Lane clocks' (a lane-asynchronous engine): the (C,) int32 global
    # window the host fills (W is then each lane's virtual window, which
    # the ("lanes",) head writes), the (C,) bool active lanes, the
    # engine's state.LaneClocks, and the freeze's snapshot of the state
    # without its ring; all None without lane clocks.
    Wg: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    lanes: Optional[LaneClocks] = None
    snap: Optional[ClusterBatchState] = None


def piece_schedule(plan: WindowPlan, route: str, razor: bool = False, gauges: bool = False) -> List[Key]:
    """The pieces window `plan` runs on `route`, in order (step.window_body's
    order); `razor`: the window-cost razor is on; `gauges`: a gauge sample
    follows the window."""
    hpa = plan.hpa_cycle if plan.hpa_cycle or plan.hpa_collect else None
    head = [] if plan.freeze is None else [("lanes",) + (("freeze",) if plan.freeze else ())]
    if plan.reclaim:
        head.append(("reclaim",))
    end = ("end", route, plan.removal_due, hpa, plan.ca_due) + (("crash",) if plan.crash_due else ())
    if razor and plan.n_chunks == 0:
        end += ("gate",)
    if plan.freeze:
        end += ("freeze",)
    return head + [("chunk",)] * plan.n_chunks + [end] + ([("gauge",)] if gauges else [])


class CudaGraphs:
    """The capture backend on the card: one capture stream, on which the
    warm-ups run too (the free kernel's scratch is per stream), and one
    memory pool for every graph."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._capturing = None  # the graph being captured
        # Conditional bodies (when): captured on a stream and into a pool
        # of their own while the piece's capture is open, then copied into
        # its graph; each is kept, with the memory its capture took.
        self.body_stream = torch.cuda.Stream(device)
        self.body_pool = torch.cuda.graph_pool_handle()
        self._bodies: List[torch.cuda.CUDAGraph] = []
        # A body that launches counted kernels adds one to its slot here
        # each time it runs; body_slots[i]: its launch counts,
        # body_totals[i]: its runs settled so far, slot_replays[i]: the
        # replays of the graph holding it (counted by the executor).
        self.body_runs = torch.zeros((BODY_COUNTERS,), dtype=torch.int64, device=device)
        self.body_slots: List[Dict[str, int]] = []
        self.body_totals: List[int] = []
        self.slot_replays: List[int] = []
        register_deferred(self)

    def warm(self, fn: Callable[[], None]) -> None:
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def capture(self, fn: Callable[[], None]):
        """`fn` captured into a graph (module note: thread-local mode, the
        garbage collector off)."""
        graph = torch.cuda.CUDAGraph()
        self._capturing = graph
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
                fn()
        finally:
            self._capturing = None
            if collecting:
                gc.enable()
        return graph

    def when(self, pred: torch.Tensor, fn: Callable[[], None]) -> None:
        """Inside a capture, `fn`'s work becomes the body of a conditional
        node that a replay runs only where the (0-d bool, on the card) flag
        `pred` is set when the node is reached: the reference's lax.cond,
        with no read by the host.

        `fn` is captured as a graph of its own first (kept, never replayed
        alone), on the body stream into the body pool, so the open
        capture's stream and pool are untouched; ops/csrc/graph_if.cu then
        appends the flag's set kernel and the IF node holding a copy of it
        to the open capture. A warm-up runs `fn` on the body stream, as
        its capture will (the free kernel's scratch is per stream)."""
        if self._capturing is None:
            outer = torch.cuda.current_stream(self.device)
            self.body_stream.wait_stream(outer)
            with torch.cuda.stream(self.body_stream):
                fn()
            outer.wait_stream(self.body_stream)
            return
        from kubernetriks_tpu_torch.ops import _build

        body = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(LAUNCHES)
        with torch.cuda.stream(self.body_stream):
            body.capture_begin(pool=self.body_pool, capture_error_mode="thread_local")
            try:
                fn()
                delta = {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]}
                if delta:
                    slot = len(self.body_slots)
                    if slot >= BODY_COUNTERS:
                        raise RuntimeError(f"CudaGraphs.when: more than {BODY_COUNTERS} counted conditional bodies")
                    self.body_runs[slot : slot + 1].add_(1)
                    self.body_slots.append(delta)
                    self.body_totals.append(0)
                    self.slot_replays.append(0)
            finally:
                body.capture_end()
        publish_capture(tuple(getattr(_CAPTURING, "key", None) or ()) + ("body",))
        # The body's launches count where it runs (settle_launches), not
        # at every replay of the graph holding it.
        LAUNCHES.update(before)
        self._bodies.append(body)
        rc = _build.kernel("graph_if")(
            pred.data_ptr(), body.raw_cuda_graph(), torch.cuda.current_stream(self.device).cuda_stream
        )
        if rc != 0:
            raise RuntimeError(f"CudaGraphs.when: adding the conditional node failed with cudaError {rc}")

    def settle_launches(self) -> None:  # ktpu: sync-ok(launch accounting: the conditional bodies' counters, read outside any window)
        """Fold the counted bodies' runs on the card into LAUNCHES and zero
        them (a host read)."""
        n = len(self.body_slots)
        if not n:
            return
        runs = to_host(self.body_runs[:n]).tolist()
        self.body_runs[:n].zero_()
        for i, (delta, r) in enumerate(zip(self.body_slots, runs)):
            self.body_totals[i] += r
            for name, k in delta.items():
                LAUNCHES[name] += r * k

    def pool_bytes(self) -> int:
        """Device memory the graphs' pool holds."""
        pool = tuple(self.pool)
        return sum(
            seg["total_size"]
            for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool
        )


class WindowExecutor:
    """Runs an engine's windows as pieces over fixed buffers, replayed from
    CUDA graphs when a capture backend is given (module note).
    `dispatch_stats` is the engine's: captures, replays, graph_windows and
    eager_windows, and fast-forward's executed_windows and
    skipped_windows, are counted here."""

    def __init__(self, sim, backend=None):
        self.sim = sim
        self.backend = backend
        dev = sim.state.time.device
        # The slide's shift and fast-forward's next window come back
        # through one pinned host word (an ordinary one on the CPU), copied
        # without blocking, then waited on.
        self._word_host = torch.zeros((1,), dtype=torch.int32, pin_memory=dev.type == "cuda")
        self._word_event = torch.cuda.Event() if dev.type == "cuda" else None
        self.gauges_on = False
        # Whether a slide graph was ever captured: a rebuild then captures
        # the slide of its new staging.
        self._slides_captured = False
        self._bind_buffers()

    def _bind_buffers(self) -> None:
        """Fixed buffers around the engine's current state (and its slide
        ranks); drops every piece and graph built on earlier ones."""
        sim = self.sim
        state = sim.state
        C, P = state.pods.phase.shape
        N = state.nodes.alive.shape[1]
        dev = state.time.device
        sliding = sim.pod_window is not None and sim.autoscale_statics is not None
        node_faults = sim.faults is not None and sim.faults.params.node_faults
        cm = sim.conditional_move
        self.bufs = WindowBuffers(
            state=state,
            acc=EventAccumulators.fresh(C, N, P, dev, node_faults=node_faults),
            W=torch.zeros((C,), dtype=torch.int32, device=dev),
            shift=torch.zeros((1,), dtype=torch.int32, device=dev),
            span=torch.zeros((2,), dtype=torch.int32, device=dev),
            limit=torch.zeros((1,), dtype=torch.int32, device=dev),
            rank=sim.autoscale_statics.pod_name_rank if sliding else None,
            node_create_rel=torch.full((C, N), INF, dtype=torch.float32, device=dev) if cm else None,
            wake=empty_wake(C, N, P, dev) if cm else None,
            m0=counter_snapshot(state.metrics) if state.telemetry is not None else None,
            stage_lo=None if sim.pod_window is None else torch.zeros((1,), dtype=torch.int32, device=dev),
        )
        if sim._lane_clocks is not None:
            self.bufs = self.bufs._replace(
                Wg=torch.zeros((C,), dtype=torch.int32, device=dev),
                active=torch.zeros((C,), dtype=torch.bool, device=dev),
                lanes=sim._lane_clocks,
                snap=clone_state(strip_telemetry(state)),
            )
        if self.gauges_on:
            self.bufs = self._with_gauges(self.bufs)
        leaves = [t for t in flatten(self.bufs).values() if t.numel()]
        self._fixed = storages(leaves)
        # The state's leaf addresses the pieces are captured on.
        self.addresses = state_addresses(state)
        if len(self._fixed) != len(leaves):
            raise ValueError("WindowExecutor: two buffers share memory; each must own its own")
        self._bodies: Dict[Key, Callable[[WindowBuffers], None]] = {}
        # key -> (graph, its launch counts, the counted conditional bodies'
        # slots it holds)
        self.graphs: Dict[Key, Tuple[object, Dict[str, int], range]] = {}
        # key -> the collectives its capture recorded (under a mesh: the
        # slide's shift, the razor's predicate, fast-forward's next window).
        self.collective_captures: Dict[Key, int] = {}

    @staticmethod
    def _with_gauges(b: WindowBuffers) -> WindowBuffers:
        C, dev = b.W.shape[0], b.W.device
        return b._replace(
            gauges=torch.zeros((GAUGE_SPAN, C, 7), dtype=torch.float32, device=dev),
            gauge_slot=torch.zeros((1,), dtype=torch.int32, device=dev),
        )

    def enable_gauges(self) -> None:
        """Add the gauge buffers (once; every piece and graph stays, as
        none reads them but the gauge piece)."""
        if self.gauges_on:
            return
        self.gauges_on = True
        self.bufs = self._with_gauges(self.bufs)
        self._fixed |= storages([self.bufs.gauges, self.bufs.gauge_slot])

    def read_gauges(self, n: int):
        """The span's n gauge samples, (n, C, 7) on the host (a host read),
        and the slot back to 0."""
        out = to_host(self.bufs.gauges[:n])  # ktpu: sync-ok(the gauge buffer, a span's read, counted in host_syncs, in an allow scope)
        self.bufs.gauge_slot.zero_()
        return out

    def reset_after_install(self) -> None:
        """Fresh accumulators and, with a telemetry ring, m0 set to the
        installed counters (the next window's incoming counters)."""
        self.bufs.acc.reset_()
        if self.bufs.m0 is not None:
            self.bufs.m0.copy_(counter_snapshot(self.bufs.state.metrics))

    def rebuild(self) -> None:
        """New buffers at the engine's new pod width, after a growth of the
        pod window, and captures again every piece captured before (the
        slide at the new widths, a graph a slot)."""
        keys = [key for key in self.graphs if key[0] != "slide"]
        self._bind_buffers()
        if self._slides_captured:
            keys += self.slide_keys()
        if keys:
            self.capture(keys)

    def slide_key(self) -> Key:
        """The slide piece's key: the window's and the stage's widths and
        the installed slot (-1: the whole-trace payload)."""
        sim = self.sim
        return ("slide", sim.pod_window, sim._stage_cols(), sim._stage_tag())

    def slide_keys(self) -> List[Key]:
        """The slide piece's keys, one a slot of the current staging."""
        sim = self.sim
        return [("slide", sim.pod_window, sim._stage_cols(), tag) for tag in sim._stage_tags()]

    def drop_slide(self) -> None:
        """Forget the slide graphs (their slots are being freed: a re-seek
        builds a new ring)."""
        for key in [k for k in self.graphs if k[0] == "slide"]:
            del self.graphs[key]  # _slides_captured stays: a rebuild captures the new ring's
        for key in [k for k in self._bodies if k[0] == "slide"]:
            del self._bodies[key]

    def install_stage(self, lo: int, ready=None) -> None:
        """Install the slab covering plain columns [lo, lo + L): on the
        compute stream, wait for `ready` (the slab's upload event, None
        where there is none to wait for) and write stage_lo. Outside any
        capture; no host read."""
        dev = self.bufs.stage_lo.device
        if ready is not None:
            torch.cuda.current_stream(dev).wait_event(ready)
        self.bufs.stage_lo.fill_(lo)

    # --- the pieces ----------------------------------------------------------

    def _copy_back(self, dst, src) -> None:
        copy_state_into(dst, src, self._fixed)

    def _when(self, pred: torch.Tensor, fn: Callable[[], None]) -> None:
        """`fn` where the device flag `pred` is set: a conditional node of
        the graph being captured (CudaGraphs.when); uncaptured, `fn` runs
        where `pred` is set on the CPU and whatever it holds on the card
        (no host read), so it must leave the buffers as they are where
        `pred` is false."""
        if self.backend is not None:
            self.backend.when(pred, fn)
        elif pred.device.type != "cpu" or bool(pred):
            fn()

    def _global_any(self, pred: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool over the engine's clusters, made the whole batch's
        under a mesh (an all-reduce over its group, captured with the
        piece on NCCL)."""
        group = self.sim._group
        if group is None:
            return pred
        flag = pred.to(torch.int32)
        all_reduce_(flag, "max", group)
        return flag > 0

    def _body(self, key: Key) -> Callable[[WindowBuffers], None]:
        """The piece `key` as a function of the buffers it reads and writes."""
        run = self._bodies.get(key)
        if run is None:
            run = self._bodies[key] = self._make_body(key)
        return run

    def _make_body(self, key: Key) -> Callable[[WindowBuffers], None]:
        sim = self.sim
        k = sim._k
        kind = key[0]
        if kind == "chunk":
            def run(b: WindowBuffers) -> None:
                cursor, acc, node_create_rel = event_chunk(
                    b.state, sim.slab, b.W, sim.consts, k, sim.max_events_per_window, b.acc, b.node_create_rel
                )
                b.state.event_cursor.copy_(cursor)
                self._copy_back(b.acc, acc)
                if node_create_rel is not None:
                    b.node_create_rel.copy_(node_create_rel)
        elif kind == "lanes":
            freeze = "freeze" in key[1:]

            def run(b: WindowBuffers) -> None:
                W, active = lane_window(b.Wg, b.lanes.lane_clock, b.lanes.lane_horizon)
                b.W.copy_(W)
                b.active.copy_(active)
                if freeze:
                    snap = flatten(b.snap)
                    for path, leaf in flatten(strip_telemetry(b.state)).items():
                        snap[path].copy_(leaf)
        elif kind == "reclaim":
            st = sim.autoscale_statics

            period = sim.reclaim_period

            def run(b: WindowBuffers) -> None:
                dead = ca_dead_slots(b.state, st)

                def compact() -> None:
                    self._copy_back(b.state, ca_reclaim_pass(b.state, st, b.W, k, dead, period))

                self._when(reclaim_due(dead, b.W, period), compact)
        elif kind == "end":
            route, removal_due, hpa, ca_due = key[1:5]
            crash_due = "crash" in key[5:]
            gated = "gate" in key[5:]
            freeze = "freeze" in key[5:]
            cm = sim.conditional_move

            def run(b: WindowBuffers) -> None:
                orders = reclaim_name_orders(b.state.auto, sim.autoscale_statics, k, removal_due or ca_due)

                def tail():
                    return events_tail(
                        b.state, b.acc, b.W, k, removal_due, cm, sim.name_ranks, b.node_create_rel,
                        None if orders is None else orders[1], sim.faults, crash_due,
                    )

                if gated:
                    # No event chunk ran, so the accumulators are fresh;
                    # the tail runs where the razor's predicate holds.
                    b.state.time.copy_(torch.maximum(b.state.time, b.W))
                    if cm:
                        for mask, rel in ((b.wake.node_mask, b.wake.node_rel), (b.wake.freed_mask, b.wake.freed_rel)):
                            mask.fill_(False)
                            rel.fill_(INF)

                    def gated_tail() -> None:
                        state, wake = tail()
                        self._copy_back(b.state, state)
                        if cm:
                            self._copy_back(b.wake, wake)

                    self._when(self._global_any(window_work_due(b.state, sim.slab, b.W)), gated_tail)
                    state, wake = b.state, b.wake
                else:
                    state, wake = tail()
                # What the storage saw before this cycle: the CA reads it
                # when its snapshot precedes the cycle's commit visibility.
                pre = (state.pods.phase, state.pods.attempts, state.nodes.alloc_cpu, state.nodes.alloc_ram)
                state = run_scheduling_cycle(
                    state, b.W, k, sim.max_pods_per_cycle, route, cm, wake, profile=sim.profile,
                    faults=sim.faults, profile_terms=sim.profile_terms,
                )
                if hpa is not None:
                    state = hpa_pass(state, sim.autoscale_statics, b.W, k, sim.hpa_seg, hpa)
                if ca_due:
                    state = ca_pass(
                        state, sim.autoscale_statics, b.W, k,
                        sim.max_ca_pods_per_cycle, sim.max_pods_per_scale_down, pre, orders,
                    )
                self._copy_back(b.state, state)
                if not gated:
                    b.acc.reset_()
                    if cm:
                        b.node_create_rel.fill_(INF)
                if freeze:
                    # The inactive lanes back to the head's snapshot.
                    freeze_lanes_(b.state, b.snap, b.active)
                if b.m0 is not None:
                    # The window's record, outside the razor's conditional
                    # node: a gated window records too.
                    telemetry_record(b.state, b.m0, b.W, sim.consts, window=b.Wg, active=b.active)
        elif kind == "gauge":
            def run(b: WindowBuffers) -> None:
                b.gauges.index_copy_(0, b.gauge_slot.long(), gauge_snapshot(b.state)[None])
                b.gauge_slot.add_(1)
        elif kind == "next":
            has_auto = sim.autoscale_statics is not None and sim.state.auto is not None

            def run(b: WindowBuffers) -> None:
                rows = next_window_rows(b.state, sim.slab, sim.autoscale_statics, sim.config.scheduling_cycle_interval)
                if sim._group is not None:
                    # Every shard's words, in rank order: the span is the
                    # whole batch's.
                    rows = all_gather_rows(rows, sim._group)
                b.span.copy_(window_kernel.next_window_combine(
                    rows, b.W, b.limit, flush_windows=sim.flush_windows, has_auto=has_auto,
                ))
        elif kind == "catch_up":
            def run(b: WindowBuffers) -> None:
                self._copy_back(b.state, catch_up_bookkeeping(
                    b.state, b.span, sim.autoscale_statics, sim.config.scheduling_cycle_interval,
                    sim.consts.flush_interval,
                ))
        elif kind == "slide":
            W, slot = key[1], key[3]

            def run(b: WindowBuffers) -> None:
                pay = sim._stage_slot(slot)._asdict()
                base, lo = b.state.pod_base[0], b.stage_lo[0]
                s0 = slide_shift_core(b.state.pods.phase[:, :W], pay["create_win"], base, lo)
                if sim._group is not None:
                    # The least over every shard's clusters: all slide alike.
                    all_reduce_(s0, "min", sim._group)
                s = quantize_shift(s0, W)
                pods, rank = slide_apply(b.state.pods, b.rank, pay, base, s, W, lo)
                self._copy_back(b.state.pods, pods)
                if rank is not None:
                    b.rank.copy_(rank)
                b.state.pod_base.add_(s)
                b.shift.copy_(s)
        else:
            raise ValueError(f"unknown window piece {key!r}")
        return run

    # --- capture and replay ----------------------------------------------------

    def reachable_keys(self) -> List[Key]:
        """Every piece the engine's plans can reach on its current route: a
        superset read from the build (the trace's node removals, the
        autoscalers), not from a dry run of the plans."""
        sim = self.sim
        clock = sim.clock
        removals = [False]
        if bool(sim._rm_prefix[:, -1].any()) or (clock is not None and clock.ca_on):
            removals.append(True)
        hpas, cas = [None], [False]
        if clock is not None:
            if clock.hpa_on:
                hpas += [False, True]
            if clock.ca_on:
                cas.append(True)
        crashes = bool(sim._crash_prefix[:, -1].any())
        route = sim.cycle_route
        keys: List[Key] = [("lanes",), ("lanes", "freeze")] if sim.lane_async else []
        if sim.reclaim:
            keys.append(("reclaim",))
        keys.append(("chunk",))
        keys += [
            ("end", route, rm, hpa, ca) + crash
            for rm in removals
            for crash in ([(), ("crash",)] if rm and crashes else [()])
            for hpa in hpas
            for ca in cas
        ]
        if sim.window_razor:
            # A crash is a slab event: a window with one has event chunks.
            keys += [key + ("gate",) for key in keys if key[0] == "end" and "crash" not in key]
        if sim.lane_async:
            # Both freeze variants of every end piece (the counterpart of
            # the reference's precompile_lane_spans).
            keys += [key + ("freeze",) for key in keys if key[0] == "end"]
        if sim.fast_forward:
            keys += [("next",), ("catch_up",)]
        if sim.pod_window is not None:
            keys += self.slide_keys()
        if self.gauges_on:
            keys.append(("gauge",))
        return keys

    def capture(self, keys: Iterable[Key]) -> int:
        """Warm and capture each of `keys` not captured yet (the
        counterpart of the reference's precompile_chunks); returns how many
        were captured. One scratch copy of the buffers serves the warm-ups."""
        todo = [key for key in dict.fromkeys(keys) if key not in self.graphs]
        if not todo:
            return 0
        if self.backend is None:
            raise RuntimeError("WindowExecutor.capture: no capture backend (graphs are off)")
        scratch = clone_state(self.bufs)
        slots = getattr(self.backend, "body_slots", [])
        with self.sim.tracer.span(PH_PRECOMPILE):
            self._capture_all(todo, scratch, slots)
        return len(todo)

    def _capture_all(self, todo: List[Key], scratch: WindowBuffers, slots: list) -> None:
        for key in todo:
            body = self._body(key)
            before = dict(LAUNCHES)
            try:
                self.backend.warm(partial(body, scratch))
                warmed = dict(LAUNCHES)
                first = len(slots)
                _CAPTURING.key = key
                calls = sum(COLLECTIVE_CALLS.values())
                graph = self.backend.capture(partial(body, self.bufs))
                delta = {n: LAUNCHES[n] - warmed[n] for n in LAUNCHES if LAUNCHES[n] != warmed[n]}
                if sum(COLLECTIVE_CALLS.values()) > calls:
                    self.collective_captures[key] = sum(COLLECTIVE_CALLS.values()) - calls
            finally:
                _CAPTURING.key = None
                LAUNCHES.update(before)
            self.graphs[key] = (graph, delta, range(first, len(slots)))
            self._slides_captured |= key[0] == "slide"
            self.sim.dispatch_stats["captures"] += 1
            publish_capture(key)

    def _run(self, key: Key) -> None:
        if self.backend is None:
            self._body(key)(self.bufs)
            return
        entry = self.graphs.get(key)
        if entry is None:
            self.capture([key])
            entry = self.graphs[key]
        graph, delta, slots = entry
        graph.replay()
        for name, n in delta.items():
            LAUNCHES[name] += n
        for i in slots:
            self.backend.slot_replays[i] += 1
        self.sim.dispatch_stats["replays"] += 1

    def skipped_body_launches(self) -> Dict[str, int]:
        """Launches of conditional bodies whose node found its flag clear,
        over the executor's life: what an eager run of the same windows on
        the card (which runs them whatever the flag holds) launches more.
        Settles the body counters first (a host read)."""
        backend = self.backend
        if not isinstance(backend, CudaGraphs):
            return {}
        backend.settle_launches()
        out: Dict[str, int] = {}
        for delta, total, replays in zip(backend.body_slots, backend.body_totals, backend.slot_replays):
            skipped = replays - total
            for name, k in delta.items():
                out[name] = out.get(name, 0) + skipped * k
        return out

    def _read_word(self, word: torch.Tensor, reason: str) -> int:
        """One int32 device word read back (a host read, counted in the
        engine's host_syncs, inside an allow scope of the sanitizer):
        copied to the pinned host word without blocking, then waited on
        where its value is used (sanitize.to_host)."""
        self._word_host.copy_(word, non_blocking=True)
        if self._word_event is not None:
            self._word_event.record()
        with allow_transfer(self.sim._sanitize, reason):
            return int(to_host(self._word_host, ready=self._word_event)[0])  # ktpu: sync-ok(the slide's shift or fast-forward's next window, counted in host_syncs, in an allow scope)

    def slide(self) -> int:
        """Run the slide piece and read its shift back (0: no slide was
        possible, and the state is as it was)."""
        self._run(self.slide_key())
        with self.sim.tracer.span(PH_SHIFT_WAIT):
            return self._read_word(self.bufs.shift, "the slide's shift, a span's read")

    def run_windows(self, windows: Iterable[Tuple[int, WindowPlan]]) -> None:
        """Advance the engine's state through `windows`, (index, plan) in
        order (the reference's run_windows over a chunk of window indices)."""
        sim = self.sim
        stats = sim.dispatch_stats
        window = self.bufs.W if self.bufs.Wg is None else self.bufs.Wg
        for w, plan in windows:
            window.fill_(w)
            for key in piece_schedule(plan, sim.cycle_route, sim.window_razor, self.gauges_on):
                self._run(key)
            stats["graph_windows" if self.backend is not None else "eager_windows"] += 1

    def run_windows_skipping(
        self, first: int, last: int, plan: Callable[[int], WindowPlan], skipped: Callable[[int, int], None]
    ) -> None:
        """Advance the engine's state through windows first..last with
        fast-forward (the reference's `_run_windows_skip_impl`, step.py:
        2391): window `first` runs; after each executed window the next
        piece finds the next window that could change state (at most last
        + 1), which the host reads back (one read an executed window,
        counted in the engine's host_syncs); where windows lie between,
        the catch-up piece replays their bookkeeping and `skipped(lo, hi)`
        brings the host's mirrors through windows [lo, hi). `plan(w)`: the
        plan of an executed window w. After each read the engine's
        `_after_executed_read` runs (the telemetry ring's drain rides that
        read where the ring fills)."""
        sim = self.sim
        stats = sim.dispatch_stats
        self.bufs.limit.fill_(last + 1)
        w = first
        while w <= last:
            self.run_windows([(w, plan(w))])
            self._run(("next",))
            with sim.tracer.span(PH_PROGRESS_WAIT):
                nxt = self._read_word(self.bufs.span[1:], "fast-forward's next window, an executed window's read")
            sim.host_syncs += 1
            stats["executed_windows"] += 1
            sim._after_executed_read()
            if nxt > w + 1:
                self._run(("catch_up",))
                skipped(w + 1, nxt)
                stats["skipped_windows"] += nxt - w - 1
            w = nxt
